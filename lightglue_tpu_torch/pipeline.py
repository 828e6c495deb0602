"""User-facing API (counterpart of lightglue_tpu/pipeline.py:37-218,
442-583; reference lightglue.py:439-479, utils.py:41-69, 131-165).

``SuperPoint(...).extract(image)`` and ``ALIKED(...).extract(image)``
return a feats dict of numpy arrays;
``LightGlue(...)`` is called on ``{"image0": feats0, "image1": feats1}``
with numpy or torch feature arrays and returns numpy outputs plus the ragged
``matches``/``scores`` lists, built on the host by the C++ runtime
(``native.py``); ``match_pair``
does both for two images, ``match_sequence`` extracts a sequence once and
matches its windowed pairs in one batched call. ``pretrained=True`` on a
wrapper resolves its release checkpoint through ``weights.fetch``;
``map_tensor`` and ``batch_to_device`` move nested batches.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from . import native, nn
from . import weights as weights_lib
from .configs import (
    ALIKEDConfig, DISKConfig, LightGlueConfig, PreprocessConfig, SIFTConfig,
    SuperPointConfig, lightglue_config)
from .models import aliked as aliked_model
from .models import disk as disk_model
from .models import hardnet as hardnet_model
from .models import lightglue as lg
from .models import sift as sift_model
from .models import sift_device
from .models import superpoint as sp
from .utils import diagnostics
from .utils.image import ImagePreprocessor, numpy_image_to_array, pad_to_multiple


def rbd(data: dict) -> dict:
    """Remove the batch dimension (reference: utils.py:64-69)."""
    return {
        k: v[0] if isinstance(v, (np.ndarray, torch.Tensor, list)) else v
        for k, v in data.items()
    }


def map_tensor(input_, func):
    """``func`` applied to every numpy array and torch tensor in nested
    dicts, lists and tuples; strings and other leaves kept (reference:
    utils.py:41-52; lightglue_tpu/pipeline.py:37-49)."""
    if isinstance(input_, (str, bytes)):
        return input_
    if isinstance(input_, dict):
        return {k: map_tensor(v, func) for k, v in input_.items()}
    if isinstance(input_, (list, tuple)):
        return type(input_)(map_tensor(v, func) for v in input_)
    if isinstance(input_, (np.ndarray, torch.Tensor)):
        return func(input_)
    return input_


def batch_to_device(batch: dict, device: Union[str, torch.device] = "cuda"
                    ) -> dict:
    """A (nested) batch with every numpy array and tensor as a tensor on
    ``device`` (reference: utils.py:55-61): the card unless the caller asks
    for the CPU; without CUDA the default raises."""
    device = torch.device(device)
    return map_tensor(batch, lambda t: torch.as_tensor(t).to(device))


def compact_matches(
    matches0: np.ndarray, mscores0: np.ndarray
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """(B, M) static-shape outputs -> per batch entry ((K, 2) int32 index
    pairs, (K,) scores) (reference builds these on device,
    lightglue.py:593-602), by the C++ host runtime (``native.py``; its
    numpy form ``native.compact_matches_numpy``)."""
    return native.compact_matches(matches0, mscores0)


_AUTO_KPTS_CAP = 16384


def _auto_kpts_bucket(conf, h: int, w: int) -> int:
    """Static capacity for ``max_num_keypoints=None`` (the reference keeps
    every point above the threshold, superpoint.py:108-117, 189-207).

    Radius-r NMS survivors are at least r + 1 apart on some axis, so at most
    one lies in each (r+1) x (r+1) tile. That bound, rounded up to a step of
    2048 (few distinct shapes across image sizes), makes the validity mask
    exactly the reference's threshold selection while it fits the 16384
    cap; beyond the cap a warning says that the weakest points are cut."""
    r = max(int(conf.nms_radius), 0)
    bound = -(-h // (r + 1)) * (-(-w // (r + 1)))
    k = min(-(-bound // 2048) * 2048, _AUTO_KPTS_CAP, h * w)
    if bound > _AUTO_KPTS_CAP:
        diagnostics.warn_once(
            f"auto-kpts-cap-{type(conf).__name__}",
            f"max_num_keypoints=None: NMS capacity bound {bound} at "
            f"{w}x{h} exceeds the {_AUTO_KPTS_CAP} static cap; keypoints "
            "beyond the cap (weakest first) would be dropped. Pass an "
            "explicit max_num_keypoints to silence.",
        )
    return k


def _numpy_feats(feats: sp.Features, kpts: torch.Tensor, sizes) -> dict:
    out = {
        "keypoints": kpts.cpu().numpy().astype(np.float32),
        "keypoint_scores": feats.keypoint_scores.cpu().numpy(),
        "descriptors": feats.descriptors.cpu().numpy(),
        "valid": feats.valid.cpu().numpy(),
        "image_size": np.asarray(sizes, np.float32),
    }
    for extra in ("scales", "oris"):  # SIFT-family
        if getattr(feats, extra) is not None:
            out[extra] = getattr(feats, extra).cpu().numpy()
    return out


class Extractor:
    """Base wrapper: parameters on one device, preprocessing, the forward
    pass and the rescale of the keypoints to the original image (reference
    Extractor.extract, utils.py:136-147). A subclass names its config class,
    model module (``init_params``, ``forward``), JAX-npz converter and
    release checkpoint.

    ``params``: the port's parameter tree, or the path of a flat npz in the
    JAX package's layout; None draws random weights from ``seed``, unless
    ``pretrained=True``, which resolves the release checkpoint through
    ``weights.fetch`` (the shared ``weights/`` cache, else a download;
    offline it raises ``WeightsUnavailableError``). ``device`` is "cuda"
    (the kernels) unless the caller asks for "cpu" (the plain versions);
    without CUDA the default raises."""

    stride = 8  # pad input H/W to this multiple
    _conf_cls: type
    _model: object
    _from_jax: staticmethod
    _weights: str  # the release's registry name, formatted with the config's fields

    def __init__(
        self,
        params: Union[None, str, nn.Params] = None,
        conf=None,
        seed: int = 0,
        pretrained: bool = False,
        device: Union[str, torch.device] = "cuda",
        **conf_overrides,
    ):
        self.conf = (conf or self._conf_cls()).replace(**conf_overrides)
        self.preprocess_conf = PreprocessConfig(resize=self.conf.resize)
        if params is None and pretrained:
            params = weights_lib.fetch(self._weights.format(**vars(self.conf)))
        if params is None:
            params = self._model.init_params(
                self.conf, torch.Generator().manual_seed(seed))
        elif isinstance(params, str):
            with np.load(params) as f:
                params = self._from_jax({k: f[k] for k in f.files}, self.conf)
        self.device = torch.device(device)
        self.params = nn.params_to(params, self.device)

    def _effective_conf(self, h: int, w: int):
        """``max_num_keypoints=None`` resolved to an area-derived bucket."""
        if self.conf.max_num_keypoints is not None:
            return self.conf
        return self.conf.replace(
            max_num_keypoints=_auto_kpts_bucket(self.conf, h, w))

    def _image(self, image) -> torch.Tensor:
        img = torch.as_tensor(image)
        if img.dtype == torch.uint8:
            img = numpy_image_to_array(img.to(self.device))
        if img.dim() == 2:
            img = img[..., None]
        return img.to(self.device, torch.float32)

    @torch.inference_mode()
    def extract(self, image, **preprocess_overrides) -> Dict[str, np.ndarray]:
        """image: (H, W, C) or (H, W), numpy or torch, float [0, 1] or uint8.
        Returns a feats dict with a leading batch dim: keypoints (1, K, 2)
        in ORIGINAL image pixels, keypoint_scores, descriptors, valid,
        image_size (1, 2) = the original (w, h)."""
        img = self._image(image)
        if img.dim() == 4:
            if img.shape[0] != 1:
                raise ValueError("extract() takes a single unbatched image")
            img = img[0]
        orig_h, orig_w = img.shape[:2]
        pp = ImagePreprocessor(self.preprocess_conf, **preprocess_overrides)
        img, scales = pp(img)
        img, (vh, vw) = pad_to_multiple(img, self.stride)
        feats = self._model.forward(
            self.params, self._effective_conf(img.shape[0], img.shape[1]),
            img[None], torch.tensor([[vw, vh]], dtype=torch.float32,
                                    device=self.device))
        kpts = (feats.keypoints + 0.5) / torch.from_numpy(scales).to(
            self.device) - 0.5
        return _numpy_feats(feats, kpts, [[orig_w, orig_h]])

    @torch.inference_mode()
    def extract_batch(self, images) -> Dict[str, np.ndarray]:
        """Same-size images (B, H, W, C) float [0, 1] in one forward pass,
        without resizing; H and W are padded to the stride."""
        imgs = self._image(images)
        if imgs.dim() == 3:
            imgs = imgs[..., None]
        b = imgs.shape[0]
        imgs, (h, w) = pad_to_multiple(imgs, self.stride)
        sizes = torch.tensor([[w, h]] * b, dtype=torch.float32,
                             device=self.device)
        feats = self._model.forward(
            self.params, self._effective_conf(imgs.shape[1], imgs.shape[2]),
            imgs, sizes)
        return _numpy_feats(feats, feats.keypoints, sizes.cpu().numpy())


class SuperPoint(Extractor):
    """SuperPoint wrapper (reference superpoint.py:98-148)."""

    _conf_cls = SuperPointConfig
    _model = sp
    _from_jax = staticmethod(weights_lib.superpoint_from_jax_params)
    _weights = "superpoint_v1"


class ALIKED(Extractor):
    """ALIKED wrapper (reference aliked.py:612-695); images are padded to a
    multiple of 32."""

    stride = aliked_model.STRIDE
    _conf_cls = ALIKEDConfig
    _model = aliked_model
    _from_jax = staticmethod(weights_lib.aliked_from_jax_params)
    _weights = "{model_name}"


class DISK(Extractor):
    """DISK wrapper (reference disk.py:7-55); images are padded to a
    multiple of 16."""

    stride = disk_model.STRIDE
    _conf_cls = DISKConfig
    _model = disk_model
    _from_jax = staticmethod(weights_lib.disk_from_jax_params)
    _weights = "disk_depth"


class SIFTDevice(Extractor):
    """SIFT on the wrapper's device (``models.sift_device``, the DoG scale
    space in PyTorch) behind the Extractor surface, so that it runs in
    ``match_pair``, ``extract_batch``, ``match_sequence`` and
    ``end_to_end``; no parameters, no padding (stride 1)."""

    stride = 1
    _conf_cls = SIFTConfig
    _model = sift_device

    def __init__(self, conf: Optional[SIFTConfig] = None,
                 device: Union[str, torch.device] = "cuda", **conf_overrides):
        self.conf = (conf or SIFTConfig(backend="device")).replace(
            **conf_overrides)
        if self.conf.backend != "device":
            raise ValueError(f"SIFTDevice runs backend 'device', not "
                             f"{self.conf.backend!r}; use SIFT for the others")
        self.preprocess_conf = PreprocessConfig(resize=self.conf.resize)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SIFTDevice: no CUDA device; pass device='cpu'")
        self.params = None  # handcrafted: nothing learned


class DoGHardNetDevice(Extractor):
    """DoGHardNet on the wrapper's device (``models.hardnet``: SIFTDevice's
    detections, HardNet on their LAF patches) behind the Extractor surface,
    so that it runs in ``match_pair``, ``extract_batch``,
    ``match_sequence`` and ``end_to_end``; no padding (stride 1).
    ``params``: the port's HardNet tree, a JAX flat npz path, or None
    (random weights from ``seed``, or with ``pretrained=True`` the release
    "hardnet_liberty_aug" through ``weights.fetch``); kornia's state dicts
    convert through ``weights.hardnet_from_state_dict``."""

    stride = 1
    _conf_cls = SIFTConfig
    _model = hardnet_model
    _from_jax = staticmethod(weights_lib.hardnet_from_jax_params)
    _weights = "hardnet_liberty_aug"

    def __init__(self, params: Union[None, str, nn.Params] = None, seed: int = 0,
                 conf: Optional[SIFTConfig] = None, pretrained: bool = False,
                 device: Union[str, torch.device] = "cuda", **conf_overrides):
        conf = (conf or SIFTConfig(backend="device")).replace(**conf_overrides)
        if conf.backend != "device":
            raise ValueError(f"DoGHardNetDevice runs backend 'device', not "
                             f"{conf.backend!r}; use DoGHardNet for the others")
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DoGHardNetDevice: no CUDA device; pass "
                               "device='cpu'")
        super().__init__(params, conf, seed, pretrained, device)


class SIFT:
    """SIFT (reference sift.py:79-216): OpenCV's SIFT on the host
    (``backend="opencv"``, as the reference), RootSIFT, padded to
    ``max_num_keypoints`` slots with ``valid``, with scales and oris; or
    the DoG scale space on ``device`` (``backend="device"``), which is
    ``SIFTDevice``'s extraction. ``device`` serves the "device" backend
    only ("cuda" unless the caller asks for "cpu").

    ``_describe(gray, pred)`` is the describe hook: it takes the resized
    grey image and the host detections, before RootSIFT
    (``_apply_rootsift``), the padding and the keypoints' rescale, and
    returns them with their descriptors. SIFT keeps OpenCV's; DoGHardNet
    overrides it with HardNet's."""

    _apply_rootsift = True

    def __init__(self, conf: Optional[SIFTConfig] = None,
                 device: Union[str, torch.device] = "cuda", **conf_overrides):
        self.conf = (conf or SIFTConfig()).replace(**conf_overrides)
        self.preprocess_conf = PreprocessConfig(resize=self.conf.resize)
        self._on_device = (SIFTDevice(self.conf, device=device)
                           if self.conf.backend == "device" else None)

    def _detect(self, gray: np.ndarray) -> dict:
        if self.conf.backend == "opencv":
            return sift_model.extract_single_image_opencv(gray, self.conf)
        pred = sift_model.extract_single_image_pycolmap(gray, self.conf)
        if self.conf.nms_radius is not None:
            keep = sift_model.filter_dog_point(
                pred["keypoints"], pred["scales"], pred["oris"], gray.shape,
                self.conf.nms_radius, scores=pred["keypoint_scores"])
            pred = {k: v[keep] for k, v in pred.items()}
        k = self.conf.max_num_keypoints
        if k is not None and len(pred["keypoints"]) > k:
            idx = np.argsort(-pred["keypoint_scores"])[:k]
            pred = {k_: v[idx] for k_, v in pred.items()}
        return pred

    @torch.inference_mode()
    def extract(self, image, **preprocess_overrides) -> Dict[str, np.ndarray]:
        """image: (H, W, C) or (H, W), float [0, 1] or uint8 (RGB turned to
        grey by the reference's weights). Returns a feats dict with a
        leading batch dim: keypoints in ORIGINAL image pixels,
        keypoint_scores, descriptors (RootSIFT), scales, oris, valid,
        image_size."""
        if self._on_device is not None:
            return self._on_device.extract(image, **preprocess_overrides)
        img = np.asarray(image)
        if img.dtype == np.uint8:
            img = (img / 255.0).astype(np.float32)
        if img.ndim == 4:
            img = img[0]
        if img.ndim == 3 and img.shape[-1] == 3:
            gray = img @ np.array(sp.RGB_TO_GRAY, np.float32)
        elif img.ndim == 3:
            gray = img[..., 0]
        else:
            gray = img
        gray = np.asarray(gray, np.float32)
        orig_h, orig_w = gray.shape
        pp = ImagePreprocessor(self.preprocess_conf, **preprocess_overrides)
        gray_r, scales_xy = pp(torch.from_numpy(gray)[..., None])
        gray_r = gray_r[..., 0].numpy()
        pred = self._describe(gray_r, self._detect(gray_r))
        if self.conf.rootsift and self._apply_rootsift:
            pred["descriptors"] = sift_model.sift_to_rootsift(pred["descriptors"])
        pred = sift_model.pad_features(pred, self.conf.max_num_keypoints)
        kpts = (pred["keypoints"] + 0.5) / scales_xy[None] - 0.5
        return {
            "keypoints": kpts[None].astype(np.float32),
            "keypoint_scores": pred["keypoint_scores"][None],
            "descriptors": pred["descriptors"][None],
            "scales": pred["scales"][None],
            "oris": pred["oris"][None],
            "valid": pred["valid"][None],
            "image_size": np.array([[orig_w, orig_h]], np.float32),
        }

    def _describe(self, gray: np.ndarray, pred: dict) -> dict:
        return pred  # OpenCV has described them


class DoGHardNet(SIFT):
    """SIFT keypoints with HardNet descriptors on 32 x 32 LAF patches
    (reference dog_hardnet.py:8-41), no RootSIFT: OpenCV's detection on the
    host (``backend="opencv"``), then HardNet's patches and CNN on
    ``device`` ("cuda" unless the caller asks for "cpu"); with
    ``backend="device"`` it is ``DoGHardNetDevice``'s extraction. ``params``,
    ``seed`` and ``pretrained`` as ``DoGHardNetDevice``'s."""

    _apply_rootsift = False

    def __init__(self, params: Union[None, str, nn.Params] = None, seed: int = 0,
                 conf: Optional[SIFTConfig] = None, pretrained: bool = False,
                 device: Union[str, torch.device] = "cuda", **conf_overrides):
        self.conf = (conf or SIFTConfig()).replace(**conf_overrides)
        self.preprocess_conf = PreprocessConfig(resize=self.conf.resize)
        self._hardnet = DoGHardNetDevice(
            params, seed, self.conf.replace(backend="device"), pretrained, device)
        self._on_device = self._hardnet if self.conf.backend == "device" else None

    def _describe(self, gray: np.ndarray, pred: dict) -> dict:
        if len(pred["keypoints"]) == 0:
            pred["descriptors"] = np.zeros((0, hardnet_model.DESC_DIM), np.float32)
            return pred
        dev = self._hardnet.device
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        patches = hardnet_model.extract_laf_patches(
            t(gray), t(pred["keypoints"]),
            t(hardnet_model.LAF_SCALE * pred["scales"]), t(pred["oris"]))
        pred["descriptors"] = hardnet_model.describe_patches(
            self._hardnet.params, patches).cpu().numpy()
        return pred


class LightGlue:
    """Matcher wrapper: parameters on one device ("cuda" unless the caller
    asks for "cpu"), optional static padding buckets, host-side compaction
    of the matches.

    ``params``: the port's tree, the path of a JAX flat npz, a reference
    state dict (flat, ``transformers.0.self_attn.Wqkv.weight``, ...;
    through ``weights.from_state_dict``), or None (random weights from
    ``seed``, or with ``pretrained=True`` the release checkpoint
    ``conf.weights`` through ``weights.fetch``, as ``Extractor``'s)."""

    def __init__(
        self,
        features: Optional[str] = "superpoint",
        params: Union[None, str, nn.Params] = None,
        conf: Optional[LightGlueConfig] = None,
        seed: int = 0,
        pretrained: bool = False,
        device: Union[str, torch.device] = "cuda",
        **conf_overrides,
    ):
        self.conf = conf or lightglue_config(features, **conf_overrides)
        if params is None and pretrained:
            params = weights_lib.fetch(self.conf.weights)
        if params is None:
            params = lg.init_params(self.conf, torch.Generator().manual_seed(seed))
        elif isinstance(params, str):
            params = weights_lib.load_params(params, self.conf)
        elif any("." in k for k in params):  # a reference state dict
            params = weights_lib.from_state_dict(params, self.conf)
        self.device = torch.device(device)
        self.params = nn.params_to(params, self.device)
        lg.prepared_blocks(self.params, self.conf)  # B5/B6 weights, once
        self.static_lengths: Optional[Tuple[int, ...]] = None

    def compile(self, static_lengths=(256, 512, 768, 1024, 1280, 1536)):
        """Register static padding buckets (reference LightGlue.compile,
        lightglue.py:439-454): each request's keypoints are padded to the
        next bucket with validity masks, so every count in a bucket runs at
        one shape."""
        self.static_lengths = tuple(sorted(static_lengths))
        return self

    def _bucket(self, n: int) -> Optional[int]:
        for b in self.static_lengths or ():
            if n <= b:
                return b
        return None  # no buckets, or beyond the largest: run unpadded

    def _tensor(self, x, dtype: torch.dtype):
        if x is None:
            return None
        return torch.as_tensor(x).to(self.device, dtype)

    @torch.inference_mode()
    def __call__(self, data: dict) -> dict:
        for key in ("image0", "image1"):
            if key not in data:
                raise KeyError(f"Missing key {key} in data")
        d0, d1 = data["image0"], data["image1"]
        f32 = torch.float32
        kw = dict(
            kpts0=self._tensor(d0["keypoints"], f32),
            kpts1=self._tensor(d1["keypoints"], f32),
            desc0=self._tensor(d0["descriptors"], f32),
            desc1=self._tensor(d1["descriptors"], f32),
            size0=self._tensor(d0.get("image_size"), f32),
            size1=self._tensor(d1.get("image_size"), f32),
            mask0=self._tensor(d0.get("valid"), torch.bool),
            mask1=self._tensor(d1.get("valid"), torch.bool),
        )
        if self.conf.add_scale_ori:
            for side, d in (("0", d0), ("1", d1)):
                kw[f"scales{side}"] = self._tensor(d.get("scales"), f32)
                kw[f"oris{side}"] = self._tensor(d.get("oris"), f32)
        m_orig = kw["kpts0"].shape[1]
        n_orig = kw["kpts1"].shape[1]
        for side, n_in in (("0", m_orig), ("1", n_orig)):
            bucket = self._bucket(n_in)
            if bucket is None or bucket == n_in:
                continue
            pad = bucket - n_in

            def padded(x, value):
                # F.pad widths run from the last axis: pad axis 1 at its end
                widths = [0, 0] * (x.ndim - 2) + [0, pad]
                return torch.nn.functional.pad(x, widths, value=value)

            kw[f"kpts{side}"] = padded(kw[f"kpts{side}"], 1.0)
            kw[f"desc{side}"] = padded(kw[f"desc{side}"], 0.0)
            mask = kw[f"mask{side}"]
            if mask is None:
                mask = torch.ones(kw[f"kpts{side}"].shape[0], n_in,
                                  dtype=torch.bool, device=self.device)
            kw[f"mask{side}"] = padded(mask, False)
            for extra in (f"scales{side}", f"oris{side}"):
                if kw.get(extra) is not None:
                    kw[extra] = padded(kw[extra], 0.0)
        out = lg.forward(self.params, self.conf, **kw)
        # strip the bucket padding (reference strips at lightglue.py:
        # 590-591); padded slots are masked, so no index points into them
        matches0 = out.matches0[:, :m_orig].cpu().numpy()
        mscores0 = out.matching_scores0[:, :m_orig].cpu().numpy()
        matches, scores = compact_matches(matches0, mscores0)
        return {
            "matches0": matches0,
            "matches1": out.matches1[:, :n_orig].cpu().numpy(),
            "matching_scores0": mscores0,
            "matching_scores1": out.matching_scores1[:, :n_orig].cpu().numpy(),
            "stop": int(out.stop),
            "matches": matches,
            "scores": scores,
            "prune0": out.prune0[:, :m_orig].cpu().numpy(),
            "prune1": out.prune1[:, :n_orig].cpu().numpy(),
        }


def match_pair(
    extractor: Extractor,
    matcher: LightGlue,
    image0,
    image1,
    **preprocess,
) -> Tuple[dict, dict, dict]:
    """Extract and match a pair of images (reference utils.py:150-165).
    Returns (feats0, feats1, matches01) with batch dims removed."""
    feats0 = extractor.extract(image0, **preprocess)
    feats1 = extractor.extract(image1, **preprocess)
    matches01 = matcher({"image0": feats0, "image1": feats1})
    return rbd(feats0), rbd(feats1), rbd(matches01)


def match_sequence(
    extractor: Extractor,
    matcher: LightGlue,
    images,
    window: int = 1,
) -> Tuple[dict, dict]:
    """Extract-once windowed sequential matching (counterpart of
    lightglue_tpu/pipeline.py:586-684): each image is extracted once and
    matched against its ``window`` successors in one batched matcher call,
    per pair about 1/window of an extraction plus one matcher pass, against
    two extractions and a match for repeated ``match_pair`` calls. Runs
    eagerly on the extractor's device.

    images: (B, H, W[, C]) float [0, 1] or uint8, same size (no resizing:
    pre-size the sequence; H and W are padded to the extractor's stride).

    Returns (feats, pairs):
      feats: per-image arrays: keypoints (B, K, 2) (input pixels),
        keypoint_scores, descriptors, valid, image_size.
      pairs: i0/i1 (P,) pair indices for every (i, i+w), w <= window, plus
        matches0 / matching_scores0 (P, K), the ragged ``matches`` /
        ``scores`` lists as in LightGlue.__call__, and stop.
    """
    from .end_to_end import make_windowed_sequence_end_to_end, \
        sequence_window_pairs

    imgs = np.asarray(images)
    if imgs.ndim == 3:
        imgs = imgs[..., None]
    if imgs.dtype == np.uint8:
        imgs = imgs.astype(np.float32) / 255.0
    # a fresh array: the channel axis gets a stride of 1 element, as in
    # extract_batch's tensors (a stride of 0 can take another conv path)
    imgs = imgs.astype(np.float32)
    b, h, w = imgs.shape[:3]
    if b < 2:
        raise ValueError("match_sequence needs at least 2 images")
    stride = getattr(extractor, "stride", 1)
    ph, pw = (-h) % stride, (-w) % stride
    if ph or pw:
        imgs = np.pad(imgs, [(0, 0), (0, ph), (0, pw), (0, 0)], mode="edge")
    sizes = np.tile([[w, h]], (b, 1)).astype(np.float32)

    window = min(window, b - 1)
    conf = extractor._effective_conf(imgs.shape[1], imgs.shape[2])
    cache = getattr(matcher, "_seq_programs", None)
    if cache is None:
        cache = matcher._seq_programs = {}
    key = (id(extractor), window, conf)
    entry = cache.get(key)
    # the entry pins the extractor, so that its id cannot pass to another
    # extractor while the program (holding the old parameters) is cached
    if entry is None or entry[0] is not extractor:
        prog = make_windowed_sequence_end_to_end(
            extractor._model.forward, extractor.params, conf,
            matcher.params, matcher.conf, window=window,
        )
        cache[key] = entry = (extractor, prog)
    dev = extractor.device
    out = entry[1](torch.from_numpy(imgs).to(dev), torch.from_numpy(sizes).to(dev))

    i0, i1 = sequence_window_pairs(b, window)
    # per-image features: every image is the 0-side of some pair except the
    # last, which is the 1-side of the last w=1 pair
    f0, f1 = out.feats0, out.feats1

    def per_image(field):
        a = getattr(f0, field, None)
        if a is None:
            return None
        return torch.cat([a[: b - 1], getattr(f1, field)[b - 2 : b - 1]]).cpu().numpy()

    feats = {
        "keypoints": per_image("keypoints"),
        "keypoint_scores": per_image("keypoint_scores"),
        "descriptors": per_image("descriptors"),
        "valid": per_image("valid"),
        "image_size": sizes,
    }
    for extra in ("scales", "oris"):  # SIFT-family
        v = per_image(extra)
        if v is not None:
            feats[extra] = v
    matches0 = out.matches.matches0.cpu().numpy()
    mscores0 = out.matches.matching_scores0.cpu().numpy()
    ragged_m, ragged_s = compact_matches(matches0, mscores0)
    pairs = {
        "i0": i0,
        "i1": i1,
        "matches0": matches0,
        "matching_scores0": mscores0,
        "matches": ragged_m,
        "scores": ragged_s,
        "stop": int(out.matches.stop),
    }
    return feats, pairs
