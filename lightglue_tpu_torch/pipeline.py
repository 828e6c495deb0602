"""User-facing matcher wrapper (counterpart of lightglue_tpu/pipeline.py:
59-75, 442-568; reference lightglue.py:439-479).

``LightGlue(...)`` is called on ``{"image0": feats0, "image1": feats1}``
with numpy or torch feature arrays and returns numpy outputs plus the ragged
``matches``/``scores`` lists, built on the host in numpy.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from . import nn
from . import weights as weights_lib
from .configs import LightGlueConfig, lightglue_config
from .models import lightglue as lg


def rbd(data: dict) -> dict:
    """Remove the batch dimension (reference: utils.py:64-69)."""
    return {
        k: v[0] if isinstance(v, (np.ndarray, torch.Tensor, list)) else v
        for k, v in data.items()
    }


def compact_matches(
    matches0: np.ndarray, mscores0: np.ndarray
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """(B, M) static-shape outputs -> per batch entry ((K, 2) int32 index
    pairs, (K,) scores) (reference builds these on device,
    lightglue.py:593-602)."""
    matches0 = np.asarray(matches0, np.int32)
    mscores0 = np.asarray(mscores0, np.float32)
    out_m, out_s = [], []
    for row, scores in zip(matches0, mscores0):
        idx = np.nonzero(row > -1)[0]
        out_m.append(np.stack([idx, row[idx]], -1).astype(np.int32))
        out_s.append(scores[idx])
    return out_m, out_s


class LightGlue:
    """Matcher wrapper: parameters on one device, optional static padding
    buckets, host-side compaction of the matches."""

    def __init__(
        self,
        features: Optional[str] = "superpoint",
        params: Union[None, str, nn.Params] = None,
        conf: Optional[LightGlueConfig] = None,
        seed: int = 0,
        device: Union[str, torch.device, None] = None,
        **conf_overrides,
    ):
        self.conf = conf or lightglue_config(features, **conf_overrides)
        if params is None:
            params = lg.init_params(self.conf, torch.Generator().manual_seed(seed))
        elif isinstance(params, str):
            params = weights_lib.load_params(params, self.conf)
        self.device = torch.device(device or "cpu")
        self.params = nn.params_to(params, self.device)
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
