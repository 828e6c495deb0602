"""SuperPoint detector and descriptor (counterpart of
lightglue_tpu/models/superpoint.py; reference lightglue/superpoint.py:98-227).

The VGG-style encoder and both heads run in NCHW: conv1/conv2 through the
stem and block-2 kernels (B7, B8) when ``conf.fused_stem``, else as plain
cuDNN convs; the rest as cuDNN convs, in full fp32 (no TF32), or with
``conf.mp`` in bf16 (B7 and B8 in their bf16 forms, the cuDNN convs in
bf16, the softmax and the descriptor norm in fp32, as the JAX package at
mp). NMS is kernel B9, on fp32 scores in both. Detection is a
static-shape top-k with a validity mask, and the descriptor lookup is the
JAX package's gather-based bilinear sampler.
Images enter as (B, H, W, C), the JAX package's layout.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import nn
from ..configs import SuperPointConfig
from ..ops import stem, stem2
from ..ops.sampling import bilinear_sample, simple_nms, top_k_keypoints

RGB_TO_GRAY = (0.299, 0.587, 0.114)
LAYERS = {  # name: (in, out, kernel), reference superpoint.py:121-142
    "conv1a": (1, 64, 3), "conv1b": (64, 64, 3),
    "conv2a": (64, 64, 3), "conv2b": (64, 64, 3),
    "conv3a": (64, 128, 3), "conv3b": (128, 128, 3),
    "conv4a": (128, 128, 3), "conv4b": (128, 128, 3),
    "convPa": (128, 256, 3), "convPb": (256, 65, 1),
    "convDa": (128, 256, 3), "convDb": (256, None, 1),
}


class Features(NamedTuple):
    """Extractor output; ``valid`` marks real keypoint slots (static k).
    ``scales`` and ``oris`` come from the SIFT family only."""

    keypoints: torch.Tensor  # (B, K, 2) (x, y) pixels
    keypoint_scores: torch.Tensor  # (B, K)
    descriptors: torch.Tensor  # (B, K, D)
    valid: torch.Tensor  # (B, K) bool
    scales: Optional[torch.Tensor] = None  # (B, K)
    oris: Optional[torch.Tensor] = None  # (B, K) radians


def layer_shapes(conf: SuperPointConfig = SuperPointConfig()) -> dict:
    """name -> (in, out, kernel) of every conv layer."""
    return {n: (i, conf.descriptor_dim if o is None else o, k)
            for n, (i, o, k) in LAYERS.items()}


def init_params(
    conf: SuperPointConfig = SuperPointConfig(),
    generator: Optional[torch.Generator] = None,
) -> nn.Params:
    """Random parameters with the reference layer shapes, OIHW, drawn from
    ``generator`` on the CPU (torch's Conv2d default, the JAX package's
    init).

    With these, activations shrink layer by layer and the detector's
    softmax comes out nearly flat: every score within a few percent of
    1/65, so rounding decides the ranking. Conv weights times 3 keep the
    activations' scale, and the scores spread as a trained detector's do
    (maximum near 1, median near 1e-5 on ``synthetic.texture``): the
    stand-in that the tests and ``chip_smoke.py`` use for the trained
    weights."""
    g = generator or torch.Generator().manual_seed(0)
    return {n: nn.conv2d_init(i, o, k, g)
            for n, (i, o, k) in layer_shapes(conf).items()}


def rgb_to_grayscale(image: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B, H, W, 1), ITU-R 601 weights, summed left to
    right."""
    r, g, b = (image[..., i:i + 1] * RGB_TO_GRAY[i] for i in range(3))
    return r + g + b


def dense_forward(
    params: nn.Params, image: torch.Tensor, fused_stem: bool = True,
    mp: bool = False,
):
    """Encoder and both heads on (B, H, W, C) images. Returns the
    full-resolution score map (B, H, W) before NMS and the L2-normalized
    descriptor map (B, H/8, W/8, D) (superpoint.py:158-215), both fp32.

    ``mp``: the convolutions in bf16 (lightglue_tpu/models/superpoint.py:
    85-143): B7 reads the fp32 image and rounds it, the rest runs on bf16
    maps, the logits' softmax and the descriptors' L2 norm in fp32."""
    logits, desc = dense_heads(params, image, fused_stem, mp)
    scores = torch.softmax(logits.float(), dim=1)[:, :-1]
    b, _, h, w = scores.shape
    scores = scores.reshape(b, 8, 8, h, w).permute(0, 3, 1, 4, 2)
    scores = scores.reshape(b, h * 8, w * 8)
    desc = nn.l2_normalize(desc.float().permute(0, 2, 3, 1), dim=-1)
    return scores, desc


def dense_heads(
    params: nn.Params, image: torch.Tensor, fused_stem: bool = True,
    mp: bool = False,
):
    """``dense_forward`` up to its heads' last convolutions: the detector's
    65 logits (B, 65, H/8, W/8) and the descriptor map (B, D, H/8, W/8),
    in the convolutions' type (bf16 under ``mp``)."""
    if image.shape[-1] == 3:
        image = rgb_to_grayscale(image)
    x = image.permute(0, 3, 1, 2).contiguous().float()

    def cbr(name, x):  # conv + ReLU, in x's type
        return torch.relu(nn.conv2d(params[name], x))

    if fused_stem:
        x = stem.fused_stem(
            {"conv1a": params["conv1a"], "conv1b": params["conv1b"]}, x, mp)
        x = stem2.fused_block2(
            {"conv2a": params["conv2a"], "conv2b": params["conv2b"]}, x)
    elif mp:  # the plain chain in bf16, as XLA runs it
        x = x.to(torch.bfloat16)
        for a, b in (("conv1a", "conv1b"), ("conv2a", "conv2b")):
            x = nn.max_pool(cbr(b, cbr(a, x)), 2)
    else:
        x = stem2.fused_block2_plain(
            {"conv2a": params["conv2a"], "conv2b": params["conv2b"]},
            stem.fused_stem_plain(
                {"conv1a": params["conv1a"], "conv1b": params["conv1b"]}, x))
    with nn.fp32_convs():
        x = nn.max_pool(cbr("conv3b", cbr("conv3a", x)), 2)
        x = cbr("conv4b", cbr("conv4a", x))
        # detector head: 65-way softmax, dustbin dropped, 8x8 pixel shuffle
        logits = nn.conv2d(params["convPb"], cbr("convPa", x))
        desc = nn.conv2d(params["convDb"], cbr("convDa", x))
    return logits, desc


def sample_descriptors(
    keypoints: torch.Tensor, desc_map: torch.Tensor, s: int = 8
) -> torch.Tensor:
    """Bilinear descriptor lookup at full-resolution keypoints
    (superpoint.py:78-95). keypoints (B, K, 2) pixels; desc_map (B, h, w,
    D) at stride s."""
    _, hh, ww, _ = desc_map.shape
    kp = keypoints - s / 2 + 0.5
    # filled on the device: a host tensor here would cost a copy and a sync
    denom = torch.stack([
        torch.full((), ww * s - s / 2 - 0.5, device=keypoints.device),
        torch.full((), hh * s - s / 2 - 0.5, device=keypoints.device)])
    kp = kp / denom
    kp = kp * 2 - 1
    return nn.l2_normalize(bilinear_sample(desc_map, kp, align_corners=True))


def detection_map(scores: torch.Tensor, conf: SuperPointConfig,
                  image_size: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The map the top-k reads: ``simple_nms`` of the dense scores (B, H,
    W), then the border band at -1 (superpoint.py:181-186), measured from
    the true extent when the image is padded."""
    scores = simple_nms(scores, conf.nms_radius)
    pad = conf.remove_borders
    b, h, w = scores.shape
    dev = scores.device
    ys = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None]
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, None, :]
    if image_size is not None:
        size = image_size.to(dev, torch.float32)
        tw, th = size[:, 0, None, None], size[:, 1, None, None]
    else:
        tw = torch.full((b, 1, 1), float(w), device=dev)
        th = torch.full((b, 1, 1), float(h), device=dev)
    if pad or image_size is not None:
        border = (ys < pad) | (ys >= th - pad) | (xs < pad) | (xs >= tw - pad)
        scores = torch.where(border, torch.full_like(scores, -1.0), scores)
    return scores


@torch.inference_mode()
def forward(
    params: nn.Params,
    conf: SuperPointConfig,
    image: torch.Tensor,
    image_size: Optional[torch.Tensor] = None,
) -> Features:
    """Full extraction: (B, H, W, C) image -> static-k Features.

    H and W must be multiples of 8 (pad with utils.image.pad_to_multiple).
    ``image_size`` (B, 2) as (w, h) gives the true extent of a padded image:
    detections in the pad band are suppressed with the border."""
    if image.shape[1] % 8 or image.shape[2] % 8:
        raise ValueError(f"H and W must be multiples of 8, got "
                         f"{tuple(image.shape[1:3])}")
    scores, desc_map = dense_forward(params, image, fused_stem=conf.fused_stem,
                                     mp=conf.mp)
    scores = detection_map(scores, conf, image_size)
    kpts, kscores, valid = top_k_keypoints(
        scores, conf.max_num_keypoints, conf.detection_threshold,
        approx_recall=conf.approx_topk, twolevel=conf.twolevel_topk,
    )
    descs = sample_descriptors(kpts, desc_map, 8)
    return Features(
        keypoints=kpts,
        keypoint_scores=torch.where(valid, kscores, torch.zeros_like(kscores)),
        descriptors=torch.where(valid[..., None], descs, torch.zeros_like(descs)),
        valid=valid,
    )
