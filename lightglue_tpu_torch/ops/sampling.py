"""Bilinear point sampling and keypoint detection helpers (counterpart of
lightglue_tpu/ops/sampling.py).

The reference uses ``grid_sample`` for descriptor lookup and a dynamic
``torch.where`` threshold for detection (superpoint.py:78-95, 188-207). As in
the JAX package, sampling is four gathers and a lerp (the same order of
operations), and detection is a static-shape top-k with a validity mask.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..nn import l2_normalize
from ..utils import diagnostics
from . import nms


def bilinear_sample(
    fmap: torch.Tensor, pts: torch.Tensor, align_corners: bool = True,
    row_l2_normalize: bool = False,
) -> torch.Tensor:
    """Sample ``fmap`` (B, H, W, C) at normalized points ``pts`` (B, K, 2)
    in [-1, 1] as (x, y): grid_sample(mode='bilinear') with zero padding.
    ``row_l2_normalize`` L2-normalizes each gathered corner row before the
    lerp, which samples the L2-normalized map without building it.
    Returns (B, K, C)."""
    b, h, w, c = fmap.shape
    x, y = pts[..., 0], pts[..., 1]
    if align_corners:
        fx = (x + 1.0) * 0.5 * (w - 1)
        fy = (y + 1.0) * 0.5 * (h - 1)
    else:
        fx = (x + 1.0) * 0.5 * w - 0.5
        fy = (y + 1.0) * 0.5 * h - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    # the lerp in the map's type, as the JAX package's (bf16 at mp)
    wx = (fx - x0)[..., None].to(fmap.dtype)
    wy = (fy - y0)[..., None].to(fmap.dtype)
    flat = fmap.reshape(b, h * w, c)

    def gather(yi, xi):
        inside = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        xc = torch.clamp(xi, 0, w - 1).long()
        yc = torch.clamp(yi, 0, h - 1).long()
        idx = (yc * w + xc)[..., None].expand(-1, -1, c)
        vals = torch.gather(flat, 1, idx)
        if row_l2_normalize:
            vals = l2_normalize(vals)
        return torch.where(inside[..., None], vals, torch.zeros_like(vals))

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def upsample(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resampling of (B, C, h, w) planes to ``size`` (H, W) with
    align_corners=True (reference nn.Upsample, aliked.py:659-670), rows
    first, then columns. The two-point weights come from a float64
    linspace, as the JAX package's lerp matrices and B11's per-pixel
    weights do: ``F.interpolate`` forms the source coordinate in float32,
    which moves ALIKED's score map by about 2e-5 at 768 x 1024.

    bf16 planes (mp) are resampled as the JAX package's bf16 lerp matrices
    do it: the two weights rounded to bf16, each output the fp32 sum of
    the two products, rounded to bf16 after each axis."""

    def taps(n_out: int, n_in: int):
        pos = torch.linspace(0.0, n_in - 1.0, n_out, dtype=torch.float64,
                             device=x.device)
        i0 = pos.floor().long()
        return i0, (i0 + 1).clamp(max=n_in - 1), (pos - i0).float()

    r0, r1, wr = taps(size[0], x.shape[-2])
    c0, c1, wc = taps(size[1], x.shape[-1])
    if x.dtype == torch.bfloat16:
        def lerp(a, c, wt):
            w1, w0 = (v.to(torch.bfloat16).float() for v in (wt, 1 - wt))
            return (w0 * a.float() + w1 * c.float()).to(torch.bfloat16)
    else:
        lerp = torch.lerp
    rows = lerp(x.index_select(2, r0), x.index_select(2, r1), wr[:, None])
    return lerp(rows.index_select(3, c0), rows.index_select(3, c1), wc)


def simple_nms(scores: torch.Tensor, nms_radius: int) -> torch.Tensor:
    """Iterative max-pool NMS over (B, H, W) score maps (reference
    superpoint.py:52-68): B9 on CUDA tensors, the plain version on CPU
    tensors; the two agree bitwise."""
    if nms_radius < 0:
        raise ValueError("nms_radius must be >= 0")
    if scores.device.type == "cpu":
        return nms.simple_nms_plain(scores, nms_radius)
    return nms.simple_nms_kernel(scores, nms_radius)


def top_k_keypoints(
    scores: torch.Tensor, k: int, threshold: float,
    approx_recall: float = 0.0, twolevel: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Static-shape keypoint selection: the k highest scores of each (H, W)
    map, ties broken toward the lower flat index as ``jax.lax.top_k`` does
    (``torch.topk`` promises no order on ties; most of a map after NMS is
    tied at 0 or at the border's -1, and the invalid slots are part of the
    output). Returns (keypoints (B, k, 2) as (x, y) fp32, scores (B, k),
    valid (B, k) = score > threshold).

    ``approx_recall > 0`` and ``twolevel`` pick faster selections on a TPU;
    here the selection is always exact, and asking for them warns once."""
    if approx_recall > 0 or twolevel:
        diagnostics.warn_once(
            "exact-topk",
            "approx_topk / twolevel_topk select keypoints faster on a TPU; "
            "lightglue_tpu_torch always selects the exact top-k.",
        )
    b, h, w = scores.shape
    if not 0 < k <= h * w:
        raise ValueError(f"k must be in 1..{h * w}, got {k}")
    flat = scores.reshape(b, h * w)
    kscores, idx = torch.sort(flat, dim=1, descending=True, stable=True)
    kscores, idx = kscores[:, :k], idx[:, :k]
    kpts = torch.stack([(idx % w).float(), (idx // w).float()], -1)
    return kpts, kscores, kscores > threshold
