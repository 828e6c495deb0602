"""Keypoint coordinate utilities, mask-aware (counterpart of
lightglue_tpu/ops/keypoints.py; reference lightglue/lightglue.py:31-55)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def normalize_keypoints(
    kpts: torch.Tensor,
    size: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Shift/scale keypoints (B, N, 2) to ~[-1, 1].

    ``size`` (B, 2) is (w, h); without it the bbox of the valid keypoints is
    used, ``size = max(1 + max - min, 1)``. The shift is ``size / 2`` about
    the origin, not the bbox centre, as in the reference.
    """
    kpts = kpts.float()
    if size is None:
        if mask is not None:
            big = 1e9
            m = mask[..., None]
            mx = torch.where(m, kpts, torch.full_like(kpts, -big)).amax(-2)
            mn = torch.where(m, kpts, torch.full_like(kpts, big)).amin(-2)
        else:
            mx = kpts.amax(-2)
            mn = kpts.amin(-2)
        size = torch.clamp(1.0 + mx - mn, min=1.0)
    else:
        size = size.to(device=kpts.device, dtype=torch.float32)
    shift = size / 2.0
    scale = size.amax(-1) / 2.0
    return (kpts - shift[..., None, :]) / scale[..., None, None]


def pad_to_length(
    x: torch.Tensor, length: int, axis: int = -2
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad ``x`` along ``axis`` to ``length`` with ones; return (padded,
    mask) where mask (bool, size ``length`` on ``axis``, last dim 1) marks
    the real entries (reference: lightglue.py:46-55)."""
    axis = axis % x.ndim
    n = x.shape[axis]
    if length < n:
        raise ValueError(f"pad_to_length: {length} < existing {n}")
    pad_shape = list(x.shape)
    pad_shape[axis] = length - n
    y = torch.cat([x, x.new_ones(pad_shape)], dim=axis)
    mask_shape = list(y.shape)
    mask_shape[-1] = 1
    idx = torch.arange(length, device=x.device)
    mask = (idx < n).reshape([length if i == axis else 1 for i in range(x.ndim)])
    return y, mask.expand(mask_shape)
