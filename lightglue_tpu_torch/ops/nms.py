"""Non-maximum suppression of SuperPoint's and ALIKED's score maps: kernel
B9 and its plain version.

Counterpart of lightglue_tpu/ops/nms.py::simple_nms_pallas (``_nms_kernel``,
nms.py:81-129) and of the reference algorithm it fuses
(lightglue_tpu/ops/sampling.py::simple_nms; reference superpoint.py:52-68).
On a CUDA tensor ``simple_nms_kernel`` launches ``csrc/nms.cu`` or raises;
``simple_nms_plain`` is the same function in plain PyTorch. Both are max and
compare only, so they agree bitwise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build

MAX_RADIUS = 8  # the kernel's radii: template instantiations 0-8


def _max_pool(x: torch.Tensor, r: int) -> torch.Tensor:
    """(2r+1) sliding max, stride 1; outside the map counts as -inf (the
    padding of F.max_pool2d), as reduce_window SAME with -inf does."""
    return F.max_pool2d(x, 2 * r + 1, stride=1, padding=r)


def simple_nms_plain(scores: torch.Tensor, nms_radius: int) -> torch.Tensor:
    """Two suppression rounds over (B, H, W) score maps: a pixel survives
    if it is the maximum of its (2r+1) window, or becomes one once the
    windows around earlier maxima are zeroed. Suppressed pixels are 0."""
    r = int(nms_radius)
    s = scores[:, None]
    zeros = torch.zeros_like(s)
    max_mask = s == _max_pool(s, r)
    for _ in range(2):
        supp_mask = _max_pool(max_mask.to(s.dtype), r) > 0
        supp_scores = torch.where(supp_mask, zeros, s)
        new_max_mask = supp_scores == _max_pool(supp_scores, r)
        max_mask = max_mask | (new_max_mask & ~supp_mask)
    return torch.where(max_mask, s, zeros)[:, 0]


def simple_nms_kernel(scores: torch.Tensor, nms_radius: int) -> torch.Tensor:
    """B9: the whole suppression over (B, H, W) fp32 CUDA maps, any H, W >=
    1 and radius 0-8."""
    dev = _build.check_cuda(scores=scores)
    r = int(nms_radius)
    if scores.dim() != 3 or min(scores.shape) < 1:
        raise ValueError(f"scores must be (B, H, W), got {tuple(scores.shape)}")
    if not 0 <= r <= MAX_RADIUS:
        raise ValueError(f"nms kernel takes radius 0-{MAX_RADIUS}, got {r}")
    b, h, w = scores.shape
    out = torch.empty_like(scores)
    # the kernel's two bit masks, (B, H, cdiv(W, 32)) words each
    bits = torch.empty(2 * b * h * -(-w // 32), dtype=torch.int32, device=dev)
    _build.launch("lg_simple_nms", dev, scores, out, bits, b, h, w, r)
    _build.count("simple_nms")
    return out
