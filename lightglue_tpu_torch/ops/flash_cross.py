"""Bidirectional shared-QK cross attention: kernel K2 and its plain version.

Counterpart of lightglue_tpu/ops/flash_cross.py::fused_cross_attention:
the exact variant (``_fused_cross_kernel``, flash_cross.py:44-113,
201-307) and, with ``shift`` set, the single-pass variant
(``_single_pass_cross_kernel``, flash_cross.py:116-184). Exact: the row
direction (messages into image 0) is an exact softmax; the column direction
(into image 1) shifts by the per-(batch, head) maximum of the whole score
matrix, as the TPU kernel does, and neither zeroes the messages of invalid
rows of image 0 (callers read valid rows only). Shift: one
e = exp2(min(s + bias0 + bias1 - shift * log2(e), 100)) serves both
directions, and invalid rows and columns come out 0.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _build
from .flash import LOG2E, key_bias, shift_weights

TILE = 64  # query rows per block of the row launch (csrc/common.cuh)
# The only head_dim of K2 and B6, as in the TPU kernels (their ones column
# in V sits at lane 64); the matcher takes B1' above it.
HEAD_DIM = 64
# Launch modes of csrc/flash_cross.cu (lg_fused_cross's ``mode``).
EXACT, EXACT_BLOCK, SHIFT = 0, 1, 2


def _biases(valid0, valid1, b, m, n, device):
    if valid0 is None and valid1 is None:
        return None, None
    ones = lambda k: torch.ones(b, k, dtype=torch.bool, device=device)
    return (key_bias(ones(m) if valid0 is None else valid0).contiguous(),
            key_bias(ones(n) if valid1 is None else valid1).contiguous())


def fused_cross_attention_plain(
    qk0: torch.Tensor,
    qk1: torch.Tensor,
    v0: torch.Tensor,
    v1: torch.Tensor,
    valid0: Optional[torch.Tensor] = None,
    valid1: Optional[torch.Tensor] = None,
    shift: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """qk0, v0 (B, H, M, d); qk1, v1 (B, H, N, d); valid0 (B, M),
    valid1 (B, N) bool. Returns (m0 (B, H, M, d), m1 (B, H, N, d))."""
    b, _, m, _ = qk0.shape
    n = qk1.shape[2]
    bias0, bias1 = _biases(valid0, valid1, b, m, n, qk0.device)
    scale = qk0.shape[-1] ** -0.5
    if shift is not None:
        scale *= LOG2E
    s = (qk0 * scale) @ qk1.transpose(-1, -2)
    if shift is not None:
        if bias0 is not None:
            s = s + bias0[:, None, :, None] + bias1[:, None, None, :]
        e = shift_weights(s, shift * LOG2E)
        m0 = (e @ v1) / torch.clamp(e.sum(-1, keepdim=True), min=1e-30)
        m1 = (e.transpose(-1, -2) @ v0) / torch.clamp(
            e.sum(-2)[..., None], min=1e-30)
        return m0, m1
    if bias1 is not None:
        s = s + bias1[:, None, None, :]
    e = torch.exp(s - s.amax(-1, keepdim=True))
    m0 = (e @ v1) / torch.clamp(e.sum(-1, keepdim=True), min=1e-30)
    ec = torch.exp(s - s.amax((-2, -1), keepdim=True))
    if bias0 is not None:
        ec = ec * (bias0 >= 0).float()[:, None, :, None]
    m1 = (ec.transpose(-1, -2) @ v0) / torch.clamp(
        ec.sum(-2)[..., None], min=1e-30)
    return m0, m1


def launch_cross(qk0, qk1, v0, v1, bias0, bias1, mode: int, scale: float,
                 shift2: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The row and column launches of csrc/flash_cross.cu on CUDA tensors
    (no launch count: the calling op counts). ``scale`` multiplies qk0;
    ``mode``: EXACT (K2), EXACT_BLOCK (B6's exact attention: the column
    shift is the maximum over valid rows only, and m0 is 0 where image 1
    has no valid point) or SHIFT (log2-domain scores, ``shift2`` =
    shift * log2(e))."""
    b, h, m, d = qk0.shape
    n = qk1.shape[2]
    dev = _build.check_cuda(qk0=qk0, qk1=qk1, v0=v0, v1=v1, bias0=bias0,
                            bias1=bias1)
    if d != HEAD_DIM:
        raise ValueError(
            f"the cross attention kernel takes head_dim {HEAD_DIM}, got {d}")
    if (qk1.shape != (b, h, n, d) or v0.shape != qk0.shape
            or v1.shape != qk1.shape or m < 1 or n < 1):
        raise ValueError(
            f"bad shapes qk0 {tuple(qk0.shape)} qk1 {tuple(qk1.shape)} "
            f"v0 {tuple(v0.shape)} v1 {tuple(v1.shape)}")
    if bias0 is not None and (bias0.shape != (b, m) or bias1.shape != (b, n)):
        raise ValueError("valid0/valid1 must be (B, M)/(B, N)")
    m0 = torch.empty_like(qk0)
    m1 = torch.empty_like(qk1)
    tile_max = torch.empty(b, h, -(-m // TILE), device=dev)
    _build.launch("lg_fused_cross", dev, qk0, qk1, v0, v1, bias0, bias1, m0,
                  m1, tile_max, b, h, m, n, mode, float(scale),
                  float(shift2))
    return m0, m1


def fused_cross_attention(
    qk0: torch.Tensor,
    qk1: torch.Tensor,
    v0: torch.Tensor,
    v1: torch.Tensor,
    valid0: Optional[torch.Tensor] = None,
    valid1: Optional[torch.Tensor] = None,
    shift: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 on CUDA tensors, the plain version on CPU tensors."""
    if qk0.device.type == "cpu":
        return fused_cross_attention_plain(qk0, qk1, v0, v1, valid0, valid1,
                                           shift)
    b, _, m, d = qk0.shape
    bias0, bias1 = _biases(valid0, valid1, b, m, qk1.shape[2], qk0.device)
    if shift is None:
        out = launch_cross(qk0, qk1, v0, v1, bias0, bias1, EXACT, d ** -0.5)
        _build.count("fused_cross_attention")
    else:
        out = launch_cross(qk0, qk1, v0, v1, bias0, bias1, SHIFT,
                           d ** -0.5 * LOG2E, shift * LOG2E)
        _build.count("fused_cross_attention_shift")
    return out
