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

On CUDA tensors ``launch_cross`` (the one launch helper of K2 and of B6's
attention) runs csrc/flash_cross.cu: both directions on the attention walk
of csrc/attn_tc.cuh, each split over its keys where the query tiles would
leave SMs idle (``cross_splits``). ``cross_launches_plain`` states those
launches in plain PyTorch (``walk_partial_plain`` for one split's state,
``column_shift_plain`` for the column direction's device-side shift, the
states merged by ``flash.merge_splits_plain``); only the tests use it.

Under ``mp`` (bf16 inputs) K2 has a bf16 form (``lg_fused_cross_bf16``, the
TPU kernels fed bf16): qk0 scaled in bf16 before the kernel (as the TPU
wrapper does, and both directions read that product), fp32 scores and
softmax, the weights rounded to bf16 before each P V and the sums adding
the rounded weights (the TPU kernels sum through a ones column of the bf16
V), bf16 messages; ``fused_cross_attention_plain`` states it for bf16
inputs.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from .. import _build
from . import flash
from .flash import LOG2E, key_bias, shift_weights, wide

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
    valid1 (B, N) bool. Returns (m0 (B, H, M, d), m1 (B, H, N, d)). bf16
    inputs (_fused_cross_kernel and _single_pass_cross_kernel fed bf16):
    q0s = qk0 * scale in bf16; exact, e = exp(s - row max) rounded before
    P V1 and summed rounded, the column weights (e * exp(row max - S) *
    valid0) rounded; shift, one rounded exp2 for both directions; bf16
    messages."""
    dt = qk0.dtype
    b, _, m, _ = qk0.shape
    n = qk1.shape[2]
    bias0, bias1 = _biases(valid0, valid1, b, m, n, qk0.device)
    scale = qk0.shape[-1] ** -0.5 * (1.0 if shift is None else LOG2E)
    s = flash.scaled(qk0, scale) @ wide(qk1).transpose(-1, -2)
    if shift is not None:
        if bias0 is not None:
            s = s + bias0[:, None, :, None] + bias1[:, None, None, :]
        e = ec = wide(shift_weights(s, shift * LOG2E).to(dt))
    else:
        if bias1 is not None:
            s = s + bias1[:, None, None, :]
        m_row = s.amax(-1, keepdim=True)
        er = torch.exp(s - m_row)
        e = wide(er.to(dt))
        if dt == torch.bfloat16:  # the TPU kernel's e_c: from e, rounded
            ec = wide((er * torch.exp(m_row - m_row.amax(-2, keepdim=True))
                       ).to(dt))
        else:
            ec = torch.exp(s - s.amax((-2, -1), keepdim=True))
        if bias0 is not None:
            ec = ec * (bias0 >= 0).float()[:, None, :, None]
    m0 = (e @ wide(v1)) / torch.clamp(e.sum(-1, keepdim=True), min=1e-30)
    m1 = (ec.transpose(-1, -2) @ wide(v0)) / torch.clamp(
        ec.sum(-2)[..., None], min=1e-30)
    return m0.to(dt), m1.to(dt)


def cross_splits(dev: torch.device, b: int, h: int, m: int, n: int,
                 mode: int, dtype: torch.dtype = torch.float32
                 ) -> Tuple[int, int]:
    """Key splits (direction 0 over image 1's n keys, direction 1 over
    image 0's m) from ``flash.split_plan`` and the walk's own tile and
    occupancy on ``dev`` (its bf16 form's for a bf16 ``dtype``): the exact
    modes' row and column launches are planned each alone, the shift
    mode's one launch over both directions together."""
    shape = flash.walk_shape(dev.index, HEAD_DIM, dtype)
    walks = (flash.walk_grid(b * h, m, n, shape),
             flash.walk_grid(b * h, n, m, shape))
    if mode == SHIFT:
        return flash.split_plan(walks, shape.sms, shape.per_sm)
    return (flash.split_plan(walks[:1], shape.sms, shape.per_sm)[0],
            flash.split_plan(walks[1:], shape.sms, shape.per_sm)[0])


def launch_cross(qk0, qk1, v0, v1, valid0, valid1, mode: int, scale: float,
                 shift2: float = 0.0,
                 splits: Optional[Sequence[int]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """csrc/flash_cross.cu's launches on CUDA tensors (no launch count: the
    calling op counts). valid0 (B, M), valid1 (B, N): bool masks or None.
    ``scale`` multiplies the queries of both directions; ``mode``: EXACT
    (K2), EXACT_BLOCK (B6's exact attention: the column shift is the
    maximum over valid rows only, and m0 is 0 where image 1 has no valid
    point) or SHIFT (log2-domain scores, ``shift2`` = shift * log2(e)).
    ``splits`` (direction 0's, direction 1's): a study's candidates, else
    ``cross_splits``; the scratch of a split walk is allocated here. bf16
    inputs launch the bf16 form (its scratch fp32, its messages bf16)."""
    b, h, m, d = qk0.shape
    n = qk1.shape[2]
    dt = qk0.dtype
    dev = _build.check_cuda(dtype=dt, qk0=qk0, qk1=qk1, v0=v0, v1=v1)
    if d != HEAD_DIM:
        raise ValueError(
            f"the cross attention kernel takes head_dim {HEAD_DIM}, got {d}")
    if (qk1.shape != (b, h, n, d) or v0.shape != qk0.shape
            or v1.shape != qk1.shape or m < 1 or n < 1):
        raise ValueError(
            f"bad shapes qk0 {tuple(qk0.shape)} qk1 {tuple(qk1.shape)} "
            f"v0 {tuple(v0.shape)} v1 {tuple(v1.shape)}")
    if mode not in (EXACT, EXACT_BLOCK, SHIFT):
        raise ValueError(f"unknown mode {mode}")
    valid0 = flash.mask_arg(valid0, (b, m), dev)
    valid1 = flash.mask_arg(valid1, (b, n), dev)
    if splits is None:
        splits = cross_splits(dev, b, h, m, n, mode, dt)
    key_tile = flash.walk_shape(dev.index, d, dt).key_tile
    scratch = []
    for nq, nk, s in ((m, n, splits[0]), (n, m, splits[1])):
        flash.split_ranges(nk, s, key_tile)  # raises unless 1 <= s <= T
        rows = b * h * nq
        scratch += ([torch.empty(s, rows, d, device=dev),
                     torch.empty(s, rows, 2, device=dev)] if s > 1
                    else [None, None])
    rmax = None if mode == SHIFT else torch.empty(b * h * m, device=dev)
    qk0, qk1, v0, v1 = map(flash.aligned16, (qk0, qk1, v0, v1))
    if dt == torch.bfloat16:
        for name, t in (("qk0", qk0), ("qk1", qk1), ("v0", v0), ("v1", v1)):
            flash.check_tma(name, t)
    m0 = torch.empty_like(qk0)
    m1 = torch.empty_like(qk1)
    _build.launch(_build.typed("lg_fused_cross", dt), dev, qk0, qk1, v0, v1, valid0, valid1, m0, m1, *scratch, rmax, b, h,
                  m, n, mode, *splits, float(scale), float(shift2))
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
    """K2 on CUDA tensors (fp32, or its bf16 form for bf16 inputs), the
    plain version on CPU tensors."""
    if qk0.device.type == "cpu":
        return fused_cross_attention_plain(qk0, qk1, v0, v1, valid0, valid1,
                                           shift)
    d = qk0.shape[-1]
    scale = d ** -0.5 * (1.0 if shift is None else LOG2E)
    dt = qk0.dtype
    if dt == torch.bfloat16:
        # the TPU wrapper's q0s = qk0 * scale in bf16, read by both
        # directions (the column walk's keys)
        _build.check_cuda(dtype=qk0.dtype, qk0=qk0)
        qk0 = qk0 * flash.bf16_value(scale)  # bf16 x bf16, rounded once
        scale = 1.0
    if shift is None:
        out = launch_cross(qk0, qk1, v0, v1, valid0, valid1, EXACT, scale)
        _build.count(_build.typed("fused_cross_attention", dt))
    else:
        out = launch_cross(qk0, qk1, v0, v1, valid0, valid1, SHIFT, scale,
                           shift * LOG2E)
        _build.count(_build.typed("fused_cross_attention_shift", dt))
    return out


# --- the launches in plain PyTorch (tests) ---------------------------------


def walk_partial_plain(q, k, v, kvalid, qvalid, scale: float, walk: str,
                       shift=0.0, zero_empty: bool = True):
    """The state one key split of csrc/attn_tc.cuh::attend_block leaves, in
    plain PyTorch: (unnormalised output (B, H, Nq, d), row max, row sum
    (B, H, Nq)). s = (scale q) k^T + key bias; ``walk`` "exact": weights
    exp(s - row max), the row max -inf where ``zero_empty`` and the split
    has no valid key; "shift": exp2(min(s + query bias - shift, 100));
    "fixed": exp(s + query bias - shift), ``shift`` (B, H) per (batch,
    head). The shifted walks' row max is not used (0)."""
    s = (q * scale) @ k.transpose(-1, -2)
    if kvalid is not None:
        s = s + key_bias(kvalid)[:, None, None, :]
    if walk == "exact":
        mx = s.amax(-1)
        e = torch.exp(s - mx[..., None])
        if zero_empty and kvalid is not None:
            mx = torch.where(kvalid.any(-1)[:, None, None], mx,
                             torch.full_like(mx, -math.inf))
        return e @ v, mx, e.sum(-1)
    if qvalid is not None:
        s = s + key_bias(qvalid)[:, None, :, None]
    if walk == "shift":
        e = shift_weights(s, shift)
    elif walk == "fixed":
        e = torch.exp(s - shift[:, :, None, None])
    else:
        raise ValueError(f"unknown walk {walk!r}")
    return e @ v, torch.zeros_like(s[..., 0]), e.sum(-1)


def column_shift_plain(rmax: torch.Tensor, valid0: Optional[torch.Tensor],
                       valid_rows_only: bool) -> torch.Tensor:
    """The column launch's shift S (B, H): the maximum of the row maxima
    (B, H, M) of its (batch, head), over valid rows of image 0 only with
    ``valid_rows_only`` (B6), and 0 where there is none."""
    if valid_rows_only and valid0 is not None:
        rmax = torch.where(valid0[:, None, :], rmax,
                           torch.full_like(rmax, -math.inf))
    s = rmax.amax(-1)
    return torch.where(s == -math.inf, torch.zeros_like(s), s)


def cross_launches_plain(qk0, qk1, v0, v1, valid0, valid1, mode: int,
                         scale: float, shift2: float = 0.0,
                         splits: Sequence[int] = (1, 1),
                         key_tile: int = 64) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """``launch_cross`` in plain PyTorch, split as the kernels split: each
    direction's keys in ``splits`` ranges of whole key tiles
    (``flash.split_ranges``), the split states merged in order
    (``flash.merge_splits_plain``). Exact modes: the row walk (keys valid1;
    mode EXACT_BLOCK zeroes an entry without a valid key), its merged row
    maxima reduced to S (``column_shift_plain``), then the column walk
    (queries qk1 with valid1's bias, keys qk0 with valid0) with the fixed
    shift S. SHIFT: both directions as shift walks, each with its query
    rows' bias. Returns (m0, m1)."""
    def walk(q, k, v, kvalid, qvalid, s, kind, shift, zero_empty=True):
        states = [walk_partial_plain(
            q, k[:, :, lo:hi], v[:, :, lo:hi],
            None if kvalid is None else kvalid[:, lo:hi], qvalid, scale, kind,
            shift, zero_empty)
            for lo, hi in flash.split_ranges(k.shape[2], s, key_tile)]
        return flash.merge_splits_plain(
            states, None if kind == "exact" else shift), states

    if mode == SHIFT:
        m0, _ = walk(qk0, qk1, v1, valid1, valid0, splits[0], "shift", shift2)
        m1, _ = walk(qk1, qk0, v0, valid0, valid1, splits[1], "shift", shift2)
        return m0, m1
    m0, states = walk(qk0, qk1, v1, valid1, None, splits[0], "exact", 0.0,
                      mode == EXACT_BLOCK)
    rmax = torch.stack([st[1] for st in states]).amax(0)
    shift = column_shift_plain(rmax, valid0, mode == EXACT_BLOCK)
    m1, _ = walk(qk1, qk0, v0, valid0, valid1, splits[1], "fixed", shift)
    return m0, m1
