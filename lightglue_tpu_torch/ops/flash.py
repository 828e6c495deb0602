"""Masked scaled dot-product attention: kernels K1 and B1' and their plain
versions, at head_dim 64 or 128.

Counterpart of lightglue_tpu/ops/flash.py::flash_sdpa: the exact variant
(``_attn_kernel_4d``, flash.py:94-217) and, with ``shift`` set, the
constant-shift variant (``_attn_kernel_shift``, flash.py:63-91); and of
``flash_cross_pair`` (flash.py:220-240), the exact bidirectional shared-QK
cross attention as two passes of that kernel with the roles swapped, which
the JAX matcher runs at head_dim 128. On CUDA tensors ``flash_sdpa`` and
``flash_cross_pair`` launch ``csrc/flash_sdpa.cu`` (B1' both directions in
one launch) or raise; on CPU tensors they run their plain versions, the
same functions in plain PyTorch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _build

NEG_INF = -1e30  # additive bias of a masked key
HEAD_DIMS = (64, 128)  # head_dims of the attention kernels (K1, B1', B5)
LOG2E = 1.4426950408889634  # exp(x) == exp2(x * LOG2E)
SHIFT_CLAMP = 100.0  # largest exp2 argument of the constant-shift softmax


def key_bias(valid: torch.Tensor) -> torch.Tensor:
    """(B, N) bool -> float32 additive bias: 0 valid, -1e30 masked."""
    return (valid.float() - 1.0) * -NEG_INF


def shift_weights(s: torch.Tensor, shift2: float) -> torch.Tensor:
    """Constant-shift softmax weights of log2-domain scores:
    exp2(min(s - shift2, SHIFT_CLAMP)). No row maximum: a masked score
    (-1e30 bias) gives exactly 0."""
    return torch.exp2(torch.clamp(s - shift2, max=SHIFT_CLAMP))


def flash_sdpa_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_valid: Optional[torch.Tensor] = None,
    shift: Optional[float] = None,
) -> torch.Tensor:
    """softmax((q / sqrt(d)) k^T + key bias) v with an fp32 softmax; rows
    of a batch entry whose keys are all masked come out as 0.
    q (B, H, Nq, d); k, v (B, H, Nk, d); k_valid (B, Nk) bool.
    ``shift`` (nats): the constant-shift form, scale * log2(e) folded into
    q and e = exp2(min(s - shift * log2(e), 100)) in place of
    exp(s - max_j s); an all-masked row is 0 because every e is."""
    scale = q.shape[-1] ** -0.5
    if shift is not None:
        scale *= LOG2E
    s = (q * scale) @ k.transpose(-1, -2)
    if k_valid is not None:
        s = s + key_bias(k_valid)[:, None, None, :]
    if shift is not None:
        e = shift_weights(s, shift * LOG2E)
        return (e @ v) / torch.clamp(e.sum(-1, keepdim=True), min=1e-30)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    o = (e @ v) / torch.clamp(e.sum(-1, keepdim=True), min=1e-30)
    if k_valid is not None:
        o = torch.where(k_valid.any(-1)[:, None, None, None], o,
                        torch.zeros_like(o))
    return o


def flash_sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_valid: Optional[torch.Tensor] = None,
    shift: Optional[float] = None,
) -> torch.Tensor:
    """K1 on CUDA tensors, the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return flash_sdpa_plain(q, k, v, k_valid, shift)
    kbias = None if k_valid is None else key_bias(k_valid).contiguous()
    dev = _build.check_cuda(q=q, k=k, v=v, k_bias=kbias)
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_sdpa kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {d}")
    if k.shape != (b, h, nk, d) or v.shape != k.shape or nk < 1:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if kbias is not None and kbias.shape != (b, nk):
        raise ValueError(f"k_valid must be ({b}, {nk}), got {tuple(kbias.shape)}")
    scale = d ** -0.5 * (1.0 if shift is None else LOG2E)
    shift2 = 0.0 if shift is None else shift * LOG2E
    o = torch.empty_like(q)
    _build.launch("lg_flash_sdpa", dev, q, k, v, kbias, o, b, h, nq, nk, d,
                  int(shift is not None), float(scale), float(shift2))
    _build.count("flash_sdpa_shift" if shift is not None else "flash_sdpa")
    return o


def flash_cross_pair_plain(
    qk0: torch.Tensor,
    qk1: torch.Tensor,
    v0: torch.Tensor,
    v1: torch.Tensor,
    valid0: Optional[torch.Tensor] = None,
    valid1: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """m0 = attention(qk0, qk1, v1, valid1), m1 = attention(qk1, qk0, v0,
    valid0), both exact (flash_sdpa_plain). qk0, v0 (B, H, M, d); qk1, v1
    (B, H, N, d); valid0 (B, M), valid1 (B, N) bool. Rows of masked queries
    are not zeroed: callers read valid rows only."""
    return (flash_sdpa_plain(qk0, qk1, v1, valid1),
            flash_sdpa_plain(qk1, qk0, v0, valid0))


def flash_cross_pair(
    qk0: torch.Tensor,
    qk1: torch.Tensor,
    v0: torch.Tensor,
    v1: torch.Tensor,
    valid0: Optional[torch.Tensor] = None,
    valid1: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1' on CUDA tensors (both directions in one launch), the plain
    version on CPU tensors."""
    if qk0.device.type == "cpu":
        return flash_cross_pair_plain(qk0, qk1, v0, v1, valid0, valid1)
    bias0 = None if valid0 is None else key_bias(valid0).contiguous()
    bias1 = None if valid1 is None else key_bias(valid1).contiguous()
    dev = _build.check_cuda(qk0=qk0, qk1=qk1, v0=v0, v1=v1, bias0=bias0,
                            bias1=bias1)
    b, h, m, d = qk0.shape
    n = qk1.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_cross_pair kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    if (qk1.shape != (b, h, n, d) or v0.shape != qk0.shape
            or v1.shape != qk1.shape or m < 1 or n < 1):
        raise ValueError(
            f"bad shapes qk0 {tuple(qk0.shape)} qk1 {tuple(qk1.shape)} "
            f"v0 {tuple(v0.shape)} v1 {tuple(v1.shape)}")
    if ((bias0 is not None and bias0.shape != (b, m))
            or (bias1 is not None and bias1.shape != (b, n))):
        raise ValueError("valid0/valid1 must be (B, M)/(B, N)")
    m0 = torch.empty_like(qk0)
    m1 = torch.empty_like(qk1)
    _build.launch("lg_flash_cross_pair", dev, qk0, qk1, v0, v1, bias0, bias1,
                  m0, m1, b, h, m, n, d, float(d ** -0.5))
    _build.count("flash_cross_pair")
    return m0, m1
