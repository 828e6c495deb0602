"""Masked scaled dot-product attention: kernel K1 and its plain version.

Counterpart of lightglue_tpu/ops/flash.py::flash_sdpa: the exact variant
(``_attn_kernel_4d``, flash.py:94-217) and, with ``shift`` set, the
constant-shift variant (``_attn_kernel_shift``, flash.py:63-91). On a CUDA
tensor ``flash_sdpa`` launches ``csrc/flash_sdpa.cu`` or raises; on a CPU
tensor it runs ``flash_sdpa_plain``, the same function in plain PyTorch.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _build

NEG_INF = -1e30  # additive bias of a masked key
HEAD_DIM = 64  # the only head_dim the attention kernels take
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
    if d != HEAD_DIM:
        raise ValueError(f"flash_sdpa kernel takes head_dim {HEAD_DIM}, got {d}")
    if k.shape != (b, h, nk, d) or v.shape != k.shape or nk < 1:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if kbias is not None and kbias.shape != (b, nk):
        raise ValueError(f"k_valid must be ({b}, {nk}), got {tuple(kbias.shape)}")
    scale = d ** -0.5 * (1.0 if shift is None else LOG2E)
    shift2 = 0.0 if shift is None else shift * LOG2E
    o = torch.empty_like(q)
    _build.launch("lg_flash_sdpa", dev, q, k, v, kbias, o, b, h, nq, nk,
                  int(shift is not None), float(scale), float(shift2))
    _build.count("flash_sdpa_shift" if shift is not None else "flash_sdpa")
    return o
