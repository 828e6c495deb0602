"""Composed attention ops (counterpart of lightglue_tpu/ops/attention.py).

Boolean masks mark VALID entries. Masked scores take the finite MASK_VALUE,
and query rows with no valid key come out as zero (the reference's
``nan_to_num`` after SDPA, lightglue.py:121,130). These are the
``conf.flash=False`` debug path; the kernels live in ops/flash*.py.
"""

from __future__ import annotations

from typing import Optional

import torch

MASK_VALUE = -1e9


def _safe_softmax(sim: torch.Tensor, dim: int = -1) -> torch.Tensor:
    simf = sim.float()
    m = simf.amax(dim, keepdim=True)
    e = torch.exp(simf - m)
    return e / torch.clamp(e.sum(dim, keepdim=True), min=1e-30)


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Scaled dot-product attention over (..., N, head_dim); ``mask``
    broadcastable to (..., Nq, Nk), True = attend."""
    scale = q.shape[-1] ** -0.5
    sim = (q @ k.transpose(-1, -2)) * scale
    if mask is not None:
        sim = torch.where(mask, sim, torch.full_like(sim, MASK_VALUE))
    out = _safe_softmax(sim, -1).to(v.dtype) @ v
    if mask is not None:
        row_valid = mask.any(-1, keepdim=True)
        out = torch.where(row_valid, out, torch.zeros_like(out))
    return out


def bidirectional_cross_attention(
    qk0: torch.Tensor,
    qk1: torch.Tensor,
    v0: torch.Tensor,
    v1: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
):
    """Shared-QK cross attention (reference CrossBlock, lightglue.py:
    216-225): one similarity matrix gives messages both ways.

    qk0 (..., M, d), qk1 (..., N, d); mask broadcastable to (..., M, N).
    Returns (m0 into image0 from v1, m1 into image1 from v0).
    """
    scale = qk0.shape[-1] ** -0.5
    sim = (qk0 @ qk1.transpose(-1, -2)) * scale
    if mask is not None:
        sim = torch.where(mask, sim, torch.full_like(sim, MASK_VALUE))
    m0 = _safe_softmax(sim, -1).to(v1.dtype) @ v1
    m1 = _safe_softmax(sim, -2).to(v0.dtype).transpose(-1, -2) @ v0
    if mask is not None:
        m0 = torch.where(mask.any(-1, keepdim=True), m0, torch.zeros_like(m0))
        m1 = torch.where(mask.any(-2)[..., None], m1, torch.zeros_like(m1))
    return m0, m1
