"""Log-assignment head and mutual-nearest filtering, composed and mask-aware
(counterpart of lightglue_tpu/ops/assignment.py; reference
lightglue.py:265-318). The ``conf.flash=False`` debug path; the kernel is
ops/assignment_fused.py."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import nn
from .attention import MASK_VALUE


def _masked_log_softmax(
    x: torch.Tensor, mask: Optional[torch.Tensor], dim: int
) -> torch.Tensor:
    xf = x.float()
    if mask is not None:
        xf = torch.where(mask, xf, torch.full_like(xf, MASK_VALUE))
    # the max only shifts: no gradient through it, as the JAX package's
    # stop_gradient (the values are the same either way)
    shifted = xf - xf.amax(dim, keepdim=True).detach()
    return shifted - torch.log(torch.exp(shifted).sum(dim, keepdim=True))


def sigmoid_log_double_softmax(
    sim: torch.Tensor,
    z0: torch.Tensor,
    z1: torch.Tensor,
    mask0: Optional[torch.Tensor] = None,
    mask1: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Log assignment (B, M+1, N+1) from sim (B, M, N) and matchability
    logits z0 (B, M, 1), z1 (B, N, 1); dustbins are logsigmoid(-z)."""
    b, m, n = sim.shape
    z0 = z0.float()
    z1 = z1.float()
    certainties = F.logsigmoid(z0) + F.logsigmoid(z1).transpose(1, 2)
    pair_mask = None
    if mask0 is not None or mask1 is not None:
        dev = sim.device
        m0 = mask0[:, :, None] if mask0 is not None else torch.ones(
            b, m, 1, dtype=torch.bool, device=dev)
        m1 = mask1[:, None, :] if mask1 is not None else torch.ones(
            b, 1, n, dtype=torch.bool, device=dev)
        pair_mask = m0 & m1
    inner = (
        _masked_log_softmax(sim, pair_mask, 2)
        + _masked_log_softmax(sim, pair_mask, 1)
        + certainties
    )
    if pair_mask is not None:
        inner = torch.where(pair_mask, inner, torch.full_like(inner, MASK_VALUE))
    scores = sim.new_zeros(b, m + 1, n + 1, dtype=torch.float32)
    scores[:, :m, :n] = inner
    scores[:, :-1, -1] = F.logsigmoid(-z0[..., 0])
    scores[:, -1, :-1] = F.logsigmoid(-z1[..., 0])
    return scores


def match_assignment_init(dim: int, generator: torch.Generator) -> nn.Params:
    return {
        "matchability": nn.linear_init(dim, 1, generator),
        "final_proj": nn.linear_init(dim, dim, generator),
    }


def match_assignment(
    p: nn.Params,
    desc0: torch.Tensor,
    desc1: torch.Tensor,
    mask0: Optional[torch.Tensor] = None,
    mask1: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Assignment scores (B, M+1, N+1) and sim (B, M, N) from descriptors
    (reference: lightglue.py:287-296)."""
    mdesc0 = nn.linear(p["final_proj"], desc0)
    mdesc1 = nn.linear(p["final_proj"], desc1)
    inv = mdesc0.shape[-1] ** -0.25
    sim = (mdesc0 * inv) @ (mdesc1 * inv).transpose(1, 2)
    z0 = nn.linear(p["matchability"], desc0)
    z1 = nn.linear(p["matchability"], desc1)
    return sigmoid_log_double_softmax(sim, z0, z1, mask0, mask1), sim


def get_matchability(p: nn.Params, desc: torch.Tensor) -> torch.Tensor:
    """Sigmoid matchability per point (reference: lightglue.py:298-299)."""
    return torch.sigmoid(nn.linear(p["matchability"], desc).float())[..., 0]


def mutual_filter(
    m0: torch.Tensor,
    m1: torch.Tensor,
    max0: torch.Tensor,
    th: float,
    mask0: Optional[torch.Tensor] = None,
    mask1: Optional[torch.Tensor] = None,
):
    """Mutual-nearest check, threshold and masks on the row/column argmax
    (m0 (B, M), m1 (B, N) int) and row max scores ``max0`` (B, M)
    (reference: lightglue.py:306-318)."""
    m0 = m0.long()
    m1 = m1.long()
    idx0 = torch.arange(m0.shape[1], device=m0.device)[None]
    idx1 = torch.arange(m1.shape[1], device=m1.device)[None]
    mutual0 = idx0 == torch.gather(m1, 1, m0)
    mutual1 = idx1 == torch.gather(m0, 1, m1)
    zero = torch.zeros((), device=max0.device)
    mscores0 = torch.where(mutual0, torch.exp(max0.float()), zero)
    mscores1 = torch.where(mutual1, torch.gather(mscores0, 1, m1), zero)
    valid0 = mutual0 & (mscores0 > th)
    valid1 = mutual1 & torch.gather(valid0, 1, m1)
    if mask0 is not None:
        valid0 = valid0 & mask0
        mscores0 = torch.where(mask0, mscores0, zero)
    if mask1 is not None:
        valid1 = valid1 & mask1
        mscores1 = torch.where(mask1, mscores1, zero)
    m0 = torch.where(valid0, m0, -1).int()
    m1 = torch.where(valid1, m1, -1).int()
    return m0, m1, mscores0, mscores1


def filter_matches(
    scores: torch.Tensor,
    th: float,
    mask0: Optional[torch.Tensor] = None,
    mask1: Optional[torch.Tensor] = None,
):
    """Mutual-nearest matches from a (B, M+1, N+1) log assignment.
    Returns (m0 (B, M) int32, m1 (B, N) int32, mscores0, mscores1)."""
    inner = scores[:, :-1, :-1]
    max0, m0 = inner.max(2)
    m1 = inner.argmax(1)
    return mutual_filter(m0, m1, max0, th, mask0, mask1)
