"""Log assignment + mutual-nearest filtering without the M x N matrix:
kernel K4 and its plain version.

Counterpart of lightglue_tpu/ops/assignment_fused.py::fused_filter_matches
(``_lse_kernel`` + ``_argmax_kernel``, assignment_fused.py:39-234). The
score factors as
    score_ij = 2 sim_ij - lse_row_i - lse_col_j + ls0_i + ls1_j,
so the row/column argmax need only the row/column log-sum-exp. Pass 1 gives
the two log-sum-exps, pass 2 the argmaxes and maxima (ties: lowest index).
The mutual check, threshold and masks run on (B, M)/(B, N) vectors
(ops/assignment.py::mutual_filter).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .. import _build
from .assignment import mutual_filter
from .flash import NEG_INF, key_bias


def _bias(mask: Optional[torch.Tensor], b: int, n: int, device) -> torch.Tensor:
    if mask is None:
        return torch.zeros(b, n, device=device)
    return key_bias(mask).contiguous()


def _terms(ls, lse, mask):
    term = ls - lse
    if mask is not None:
        term = torch.where(mask, term, torch.full_like(term, NEG_INF))
    return term.contiguous()


def _lse(s: torch.Tensor, dim: int) -> torch.Tensor:
    m = s.amax(dim, keepdim=True)
    sums = torch.clamp(torch.exp(s - m).sum(dim, keepdim=True), min=1e-30)
    return (m + torch.log(sums)).squeeze(dim)


def filter_reductions_plain(mdesc0, mdesc1, ls0, ls1, mask0=None, mask1=None):
    """Row/column argmax and max of the log assignment, in plain PyTorch.
    Returns (m0 (B, M), v0 (B, M), m1 (B, N), v1 (B, N))."""
    b, m, _ = mdesc0.shape
    n = mdesc1.shape[1]
    bias0 = _bias(mask0, b, m, mdesc0.device)[:, :, None]
    bias1 = _bias(mask1, b, n, mdesc0.device)[:, None, :]
    sim = mdesc0 @ mdesc1.transpose(1, 2)
    s = sim + bias1 + bias0
    rterm = _terms(ls0, _lse(s, 2), mask0)
    cterm = _terms(ls1, _lse(s, 1), mask1)
    s2 = sim * 2.0 + bias1 + bias0
    v0, m0 = (s2 + cterm[:, None, :]).max(2)
    v1, m1 = (s2 + rterm[:, :, None]).max(1)
    return m0, v0 + rterm, m1, v1 + cterm


def _filter_reductions_kernel(mdesc0, mdesc1, ls0, ls1, mask0, mask1):
    b, m, d = mdesc0.shape
    n = mdesc1.shape[1]
    bias0 = _bias(mask0, b, m, mdesc0.device)
    bias1 = _bias(mask1, b, n, mdesc0.device)
    dev = _build.check_cuda(mdesc0=mdesc0, mdesc1=mdesc1, ls0=ls0, ls1=ls1,
                            bias0=bias0, bias1=bias1)
    if d % 64 or mdesc1.shape != (b, n, d) or m < 1 or n < 1:
        raise ValueError(
            f"fused_filter_matches kernel takes D % 64 == 0 and matching "
            f"shapes, got {tuple(mdesc0.shape)} {tuple(mdesc1.shape)}")
    for name, t, want in (("z0", ls0, (b, m)), ("z1", ls1, (b, n)),
                          ("mask0", bias0, (b, m)), ("mask1", bias1, (b, n))):
        if t.shape != want:
            raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")
    lse_row = torch.empty(b, m, device=dev)
    lse_col = torch.empty(b, n, device=dev)
    _build.launch("lg_assign_lse", dev, mdesc0, mdesc1, bias0, bias1,
                  lse_row, b, m, n, d)
    _build.launch("lg_assign_lse", dev, mdesc1, mdesc0, bias1, bias0,
                  lse_col, b, n, m, d)
    rterm = _terms(ls0, lse_row, mask0)
    cterm = _terms(ls1, lse_col, mask1)
    m0 = torch.empty(b, m, dtype=torch.int32, device=dev)
    v0 = torch.empty(b, m, device=dev)
    m1 = torch.empty(b, n, dtype=torch.int32, device=dev)
    v1 = torch.empty(b, n, device=dev)
    _build.launch("lg_assign_argmax", dev, mdesc0, mdesc1, bias0, bias1,
                  rterm, cterm, m0, v0, b, m, n, d)
    _build.launch("lg_assign_argmax", dev, mdesc1, mdesc0, bias1, bias0,
                  cterm, rterm, m1, v1, b, n, m, d)
    _build.count("fused_filter_matches")
    return m0, v0, m1, v1


def fused_filter_matches(
    mdesc0: torch.Tensor,
    mdesc1: torch.Tensor,
    z0: torch.Tensor,
    z1: torch.Tensor,
    threshold: float,
    mask0: Optional[torch.Tensor] = None,
    mask1: Optional[torch.Tensor] = None,
):
    """Matches from projected descriptors. mdesc0/mdesc1 (B, M/N, D) are
    ALREADY final_proj'ed and scaled by d^-0.25 (reference MatchAssignment,
    lightglue.py:287-296); z0/z1 (B, M/N) are the matchability logits.
    K4 on CUDA tensors, the plain version on CPU tensors.

    Returns (matches0, matches1, mscores0, mscores1) with the
    filter_matches semantics (lightglue.py:302-318).
    """
    ls0 = F.logsigmoid(z0.float()).contiguous()
    ls1 = F.logsigmoid(z1.float()).contiguous()
    reduce = (filter_reductions_plain if mdesc0.device.type == "cpu"
              else _filter_reductions_kernel)
    m0, v0, m1, _ = reduce(mdesc0, mdesc1, ls0, ls1, mask0, mask1)
    return mutual_filter(m0, m1, v0, threshold, mask0, mask1)
