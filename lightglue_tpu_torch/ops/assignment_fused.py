"""Log assignment + mutual-nearest filtering without the M x N matrix:
kernel K4 (B2) and its plain version.

Counterpart of lightglue_tpu/ops/assignment_fused.py::fused_filter_matches
(``_lse_kernel`` + ``_argmax_kernel``, assignment_fused.py:39-234). The
score factors as
    score_ij = 2 sim_ij - lse_row_i - lse_col_j + ls0_i + ls1_j,
so the row/column argmax need only the row/column log-sum-exp. Pass 1 gives
the two log-sum-exps, pass 2 the argmaxes and maxima (ties: lowest index).
The mutual check, threshold and masks run on (B, M)/(B, N) vectors
(ops/assignment.py::mutual_filter).

On CUDA tensors each pass is one launch of csrc/assignment_fused.cu's score
tile over a (column tile, row tile, batch) grid, which reduces every score
tile in both directions to per-tile partials, and one merge launch; the
tile comes from ``tile_plan``. ``tile_partials_plain``, ``merge_lse_plain``
and ``merge_argmax_plain`` state the partials and their merges in plain
PyTorch, ``filter_reductions_tiled_plain`` the two passes with them; only
the tests use them.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import _build
from .assignment import mutual_filter
from . import block_tc
from .block_tc import TILES
from .flash import NEG_INF, aligned16, key_bias, mask_arg


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


@functools.lru_cache(maxsize=1024)
def tile_plan(b: int, m: int, n: int, sms: int) -> int:
    """Index into block_tc.TILES of B2's score tile for ``b`` pairs of
    ``m`` x ``n`` scores on a card of ``sms`` SMs: the largest tile whose
    grid (b ceil(m / rows) ceil(n / cols) blocks) gives every SM a block,
    else the smallest; the rule of block_tc.tile_plan, with ragged edges."""
    for i, (bm, bn) in enumerate(TILES):
        if b * -(-m // bm) * -(-n // bn) >= sms:
            return i
    return len(TILES) - 1


def _filter_reductions_kernel(mdesc0, mdesc1, ls0, ls1, mask0, mask1):
    """B2's four launches on CUDA tensors, at ``tile_plan``'s tile."""
    b, m, d = mdesc0.shape
    n = mdesc1.shape[1]
    dev = _build.check_cuda(mdesc0=mdesc0, mdesc1=mdesc1, ls0=ls0, ls1=ls1)
    if d % 32 or mdesc1.shape != (b, n, d) or m < 1 or n < 1:
        raise ValueError(
            f"fused_filter_matches kernel takes D % 32 == 0 and matching "
            f"shapes, got {tuple(mdesc0.shape)} {tuple(mdesc1.shape)}")
    for name, t, want in (("z0", ls0, (b, m)), ("z1", ls1, (b, n))):
        if t.shape != want:
            raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")
    mask0 = mask_arg(mask0, (b, m), dev)
    mask1 = mask_arg(mask1, (b, n), dev)
    tile = tile_plan(b, m, n, block_tc.sms(dev.index))
    bm, bn = TILES[tile]
    rt, ct = -(-m // bm), -(-n // bn)
    d0, d1 = aligned16(mdesc0), aligned16(mdesc1)
    rowp = torch.empty(b, ct, m, 2, device=dev)
    colp = torch.empty(b, rt, n, 2, device=dev)
    rterm = torch.empty(b, m, device=dev)
    cterm = torch.empty(b, n, device=dev)
    _build.launch("lg_assign_tiles", dev, d0, d1, mask0, mask1, None, None,
                  rowp, colp, b, m, n, d, tile)
    _build.launch("lg_assign_merge_lse", dev, rowp, colp, ls0, ls1, mask0,
                  mask1, rterm, cterm, b, m, n, rt, ct)
    _build.launch("lg_assign_tiles", dev, d0, d1, mask0, mask1, rterm, cterm,
                  rowp, colp, b, m, n, d, tile)
    m0 = torch.empty(b, m, dtype=torch.int32, device=dev)
    v0 = torch.empty(b, m, device=dev)
    m1 = torch.empty(b, n, dtype=torch.int32, device=dev)
    v1 = torch.empty(b, n, device=dev)
    _build.launch("lg_assign_merge_argmax", dev, rowp, colp, rterm, cterm, m0,
                  v0, m1, v1, b, m, n, rt, ct)
    _build.count("fused_filter_matches")
    return m0, v0, m1, v1


# --- the launches in plain PyTorch (tests) ---------------------------------


def tile_partials_plain(mdesc0, mdesc1, mask0, mask1, tile: Tuple[int, int],
                        rterm=None, cterm=None):
    """One pass of csrc/assignment_fused.cu's score tiles in plain PyTorch,
    tile (rows, cols). Pass 1 (terms None): s = sim + bias1 + bias0; each
    row's (max, sum of exp(s - max)) over each column tile, (B, CT, M)
    each, and each column's over each row tile, (B, RT, N). Pass 2: t = 2
    sim + bias1 + bias0; each row's (max, first index) of t + cterm over
    each column tile, each column's of t + rterm over each row tile.
    Returns ((row max, row sum or index), (column max, column sum or
    index))."""
    b, m, _ = mdesc0.shape
    n = mdesc1.shape[1]
    bm, bn = tile
    sim = mdesc0 @ mdesc1.transpose(1, 2)
    bias0 = _bias(mask0, b, m, mdesc0.device)[:, :, None]
    bias1 = _bias(mask1, b, n, mdesc0.device)[:, None, :]
    if rterm is None:
        rows = cols = sim + bias1 + bias0
    else:
        t = sim * 2.0 + bias1 + bias0
        rows, cols = t + cterm[:, None, :], t + rterm[:, :, None]

    def parts(x, size, dim):
        out = []
        for lo in range(0, x.shape[dim], size):
            blk = x.narrow(dim, lo, min(size, x.shape[dim] - lo))
            mx, arg = blk.max(dim)
            if rterm is None:
                out.append((mx, torch.exp(blk - mx.unsqueeze(dim)).sum(dim)))
            else:
                out.append((mx, arg + lo))
        return (torch.stack([p[0] for p in out], 1),
                torch.stack([p[1] for p in out], 1))

    return parts(rows, bn, 2), parts(cols, bm, 1)


def merge_lse_plain(mx: torch.Tensor, sums: torch.Tensor) -> torch.Tensor:
    """Partials (B, T, n) merged in tile order into the log-sum-exp (B, n):
    m = max_t mx_t, l = sum_t sums_t exp(mx_t - m), m + log(max(l, 1e-30))."""
    m = mx.amax(1)
    l = 0.0
    for t in range(mx.shape[1]):
        l = l + sums[:, t] * torch.exp(mx[:, t] - m)
    return m + torch.log(torch.clamp(l, min=1e-30))


def merge_argmax_plain(mx: torch.Tensor, idx: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partials (B, T, n) merged in increasing tile order with a strict >:
    (max, the lowest index that reaches it) (B, n)."""
    best, arg = mx[:, 0], idx[:, 0]
    for t in range(1, mx.shape[1]):
        better = mx[:, t] > best
        best = torch.where(better, mx[:, t], best)
        arg = torch.where(better, idx[:, t], arg)
    return best, arg


def filter_reductions_tiled_plain(mdesc0, mdesc1, ls0, ls1, mask0=None,
                                  mask1=None, tile=TILES[0]):
    """``filter_reductions_plain`` as the kernels compute it: both passes
    through ``tile_partials_plain`` and the merges. Returns (m0, v0, m1,
    v1)."""
    (rmx, rsum), (cmx, csum) = tile_partials_plain(mdesc0, mdesc1, mask0,
                                                   mask1, tile)
    rterm = _terms(ls0, merge_lse_plain(rmx, rsum), mask0)
    cterm = _terms(ls1, merge_lse_plain(cmx, csum), mask1)
    (rmx, ridx), (cmx, cidx) = tile_partials_plain(
        mdesc0, mdesc1, mask0, mask1, tile, rterm, cterm)
    v0, m0 = merge_argmax_plain(rmx, ridx)
    v1, m1 = merge_argmax_plain(cmx, cidx)
    return m0, v0 + rterm, m1, v1 + cterm


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
