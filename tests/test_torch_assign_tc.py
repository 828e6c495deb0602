"""B2 on the tile product (ops/assignment_fused.py over
csrc/assignment_fused.cu and csrc/gemm_tc.cuh) on the CPU: its tile
partials and their merges stated in plain PyTorch.

Each pass of the kernel computes every score tile once and reduces it both
ways to partials, one per (row, column tile) and per (column, row tile):
(max, sum of exp(s - max)) in pass 1, (max, first index) in pass 2; a merge
launch combines them in tile order. ``filter_reductions_tiled_plain`` runs
both passes with ``tile_partials_plain``, ``merge_lse_plain`` and
``merge_argmax_plain``.

(a) At every tile of gemm_tc.cuh, the tiled reductions equal
``filter_reductions_plain``: the maxima within 1e-5, the argmaxes exactly
(the same scores, ties to the lowest index): M != N and ragged (no multiple
of any tile), masked, with image 1 of a batch entry all masked, unmasked.
(b) The matches from them (mutual check, threshold) against JAX's
``fused_filter_matches`` in interpret mode: matches exactly equal, scores
within 1e-5.
(c) Planted exact ties inside a tile and across a row-tile and a
column-tile boundary go to the lowest index, as jnp.argmax and the TPU's
running column argmax (strict >) take them.
(d) The merges: log-sum-exp by max-rescale equals one logsumexp over all
scores; the argmax merge keeps the earlier tile on a tie.
(e) ``tile_plan``: every SM gets a block at B 1, 4 and 16, the largest such
tile is taken, and the grid covers each score once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lightglue_tpu.ops import assignment_fused as jfasg
from lightglue_tpu_torch.ops import assignment_fused as fasg
from lightglue_tpu_torch.ops.assignment import mutual_filter
from lightglue_tpu_torch.ops.block_tc import TILES

torch.set_num_threads(1)

B, M, N, D = 2, 200, 136, 64
TH = 0.1  # the matcher's filter_threshold
CASES = ["unmasked", "masked", "empty1"]


def _inputs(seed, case, m=M, n=N):
    rng = np.random.default_rng(seed)
    d0 = (rng.standard_normal((B, m, D)) * 0.4).astype(np.float32)
    d1 = (rng.standard_normal((B, n, D)) * 0.4).astype(np.float32)
    # planted matches so that the mutual check keeps some
    for i, j in ((3, 7), (50, 120), (130, 64), (199, 0)):
        if i < m and j < n:
            d0[:, i] = d1[:, j] * 3.0
    z0 = rng.standard_normal((B, m)).astype(np.float32)
    z1 = rng.standard_normal((B, n)).astype(np.float32)
    if case == "unmasked":
        return (d0, d1, z0, z1), (None, None)
    mask0 = rng.uniform(size=(B, m)) < 0.8
    mask1 = rng.uniform(size=(B, n)) < 0.8
    mask0[:, [3, 50, 130]] = mask1[:, [7, 120, 64]] = True
    if case == "empty1":
        mask1[1] = False
    return (d0, d1, z0, z1), (mask0, mask1)


def _torch(x, masks):
    t = [torch.from_numpy(a) for a in x]
    return t[:2] + [F.logsigmoid(t[2]), F.logsigmoid(t[3])], [
        None if a is None else torch.from_numpy(a) for a in masks]


# --- (a) the tiled reductions ----------------------------------------------


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("case", CASES)
def test_tiled_reductions_equal_plain(case, tile):
    (d0, d1, ls0, ls1), masks = _torch(*_inputs(1, case))
    want = fasg.filter_reductions_plain(d0, d1, ls0, ls1, *masks)
    got = fasg.filter_reductions_tiled_plain(d0, d1, ls0, ls1, *masks, tile)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)
    for g, w, mk in ((got[1], want[1], masks[0]), (got[3], want[3], masks[1])):
        rows = torch.ones_like(g, dtype=torch.bool) if mk is None else mk
        torch.testing.assert_close(g[rows], w[rows], rtol=0, atol=1e-5)


# --- (b) the matches against the Pallas kernels ----------------------------


@pytest.mark.parametrize("case", CASES)
def test_tiled_matches_equal_pallas(case):
    x, masks = _inputs(2, case)
    (d0, d1, ls0, ls1), tmasks = _torch(x, masks)
    m0, v0, m1, _ = fasg.filter_reductions_tiled_plain(d0, d1, ls0, ls1,
                                                       *tmasks, TILES[0])
    got = mutual_filter(m0, m1, v0, TH, *tmasks)
    want = jfasg.fused_filter_matches(
        *map(jnp.asarray, x), TH,
        *(None if a is None else jnp.asarray(a) for a in masks),
        interpret=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)
    assert (got[0] >= 0).sum() >= 3  # the planted matches survive


# --- (c) ties ----------------------------------------------------------------


@pytest.mark.parametrize("tile", TILES)
def test_ties_go_to_the_lowest_index(tile):
    bm, bn = tile
    m, n = 2 * bm + 5, 2 * bn + 3
    (d0, d1, z0, z1), _ = _inputs(3, "unmasked", m, n)
    # across the boundaries: row bm - 1 a dominant match of column bn - 1,
    # that column copied to bn (the next column tile), that row to bm (the
    # next row tile); inside a tile: row 1 of column 2, copied to 4
    for r, c, c2, r2 in ((bm - 1, bn - 1, bn, bm), (1, 2, 4, None)):
        d0[:, r] = d1[:, c] * 4.0
        d1[:, c2] = d1[:, c]
        z1[:, c2] = z1[:, c]
        if r2 is not None:
            d0[:, r2] = d0[:, r]
            z0[:, r2] = z0[:, r]
    (t0, t1, ls0, ls1), _ = _torch((d0, d1, z0, z1), (None, None))
    m0, _, m1, _ = fasg.filter_reductions_tiled_plain(t0, t1, ls0, ls1,
                                                      None, None, tile)
    assert (m0[:, bm - 1] == bn - 1).all() and (m0[:, bm] == bn - 1).all()
    assert (m1[:, bn - 1] == bm - 1).all() and (m1[:, bn] == bm - 1).all()
    assert (m0[:, 1] == 2).all() and (m1[:, 2] == 1).all()
    assert (m1[:, 4] == 1).all()
    want = fasg.filter_reductions_plain(t0, t1, ls0, ls1)
    torch.testing.assert_close(m0, want[0], rtol=0, atol=0)
    torch.testing.assert_close(m1, want[2], rtol=0, atol=0)


# --- (d) the merges ----------------------------------------------------------


def test_lse_merge_equals_one_logsumexp():
    rng = np.random.default_rng(4)
    s = torch.from_numpy((rng.standard_normal((2, 5, 300)) * 20).astype(
        np.float32))
    s[1, 2, :] = -1e30  # a row whose scores are all masked
    parts = [s[..., lo:lo + 64] for lo in range(0, 300, 64)]
    mx = torch.stack([p.amax(-1) for p in parts], 1)
    sums = torch.stack([torch.exp(p - p.amax(-1, keepdim=True)).sum(-1)
                        for p in parts], 1)
    got = fasg.merge_lse_plain(mx.reshape(2, len(parts), 5),
                               sums.reshape(2, len(parts), 5))
    torch.testing.assert_close(got, torch.logsumexp(s, -1), rtol=0,
                               atol=1e-5)


def test_argmax_merge_keeps_the_earlier_tile():
    mx = torch.tensor([[[1.0, 3.0], [2.0, 3.0], [2.0, 1.0]]])  # (1, T 3, 2)
    idx = torch.tensor([[[5, 1], [70, 130], [140, 200]]])
    best, arg = fasg.merge_argmax_plain(mx, idx)
    assert best.tolist() == [[2.0, 3.0]] and arg.tolist() == [[70, 1]]


# --- (e) the tile plan -------------------------------------------------------


@pytest.mark.parametrize("b,m,n,want", [
    (1, 1024, 1024, (64, 64)),  # 64 x 128 gives 128 blocks for 132 SMs
    (4, 1024, 1024, (64, 128)), (16, 1024, 1024, (64, 128)),
    (1, 1000, 700, (64, 64)), (4, 1024, 768, (64, 128)),
    (1, 100, 70, (32, 32))])  # too small for any tile: the smallest
def test_tile_plan_gives_every_sm_a_block(b, m, n, want):
    tile = fasg.tile_plan(b, m, n, 132)
    assert TILES[tile] == want
    bm, bn = want
    blocks = b * -(-m // bm) * -(-n // bn)
    assert blocks >= 132 or tile == len(TILES) - 1
    assert -(-m // bm) * bm >= m and -(-n // bn) * bn >= n
    for larger in TILES[:tile]:
        assert b * -(-m // larger[0]) * -(-n // larger[1]) < 132
