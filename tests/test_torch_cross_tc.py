"""K2 on the attention walk (ops/flash_cross.py over csrc/flash_cross.cu and
csrc/attn_tc.cuh) on the CPU: its launches stated in plain PyTorch.

K2's two directions are walks of attn_tc.cuh: the row walk (queries qk0,
keys qk1 with valid1, exact) and, in the exact modes, the column walk
(queries qk1 with valid1's bias, keys qk0 with valid0) with the fixed
shift S, the maximum of the row walk's row maxima per (batch, head); with
a shift, two shift walks. ``flash_cross.cross_launches_plain`` states
those launches, each direction split over its keys as the kernel splits
it and the states merged in split order.

(a) The row walk's flags: mode 0 (K2 exact) gives an entry whose image 1
is all masked the mean of v1, mode 1 (B6) gives it 0, mode 2 (shift) gives
the masked rows of image 0 0.
(b) The launches at every split count of either direction, modes 0 and 2,
against ``fused_cross_attention_plain`` within 1e-5 and JAX's
``fused_cross_attention`` in interpret mode within 2e-5 (the JAX package's
tolerance), on valid rows of image 0 where the exact kernels leave the
others unspecified: masked, an all-masked image on either side, ragged
lengths (M 200, N 136: no multiple of the key tile), unmasked.
(c) Mode 1 inside B6 (projection and tail in plain PyTorch around the
launches) against JAX's ``fused_cross_block`` in interpret mode and
``fused_cross_block_plain``, on valid rows.
(d) The column shift S: the maximum over every row (mode 0) or valid rows
only (mode 1), and 0 where no row is valid.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu.models import lightglue as jlg
from lightglue_tpu.ops import flash_cross as jflash_cross
from lightglue_tpu.ops import flash_cross_block as jflash_cross_block
from lightglue_tpu_torch.ops import block_tc, flash, flash_cross
from lightglue_tpu_torch.ops import flash_cross_block

torch.set_num_threads(1)

B, H, M, N, D = 2, 2, 200, 136, 64
SHIFT = 12.0
KEY_TILE = 64  # the walk's key tile at head_dim 64 (csrc/attn_tc.cuh)
CASES = ["unmasked", "masked", "empty0", "empty1"]


def _inputs(seed, case):
    rng = np.random.default_rng(seed)
    qk0, v0 = (rng.standard_normal((B, H, M, D)).astype(np.float32)
               for _ in range(2))
    qk1, v1 = (rng.standard_normal((B, H, N, D)).astype(np.float32)
               for _ in range(2))
    if case == "unmasked":
        return (qk0, qk1, v0, v1), (None, None)
    valid0 = rng.uniform(size=(B, M)) < 0.75
    valid1 = rng.uniform(size=(B, N)) < 0.75
    valid0[:, 0] = valid1[:, 0] = True
    if case == "empty0":
        valid0[1] = False
    if case == "empty1":
        valid1[1] = False
    return (qk0, qk1, v0, v1), (valid0, valid1)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _launches(x, masks, mode, splits):
    scale = D ** -0.5 * (flash.LOG2E if mode == flash_cross.SHIFT else 1.0)
    shift2 = SHIFT * flash.LOG2E if mode == flash_cross.SHIFT else 0.0
    return flash_cross.cross_launches_plain(
        *map(_t, x), *map(_t, masks), mode, scale, shift2, splits, KEY_TILE)


def _rows(valid, n):
    """Every row, or the valid rows (B, H, n) of a mask."""
    if valid is None:
        return np.ones((B, H, n), bool)
    return np.broadcast_to(valid[:, None], (B, H, n))


def _close(got, want, rows, tol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got[rows], want[rows], atol=tol, rtol=0)


def _all_splits():
    return [(s0, s1) for s0 in range(1, -(-N // KEY_TILE) + 1)
            for s1 in range(1, -(-M // KEY_TILE) + 1)]


# --- (a) the row walk's flags ----------------------------------------------


@pytest.mark.parametrize("splits", [(1, 1), (3, 4)])
def test_exact_row_walk_averages_an_all_masked_image(splits):
    x, masks = _inputs(1, "empty1")
    m0, _ = _launches(x, masks, flash_cross.EXACT, splits)
    want = np.broadcast_to(x[3][1].mean(1, keepdims=True), (H, M, D))
    np.testing.assert_allclose(m0[1].numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("splits", [(1, 1), (3, 4)])
def test_block_row_walk_zeroes_an_all_masked_image(splits):
    x, masks = _inputs(2, "empty1")
    m0, _ = _launches(x, masks, flash_cross.EXACT_BLOCK, splits)
    assert not m0[1].any()
    assert m0[0].abs().amax() > 0


@pytest.mark.parametrize("splits", [(1, 1), (2, 3)])
def test_shift_walks_zero_masked_rows(splits):
    x, masks = _inputs(3, "masked")
    m0, m1 = _launches(x, masks, flash_cross.SHIFT, splits)
    assert not m0.numpy()[~_rows(masks[0], M)].any()
    assert not m1.numpy()[~_rows(masks[1], N)].any()


# --- (b) the launches at every split count ---------------------------------


@pytest.mark.parametrize("mode", [flash_cross.EXACT, flash_cross.SHIFT])
@pytest.mark.parametrize("case", CASES)
def test_launches_equal_k2_at_every_split(case, mode):
    x, masks = _inputs(4, case)
    shift = SHIFT if mode == flash_cross.SHIFT else None
    want = flash_cross.fused_cross_attention_plain(
        *map(_t, x), *map(_t, masks), shift)
    jwant = jflash_cross.fused_cross_attention(
        *map(jnp.asarray, x), *map(_j, masks), interpret=True, shift=shift)
    rows0 = (_rows(masks[0], M) if mode == flash_cross.EXACT
             else _rows(None, M))
    for splits in _all_splits():
        m0, m1 = _launches(x, masks, mode, splits)
        _close(m0, want[0], rows0, 1e-5)
        _close(m1, want[1], _rows(None, N), 1e-5)
        _close(m0, jwant[0], rows0, 2e-5)
        _close(m1, jwant[1], _rows(masks[1], N), 2e-5)


# --- (c) mode 1 inside B6 --------------------------------------------------


def _np_tree(p):
    return {k: _np_tree(v) if isinstance(v, dict) else np.array(v)
            for k, v in p.items()}


def _torch_tree(p):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in p.items()}


@pytest.mark.parametrize("shift", [None, SHIFT])
@pytest.mark.parametrize("case", CASES)
def test_block_attention_in_b6(case, shift):
    rng = np.random.default_rng(5)
    d = H * D
    p = _np_tree(jlg._cross_block_init(jax.random.key(6), d))
    x0 = rng.standard_normal((B, M, d)).astype(np.float32)
    x1 = rng.standard_normal((B, N, d)).astype(np.float32)
    _, (valid0, valid1) = _inputs(7, case)
    w = flash_cross_block.prepare(_torch_tree(p), H, shift)
    mode = flash_cross.EXACT_BLOCK if shift is None else flash_cross.SHIFT
    want = jflash_cross_block.fused_cross_block(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x0), jnp.asarray(x1), H,
        _j(valid0), _j(valid1), shift=shift, interpret=True)
    xs = [torch.from_numpy(x0), torch.from_numpy(x1)]
    plain = flash_cross_block.fused_cross_block_plain(w, *xs, _t(valid0),
                                                      _t(valid1))
    (qk0, v0), (qk1, v1) = block_tc.project_plain(w, xs, 2)
    for splits in ((1, 1), (3, 4), (2, 1)):
        m0, m1 = flash_cross.cross_launches_plain(
            qk0, qk1, v0, v1, _t(valid0), _t(valid1), mode, 1.0,
            0.0 if shift is None else shift * flash.LOG2E, splits, KEY_TILE)
        out = block_tc.tail_chain_plain(w, [m0, m1], xs)
        for i, valid in enumerate((valid0, valid1)):
            rows = np.ones(x0.shape[:1] + (out[i].shape[1],), bool) \
                if valid is None else valid
            _close(out[i], plain[i], rows, 1e-5)
            _close(out[i], want[i], rows, 2e-5)


# --- (d) the column shift --------------------------------------------------


def test_column_shift_reads_valid_rows_only_in_block_mode():
    rmax = torch.tensor([[[1.0, 5.0, -2.0], [0.5, -math.inf, 3.0]]])
    valid0 = torch.tensor([[True, False, True]])
    s = flash_cross.column_shift_plain(rmax, valid0, False)
    assert s.tolist() == [[5.0, 3.0]]
    s = flash_cross.column_shift_plain(rmax, valid0, True)
    assert s.tolist() == [[1.0, 3.0]]
    s = flash_cross.column_shift_plain(rmax, torch.zeros_like(valid0), True)
    assert s.tolist() == [[0.0, 0.0]]
    # an all-masked image 1: every score, and so S, is -1e30
    rmax = torch.full((1, 2, 3), flash.NEG_INF)
    assert torch.equal(flash_cross.column_shift_plain(rmax, None, False),
                       torch.full((1, 2), flash.NEG_INF))
