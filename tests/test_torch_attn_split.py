"""The key split and the 3xTF32 products of the attention walk (K1, B1'),
on the CPU.

(a) ``flash.split_ranges`` and ``flash.split_plan``: every key falls in
exactly one split, each split holds at least one key tile, a grid that
fills the card is not split, and both directions of B1' are planned.
(b) The merge algebra of ``csrc/attn_tc.cuh::merge_splits``: the split
states of ``flash.split_partial_plain`` merged by
``flash.merge_splits_plain`` in split order equal ``flash_sdpa_plain``
over all keys within 1e-6 (fp32 sums in another order), and JAX's
``flash_sdpa`` in interpret mode within 2e-5 (the JAX package's own
tolerance, tests/test_flash.py), exact and with shift 12, with masked
keys, a split wholly masked and a batch entry with every key masked (0).
(c) The kernel's operand split in a torch emulation (bit masks on the
fp32 words, as csrc/attn_tc.cuh::split_tf32 computes them): 3xTF32
attention stays within 1e-6 of the float64 result at head_dim 128 on
standard normal inputs (the smoke's scale; fp32 itself is 4.7e-7 off),
where one tf32 pass is 2.5e-4 off and misses the smoke's 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu.ops import flash as jflash
from lightglue_tpu_torch.ops import flash

torch.set_num_threads(1)

SMOKE_TOL = 1e-4  # chip_smoke.py's tolerance of K1 and B1'


# --- (a) the split plan ----------------------------------------------------


@pytest.mark.parametrize("nk,tile", [(1, 64), (63, 64), (64, 64), (65, 32),
                                     (1000, 64), (1024, 32), (2048, 64)])
def test_split_ranges_cover_every_key_once(nk, tile):
    tiles = -(-nk // tile)
    for s in range(1, min(tiles, 8) + 1):
        ranges = flash.split_ranges(nk, s, tile)
        assert len(ranges) == s
        keys = np.concatenate([np.arange(lo, hi) for lo, hi in ranges])
        np.testing.assert_array_equal(keys, np.arange(nk))
        for lo, hi in ranges:
            assert lo % tile == 0 and hi > lo  # whole tiles, at least one
    with pytest.raises(ValueError):
        flash.split_ranges(nk, tiles + 1, tile)


@pytest.mark.parametrize("blocks,key_tiles,sms,per_sm", [
    (264, 16, 132, 2), (528, 16, 132, 2), (1024, 16, 132, 2),
    (512, 32, 132, 2), (132, 16, 132, 1), (264, 32, 132, 2)])
def test_split_plan_does_not_split_a_full_grid(blocks, key_tiles, sms,
                                               per_sm):
    assert flash.split_plan(((blocks, key_tiles),), sms, per_sm) == (1,)


@pytest.mark.parametrize("blocks,key_tiles,want", [
    (64, 16, 4),  # K1 (1, 4, 1024, 64): 16 tiles of 64 keys
    (32, 32, 8),  # K1 (1, 2, 1024, 128): 32 tiles of 32 keys
    (128, 32, 2),  # K1 (4, 2, 1024, 128): one block an SM without a split
    (2, 1, 1),  # one key tile cannot be split
    (1, 3, 3),  # at most the key tiles
])
def test_split_plan_fills_the_card_at_small_batch(blocks, key_tiles, want):
    (s,) = flash.split_plan(((blocks, key_tiles),), 132, 2)
    assert s == want
    assert 1 <= s <= min(key_tiles, flash.MAX_SPLITS)


def test_split_plan_covers_both_directions_of_b1():
    # B1' at two heads of 128, M 1024 / N 768, key tiles of 32: direction 0
    # has 16 query tiles and 24 key tiles, direction 1 12 and 32
    assert flash.split_plan(((2 * 16, 24), (2 * 12, 32)), 132, 2) == (4, 4)
    assert flash.split_plan(((8 * 16, 24), (8 * 12, 32)), 132, 2) == (4, 4)
    # M 1024 / N 30: direction 0's keys are one tile and are not split,
    # direction 1's are
    s0, s1 = flash.split_plan(((2 * 16, 1), (2 * 1, 32)), 132, 2)
    assert s0 == 1 and s1 > 1


# --- (b) the merge algebra -------------------------------------------------


def _mask(rng, b, n, case, lo_hi):
    if case == "unmasked":
        return None
    valid = rng.uniform(size=(b, n)) < 0.75
    valid[:, 0] = True
    if case == "split_masked":  # one split without a valid key
        valid[:, lo_hi[0]:lo_hi[1]] = False
    if case == "all_masked":
        valid[1] = False
    return valid


@pytest.mark.parametrize("shift", [None, 12.0])
@pytest.mark.parametrize("d,splits,tile", [(64, 3, 64), (128, 4, 32)])
@pytest.mark.parametrize("case", ["unmasked", "masked", "split_masked",
                                  "all_masked"])
def test_merged_splits_equal_the_whole_walk(case, d, splits, tile, shift):
    rng = np.random.default_rng(61)
    b, h, nq, nk = 2, 2, 70, 200
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32)
               for n in (nq, nk, nk))
    ranges = flash.split_ranges(nk, splits, tile)
    valid = _mask(rng, b, nk, case, ranges[1])
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tval = None if valid is None else torch.from_numpy(valid)
    states = [flash.split_partial_plain(
        tq, tk[:, :, lo:hi], tv[:, :, lo:hi],
        None if tval is None else tval[:, lo:hi], shift)
        for lo, hi in ranges]
    got = flash.merge_splits_plain(states, shift)
    whole = flash.flash_sdpa_plain(tq, tk, tv, tval, shift)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=1e-6, rtol=0)
    want = jflash.flash_sdpa(*map(jnp.asarray, (q, k, v)),
                             None if valid is None else jnp.asarray(valid),
                             block_q=128, shift=shift, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)
    if case == "all_masked":
        assert not got[1].any()
    if case == "split_masked" and shift is None:
        assert bool((states[1][1] == -np.inf).all())


# --- (c) 3xTF32 ------------------------------------------------------------

_LOW13 = -0x2000  # int32 0xffffe000: the bits a tensor core reads of a tf32


def _tf32_read(x):
    """What a tensor core reads of an fp32 word given as a tf32 operand."""
    return (x.view(torch.int32) & _LOW13).view(torch.float32)


def _split3(x):
    """csrc/attn_tc.cuh::split_tf32: big = x truncated, small = x - big
    plus half a tf32 unit (then truncated by the reader)."""
    big = _tf32_read(x)
    small = ((x - big).view(torch.int32) + 0x1000).view(torch.float32)
    return big, _tf32_read(small)


def _mm3(a, b):
    """a @ b as the kernel's three tf32 products (each exact in fp32)."""
    (ab, as_), (bb, bs) = _split3(a), _split3(b)
    return as_ @ bb + ab @ bs + ab @ bb


def _mm1(a, b):
    """a @ b as one tf32 pass, operands rounded to nearest."""
    rnd = lambda x: ((x.view(torch.int32) + 0x1000) & _LOW13).view(  # noqa
        torch.float32)
    return rnd(a) @ rnd(b)


def _attention(q, k, v, mm):
    s = mm(q * q.shape[-1] ** -0.5, k.transpose(-1, -2))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return mm(e, v) / e.sum(-1, keepdim=True)


def test_3xtf32_keeps_fp32_where_1xtf32_misses_the_tolerance():
    rng = np.random.default_rng(62)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 256, 128)).astype(
        np.float32)) for _ in range(3))
    exact = flash.flash_sdpa_plain(q.double(), k.double(), v.double())
    err = {name: float((_attention(q, k, v, mm).double() - exact).abs().max())
           for name, mm in (("fp32", torch.matmul), ("3xtf32", _mm3),
                            ("1xtf32", _mm1))}
    assert err["fp32"] <= 5e-7 and err["3xtf32"] <= 1e-6, err
    assert err["1xtf32"] > SMOKE_TOL, err
