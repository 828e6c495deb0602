"""The tensor-core launches of B5 and B6 (ops/block_tc.py over
csrc/blocks.cu and csrc/gemm_tc.cuh) on the CPU: their plain versions, the
LayerNorm statistics their tail passes from lin1 to lin2, the tile plan and
the 3xTF32 products.

(a) ``tail_chain_plain`` (out_proj, lin1 with its LayerNorm partials, lin2
with the partials merged) equals ``fused_ffn_residual_plain(x,
merge_heads(ctx) @ wo + bo)`` from the untouched parameters within 1e-6,
for one segment and for two (B6: both images in one chain).
(b) B5 and B6 through the chain against JAX's ``fused_self_block`` /
``fused_cross_block`` in interpret mode within 2e-5 at the main width (D
256, four heads of 64): unmasked, masked, a batch entry with no valid
point, exact and with shift 12.
(c) The partials' merge (Chan's formula, as lin2's prologue does it):
equal to ``layer_norm`` within 1e-6 in float64 on rows with mean 1e3 and
std 1; in float32 on the same rows within 1e-3 of the float64 result (fp32
``layer_norm`` itself is 1.5e-4 off there, the mean's rounding), where the
sum-and-sum-of-squares form is off by more than 0.1.
(d) ``tile_plan``: the grid covers every output once, gives all 132 SMs a
block for every launch of B5 and B6 at B 1 and 1024 keypoints, and takes
the largest tile at B 16.
(e) The 3xTF32 product of csrc/tc.cuh in a bit-exact torch emulation at
the projection's and lin1's depths (K 256 and 512): the split operands'
products summed exactly stay within 1e-6 of float64, and summed in fp32 as
close as an fp32 product is (2.7e-6 at K 256 on the CPU), where one tf32
pass misses chip_smoke.py's 1e-4.
(f) ``prepare`` stores out_proj and the FFN K-major: exactly the
transposes, with ``p["ffn"]`` (read by B4 and the composed blocks) left as
it was.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu.models import lightglue as jlg
from lightglue_tpu.ops import flash_cross_block as jflash_cross_block
from lightglue_tpu.ops import flash_self as jflash_self
from lightglue_tpu_torch.ops import block_tc, flash_cross_block, flash_self
from lightglue_tpu_torch.ops import ffn as ffn_ops

torch.set_num_threads(1)

SMOKE_TOL = 1e-4  # chip_smoke.py's tolerance of the block kernels
SHIFTS = [None, 12.0]


def _np_tree(p):
    return {k: _np_tree(v) if isinstance(v, dict) else np.array(v)
            for k, v in p.items()}


def _torch_tree(p):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in p.items()}


def _mask(rng, b, n, case):
    """None, a random mask, or a random mask with batch entry 1 empty."""
    if case == "unmasked":
        return None
    valid = rng.uniform(size=(b, n)) < 0.75
    valid[:, 0] = True
    if case == "all_masked":
        valid[1] = False
    return valid


# --- (a) the chain against the FFN residual --------------------------------


@pytest.mark.parametrize("d,heads,ns", [(128, 2, (70,)), (256, 4, (64,)),
                                        (128, 2, (33, 65)),
                                        (256, 4, (40, 24))])
def test_tail_chain_equals_the_ffn_residual(d, heads, ns):
    rng = np.random.default_rng(70)
    b, hd = 2, d // heads
    p = _torch_tree(_np_tree(jlg._self_block_init(jax.random.key(8), d)))
    w = flash_self.prepare(p, heads)
    xs = [torch.from_numpy(rng.standard_normal((b, n, d)).astype(np.float32))
          for n in ns]
    ctxs = [torch.from_numpy(rng.standard_normal((b, heads, n, hd)).astype(
        np.float32)) for n in ns]
    got = block_tc.tail_chain_plain(w, ctxs, xs)
    assert len(got) == len(xs)
    for out, x, ctx in zip(got, xs, ctxs):
        msg = (block_tc.merge_heads(ctx) @ p["out_proj"]["w"]
               + p["out_proj"]["b"])
        want = ffn_ops.fused_ffn_residual_plain(x, msg, p["ffn"])
        assert out.shape == x.shape
        np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-6,
                                   rtol=0)
    # the launch wrappers take the plain versions for CPU tensors
    for a, c in zip(block_tc.tail_chain(w, ctxs, xs), got):
        torch.testing.assert_close(a, c, rtol=0, atol=0)


# --- (b) B5 and B6 at the main width against the Pallas kernels -------------


@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("case", ["unmasked", "masked", "all_masked"])
def test_self_block_chain_vs_pallas(case, shift):
    rng = np.random.default_rng(71)
    b, n, d, heads = 2, 128, 256, 4
    p = _np_tree(jlg._self_block_init(jax.random.key(9), d))
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    ang = rng.uniform(-3, 3, (b, 1, n, d // heads // 2)).astype(np.float32)
    enc = np.stack([np.cos(ang), np.sin(ang)])
    valid = _mask(rng, b, n, case)
    w = flash_self.prepare(_torch_tree(p), heads, shift)
    got = flash_self.fused_self_block(
        w, torch.from_numpy(x), torch.from_numpy(enc),
        None if valid is None else torch.from_numpy(valid))
    want = jflash_self.fused_self_block(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(enc), heads,
        None if valid is None else jnp.asarray(valid), shift=shift,
        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("case", ["unmasked", "masked", "all_masked"])
def test_cross_block_chain_vs_pallas(case, shift):
    rng = np.random.default_rng(72)
    b, m, n, d, heads = 2, 128, 256, 256, 4
    p = _np_tree(jlg._cross_block_init(jax.random.key(10), d))
    x0 = rng.standard_normal((b, m, d)).astype(np.float32)
    x1 = rng.standard_normal((b, n, d)).astype(np.float32)
    valid0 = _mask(rng, b, m, "masked" if case != "unmasked" else case)
    valid1 = _mask(rng, b, n, case)
    w = flash_cross_block.prepare(_torch_tree(p), heads, shift)
    tmask = lambda v: None if v is None else torch.from_numpy(v)  # noqa
    jmask = lambda v: None if v is None else jnp.asarray(v)  # noqa
    got = flash_cross_block.fused_cross_block(
        w, torch.from_numpy(x0), torch.from_numpy(x1), tmask(valid0),
        tmask(valid1))
    want = jflash_cross_block.fused_cross_block(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x0), jnp.asarray(x1), heads,
        jmask(valid0), jmask(valid1), shift=shift, interpret=True)
    for out, ref, valid in ((got[0], want[0], valid0),
                            (got[1], want[1], valid1)):
        out, ref = out.numpy(), np.asarray(ref)
        if valid is not None:  # masked rows carry values no output reads
            out, ref = out[valid], ref[valid]
        np.testing.assert_allclose(out, ref, atol=2e-5, rtol=0)


# --- (c) the LayerNorm statistics --------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_merged_partials_keep_layer_norm_at_a_large_mean(dtype):
    rng = np.random.default_rng(73)
    h = torch.from_numpy((1e3 + rng.standard_normal((256, 512))).astype(
        np.float32))
    truth = torch.nn.functional.layer_norm(h.double(), (512,), eps=1e-5)
    hd = h.to(dtype)
    stats = block_tc.ln_partials_plain(hd)
    assert stats.shape == (256, 512 // block_tc.LN_PART, 2)
    mean, rstd = block_tc.merge_stats_plain(stats)
    err = float((((hd - mean[:, None]) * rstd[:, None]).double()
                 - truth).abs().max())
    if dtype == torch.float64:
        torch.testing.assert_close(
            ((hd - mean[:, None]) * rstd[:, None]),
            torch.nn.functional.layer_norm(hd, (512,), eps=1e-5), rtol=0,
            atol=1e-6)
        return
    assert err < 1e-3, err
    # the same rows through sum and sum of squares
    s1 = hd.mean(-1, keepdim=True)
    var = (hd * hd).mean(-1, keepdim=True) - s1 * s1
    naive = (hd - s1) / torch.sqrt(var.clamp(min=0) + 1e-5)
    assert float((naive.double() - truth).abs().max()) > 0.1


def test_partials_are_centred_on_their_own_mean():
    h = torch.arange(64, dtype=torch.float32).reshape(2, 32)
    stats = block_tc.ln_partials_plain(h)
    np.testing.assert_array_equal(stats[0, :, 0].numpy(), [7.5, 23.5])
    # sum over 16 consecutive integers of (i - 7.5)^2
    np.testing.assert_allclose(stats[0, :, 1].numpy(), [340.0, 340.0])


# --- (d) the tile plan -------------------------------------------------------


def _launches(b, n, m=None):
    """(rows, channels) of each tile-product launch of B5 (m None) or B6
    at D 256."""
    d = 256
    rows = b * n if m is None else b * (n + m)
    groups = 3 if m is None else 2
    return [(rows, groups * d), (rows, d), (rows, 2 * d), (rows, d)]


@pytest.mark.parametrize("rows,cols", [(1024, 768), (1000, 256),
                                       (16384, 512), (70, 384), (1, 256)])
def test_tile_plan_covers_every_output_once(rows, cols):
    bm, bn = block_tc.TILES[block_tc.tile_plan(rows, cols, 132)]
    cover = np.zeros((rows, cols), np.int32)
    for y in range(-(-rows // bm)):  # the grid (C / BN, cdiv(R, BM))
        for x in range(cols // bn):
            cover[y * bm:(y + 1) * bm, x * bn:(x + 1) * bn] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("block", ["B5", "B6"])
def test_tile_plan_fills_the_card_at_b1_and_keeps_large_tiles_at_b16(block):
    m = None if block == "B5" else 1024
    for rows, cols in _launches(1, 1024, m):
        bm, bn = block_tc.TILES[block_tc.tile_plan(rows, cols, 132)]
        assert -(-rows // bm) * (cols // bn) >= 132, (rows, cols, bm, bn)
    for rows, cols in _launches(16, 1024, m):
        assert block_tc.tile_plan(rows, cols, 132) == 0
    with pytest.raises(ValueError):
        block_tc.tile_plan(1024, 96, 132)


# --- (e) 3xTF32 --------------------------------------------------------------

_LOW13 = -0x2000  # int32 0xffffe000: the bits a tensor core reads of a tf32


def _tf32_read(x):
    return (x.view(torch.int32) & _LOW13).view(torch.float32)


def _split3(x):
    """csrc/tc.cuh::split_tf32: big = x truncated, small = x - big plus
    half a tf32 unit (then truncated by the reader)."""
    big = _tf32_read(x)
    small = ((x - big).view(torch.int32) + 0x1000).view(torch.float32)
    return big, _tf32_read(small)


@pytest.mark.parametrize("k", [256, 512])
def test_3xtf32_products_keep_fp32_at_the_block_depths(k):
    rng = np.random.default_rng(74)
    a = torch.from_numpy(rng.standard_normal((128, k)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((256, k))
                          / np.sqrt(k)).astype(np.float32))
    exact = a.double() @ w.double().t()
    (ab, as_), (wb, ws) = _split3(a), _split3(w)

    def three(dt):  # the three tf32 products, summed in dtype
        ab_, as_d, wb_, ws_ = (t.to(dt) for t in (ab, as_, wb, ws))
        return as_d @ wb_.t() + ab_ @ ws_.t() + ab_ @ wb_.t()

    rnd = lambda x: ((x.view(torch.int32) + 0x1000) & _LOW13).view(  # noqa
        torch.float32)
    err = {name: float((got.double() - exact).abs().max())
           for name, got in (("fp32", a @ w.t()),
                             ("3xtf32 split", three(torch.float64)),
                             ("3xtf32", three(torch.float32)),
                             ("1xtf32", rnd(a) @ rnd(w).t()))}
    # the split itself (products summed exactly) is within 1e-6; summed in
    # fp32, as the kernel's accumulators do, it is as close as fp32 is
    assert err["3xtf32 split"] <= 1e-6, err
    assert err["3xtf32"] <= 1.5 * err["fp32"] + 1e-7, err
    assert err["1xtf32"] > SMOKE_TOL, err


# --- (f) prepare -----------------------------------------------------------


@pytest.mark.parametrize("block", ["self", "cross"])
def test_prepare_stores_the_tail_k_major_and_leaves_ffn(block):
    d = 128
    if block == "self":
        p = _torch_tree(_np_tree(jlg._self_block_init(jax.random.key(11), d)))
        w, out_proj = flash_self.prepare(p, 2), p["out_proj"]
    else:
        p = _torch_tree(_np_tree(jlg._cross_block_init(jax.random.key(12), d)))
        w, out_proj = flash_cross_block.prepare(p, 2), p["to_out"]
    ffn = p["ffn"]
    before = copy.deepcopy(ffn)
    for key, want in (("woT", out_proj["w"]), ("w1T", ffn["lin1"]["w"]),
                      ("w2T", ffn["lin2"]["w"])):
        assert w[key].is_contiguous()
        torch.testing.assert_close(w[key].t(), want, rtol=0, atol=0)
    for key, want in (("bo", out_proj["b"]), ("b1", ffn["lin1"]["b"]),
                      ("gamma", ffn["ln"]["scale"]),
                      ("beta", ffn["ln"]["bias"]), ("b2", ffn["lin2"]["b"])):
        torch.testing.assert_close(w[key], want, rtol=0, atol=0)
    assert p["ffn"] is ffn and set(ffn) == {"lin1", "ln", "lin2"}
    for part in ffn:
        for name, t in ffn[part].items():
            torch.testing.assert_close(t, before[part][name], rtol=0, atol=0)
