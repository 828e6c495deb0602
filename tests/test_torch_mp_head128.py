"""The matcher's bf16 path (``mp=True``) at head_dim 128 (descriptor_dim
256, two heads) of lightglue_tpu_torch against the JAX package on the CPU.

The bf16 plain versions of the three kernels the JAX matcher feeds bf16 at
two heads of 128 are held against their Pallas kernels in interpret mode,
fed the same seeded numpy inputs rounded to bf16, within
tests/test_torch_mp.py's ``_close`` (2e-2 max(1, |JAX|) and 2^-6 (|JAX| +
rms(JAX's row)) elementwise): K1 (flash_sdpa, exact and shift 12), B1'
(flash_cross_pair, valid rows) and B5 (fused_self_block at two heads of
128). The output-scaled bound fails K1 at d 128 with one of its 32-key
tiles dropped. The whole matcher, ``LightGlue("superpoint", mp=True,
num_heads=2)`` with the trained layers regrouped to two heads
(tests/test_torch_head128.py's ``two_head_params``), is held against the
JAX matcher at mp (its XLA composition in bf16 on the CPU) under
test_matcher_mp_vs_jax_mp's bars: matches0 and prune equal on >= 99 %,
stop equal, and a score gap within 3e-2 where bf16 moves JAX's own scores
by delta <= 3e-2 from JAX in fp32 on the same pairs, else within 2 delta
(two bf16 compositions, each within delta of the fp32 result, lie within
2 delta of each other); and the premise: the port at mp within 1.25 delta
of JAX in fp32. The regrouped layers were
trained with four heads, and nine bf16 layers carry their rounding
further than at four heads: fixed, JAX at mp lies 6.9e-2 from JAX in
fp32 and the port at mp 5.2e-2 (exact) and 7.8e-2 (shift 12), and the
port lies 5.2e-2 and 8.3e-2 from JAX at mp, over the 3e-2 that
test_matcher_mp_vs_jax_mp holds at four heads (where it sees 2.5e-3);
adaptive, delta 2.9e-2 and the port within 2.7e-2 of JAX at mp.
``BatchMatcher`` at mp with two heads is held to the bit against the
eager forward.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_head128 import two_head_params
from test_torch_mp import (REL, SHIFTS, _close, _inputs, _jmask, _mask, _pair,
                           _scaled, _tmask)

from lightglue_tpu import configs as jconfigs
from lightglue_tpu import weights as jweights
from lightglue_tpu.models import lightglue as jlg
from lightglue_tpu.ops import flash as jflash
from lightglue_tpu.ops import flash_self as jflash_self
from lightglue_tpu_torch import BatchMatcher, configs, weights
from lightglue_tpu_torch.models import lightglue as lg
from lightglue_tpu_torch.ops import flash, flash_cross, flash_cross_block
from lightglue_tpu_torch.ops import flash_self
from lightglue_tpu_torch.parallel import batching
from lightglue_tpu_torch.synthetic import planted_pairs

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BF = torch.bfloat16
MASKS = ["unmasked", "masked", "all_masked"]
NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "weights", "synthetic_superpoint_lightglue.npz")
MODES = {"fixed": dict(depth_confidence=-1.0, width_confidence=-1.0),
         "adaptive": dict(pruning_min_kpts=256)}
_jit_forward = jax.jit(jlg.forward, static_argnames=("conf",))
OWN_MARGIN = 1.25


def _np_tree(p):
    return jax.tree.map(np.array, p)


def _torch_tree(p):
    return jax.tree.map(torch.from_numpy, p)


# --- the kernels' bf16 plain versions against their Pallas kernels ---------


@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("case", MASKS)
def test_flash_sdpa_bf16_d128_vs_pallas(case, shift):
    """K1 (exact) and B1s (shift 12) at (2, 2, 256, 128)."""
    rng = np.random.default_rng(70)
    q, k, v = (_pair(rng.standard_normal((2, 2, 256, 128)).astype(np.float32))
               for _ in range(3))
    valid = _mask(rng, 2, 256, case)
    got = flash.flash_sdpa(q[0], k[0], v[0], _tmask(valid), shift=shift)
    want = jflash.flash_sdpa(q[1], k[1], v[1], _jmask(valid), block_q=128,
                             shift=shift, interpret=True)
    _close(got, want)
    if case == "all_masked" and shift is None:
        assert not got[1].any()


@pytest.mark.parametrize("case", MASKS + ["ragged_m_ne_n"])
def test_flash_cross_pair_bf16_vs_pallas(case):
    """B1': both directions, each an exact K1 call fed bf16 as the TPU pair
    runs it; rows of masked queries carry values no caller reads, so valid
    rows are compared."""
    rng = np.random.default_rng(71)
    m, n = (128, 256) if case == "ragged_m_ne_n" else (256, 256)
    rand = lambda k: _pair(  # noqa: E731
        rng.standard_normal((2, 2, k, 128)).astype(np.float32))
    qk0, qk1, v0, v1 = rand(m), rand(n), rand(m), rand(n)
    valid0 = valid1 = None
    if case != "unmasked":
        valid0 = _mask(rng, 2, m, "masked")
        valid1 = _mask(rng, 2, n, "all_masked" if case == "all_masked"
                       else "masked")
    got = flash.flash_cross_pair(qk0[0], qk1[0], v0[0], v1[0], _tmask(valid0),
                                 _tmask(valid1))
    want = jflash.flash_cross_pair(qk0[1], qk1[1], v0[1], v1[1],
                                   _jmask(valid0), _jmask(valid1),
                                   block_q=128, interpret=True)
    rows = lambda v: None if v is None else np.broadcast_to(  # noqa: E731
        v[:, None], (2, 2, v.shape[1]))
    assert all(o.dtype == BF for o in got)
    _close(got[0], want[0], rows(valid0))
    _close(got[1], want[1], rows(valid1))
    if case == "all_masked":  # no valid key in image 1 for entry 1
        assert not got[0][1].any()


@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("case", MASKS)
def test_fused_self_block_bf16_head128_vs_pallas(case, shift):
    """B5 at two heads of 128: the rotary pairs, the head-major q, k, v
    columns and out_proj's fp32 sum over both heads, rounded once."""
    rng = np.random.default_rng(72)
    b, n, d, heads = 2, 128, 256, 2
    p = _np_tree(jlg._self_block_init(jax.random.key(36), d))
    x_t, x_j = _pair(rng.standard_normal((b, n, d)).astype(np.float32))
    ang = rng.uniform(-3, 3, (b, 1, n, d // heads // 2)).astype(np.float32)
    enc = np.stack([np.cos(ang), np.sin(ang)])
    valid = _mask(rng, b, n, case)
    w = flash_self.prepare(_torch_tree(p), heads, shift, mp=True)
    got = flash_self.fused_self_block(w, x_t, torch.from_numpy(enc),
                                      _tmask(valid))
    want = jflash_self.fused_self_block(
        jax.tree.map(jnp.asarray, p), x_j, jnp.asarray(enc), heads,
        _jmask(valid), shift=shift, interpret=True)
    assert got.dtype == BF
    _close(got, want)


@pytest.mark.parametrize("shift", SHIFTS)
def test_scaled_bound_catches_a_dropped_key_tile_d128(shift):
    """The output-scaled bound fails K1 at head_dim 128 when one 32-key
    tile of 1024 (the d-128 walk's key tile) is skipped."""
    rng = np.random.default_rng(73)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, n, 128)).astype(
        np.float32)).to(BF) for n in (256, 1024, 1024))
    valid = torch.ones(1, 1024, dtype=torch.bool)
    whole = flash.flash_sdpa(q, k, v, valid, shift=shift).float().numpy()
    valid[:, 32:64] = False
    dropped = flash.flash_sdpa(q, k, v, valid, shift=shift).float().numpy()
    rel = float((np.abs(dropped - whole)
                 / np.maximum(1.0, np.abs(whole))).max())
    assert _scaled(dropped, whole) > 1.0, (
        f"reads {_scaled(dropped, whole):.3f} of the scaled bound, "
        f"{rel / REL:.3f} of REL")


# --- the two-head matcher at mp against the JAX matcher at mp ----------------


@pytest.fixture(scope="module")
def jax_mp_two_heads():
    """The JAX matcher at mp with two heads (the trained layers regrouped)
    on planted pairs of 512 keypoints, B 2, fixed and adaptive, with JAX in
    fp32 and the gap between the two on the matches both make; the port's
    regrouped tree."""
    jparams = two_head_params(jweights.load_params(NPZ, dtype=np.float32),
                              jnp.concatenate)
    args = _inputs(planted_pairs(np.random.default_rng(74), 2, 512))
    want = {}
    for mode, over in MODES.items():
        out = [_jit_forward(jparams, jconfigs.lightglue_config(
            "superpoint", mp=mp, num_heads=2, **over), **{
                k: jnp.asarray(v) for k, v in args.items()})
            for mp in (True, False)]
        m0, f0 = (np.asarray(o.matches0) for o in out)
        both = (m0 >= 0) & (f0 >= 0)
        own = np.abs(np.asarray(out[0].matching_scores0)
                     - np.asarray(out[1].matching_scores0))[both].max()
        want[mode] = out[0], out[1], float(own)
    return want, two_head_params(weights.load_params(NPZ), torch.cat), args


def _spy(monkeypatch, calls, targets):
    for mod, name in targets:
        op = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, op=op, name=name, **k: (
            calls.append((name, a[1].dtype)), op(*a, **k))[1])


@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("mode", list(MODES))
def test_two_head_matcher_mp_vs_jax_mp(jax_mp_two_heads, mode, shift,
                                       monkeypatch):
    """The default configuration at two heads of 128 under mp: B5's and
    B1''s bf16 forms (never B6 or K2), against JAX at mp under
    test_matcher_mp_vs_jax_mp's bars."""
    want, params, args = jax_mp_two_heads
    want, fp32, own_gap = want[mode]
    calls = []
    _spy(monkeypatch, calls, (
        (flash_self, "fused_self_block"), (flash, "flash_cross_pair"),
        (flash_cross_block, "fused_cross_block"),
        (flash_cross, "fused_cross_attention")))
    conf = configs.lightglue_config(
        "superpoint", mp=True, num_heads=2, self_softmax_shift=shift,
        cross_softmax_shift=shift, **MODES[mode])
    got = lg.forward(params, conf, **{k: torch.as_tensor(v)
                                      for k, v in args.items()})
    m0, wm0 = got.matches0.numpy(), np.asarray(want.matches0)
    same = float((m0 == wm0).mean())
    assert same >= 0.99, f"matches0 equal on {same:.4f}"
    assert got.stop == int(want.stop)
    for f in ("prune0", "prune1"):
        agree = float((getattr(got, f).numpy()
                       == np.asarray(getattr(want, f))).mean())
        assert agree >= 0.99, f"{f} equal on {agree:.4f}"
    both = (m0 >= 0) & (wm0 >= 0)
    gap = np.abs(got.matching_scores0.numpy()
                 - np.asarray(want.matching_scores0))[both]
    # the port at mp against JAX in fp32, on the matches both make
    f0 = np.asarray(fp32.matching_scores0)
    mine = ((m0 >= 0) & (np.asarray(fp32.matches0) >= 0))
    drift = np.abs(got.matching_scores0.numpy() - f0)[mine].max()
    print(f"{mode} shift {shift}: score gap to JAX at mp {gap.max():.3e}, "
          f"to JAX in fp32 {drift:.3e}; JAX's own mp-to-fp32 gap "
          f"{own_gap:.3e}")
    assert both.sum() > 100 and mine.sum() > 100
    bar = 3e-2 if own_gap <= 3e-2 else 2 * own_gap
    assert drift <= OWN_MARGIN * own_gap and gap.max() <= bar, (
        f"score gap {gap.max():.3e}, to fp32 {drift:.3e}; JAX's own "
        f"{own_gap:.3e}")
    # B5 takes the bf16 x (its first argument the weights), B1' bf16 qk0
    assert calls.count(("fused_self_block", BF)) == 2 * got.stop
    assert calls.count(("flash_cross_pair", BF)) == got.stop
    assert len(calls) == 3 * got.stop
    if mode == "adaptive":
        assert got.stop < conf.n_layers


@pytest.mark.parametrize("mode", list(MODES))
def test_batch_matcher_mp_two_heads_equals_eager(mode):
    """BatchMatcher at mp with two heads on the CPU over two buckets of
    ragged planted pairs: each pair's matches, scores and the batch's stop
    equal to the bit to models.lightglue.forward on its padded batch."""
    conf = configs.lightglue_config("superpoint", mp=True, num_heads=2,
                                    **MODES[mode])
    params = two_head_params(weights.load_params(NPZ), torch.cat)
    rng = np.random.default_rng(75)
    pairs = []
    for n, counts in ((128, (128, 100)), (256, (256, 200, 180))):
        pr = planted_pairs(rng, len(counts), n)
        pairs += [({"keypoints": pr["keypoints0"][i][:k],
                    "descriptors": pr["descriptors0"][i][:k],
                    "image_size": pr["image_size"][i]},
                   {"keypoints": pr["keypoints1"][i],
                    "descriptors": pr["descriptors1"][i],
                    "image_size": pr["image_size"][i]})
                  for i, k in enumerate(counts)]
    bm = BatchMatcher(conf, params, buckets=(128, 256), max_batch=4,
                      device="cpu")
    results = bm.match_pairs(pairs)
    buckets = set()
    for chunk, f0, f1 in bm.padded_batches(pairs):
        buckets.add(f0["keypoints"].shape[1])
        inp = batching.batch_inputs(conf, f0, f1)
        want = lg.forward(bm.params, conf, **{
            k: None if v is None else torch.from_numpy(v)
            for k, v in inp.items()})
        for j, i in enumerate(chunk):
            k0 = pairs[i][0]["keypoints"].shape[0]
            np.testing.assert_array_equal(results[i]["matches0"],
                                          want.matches0[j, :k0].numpy())
            np.testing.assert_array_equal(
                results[i]["matching_scores0"],
                want.matching_scores0[j, :k0].numpy())
            assert results[i]["stop"] == want.stop
    assert buckets == {128, 256}


def test_compute_params_keeps_trees_that_share_layers_apart():
    """two_head_params shares the trained layers (their stacked tensors)
    with the four-head tree and has its own rotary projection: under mp
    each tree gets its own bf16 tree, the bf16 copies of the shared
    linears cast once, so a four-head forward after a two-head one (and
    the reverse) reads its own rotary projection."""
    params = weights.load_params(NPZ)
    params2 = two_head_params(params, torch.cat)
    conf4 = configs.lightglue_config("superpoint", mp=True, **MODES["fixed"])
    conf2 = conf4.replace(num_heads=2)
    t4, t2 = lg.compute_params(params, conf4), lg.compute_params(params2, conf2)
    assert t4["posenc"] is params["posenc"]
    assert t2["posenc"] is params2["posenc"]
    assert lg.compute_params(params, conf4) is t4
    sa4, sa2 = (t["transformers"]["self_attn"] for t in (t4, t2))
    assert sa4["Wqkv"]["w"] is sa2["Wqkv"]["w"]  # one bf16 copy
    pr = planted_pairs(np.random.default_rng(76), 1, 128)
    kw = {k: torch.from_numpy(v) for k, v in (
        ("kpts0", pr["keypoints0"]), ("kpts1", pr["keypoints1"]),
        ("desc0", pr["descriptors0"]), ("desc1", pr["descriptors1"]))}
    first = lg.forward(params, conf4, **kw)
    lg.forward(params2, conf2, **kw)
    again = lg.forward(params, conf4, **kw)
    assert torch.equal(first.matches0, again.matches0)
