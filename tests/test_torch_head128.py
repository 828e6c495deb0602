"""The matcher at head_dim 128 in lightglue_tpu_torch (descriptor_dim 256,
two heads), against the JAX package on the CPU.

Its kernels' plain versions are held against the Pallas kernels in
interpret mode on the same seeded numpy inputs, within 2e-5 max-abs (the
tolerance of the JAX package's own tests, tests/test_flash.py): K1
(flash_sdpa, exact and shift 12) at d 128, B1' (flash_cross_pair) on valid
rows (neither package zeroes the rows of masked queries, and their values
are read by no valid output), B5 (fused_self_block) at two heads of 128.
The whole matcher, ``LightGlue("superpoint", num_heads=2)`` with the trained
layers regrouped to two heads (``two_head_params``), is held against the
JAX matcher, which on the CPU runs its XLA composition: matches, ``stop``
and ``prune`` exactly equal, scores within 1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu import configs as jconfigs
from lightglue_tpu import weights as jweights
from lightglue_tpu.models import lightglue as jlg
from lightglue_tpu.ops import flash as jflash
from lightglue_tpu.ops import flash_self as jflash_self
from lightglue_tpu_torch import LightGlue, configs, weights
from lightglue_tpu_torch.models import lightglue as lg
from lightglue_tpu_torch.ops import flash, flash_cross, flash_cross_block
from lightglue_tpu_torch.ops import flash_self
from lightglue_tpu_torch.synthetic import planted_pairs

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = 2e-5
SHIFTS = [None, 12.0]
NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "weights", "synthetic_superpoint_lightglue.npz")
MODES = {"fixed": dict(depth_confidence=-1.0, width_confidence=-1.0),
         "adaptive": {}}
_jit_forward = jax.jit(jlg.forward, static_argnames=("conf",))


def two_head_params(params, cat):
    """The trained 4 x 64 layers as 2 x 128: the packed Wqkv column of head
    h, channel j is (h hd + j) 3 + which, so both groupings use the same
    columns; tiling the rotary frequencies [Wr | Wr] gives every channel
    pair its old frequency. Only the softmax grouping changes."""
    w = params["posenc"]["Wr"]["w"]
    return dict(params, posenc={"Wr": {"w": cat([w, w], 1)}})


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, rows=None):
    got, want = np.asarray(got), np.asarray(want)
    if rows is not None:
        got, want = got[rows], want[rows]
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def _mask(rng, b, n, case):
    """None, a random mask, or a random mask with batch entry 1 empty."""
    if case == "unmasked":
        return None
    valid = rng.uniform(size=(b, n)) < 0.75
    valid[:, 0] = True
    if case == "all_masked":
        valid[1] = False
    return valid


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


# --- K1 at head_dim 128 ----------------------------------------------------


@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("case", ["unmasked", "masked", "all_masked"])
def test_flash_sdpa_d128_plain_vs_pallas(case, shift):
    rng = np.random.default_rng(51)
    q, k, v = (_rand(rng, 2, 2, 256, 128) for _ in range(3))
    valid = _mask(rng, 2, 256, case)
    got = flash.flash_sdpa(*map(torch.from_numpy, (q, k, v)), _t(valid),
                           shift=shift)
    want = jflash.flash_sdpa(*map(jnp.asarray, (q, k, v)), _j(valid),
                             block_q=128, shift=shift, interpret=True)
    _close(got, want)
    if case == "all_masked":
        assert not got[1].any()


# --- B1': flash_cross_pair -------------------------------------------------


@pytest.mark.parametrize("case", ["unmasked", "masked", "all_masked"])
def test_flash_cross_pair_plain_vs_pallas(case):
    rng = np.random.default_rng(52)
    qk0, v0 = _rand(rng, 2, 2, 128, 128), _rand(rng, 2, 2, 128, 128)
    qk1, v1 = _rand(rng, 2, 2, 256, 128), _rand(rng, 2, 2, 256, 128)
    valid0 = _mask(rng, 2, 128, "unmasked" if case == "unmasked" else "masked")
    valid1 = _mask(rng, 2, 256, case)
    got = flash.flash_cross_pair(*map(torch.from_numpy, (qk0, qk1, v0, v1)),
                                 _t(valid0), _t(valid1))
    want = jflash.flash_cross_pair(*map(jnp.asarray, (qk0, qk1, v0, v1)),
                                   _j(valid0), _j(valid1), block_q=128,
                                   interpret=True)
    rows = lambda v, h: None if v is None else np.broadcast_to(
        v[:, None], (2, h, v.shape[1]))
    _close(got[0], want[0], rows(valid0, 2))
    _close(got[1], want[1], rows(valid1, 2))
    if case == "all_masked":  # no valid key in image 1 for entry 1
        assert not got[0][1].any()


# --- B5 at two heads of 128 -----------------------------------------------


@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("case", ["unmasked", "masked", "all_masked"])
def test_fused_self_block_head128_plain_vs_pallas(case, shift):
    rng = np.random.default_rng(53)
    b, n, d, heads = 2, 128, 256, 2
    p = jax.tree.map(np.array, jlg._self_block_init(jax.random.key(7), d))
    x = _rand(rng, b, n, d)
    ang = rng.uniform(-3, 3, (b, 1, n, d // heads // 2)).astype(np.float32)
    enc = np.stack([np.cos(ang), np.sin(ang)])
    valid = _mask(rng, b, n, case)
    w = flash_self.prepare(jax.tree.map(torch.from_numpy, p), heads, shift)
    got = flash_self.fused_self_block(w, torch.from_numpy(x),
                                      torch.from_numpy(enc), _t(valid))
    want = jflash_self.fused_self_block(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(enc), heads,
        _j(valid), shift=shift, interpret=True)
    _close(got, want)


# --- the matcher -----------------------------------------------------------


@pytest.fixture(scope="module")
def trained():
    jp = jweights.load_params(NPZ, dtype=np.float32)
    return (two_head_params(jp, jnp.concatenate),
            two_head_params(weights.load_params(NPZ), torch.cat))


def _request(pairs):
    b, m = pairs["keypoints0"].shape[:2]
    n = pairs["keypoints1"].shape[1]
    valid0 = np.ones((b, m), bool)
    valid1 = np.ones((b, n), bool)
    valid0[0, m - 9:] = False  # padded tails
    valid1[-1, n - 13:] = False
    valid1[0, ::7] = False  # scattered invalid slots
    return ({"image0": {"keypoints": pairs["keypoints0"],
                        "descriptors": pairs["descriptors0"],
                        "image_size": pairs["image_size"], "valid": valid0},
             "image1": {"keypoints": pairs["keypoints1"],
                        "descriptors": pairs["descriptors1"],
                        "image_size": pairs["image_size"], "valid": valid1}})


_WANT = {}


def _jax_matcher(params, mode, request):
    if mode not in _WANT:
        jconf = jconfigs.lightglue_config("superpoint", num_heads=2,
                                          pruning_min_kpts=32, **MODES[mode])
        i0, i1 = request["image0"], request["image1"]
        _WANT[mode] = _jit_forward(
            params, jconf, kpts0=jnp.asarray(i0["keypoints"]),
            kpts1=jnp.asarray(i1["keypoints"]),
            desc0=jnp.asarray(i0["descriptors"]),
            desc1=jnp.asarray(i1["descriptors"]),
            size0=jnp.asarray(i0["image_size"]),
            size1=jnp.asarray(i1["image_size"]),
            mask0=jnp.asarray(i0["valid"]), mask1=jnp.asarray(i1["valid"]))
    return _WANT[mode]


def _spy(monkeypatch, calls, targets):
    for mod, name in targets:
        op = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, op=op, name=name, **k: (
            calls.append(name), op(*a, **k))[1])


@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("mode", list(MODES))
def test_two_head_matcher_against_jax(trained, mode, shift, monkeypatch):
    """Full width, two heads of 128, B 2, N 256, masked points, at the
    default configuration: B5 for the self blocks, B1' for the cross
    blocks, never B6 or K2; the shift changes no match."""
    calls = []
    _spy(monkeypatch, calls, (
        (flash_self, "fused_self_block"), (flash, "flash_cross_pair"),
        (flash_cross_block, "fused_cross_block"),
        (flash_cross, "fused_cross_attention")))
    request = _request(planted_pairs(np.random.default_rng(54), 2, 256))
    want = _jax_matcher(trained[0], mode, request)
    matcher = LightGlue("superpoint", params=trained[1], device="cpu",
                        num_heads=2, pruning_min_kpts=32,
                        self_softmax_shift=shift, cross_softmax_shift=shift,
                        **MODES[mode])
    assert matcher.conf.head_dim == 128
    got = matcher(request)
    for f in ("matches0", "matches1", "prune0", "prune1"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert got["stop"] == int(want.stop)
    for f in ("matching_scores0", "matching_scores1"):
        np.testing.assert_allclose(got[f], np.asarray(getattr(want, f)),
                                   atol=1e-4, rtol=0, err_msg=f)
    assert (got["matches0"] >= 0).sum() > 50
    assert calls.count("fused_self_block") == 2 * got["stop"]
    assert calls.count("flash_cross_pair") == got["stop"]
    assert "fused_cross_block" not in calls
    assert "fused_cross_attention" not in calls
    if mode == "adaptive":
        assert got["stop"] < 9


def test_head128_dispatch_follows_jax():
    """At head_dim 128: B5 as at 64, never B6 (JAX lightglue.py:304); B1'
    is exact whatever cross_softmax_shift says (lightglue.py:328); head
    dims other than 64 and 128 are refused with flash=True."""
    conf = configs.LightGlueConfig(num_heads=2)
    assert conf.head_dim == 128
    assert lg._fused_self_ok(conf, 2048) and not lg._fused_self_ok(conf, 1000)
    assert not lg._fused_cross_ok(conf, 1024, 768)
    assert lg._fused_cross_ok(configs.LightGlueConfig(), 1024, 768)

    rng = np.random.default_rng(55)
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                     jlg._cross_block_init(jax.random.key(8), 256))
    x0 = torch.from_numpy(_rand(rng, 1, 64, 256))
    x1 = torch.from_numpy(_rand(rng, 1, 96, 256))
    m1 = torch.from_numpy(rng.uniform(size=(1, 96)) < 0.8)
    outs = [lg.cross_block(p, x0, x1, conf.replace(cross_softmax_shift=s),
                           None, m1) for s in (None, 12.0)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    for heads in (8, 1):
        with pytest.raises(ValueError, match="head_dim"):
            lg._check_conf(configs.LightGlueConfig(num_heads=heads))
    lg._check_conf(configs.LightGlueConfig(num_heads=heads, flash=False))


def test_two_head_params_keep_the_projections():
    """Regrouping leaves every projection as it is: only the rotary table
    widens, each frequency repeated for the second 64 channels."""
    params = weights.load_params(NPZ)
    two = two_head_params(params, torch.cat)
    assert two["transformers"] is params["transformers"]
    w2 = two["posenc"]["Wr"]["w"]
    assert w2.shape == (2, 64)
    assert torch.equal(w2[:, :32], w2[:, 32:])
    # the same rotary angle for channel c of 4-head head 2h+1 and channel
    # 64 + c of 2-head head h
    kn = torch.randn(1, 5, 2)
    from lightglue_tpu_torch.ops import rotary
    e4 = rotary.fourier_posenc(params["posenc"], kn)
    e2 = rotary.fourier_posenc(two["posenc"], kn)
    assert torch.equal(e2[..., 32:], e4) and torch.equal(e2[..., :32], e4)
