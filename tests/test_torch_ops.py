"""lightglue_tpu_torch building blocks (configs, nn, keypoints, rotary, the
composed attention and assignment ops) against their lightglue_tpu
counterparts on the CPU, on the same seeded numpy inputs. fp32, 1e-5
max-abs unless stated; indices exactly equal."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu import configs as jconfigs
from lightglue_tpu import nn as jnn
from lightglue_tpu.ops import assignment as jasg
from lightglue_tpu.ops import attention as jattn
from lightglue_tpu.ops import keypoints as jkp
from lightglue_tpu.ops import rotary as jrot
from lightglue_tpu_torch import configs, nn
from lightglue_tpu_torch.ops import assignment as asg
from lightglue_tpu_torch.ops import attention as attn
from lightglue_tpu_torch.ops import keypoints as kp
from lightglue_tpu_torch.ops import rotary
from lightglue_tpu_torch.utils import diagnostics

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = 1e-5


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=0)


def test_config_fields_and_presets_match_jax():
    jfields = {f.name for f in jconfigs.LightGlueConfig.__dataclass_fields__.values()}
    assert set(configs.LightGlueConfig.__dataclass_fields__) == jfields
    assert configs.FEATURES == jconfigs.FEATURES
    c = configs.lightglue_config("sift", n_layers=3)
    assert (c.input_dim, c.add_scale_ori, c.n_layers, c.head_dim) == (128, True, 3, 64)
    # the JAX package's default block configuration (whole-block kernels)
    assert c.fused_self and c.fused_cross
    assert (c.fused_self, c.fused_cross) == (
        jconfigs.LightGlueConfig().fused_self, jconfigs.LightGlueConfig().fused_cross)
    with pytest.raises(ValueError):
        configs.lightglue_config("nope")


@pytest.mark.parametrize("option", [
    dict(fused_self=True), dict(fused_cross=True), dict(mp=True),
    dict(self_softmax_shift=8.0), dict(cross_softmax_shift=8.0),
    dict(compaction_bucket=256),
])
def test_unported_options_raise(option):
    """Every option of the JAX package's matcher is ported and taken: the
    whole-block kernels, both softmax shifts, bf16 at head_dim 64 and 128
    (B5, B6, B1s, B3s, B1', their bf16 forms) and two-stage compaction;
    nothing is refused any more."""
    conf = configs.lightglue_config("superpoint", **option)
    assert all(getattr(conf, k) == v for k, v in option.items())
    if "mp" in option:
        conf = configs.lightglue_config("superpoint", num_heads=2, **option)
        assert conf.head_dim == 128 and conf.mp


def test_nn_layers():
    rng = np.random.default_rng(0)
    x = _rand(rng, 3, 5, 16)
    p = {"w": _rand(rng, 16, 8), "b": _rand(rng, 8)}
    ln = {"scale": _rand(rng, 16), "bias": _rand(rng, 16)}
    tp = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    jp = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    _close(nn.linear(tp(p), torch.from_numpy(x)), jnn.linear(jp(p), jnp.asarray(x)))
    _close(nn.layer_norm(tp(ln), torch.from_numpy(x)),
           jnn.layer_norm(jp(ln), jnp.asarray(x)))
    _close(nn.gelu(torch.from_numpy(x * 3)), jnn.gelu(jnp.asarray(x * 3)))
    stacked = nn.stack_params([tp(p), tp(p)])
    assert stacked["w"].shape == (2, 16, 8)
    assert torch.equal(nn.index_params(stacked, 1)["b"], tp(p)["b"])


@pytest.mark.parametrize("with_size", [False, True])
def test_normalize_keypoints(with_size):
    rng = np.random.default_rng(1)
    k = (rng.uniform(size=(2, 30, 2)) * 500).astype(np.float32)
    mask = rng.uniform(size=(2, 30)) < 0.8
    size = np.array([[640.0, 480.0], [500.0, 700.0]], np.float32) if with_size else None
    got = kp.normalize_keypoints(torch.from_numpy(k),
                                 None if size is None else torch.from_numpy(size),
                                 torch.from_numpy(mask))
    want = jkp.normalize_keypoints(jnp.asarray(k),
                                   None if size is None else jnp.asarray(size),
                                   jnp.asarray(mask))
    _close(got, want)
    _close(kp.normalize_keypoints(torch.from_numpy(k)),
           jkp.normalize_keypoints(jnp.asarray(k)))


def test_pad_to_length():
    x = np.arange(12, dtype=np.float32).reshape(1, 6, 2)
    y, m = kp.pad_to_length(torch.from_numpy(x), 9)
    jy, jm = jkp.pad_to_length(jnp.asarray(x), 9)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    with pytest.raises(ValueError):
        kp.pad_to_length(torch.from_numpy(x), 3)


def test_rotary():
    rng = np.random.default_rng(2)
    kpts = _rand(rng, 2, 20, 2)
    w = _rand(rng, 2, 32)
    t = _rand(rng, 2, 4, 20, 64)
    enc = rotary.fourier_posenc({"Wr": {"w": torch.from_numpy(w)}},
                                torch.from_numpy(kpts))
    jenc = jrot.fourier_posenc({"Wr": {"w": jnp.asarray(w)}}, jnp.asarray(kpts))
    assert enc.shape == (2, 2, 1, 20, 32)
    _close(enc, jenc)
    _close(rotary.apply_rotary(enc, torch.from_numpy(t)),
           jrot.apply_rotary(jenc, jnp.asarray(t)))


@pytest.mark.parametrize("masked", [False, True])
def test_composed_attention(masked):
    rng = np.random.default_rng(3)
    q, k, v = _rand(rng, 2, 2, 40, 32), _rand(rng, 2, 2, 50, 32), _rand(rng, 2, 2, 50, 32)
    v0 = _rand(rng, 2, 2, 40, 32)
    mask = None
    if masked:
        va0 = rng.uniform(size=(2, 40)) < 0.8
        va1 = rng.uniform(size=(2, 50)) < 0.8
        va1[1] = False  # a batch row with no valid key
        mask = va0[:, None, :, None] & va1[:, None, None, :]
    t = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a))
    j = lambda a: None if a is None else jnp.asarray(a)
    kmask = None if mask is None else mask[:, :, :1].repeat(40, 2)
    _close(attn.sdpa(t(q), t(k), t(v), t(kmask)), jattn.sdpa(j(q), j(k), j(v), j(kmask)))
    got = attn.bidirectional_cross_attention(t(q), t(k), t(v0), t(v), t(mask))
    want = jattn.bidirectional_cross_attention(j(q), j(k), j(v0), j(v), j(mask))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("masked", [False, True])
def test_composed_assignment(masked):
    rng = np.random.default_rng(4)
    d0, d1 = _rand(rng, 2, 30, 32), _rand(rng, 2, 36, 32)
    p = {"matchability": {"w": _rand(rng, 32, 1), "b": _rand(rng, 1)},
         "final_proj": {"w": _rand(rng, 32, 32, scale=0.2), "b": _rand(rng, 32)}}
    masks = ((rng.uniform(size=(2, 30)) < 0.8, rng.uniform(size=(2, 36)) < 0.8)
             if masked else (None, None))
    tp = {k: {kk: torch.from_numpy(vv) for kk, vv in v.items()} for k, v in p.items()}
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tm = [None if m is None else torch.from_numpy(m) for m in masks]
    jm = [None if m is None else jnp.asarray(m) for m in masks]
    scores, sim = asg.match_assignment(tp, torch.from_numpy(d0), torch.from_numpy(d1), *tm)
    jscores, jsim = jasg.match_assignment(jp, jnp.asarray(d0), jnp.asarray(d1), *jm)
    _close(sim, jsim)
    _close(scores, jscores, tol=1e-4)
    _close(asg.get_matchability(tp, torch.from_numpy(d0)),
           jasg.get_matchability(jp, jnp.asarray(d0)))
    got = asg.filter_matches(scores, 0.01, *tm)
    want = jasg.filter_matches(jscores, 0.01, *jm)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got[2:], want[2:]):
        _close(g, w)


def test_warn_once():
    diagnostics.reset()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert diagnostics.warn_once("k", "first")
        assert not diagnostics.warn_once("k", "again")
    assert [str(r.message) for r in rec] == ["first"]
    assert issubclass(rec[0].category, diagnostics.DegradedModeWarning)
    diagnostics.reset()
