"""The whole-block ops of lightglue_tpu_torch (B5 fused_self_block, B6
fused_cross_block) and the matcher at its default block configuration,
against the JAX package on the CPU.

The plain versions are held against the Pallas kernels in interpret mode on
the same seeded numpy inputs and the same weights, within 1e-5 max-abs on
valid rows (the rows of masked points carry values that no valid output
reads, and the two packages' exact kernels fill them differently). The
matcher at the default configuration (B5 and B6, exact and with the
constant shift 12) is held against the JAX matcher, which on the CPU runs
its XLA composition whatever the switches say: matches, ``stop`` and
``prune`` exactly equal, scores within 1e-4.
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
from lightglue_tpu.ops import flash_cross_block as jflash_cross_block
from lightglue_tpu.ops import flash_self as jflash_self
from lightglue_tpu_torch import LightGlue, SuperPoint, configs, weights
from lightglue_tpu_torch.models import lightglue as lg
from lightglue_tpu_torch.ops import ffn as ffn_ops
from lightglue_tpu_torch.ops import flash_cross_block, flash_self
from lightglue_tpu_torch.synthetic import planted_pairs

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = 1e-5
NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "weights", "synthetic_superpoint_lightglue.npz")
SHIFTS = [None, 12.0]
_jit_forward = jax.jit(jlg.forward, static_argnames=("conf",))


def _np_tree(p):
    return {k: _np_tree(v) if isinstance(v, dict) else np.array(v)
            for k, v in p.items()}


def _torch_tree(p):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in p.items()}


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


# --- B5: fused_self_block --------------------------------------------------


@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("case", ["unmasked", "masked", "all_masked"])
def test_fused_self_block_plain_vs_pallas(case, shift):
    rng = np.random.default_rng(10)
    b, n, d, heads = 2, 128, 128, 2
    p = _np_tree(jlg._self_block_init(jax.random.key(3), d))
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
    _close(got, want)
    if case == "all_masked":  # the empty entry's message is out_proj's bias
        msg = np.broadcast_to(p["out_proj"]["b"], (n, d)).copy()
        _close(got[1], ffn_ops.fused_ffn_residual_plain(
            torch.from_numpy(x[1]), torch.from_numpy(msg),
            _torch_tree(p["ffn"])))


# --- B6: fused_cross_block -------------------------------------------------


@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("case", ["unmasked", "masked", "all_masked",
                                  "ragged_m_ne_n"])
def test_fused_cross_block_plain_vs_pallas(case, shift):
    rng = np.random.default_rng(11)
    b, d, heads = 2, 128, 2
    m, n = (128, 256) if case == "ragged_m_ne_n" else (128, 128)
    p = _np_tree(jlg._cross_block_init(jax.random.key(4), d))
    x0 = rng.standard_normal((b, m, d)).astype(np.float32)
    x1 = rng.standard_normal((b, n, d)).astype(np.float32)
    if case == "unmasked":
        valid0 = valid1 = None
    else:
        valid0 = _mask(rng, b, m, "masked")
        valid1 = _mask(rng, b, n, "all_masked" if case == "all_masked"
                       else "masked")
    w = flash_cross_block.prepare(_torch_tree(p), heads, shift)
    tmask = lambda v: None if v is None else torch.from_numpy(v)
    jmask = lambda v: None if v is None else jnp.asarray(v)
    got = flash_cross_block.fused_cross_block(
        w, torch.from_numpy(x0), torch.from_numpy(x1), tmask(valid0),
        tmask(valid1))
    want = jflash_cross_block.fused_cross_block(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x0), jnp.asarray(x1), heads,
        jmask(valid0), jmask(valid1), shift=shift, interpret=True)
    _close(got[0], want[0], valid0)
    _close(got[1], want[1], valid1)


def test_prepare_regroups_the_packed_projection():
    """B5's w_in rows are the reference packing's q, k, v columns per head,
    q scaled; B6's are to_qk and to_v, each scaled by the root."""
    rng = np.random.default_rng(12)
    d, heads = 128, 2
    p = {"Wqkv": {"w": torch.from_numpy(rng.standard_normal((d, 3 * d))
                                        .astype(np.float32)),
                  "b": torch.arange(3 * d, dtype=torch.float32)},
         "out_proj": {"w": torch.zeros(d, d), "b": torch.zeros(d)},
         "ffn": _torch_tree(_np_tree(jlg._ffn_init(jax.random.key(7), d)))}
    w = flash_self.prepare(p, heads)
    h, c = 1, 5  # head 1, channel 5
    col = (h * 64 + c) * 3
    torch.testing.assert_close(w["w_in"][h * 64 + c],
                               p["Wqkv"]["w"][:, col] / 8, rtol=0, atol=0)
    torch.testing.assert_close(w["w_in"][d + h * 64 + c],
                               p["Wqkv"]["w"][:, col + 1], rtol=0, atol=0)
    assert float(w["b_in"][2 * d + h * 64 + c]) == col + 2
    ws = flash_self.prepare(p, heads, shift=12.0)
    assert float(ws["b_in"][h * 64 + c]) == pytest.approx(
        col / 8 * 1.4426950408889634)


# --- the matcher at the default configuration --------------------------------


@pytest.fixture(scope="module")
def trained():
    return jweights.load_params(NPZ, dtype=np.float32), weights.load_params(NPZ)


def _inputs(pairs):
    b, m = pairs["keypoints0"].shape[:2]
    n = pairs["keypoints1"].shape[1]
    mask0 = np.ones((b, m), bool)
    mask1 = np.ones((b, n), bool)
    mask0[0, m - 9:] = False  # padded tails
    mask1[-1, n - 13:] = False
    mask1[0, ::7] = False  # scattered invalid slots
    return dict(kpts0=pairs["keypoints0"], kpts1=pairs["keypoints1"],
                desc0=pairs["descriptors0"], desc1=pairs["descriptors1"],
                size0=pairs["image_size"], size1=pairs["image_size"],
                mask0=mask0, mask1=mask1)


MODES = {"fixed": dict(depth_confidence=-1.0, width_confidence=-1.0),
         "adaptive": {}}
_WANT = {}


def _jax_matcher(trained, mode, n):
    """The JAX matcher's output (its XLA composition on the CPU), once per
    mode and size."""
    if (mode, n) not in _WANT:
        jconf = jconfigs.lightglue_config("superpoint", pruning_min_kpts=32,
                                          **MODES[mode])
        args = _inputs(planted_pairs(np.random.default_rng(13), 2, n))
        _WANT[mode, n] = (args, _jit_forward(
            trained[0], jconf, **{k: jnp.asarray(v) for k, v in args.items()}))
    return _WANT[mode, n]


@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("mode", list(MODES))
def test_default_config_against_jax(trained, mode, shift, monkeypatch):
    """Full width, trained npz, B 2, N 256 (B5 and B6 both engage), masked
    points; the constant shift changes no match."""
    calls = []
    for mod, name in ((flash_self, "fused_self_block"),
                      (flash_cross_block, "fused_cross_block")):
        op = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, op=op, name=name: (
            calls.append(name), op(*a))[1])
    args, want = _jax_matcher(trained, mode, 256)
    conf = configs.lightglue_config(
        "superpoint", pruning_min_kpts=32, self_softmax_shift=shift,
        cross_softmax_shift=shift, **MODES[mode])
    assert conf.fused_self and conf.fused_cross
    got = lg.forward(trained[1], conf,
                     **{k: torch.as_tensor(v) for k, v in args.items()})
    for f in ("matches0", "matches1", "prune0", "prune1"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert got.stop == int(want.stop)
    for f in ("matching_scores0", "matching_scores1"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), atol=1e-4,
                                   rtol=0, err_msg=f)
    assert (got.matches0.numpy() >= 0).sum() > 100
    assert calls.count("fused_self_block") == 2 * got.stop
    assert calls.count("fused_cross_block") == got.stop
    if mode == "adaptive":
        assert got.stop < 9 and (got.prune0.numpy() < got.stop).any()


@pytest.mark.parametrize("mode", list(MODES))
def test_fused_and_composed_give_the_same_matches(trained, mode):
    """One from_jax_params tree through B5/B6 and through the composed
    blocks (with the shift, B1s and B3s): the same matches, stop, prune."""
    params = weights.from_jax_params(jweights.flatten_tree(trained[0]))
    args = _inputs(planted_pairs(np.random.default_rng(14), 2, 128))
    targs = {k: torch.as_tensor(v) for k, v in args.items()}
    outs = []
    for fused in (True, False):
        conf = configs.lightglue_config(
            "superpoint", pruning_min_kpts=32, fused_self=fused,
            fused_cross=fused, self_softmax_shift=12.0,
            cross_softmax_shift=12.0, **MODES[mode])
        outs.append(lg.forward(params, conf, **targs))
    for f in ("matches0", "matches1", "prune0", "prune1"):
        np.testing.assert_array_equal(getattr(outs[0], f).numpy(),
                                      getattr(outs[1], f).numpy(), err_msg=f)
    assert outs[0].stop == outs[1].stop
    np.testing.assert_allclose(outs[0].matching_scores0.numpy(),
                               outs[1].matching_scores0.numpy(), atol=1e-4,
                               rtol=0)


def test_block_dispatch_follows_jax():
    """B5 at N <= 2048, B6 at max(M, N) <= 1024, lengths multiples of 128,
    and only with flash, fused_ffn and the block's switch on."""
    conf = configs.LightGlueConfig()
    assert lg._fused_self_ok(conf, 2048) and not lg._fused_self_ok(conf, 2176)
    assert not lg._fused_self_ok(conf, 1000)
    assert lg._fused_cross_ok(conf, 1024, 768)
    assert not lg._fused_cross_ok(conf, 2048, 2048)
    assert not lg._fused_cross_ok(conf, 1024, 1000)
    for off in ("flash", "fused_ffn", "fused_self"):
        assert not lg._fused_self_ok(conf.replace(**{off: False}), 1024)
    for off in ("flash", "fused_ffn", "fused_cross"):
        assert not lg._fused_cross_ok(conf.replace(**{off: False}), 1024, 1024)


def test_block_weights_are_prepared_once(trained):
    params = trained[1]
    conf = configs.LightGlueConfig(self_softmax_shift=12.0)
    first = lg.prepared_blocks(params, conf)
    assert lg.prepared_blocks(params, conf) is first
    assert len(first) == conf.n_layers
    assert first[0][0]["shift"] == 12.0 and first[0][1]["shift"] is None
    assert lg.prepared_blocks(params, conf.replace(
        self_softmax_shift=None)) is not first


def test_config_defaults_and_refusals():
    conf = configs.LightGlueConfig()
    assert conf.fused_self and conf.fused_cross and conf.fused_ffn
    configs.LightGlueConfig(self_softmax_shift=12.0, cross_softmax_shift=12.0)
    assert configs.LightGlueConfig(mp=True).mp  # bf16 at head_dim 64
    # ... and at 128, and two-stage compaction: accepted, nothing refused
    for ok in (dict(mp=True, num_heads=2), dict(compaction_bucket=64)):
        conf = configs.LightGlueConfig(**ok)
        assert all(getattr(conf, k) == v for k, v in ok.items())


def test_block_ops_on_other_devices_raise():
    """CPU tensors take the plain versions without building; a tensor on
    neither the CPU nor a GPU is refused, not computed."""
    from lightglue_tpu_torch import _build
    rng = np.random.default_rng(15)
    p5 = _torch_tree(_np_tree(jlg._self_block_init(jax.random.key(5), 128)))
    p6 = _torch_tree(_np_tree(jlg._cross_block_init(jax.random.key(6), 128)))
    w5, w6 = flash_self.prepare(p5, 2), flash_cross_block.prepare(p6, 2)
    x = torch.from_numpy(rng.standard_normal((1, 8, 128)).astype(np.float32))
    enc = torch.zeros(2, 1, 1, 8, 32)
    flash_self.fused_self_block(w5, x, enc)
    flash_cross_block.fused_cross_block(w6, x, x)
    assert _build._lib is None
    meta = torch.zeros(1, 8, 128, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_self.fused_self_block(w5, meta, enc.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        flash_cross_block.fused_cross_block(w6, meta, meta)


@pytest.mark.parametrize("make", [
    lambda: LightGlue("superpoint", n_layers=2),
    lambda: SuperPoint(max_num_keypoints=64),
])
def test_entry_points_default_to_cuda(make):
    """Without ``device`` the entry points go to the card; without CUDA they
    raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        assert make().device == torch.device("cuda")
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            make()
