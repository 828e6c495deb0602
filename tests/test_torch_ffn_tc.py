"""B4 (ops/ffn.py) on the tile product, and the attention walk's P V sum
order at head_dim 128, on the CPU.

(a) B4's route: the prepared weights (``ffn.prepared``: lin1 and lin2
K-major) through ``block_tc.tail_lin1_plain`` and ``tail_lin2_plain`` (the
LayerNorm from lin1's partials merged by Chan's formula), which state what
the two launches compute, equal ``fused_ffn_residual_plain`` on the
untouched parameters within 1e-6 of max(1, |plain|) (outputs reach 10,
where one fp32 unit is 9.5e-7): D 128 and 256, one segment and two (the
composed cross block's pair, each with its own message), 200 ragged rows;
and JAX's ``fused_ffn_residual`` in interpret mode (block_q 64) within
2e-5. On CPU tensors the wrappers are the plain version itself.
(b) The prepared weights: built once per parameter tree, also for a
layer of stacked parameters (``nn.index_params`` hands out a new view each
call), one entry per layer, rebuilt when a tensor is replaced; exactly the
transposes, the tree left as it was.
(c) The FFN-only weight check (``block_tc.check_ffn_weights``, split out of
``check_block_weights``): no heads or input projection needed, shapes and
widths refused; a tensor that is not on a CUDA device is refused before
anything is prepared.
(d) The composed cross block hands both images to one B4 call.
(e) The walk's P V sums at head_dim 128 over 2048 keys (csrc/attn_tc.cuh,
``Config<128>::kPv``) in a torch emulation: the operands split as
``split_tf32`` does it (bit masks), each mma's eight products summed
exactly and added to its accumulator rounded toward zero (the tensor
core's truncating add), three mmas an 8-key step. Summed per 32-key tile
and added to O in fp32 (the committed order) the output stays within 1e-6
of float64 (relative to max(1, |O|)), as close as an fp32 product; summed
in place into O, the order before, it misses by more than tenfold.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu.ops import ffn as jffn
from lightglue_tpu_torch import _build, nn
from lightglue_tpu_torch.configs import lightglue_config
from lightglue_tpu_torch.models import lightglue as lg
from lightglue_tpu_torch.ops import block_tc
from lightglue_tpu_torch.ops import ffn as ffn_ops

torch.set_num_threads(1)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _ffn_params(rng, d, layers=None):
    """The FFN's parameters as stored (in, out); with ``layers``, stacked."""
    lead = () if layers is None else (layers,)
    return {
        "lin1": {"w": _rand(rng, *lead, 2 * d, 2 * d, scale=(2 * d) ** -0.5),
                 "b": _rand(rng, *lead, 2 * d, scale=0.1)},
        "ln": {"scale": 1 + _rand(rng, *lead, 2 * d, scale=0.1),
               "bias": _rand(rng, *lead, 2 * d, scale=0.1)},
        "lin2": {"w": _rand(rng, *lead, 2 * d, d, scale=(2 * d) ** -0.5),
                 "b": _rand(rng, *lead, d, scale=0.1)},
    }


def _tree(p, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in p.items()}


def _leaves(p):
    return [t for v in p.values()
            for t in (_leaves(v) if isinstance(v, dict) else [v])]


# --- (a) the route ----------------------------------------------------------


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("ns", [(128,), (200,), (128, 64), (200, 72)])
def test_b4_route_equals_the_plain_version(d, ns):
    rng = np.random.default_rng(110)
    p = _tree(_ffn_params(rng, d), torch.from_numpy)
    xs = [torch.from_numpy(_rand(rng, 2, n, d)) for n in ns]
    msgs = [torch.from_numpy(_rand(rng, 2, n, d)) for n in ns]
    got = block_tc.ffn_chain_plain(ffn_ops.prepared(p), xs, msgs)
    assert len(got) == len(xs)
    for out, x, m in zip(got, xs, msgs):
        want = ffn_ops.fused_ffn_residual_plain(x, m, p)
        assert out.shape == x.shape
        np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-6,
                                   rtol=1e-6)
        torch.testing.assert_close(ffn_ops.fused_ffn_residual(x, m, p), want,
                                   rtol=0, atol=0)
    if len(ns) == 2:
        pair = ffn_ops.fused_ffn_residual_pair(xs[0], msgs[0], xs[1],
                                               msgs[1], p)
        for a, x, m in zip(pair, xs, msgs):
            torch.testing.assert_close(
                a, ffn_ops.fused_ffn_residual_plain(x, m, p), rtol=0, atol=0)


@pytest.mark.parametrize("d", [128, 256])
def test_b4_route_vs_pallas(d):
    rng = np.random.default_rng(111)
    p = _ffn_params(rng, d)
    xs = [_rand(rng, 2, n, d) for n in (128, 64)]
    msgs = [_rand(rng, 2, n, d) for n in (128, 64)]
    got = block_tc.ffn_chain_plain(
        ffn_ops.prepared(_tree(p, torch.from_numpy)),
        [torch.from_numpy(x) for x in xs], [torch.from_numpy(m) for m in msgs])
    for out, x, m in zip(got, xs, msgs):
        want = jffn.fused_ffn_residual(jnp.asarray(x), jnp.asarray(m),
                                       _tree(p, jnp.asarray), block_q=64,
                                       interpret=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=0)


# --- (b) the prepared weights -----------------------------------------------


def test_prepared_once_per_tree_and_layer():
    rng = np.random.default_rng(112)
    stacked = _tree(_ffn_params(rng, 128, layers=3), torch.from_numpy)
    before = _tree(stacked, torch.clone)
    first = [ffn_ops.prepared(nn.index_params(stacked, i)) for i in range(3)]
    again = [ffn_ops.prepared(nn.index_params(stacked, i)) for i in range(3)]
    assert all(a is b for a, b in zip(first, again))
    assert len({id(w) for w in first}) == 3
    for i, w in enumerate(first):
        layer = nn.index_params(stacked, i)
        assert torch.equal(w["w1T"], layer["lin1"]["w"].t())
        assert torch.equal(w["w2T"], layer["lin2"]["w"].t())
        for k, src in (("b1", layer["lin1"]["b"]), ("gamma",
                       layer["ln"]["scale"]), ("beta", layer["ln"]["bias"]),
                       ("b2", layer["lin2"]["b"])):
            assert torch.equal(w[k], src) and w[k].data_ptr() != \
                src.data_ptr()
        assert all(t.is_contiguous() for t in w.values())
    assert all(torch.equal(a, b)
               for a, b in zip(_leaves(stacked), _leaves(before)))
    # a tree of its own, and a tree with one tensor replaced, rebuild
    single = _tree(_ffn_params(rng, 128), torch.from_numpy)
    w = ffn_ops.prepared(single)
    assert ffn_ops.prepared(single) is w
    changed = dict(single, ln={"scale": single["ln"]["scale"] + 1.0,
                               "bias": single["ln"]["bias"]})
    w2 = ffn_ops.prepared(changed)
    assert w2 is not w and torch.equal(w2["gamma"], changed["ln"]["scale"])


# --- (c) the weight check ---------------------------------------------------


def test_ffn_weight_check():
    rng = np.random.default_rng(113)
    w = ffn_ops.prepared(_tree(_ffn_params(rng, 128), torch.from_numpy))
    assert "num_heads" not in w and "w_in" not in w
    with pytest.raises(ValueError, match="CUDA"):  # shapes fit: the device
        block_tc.check_ffn_weights(w, 128)
    with pytest.raises(ValueError, match="w1T must be"):
        block_tc.check_ffn_weights(w, 256)
    with pytest.raises(ValueError, match="take D in"):
        block_tc.check_ffn_weights(w, 64)
    bad = dict(w, w2T=w["w2T"][:, :128].contiguous())
    with pytest.raises(ValueError, match="w2T must be"):
        block_tc.check_ffn_weights(bad, 128)
    # the block check still asks for the heads' and projection's shapes
    blk = dict(w, num_heads=2, w_in=torch.zeros(384, 128), b_in=torch.zeros(384),
               woT=torch.zeros(128, 128), bo=torch.zeros(128))
    with pytest.raises(ValueError, match="CUDA"):
        block_tc.check_block_weights(blk, 128)
    with pytest.raises(ValueError, match="head_dim"):
        block_tc.check_block_weights(dict(blk, num_heads=3), 128)


def test_b4_refuses_a_non_cuda_tensor_before_preparing():
    p = _tree(_ffn_params(np.random.default_rng(114), 256), torch.from_numpy)
    meta = torch.zeros(1, 8, 256, device="meta")
    for call in (lambda: ffn_ops.fused_ffn_residual(meta, meta, p),
                 lambda: ffn_ops.fused_ffn_residual_pair(meta, meta, meta,
                                                         meta, p)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert p["lin1"]["w"] not in ffn_ops._PREPARED
    assert _build._lib is None


# --- (d) the composed cross block -------------------------------------------


def test_composed_cross_block_hands_both_images_to_one_call(monkeypatch):
    rng = np.random.default_rng(115)
    conf = lightglue_config("superpoint", fused_cross=False, fused_self=False)
    d = conf.descriptor_dim

    def lin(i, o):
        return {"w": torch.from_numpy(_rand(rng, i, o, scale=i ** -0.5)),
                "b": torch.from_numpy(_rand(rng, o, scale=0.1))}

    p = {"to_qk": lin(d, d), "to_v": lin(d, d), "to_out": lin(d, d),
         "ffn": _tree(_ffn_params(rng, d), torch.from_numpy)}
    x0 = torch.from_numpy(_rand(rng, 1, 40, d))
    x1 = torch.from_numpy(_rand(rng, 1, 24, d))
    calls = []
    pair = ffn_ops.fused_ffn_residual_pair

    def counted(*args):
        calls.append(args)
        return pair(*args)

    monkeypatch.setattr(ffn_ops, "fused_ffn_residual_pair", counted)
    got = lg.cross_block(p, x0, x1, conf)
    assert len(calls) == 1 and calls[0][0] is x0 and calls[0][2] is x1
    want = lg.cross_block(p, x0, x1, conf.replace(fused_ffn=False))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)


# --- (e) the walk's P V sum order at head_dim 128 ----------------------------

_LOW13 = -0x2000  # int32 0xffffe000: the bits a tensor core reads of a tf32


def _tf32(x):
    return (x.view(torch.int32) & _LOW13).view(torch.float32)


def _split3(x):
    """csrc/tc.cuh::split_tf32 as the tensor core reads it."""
    big = _tf32(x)
    return big, _tf32(((x - big).view(torch.int32) + 0x1000).view(
        torch.float32))


def _toward_zero(y):
    """float64 -> float32 rounded toward zero."""
    f = y.float()
    return torch.where(f.double().abs() > y.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def _pv(p, v, key_tile):
    """O = P V as the walk sums it: every 8-key step three mmas (P small x
    V big, P big x V small, P big x V big), each adding its eight exact
    products to its accumulator rounded toward zero; with ``key_tile`` the
    accumulator is a zeroed fragment added to O in fp32 after each key
    tile, else O itself."""
    (pb, ps), (vb, vs) = _split3(p), _split3(v)
    ops = [(a.double(), b.double()) for a, b in ((ps, vb), (pb, vs), (pb, vb))]
    o = torch.zeros(p.shape[:-1] + v.shape[-1:])
    acc = o if key_tile is None else torch.zeros_like(o)
    for k0 in range(0, p.shape[-1], 8):
        for a, b in ops:
            acc = _toward_zero(acc.double() + a[..., k0:k0 + 8]
                               @ b[..., k0:k0 + 8, :])
        if key_tile is not None and (k0 + 8) % key_tile == 0:
            o, acc = o + acc, torch.zeros_like(o)
    return acc if key_tile is None else o


@pytest.mark.parametrize("q_scale,v_mean", [(1.0, 1.0), (3.0, 1.0),
                                            (3.0, 0.0)])
def test_walk_pv_key_tile_sums_at_head_dim_128(q_scale, v_mean):
    rng = np.random.default_rng(116)
    d, nk = 128, 2048
    q = torch.from_numpy(_rand(rng, 1, 64, d, scale=q_scale))
    k = torch.from_numpy(_rand(rng, 1, nk, d))
    v = torch.from_numpy(_rand(rng, 1, nk, d) + np.float32(v_mean))
    s = (q * d ** -0.5) @ k.transpose(-1, -2)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    ref = (p.double() @ v.double()) / p.double().sum(-1, keepdim=True)
    scale = max(1.0, float(ref.abs().max()))
    err = {name: float((o / l - ref).abs().max()) / scale for name, o in (
        ("tiles", _pv(p, v, 32)), ("in place", _pv(p, v, None)),
        ("fp32", p @ v))}
    assert err["tiles"] <= 1e-6 and err["tiles"] <= 2 * err["fp32"] + 1e-7, err
    assert err["in place"] > 10 * 1e-6, err
