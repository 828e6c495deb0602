"""The matcher's bf16 path (``mp=True``) of lightglue_tpu_torch against the
JAX package on the CPU.

Each bf16 plain version (B5, B6, B4, B1 and B1s, B3 and B3s) is held
against its Pallas kernel in interpret mode, fed the same seeded numpy
inputs rounded to bf16 (both packages round to nearest even, so the inputs
are equal): elementwise |port - JAX| <= 2e-2 max(1, |JAX|), the largest
distance in bf16 units of the last place stated in the failure message.
That bound is fixed at 0.02 for the attention outputs, which lie far below
1, so every output is held, besides, to its own scale: |port - JAX| <=
2^-6 (|JAX| + rms of JAX's row), two bf16 steps of the larger (the rms
term sized for the card's walk, which rounds each weight against the
running row maximum: chip_smoke.py's MP_SCALED). Observed: at most 0.32 of
it against Pallas, 0.50 for that walk at 2048 keys; a K1 that skips one
64-key tile of 1024 reads 84 times it.
The two sides round at the same points; they differ by the order of fp32
sums and, where a product's fp32 result sits near a bf16 rounding
boundary, by one bf16 unit of an intermediate.

The whole matcher at ``mp=True`` (the trained npz, planted pairs of 512
keypoints, B 2) is held against the JAX matcher at ``mp=True``, which on
the CPU runs its XLA composition in bf16 (whatever the block switches and
softmax shifts say), so its bf16 rounding points are XLA's, not the
kernels': matches0 equal on >= 99 % of keypoints, stop equal, prune0 and
prune1 equal on >= 99 %, matching_scores0 within 3e-2 where both match.
Observed: matches0 and stop equal in all eight configurations, prune equal
on 99.8-100 % of keypoints, scores within 2.5e-3 fixed and 2.8e-2 adaptive
(stop 3: three layers of bf16 rounding in the port's kernels' order and in
XLA's leave the scores of the last assignment furthest apart).
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
from lightglue_tpu.ops import ffn as jffn
from lightglue_tpu.ops import flash as jflash
from lightglue_tpu.ops import flash_cross as jflash_cross
from lightglue_tpu.ops import flash_cross_block as jflash_cross_block
from lightglue_tpu.ops import flash_self as jflash_self
from lightglue_tpu_torch import BatchMatcher, _build, configs, weights
from lightglue_tpu_torch.models import lightglue as lg
from lightglue_tpu_torch.ops import assignment_fused, block_tc
from lightglue_tpu_torch.ops import ffn as ffn_ops
from lightglue_tpu_torch.ops import flash, flash_cross, flash_cross_block
from lightglue_tpu_torch.ops import flash_self
from lightglue_tpu_torch.parallel import batching
from lightglue_tpu_torch.synthetic import planted_pairs

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BF = torch.bfloat16
REL = 2e-2  # |port - JAX| <= REL * max(1, |JAX|), elementwise
# and |port - JAX| <= SCALED * (|JAX| + rms(JAX's row)), elementwise
SCALED = 2.0 ** -6
SHIFTS = [None, 12.0]
MASKS = ["unmasked", "masked", "all_masked"]
NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "weights", "synthetic_superpoint_lightglue.npz")
_jit_forward = jax.jit(jlg.forward, static_argnames=("conf",))


def _np_tree(p):
    return {k: _np_tree(v) if isinstance(v, dict) else np.array(v)
            for k, v in p.items()}


def _torch_tree(p):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in p.items()}


def _pair(x):
    """One fp32 numpy array as the same bf16 values in both packages."""
    return torch.from_numpy(x).to(BF), jnp.asarray(x, jnp.bfloat16)


def _tmask(v):
    return None if v is None else torch.from_numpy(v)


def _jmask(v):
    return None if v is None else jnp.asarray(v)


def _mask(rng, b, n, case):
    """None, a random mask, or a random mask with batch entry 1 empty."""
    if case == "unmasked":
        return None
    valid = rng.uniform(size=(b, n)) < 0.75
    valid[:, 0] = True
    if case == "all_masked":
        valid[1] = False
    return valid


def _ulps(got, want):
    """The largest distance in bf16 units of the last place of ``want``."""
    unit = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                   - 7)
    return float(np.max(np.abs(got - want) / unit))


def _scaled(g, w, rows=None):
    """Largest |g - w| / (SCALED (|w| + rms(w's row))) over ``rows``
    (numpy fp32; the rms over the last axis of every row)."""
    rms = np.broadcast_to(np.sqrt(np.mean(np.square(w, dtype=np.float64),
                                          -1, keepdims=True)), w.shape)
    if rows is not None:
        g, w, rms = g[rows], w[rows], rms[rows]
    err = np.abs(g - w)
    bound = SCALED * (np.abs(w) + rms)
    ratio = np.where(err == 0, 0.0, err / np.where(bound > 0, bound, 1e-300))
    return float(ratio.max()) if ratio.size else 0.0


def _close(got, want, rows=None):
    """got (torch, bf16) against want (JAX, bf16) within REL and within the
    output's own scale; ``rows``: the (B, N) valid rows to compare, else
    every row."""
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    g_all = got.float().numpy()
    w_all = np.asarray(want, np.float32)
    g, w = (g_all, w_all) if rows is None else (g_all[rows], w_all[rows])
    err = np.abs(g - w)
    bound = REL * np.maximum(1.0, np.abs(w))
    assert (err <= bound).all(), (
        f"max |port - JAX| {err.max():.3e} over the bound at "
        f"{int((err > bound).sum())} of {err.size}; {_ulps(g, w):.1f} bf16 ulps")
    scaled = _scaled(g_all, w_all, rows)
    assert scaled <= 1.0, (
        f"|port - JAX| reads {scaled:.3f} of SCALED (|JAX| + rms(row)); "
        f"{_ulps(g, w):.1f} bf16 ulps")
    assert np.isfinite(g).all()


# --- the kernels' bf16 plain versions against their Pallas kernels ---------


@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("case", MASKS)
def test_fused_self_block_bf16_vs_pallas(case, shift):
    """B5 at two heads of 64."""
    rng = np.random.default_rng(40)
    b, n, d, heads = 2, 128, 128, 2
    p = _np_tree(jlg._self_block_init(jax.random.key(30), d))
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
    _close(got, want)


@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("case", MASKS + ["ragged_m_ne_n"])
def test_fused_cross_block_bf16_vs_pallas(case, shift):
    """B6 at two heads of 64, both images; valid rows compared."""
    rng = np.random.default_rng(41)
    b, d, heads = 2, 128, 2
    m, n = (128, 256) if case == "ragged_m_ne_n" else (128, 128)
    p = _np_tree(jlg._cross_block_init(jax.random.key(31), d))
    x0_t, x0_j = _pair(rng.standard_normal((b, m, d)).astype(np.float32))
    x1_t, x1_j = _pair(rng.standard_normal((b, n, d)).astype(np.float32))
    valid0 = valid1 = None
    if case != "unmasked":
        valid0 = _mask(rng, b, m, "masked")
        valid1 = _mask(rng, b, n, "all_masked" if case == "all_masked"
                       else "masked")
    w = flash_cross_block.prepare(_torch_tree(p), heads, shift, mp=True)
    got = flash_cross_block.fused_cross_block(w, x0_t, x1_t, _tmask(valid0),
                                              _tmask(valid1))
    want = jflash_cross_block.fused_cross_block(
        jax.tree.map(jnp.asarray, p), x0_j, x1_j, heads, _jmask(valid0),
        _jmask(valid1), shift=shift, interpret=True)
    _close(got[0], want[0], valid0)
    _close(got[1], want[1], valid1)


@pytest.mark.parametrize("d", [128, 256])
def test_fused_ffn_residual_bf16_vs_pallas(d):
    """B4: bf16 W1, W2, x and msg; fp32 LayerNorm; the hidden rounded."""
    rng = np.random.default_rng(42)
    p = _np_tree(jlg._ffn_init(jax.random.key(32), d))
    x_t, x_j = _pair(rng.standard_normal((2, 128, d)).astype(np.float32))
    m_t, m_j = _pair(rng.standard_normal((2, 128, d)).astype(np.float32))
    got = ffn_ops.fused_ffn_residual(x_t, m_t, _torch_tree(p))
    want = jffn.fused_ffn_residual(x_j, m_j, jax.tree.map(jnp.asarray, p),
                                   interpret=True)
    _close(got, want)
    a, b = ffn_ops.fused_ffn_residual_pair(x_t, m_t, x_t, m_t, _torch_tree(p))
    assert torch.equal(a, got) and torch.equal(b, got)


@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("case", MASKS)
def test_flash_sdpa_bf16_vs_pallas(case, shift):
    """B1 (exact) and B1s (shift 12); an all-masked entry is 0 in both."""
    rng = np.random.default_rng(43)
    q, k, v = (_pair(rng.standard_normal((2, 2, 256, 64)).astype(np.float32))
               for _ in range(3))
    valid = _mask(rng, 2, 256, case)
    got = flash.flash_sdpa(q[0], k[0], v[0], _tmask(valid), shift=shift)
    want = jflash.flash_sdpa(q[1], k[1], v[1], _jmask(valid), shift=shift,
                             interpret=True)
    _close(got, want)
    if case == "all_masked" and shift is None:
        assert not got[1].any()


@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("case", MASKS + ["ragged_m_ne_n"])
def test_fused_cross_attention_bf16_vs_pallas(case, shift):
    """B3 (exact) and B3s (shift 12): the exact form's rows of masked
    points carry values no caller reads, so valid rows are compared; the
    shift form's every row."""
    rng = np.random.default_rng(44)
    m, n = (128, 256) if case == "ragged_m_ne_n" else (256, 256)
    rand = lambda k: _pair(  # noqa: E731
        rng.standard_normal((2, 2, k, 64)).astype(np.float32))
    qk0, qk1, v0, v1 = rand(m), rand(n), rand(m), rand(n)
    valid0 = valid1 = None
    if case != "unmasked":
        valid0 = _mask(rng, 2, m, "masked")
        valid1 = _mask(rng, 2, n, "all_masked" if case == "all_masked"
                       else "masked")
    got = flash_cross.fused_cross_attention(
        qk0[0], qk1[0], v0[0], v1[0], _tmask(valid0), _tmask(valid1),
        shift=shift)
    want = jflash_cross.fused_cross_attention(
        qk0[1], qk1[1], v0[1], v1[1], _jmask(valid0), _jmask(valid1),
        shift=shift, interpret=True)
    rows = lambda v: None if v is None or shift is not None else \
        np.broadcast_to(v[:, None], (2, 2, v.shape[1]))  # noqa: E731
    _close(got[0], want[0], rows(valid0))
    _close(got[1], want[1], rows(valid1))


@pytest.mark.parametrize("shift", SHIFTS)
def test_scaled_bound_catches_a_dropped_key_tile(shift):
    """The output-scaled bound fails an attention kernel that skips one
    64-key tile of 1024 (K1's bf16 plain version with the tile masked out,
    against it whole)."""
    rng = np.random.default_rng(49)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, n, 64)).astype(
        np.float32)).to(BF) for n in (256, 1024, 1024))
    valid = torch.ones(1, 1024, dtype=torch.bool)
    whole = flash.flash_sdpa(q, k, v, valid, shift=shift).float().numpy()
    valid[:, 64:128] = False
    dropped = flash.flash_sdpa(q, k, v, valid, shift=shift).float().numpy()
    rel = float((np.abs(dropped - whole)
                 / np.maximum(1.0, np.abs(whole))).max())
    assert _scaled(dropped, whole) > 1.0, (
        f"reads {_scaled(dropped, whole):.3f} of the scaled bound, "
        f"{rel / REL:.3f} of REL")


def _running_max_walk(q, k, v, tile=64):
    """K1's bf16 form as the card's walk rounds it: key tiles in order, the
    weights exp(s - running max) rounded to bf16 before P V, the row sum
    of the unrounded weights, both rescaled as the maximum grows."""
    s_all = flash.scaled(q, q.shape[-1] ** -0.5) @ k.float().transpose(-1, -2)
    m = torch.full(q.shape[:-1] + (1,), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape)
    for j in range(0, k.shape[2], tile):
        s = s_all[..., j:j + tile]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        a, e = torch.exp(m - m_new), torch.exp(s - m_new)
        l = l * a + e.sum(-1, keepdim=True)
        acc = acc * a + e.to(BF).float() @ v[:, :, j:j + tile].float()
        m = m_new
    return (acc / l).to(BF)


def test_scaled_bound_admits_the_walks_rounding():
    """The card's walk rounds each weight against the running row maximum,
    the plain version (and the TPU kernel) against the final one: one bf16
    unit apart per weight, a random sum over the keys. At 2048 keys that
    stays within the output-scaled bound."""
    rng = np.random.default_rng(50)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 4, n, 64)).astype(
        np.float32)).to(BF) for n in (512, 2048, 2048))
    walk = _running_max_walk(q, k, v).float().numpy()
    plain = flash.flash_sdpa(q, k, v).float().numpy()
    assert 0.0 < _scaled(walk, plain) <= 1.0, _scaled(walk, plain)


def test_bf16_plain_versions_against_their_fp32_forms():
    """On bf16-representable inputs each bf16 plain version stays within
    the bf16 envelope of its fp32 plain version (the fp32 one reads the
    same values and rounds nowhere)."""
    rng = np.random.default_rng(45)
    x = torch.from_numpy(rng.standard_normal((2, 128, 128)).astype(np.float32))
    xb = x.to(BF)
    p = _torch_tree(_np_tree(jlg._self_block_init(jax.random.key(33), 128)))
    ang = rng.uniform(-3, 3, (2, 1, 128, 32)).astype(np.float32)
    enc = torch.from_numpy(np.stack([np.cos(ang), np.sin(ang)]))
    lo = flash_self.fused_self_block(flash_self.prepare(p, 2, mp=True), xb, enc)
    hi = flash_self.fused_self_block(flash_self.prepare(p, 2), xb.float(), enc)
    assert lo.dtype == BF and hi.dtype == torch.float32
    err = (lo.float() - hi).abs() / torch.clamp(hi.abs(), min=1.0)
    assert float(err.max()) <= REL


# --- output types ------------------------------------------------------------


def test_output_dtypes(monkeypatch):
    """bf16 where the JAX kernels return bf16 (B1, B3, B4, B5, B6), fp32
    where they take fp32 (B2's inputs: the assignment head casts back)."""
    rng = np.random.default_rng(46)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(BF)
    assert flash.flash_sdpa(t(1, 2, 64, 64), t(1, 2, 64, 64),
                            t(1, 2, 64, 64)).dtype == BF
    assert all(o.dtype == BF for o in flash_cross.fused_cross_attention(
        t(1, 2, 64, 64), t(1, 2, 32, 64), t(1, 2, 64, 64), t(1, 2, 32, 64)))
    p = _torch_tree(_np_tree(jlg._ffn_init(jax.random.key(34), 128)))
    assert ffn_ops.fused_ffn_residual(t(1, 8, 128), t(1, 8, 128),
                                      p).dtype == BF
    seen = []

    def spy(mdesc0, mdesc1, z0, z1, *args):
        seen.append({mdesc0.dtype, mdesc1.dtype, z0.dtype, z1.dtype})
        return real(mdesc0, mdesc1, z0, z1, *args)

    real = assignment_fused.fused_filter_matches
    monkeypatch.setattr(assignment_fused, "fused_filter_matches", spy)
    conf = configs.lightglue_config("superpoint", mp=True, n_layers=2,
                                    depth_confidence=-1.0,
                                    width_confidence=-1.0)
    params = lg.init_params(conf, torch.Generator().manual_seed(0))
    pr = planted_pairs(np.random.default_rng(4), 1, 128)
    out = lg.forward(params, conf, kpts0=torch.from_numpy(pr["keypoints0"]),
                     kpts1=torch.from_numpy(pr["keypoints1"]),
                     desc0=torch.from_numpy(pr["descriptors0"]),
                     desc1=torch.from_numpy(pr["descriptors1"]))
    assert seen == [{torch.float32}]
    assert out.matching_scores0.dtype == torch.float32


# --- refusals, checks and caches ---------------------------------------------


def test_mp_refusals():
    """Every mp configuration of the JAX package is accepted: head_dim 128
    (B.3) and two-stage compaction (A.3) are ported."""
    assert configs.LightGlueConfig(mp=True).mp
    assert configs.lightglue_config("superpoint", mp=True).head_dim == 64
    conf = configs.lightglue_config("superpoint", mp=True, num_heads=2)
    assert conf.mp and conf.head_dim == 128
    # the extractors' bf16 path is ported: accepted
    assert configs.SuperPointConfig(mp=True).mp
    assert configs.ALIKEDConfig(mp=True).mp
    conf = configs.LightGlueConfig(mp=True, compaction_bucket=64)
    assert conf.mp and conf.compaction_bucket == 64


def test_fp32_launch_checks_refuse_bf16():
    """The launch checks read the type before the device, so a bf16
    tensor handed to an fp32-only launch raises here, with no card."""
    xb = torch.zeros(2, 8, dtype=BF)
    with pytest.raises(TypeError, match="float32"):
        _build.check_cuda(x=xb)
    with pytest.raises(TypeError, match="bfloat16"):
        _build.check_cuda(dtype=BF, x=xb.float())
    p = _torch_tree(_np_tree(jlg._ffn_init(jax.random.key(35), 128)))
    w = ffn_ops.prepared(p)
    assert block_tc.wtype(w) == torch.float32
    # one bf16 matrix among fp32 weights: refused, not converted
    with pytest.raises(TypeError, match="w2T"):
        block_tc.check_ffn_weights(dict(w, w2T=w["w2T"].to(BF)), 128)
    with pytest.raises(TypeError):
        block_tc.ffn_weights(p, torch.float16)
    wb = ffn_ops.prepared(p, BF)
    assert wb is not w and block_tc.wtype(wb) == BF
    assert wb["b1"].dtype == torch.float32 and wb["gamma"].dtype == torch.float32
    with pytest.raises(ValueError, match="CUDA"):  # types fit: the device
        block_tc.check_ffn_weights(wb, 128)
    # both attention head_dims have a bf16 walk: nothing refuses d 128
    lg._check_conf(configs.lightglue_config("superpoint", mp=True,
                                            num_heads=2))


def test_prepared_blocks_per_mp():
    """One tree gives distinct weights for mp False and True, each built
    once; the bf16 ones hold bf16 matrices and fp32 biases."""
    params = weights.load_params(NPZ)
    conf = configs.lightglue_config("superpoint")
    f32 = lg.prepared_blocks(params, conf)
    b16 = lg.prepared_blocks(params, conf.replace(mp=True))
    assert b16 is not f32 and lg.prepared_blocks(params, conf.replace(
        mp=True)) is b16 and lg.prepared_blocks(params, conf) is f32
    for (w5, w6), (v5, v6) in zip(f32, b16):
        for w, v in ((w5, v5), (w6, v6)):
            assert block_tc.wtype(w) == torch.float32 and block_tc.wtype(v) == BF
            assert v["w_in"].dtype == BF and v["b_in"].dtype == torch.float32
            # the scale folded in fp32, then rounded
            assert torch.equal(v["w_in"], w["w_in"].to(BF))


def test_compute_params_cast_once_per_tree(monkeypatch):
    """Under mp the linears that take bf16 activations read weights cast
    to bf16 once per tree: every nn.linear of a composed mp forward gets
    weights of its input's type (no cast per call) but the pruning's
    matchability, which reads the fp32 assignment head; the FFN, the
    rotary projection and the assignment head are the tree's own."""
    conf = configs.lightglue_config(
        "superpoint", mp=True, n_layers=2, fused_self=False,
        fused_cross=False, pruning_min_kpts=0)
    params = lg.init_params(conf, torch.Generator().manual_seed(0))
    tree = lg.compute_params(params, conf)
    assert lg.compute_params(params, conf) is tree
    assert lg.compute_params(params, conf.replace(mp=False)) is params
    tr, own = tree["transformers"], params["transformers"]
    for blk, names in (("self_attn", ("Wqkv", "out_proj")),
                       ("cross_attn", ("to_qk", "to_v", "to_out"))):
        for n in names:
            assert tr[blk][n]["w"].dtype == BF
            assert torch.equal(tr[blk][n]["b"], own[blk][n]["b"].to(BF))
        assert tr[blk]["ffn"] is own[blk]["ffn"]
    assert tree["token_confidence"]["token"]["w"].dtype == BF
    for n in ("posenc", "log_assignment"):
        assert tree[n] is params[n]
    casts, seen = [], []
    real = lg.nn.linear

    def spy(p, x):
        seen.append(x.dtype)
        if p["w"].dtype != x.dtype:
            casts.append(tuple(p["w"].shape))
        return real(p, x)

    monkeypatch.setattr(lg.nn, "linear", spy)
    pr = planted_pairs(np.random.default_rng(5), 1, 128)
    out = lg.forward(params, conf, kpts0=torch.from_numpy(pr["keypoints0"]),
                     kpts1=torch.from_numpy(pr["keypoints1"]),
                     desc0=torch.from_numpy(pr["descriptors0"]),
                     desc1=torch.from_numpy(pr["descriptors1"]))
    assert seen.count(BF) >= 2 * 2 * 5 and set(casts) <= {(256, 1)}, casts
    assert out.matching_scores0.dtype == torch.float32


# --- the whole matcher at mp against the JAX matcher at mp ---------------------


MODES = {"fixed": dict(depth_confidence=-1.0, width_confidence=-1.0),
         "adaptive": dict(pruning_min_kpts=256)}
BLOCKS = {"default": {}, "composed": dict(fused_self=False, fused_cross=False)}


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


@pytest.fixture(scope="module")
def jax_mp():
    """The JAX matcher at mp on planted pairs of 512 keypoints, B 2, fixed
    and adaptive (its CPU path runs the XLA composition, the same for
    every block switch and softmax shift), and the port's trained tree."""
    jparams = jweights.load_params(NPZ, dtype=np.float32)
    args = _inputs(planted_pairs(np.random.default_rng(47), 2, 512))
    want = {}
    for mode, over in MODES.items():
        jconf = jconfigs.lightglue_config("superpoint", mp=True, **over)
        want[mode] = _jit_forward(jparams, jconf, **{
            k: jnp.asarray(v) for k, v in args.items()})
    return want, weights.load_params(NPZ), args


@pytest.mark.parametrize("blocks", list(BLOCKS))
@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("mode", list(MODES))
def test_matcher_mp_vs_jax_mp(jax_mp, mode, shift, blocks):
    want, params, args = jax_mp
    want = want[mode]
    conf = configs.lightglue_config(
        "superpoint", mp=True, self_softmax_shift=shift,
        cross_softmax_shift=shift, **MODES[mode], **BLOCKS[blocks])
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
    assert both.sum() > 100 and gap.max() <= 3e-2, f"score gap {gap.max():.3e}"
    if mode == "adaptive":
        assert got.stop < conf.n_layers


# --- serving ------------------------------------------------------------------


@pytest.mark.parametrize("mode", list(MODES))
def test_batch_matcher_mp_equals_eager(mode):
    """BatchMatcher at mp on the CPU (the eager forward on each padded
    batch) over two buckets of ragged planted pairs: each pair's matches
    and the batch's stop equal to the bit to models.lightglue.forward on
    the same padded batch."""
    conf = configs.lightglue_config("superpoint", mp=True, **MODES[mode])
    params = weights.load_params(NPZ)
    rng = np.random.default_rng(48)
    pairs = []
    for n, counts in ((64, (64, 50)), (128, (128, 100, 90))):
        pr = planted_pairs(rng, len(counts), n)
        pairs += [({"keypoints": pr["keypoints0"][i][:k],
                    "descriptors": pr["descriptors0"][i][:k],
                    "image_size": pr["image_size"][i]},
                   {"keypoints": pr["keypoints1"][i],
                    "descriptors": pr["descriptors1"][i],
                    "image_size": pr["image_size"][i]})
                  for i, k in enumerate(counts)]
    bm = BatchMatcher(conf, params, buckets=(64, 128), max_batch=4,
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
    assert buckets == {64, 128}
