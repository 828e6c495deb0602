"""The extractors' bf16 path (mp=True) of lightglue_tpu_torch against
lightglue_tpu on the CPU, on seeded numpy inputs.

- Each kernel's bf16 plain version against its Pallas kernel at mp=True in
  interpret mode: B7 (``stem.fused_stem_plain(mp=True)``), the B7 -> B8
  chain (the stem's bf16 output into ``stem2.fused_block2_plain``, the
  channel-plane layout for Pallas), B10 (``aliked_stem`` on a bf16 image)
  at aliked-n16 and at aliked-t16 (the Pallas kernel is built for 16
  channels: t16's weights go in zero-padded to 16, which adds exact
  zeros to every sum), B11 and B12
  (``score_head`` with ``mp=True``). The bound is the bf16 matcher's
  (tests/test_torch_mp.py): |plain - JAX| <= 2e-2 max(1, |JAX|) and
  <= 2^-6 (|JAX| + rms(JAX row)), elementwise: the two sum each output in
  another order in fp32, so a sum near a bf16 rounding boundary can round
  to the other neighbour, one bf16 step (2^-8 relative) at each rounding
  point, and a step early in the chain moves its consumers by about as
  much. Every JAX reference is compiled with XLA's
  ``xla_allow_excess_precision`` off (``_strict``): by default XLA on the
  CPU drops a round trip to bf16 and back inside a fusion, where the TPU
  kernels and the port round. So compiled, B10's Pallas kernel and its
  plain version agree to the bit.
- A probe: the fp32 stem rounded to bf16 only at its output breaks the
  bound (the bf16 form rounds the image, conv1a's output and each sum
  before its bias).
- Whole extraction: ``models.superpoint.forward`` and
  ``models.aliked.forward`` (lazy and dense, with and without B11 / B12)
  at mp against the JAX ``forward`` at mp, which runs XLA's composition on
  the CPU. bf16 moves scores by about 2^-8 relative before NMS and the
  top-k, so near-equal scores change rank (lightglue_tpu/configs.py:
  155-158): the tests hold the share of keypoints found by both, and the
  descriptors and scores of those keypoints, to bounds measured against
  how far the JAX package's own mp output lies from its fp32 output.
- Images to matches: ``make_end_to_end`` at mp (SuperPoint into the mp
  matcher) against the JAX ``make_end_to_end`` at mp.
- Every keypoint that the port at mp keeps and the JAX package at mp does
  not (or the reverse), on the images above, with its margins against the
  top-k's cut and its NMS window's runner-up
  (``scripts/keypoint_margins.py``), the JAX package run with the Pallas
  counterparts of the port's kernels engaged (interpret mode): none clears
  both by more than 4 steps of its score, on any path. Two faults that
  moved such keypoints are held here too: the deformable conv's bilinear
  samples equal the JAX package's to the bit (XLA fuses their four
  products into multiply-adds), and aliked-t16 runs the composed block 1,
  as the JAX package does, not B10.
"""

import contextlib
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu import configs as jconfigs
from lightglue_tpu import end_to_end as jend_to_end
from lightglue_tpu import weights as jweights
from lightglue_tpu.models import aliked as jal
from lightglue_tpu.models import lightglue as jlg
from lightglue_tpu.models import superpoint as jsp
from lightglue_tpu.ops import aliked_stem as jops_astem
from lightglue_tpu.ops import deform as jdeform
from lightglue_tpu.ops import score_head as jops_score
from lightglue_tpu.ops import stem as jops_stem
from lightglue_tpu.ops import stem2 as jops_stem2
from lightglue_tpu.ops.aliked_stem import fused_aliked_stem as jstem
from lightglue_tpu.ops.score_head import (score_head_pallas_cplane,
                                          score_head_pallas_lazy)
from lightglue_tpu.ops.stem import fused_stem_pallas
from lightglue_tpu.ops.stem2 import fused_block2_pallas
from lightglue_tpu_torch import configs, end_to_end, weights
from lightglue_tpu_torch.models import aliked as al
from lightglue_tpu_torch.models import superpoint as sp
from lightglue_tpu_torch.ops import aliked_stem, deform, score_head, stem, stem2
from lightglue_tpu_torch.scripts import keypoint_margins as km
from lightglue_tpu_torch.synthetic import image_pair, texture

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BF = torch.bfloat16
REL = 2e-2  # |plain - JAX| <= REL max(1, |JAX|), elementwise
SCALED = 2.0 ** -6  # and <= SCALED (|JAX| + rms(JAX row))
_jax_al_init = jax.jit(jal.init_params, static_argnums=1)


def _strict(fn, *args, **static):
    """fn(*args, **static), compiled by XLA with every bf16 rounding kept
    (``xla_allow_excess_precision`` off)."""
    f = jax.jit(functools.partial(fn, **static))
    return f.lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _reach(got, want):
    """(largest err / (REL max(1, |want|)), largest err / (SCALED (|want| +
    rms(want's row)))), rows along the last axis: both must be <= 1."""
    g = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                   np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape and np.isfinite(g).all()
    err = np.abs(g - w)
    rms = np.sqrt(np.mean(np.square(w), -1, keepdims=True))
    scaled = SCALED * (np.abs(w) + rms)
    ratio = np.where(err == 0, 0.0, err / np.where(scaled > 0, scaled, 1e-300))
    return float((err / (REL * np.maximum(1.0, np.abs(w)))).max()), float(ratio.max())


def _close(got, want):
    rel, scaled = _reach(got, want)
    assert rel <= 1.0 and scaled <= 1.0, (rel, scaled)


@functools.lru_cache(maxsize=None)
def _sp_params():
    """The JAX package's SuperPoint init (key 0), conv weights times 3 (the
    stand-in for trained weights), as (JAX tree, port tree)."""
    flat = jweights.flatten_tree(jsp.init_params(jax.random.key(0)))
    flat = {k: np.asarray(v) * (3.0 if k.endswith("/w") else 1.0)
            for k, v in flat.items()}
    return (jweights.unflatten_tree(flat),
            weights.superpoint_from_jax_params(flat))


@functools.lru_cache(maxsize=None)
def _al_params(name):
    """ALIKED's JAX init (key 0) with random batch-norm statistics (so that
    B10's BN rounding is exercised), encoder and aggregation convs times 2,
    score-head convs times 3, as (JAX tree, port tree)."""
    flat = {k: np.asarray(v) for k, v in jweights.flatten_tree(_jax_al_init(
        jax.random.key(0), jconfigs.ALIKEDConfig(model_name=name))).items()}
    rng = np.random.default_rng(1)
    for k, v in flat.items():
        field = k.split("/")[-1]
        if "/bn" in k:
            flat[k] = {"scale": rng.uniform(0.5, 1.5, v.shape),
                       "bias": rng.normal(0, 0.1, v.shape),
                       "mean": rng.normal(0, 0.1, v.shape),
                       "var": rng.uniform(0.5, 1.5, v.shape)}[field].astype(np.float32)
        elif field == "w" and "offset_conv" not in k \
                and not k.startswith("desc_head"):
            flat[k] = v * (3.0 if k.startswith("score_head") else 2.0)
    return (jweights.unflatten_tree(flat), weights.aliked_from_jax_params(
        flat, configs.ALIKEDConfig(model_name=name)))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


# --- each kernel's bf16 plain version against its Pallas kernel --------------


STEM_SHAPES = [(2, 64, 256), (1, 80, 300)]  # tests/test_stem.py's


@functools.lru_cache(maxsize=None)
def _stem_pair(shape):
    jp, tp = _sp_params()
    b, h, w = shape
    img = np.random.default_rng(3).uniform(0, 1, (b, h, w, 1)).astype(np.float32)
    got = stem.fused_stem_plain(tp, _nchw(img), mp=True)
    want = _strict(fused_stem_pallas,
                   {"conv1a": jp["conv1a"], "conv1b": jp["conv1b"]},
                   jnp.asarray(img), mp=True, interpret=True,
                   out_layout="cplane")  # (B, H/2, 64, W/2)
    return img, got, want


@pytest.mark.parametrize("shape", STEM_SHAPES)
def test_stem_bf16_plain_vs_pallas(shape):
    _, got, want = _stem_pair(shape)
    b, h, w = shape
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    assert tuple(got.shape) == (b, 64, h // 2, w // 2)
    _close(got.permute(0, 2, 1, 3), np.asarray(want, np.float32))


def test_bound_catches_a_stem_rounded_only_at_its_output():
    """The fp32 stem rounded to bf16 at the end: the rounding points inside
    (the image, conv1a's output, each sum before its bias) move the output
    past the bound."""
    img, _, want = _stem_pair(STEM_SHAPES[0])
    late = stem.fused_stem_plain(_sp_params()[1], _nchw(img)).to(BF)
    rel, scaled = _reach(late.permute(0, 2, 1, 3), np.asarray(want, np.float32))
    assert max(rel, scaled) > 1.0, (rel, scaled)


@pytest.mark.parametrize("shape", STEM_SHAPES)
def test_stem_to_block2_bf16_plain_vs_pallas(shape):
    """The B7 -> B8 chain: each side's bf16 stem output into its block 2
    (Pallas: the channel-plane layout, lanes padded to 128)."""
    jp, tp = _sp_params()
    _, got7, want7 = _stem_pair(shape)
    b, h, w = shape
    got = stem2.fused_block2_plain(tp, got7)
    assert got.dtype == BF and tuple(got.shape) == (b, 64, h // 4, w // 4)
    x = jnp.pad(want7, ((0, 0), (0, 0), (0, 0),
                        (0, -(-(w // 2) // 128) * 128 - w // 2)))
    want = _strict(fused_block2_pallas,
                   {"conv2a": jp["conv2a"], "conv2b": jp["conv2b"]}, x,
                   h2=h // 2, w2=w // 2, mp=True, interpret=True)
    _close(got.permute(0, 2, 3, 1), np.asarray(want, np.float32))


@pytest.mark.parametrize("name, shape", [
    ("aliked-n16", (1, 32, 64)), ("aliked-n16", (2, 48, 96)),
    ("aliked-t16", (1, 40, 72)), ("aliked-t16", (2, 32, 64))])
def test_aliked_stem_bf16_plain_vs_jax(name, shape):
    """B10's bf16 form against the Pallas kernel at mp; at aliked-t16 the
    kernel (built for C1 16, CY 32) takes the 8-channel weights zero-padded,
    with identity batch norms on the padded channels (their SELU(0) = 0
    outputs are dropped)."""
    jp, tp = _al_params(name)
    b, h, w = shape
    img = np.random.default_rng(4).uniform(0, 1, (b, h, w, 3)).astype(np.float32)
    jimg = jnp.asarray(img).astype(jnp.bfloat16)
    y1, x1p = aliked_stem.fused_aliked_stem(tp, _nchw(img).to(BF))
    c1 = 16 if name == "aliked-n16" else 8
    assert y1.dtype == BF and x1p.dtype == BF
    assert tuple(y1.shape) == (b, h, w, 2 * c1)
    assert tuple(x1p.shape) == (b, c1, h // 2, w // 2)
    jy1, jx = _strict(jstem, _padded16(jp), jimg, mp=True, interpret=True)
    _close(y1, np.asarray(jy1, np.float32)[..., :2 * c1])
    _close(x1p.permute(0, 2, 3, 1), np.asarray(jx, np.float32)[..., :c1])


def _padded16(jp):
    """{"block1", "conv1"} of a JAX tree, channels zero-padded to C1 16 and
    CY 32 (identity batch norms on the padded channels)."""
    def pad(w, *to):
        return jnp.pad(w, [(0, t - n) for n, t in zip(w.shape, to)])
    bp = jp["block1"]
    c1 = bp["conv2"]["w"].shape[-1]
    bn = lambda p: {k: jnp.pad(v, (0, 16 - c1), constant_values=float(
        k in ("scale", "var"))) for k, v in p.items()}
    return {"block1": {"conv1": {"w": pad(bp["conv1"]["w"], 3, 3, 3, 16)},
                       "bn1": bn(bp["bn1"]),
                       "conv2": {"w": pad(bp["conv2"]["w"], 3, 3, 16, 16)},
                       "bn2": bn(bp["bn2"])},
            "conv1": {"w": pad(jp["conv1"]["w"], 1, 1, 16, 32)}}


def _score_case(seed, b, h, w):
    jp, tp = _al_params("aliked-n16")
    rng = np.random.default_rng(seed)
    parts = [rng.standard_normal((b, 8, max(1, h // f), max(1, w // f)))
             .astype(np.float32) for f in (1, 2, 8, 32)]
    return jp["score_head"], tp["score_head"], parts


@pytest.mark.parametrize("shape", [(2, 64, 96)])
def test_score_head_lazy_bf16_plain_vs_pallas(shape):
    """B11's bf16 form from fp32 branch parts."""
    jsh, tsh, parts = _score_case(5, *shape)
    got = score_head.score_head_lazy(tsh, *map(torch.from_numpy, parts), mp=True)
    want = _strict(score_head_pallas_lazy, jsh, *map(jnp.asarray, parts),
                   mp=True, interpret=True)
    assert got.dtype == torch.float32
    _close(got, np.asarray(want))


@pytest.mark.parametrize("shape", [(2, 40, 72)])
def test_score_head_cplane_bf16_plain_vs_pallas(shape):
    """B12's bf16 form from an fp32 s0."""
    jsh, tsh, _ = _score_case(6, *shape)
    s0 = np.random.default_rng(7).standard_normal(
        (shape[0], 8, *shape[1:])).astype(np.float32)
    got = score_head.score_head_cplane(tsh, torch.from_numpy(s0), mp=True)
    want = _strict(score_head_pallas_cplane, jsh, jnp.asarray(s0), mp=True,
                   tile_rows=64, interpret=True)
    assert got.dtype == torch.float32
    _close(got, np.asarray(want))


def test_bf16_weight_layouts_and_caches():
    """prepare_conv's bf16 layout is csrc/conv_wgmma.cuh's 128-byte swizzle
    (output channel co's 16-byte chunk c, input channels 8c .. 8c + 7, at
    chunk c ^ (co % 8) of its row); the caches keep one entry per type (B7,
    B8, B10) or per mp (B11, B12)."""
    _, tp = _sp_params()
    w = tp["conv2a"]["w"]
    got = stem.prepare_conv(w, BF).float()  # (9, 64, 64)
    wt = w.permute(2, 3, 0, 1).reshape(9, 64, 64).to(BF).float()
    for co in range(64):
        for c in range(8):
            e = 8 * (c ^ (co % 8))
            assert torch.equal(got[:, co, e:e + 8], wt[:, co, 8 * c:8 * c + 8])
    assert stem.prepared_conv(w, BF) is stem.prepared_conv(w, BF)
    assert stem.prepared_conv(w) is not stem.prepared_conv(w, BF)
    assert stem.prepared_conv(w).dtype == torch.float32
    _, ap = _al_params("aliked-t16")
    k1, w2, wy = aliked_stem.prepared(ap, BF)
    assert aliked_stem.prepared(ap, BF)[1] is w2
    assert w2.shape == (5, 1, 32, 4) and w2.dtype == BF  # taps paired
    assert torch.equal(w2[4, 0, :, 2:].float(), torch.zeros(32, 2))  # tap 10
    assert wy.shape == (2, 32, 4) and torch.equal(wy[..., 2:].float(),
                                                  torch.zeros(2, 32, 2))
    assert torch.equal(k1, k1.to(BF).float())
    _, np16 = _al_params("aliked-n16")
    assert aliked_stem.prepared(np16, BF)[1].shape == (9, 2, 32, 4)
    sh = np16["score_head"]
    a, b = score_head.prepared(sh, True), score_head.prepared(sh)
    assert score_head.prepared(sh, True) is a and a is not b
    assert torch.equal(a, b.to(BF).float()) and not torch.equal(a, b)


# --- whole extraction against the JAX package at mp --------------------------


def _common(ka, kb, va, vb, tol):
    """Per image: the share of a's valid keypoints with one of b's within
    ``tol`` px, and the index pairs (i, j) of those."""
    shares, pairs = [], []
    for i in range(ka.shape[0]):
        ia, ib = np.flatnonzero(va[i]), np.flatnonzero(vb[i])
        d = np.abs(ka[i][ia][:, None] - kb[i][ib][None]).max(-1)
        hit = d.min(1) <= tol
        shares.append(float(hit.mean()) if len(ia) else 1.0)
        pairs.append((ia[hit], ib[d.argmin(1)[hit]]))
    return shares, pairs


def _sp_images(seed, b, h, w):
    rng = np.random.default_rng(seed)
    return np.stack([texture(rng, h, w) for _ in range(b)])[..., None]


@pytest.mark.parametrize("fused_stem", [True, False])
@pytest.mark.parametrize("shape", [(1, 64, 256), (2, 96, 128)])
def test_superpoint_forward_mp_vs_jax(shape, fused_stem):
    """At 128 keypoints, a cap that binds as the main path's 1024 do at
    768 x 1024 (so ``valid`` is all slots on both sides). Measured on these
    inputs: 0.984-1.0 of the keypoints in common (B7 and B8 round where the
    TPU kernels do, which is not where XLA's composition does);
    descriptors within 1.8e-3 and scores within 8.6 % of the JAX package's
    at mp, where its own mp output lies 2.1e-3 and 8.1 % from its fp32 one
    (a softmax of bf16 logits). Held at 0.95, 5e-3 and 15 %."""
    _, tp = _sp_params()
    img = _sp_images(0, *shape)
    conf = configs.SuperPointConfig(max_num_keypoints=128, mp=True,
                                    fused_stem=fused_stem)
    got = sp.forward(tp, conf, torch.from_numpy(img))
    want = _jax_superpoint(shape)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.descriptors.dtype == torch.float32
    shares, pairs = _common(got.keypoints.numpy(), np.asarray(want.keypoints),
                            got.valid.numpy(), np.asarray(want.valid), 0.0)
    assert min(shares) >= 0.95, shares
    for i, (a, b) in enumerate(pairs):
        d = got.descriptors.numpy()[i][a] - np.asarray(want.descriptors)[i][b]
        assert np.abs(d).max() <= 5e-3
        s, ws = got.keypoint_scores.numpy()[i][a], np.asarray(want.keypoint_scores)[i][b]
        assert (np.abs(s - ws) <= 0.15 * ws).all()


@functools.lru_cache(maxsize=None)
def _jax_superpoint(shape):
    """The JAX package's SuperPoint features at mp on _sp_images(0, *shape),
    128 keypoints, once per shape."""
    jp, _ = _sp_params()
    jconf = jconfigs.SuperPointConfig(max_num_keypoints=128, mp=True)
    return _strict(lambda p, x: jsp.forward(p, jconf, x), jp,
                   jnp.asarray(_sp_images(0, *shape)))


def _al_images(seed, b, h, w):
    rng = np.random.default_rng(seed)
    return np.stack([image_pair(rng, h, w)[0] for _ in range(b)])[..., None]


@pytest.mark.parametrize("opts", [
    dict(lazy_fm=True), dict(lazy_fm=True, fused_score_head=True),
    dict(lazy_fm=True, fused_stem=False), dict(lazy_fm=False),
    dict(lazy_fm=False, fused_score_head=True)])
@pytest.mark.parametrize("name", ["aliked-n16", "aliked-t16"])
def test_aliked_forward_mp_vs_jax(name, opts):
    """ALIKED's score map is nearly flat around its peaks, so bf16 changes
    which peaks win far more than SuperPoint's: the JAX package's own mp
    and fp32 outputs share 0.45-0.8 of their keypoints here. The composed
    path (fused_stem off, no fused score head) matches the JAX package's
    XLA composition at aliked-n16 to 6e-8 in the score map (every keypoint
    in common); B10, B11 and B12 round where the TPU kernels round, not
    where XLA does. Held: the score map's mean |difference| no larger than
    between the JAX package's own mp and fp32 maps (measured 0.0006-0.0066
    against 0.0055-0.0070), its largest within 0.08 (measured 0.057); the
    share of keypoints in common >= 0.3 within 0.5 px (measured 0.42-1.0);
    the valid count equal at aliked-n16, where the cap of 128 binds, and
    within 20 % at aliked-t16, whose scores sit near the 0.2 threshold (the
    JAX package's own mp and fp32 counts differ by up to 10 %, the kernel
    paths' by up to 16 %); the descriptors of the common keypoints within
    5e-3 (measured 8.2e-4)."""
    jp, tp = _al_params(name)
    img = _al_images(0, 2, 64, 96)
    conf = configs.ALIKEDConfig(model_name=name, max_num_keypoints=128,
                                mp=True, **opts)
    got = al.forward(tp, conf, torch.from_numpy(img))
    want, jmp, j32 = _jax_aliked(name, opts["lazy_fm"])
    assert got.descriptors.dtype == torch.float32
    v, wv = got.valid.numpy(), np.asarray(want.valid)
    if name == "aliked-n16":
        np.testing.assert_array_equal(v, wv)
    else:
        assert (np.abs(v.sum(1) - wv.sum(1)) <= 0.2 * wv.sum(1)).all()
    shares, pairs = _common(got.keypoints.numpy(), np.asarray(want.keypoints),
                            v, wv, 0.5)
    assert min(shares) >= 0.3, shares
    for i, (a, b) in enumerate(pairs):
        d = got.descriptors.numpy()[i][a] - np.asarray(want.descriptors)[i][b]
        assert np.abs(d).max() <= 5e-3
    # the score maps, against the JAX package's own mp-to-fp32 distance
    x = _nchw(np.repeat(img, 3, -1)).to(BF)
    if opts["lazy_fm"]:
        sm = al._dense_branches(tp, x, opts.get("fused_score_head", False),
                                opts.get("fused_stem", True))[1]
    else:
        sm = al._dense_raw(tp, x, opts.get("fused_score_head", False))[1]
    diff = np.abs(sm.numpy() - jmp)
    assert diff.max() <= 0.08
    assert diff.mean() <= np.abs(jmp - j32).mean()


@functools.lru_cache(maxsize=None)
def _jax_aliked(name, lazy):
    """The JAX package's features at mp on ``_al_images(0, 2, 64, 96)``
    and its score maps at mp and fp32, once per (model, lazy)."""
    jp, _ = _al_params(name)
    img = _al_images(0, 2, 64, 96)
    jconf = jconfigs.ALIKEDConfig(model_name=name, max_num_keypoints=128,
                                  mp=True, lazy_fm=lazy)
    want = _strict(lambda p, x: jal.forward(p, jconf, x), jp, jnp.asarray(img))
    jx = jnp.asarray(np.repeat(img, 3, -1))
    dense = jal._dense_branches if lazy else jal._dense_raw
    jmp = np.asarray(_strict(dense, jp, jx.astype(jnp.bfloat16))[1])
    j32 = np.asarray(_strict(dense, jp, jx)[1])
    return want, jmp, j32


# --- images to matches --------------------------------------------------------


def test_make_end_to_end_mp_vs_jax():
    """SuperPoint at mp into the matcher at mp, both images of a batch of 2
    in one call, against the JAX pipeline at mp (the composed blocks, as in
    tests/test_torch_extract.py). Keypoints in common >= 0.95 and, on the
    pairs whose keypoints are common to both sides, matches0 equal on
    >= 0.95 of them (measured: all)."""
    jp, tp = _sp_params()
    rng = np.random.default_rng(0)
    img0, img1, _ = image_pair(rng, 96, 128)
    im0 = np.stack([img0, img1])[..., None]
    im1 = np.stack([img1, img0[::-1].copy()])[..., None]
    sizes = np.array([[128, 96], [120, 88]], np.float32)
    npz = "weights/synthetic_superpoint_lightglue.npz"
    mkw = dict(fused_self=False, fused_cross=False, pruning_min_kpts=32, mp=True)
    mconf = configs.lightglue_config("superpoint", **mkw)
    jmconf = jconfigs.lightglue_config("superpoint", **mkw)
    run = end_to_end.make_end_to_end(
        sp.forward, tp, configs.SuperPointConfig(max_num_keypoints=128, mp=True),
        weights.load_params(npz, mconf), mconf)
    jrun = jend_to_end.make_end_to_end(
        jsp.forward, jp, jconfigs.SuperPointConfig(max_num_keypoints=128, mp=True),
        jweights.load_params(npz, dtype=np.float32), jmconf)
    got = run(*map(torch.from_numpy, (im0, im1, sizes, sizes)))
    want = _strict(jrun, *map(jnp.asarray, (im0, im1, sizes, sizes)))
    common = []
    for gf, wf in ((got.feats0, want.feats0), (got.feats1, want.feats1)):
        np.testing.assert_array_equal(gf.valid.numpy(), np.asarray(wf.valid))
        shares, pairs = _common(gf.keypoints.numpy(), np.asarray(wf.keypoints),
                                gf.valid.numpy(), np.asarray(wf.valid), 0.0)
        assert min(shares) >= 0.95, shares
        common.append(pairs)
    m0, wm0 = got.matches.matches0.numpy(), np.asarray(want.matches.matches0)
    agree = []
    for i, ((a0, b0), (a1, b1)) in enumerate(zip(common[0], common[1])):
        to_b1 = dict(zip(a1, b1))  # port index in image 1 -> JAX index
        for ia, ib in zip(a0, b0):
            gm, wm = m0[i][ia], wm0[i][ib]
            if gm >= 0 and gm not in to_b1:
                continue  # matched to a keypoint only the port found
            agree.append((to_b1[gm] if gm >= 0 else -1) == wm)
    assert len(agree) > 100 and np.mean(agree) >= 0.95, np.mean(agree)
    assert (m0 >= 0).sum() > 0


# --- the keypoints the two extractions do not share ---------------------------


@contextlib.contextmanager
def _tpu_kernels_interpreted():
    """The JAX package's dense forwards with their Pallas kernels engaged
    where the TPU engages them, run in interpret mode: the TPU check and
    the kernels' shape gates opened (interpret mode runs any size), block
    2's lanes padded to 128 (as test_stem_to_block2_bf16_plain_vs_pallas
    pads them), and an einsum of bf16 operands into fp32 given the same
    values in fp32 (XLA on the CPU has no bf16 dot into the score head's
    channel-plane fp32 output; a product of two bf16 values is exact in
    fp32, so the products and their fp32 sums are the ones asked for)."""
    einsum, block2 = jnp.einsum, jops_stem2.fused_block2_pallas

    def einsum_f32(spec, *ops, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            ops = [o.astype(jnp.float32) for o in ops]
        return einsum(spec, *ops, preferred_element_type=preferred_element_type,
                      **kw)

    def block2_padded(p, x, **kw):
        pad = -(-x.shape[-1] // 128) * 128 - x.shape[-1]
        return block2(p, jnp.pad(x, ((0, 0), (0, 0), (0, 0), (0, pad))),
                      interpret=True, **kw)

    interpreted = lambda f: functools.partial(f, interpret=True)  # noqa: E731
    patches = [(jlg, "_on_tpu", lambda: True), (jnp, "einsum", einsum_f32),
               (jops_stem2, "fused_block2_pallas", block2_padded)]
    for mod, name in ((jops_stem, "stem_pallas_ok"),
                      (jops_stem2, "block2_pallas_ok"),
                      (jops_astem, "aliked_stem_ok"),
                      (jops_score, "score_head_lazy_ok"),
                      (jops_score, "score_head_cplane_ok")):
        patches.append((mod, name, lambda h, w: True))
    for mod, name in ((jops_stem, "fused_stem_pallas"),
                      (jops_astem, "fused_aliked_stem"),
                      (jops_score, "score_head_pallas_lazy"),
                      (jops_score, "score_head_pallas_cplane")):
        patches.append((mod, name, interpreted(getattr(mod, name))))
    with contextlib.ExitStack() as stack:
        for mod, name, f in patches:
            stack.enter_context(mock.patch.object(mod, name, f))
        yield


@functools.lru_cache(maxsize=None)
def _jax_reference_map(kind, which, opts):
    """The JAX package's dense score map at mp on the images of
    test_unshared_keypoints_are_near_ties, with its Pallas kernels
    engaged (interpret mode) where the port's options run the port's:
    B7 and B8 (SuperPoint's fused stem), B10 (aliked-n16's fused stem),
    B11 and B12 (the fused score head); XLA's composition elsewhere."""
    opts = dict(opts)
    if kind == "superpoint":
        jp, _ = _sp_params()
        x = jnp.asarray(_sp_images(0, *which))
        fn = lambda p, x: jsp.dense_forward(  # noqa: E731
            p, x, mp=True, fused_stem=opts["fused_stem"])[0]
    else:
        jp, _ = _al_params(which)
        x = jnp.asarray(np.repeat(_al_images(0, 2, 64, 96), 3, -1)
                        ).astype(jnp.bfloat16)
        fused = opts.get("fused_score_head", False)
        fn = (lambda p, x: jal._dense_branches(  # noqa: E731
            p, x, fused_score=fused, fused_stem=opts.get("fused_stem", True))[1]
        ) if opts["lazy_fm"] else (lambda p, x: jal._dense_raw(  # noqa: E731
            p, x, fused_score=fused)[1])
    with _tpu_kernels_interpreted():
        return np.asarray(_strict(fn, jp, x))


ALIKED_PATHS = (dict(lazy_fm=True), dict(lazy_fm=True, fused_score_head=True),
                dict(lazy_fm=True, fused_stem=False), dict(lazy_fm=False),
                dict(lazy_fm=False, fused_score_head=True))
MARGIN_CASES = (
    [("superpoint", shape, dict(fused_stem=fs))
     for shape in ((1, 64, 256), (2, 96, 128)) for fs in (True, False)]
    + [("aliked", name, opts) for name in ("aliked-n16", "aliked-t16")
       for opts in ALIKED_PATHS])


@pytest.mark.parametrize("kind, which, opts", MARGIN_CASES)
def test_unshared_keypoints_are_near_ties(kind, which, opts):
    """The keypoints one side keeps and the other does not, at mp, the
    port against the JAX package with the Pallas counterparts of the
    port's kernels engaged: none clears both margins, against the cut and
    against its NMS window's runner-up, by more than 4 steps of its score
    (one bf16 step, or what one bf16 step of SuperPoint's logits or of
    ALIKED's sigmoid input moves it). Measured: SuperPoint 0-5 unshared of
    128 or 256, none over 4 steps on both (in bf16 steps of the score
    alone, one at (2, 96, 128) with the fused stem: 89 and 6.7 steps);
    aliked-n16 101 and 84 unshared of 256 on its B10 and B10 + B11 paths,
    none on the others; aliked-t16 one of 117 with B11, none elsewhere;
    none over 4 steps on both."""
    if kind == "superpoint":
        _, tp = _sp_params()
        img = torch.from_numpy(_sp_images(0, *which))
        conf = configs.SuperPointConfig(max_num_keypoints=128, mp=True, **opts)
        mine = km.detection_maps(kind, tp, conf, img)
        raw = torch.from_numpy(_jax_reference_map(kind, which,
                                                  tuple(opts.items())))
        # the steps of JAX's scores from the port's logits: both round the
        # same logits to bf16, within a step of each other
        theirs = (raw, sp.detection_map(raw, conf), mine[2])
    else:
        _, tp = _al_params(which)
        conf = configs.ALIKEDConfig(model_name=which, max_num_keypoints=128,
                                    mp=True, **opts)
        mine = km.detection_maps(kind, tp, conf,
                                 torch.from_numpy(_al_images(0, 2, 64, 96)))
        raw = torch.from_numpy(_jax_reference_map(kind, which,
                                                  tuple(opts.items())))
        theirs = (raw, al.detection_map(raw, conf),
                  km.score_steps(raw, sigmoid=True))
    m = km.unshared_margins(mine, theirs, conf.max_num_keypoints,
                            conf.detection_threshold, conf.nms_radius)
    print(km.summary(m))
    assert km.faults(m["a"]) == 0 and km.faults(m["b"]) == 0, km.summary(m)


@pytest.mark.parametrize("dtype", [BF, torch.float32])
def test_bilinear_taps_equal_jax_to_the_bit(dtype):
    """The deformable conv's bilinear samples against the JAX package's
    (``_bilinear_gather``, compiled by XLA, which fuses its sum of four
    products into multiply-adds), inside the map, across its edges and
    off it: equal to the bit. Summed as four rounded products, one sample
    in six differed by an fp32 step, and at mp a one-step flip of a
    sample in aliked-t16's block 3 moved keypoint scores by up to 17 of
    their steps."""
    rng = np.random.default_rng(77)
    b, h, w, c = 2, 8, 12, 16
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)) \
        if dtype == BF else x
    fy = rng.uniform(-3, h + 2, (b, 50, 9)).astype(np.float32)
    fx = rng.uniform(-3, w + 2, (b, 50, 9)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == BF else jnp.float32)
    want = np.asarray(_strict(jdeform._bilinear_gather, jx, fy, fx))
    got = deform.bilinear_taps(torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2),
                               torch.from_numpy(fy), torch.from_numpy(fx))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mp", [True, False])
def test_aliked_t16_runs_the_composed_block1(mp, monkeypatch):
    """B10 runs block 1 only where it has 16 channels, as in the JAX
    package: aliked-t16 with ``fused_stem`` equals its composed block 1 to
    the bit, and B10 is not called; aliked-n16 calls it."""
    calls = []
    op = aliked_stem.fused_aliked_stem
    monkeypatch.setattr(aliked_stem, "fused_aliked_stem", lambda *a: (
        calls.append(a[0]["conv1"]["w"].shape[1]), op(*a))[1])
    x = _nchw(np.repeat(_al_images(2, 1, 32, 64), 3, -1))
    x = x.to(BF) if mp else x
    with torch.inference_mode():
        for name in ("aliked-t16", "aliked-n16"):
            tp = _al_params(name)[1]
            fused = al._dense_branches(tp, x, fused_stem=True)[1]
            composed = al._dense_branches(tp, x, fused_stem=False)[1]
            if name == "aliked-t16":
                assert torch.equal(fused, composed) and calls == []
    assert calls == [16]
