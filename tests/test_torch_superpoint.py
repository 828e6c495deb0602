"""lightglue_tpu_torch SuperPoint against lightglue_tpu on the CPU, on the
same seeded numpy inputs: the plain versions of kernels B7-B9 against the
Pallas kernels in interpret mode and the XLA chain, the sampling and
detection helpers, ``superpoint.forward``, and the weights bridge.

Tolerances (fp32): the stem within 1e-5 max-abs (the Pallas kernel's own
bound against XLA, tests/test_stem.py); block 2 within 5e-4 (its dx-split
sums, tests/test_stem.py); NMS bitwise; keypoints, top-k indices and
``valid`` exactly equal; scores and descriptors within 1e-5.

SuperPoint runs on ``synthetic.texture`` images with the JAX package's
random init, conv weights times 3 (``models.superpoint.init_params``):
unscaled, the detector's scores all lie within a few percent of 1/65 and
differ by a few ulps, so any two frameworks rank them differently.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu import configs as jconfigs
from lightglue_tpu import nn as jnn
from lightglue_tpu import weights as jweights
from lightglue_tpu.models import superpoint as jsp
from lightglue_tpu.ops import sampling as jsampling
from lightglue_tpu.ops.nms import simple_nms_pallas
from lightglue_tpu.ops.stem import fused_stem_pallas
from lightglue_tpu.ops.stem2 import fused_block2_pallas
from lightglue_tpu_torch import _build, configs, weights
from lightglue_tpu_torch.models import superpoint as sp
from lightglue_tpu_torch.ops import nms, sampling, stem, stem2
from lightglue_tpu_torch.synthetic import texture
from lightglue_tpu_torch.utils import diagnostics

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

GAIN = 3.0


def _nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def sp_flat():
    """The JAX package's init (key 0), conv weights times GAIN, flat."""
    flat = jweights.flatten_tree(jsp.init_params(jax.random.key(0)))
    return {k: np.asarray(v) * (GAIN if k.endswith("/w") else 1.0)
            for k, v in flat.items()}


@pytest.fixture(scope="module")
def both_params(sp_flat):
    return (jweights.unflatten_tree(sp_flat),
            weights.superpoint_from_jax_params(sp_flat))


def _images(seed, b, h, w):
    rng = np.random.default_rng(seed)
    return np.stack([texture(rng, h, w) for _ in range(b)])[..., None]


# --- B7 stem and B8 block 2 -----------------------------------------------


@pytest.mark.parametrize("shape", [(2, 64, 256), (1, 80, 300)])
def test_stem_plain_vs_pallas_and_xla(both_params, shape):
    jp, tp = both_params
    b, h, w = shape
    img = np.random.default_rng(3).uniform(0, 1, (b, h, w, 1)).astype(np.float32)
    sp1 = {"conv1a": jp["conv1a"], "conv1b": jp["conv1b"]}
    got = _nhwc(stem.fused_stem(
        {"conv1a": tp["conv1a"], "conv1b": tp["conv1b"]}, _nchw(img)))
    pallas = np.asarray(fused_stem_pallas(sp1, jnp.asarray(img), mp=False,
                                          interpret=True))
    x = jax.nn.relu(jnn.conv2d(jp["conv1a"], jnp.asarray(img)))
    xla = np.asarray(jnn.max_pool(jax.nn.relu(jnn.conv2d(jp["conv1b"], x)), 2))
    assert got.shape == pallas.shape == (b, h // 2, w // 2, 64)
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, xla, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", [(2, 64, 256), (1, 80, 300)])
def test_block2_plain_vs_pallas(both_params, shape):
    """Both block-2 versions take the same input, the XLA stem's output (in
    the channel-plane layout, lanes padded to 128, for the Pallas one)."""
    jp, tp = both_params
    b, h, w = shape
    img = jnp.asarray(np.random.default_rng(7).uniform(
        0, 1, (b, h, w, 1)).astype(np.float32))
    x = jax.nn.relu(jnn.conv2d(jp["conv1a"], img))
    x = np.asarray(jnn.max_pool(jax.nn.relu(jnn.conv2d(jp["conv1b"], x)), 2))
    cp = x.transpose(0, 1, 3, 2)
    cp = np.pad(cp, ((0, 0), (0, 0), (0, 0), (0, -(-w // 256) * 128 - w // 2)))
    want = np.asarray(fused_block2_pallas(
        {"conv2a": jp["conv2a"], "conv2b": jp["conv2b"]}, jnp.asarray(cp),
        h2=h // 2, w2=w // 2, mp=False, interpret=True))
    got = _nhwc(stem2.fused_block2(
        {"conv2a": tp["conv2a"], "conv2b": tp["conv2b"]}, _nchw(x)))
    assert got.shape == want.shape == (b, h // 4, w // 4, 64)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)


# --- B9 NMS ----------------------------------------------------------------


def _nms_cases():
    rng = np.random.default_rng(0)
    cases = []
    for r in (2, 4):
        for shape in ((2, 96, 128), (1, 128, 200)):
            cases.append((f"dense-r{r}-{shape}", rng.uniform(
                0, 1, shape).astype(np.float32), r, 32))
    s = rng.uniform(0, 1e-4, (1, 160, 128)).astype(np.float32)
    s[0, rng.integers(0, 160, 50), rng.integers(0, 128, 50)] = \
        rng.uniform(0.1, 1.0, 50).astype(np.float32)
    cases.append(("sparse-peaks", s, 4, 64))
    cases.append(("negative", rng.standard_normal((2, 96, 160)).astype(
        np.float32), 2, 32))
    plateau = np.zeros((1, 96, 128), np.float32)
    plateau[0, 10:20, 10:30] = 0.5
    plateau[0, 40, 40] = 1.0
    cases.append(("plateau", plateau, 4, 32))
    cases.append(("tile-taller-than-map", rng.uniform(
        0, 1, (1, 72, 128)).astype(np.float32), 2, 256))
    return cases


@pytest.mark.parametrize("case", _nms_cases(), ids=lambda c: c[0])
def test_nms_plain_vs_pallas_bitwise(case):
    _, s, r, rows = case
    want = np.asarray(simple_nms_pallas(jnp.asarray(s), r, tile_rows=rows,
                                        interpret=True))
    got = sampling.simple_nms(torch.from_numpy(s), r).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.tobytes() == want.tobytes()


def test_nms_plain_vs_xla_small_radii():
    rng = np.random.default_rng(5)
    s = np.round(rng.uniform(0, 1, (2, 24, 40)), 1).astype(np.float32)  # ties
    for r in (0, 1, 3):
        want = np.asarray(jsampling.simple_nms(jnp.asarray(s), r))
        got = nms.simple_nms_plain(torch.from_numpy(s), r).numpy()
        assert got.tobytes() == want.tobytes()


# --- sampling and detection -------------------------------------------------


@pytest.mark.parametrize("align_corners", [True, False])
def test_bilinear_sample_outside(align_corners):
    rng = np.random.default_rng(1)
    fmap = rng.standard_normal((2, 16, 20, 8)).astype(np.float32)
    pts = rng.uniform(-1.3, 1.3, (2, 41, 2)).astype(np.float32)
    pts[0, :4] = [[-1, -1], [1, 1], [-1.05, 0.2], [0.3, 1.01]]
    got = sampling.bilinear_sample(torch.from_numpy(fmap),
                                   torch.from_numpy(pts), align_corners)
    want = jsampling.bilinear_sample(jnp.asarray(fmap), jnp.asarray(pts),
                                     align_corners)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    assert (got.numpy()[np.abs(pts).max(-1) > 1.1 + 2 / 15] == 0).all()


def test_top_k_ties_follow_jax():
    """A map after NMS and border removal: mostly tied zeros, a -1 band,
    repeated values. Indices equal jax.lax.top_k's: lower index first."""
    rng = np.random.default_rng(2)
    s = np.zeros((2, 40, 48), np.float32)
    s[:, rng.integers(4, 36, 30), rng.integers(4, 44, 30)] = 0.25
    s[:, rng.integers(4, 36, 30), rng.integers(4, 44, 30)] = 0.5
    s[:, :4] = s[:, -4:] = s[:, :, :4] = s[:, :, -4:] = -1.0
    s[1, 20, 20] = 0.0007
    for k in (16, 100, 1500, 40 * 48):
        got = sampling.top_k_keypoints(torch.from_numpy(s), k, 0.0005)
        want = jsampling.top_k_keypoints(jnp.asarray(s), k, 0.0005)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_top_k_exact_options_warn_once():
    diagnostics.reset()
    s = torch.rand(1, 8, 8, generator=torch.Generator().manual_seed(0))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        a = sampling.top_k_keypoints(s, 5, 0.1, approx_recall=0.95)
        b = sampling.top_k_keypoints(s, 5, 0.1, twolevel=True)
    assert len(rec) == 1 and "exact" in str(rec[0].message)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    diagnostics.reset()
    with pytest.raises(ValueError):
        sampling.top_k_keypoints(s, 65, 0.1)


# --- the model ---------------------------------------------------------------


@pytest.mark.parametrize("case", ["64x256", "96x128-padded"])
def test_forward_matches_jax(both_params, case):
    jp, tp = both_params
    if case == "64x256":
        img, size = _images(0, 1, 64, 256), None
    else:
        img = _images(1, 2, 96, 128)
        size = np.array([[120, 80], [128, 88]], np.float32)
    conf = configs.SuperPointConfig(max_num_keypoints=256)
    jconf = jconfigs.SuperPointConfig(max_num_keypoints=256)
    got = sp.forward(tp, conf, torch.from_numpy(img),
                     None if size is None else torch.from_numpy(size))
    want = jsp.forward(jp, jconf, jnp.asarray(img),
                       None if size is None else jnp.asarray(size))
    np.testing.assert_array_equal(got.keypoints.numpy(), np.asarray(want.keypoints))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert int(got.valid.sum()) > 100
    for f in ("keypoint_scores", "descriptors"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), atol=1e-5,
                                   rtol=0, err_msg=f)
    if size is not None:  # nothing detected in the pad band or the border
        assert not got.valid.all()  # invalid slots are compared too
        for i, (tw, th) in enumerate(size):
            k = got.keypoints.numpy()[i][got.valid.numpy()[i]]
            assert (k[:, 0] < tw - 4).all() and (k[:, 1] < th - 4).all()


def test_fused_stem_switch_and_rgb(both_params):
    """On the CPU both settings of fused_stem run the plain chain; an RGB
    image is reduced to gray first, as in the JAX package."""
    jp, tp = both_params
    rng = np.random.default_rng(4)
    rgb = rng.uniform(0, 1, (1, 32, 48, 3)).astype(np.float32)
    s1, d1 = sp.dense_forward(tp, torch.from_numpy(rgb), fused_stem=True)
    s0, d0 = sp.dense_forward(tp, torch.from_numpy(rgb), fused_stem=False)
    assert torch.equal(s1, s0) and torch.equal(d1, d0)
    js, jd = jsp.dense_forward(jp, jnp.asarray(rgb), fused_stem=False)
    assert s1.shape == (1, 32, 48) and d1.shape == (1, 4, 6, 256)
    np.testing.assert_allclose(s1.numpy(), np.asarray(js), atol=1e-5, rtol=0)
    np.testing.assert_allclose(d1.numpy(), np.asarray(jd), atol=1e-5, rtol=0)


def test_sample_descriptors_matches_jax():
    rng = np.random.default_rng(6)
    dmap = rng.standard_normal((1, 8, 10, 16)).astype(np.float32)
    kpts = rng.uniform(0, 70, (1, 12, 2)).astype(np.float32)
    got = sp.sample_descriptors(torch.from_numpy(kpts), torch.from_numpy(dmap))
    want = jsp.sample_descriptors(jnp.asarray(kpts), jnp.asarray(dmap), 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


# --- configs and dispatch ------------------------------------------------------


def test_configs_match_jax():
    for name in ("SuperPointConfig", "PreprocessConfig"):
        mine = getattr(configs, name)()
        theirs = getattr(jconfigs, name)()
        assert set(mine.__dataclass_fields__) == set(theirs.__dataclass_fields__)
        for f in mine.__dataclass_fields__:
            assert getattr(mine, f) == getattr(theirs, f), (name, f)
    assert configs.SuperPointConfig(mp=True).mp  # the bf16 path is ported


def test_cpu_never_builds_and_other_devices_raise(both_params):
    _, tp = both_params
    meta = lambda *s: torch.zeros(*s, device="meta")
    mp = lambda p: {k: {"w": v["w"].to("meta"), "b": v["b"].to("meta")}
                    for k, v in p.items()}
    with pytest.raises(ValueError, match="CUDA"):
        stem.fused_stem(mp({"conv1a": tp["conv1a"], "conv1b": tp["conv1b"]}),
                        meta(1, 1, 16, 16))
    with pytest.raises(ValueError, match="CUDA"):
        stem2.fused_block2(mp({"conv2a": tp["conv2a"], "conv2b": tp["conv2b"]}),
                           meta(1, 64, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        sampling.simple_nms(meta(1, 16, 16), 4)
    sampling.simple_nms(torch.zeros(1, 16, 16), 4)
    stem.fused_stem({"conv1a": tp["conv1a"], "conv1b": tp["conv1b"]},
                    torch.zeros(1, 1, 16, 16))
    assert _build._lib is None
    for name in ("fused_stem", "fused_block2", "simple_nms"):
        assert name in _build.KERNELS


# --- the weights bridge ---------------------------------------------------------


def test_jax_init_params_give_equal_outputs(sp_flat, both_params):
    """JAX init -> flatten_tree -> port: the same dense outputs."""
    jp, tp = both_params
    for name, (o, i, k, _) in weights.superpoint_shapes().items():
        np.testing.assert_array_equal(
            tp[name]["w"].numpy(), sp_flat[f"{name}/w"].transpose(3, 2, 0, 1))
        assert tp[name]["w"].shape == (o, i, k, k)
    img = _images(9, 1, 32, 64)
    js, jd = jsp.dense_forward(jp, jnp.asarray(img), fused_stem=False)
    ts, td = sp.dense_forward(tp, torch.from_numpy(img))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5, rtol=0)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5, rtol=0)


def test_state_dict_round_trip():
    """A random reference state dict (shapes from the fixture) -> JAX
    convert_superpoint -> flat -> port -> state dict, identically; and the
    state dict straight into the port gives the same tree."""
    import json
    import os

    fix = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "superpoint_v1.json")
    with open(fix) as f:
        shapes = json.load(f)["keys"]
    rng = np.random.default_rng(8)
    sd = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    flat = jweights.flatten_tree(jweights.convert_superpoint(sd))
    port = weights.superpoint_from_jax_params(flat)
    back = weights.superpoint_to_state_dict(port)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k])
    direct = weights.superpoint_from_state_dict(sd)
    for name in port:
        for leaf in ("w", "b"):
            assert torch.equal(direct[name][leaf], port[name][leaf])
    assert {k: list(v.shape) for k, v in back.items()} == shapes


def test_bad_keys_and_shapes_raise(sp_flat):
    bad = dict(sp_flat)
    bad.pop("convDb/b")
    with pytest.raises(KeyError, match="convDb/b"):
        weights.superpoint_from_jax_params(bad)
    with pytest.raises(KeyError, match="unexpected"):
        weights.superpoint_from_jax_params({**sp_flat, "extra/w": np.zeros(1)})
    short = {**sp_flat, "convPb/w": sp_flat["convPb/w"][..., :64]}
    with pytest.raises(ValueError, match="convPb"):
        weights.superpoint_from_jax_params(short)
    with pytest.raises(ValueError, match="convDb"):  # descriptor_dim 128
        weights.superpoint_from_jax_params(
            sp_flat, configs.SuperPointConfig(descriptor_dim=128))


def test_port_init_shapes():
    p = sp.init_params(configs.SuperPointConfig(descriptor_dim=128),
                       torch.Generator().manual_seed(0))
    want = weights.superpoint_shapes(configs.SuperPointConfig(descriptor_dim=128))
    assert {k: tuple(v["w"].shape) for k, v in p.items()} == want
    bound = 1.0 / np.sqrt(9 * 64)
    assert float(p["conv2a"]["w"].abs().max()) <= bound
    assert float(p["conv2a"]["b"].abs().max()) <= bound
