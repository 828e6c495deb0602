"""lightglue_tpu_torch ALIKED against lightglue_tpu on the CPU, on the same
seeded numpy inputs and weights: the deformable conv, row-normalized
sampling, the weights bridge, ``models.aliked.forward`` (lazy and dense
feature maps, aliked-n16 and aliked-t16) and ``match_pair`` with the
``"aliked"`` matcher preset.

ALIKED runs with the JAX package's random init, encoder and aggregation
conv weights times 2 and score-head conv weights times 3 (``_gained``):
unscaled, every score lies within about 1e-3 of 0.5 and neighbouring
scores within a few ulps, so no two frameworks rank them alike (the
stand-in for the release weights, which are not in the repository).

Tolerances (fp32): ``valid``, matches, ``stop`` and prune depths exactly
equal; keypoints within 1e-4 px (the 5x5 soft-argmax at temperature 0.1
scales score differences by about 10); descriptors and scores within 1e-4;
the deformable conv and sampling within 1e-5.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu import configs as jconfigs
from lightglue_tpu import pipeline as jpipeline
from lightglue_tpu import weights as jweights
from lightglue_tpu.models import aliked as jal
from lightglue_tpu.models import lightglue as jlg
from lightglue_tpu.ops import deform as jdeform
from lightglue_tpu.ops import sampling as jsampling
from lightglue_tpu_torch import ALIKED, LightGlue, configs, match_pair, weights
from lightglue_tpu_torch.models import aliked as al
from lightglue_tpu_torch.ops import deform, sampling
from lightglue_tpu_torch.synthetic import image_pair

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
K = 128  # keypoints per image
_jax_forward = jax.jit(jal.forward, static_argnames=("conf",))
_jax_init = jax.jit(jal.init_params, static_argnums=1)


def _gained(flat):
    """Encoder and aggregation conv weights times 2, score-head conv
    weights times 3; offset convs and the descriptor head as drawn."""
    out = {}
    for k, v in flat.items():
        v = np.asarray(v)
        if k.endswith("/w") and "offset_conv" not in k \
                and not k.startswith("desc_head"):
            v = v * (3.0 if k.startswith("score_head") else 2.0)
        out[k] = v
    return out


@functools.lru_cache(maxsize=None)
def _flat(name="aliked-n16"):
    """The JAX package's init (key 0) of ``name``, gained, flat."""
    return _gained(jweights.flatten_tree(_jax_init(
        jax.random.key(0), jconfigs.ALIKEDConfig(model_name=name))))


@pytest.fixture(scope="module", params=["aliked-n16", "aliked-t16"])
def model(request):
    name = request.param
    flat = _flat(name)
    return (name, jweights.unflatten_tree(flat),
            weights.aliked_from_jax_params(
                flat, configs.ALIKEDConfig(model_name=name)))


def _images(seed, b, h, w):
    rng = np.random.default_rng(seed)
    return np.stack([image_pair(rng, h, w)[0] for _ in range(b)])[..., None]


def _check_features(got, want, min_valid=20):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert int(got.valid.sum()) >= min_valid
    np.testing.assert_allclose(got.keypoints.numpy(), np.asarray(want.keypoints),
                               atol=1e-4, rtol=0)
    for f in ("keypoint_scores", "descriptors"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), atol=1e-4,
                                   rtol=0, err_msg=f)


# --- ops ----------------------------------------------------------------------


def test_deform_conv2d_matches_jax():
    """Offsets up to +-6 px on a 12 x 16 map, so that taps fall outside it
    on every side (zero there)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 16, 8)).astype(np.float32)
    off = rng.uniform(-6, 6, (2, 12, 16, 18)).astype(np.float32)
    w = rng.standard_normal((3, 3, 8, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    want = jdeform.deform_conv2d(jnp.asarray(x), jnp.asarray(off), jnp.asarray(w),
                                 jnp.asarray(b))
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))
    got = deform.deform_conv2d(to(x), to(off),
                               torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                               torch.from_numpy(b))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)


def test_deformable_conv_block_matches_jax():
    """Offsets of a few pixels, many beyond the clamp at max(H, W)/4 = 3."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 8, 12, 6)).astype(np.float32)
    jp = {"offset_conv": {"w": rng.standard_normal((3, 3, 6, 18)).astype(np.float32),
                          "b": rng.standard_normal(18).astype(np.float32)},
          "regular_conv": {"w": rng.standard_normal((3, 3, 6, 4)).astype(np.float32)
                           / np.sqrt(54.0, dtype=np.float32)}}
    tp = {"offset_conv": {"w": torch.from_numpy(jp["offset_conv"]["w"].transpose(3, 2, 0, 1).copy()),
                          "b": torch.from_numpy(jp["offset_conv"]["b"])},
          "regular_conv": {"w": torch.from_numpy(jp["regular_conv"]["w"].transpose(3, 2, 0, 1).copy())}}
    want = jdeform.deformable_conv_block(jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    got = deform.deformable_conv_block(
        tp, torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)


def test_bilinear_sample_row_normalized_matches_jax():
    rng = np.random.default_rng(2)
    fmap = rng.standard_normal((2, 10, 14, 6)).astype(np.float32)
    fmap[0, 3, 4] = 0.0  # a zero row: normalized to 0, not NaN
    pts = rng.uniform(-1.2, 1.2, (2, 30, 2)).astype(np.float32)
    want = jsampling.bilinear_sample(jnp.asarray(fmap), jnp.asarray(pts),
                                     row_l2_normalize=True)
    got = sampling.bilinear_sample(torch.from_numpy(fmap), torch.from_numpy(pts),
                                   row_l2_normalize=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    assert np.isfinite(got.numpy()).all()


# --- weights --------------------------------------------------------------------


@pytest.mark.parametrize("name", ["aliked-n16", "aliked-t16", "aliked-n32",
                                  "aliked-n16rot"])
def test_state_dict_bridge(name):
    """A random reference state dict (keys and shapes from the fixture) ->
    port -> state dict, identically; and through JAX convert_aliked ->
    flat -> port, the same tree."""
    with open(os.path.join(FIXTURES, f"{name}.json")) as f:
        shapes = json.load(f)["keys"]
    rng = np.random.default_rng(3)
    sd = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    conf = configs.ALIKEDConfig(model_name=name)
    port = weights.aliked_from_state_dict(sd, conf)
    back = weights.aliked_to_state_dict(port, conf)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k])
    via_jax = weights.aliked_from_jax_params(
        jweights.flatten_tree(jweights.convert_aliked(sd)), conf)
    flat_a, flat_b = (jweights.flatten_tree(jax.tree.map(np.asarray, t))
                      for t in (port, via_jax))
    assert set(flat_a) == set(flat_b)
    for k in flat_a:
        np.testing.assert_array_equal(flat_a[k], flat_b[k], err_msg=k)
    init = al.init_params(conf)
    assert {k: tuple(v.shape) for k, v in
            weights.aliked_to_state_dict(init, conf).items()} == {
        k: tuple(s) for k, s in shapes.items()}


def test_bad_keys_and_shapes_raise():
    flat = _flat()
    bad = dict(flat)
    bad.pop("block2/bn1/var")
    with pytest.raises(KeyError, match="block2/bn1/var"):
        weights.aliked_from_jax_params(bad)
    with pytest.raises(KeyError, match="unexpected"):
        weights.aliked_from_jax_params({**flat, "extra/w": np.zeros(1)})
    with pytest.raises(ValueError, match="desc_head"):  # aliked-n32 has M 32
        weights.aliked_from_jax_params(
            flat, configs.ALIKEDConfig(model_name="aliked-n32"))


# --- the model --------------------------------------------------------------------


@pytest.mark.parametrize("lazy", [True, False])
def test_forward_matches_jax(model, lazy):
    name, jp, tp = model
    img = _images(0, 2, 64, 96)
    size = np.array([[96, 64], [90, 60]], np.float32)  # image 1 padded
    conf = configs.ALIKEDConfig(model_name=name, max_num_keypoints=K, lazy_fm=lazy)
    jconf = jconfigs.ALIKEDConfig(model_name=name, max_num_keypoints=K,
                                  lazy_fm=lazy)
    got = al.forward(tp, conf, torch.from_numpy(img), torch.from_numpy(size))
    want = _jax_forward(jp, jconf, jnp.asarray(img), jnp.asarray(size))
    _check_features(got, want)
    k1 = got.keypoints.numpy()[1][got.valid.numpy()[1]]
    assert (k1[:, 0] < 90 - 2).all() and (k1[:, 1] < 60 - 2).all()
    # on the CPU the kernels' switches select the same plain versions
    fused = al.forward(tp, conf.replace(fused_stem=False, fused_score_head=True),
                       torch.from_numpy(img), torch.from_numpy(size))
    for f in got._fields:
        a, b = getattr(got, f), getattr(fused, f)
        assert (a is None and b is None) or torch.equal(a, b), f


def test_branch_of_one_row_follows_the_dense_path(model):
    """At H = 32 the coarsest branch has one row. The port's lazy path is
    held against the JAX package's DENSE path there: the JAX lazy path
    clamps that branch to a row that does not exist (models/aliked.py:491)
    and gives other descriptors."""
    name, jp, tp = model
    img = _images(1, 1, 32, 128)
    conf = configs.ALIKEDConfig(model_name=name, max_num_keypoints=32)
    jconf = jconfigs.ALIKEDConfig(model_name=name, max_num_keypoints=32,
                                  lazy_fm=False)
    got = al.forward(tp, conf, torch.from_numpy(img))
    _check_features(got, _jax_forward(jp, jconf, jnp.asarray(img)), min_valid=8)


def test_gray_and_rgb_and_stride(model):
    name, _, tp = model
    conf = configs.ALIKEDConfig(model_name=name, max_num_keypoints=16)
    gray = torch.from_numpy(_images(2, 1, 32, 64))
    a = al.forward(tp, conf, gray)
    b = al.forward(tp, conf, gray.expand(-1, -1, -1, 3).contiguous())
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None and y is None) or torch.equal(x, y), f
    with pytest.raises(ValueError, match="multiples of 32"):
        al.forward(tp, conf, torch.zeros(1, 48, 64, 3))


def test_configs_match_jax():
    mine, theirs = configs.ALIKEDConfig(), jconfigs.ALIKEDConfig()
    assert set(mine.__dataclass_fields__) == set(theirs.__dataclass_fields__)
    for f in mine.__dataclass_fields__:
        assert getattr(mine, f) == getattr(theirs, f), f
    assert configs.ALIKEDConfig(mp=True).mp  # the bf16 path is ported


# --- the pipeline -------------------------------------------------------------------


def test_match_pair_matches_jax(tmp_path):
    """match_pair(ALIKED, LightGlue("aliked")) on a generated pair, seeded
    random matcher weights in both packages, exactly as the JAX pipeline."""
    flat = _flat()
    mconf = jconfigs.lightglue_config("aliked", pruning_min_kpts=32)
    mflat = {k: np.asarray(v) for k, v in jweights.flatten_tree(
        jlg.init_params(jax.random.key(1), mconf)).items()}
    path = str(tmp_path / "aliked.npz")
    np.savez(path, **flat)
    ext = ALIKED(params=path, max_num_keypoints=K, device="cpu")
    m = LightGlue("aliked", params=weights.from_jax_params(
        mflat, configs.lightglue_config("aliked")), pruning_min_kpts=32,
        device="cpu")
    jext = jpipeline.ALIKED(params=jweights.unflatten_tree(flat),
                            max_num_keypoints=K)
    jm = jpipeline.LightGlue("aliked", params=jweights.unflatten_tree(mflat),
                             pruning_min_kpts=32)
    img0, img1, _ = image_pair(np.random.default_rng(4), 90, 120)
    f0, f1, got = match_pair(ext, m, img0, img1, resize=None)
    jf0, jf1, want = jpipeline.match_pair(jext, jm, img0, img1, resize=None)
    for g, w in ((f0, jf0), (f1, jf1)):
        for k in ("valid", "image_size"):
            np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=k)
        for k in ("keypoints", "keypoint_scores", "descriptors"):
            np.testing.assert_allclose(g[k], np.asarray(w[k]), atol=1e-4,
                                       rtol=0, err_msg=k)
        assert g["descriptors"].shape == (K, 128) and g["valid"].sum() > 20
    for k in ("matches0", "matches1", "prune0", "prune1"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert got["stop"] == want["stop"]
    with pytest.raises(FileNotFoundError, match="not in this repository"):
        ALIKED(pretrained=True, device="cpu")
    assert ALIKED.stride == 32
