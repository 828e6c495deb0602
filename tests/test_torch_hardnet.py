"""lightglue_tpu_torch DoGHardNet against lightglue_tpu on the CPU, on the
same seeded numpy inputs: HardNet (``describe_patches``) and the LAF patch
sampler (``extract_laf_patches_batch``) against the jitted JAX functions,
the whole ``forward`` (SIFT detections, patches, CNN), the host
``DoGHardNet`` (OpenCV's detections, HardNet on the patches) and images to
matches through ``match_pair``, ``make_end_to_end`` and ``match_sequence``
from ``DoGHardNetDevice`` into ``LightGlue("doghardnet")`` with the trained
layers of ``weights/synthetic_sift_lightglue.npz`` (the preset's shapes);
then the kornia HardNet state dict against the JAX package's
``convert_hardnet``.

HardNet's weights are ``synthetic.hardnet_params`` (seeded convs, batch
norms holding the statistics of the test pair's patches) with random
batch-norm affine parameters, carried across by
``weights.hardnet_from_jax_params``.
Tolerances: the descriptors 1e-5 (unit vectors; measured 7e-7 on the same
patches, the fp32 convolutions summed in another order, and up to 6.4e-6
through the patches); the patches 5e-5 (values in [0, 1]; measured
8.2e-6: torch's and XLA's cos and sin differ by an ulp in a few percent
of angles, which moves a sample by up to about 1e-5 px at these scales); keypoints, scores and valid equal, scales and oris within 1e-5 as
``tests/test_torch_sift.py`` holds SIFT; matches equal, matching scores
within 1e-3. The descriptors of invalid slots are exactly 0. One JAX
program of the extractor is compiled (about 40 s), the JAX
DoGHardNetDevice's forward at B 1, which serves the forward, match_pair
and make_end_to_end checks.
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
from lightglue_tpu.models import hardnet as jhardnet
from lightglue_tpu_torch import (DoGHardNet, DoGHardNetDevice, LightGlue,
                                 configs, end_to_end, match_pair,
                                 match_sequence, nn, weights)
from lightglue_tpu_torch.models import hardnet
from lightglue_tpu_torch.synthetic import hardnet_params, image_pair

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "weights", "synthetic_sift_lightglue.npz")
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "hardnet_liberty_aug.json")
K = 128
H, W = 96, 128
DESC_TOL, PATCH_TOL = 1e-5, 5e-5
CONF = configs.SIFTConfig(max_num_keypoints=K, backend="device")


@functools.lru_cache(maxsize=None)
def _pair():
    a, b, _ = image_pair(np.random.default_rng(0), H, W)
    return a, b


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _flat():
    """synthetic.hardnet_params (seed 2, batch norms from the patches of
    _pair()), with random batch-norm affine parameters, as the JAX
    package's flat dict (conv weights HWIO)."""
    p = hardnet_params(_t(np.stack(_pair())), CONF, seed=2)
    rng = np.random.default_rng(3)
    flat = {}
    for k, v in weights.flatten_params(p).items():
        if k.endswith("/scale"):
            v = v * (1 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        if k.endswith("/bias"):
            v = 0.1 * rng.standard_normal(v.shape).astype(np.float32)
        flat[k] = v.transpose(2, 3, 1, 0) if v.ndim == 4 else v
    return flat


def _jparams():
    return jweights.unflatten_tree(_flat())


def _params():
    return weights.hardnet_from_jax_params(_flat())


# --- HardNet and the patches ----------------------------------------------------


def test_describe_patches_matches_jax():
    """describe_patches on random and on smooth patches (a ramp plus a
    little noise) against the jitted JAX one: within DESC_TOL, unit rows;
    nn.conv2d's stride 2 / padding 1 and 8x8 VALID forms against
    jax.lax.conv_general_dilated through the JAX package's nn.conv2d."""
    from lightglue_tpu import nn as jnn

    rng = np.random.default_rng(4)
    ramp = np.linspace(0, 1, 32, dtype=np.float32)[None, :, None, None]
    patches = np.concatenate([
        rng.random((24, 32, 32, 1), dtype=np.float32),
        ramp * rng.random((8, 1, 1, 1), dtype=np.float32)
        + 1e-3 * rng.random((8, 32, 32, 1), dtype=np.float32)])
    want = np.asarray(jax.jit(jhardnet.describe_patches)(_jparams(), patches))
    got = hardnet.describe_patches(_params(), _t(patches).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), want, atol=DESC_TOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0,
                               atol=1e-5)
    x = rng.standard_normal((2, 17, 19, 8)).astype(np.float32)
    w = rng.standard_normal((3, 3, 8, 5)).astype(np.float32)
    for kw in (dict(stride=2, padding=1), dict(padding="VALID"), {}):
        want = np.asarray(jnn.conv2d({"w": w}, jnp.asarray(x), **kw))
        got = nn.conv2d({"w": _t(w.transpose(3, 2, 0, 1))},
                        _t(x).permute(0, 3, 1, 2), **kw)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                   atol=1e-5, rtol=0, err_msg=str(kw))


def test_laf_patches_match_jax():
    """extract_laf_patches_batch at seeded centres (some beyond every
    border), scales and orientations against the jitted JAX one: within
    PATCH_TOL; the sample grid equal to the bit to the jitted
    jnp.linspace; a sample clamped to the image edge reads the edge."""
    rng = np.random.default_rng(5)
    b, k = 2, 96
    imgs = rng.random((b, H, W), dtype=np.float32)
    c = np.stack([rng.uniform(-20, W + 20, (b, k)),
                  rng.uniform(-20, H + 20, (b, k))], -1).astype(np.float32)
    c[:, :4] = [[0, 0], [W - 1, H - 1], [-50, H / 2], [W / 2, H + 50]]
    s = rng.uniform(1, 80, (b, k)).astype(np.float32)
    o = rng.uniform(0, 2 * np.pi, (b, k)).astype(np.float32)
    want = np.asarray(jax.jit(jhardnet.extract_laf_patches_batch)(
        imgs, c, s, o))[..., 0]
    got = hardnet.extract_laf_patches_batch(_t(imgs), _t(c), _t(s), _t(o))
    assert got.shape == (b, k, 1, 32, 32)
    np.testing.assert_allclose(got[:, :, 0].numpy(), want, atol=PATCH_TOL,
                               rtol=0)
    grid = np.asarray(jax.jit(lambda: jnp.linspace(-1.0, 1.0, 32))())
    np.testing.assert_array_equal(hardnet.sample_grid().numpy(), grid)
    one = hardnet.extract_laf_patches(_t(imgs[0]), _t(c[0]), _t(s[0]), _t(o[0]))
    np.testing.assert_array_equal(one.numpy(), got[0].numpy())
    # a tiny LAF at the far corner samples only the corner pixel
    corner = hardnet.extract_laf_patches(
        _t(imgs[0]), torch.tensor([[W + 5.0, H + 5.0]]), torch.tensor([1.0]),
        torch.tensor([0.3]))
    np.testing.assert_array_equal(corner.numpy(), imgs[0, -1, -1])


# --- the device extractor ---------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_pipeline():
    """The JAX package's DoGHardNetDevice and trained "doghardnet" matcher,
    and its match_pair on _pair()."""
    ext = jpipeline.DoGHardNetDevice(params=_jparams(), max_num_keypoints=K)
    m = jpipeline.LightGlue("doghardnet", params=NPZ)
    return ext, m, jpipeline.match_pair(ext, m, *_pair(), resize=None)


def _jax_features():
    """The JAX DoGHardNetDevice's forward on each image of _pair() at B 1
    (the program match_pair compiled)."""
    ext = _jax_pipeline()[0]
    sizes = jnp.asarray([[W, H]], jnp.float32)
    return [ext._jit_forward(ext.params, ext.conf,
                             jnp.asarray(x)[None, ..., None], sizes)
            for x in _pair()]


def _check_feats(got, want, valid):
    for k in ("keypoints", "keypoint_scores", "valid"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    for k in ("scales", "oris"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-5,
                                   rtol=0, err_msg=k)
    desc, wdesc = got["descriptors"], np.asarray(want["descriptors"])
    np.testing.assert_allclose(desc[valid], wdesc[valid], atol=DESC_TOL, rtol=0)
    assert (desc[~valid] == 0).all()


def _check_matches(got, want):
    for k in ("matches0", "matches1"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(np.asarray(got["matching_scores0"]),
                               np.asarray(want["matching_scores0"]), atol=1e-3)


def test_forward_matches_jax():
    """hardnet.forward on each image against the JAX package's (its
    DoGHardNetDevice forward at B 1): keypoints, scores and valid equal,
    scales and oris within 1e-5, descriptors within DESC_TOL on valid
    slots and 0 elsewhere; RGB input turns grey as sift_device does."""
    for x, want in zip(_pair(), _jax_features()):
        f = hardnet.forward(_params(), CONF, _t(x)[None, ..., None])
        got = {k: getattr(f, k)[0].numpy() for k in f._fields}
        v = got["valid"]
        assert 30 < v.sum() < K
        _check_feats(got, {k: np.asarray(getattr(want, k))[0]
                           for k in got}, v)
    a = _pair()[0]
    rgb = _t(np.stack([a, np.sqrt(a), a * a], -1)[None])
    f = hardnet.forward(_params(), CONF, rgb)
    g = hardnet.forward(_params(), CONF, hardnet.sift_device.to_gray(rgb))
    np.testing.assert_array_equal(f.descriptors.numpy(), g.descriptors.numpy())


def test_match_pair_matches_jax():
    """match_pair(DoGHardNetDevice, LightGlue("doghardnet", trained npz))
    against the JAX package's: features as above, matches equal, matching
    scores within 1e-3, the same stop; the trained matcher finds matches
    (on HardNet's seeded stand-in weights, synthetic.hardnet_params)."""
    _, _, (jf0, jf1, want) = _jax_pipeline()
    ext = DoGHardNetDevice(params=_params(), max_num_keypoints=K, device="cpu")
    m = LightGlue("doghardnet", params=NPZ, device="cpu")
    f0, f1, got = match_pair(ext, m, *_pair(), resize=None)
    _check_feats(f0, jf0, f0["valid"])
    _check_feats(f1, jf1, f1["valid"])
    _check_matches(got, want)
    assert got["stop"] == want["stop"]
    assert (got["matches0"] >= 0).sum() >= 20


def test_make_end_to_end_and_sequence():
    """make_end_to_end(hardnet.forward, "doghardnet") at B 2 on (a, b) and
    (b, a), each against the JAX package's forward and matcher on that
    pair: keypoints and valid equal, matches equal, scores within 1e-3.
    match_sequence(DoGHardNetDevice, window 1) on [a, b, a] equals
    make_end_to_end on each pair: features and matches."""
    _, jm, _ = _jax_pipeline()
    m = LightGlue("doghardnet", params=NPZ, device="cpu")
    a, b = _pair()
    sizes = np.array([[W, H]], np.float32)
    jfeats = _jax_features()

    def jax_pair(f0, f1):
        d = [{"keypoints": f.keypoints, "descriptors": f.descriptors,
              "valid": f.valid, "scales": f.scales, "oris": f.oris,
              "image_size": sizes} for f in (f0, f1)]
        return jm({"image0": d[0], "image1": d[1]})

    ext = DoGHardNetDevice(params=_params(), max_num_keypoints=K, device="cpu")
    run = end_to_end.make_end_to_end(hardnet.forward, ext.params, ext.conf,
                                     m.params, m.conf)
    size = _t(np.repeat(sizes, 2, 0))
    got = run(_t(np.stack([a, b]))[..., None], _t(np.stack([b, a]))[..., None],
              size, size)
    for i, (p, q) in enumerate(((0, 1), (1, 0))):
        want = jax_pair(jfeats[p], jfeats[q])
        for s, j in (("feats0", p), ("feats1", q)):
            for f in ("keypoints", "valid"):
                np.testing.assert_array_equal(
                    getattr(getattr(got, s), f)[i].numpy(),
                    np.asarray(getattr(jfeats[j], f))[0], err_msg=f)
        mine = {"matches0": got.matches.matches0[i].numpy(),
                "matches1": got.matches.matches1[i].numpy(),
                "matching_scores0": got.matches.matching_scores0[i].numpy()}
        _check_matches(mine, {k: np.asarray(want[k])[0] for k in
                              ("matches0", "matches1", "matching_scores0")})

    feats, pairs = match_sequence(ext, m, np.stack([a, b, a]), window=1)
    assert feats["scales"].shape == (3, K) and feats["oris"].shape == (3, K)
    for i in range(2):  # pair (i, i + 1): (a, b) then (b, a)
        for f in ("keypoints", "descriptors", "valid"):
            np.testing.assert_array_equal(feats[f][i],
                                          getattr(got.feats0, f)[i].numpy())
        np.testing.assert_array_equal(pairs["matches0"][i],
                                      got.matches.matches0[i].numpy())


def test_wrappers_need_cuda_and_refuse_downloads():
    """DoGHardNetDevice and DoGHardNet default to CUDA and raise without
    it; pretrained=True raises naming the converter; a config naming
    another backend is refused; DoGHardNet(backend="device") is
    DoGHardNetDevice's extraction."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            DoGHardNetDevice()
        with pytest.raises(RuntimeError, match="CUDA"):
            DoGHardNet()
    with pytest.raises(FileNotFoundError, match="hardnet_from_state_dict"):
        DoGHardNetDevice(pretrained=True, device="cpu")
    with pytest.raises(FileNotFoundError, match="from_state_dict"):
        LightGlue("doghardnet", pretrained=True, device="cpu")
    with pytest.raises(ValueError, match="'device'"):
        DoGHardNetDevice(conf=configs.SIFTConfig(), device="cpu")
    a = _pair()[0]
    kw = dict(params=_params(), max_num_keypoints=K, device="cpu")
    got = DoGHardNet(backend="device", **kw).extract(a, resize=None)
    want = DoGHardNetDevice(**kw).extract(a, resize=None)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# --- the host wrapper -------------------------------------------------------------


@pytest.mark.parametrize("uint8", [False, True])
def test_host_doghardnet_matches_jax(uint8):
    """DoGHardNet (OpenCV's detection on the host, HardNet on the CPU)
    against the JAX package's DoGHardNet: the OpenCV detections equal
    (keypoints, scores, scales, oris, valid, image size), the descriptors
    within DESC_TOL on valid slots and 0 on the padding, no RootSIFT
    (unit rows); an image without keypoints gives none."""
    img = image_pair(np.random.default_rng(1), H, W)[0]
    if uint8:
        img = (img * 255).astype(np.uint8)
    kw = dict(max_num_keypoints=K, resize=None)
    got = DoGHardNet(params=_params(), device="cpu", **kw).extract(img)
    want = jpipeline.DoGHardNet(params=_jparams(), **kw).extract(img)
    assert set(got) == set(want)
    v = got["valid"][0]
    assert 20 < v.sum()
    for k in want:
        if k != "descriptors":
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    d = got["descriptors"][0]
    np.testing.assert_allclose(d[v], np.asarray(want["descriptors"])[0][v],
                               atol=DESC_TOL, rtol=0)
    assert (d[~v] == 0).all()
    np.testing.assert_allclose(np.linalg.norm(d[v], axis=-1), 1.0, atol=1e-5)
    if not uint8:
        flat = DoGHardNet(params=_params(), device="cpu", **kw).extract(
            np.full((H, W), 0.5, np.float32))
        assert flat["descriptors"].shape == (1, K, 128)
        assert not flat["valid"].any() and (flat["descriptors"] == 0).all()


# --- the kornia state dict ----------------------------------------------------------


def _kornia_dict(affine=False):
    """A seeded state dict in the fixture's layout (kornia's HardNet:
    batch norms without affine parameters), with num_batches_tracked."""
    with open(FIXTURE) as f:
        keys = json.load(f)["keys"]
    rng = np.random.default_rng(6)
    sd = {}
    for k, shape in keys.items():
        a = rng.standard_normal(shape).astype(np.float32) * 0.2
        sd[k] = np.abs(a) + 0.5 if k.endswith("running_var") else a
        if k.endswith("running_mean"):
            pre = k[: -len("running_mean")]
            sd[pre + "num_batches_tracked"] = np.array(7)
            if affine:
                sd[pre + "weight"] = rng.random(shape).astype(np.float32) + 0.5
                sd[pre + "bias"] = rng.standard_normal(shape).astype(np.float32)
    return sd


@pytest.mark.parametrize("affine", [False, True])
def test_state_dict_round_trip_matches_convert_hardnet(affine):
    """hardnet_from_state_dict against JAX convert_hardnet (HWIO -> OIHW,
    the batch norms' defaults where the dict has no affine parameters):
    equal to the bit; describe_patches on it against the JAX one within
    DESC_TOL; hardnet_to_state_dict gives back the dict (the fixture's
    keys for kornia's layout) and hardnet_from_jax_params the same tree."""
    sd = _kornia_dict(affine)
    tree = weights.hardnet_from_state_dict(sd)
    jp = jweights.convert_hardnet(sd)
    jflat = jweights.flatten_tree(jp)
    back = weights.flatten_params(tree)
    assert set(back) == set(jflat)
    for k, v in jflat.items():
        v = np.asarray(v)
        np.testing.assert_array_equal(back[k], v.transpose(3, 2, 0, 1)
                                      if v.ndim == 4 else v, err_msg=k)
    from_jax = weights.flatten_params(weights.hardnet_from_jax_params(jflat))
    for k in back:
        np.testing.assert_array_equal(from_jax[k], back[k], err_msg=k)
    patches = np.random.default_rng(7).random((6, 32, 32, 1), dtype=np.float32)
    want = np.asarray(jax.jit(jhardnet.describe_patches)(jp, patches))
    got = hardnet.describe_patches(tree, _t(patches).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), want, atol=DESC_TOL, rtol=0)
    out = weights.hardnet_to_state_dict(tree)
    want_keys = {k for k in sd if not k.endswith("num_batches_tracked")}
    assert set(out) == want_keys
    for k in out:
        np.testing.assert_array_equal(out[k], sd[k], err_msg=k)


def test_state_dict_rejections_match_convert_hardnet():
    """The bad dicts JAX convert_hardnet refuses (strict, its default), the
    port refuses too: an extra conv (eight convs), a batch norm without its
    statistics (six batch norms), a leftover tensor, a wrong shape; a
    missing or unexpected key of the JAX flat dict raises."""
    sd = _kornia_dict()
    bad = [{**sd, "features.99.weight": np.zeros((4, 4, 3, 3), np.float32)},
           {k: v for k, v in sd.items() if "features.1.running" not in k},
           {**sd, "features.5.extra": np.zeros(3, np.float32)},
           {**sd, "features.3.weight": np.zeros((32, 32, 5, 5), np.float32)}]
    for d in bad:
        with pytest.raises(ValueError):
            jweights.convert_hardnet(d)
        with pytest.raises(ValueError):
            weights.hardnet_from_state_dict(d)
    with pytest.raises(KeyError, match="unexpected"):
        weights.hardnet_from_jax_params({**_flat(), "conv7/w": np.zeros(1)})
