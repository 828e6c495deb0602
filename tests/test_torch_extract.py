"""lightglue_tpu_torch extraction surface against lightglue_tpu on the CPU:
image preprocessing against OpenCV, ``SuperPoint.extract``, ``match_pair``
and ``make_end_to_end`` against the JAX pipeline on the same images and
weights (the JAX matcher in the composed block configuration, as the port
runs it), and the main path without OpenCV or PIL.

Tolerances: resizing within 1e-5 of cv2 on [0, 1] images (different
summation order); keypoints, ``valid``, matches, ``stop`` and prune depths
exactly equal; scores and descriptors within 1e-5 (matching scores 1e-4,
as tests/test_torch_pipeline.py holds them).
"""

import os
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu import configs as jconfigs
from lightglue_tpu import end_to_end as jend_to_end
from lightglue_tpu import pipeline as jpipeline
from lightglue_tpu import weights as jweights
from lightglue_tpu.models import superpoint as jsp
from lightglue_tpu_torch import LightGlue, SuperPoint, configs, match_pair
from lightglue_tpu_torch import end_to_end, pipeline, weights
from lightglue_tpu_torch.models import lightglue as lg
from lightglue_tpu_torch.models import superpoint as sp
from lightglue_tpu_torch.synthetic import image_pair
from lightglue_tpu_torch.utils import image as image_utils

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "weights", "synthetic_superpoint_lightglue.npz")
K = 256  # keypoints per image
MATCHER = dict(pruning_min_kpts=32)  # small enough that pruning runs


def _no_network(url, timeout=None):
    raise weights.urllib.error.URLError(f"{url}: offline")



@pytest.fixture(scope="module")
def sp_flat():
    """The JAX package's init (key 0), conv weights times 3 (see
    test_torch_superpoint)."""
    flat = jweights.flatten_tree(jsp.init_params(jax.random.key(0)))
    return {k: np.asarray(v) * (3.0 if k.endswith("/w") else 1.0)
            for k, v in flat.items()}


@pytest.fixture(scope="module")
def extractors(sp_flat):
    jext = jpipeline.SuperPoint(params=jweights.unflatten_tree(sp_flat),
                                max_num_keypoints=K)
    ext = SuperPoint(params=weights.superpoint_from_jax_params(sp_flat),
                     max_num_keypoints=K, device="cpu")
    return jext, ext


@pytest.fixture(scope="module")
def matchers():
    jm = jpipeline.LightGlue(
        "superpoint", params=jweights.load_params(NPZ, dtype=np.float32),
        fused_self=False, fused_cross=False, **MATCHER)
    return jm, LightGlue("superpoint", params=NPZ, device="cpu",
                         fused_self=False, fused_cross=False, **MATCHER)


@pytest.fixture(scope="module")
def pair():
    img0, img1, hom = image_pair(np.random.default_rng(0), 96, 128)
    return img0[..., None], img1[..., None], hom


# --- preprocessing -----------------------------------------------------------


@pytest.mark.parametrize("interp,src,dst", [
    ("area", (150, 200), (96, 128)),    # factor 0.64 on both axes
    ("area", (75, 113), (40, 60)),      # unequal non-integer factors
    ("area", (64, 96), (32, 48)),       # integer factor 2
    ("linear", (75, 113), (40, 60)),
    ("linear", (40, 60), (75, 113)),
])
def test_resize_matches_cv2(interp, src, dst):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (*src, 3)).astype(np.float32)
    flag = {"area": cv2.INTER_AREA, "linear": cv2.INTER_LINEAR}[interp]
    want = cv2.resize(img, dst[::-1], interpolation=flag)
    got, scale = image_utils.resize_image(img, dst, interp=interp)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert scale == (dst[1] / src[1], dst[0] / src[0])
    gray, _ = image_utils.resize_image(img[..., 0], dst, interp=interp)
    np.testing.assert_allclose(gray.numpy(), want[..., 0], atol=1e-5, rtol=0)


def test_preprocessor_and_padding_match_jax():
    from lightglue_tpu.utils import image as jimage

    rng = np.random.default_rng(2)
    img = rng.uniform(0, 1, (90, 130, 1)).astype(np.float32)
    for conf in (configs.PreprocessConfig(resize=100),
                 configs.PreprocessConfig(resize=64, side="short"),
                 configs.PreprocessConfig(resize=200),
                 configs.PreprocessConfig(resize=100, antialias=False)):
        got, gs = image_utils.ImagePreprocessor(conf)(torch.from_numpy(img))
        want, ws = jimage.ImagePreprocessor(
            jconfigs.PreprocessConfig(**vars(conf)))(img)
        want = want if want.ndim == 3 else want[..., None]
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    padded, hw = image_utils.pad_to_multiple(torch.from_numpy(img), 8)
    jpadded, jhw = jimage.pad_to_multiple(img, 8)
    assert hw == jhw
    np.testing.assert_array_equal(padded.numpy(), jpadded)
    u8 = rng.integers(0, 256, (5, 7, 3), dtype=np.uint8)
    np.testing.assert_array_equal(image_utils.numpy_image_to_array(u8).numpy(),
                                  jimage.numpy_image_to_array(u8))


def test_auto_kpts_bucket_matches_jax():
    for h, w in ((64, 80), (768, 1024), (3000, 4000)):
        for conf, jconf in ((configs.SuperPointConfig(), jconfigs.SuperPointConfig()),
                            (configs.SuperPointConfig(nms_radius=1),
                             jconfigs.SuperPointConfig(nms_radius=1))):
            assert pipeline._auto_kpts_bucket(conf, h, w) == \
                jpipeline._auto_kpts_bucket(jconf, h, w)


# --- extraction and matching ---------------------------------------------------


def _same_feats(got, want):
    for k in ("keypoints", "valid", "image_size"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    for k in ("keypoint_scores", "descriptors"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-5,
                                   rtol=0, err_msg=k)


def test_extract_matches_jax(extractors, pair):
    jext, ext = extractors
    img0 = pair[0]
    got = ext.extract(img0, resize=None)
    _same_feats(got, jext.extract(img0, resize=None))
    assert got["keypoints"].shape == (1, K, 2) and got["valid"].sum() > 100
    # a uint8 image that needs padding (90 x 126 -> 96 x 128)
    u8 = (img0[:90, :126, 0] * 255).astype(np.uint8)
    got = ext.extract(u8, resize=None)
    _same_feats(got, jext.extract(u8, resize=None))
    np.testing.assert_array_equal(got["image_size"], [[126, 90]])


def test_extract_batch_matches_jax(extractors, pair):
    jext, ext = extractors
    imgs = np.stack([pair[0][:92], pair[1][:92]])  # padded to 96 rows
    _same_feats(ext.extract_batch(imgs), jext.extract_batch(imgs))


def test_match_pair_matches_jax(extractors, matchers, pair):
    jext, ext = extractors
    jm, m = matchers
    img0, img1, _ = pair
    f0, f1, got = match_pair(ext, m, img0, img1, resize=None)
    jf0, jf1, want = jpipeline.match_pair(jext, jm, img0, img1, resize=None)
    _same_feats(f0, jf0)
    _same_feats(f1, jf1)
    for k in ("matches0", "matches1", "prune0", "prune1"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert got["stop"] == want["stop"]
    np.testing.assert_allclose(got["matching_scores0"],
                               np.asarray(want["matching_scores0"]),
                               atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got["matches"], np.asarray(want["matches"]))
    assert len(got["matches"]) > 0


def test_make_end_to_end_matches_jax(sp_flat, pair):
    """Both images of a batch of 2 extracted and matched in one call,
    without a host copy in between."""
    img0, img1, _ = pair
    im0 = np.stack([img0, img1])
    im1 = np.stack([img1, img0[::-1].copy()])
    sizes = np.array([[128, 96], [120, 88]], np.float32)
    conf = configs.SuperPointConfig(max_num_keypoints=K)
    jconf = jconfigs.SuperPointConfig(max_num_keypoints=K)
    mconf = configs.lightglue_config("superpoint", fused_self=False,
                                     fused_cross=False, **MATCHER)
    jmconf = jconfigs.lightglue_config("superpoint", fused_self=False,
                                       fused_cross=False, **MATCHER)
    run = end_to_end.make_end_to_end(
        sp.forward, weights.superpoint_from_jax_params(sp_flat), conf,
        weights.load_params(NPZ, mconf), mconf)
    jrun = jend_to_end.make_end_to_end(
        jsp.forward, jweights.unflatten_tree(sp_flat), jconf,
        jweights.load_params(NPZ, dtype=np.float32), jmconf)
    got = run(*map(torch.from_numpy, (im0, im1, sizes, sizes)))
    want = jrun(*map(jnp.asarray, (im0, im1, sizes, sizes)))
    for gf, wf in ((got.feats0, want.feats0), (got.feats1, want.feats1)):
        np.testing.assert_array_equal(gf.keypoints.numpy(), np.asarray(wf.keypoints))
        np.testing.assert_array_equal(gf.valid.numpy(), np.asarray(wf.valid))
        np.testing.assert_allclose(gf.descriptors.numpy(),
                                   np.asarray(wf.descriptors), atol=1e-5, rtol=0)
    for k in ("matches0", "matches1", "prune0", "prune1"):
        np.testing.assert_array_equal(getattr(got.matches, k).numpy(),
                                      np.asarray(getattr(want.matches, k)),
                                      err_msg=k)
    assert int(got.matches.stop) == int(want.matches.stop)
    assert (got.matches.matches0.numpy() >= 0).sum() > 0
    assert isinstance(got.matches, lg.MatchOutput)


def test_pretrained_raises_and_npz_params(sp_flat, tmp_path, monkeypatch):
    # offline: pretrained=True resolves through weights.fetch and raises
    monkeypatch.setattr(weights, "default_cache_dir", lambda: tmp_path / "cache")
    monkeypatch.setattr(weights.urllib.request, "urlopen", _no_network)
    with pytest.raises(weights.WeightsUnavailableError, match="superpoint_v1.pth"):
        SuperPoint(pretrained=True, device="cpu")
    path = str(tmp_path / "sp.npz")
    np.savez(path, **sp_flat)
    ext = SuperPoint(params=path, device="cpu")
    want = weights.superpoint_from_jax_params(sp_flat)
    for name in want:
        assert torch.equal(ext.params[name]["w"], want[name]["w"])
    assert SuperPoint(seed=1, device="cpu").params["conv1a"]["w"].shape == (
        64, 1, 3, 3)


def test_main_path_without_opencv_or_pil():
    """With cv2 and PIL unimportable, extraction (with a resize) and
    matching still run, and nothing of JAX is imported; reading a file
    says what it needs."""
    code = """
import sys
sys.modules["cv2"] = None
sys.modules["PIL"] = None
import numpy as np, torch
torch.set_num_threads(1)
from lightglue_tpu_torch import LightGlue, SuperPoint, match_pair
from lightglue_tpu_torch.models import superpoint as sp
from lightglue_tpu_torch.synthetic import image_pair
from lightglue_tpu_torch.utils.image import read_image
img0, img1, _ = image_pair(np.random.default_rng(0), 60, 80)
params = {n: {"w": p["w"] * 3.0, "b": p["b"]}
          for n, p in sp.init_params().items()}
ext = SuperPoint(params=params, max_num_keypoints=64, resize=48, device="cpu")
f0, f1, m = match_pair(ext, LightGlue("superpoint", n_layers=2, device="cpu"),
                       img0, img1)
assert f0["keypoints"].shape == (64, 2), f0["keypoints"].shape
assert f0["image_size"].tolist() == [80.0, 60.0]
assert m["matches0"].shape == (64,)
try:
    read_image("lightglue_tpu_torch/__init__.py")
except ImportError as e:
    assert "cv2" in str(e)
else:
    raise AssertionError("read_image decoded without cv2 or PIL")
bad = [k for k in sys.modules if k.split(".")[0] in ("jax", "lightglue_tpu")]
assert not bad, bad
"""
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=300)
