"""The port's sequence matching (``end_to_end.make_sequence_end_to_end``,
``make_windowed_sequence_end_to_end``, ``sequence_window_pairs`` and
``pipeline.match_sequence``) against the JAX package's on the CPU, at the
sizes of tests/test_end_to_end.py (SuperPoint on 64 x 80 images, 64
keypoints), with the trained matcher; and each pair against the port's
``make_end_to_end`` on that pair.

SuperPoint's weights are the JAX init (key 0) with the conv weights times 3
(see tests/test_torch_extract.py); the matcher is fixed with threshold 0
(every mutual pair kept), in the composed block configuration, as the
port's tests run the JAX matcher. Keypoints, ``valid``, matches and
``stop`` exactly equal; descriptors within 1e-5 and matching scores within
1e-4, as tests/test_torch_extract.py holds them; keypoint scores within
2e-5: on these uniform-noise images the scaled weights push the scores to
0.999, where XLA's and oneDNN's conv sums put them up to 1.1e-5 apart
(four seeds), one step past test_torch_extract's 1e-5.
"""

import os

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
from lightglue_tpu_torch import LightGlue, SuperPoint, configs, match_sequence
from lightglue_tpu_torch import end_to_end, weights
from lightglue_tpu_torch.models import superpoint as sp

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "weights", "synthetic_superpoint_lightglue.npz")
K = 64
H, W = 64, 80
MATCHER = dict(depth_confidence=-1.0, width_confidence=-1.0,
               filter_threshold=0.0, fused_self=False, fused_cross=False)


@pytest.fixture(scope="module")
def sp_flat():
    flat = jweights.flatten_tree(jsp.init_params(jax.random.key(0)))
    return {k: np.asarray(v) * (3.0 if k.endswith("/w") else 1.0)
            for k, v in flat.items()}


@pytest.fixture(scope="module")
def programs(sp_flat):
    """(make_*) -> (port program, JAX program) constructors and the port's
    pairwise program."""
    conf = configs.SuperPointConfig(max_num_keypoints=K)
    jconf = jconfigs.SuperPointConfig(max_num_keypoints=K)
    mconf = configs.lightglue_config("superpoint", **MATCHER)
    jmconf = jconfigs.lightglue_config("superpoint", **MATCHER)
    args = (sp.forward, weights.superpoint_from_jax_params(sp_flat), conf,
            weights.load_params(NPZ, mconf), mconf)
    jargs = (jsp.forward, jweights.unflatten_tree(sp_flat), jconf,
             jweights.load_params(NPZ, dtype=np.float32), jmconf)

    def build(name, **kw):
        return (getattr(end_to_end, name)(*args, **kw),
                getattr(jend_to_end, name)(*jargs, **kw))

    return build, end_to_end.make_end_to_end(*args)


def _images(b, seed=0, h=H, w=W):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (b, h, w, 1)).astype(np.float32)


def _same_output(got, want):
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
    for k in ("matching_scores0", "matching_scores1"):
        np.testing.assert_allclose(getattr(got.matches, k).numpy(),
                                   np.asarray(getattr(want.matches, k)),
                                   atol=1e-4, rtol=0, err_msg=k)


def _same_as_pairwise(out, pair, imgs, sizes, i0, i1):
    """Each pair of a sequence output equal to make_end_to_end on it."""
    for p, (a, c) in enumerate(zip(i0, i1)):
        ref = pair(imgs[a:a + 1], imgs[c:c + 1], sizes[a:a + 1], sizes[c:c + 1])
        np.testing.assert_array_equal(out.feats0.keypoints[p].numpy(),
                                      ref.feats0.keypoints[0].numpy())
        np.testing.assert_array_equal(out.feats1.keypoints[p].numpy(),
                                      ref.feats1.keypoints[0].numpy())
        for k in ("matches0", "matches1"):
            np.testing.assert_array_equal(getattr(out.matches, k)[p].numpy(),
                                          getattr(ref.matches, k)[0].numpy())
        np.testing.assert_allclose(out.matches.matching_scores0[p].numpy(),
                                   ref.matches.matching_scores0[0].numpy(),
                                   atol=1e-4, rtol=0)


@pytest.mark.parametrize("n,window", [(2, 1), (4, 1), (4, 2), (5, 3), (6, 4),
                                      (3, 5), (8, 4)])
def test_sequence_window_pairs_matches_jax(n, window):
    got = end_to_end.sequence_window_pairs(n, window)
    want = jend_to_end.sequence_window_pairs(n, window)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_consecutive_sequence_matches_jax(programs):
    build, pair = programs
    run, jrun = build("make_sequence_end_to_end")
    imgs = _images(3)
    sizes = np.tile([[float(W), float(H)]], (3, 1)).astype(np.float32)
    got = run(torch.from_numpy(imgs), torch.from_numpy(sizes))
    _same_output(got, jrun(jnp.asarray(imgs), jnp.asarray(sizes)))
    assert got.matches.matches0.shape == (2, K)
    assert (got.matches.matches0 >= 0).sum() > 20
    _same_as_pairwise(got, pair, torch.from_numpy(imgs),
                      torch.from_numpy(sizes), [0, 1], [1, 2])


def test_windowed_sequence_matches_jax(programs):
    build, pair = programs
    run, jrun = build("make_windowed_sequence_end_to_end", window=2)
    imgs = _images(4, seed=1)
    sizes = np.tile([[float(W), float(H)]], (4, 1)).astype(np.float32)
    got = run(torch.from_numpy(imgs), torch.from_numpy(sizes))
    _same_output(got, jrun(jnp.asarray(imgs), jnp.asarray(sizes)))
    i0, i1 = end_to_end.sequence_window_pairs(4, 2)
    np.testing.assert_array_equal(i0, [0, 1, 2, 0, 1])
    np.testing.assert_array_equal(i1, [1, 2, 3, 2, 3])
    assert got.matches.matches0.shape == (5, K)
    _same_as_pairwise(got, pair, torch.from_numpy(imgs),
                      torch.from_numpy(sizes), i0, i1)


@pytest.fixture(scope="module")
def wrappers(sp_flat):
    jext = jpipeline.SuperPoint(params=jweights.unflatten_tree(sp_flat),
                                max_num_keypoints=K)
    ext = SuperPoint(params=weights.superpoint_from_jax_params(sp_flat),
                     max_num_keypoints=K, device="cpu")
    jm = jpipeline.LightGlue(
        "superpoint", params=jweights.load_params(NPZ, dtype=np.float32),
        **MATCHER)
    m = LightGlue("superpoint", params=NPZ, device="cpu", **MATCHER)
    return (ext, m), (jext, jm)


@pytest.mark.parametrize("window,uint8", [(2, False), (1, True)])
def test_match_sequence_matches_jax(wrappers, window, uint8):
    """feats and pairs of pipeline.match_sequence against the JAX one; the
    uint8 case needs padding to the stride (60 x 78 -> 64 x 80)."""
    (ext, m), (jext, jm) = wrappers
    imgs = _images(4, seed=2)
    if uint8:
        imgs = (imgs[:, :60, :78, 0] * 255).astype(np.uint8)
    feats, pairs = match_sequence(ext, m, imgs, window=window)
    jfeats, jpairs = jpipeline.match_sequence(jext, jm, imgs, window=window)
    assert sorted(feats) == sorted(jfeats)
    for k in ("keypoints", "valid", "image_size"):
        np.testing.assert_array_equal(feats[k], np.asarray(jfeats[k]), err_msg=k)
    for k, tol in (("keypoint_scores", 2e-5), ("descriptors", 1e-5)):
        np.testing.assert_allclose(feats[k], np.asarray(jfeats[k]), atol=tol,
                                   rtol=0, err_msg=k)
    assert sorted(pairs) == sorted(jpairs)
    for k in ("i0", "i1", "matches0"):
        np.testing.assert_array_equal(pairs[k], np.asarray(jpairs[k]), err_msg=k)
    np.testing.assert_allclose(pairs["matching_scores0"],
                               np.asarray(jpairs["matching_scores0"]),
                               atol=1e-4, rtol=0)
    assert pairs["stop"] == jpairs["stop"]
    for g, w in zip(pairs["matches"], jpairs["matches"]):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert sum(len(x) for x in pairs["matches"]) > 20
    # per-image features are the extractor's own, and a second call reuses
    # the cached program
    ref = ext.extract_batch(imgs.astype(np.float32) / 255.0 if uint8 else imgs)
    np.testing.assert_array_equal(feats["keypoints"], ref["keypoints"])
    cached = dict(m._seq_programs)
    _, again = match_sequence(ext, m, imgs, window=window)
    np.testing.assert_array_equal(again["matches0"], pairs["matches0"])
    assert m._seq_programs == cached


def test_match_sequence_needs_two_images(wrappers):
    (ext, m), _ = wrappers
    with pytest.raises(ValueError, match="at least 2"):
        match_sequence(ext, m, _images(1))
