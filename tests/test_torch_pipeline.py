"""lightglue_tpu_torch.pipeline: padding buckets, host-side compaction, the
JAX pipeline's outputs on the same request, and import isolation."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lightglue_tpu import pipeline as jpipeline
from lightglue_tpu import weights as jweights
from lightglue_tpu_torch import LightGlue, compact_matches, rbd
from lightglue_tpu_torch.synthetic import planted_pairs

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "weights", "synthetic_superpoint_lightglue.npz")


def _request(pairs, valid0=None):
    d0 = {"keypoints": pairs["keypoints0"], "descriptors": pairs["descriptors0"],
          "image_size": pairs["image_size"]}
    if valid0 is not None:
        d0["valid"] = valid0
    d1 = {"keypoints": pairs["keypoints1"], "descriptors": pairs["descriptors1"],
          "image_size": pairs["image_size"]}
    return {"image0": d0, "image1": d1}


@pytest.fixture(scope="module")
def matcher():
    return LightGlue("superpoint", params=NPZ, pruning_min_kpts=32,
                     device="cpu", fused_self=False, fused_cross=False)


@pytest.mark.parametrize("valid", [False, True])
def test_buckets_match_the_unpadded_call(matcher, valid):
    pairs = planted_pairs(np.random.default_rng(0), 1, 100, 120)
    valid0 = None
    if valid:
        valid0 = np.ones((1, 100), bool)
        valid0[0, 90:] = False
    req = _request(pairs, valid0)
    plain = matcher(req)
    bucketed = LightGlue("superpoint", params=matcher.params,
                         pruning_min_kpts=32, device="cpu", fused_self=False,
                         fused_cross=False).compile((128, 256))(req)
    for k in ("matches0", "matches1", "prune0", "prune1"):
        np.testing.assert_array_equal(bucketed[k], plain[k], err_msg=k)
        assert bucketed[k].shape == plain[k].shape
    assert bucketed["stop"] == plain["stop"]
    for k in ("matching_scores0", "matching_scores1"):
        np.testing.assert_allclose(bucketed[k], plain[k], atol=1e-5, rtol=0)
    assert len(plain["matches"][0]) > 20
    if valid:
        assert (plain["matches0"][0, 90:] == -1).all()


def test_same_request_as_the_jax_pipeline(matcher):
    pairs = planted_pairs(np.random.default_rng(1), 2, 96)
    req = _request(pairs)
    got = matcher(req)
    jm = jpipeline.LightGlue(
        "superpoint", params=jweights.load_params(NPZ, dtype=np.float32),
        pruning_min_kpts=32, fused_self=False, fused_cross=False)
    want = jm(req)
    for k in ("matches0", "matches1", "prune0", "prune1"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert got["stop"] == want["stop"]
    np.testing.assert_allclose(got["matching_scores0"],
                               np.asarray(want["matching_scores0"]),
                               atol=1e-4, rtol=0)
    for g, w in zip(got["matches"], want["matches"]):
        np.testing.assert_array_equal(g, w)


def test_compact_matches():
    m0 = np.array([[2, -1, 0, -1], [-1, -1, -1, -1]], np.int32)
    s0 = np.array([[0.9, 0.0, 0.5, 0.0], [0.0] * 4], np.float32)
    pairs, scores = compact_matches(m0, s0)
    np.testing.assert_array_equal(pairs[0], [[0, 2], [2, 0]])
    np.testing.assert_array_equal(scores[0], np.float32([0.9, 0.5]))
    assert pairs[1].shape == (0, 2) and pairs[1].dtype == np.int32
    assert scores[1].shape == (0,)


def test_rbd():
    out = rbd({"a": np.zeros((1, 3)), "b": [np.ones(2)], "stop": 4})
    assert out["a"].shape == (3,) and out["b"].shape == (2,) and out["stop"] == 4


def test_missing_image_raises(matcher):
    with pytest.raises(KeyError, match="image1"):
        matcher({"image0": {}})


def test_import_leaves_jax_out():
    """Every module of the port imports with JAX, OpenCV and PIL blocked."""
    code = ("import sys; sys.modules['cv2'] = None; sys.modules['PIL'] = None; "
            "sys.modules['jax'] = None; "
            "import lightglue_tpu_torch, lightglue_tpu_torch.pipeline, "
            "lightglue_tpu_torch.end_to_end, lightglue_tpu_torch.utils.image, "
            "lightglue_tpu_torch.models.superpoint, "
            "lightglue_tpu_torch.ops.sampling, lightglue_tpu_torch.ops.nms, "
            "lightglue_tpu_torch.ops.stem, lightglue_tpu_torch.ops.stem2, "
            "lightglue_tpu_torch.ops.flash_self, "
            "lightglue_tpu_torch.ops.flash_cross, "
            "lightglue_tpu_torch.ops.assignment_fused, "
            "lightglue_tpu_torch.ops.block_tc, "
            "lightglue_tpu_torch.ops.flash_cross_block, "
            "lightglue_tpu_torch.models.aliked, "
            "lightglue_tpu_torch.ops.aliked_stem, "
            "lightglue_tpu_torch.ops.score_head, "
            "lightglue_tpu_torch.ops.deform, "
            "lightglue_tpu_torch.ops.gather, "
            "lightglue_tpu_torch.scripts.micro_gather2, "
            "lightglue_tpu_torch.scripts.attn_split, "
            "lightglue_tpu_torch.scripts.assign_study, "
            "lightglue_tpu_torch.scripts.host_latency, "
            "lightglue_tpu_torch.scripts.walk_sums, "
            "lightglue_tpu_torch.scripts.conv_study, "
            "lightglue_tpu_torch.ops.ffn, "
            "lightglue_tpu_torch.scripts.ffn_times, "
            "lightglue_tpu_torch.scripts.cpu_repeat, "
            "lightglue_tpu_torch.synthetic; "
            "bad = [m for m, mod in sys.modules.items() if mod is not None "
            "and m.split('.')[0] in ('jax', 'lightglue_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
