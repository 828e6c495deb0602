"""The port's matcher (lightglue_tpu_torch.models.lightglue) against the JAX
matcher on the CPU, on the same seeded numpy inputs and the same weights.

Match indices, ``stop``, ``prune0`` and ``prune1`` exactly equal; matching
scores within 1e-4.
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
from lightglue_tpu_torch import configs, weights
from lightglue_tpu_torch.models import lightglue as lg
from lightglue_tpu_torch.synthetic import planted_pairs

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "weights", "synthetic_superpoint_lightglue.npz")
SMALL = dict(n_layers=3, input_dim=128, descriptor_dim=128, num_heads=2)
_jit_forward = jax.jit(jlg.forward, static_argnames=("conf",))


def _inputs(pairs, masked):
    args = dict(kpts0=pairs["keypoints0"], kpts1=pairs["keypoints1"],
                desc0=pairs["descriptors0"], desc1=pairs["descriptors1"],
                size0=pairs["image_size"], size1=pairs["image_size"])
    if masked:
        b, m = pairs["keypoints0"].shape[:2]
        n = pairs["keypoints1"].shape[1]
        mask0 = np.ones((b, m), bool)
        mask1 = np.ones((b, n), bool)
        mask0[0, m - 9:] = False  # padded tails
        mask1[-1, n - 13:] = False
        mask1[0, ::7] = False  # scattered invalid slots
        args.update(mask0=mask0, mask1=mask1)
    return args


def _compare(jparams, jconf, params, conf, args):
    want = _jit_forward(jparams, jconf, **{k: jnp.asarray(v) for k, v in args.items()})
    got = lg.forward(params, conf, **{k: torch.as_tensor(v) for k, v in args.items()})
    for f in ("matches0", "matches1", "prune0", "prune1"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert got.stop == int(want.stop)
    for f in ("matching_scores0", "matching_scores1"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), atol=1e-4,
                                   rtol=0, err_msg=f)
    return got


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("mode", ["fixed", "adaptive", "composed"])
def test_small_config_random_weights(mode, masked):
    """3 layers, 128-d, 2 heads of 64; JAX random params converted. A zero
    threshold keeps every mutual pair, so random weights still match."""
    over = dict(SMALL, filter_threshold=0.0, pruning_min_kpts=16)
    if mode != "adaptive":
        over.update(depth_confidence=-1.0, width_confidence=-1.0)
    jconf = jconfigs.lightglue_config("superpoint", **over, fused_self=False,
                                      fused_cross=False)
    conf = configs.lightglue_config("superpoint", **over, fused_self=False,
                                    fused_cross=False)
    if mode == "composed":  # the debug switches to the composed ops
        conf = conf.replace(flash=False, fused_ffn=False)
    jparams = jlg.init_params(jax.random.key(0), jconf)
    params = weights.from_jax_params(jweights.flatten_tree(jparams), conf)
    pairs = planted_pairs(np.random.default_rng(0), 2, 48, 56, desc_dim=128)
    got = _compare(jparams, jconf, params, conf, _inputs(pairs, masked))
    assert (got.matches0.numpy() >= 0).sum() > 10


@pytest.fixture(scope="module")
def trained():
    jparams = jweights.load_params(NPZ, dtype=np.float32)
    return jparams, weights.load_params(NPZ)


ADAPTIVE_MODES = {
    "fixed": dict(depth_confidence=-1.0, width_confidence=-1.0),
    "adaptive": {},
    "prune_only": dict(depth_confidence=-1.0),
    "exit_only": dict(width_confidence=-1.0),
}


@pytest.mark.parametrize("mode", list(ADAPTIVE_MODES))
def test_full_width_trained_weights(trained, mode):
    """The trained npz (9 layers, 256-d, 4 x 64) on planted pairs, B 2,
    N 128; pruning_min_kpts 32 so width pruning engages at this size."""
    over = dict(pruning_min_kpts=32, **ADAPTIVE_MODES[mode])
    jconf = jconfigs.lightglue_config("superpoint", **over, fused_self=False,
                                      fused_cross=False)
    conf = configs.lightglue_config("superpoint", **over, fused_self=False,
                                    fused_cross=False)
    jparams, params = trained
    pairs = planted_pairs(np.random.default_rng(3), 2, 128)
    got = _compare(jparams, jconf, params, conf,
                   _inputs(pairs, masked=mode != "fixed"))
    m0 = got.matches0.numpy()
    gt = pairs["gt_matches0"]
    # the trained weights find the planted pairs (a sanity floor, not a
    # quality measure)
    assert ((m0 == gt) & (m0 >= 0)).sum() >= 0.8 * (m0 >= 0).sum() > 20
    # the adaptive code really ran
    if mode in ("adaptive", "exit_only"):
        assert got.stop < 9
    if mode in ("adaptive", "prune_only"):
        assert (got.prune0.numpy() < got.stop).any()


@pytest.mark.parametrize("which", ["img0", "img1", "both"])
@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_side_without_valid_keypoints(which, mode):
    """All-invalid masks (the JAX package's zero-keypoint path): no NaN,
    no matches, zero scores, and the same outputs as JAX."""
    over = dict(SMALL)
    if mode == "fixed":
        over.update(depth_confidence=-1.0, width_confidence=-1.0)
    jconf = jconfigs.lightglue_config("superpoint", **over, fused_self=False,
                                      fused_cross=False)
    conf = configs.lightglue_config("superpoint", **over, fused_self=False,
                                    fused_cross=False)
    jparams = jlg.init_params(jax.random.key(1), jconf)
    params = weights.from_jax_params(jweights.flatten_tree(jparams), conf)
    pairs = planted_pairs(np.random.default_rng(2), 1, 32, 40, desc_dim=128)
    args = _inputs(pairs, masked=False)
    args["mask0"] = np.full((1, 32), which == "img1")
    args["mask1"] = np.full((1, 40), which == "img0")
    got = _compare(jparams, jconf, params, conf, args)
    for f in got._fields:
        v = getattr(got, f)
        assert not (isinstance(v, torch.Tensor) and v.isnan().any()), f
    assert (got.matches0 == -1).all() and (got.matches1 == -1).all()
    assert (got.matching_scores0 == 0).all() and (got.matching_scores1 == 0).all()
