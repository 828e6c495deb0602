"""The constant-shift attention variants of lightglue_tpu_torch (B1s:
flash_sdpa with ``shift``; B3s: the single-pass fused_cross_attention)
against the JAX package's Pallas kernels in interpret mode, and the
composed matcher with both shifts against the JAX matcher, on the CPU.

Tolerances (fp32): attention outputs within 1e-5 max-abs. The shift
variants leave the rows of masked points at 0 in both packages, so every
row is compared. Matches, ``stop`` and ``prune`` exactly equal; scores
within 1e-4.
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
from lightglue_tpu.ops import attention as jattn
from lightglue_tpu.ops import flash as jflash
from lightglue_tpu.ops import flash_cross as jflash_cross
from lightglue_tpu_torch import configs, weights
from lightglue_tpu_torch.models import lightglue as lg
from lightglue_tpu_torch.ops import flash, flash_cross
from lightglue_tpu_torch.synthetic import planted_pairs

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = 1e-5
SHIFT = 12.0  # the JAX bench's self_ and cross_softmax_shift (bench.py:279)
NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "weights", "synthetic_superpoint_lightglue.npz")
_jit_forward = jax.jit(jlg.forward, static_argnames=("conf",))


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL,
                               rtol=0)


# --- B1s: flash_sdpa with a constant shift ----------------------------------


@pytest.mark.parametrize("case", ["unmasked", "masked", "all_masked_row"])
def test_flash_sdpa_shift_plain_vs_pallas(case):
    rng = np.random.default_rng(21)
    q, k, v = (_rand(rng, 2, 2, 256, 64) for _ in range(3))
    valid = None
    if case != "unmasked":
        valid = rng.uniform(size=(2, 256)) < 0.7
        if case == "all_masked_row":
            valid[1] = False
    got = flash.flash_sdpa(*map(torch.from_numpy, (q, k, v)),
                           None if valid is None else torch.from_numpy(valid),
                           shift=SHIFT)
    want = jflash.flash_sdpa(*map(jnp.asarray, (q, k, v)),
                             None if valid is None else jnp.asarray(valid),
                             block_q=128, shift=SHIFT, interpret=True)
    _close(got, want)
    exact = jattn.sdpa(*map(jnp.asarray, (q, k, v)),
                       None if valid is None
                       else jnp.asarray(valid)[:, None, None, :])
    _close(got, exact)  # the shift changes no result at these scores
    if case == "all_masked_row":
        assert not got[1].any()


def test_flash_sdpa_shift_clamps_large_scores():
    """Scores far above the shift hit the exp2 clamp in both packages."""
    rng = np.random.default_rng(22)
    q, k, v = (_rand(rng, 1, 1, 128, 64) for _ in range(3))
    q *= 6.0
    k *= 6.0
    got = flash.flash_sdpa(*map(torch.from_numpy, (q, k, v)), shift=SHIFT)
    want = jflash.flash_sdpa(*map(jnp.asarray, (q, k, v)), block_q=128,
                             shift=SHIFT, interpret=True)
    assert np.isfinite(got.numpy()).all()
    _close(got, want)


# --- B3s: single-pass fused_cross_attention ---------------------------------


@pytest.mark.parametrize("case", ["unmasked", "masked", "all_masked_image1"])
def test_fused_cross_shift_plain_vs_pallas(case):
    rng = np.random.default_rng(23)
    qk0, v0 = _rand(rng, 2, 2, 128, 64), _rand(rng, 2, 2, 128, 64)
    qk1, v1 = _rand(rng, 2, 2, 256, 64), _rand(rng, 2, 2, 256, 64)
    masks = (None, None)
    if case != "unmasked":
        va0 = rng.uniform(size=(2, 128)) < 0.8
        va1 = rng.uniform(size=(2, 256)) < 0.8
        if case == "all_masked_image1":
            va1[0] = False
        masks = (va0, va1)
    t = [torch.from_numpy(a) for a in (qk0, qk1, v0, v1)]
    m0, m1 = flash_cross.fused_cross_attention(
        *t, *[None if a is None else torch.from_numpy(a) for a in masks],
        shift=SHIFT)
    pm0, pm1 = jflash_cross.fused_cross_attention(
        *map(jnp.asarray, (qk0, qk1, v0, v1)),
        *[None if a is None else jnp.asarray(a) for a in masks],
        shift=SHIFT, interpret=True)
    _close(m0, pm0)
    _close(m1, pm1)
    if case != "unmasked":  # invalid rows and columns come out 0
        assert not m0.numpy()[~np.broadcast_to(masks[0][:, None],
                                               m0.shape[:3])].any()
        assert not m1.numpy()[~np.broadcast_to(masks[1][:, None],
                                               m1.shape[:3])].any()


# --- the composed matcher with both shifts ----------------------------------


@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_composed_shift_matcher_against_jax(mode):
    """fused_self=False, fused_cross=False with shift 12 runs B1s and B3s
    in every layer; the trained npz at full width, B 2, N 128, masked."""
    over = dict(pruning_min_kpts=32)
    if mode == "fixed":
        over.update(depth_confidence=-1.0, width_confidence=-1.0)
    jconf = jconfigs.lightglue_config("superpoint", **over)
    conf = configs.lightglue_config(
        "superpoint", fused_self=False, fused_cross=False,
        self_softmax_shift=SHIFT, cross_softmax_shift=SHIFT, **over)
    jparams = jweights.load_params(NPZ, dtype=np.float32)
    params = weights.from_jax_params(jweights.flatten_tree(jparams))
    pairs = planted_pairs(np.random.default_rng(24), 2, 128)
    mask0 = np.ones((2, 128), bool)
    mask0[1, 100:] = False
    args = dict(kpts0=pairs["keypoints0"], kpts1=pairs["keypoints1"],
                desc0=pairs["descriptors0"], desc1=pairs["descriptors1"],
                size0=pairs["image_size"], size1=pairs["image_size"],
                mask0=mask0, mask1=np.ones((2, 128), bool))
    want = _jit_forward(jparams, jconf,
                        **{k: jnp.asarray(v) for k, v in args.items()})
    got = lg.forward(params, conf,
                     **{k: torch.as_tensor(v) for k, v in args.items()})
    for f in ("matches0", "matches1", "prune0", "prune1"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert got.stop == int(want.stop)
    np.testing.assert_allclose(got.matching_scores0.numpy(),
                               np.asarray(want.matching_scores0), atol=1e-4,
                               rtol=0)
    assert (got.matches0.numpy() >= 0).sum() > 50
