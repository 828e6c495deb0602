"""Plain versions of ALIKED's kernels B10-B12 in lightglue_tpu_torch against
lightglue_tpu on the CPU, on the same seeded numpy inputs: the Pallas
kernels in interpret mode where they take the shape, else the composed JAX
ops they replace. The CUDA kernels themselves are held against these plain
versions on the card by ``chip_smoke.py``.

Tolerances (fp32): B10 and B12 within 1e-5 max-abs (different summation
order of the same products); B11 within 1e-4 (the lerp products associate
differently, as tests/test_score_head_pallas.py holds the Pallas kernel).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu import nn as jnn
from lightglue_tpu import weights as jweights
from lightglue_tpu.configs import ALIKEDConfig as JALIKEDConfig
from lightglue_tpu.models import aliked as jal
from lightglue_tpu.ops.aliked_stem import fused_aliked_stem as jstem
from lightglue_tpu.ops.score_head import (
    score_head_pallas_cplane, score_head_pallas_lazy)
from lightglue_tpu_torch import _build, configs, weights
from lightglue_tpu_torch.ops import aliked_stem, score_head

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_jax_init = jax.jit(jal.init_params, static_argnums=1)


def _params(model_name, seed):
    """JAX init with random batch-norm statistics (the init's are the
    identity, which would leave the folding untested), as (JAX tree, port
    tree)."""
    conf = JALIKEDConfig(model_name=model_name)
    flat = {k: np.asarray(v) for k, v in jweights.flatten_tree(
        _jax_init(jax.random.key(seed), conf)).items()}
    rng = np.random.default_rng(seed)
    for k, v in flat.items():
        if "/bn" in k:
            flat[k] = {"scale": rng.uniform(0.5, 1.5, v.shape),
                       "bias": rng.normal(0, 0.1, v.shape),
                       "mean": rng.normal(0, 0.1, v.shape),
                       "var": rng.uniform(0.5, 1.5, v.shape)}[k.split("/")[-1]
                                                              ].astype(np.float32)
    return (jweights.unflatten_tree(flat), weights.aliked_from_jax_params(
        flat, configs.ALIKEDConfig(model_name=model_name)))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@jax.jit
def _jax_stem_composed(block1, conv1, img):
    """The composed JAX ops B10 replaces (tests/test_aliked_stem.py:18-22)."""
    x1 = jal._conv_block(block1, img)
    return jal.selu(jnn.conv2d(conv1, x1)), jal._avg_pool(x1, 2)


@pytest.mark.parametrize("model_name", ["aliked-n16", "aliked-t16"])
def test_stem_plain_vs_jax(model_name):
    """n16 against the Pallas kernel (built for 16 channels only) and the
    composed JAX ops; t16 against the composed JAX ops."""
    jp, tp = _params(model_name, 0)
    img = np.random.default_rng(3).uniform(0, 1, (1, 64, 128, 3)).astype(np.float32)
    y1, x1p = aliked_stem.fused_aliked_stem(
        {"block1": tp["block1"], "conv1": tp["conv1"]}, _nchw(img))
    got = (y1.numpy(), x1p.permute(0, 2, 3, 1).numpy())
    composed = _jax_stem_composed(jp["block1"], jp["conv1"], jnp.asarray(img))
    c1, cy = tp["conv1"]["w"].shape[1], tp["conv1"]["w"].shape[0]
    assert got[0].shape == (1, 64, 128, cy) and got[1].shape == (1, 32, 64, c1)
    wants = [composed]
    if model_name == "aliked-n16":
        wants.append(jstem({"block1": jp["block1"], "conv1": jp["conv1"]},
                           jnp.asarray(img), mp=False, interpret=True))
    for want in wants:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=0)


def _tail_params(seed):
    jp, tp = _params("aliked-n16", seed)
    return jp["score_head"], tp["score_head"]


def test_score_head_cplane_plain_vs_pallas():
    jsh, tsh = _tail_params(4)
    s0 = np.random.default_rng(5).standard_normal((2, 8, 96, 128)).astype(np.float32)
    want = score_head_pallas_cplane(jsh, jnp.asarray(s0), mp=False,
                                    tile_rows=32, interpret=True)
    got = score_head.score_head_cplane(tsh, torch.from_numpy(s0))
    assert got.shape == (2, 96, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def _parts(seed, b, h, w):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, 8, h // f, w // f)).astype(np.float32)
            for f in (1, 2, 8, 32)]


def _jax_lazy_composed(jsh, parts):
    """The composed JAX score head of models/aliked.py::_dense_branches:
    the parts upsampled (``_upsample``) and summed, then the tapmat tail."""
    return _jax_lazy_composed_nhwc(
        jsh, [jnp.asarray(p.transpose(0, 2, 3, 1)) for p in parts])


@jax.jit
def _jax_lazy_composed_nhwc(jsh, nhwc):
    s0 = nhwc[0]
    for si, f in zip(nhwc[1:], (2, 8, 32)):
        s0 = s0 + jal._upsample(si, f)
    s = jal.selu(s0)
    for name in ("2", "4"):
        s = jal.selu(jnn.conv2d_tapmat(jsh[name], s))
    return jax.nn.sigmoid(jnn.conv2d_tapmat(jsh["6"], s))[..., 0]


def test_score_head_lazy_plain_vs_pallas():
    jsh, tsh = _tail_params(6)
    parts = _parts(7, 1, 256, 128)
    want = score_head_pallas_lazy(jsh, *map(jnp.asarray, parts), mp=False,
                                  interpret=True)
    got = score_head.score_head_lazy(tsh, *map(torch.from_numpy, parts))
    assert got.shape == (1, 256, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        _jax_lazy_composed(jsh, parts)), atol=1e-4, rtol=0)


@pytest.mark.parametrize("hw", [(32, 96), (64, 32), (32, 32)])
def test_score_head_lazy_branch_of_one(hw):
    """H or W = 32 leaves the coarsest branch one row or column: its single
    value is taken, as the composed JAX path does (the JAX Pallas kernel
    clamps to a row that does not exist there)."""
    jsh, tsh = _tail_params(8)
    parts = _parts(9, 2, *hw)
    got = score_head.score_head_lazy(tsh, *map(torch.from_numpy, parts))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        _jax_lazy_composed(jsh, parts)), atol=1e-4, rtol=0)


def test_cpu_never_builds_and_other_devices_raise():
    _, tp = _params("aliked-t16", 1)
    meta = lambda *s: torch.zeros(*s, device="meta")
    to_meta = lambda p: {k: to_meta(v) if isinstance(v, dict) else v.to("meta")
                         for k, v in p.items()}
    stem_p = {"block1": tp["block1"], "conv1": tp["conv1"]}
    with pytest.raises(ValueError, match="CUDA"):
        aliked_stem.fused_aliked_stem(to_meta(stem_p), meta(1, 3, 32, 32))
    sh = to_meta(tp["score_head"])
    with pytest.raises(ValueError, match="CUDA"):
        score_head.score_head_cplane(sh, meta(1, 8, 32, 32))
    with pytest.raises(ValueError, match="CUDA"):
        score_head.score_head_lazy(sh, meta(1, 8, 32, 32), meta(1, 8, 16, 16),
                                   meta(1, 8, 4, 4), meta(1, 8, 1, 1))
    with pytest.raises(ValueError, match="takes"):  # widths without a kernel
        bad = dict(stem_p, conv1={"w": torch.zeros(24, 8, 1, 1)})
        aliked_stem.fused_aliked_stem(to_meta(bad), meta(1, 3, 32, 32))
    aliked_stem.fused_aliked_stem(stem_p, torch.zeros(1, 3, 32, 32))
    score_head.score_head_cplane(tp["score_head"], torch.zeros(1, 8, 32, 32))
    assert _build._lib is None
    for name in ("fused_aliked_stem", "score_head_lazy", "score_head_cplane"):
        assert name in _build.KERNELS
