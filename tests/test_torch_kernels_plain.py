"""Plain PyTorch versions of the four kernels of lightglue_tpu_torch against
the JAX package: each Pallas kernel in interpret mode, and the composed JAX
op. Inputs come from seeded numpy and go to both packages.

Tolerances (fp32 on the CPU): attention, FFN and log-sum-exp outputs within
1e-5 max-abs (interpret vs XLA differ by < 2e-6, docs/PARITY.md); match
indices exactly equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lightglue_tpu.models import lightglue as jlg
from lightglue_tpu.ops import assignment as jasg
from lightglue_tpu.ops import assignment_fused as jfasg
from lightglue_tpu.ops import attention as jattn
from lightglue_tpu.ops import ffn as jffn
from lightglue_tpu.ops import flash as jflash
from lightglue_tpu.ops import flash_cross as jflash_cross
from lightglue_tpu_torch import _build
from lightglue_tpu_torch.ops import assignment_fused as fasg
from lightglue_tpu_torch.ops import ffn, flash, flash_cross

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = 1e-5


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rows=None, tol=TOL):
    got, want = _np(got), _np(want)
    if rows is not None:
        got, want = got[rows], want[rows]
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


# --- K1: flash_sdpa --------------------------------------------------------


@pytest.mark.parametrize("case", ["unmasked", "masked", "all_masked_row"])
def test_flash_sdpa_plain_vs_pallas(case):
    rng = np.random.default_rng(1)
    q, k, v = (_rand(rng, 2, 2, 128, 64) for _ in range(3))
    valid = None
    if case != "unmasked":
        valid = rng.uniform(size=(2, 128)) < 0.7
        if case == "all_masked_row":
            valid[1] = False
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else torch.from_numpy(valid)
    got = flash.flash_sdpa(*map(torch.from_numpy, (q, k, v)), tv)
    pallas = jflash.flash_sdpa(*map(jnp.asarray, (q, k, v)), jv, block_q=64,
                               interpret=True)
    composed = jattn.sdpa(*map(jnp.asarray, (q, k, v)),
                          None if jv is None else jv[:, None, None, :])
    _close(got, pallas)
    _close(got, composed)
    if case == "all_masked_row":
        assert not _np(got)[1].any()


def test_flash_sdpa_plain_ragged_vs_composed():
    rng = np.random.default_rng(2)
    q = _rand(rng, 2, 2, 200, 64)
    k, v = _rand(rng, 2, 2, 137, 64), _rand(rng, 2, 2, 137, 64)
    valid = rng.uniform(size=(2, 137)) < 0.8
    got = flash.flash_sdpa(*map(torch.from_numpy, (q, k, v, valid)))
    want = jattn.sdpa(*map(jnp.asarray, (q, k, v)),
                      jnp.asarray(valid)[:, None, None, :])
    _close(got, want)


# --- K2: fused_cross_attention ---------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_fused_cross_plain_vs_pallas(masked):
    rng = np.random.default_rng(3)
    qk0, v0 = _rand(rng, 2, 2, 128, 64), _rand(rng, 2, 2, 128, 64)
    qk1, v1 = _rand(rng, 2, 2, 192, 64), _rand(rng, 2, 2, 192, 64)
    va0 = rng.uniform(size=(2, 128)) < 0.8 if masked else np.ones((2, 128), bool)
    va1 = rng.uniform(size=(2, 192)) < 0.8 if masked else np.ones((2, 192), bool)
    masks = (va0, va1) if masked else (None, None)
    t = [torch.from_numpy(a) for a in (qk0, qk1, v0, v1)]
    tm = [None if a is None else torch.from_numpy(a) for a in masks]
    jm = [None if a is None else jnp.asarray(a) for a in masks]
    m0, m1 = flash_cross.fused_cross_attention(*t, *tm)
    pm0, pm1 = jflash_cross.fused_cross_attention(
        *map(jnp.asarray, (qk0, qk1, v0, v1)), *jm, block_q=64, interpret=True)
    pair = jnp.asarray(va0[:, None, :, None] & va1[:, None, None, :])
    cm0, cm1 = jattn.bidirectional_cross_attention(
        *map(jnp.asarray, (qk0, qk1, v0, v1)), pair if masked else None)
    # valid rows only: neither kernel zeroes m0 on invalid rows of image 0
    rows0 = np.broadcast_to(va0[:, None], (2, 2, 128))
    rows1 = np.broadcast_to(va1[:, None], (2, 2, 192))
    for want0, want1 in ((pm0, pm1), (cm0, cm1)):
        _close(m0, want0, rows0)
        _close(m1, want1, rows1)


def test_fused_cross_plain_ragged_vs_composed():
    rng = np.random.default_rng(4)
    qk0, v0 = _rand(rng, 1, 2, 200, 64), _rand(rng, 1, 2, 200, 64)
    qk1, v1 = _rand(rng, 1, 2, 136, 64), _rand(rng, 1, 2, 136, 64)
    va0 = np.arange(200)[None] < 170
    va1 = np.arange(136)[None] < 120
    m0, m1 = flash_cross.fused_cross_attention(
        *map(torch.from_numpy, (qk0, qk1, v0, v1, va0, va1)))
    pair = jnp.asarray(va0[:, None, :, None] & va1[:, None, None, :])
    cm0, cm1 = jattn.bidirectional_cross_attention(
        *map(jnp.asarray, (qk0, qk1, v0, v1)), pair)
    _close(m0, cm0, np.broadcast_to(va0[:, None], (1, 2, 200)))
    _close(m1, cm1, np.broadcast_to(va1[:, None], (1, 2, 136)))


# --- K3: fused_ffn_residual ------------------------------------------------


def _ffn_params(rng, d):
    return {
        "lin1": {"w": _rand(rng, 2 * d, 2 * d, scale=(2 * d) ** -0.5),
                 "b": _rand(rng, 2 * d, scale=0.1)},
        "ln": {"scale": 1 + _rand(rng, 2 * d, scale=0.1),
               "bias": _rand(rng, 2 * d, scale=0.1)},
        "lin2": {"w": _rand(rng, 2 * d, d, scale=(2 * d) ** -0.5),
                 "b": _rand(rng, d, scale=0.1)},
    }


def _tree(p, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in p.items()}


@pytest.mark.parametrize("n", [128, 200])
def test_ffn_plain_vs_pallas_and_composed(n):
    rng = np.random.default_rng(5)
    d = 64
    x, msg = _rand(rng, 2, n, d), _rand(rng, 2, n, d)
    p = _ffn_params(rng, d)
    got = ffn.fused_ffn_residual(torch.from_numpy(x), torch.from_numpy(msg),
                                 _tree(p, torch.from_numpy))
    jp = _tree(p, jnp.asarray)
    composed = jnp.asarray(x) + jlg._ffn(
        jp, jnp.concatenate([jnp.asarray(x), jnp.asarray(msg)], -1))
    _close(got, composed)
    if n % 64 == 0:  # the Pallas wrapper needs block-divisible rows
        pallas = jffn.fused_ffn_residual(jnp.asarray(x), jnp.asarray(msg), jp,
                                         block_q=64, interpret=True)
        _close(got, pallas)


# --- K4: fused_filter_matches ----------------------------------------------


def _filter_inputs(rng, m, n, d):
    md0 = _rand(rng, 2, m, d, scale=0.4)
    md1 = _rand(rng, 2, n, d, scale=0.4)
    # planted exact ties: row 3 of image 0 is a scaled copy of column 10 of
    # image 1, and column 10 is duplicated at 40 and 90; row 3 is duplicated
    # at row 70. The lowest index must win both argmaxes.
    md0[:, 3] = md1[:, 10] * 4.0
    md1[:, 40] = md1[:, 10]
    md1[:, 90] = md1[:, 10]
    md0[:, 70] = md0[:, 3]
    z0, z1 = _rand(rng, 2, m), _rand(rng, 2, n)
    z0[:, 70] = z0[:, 3]  # copies carry the same matchability
    z1[:, 40] = z1[:, 90] = z1[:, 10]
    mask0 = rng.uniform(size=(2, m)) < 0.9
    mask1 = rng.uniform(size=(2, n)) < 0.9
    mask0[:, [3, 70]] = True
    mask1[:, [10, 40, 90]] = True
    return md0, md1, z0, z1, mask0, mask1


@pytest.mark.parametrize("th", [0.0, 0.1])
@pytest.mark.parametrize("masked", [False, True])
def test_filter_matches_plain_vs_pallas_with_ties(masked, th):
    """th 0 keeps every mutual pair, so the tied pair (3, 10) must come out;
    at 0.1 its split probability mass drops it, in both packages."""
    rng = np.random.default_rng(6)
    md0, md1, z0, z1, mask0, mask1 = _filter_inputs(rng, 128, 128, 64)
    masks = (mask0, mask1) if masked else (None, None)
    got = fasg.fused_filter_matches(
        *map(torch.from_numpy, (md0, md1, z0, z1)), th,
        *[None if a is None else torch.from_numpy(a) for a in masks])
    want = jfasg.fused_filter_matches(
        *map(jnp.asarray, (md0, md1, z0, z1)), th,
        *[None if a is None else jnp.asarray(a) for a in masks],
        block_q=64, interpret=True)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(_np(g), _np(w))
    for g, w in zip(got[2:], want[2:]):
        _close(g, w)
    if th == 0.0:
        m0, m1 = _np(got[0]), _np(got[1])
        assert (m0[:, 3] == 10).all() and (m1[:, 10] == 3).all()
        # the ties went to row 3 and column 10: the copies are not mutual
        assert (m0[:, 70] == -1).all() and (m1[:, [40, 90]] == -1).all()


def test_filter_reductions_plain_vs_composed():
    """Row/column maxima of the factored score against the composed
    log-assignment matrix (so the log-sum-exp pass is checked on its own)."""
    rng = np.random.default_rng(7)
    md0, md1, z0, z1, mask0, mask1 = _filter_inputs(rng, 128, 128, 64)
    ls0 = torch.nn.functional.logsigmoid(torch.from_numpy(z0))
    ls1 = torch.nn.functional.logsigmoid(torch.from_numpy(z1))
    _, v0, _, v1 = fasg.filter_reductions_plain(
        torch.from_numpy(md0), torch.from_numpy(md1), ls0, ls1,
        torch.from_numpy(mask0), torch.from_numpy(mask1))
    sim = jnp.einsum("bmd,bnd->bmn", jnp.asarray(md0), jnp.asarray(md1))
    scores = jasg.sigmoid_log_double_softmax(
        sim, jnp.asarray(z0)[..., None], jnp.asarray(z1)[..., None],
        jnp.asarray(mask0), jnp.asarray(mask1))
    inner = np.asarray(scores)[:, :-1, :-1]
    _close(v0, inner.max(2), mask0)
    _close(v1, inner.max(1), mask1)


def test_filter_matches_plain_ragged_vs_composed():
    rng = np.random.default_rng(8)
    md0, md1, z0, z1, mask0, mask1 = _filter_inputs(rng, 200, 136, 64)
    got = fasg.fused_filter_matches(
        *map(torch.from_numpy, (md0, md1, z0, z1)), 0.1,
        torch.from_numpy(mask0), torch.from_numpy(mask1))
    sim = jnp.einsum("bmd,bnd->bmn", jnp.asarray(md0), jnp.asarray(md1))
    scores = jasg.sigmoid_log_double_softmax(
        sim, jnp.asarray(z0)[..., None], jnp.asarray(z1)[..., None],
        jnp.asarray(mask0), jnp.asarray(mask1))
    want = jasg.filter_matches(scores, 0.1, jnp.asarray(mask0),
                               jnp.asarray(mask1))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(_np(g), _np(w))
    for g, w in zip(got[2:], want[2:]):
        _close(g, w)


# --- dispatch --------------------------------------------------------------


def test_cpu_ops_never_build_and_other_devices_raise():
    """CPU tensors take the plain versions without touching nvcc; a tensor
    on neither the CPU nor a GPU is refused, not computed."""
    x = torch.zeros(1, 1, 8, 64)
    flash.flash_sdpa(x, x, x)
    assert _build._lib is None
    meta = torch.zeros(1, 1, 8, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_sdpa(meta, meta, meta)
    with pytest.raises(ValueError, match="CUDA"):
        flash_cross.fused_cross_attention(meta, meta, meta, meta)
    with pytest.raises(ValueError, match="CUDA"):
        ffn.fused_ffn_residual(torch.zeros(1, 8, 256, device="meta"),
                               torch.zeros(1, 8, 256, device="meta"),
                               _tree(_ffn_params(np.random.default_rng(0), 256),
                                     torch.from_numpy))
    with pytest.raises(ValueError, match="CUDA"):
        fasg.fused_filter_matches(torch.zeros(1, 8, 64, device="meta"),
                                  torch.zeros(1, 8, 64, device="meta"),
                                  torch.zeros(1, 8, device="meta"),
                                  torch.zeros(1, 8, device="meta"), 0.1)
