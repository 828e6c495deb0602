"""lightglue_tpu_torch.native (the port's build of its copy of the C++ host
runtime) against the JAX package's binding (lightglue_tpu/native.py over
native/liblg_host.so) and against its own numpy forms, on seeded inputs:
rows that match nothing, empty and ragged lists, ties. Indices and counts
are equal; scores are equal to the JAX binding's (both call the C library's
expf) and within 1 ulp-scale of numpy's exp."""

import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

from lightglue_tpu import native as jax_native

from lightglue_tpu_torch import _build, native, pipeline
from lightglue_tpu_torch.configs import lightglue_config
from lightglue_tpu_torch.models import lightglue as lg
from lightglue_tpu_torch.parallel.batching import BatchMatcher
from lightglue_tpu_torch.synthetic import planted_pairs

JAX_LIB = Path(jax_native.__file__).resolve().parent.parent / "native" / "liblg_host.so"
JAX_LIB_SHA = hashlib.sha256(JAX_LIB.read_bytes()).hexdigest()


def match_rows(rng, b, m, n):
    """matches0 with a row that matches nothing and a ragged tail."""
    m0 = rng.integers(-1, n, (b, m)).astype(np.int32)
    m0[rng.uniform(size=(b, m)) < 0.4] = -1
    if b > 1:
        m0[1] = -1
    s0 = rng.uniform(0, 1, (b, m)).astype(np.float32)
    return m0, s0


@pytest.mark.parametrize("shape", [(3, 64, 50), (1, 1, 1), (4, 0, 8), (0, 5, 5),
                                   (2, 300, 2048)])
def test_compact_matches(shape):
    m0, s0 = match_rows(np.random.default_rng(sum(shape)), *shape)
    got = native.compact_matches(m0, s0)
    for other in (native.compact_matches_numpy(m0, s0),
                  jax_native.compact_matches(m0, s0)):
        assert len(got[0]) == len(other[0]) == shape[0]
        for g, o in zip(got[0] + got[1], other[0] + other[1]):
            assert g.dtype == o.dtype and g.shape == o.shape
            np.testing.assert_array_equal(g, o)
    for pairs in got[0]:
        assert pairs.shape[1] == 2 and pairs.dtype == np.int32


def test_compact_matches_all_unmatched():
    m0 = np.full((2, 16), -1, np.int32)
    pairs, scores = native.compact_matches(m0, np.ones((2, 16), np.float32))
    assert all(p.shape == (0, 2) for p in pairs)
    assert all(s.shape == (0,) and s.dtype == np.float32 for s in scores)


@pytest.mark.parametrize("lengths,k,d", [((3, 7, 5), 6, 4), ((0, 9, 2, 12), 8, 3),
                                         ((5,), 5, 1), ((0, 0), 4, 2),
                                         ((700, 1024, 31), 1024, 256)])
def test_pack_ragged(lengths, k, d):
    rng = np.random.default_rng(len(lengths) + k)
    arrays = [rng.standard_normal((n, d)).astype(np.float32) for n in lengths]
    got = native.pack_ragged(arrays, k, pad_value=9.0)
    for other in (native.pack_ragged_numpy(arrays, k, pad_value=9.0),
                  jax_native.pack_ragged(arrays, k, pad_value=9.0)):
        for g, o in zip(got, other):
            assert g.dtype == o.dtype and g.shape == o.shape
            np.testing.assert_array_equal(g, o)
    np.testing.assert_array_equal(got[1].sum(1), [min(n, k) for n in lengths])


@pytest.mark.parametrize("m,n,ties", [(21, 31, False), (64, 48, True),
                                      (1, 7, False), (9, 1, True)])
def test_filter_matches_host(m, n, ties):
    rng = np.random.default_rng(m * 100 + n)
    if ties:  # few distinct values: ties along rows and columns
        scores = -rng.integers(0, 4, (m, n)).astype(np.float32) * 0.5
    else:
        scores = (rng.standard_normal((m, n)) * 2 - 3).astype(np.float32)
    for th in (0.0, 0.1, 0.6):
        got = native.filter_matches_host(scores, th)
        want = native.filter_matches_host_numpy(scores, th)
        jax_got = jax_native.filter_matches_host(scores, th)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[0], jax_got[0])
        np.testing.assert_array_equal(got[1], jax_got[1])
        np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=0)
        assert got[0].dtype == np.int32 and got[1].dtype == np.float32


def test_filter_matches_host_refuses_no_columns():
    with pytest.raises(ValueError, match="no columns"):
        native.filter_matches_host(np.zeros((3, 0), np.float32), 0.1)


def test_library_is_built_under_build_dir():
    native.library()
    path = native.library_path()
    assert path.parent == _build.BUILD_DIR and path.exists()
    assert path.name.startswith("liblg_host_") and path.suffix == ".so"


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text('extern "C" int compact_matches( { this is not C++ }\n')
    monkeypatch.setattr(native, "SOURCE", bad)
    assert not native.library_path().exists()
    with pytest.raises(RuntimeError, match="error"):
        native.build()
    assert not native.library_path().exists()
    assert not list(_build.BUILD_DIR.glob(f"{native.library_path().stem}.*"))


def test_pipeline_and_batch_matcher_go_through_the_library(monkeypatch):
    calls = []
    real = native.compact_matches

    def spy(m0, s0):
        calls.append(np.asarray(m0).shape)
        return real(m0, s0)

    monkeypatch.setattr(native, "compact_matches", spy)
    m0, s0 = match_rows(np.random.default_rng(0), 2, 8, 8)
    pipeline.compact_matches(m0, s0)
    assert calls == [(2, 8)]
    conf = lightglue_config("superpoint", n_layers=2)
    params = lg.init_params(conf, torch.Generator().manual_seed(0))
    bm = BatchMatcher(conf, params, buckets=(64,), max_batch=4, device="cpu")
    pr = planted_pairs(np.random.default_rng(1), 3, 48)
    pairs = [tuple({"keypoints": pr[f"keypoints{s}"][i],
                    "descriptors": pr[f"descriptors{s}"][i]} for s in (0, 1))
             for i in range(3)]
    res = bm.match_pairs(pairs)
    assert calls[1:] == [(4, 64)]
    for r in res:
        want, _ = native.compact_matches_numpy(r["matches0"][None],
                                               r["matching_scores0"][None])
        np.testing.assert_array_equal(r["matches"], want[0])


def test_jax_library_untouched():
    """Last in the file: the JAX package's tracked library has the bytes it
    had when this module was imported."""
    assert hashlib.sha256(JAX_LIB.read_bytes()).hexdigest() == JAX_LIB_SHA
