"""The port's serving layer (lightglue_tpu_torch.parallel) against the JAX
package's (lightglue_tpu.parallel.batching) on the CPU, on the same seeded
numpy inputs and the same weights (JAX params carried across by
``weights.from_jax_params``).

Bucketing and padding array for array; ``BatchMatcher.match_pairs`` with
matches, ``matches0``/``matches1`` and ``stop`` exactly equal and matching
scores within 1e-4 (as tests/test_torch_matcher.py holds the matcher);
``warmup``'s count equal. The CUDA graph runner's bookkeeping (segments,
stop reads, exits, packed inputs and outputs) runs here with each capture
recorded as a Python call and each replay rerunning it into the captured
tensors, held to the bit against ``models.lightglue.forward``.
"""

import contextlib
import os

import jax
import numpy as np
import pytest
import torch

from lightglue_tpu import configs as jconfigs
from lightglue_tpu import weights as jweights
from lightglue_tpu.models import lightglue as jlg
from lightglue_tpu.parallel import batching as jbatching
from lightglue_tpu_torch import BatchMatcher, configs, weights
from lightglue_tpu_torch.models import lightglue as lg
from lightglue_tpu_torch.parallel import batching, graphs
from lightglue_tpu_torch.synthetic import planted_pairs

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "weights", "synthetic_superpoint_lightglue.npz")
BLOCKS = dict(fused_self=False, fused_cross=False)  # as the port's tests run JAX
MODES = {"fixed": dict(depth_confidence=-1.0, width_confidence=-1.0),
         "adaptive": dict(pruning_min_kpts=16)}
# ragged pairs over buckets (32, 64): three in 32 (a dummy pads the batch
# to 4), two in 64
SIZES = [(20, 28), (50, 40), (10, 12), (32, 17), (64, 33)]


def _feats(rng, n, dim=256, size=True):
    f = {"keypoints": rng.uniform(0, 64, (n, 2)).astype(np.float32),
         "descriptors": rng.standard_normal((n, dim)).astype(np.float32)}
    if size:
        f["image_size"] = np.array([64.0, 48.0], np.float32)
    return f


def _pairs(seed, sizes=SIZES, size=True):
    rng = np.random.default_rng(seed)
    return [(_feats(rng, a, size=size), _feats(rng, b, size=size))
            for a, b in sizes]


def _planted(pr, counts):
    """Pairs of planted_pairs' batch entries, image 0 cut to ``counts``."""
    return [({"keypoints": pr["keypoints0"][i][:k],
              "descriptors": pr["descriptors0"][i][:k],
              "image_size": pr["image_size"][i]},
             {"keypoints": pr["keypoints1"][i],
              "descriptors": pr["descriptors1"][i],
              "image_size": pr["image_size"][i]})
            for i, k in enumerate(counts)]


def _same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("matches0", "matches1", "matches"):
            np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=k)
        assert g["stop"] == w["stop"]
        for k in ("matching_scores0", "matching_scores1", "scores"):
            np.testing.assert_allclose(g[k], np.asarray(w[k]), atol=1e-4,
                                       rtol=0, err_msg=k)


@pytest.fixture(scope="module")
def small():
    """Two layers at the superpoint preset's widths, the JAX init (key 0)
    carried across; threshold 0 keeps every mutual pair."""
    over = dict(n_layers=2, filter_threshold=0.0, **BLOCKS)
    jparams = jlg.init_params(jax.random.key(0),
                              jconfigs.lightglue_config("superpoint", **over))
    params = weights.from_jax_params(
        jweights.flatten_tree(jparams),
        configs.lightglue_config("superpoint", **over))
    return over, jparams, params


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 1024, 1025, 4096, 5000])
def test_next_bucket_matches_jax(n):
    assert batching.next_bucket(n) == jbatching.next_bucket(n)
    assert (batching.next_bucket(n, (16, 32))
            == jbatching.next_bucket(n, (16, 32)))
    assert batching.DEFAULT_BUCKETS == jbatching.DEFAULT_BUCKETS


@pytest.mark.parametrize("bucket", [None, 64])
def test_pad_features_to_bucket_matches_jax(bucket):
    rng = np.random.default_rng(1)
    feats = []
    for n in (5, 17, 9):
        f = _feats(rng, n, dim=8)
        f["keypoint_scores"] = rng.uniform(size=n).astype(np.float32)
        f["scales"] = rng.uniform(1, 4, n).astype(np.float32)
        f["oris"] = rng.uniform(-3, 3, n).astype(np.float32)
        feats.append(f)
    feats[1]["valid"] = rng.uniform(size=17) < 0.7  # a mask given
    got = batching.pad_features_to_bucket(feats, bucket, (8, 32))
    want = jbatching.pad_features_to_bucket(feats, bucket, (8, 32))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["keypoints"].shape == (3, bucket or 32, 2)


@pytest.mark.parametrize("scale_ori", [False, True])
def test_pack_pairs_equals_padded_batch(scale_ori):
    """match_pairs' straight fill of a chunk equals pad_features_to_bucket
    + batch_inputs array for array, dummy pairs, given masks and
    scales/oris included."""
    rng = np.random.default_rng(7)
    conf = configs.lightglue_config("sift" if scale_ori else "superpoint")
    dim = conf.input_dim
    sel = []
    for n0, n1 in ((5, 17), (32, 9), (1, 30)):
        pair = (_feats(rng, n0, dim), _feats(rng, n1, dim))
        for f in pair:
            n = f["keypoints"].shape[0]
            f["scales"] = rng.uniform(1, 4, n).astype(np.float32)
            f["oris"] = rng.uniform(-3, 3, n).astype(np.float32)
        sel.append(pair)
    sel[1][0]["valid"] = rng.uniform(size=32) < 0.5
    sel.append(sel[0])  # a dummy
    want = batching.batch_inputs(
        conf, *(batching.pad_features_to_bucket([p[s] for p in sel], 32)
                for s in (0, 1)))
    sig = graphs.signature_of(want)
    assert sig == graphs.Signature(4, 32, 32, True, scale_ori)
    got = graphs.host_arrays(sig, dim)
    for a in got.values():
        a.fill(7)  # no slot left unwritten
    batching.pack_pairs(sel)(got)
    assert sorted(got) == sorted(k for k, v in want.items() if v is not None)
    for k, a in got.items():
        assert a.dtype == want[k].dtype, k
        np.testing.assert_array_equal(a, want[k], err_msg=k)


@pytest.mark.parametrize("mode", list(MODES))
def test_match_pairs_matches_jax(small, mode):
    """Ragged pairs over two buckets, with a dummy pair padding a batch."""
    over, jparams, params = small
    over = dict(over, **MODES[mode])
    jbm = jbatching.BatchMatcher(jconfigs.lightglue_config("superpoint", **over),
                                 jparams, buckets=(32, 64), max_batch=4)
    bm = BatchMatcher(configs.lightglue_config("superpoint", **over), params,
                      buckets=(32, 64), max_batch=4, device="cpu")
    chunks = [len(c) for c, f0, _ in bm.padded_batches(_pairs(0))]
    assert sorted(chunks) == [2, 3]  # batches of 4 (one dummy) and 2
    got = bm.match_pairs(_pairs(0))
    _same_results(got, jbm.match_pairs(_pairs(0)))
    assert sum(len(r["matches"]) for r in got) > 20
    # without image_size: keypoints normalized by their bounding box
    _same_results(bm.match_pairs(_pairs(1, size=False)),
                  jbm.match_pairs(_pairs(1, size=False)))


def test_match_feature_batch_matches_jax(small):
    """One padded batch through match_feature_batch, whose runner is
    cached per (conf, tree, device)."""
    over, jparams, params = small
    conf = configs.lightglue_config("superpoint", **over)
    feats = [batching.pad_features_to_bucket([p[s] for p in _pairs(5)], 64)
             for s in (0, 1)]
    got = batching.match_feature_batch(params, conf, *feats, device="cpu")
    want = jbatching.match_feature_batch(
        jparams, jconfigs.lightglue_config("superpoint", **over), *feats)
    for f in ("matches0", "matches1", "prune0", "prune1"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)))
    assert got.stop == int(want.stop)
    np.testing.assert_allclose(got.matching_scores0,
                               np.asarray(want.matching_scores0), atol=1e-4, rtol=0)
    batching.match_feature_batch(params, conf, *feats, device="cpu")
    assert batching._shared_matcher.cache_info().hits >= 1


def test_single_pair_equivalence(small):
    """The same pair matched alone gives the same matches as in a batch
    (tests/test_parallel.py:128-131)."""
    over, _, params = small
    conf = configs.lightglue_config("superpoint", **over, **MODES["fixed"])
    pairs = _pairs(2)
    batched = BatchMatcher(conf, params, buckets=(32, 64), max_batch=4,
                           device="cpu").match_pairs(pairs)
    solo = BatchMatcher(conf, params, buckets=(32,), max_batch=1,
                        device="cpu").match_pairs([pairs[0]])[0]
    np.testing.assert_array_equal(solo["matches0"], batched[0]["matches0"])


def test_warmup_count_matches_jax():
    """Two buckets x two batch sizes x (with, without image_size), as
    tests/test_serving_warmup.py:34-47; the warmed programs serve the
    traffic after."""
    over = dict(n_layers=2, **MODES["fixed"], **BLOCKS)
    jconf = jconfigs.lightglue_config("superpoint", **over)
    jbm = jbatching.BatchMatcher(jconf, jlg.init_params(jax.random.key(0), jconf),
                                 buckets=(16, 32), max_batch=2)
    conf = configs.lightglue_config("superpoint", **over)
    bm = BatchMatcher(conf, lg.init_params(conf, torch.Generator().manual_seed(0)),
                      buckets=(16, 32), max_batch=2, device="cpu")
    n = bm.warmup(batches=(1, 2))
    assert n == jbm.warmup(batches=(1, 2)) == 2 * 2 * 2
    assert bm.warmup() == jbm.warmup() == 2 * 1 * 2
    sizes = [(10, 12), (30, 7), (16, 16)]
    res = bm.match_pairs(_pairs(3, sizes))
    for r, (n0, n1) in zip(res, sizes):
        assert r["matches0"].shape == (n0,) and r["matches1"].shape == (n1,)


def test_traffic_signatures_are_the_warmed_ones():
    """Every batch match_pairs sends is a signature warmup builds, so a
    warmed matcher captures nothing while it serves."""
    conf = configs.lightglue_config("superpoint", n_layers=2)
    bm = BatchMatcher(conf, lg.init_params(conf, torch.Generator().manual_seed(0)),
                      buckets=(16, 32, 64), max_batch=4, device="cpu")
    warmed = []
    bm._matcher.warm = warmed.append
    bm.warmup(batches=(1, 2, 3, 4))
    assert len(warmed) == len(set(warmed)) == 3 * 3 * 2
    sizes = [(3, 60), (17, 2), (64, 64), (9, 9), (30, 30), (31, 1), (5, 5)]
    for size in (True, False):
        for _, f0, f1 in bm.padded_batches(_pairs(4, sizes, size=size)):
            sig = graphs.signature_of(batching.batch_inputs(conf, f0, f1))
            assert sig in warmed
            assert sig.with_size == size and sig.m == sig.n


@pytest.mark.parametrize("mode", list(MODES))
def test_full_width_trained_matches_jax(mode):
    """The trained npz (9 layers, 256-d, 4 x 64) on planted pairs at bucket
    128: three pairs, one of them ragged, batched to 4 with a dummy."""
    over = dict(BLOCKS, **MODES[mode])
    jbm = jbatching.BatchMatcher(
        jconfigs.lightglue_config("superpoint", **over),
        jweights.load_params(NPZ, dtype=np.float32), buckets=(128,),
        max_batch=4)
    bm = BatchMatcher(configs.lightglue_config("superpoint", **over),
                      weights.load_params(NPZ), buckets=(128,), max_batch=4,
                      device="cpu")
    pr = planted_pairs(np.random.default_rng(5), 3, 128)
    pairs = _planted(pr, (128, 100, 128))
    got = bm.match_pairs(pairs)
    _same_results(got, jbm.match_pairs(pairs))
    gt = pr["gt_matches0"][0]
    m0 = got[0]["matches0"]
    assert ((m0 == gt) & (m0 >= 0)).sum() >= 0.8 * (m0 >= 0).sum() > 20
    if mode == "adaptive":
        assert got[0]["stop"] < 9


class _Recorded:
    """A capture as a Python call: replay reruns it and writes its results
    into the tensors the capture returned, as a graph's replay rewrites
    them."""

    def __init__(self, fn, result):
        self.fn, self.result = fn, result

    def replay(self):
        def assign(dst, src):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)
            elif isinstance(dst, tuple):
                for d, s in zip(dst, src):
                    assign(d, s)
        assign(self.result, self.fn())


@pytest.fixture
def recorded_graphs(monkeypatch):
    class Stream:
        def synchronize(self):
            pass

    def graph(self, fn):
        result = fn()
        return graphs.Captured(_Recorded(fn, result), {"fused_filter_matches": 1}), result

    monkeypatch.setattr(graphs.GraphMatcher, "_graph", graph)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)


@pytest.mark.parametrize("mode", ["fixed", "adaptive", "prune only"])
def test_graph_runner_replays_like_forward(recorded_graphs, mode):
    """GraphMatcher's segments, stop reads, exits and packed buffers, with
    the trained npz on planted pairs, against models.lightglue.forward on
    the same padded batches, to the bit; a signature is captured once and
    each replay adds its capture's launch counts."""
    from lightglue_tpu_torch import _build
    over = {"fixed": MODES["fixed"], "adaptive": dict(pruning_min_kpts=32),
            "prune only": dict(depth_confidence=-1.0, pruning_min_kpts=32)}[mode]
    conf = configs.lightglue_config("superpoint", **over)
    params = weights.load_params(NPZ)
    bm = BatchMatcher(conf, params, buckets=(128,), max_batch=4, device="cpu")
    bm._matcher = gm = graphs.GraphMatcher(conf, bm.params, torch.device("cpu"))
    pairs = _planted(planted_pairs(np.random.default_rng(6), 3, 128),
                     (128, 108, 88))
    _build.reset_launch_counts()
    for call in range(2):
        results = bm.match_pairs(pairs)  # through pack_pairs' fill
        for chunk, f0, f1 in bm.padded_batches(pairs):
            got = bm.match_batch(f0, f1)
            for j, i in enumerate(chunk):
                np.testing.assert_array_equal(
                    results[i]["matches0"],
                    got.matches0[j, :pairs[i][0]["keypoints"].shape[0]])
            inp = batching.batch_inputs(conf, f0, f1)
            want = lg.forward(bm.params, conf, **{
                k: None if v is None else torch.from_numpy(v) for k, v in inp.items()})
            for f in graphs.OUTPUTS:
                np.testing.assert_array_equal(getattr(got, f),
                                              getattr(want, f).numpy(), err_msg=f)
                assert getattr(got, f).dtype == getattr(want, f).numpy().dtype
            assert got.stop == want.stop
    assert len(gm.sets) == 1
    gs = next(iter(gm.sets.values()))
    graphs_run = 1 if mode == "fixed" else got.stop + 1  # segments and an exit
    assert _build.launch_counts()["fused_filter_matches"] == 4 * graphs_run
    if mode == "fixed":
        assert len(gs.segments) == 1 and not gs.exits
    else:
        assert len(gs.segments) == len(gs.exits) == len(gs.states) == conf.n_layers
        assert (gs.stops[0] is None) == (mode == "prune only")
        assert gs.stops[-1] is None
        assert (got.stop < conf.n_layers) == (mode == "adaptive")
        assert (got.prune0 < got.stop).any()
