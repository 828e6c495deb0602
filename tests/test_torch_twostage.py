"""Two-stage compaction of lightglue_tpu_torch (``compaction_bucket`` > 0)
against the JAX package on the CPU, on the same seeded numpy inputs and the
same weights.

``forward_adaptive_twostage`` and ``forward``'s dispatch at the sizes of
tests/test_adaptive_compact.py (random JAX weights carried across), one
overflow case (more survivors than the bucket holds, so the matchability
order decides which stay), and the full-width trained matcher at 1024
keypoints with prefix 3, bucket 640 and shift 12 (the JAX bench's
headline configuration at that size): in fp32 matches, ``stop`` and
``prune`` exactly equal and scores within 1e-4; at ``mp=True`` against the
JAX matcher at mp under the bars of tests/test_torch_mp.py (matches0 and
prune equal on >= 99 %, stop equal, score gap <= 3e-2). ``BatchMatcher``
with a compaction bucket on the CPU, and the CUDA graph runner's two-stage
graph set (each capture recorded as a Python call, each replay rerunning
it into the captured tensors), equal to the bit to the eager forward.
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_serving import _planted, recorded_graphs  # noqa: F401

from lightglue_tpu import configs as jconfigs
from lightglue_tpu import weights as jweights
from lightglue_tpu.models import lightglue as jlg
from lightglue_tpu_torch import BatchMatcher, _build, configs, weights
from lightglue_tpu_torch.models import lightglue as lg
from lightglue_tpu_torch.parallel import batching, graphs
from lightglue_tpu_torch.synthetic import planted_pairs
from lightglue_tpu_torch.utils import diagnostics

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "weights", "synthetic_superpoint_lightglue.npz")
# tests/test_adaptive_compact.py's configuration: keep threshold 0.6, about
# half the points pruned at each layer
AGGRESSIVE = dict(depth_confidence=-1.0, width_confidence=0.4,
                  pruning_min_kpts=-1, filter_threshold=0.0)
_jit_forward = jax.jit(jlg.forward, static_argnames=("conf",))
_jit_twostage = jax.jit(jlg.forward_adaptive_twostage,
                        static_argnames=("conf", "n_prefix", "bucket"))


def _inputs(seed, b, m, n):
    """tests/test_adaptive_compact.py's inputs, as numpy."""
    rng = np.random.default_rng(seed)
    return dict(
        kpts0=rng.uniform(0, 640, (b, m, 2)).astype(np.float32),
        kpts1=rng.uniform(0, 480, (b, n, 2)).astype(np.float32),
        desc0=rng.standard_normal((b, m, 256)).astype(np.float32),
        desc1=rng.standard_normal((b, n, 256)).astype(np.float32),
        size0=np.tile(np.float32([[640.0, 480.0]]), (b, 1)),
        size1=np.tile(np.float32([[640.0, 480.0]]), (b, 1)),
    )


def _j(args):
    return {k: jnp.asarray(v) for k, v in args.items()}


def _t(args):
    return {k: torch.as_tensor(v) for k, v in args.items()}


def _random(over):
    """The JAX init (key 0) and the same weights in the port's tree."""
    jconf = jconfigs.lightglue_config("superpoint", **over)
    jparams = jlg.init_params(jax.random.key(0), jconf)
    conf = configs.lightglue_config("superpoint", **over)
    return jparams, weights.from_jax_params(jweights.flatten_tree(jparams),
                                            conf), conf


def _equal(got, want, score_tol=1e-4):
    for f in ("matches0", "matches1", "prune0", "prune1"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert got.stop == int(want.stop)
    for f in ("matching_scores0", "matching_scores1"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   atol=score_tol, rtol=0, err_msg=f)


def test_twostage_vs_jax():
    """tests/test_adaptive_compact.py:30's case: B 2, 96 points, prefix 3,
    bucket 64; and the port's two-stage path equal to its own masked
    adaptive path there, as the JAX test holds JAX's."""
    jparams, params, conf = _random(AGGRESSIVE)
    args = _inputs(2, 2, 96, 96)
    want = _jit_twostage(jparams, jconfigs.lightglue_config(
        "superpoint", **AGGRESSIVE), 3, 64, **_j(args))
    got = lg.forward_adaptive_twostage(params, conf, 3, 64, **_t(args))
    _equal(got, want)
    masked = lg.forward(params, conf, **_t(args))
    surv = (masked.prune0 == masked.prune0.max()).sum(1)
    assert int(surv.max()) <= 64
    for f in ("matches0", "matches1", "prune0"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(masked, f).numpy(), err_msg=f)


def test_forward_dispatch_vs_jax():
    """tests/test_adaptive_compact.py:62's case through ``forward`` with
    compaction_bucket 64, prefix 3; a batch at the bucket's own size takes
    the masked adaptive path, as in JAX."""
    over = dict(AGGRESSIVE, compaction_bucket=64, compaction_prefix=3)
    jparams, params, conf = _random(over)
    jconf = jconfigs.lightglue_config("superpoint", **over)
    args = _inputs(5, 1, 96, 96)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", diagnostics.DegradedModeWarning)
        got = lg.forward(params, conf, **_t(args))
    _equal(got, _jit_forward(jparams, jconf, **_j(args)))
    direct = lg.forward_adaptive_twostage(params, conf, 3, 64, **_t(args))
    for f in lg.MatchOutput._fields:
        a, b = getattr(got, f), getattr(direct, f)
        assert (a == b) if isinstance(a, int) else torch.equal(a, b), f
    assert lg.twostage(conf, 96, 96) and not lg.twostage(conf, 64, 96)
    assert not lg.twostage(conf.replace(width_confidence=-1.0), 96, 96)
    small = _inputs(6, 1, 64, 64)
    _equal(lg.forward(params, conf, **_t(small)),
           _jit_forward(jparams, jconf, **_j(small)))


def test_overflow_keeps_the_most_matchable_as_jax():
    """More points survive the prefix than the bucket holds: the
    (inactive, -matchability) order decides which are kept, and the
    outputs, dropped points included, equal JAX's."""
    over = dict(AGGRESSIVE, width_confidence=0.9)  # keep matchability > 0.1
    jparams, params, conf = _random(over)
    args = _inputs(7, 2, 128, 112)
    st = lg.forward_prefix(params, conf, 2, **_t(args))
    survivors = st.state.act0.sum(1).min(), st.state.act1.sum(1).min()
    bucket = 48
    assert min(int(s) for s in survivors) > bucket, survivors
    want = _jit_twostage(jparams, jconfigs.lightglue_config(
        "superpoint", **over), 2, bucket, **_j(args))
    got = lg.forward_adaptive_twostage(params, conf, 2, bucket, **_t(args))
    _equal(got, want)
    small, ind0, _ = lg.compact(params, conf, st.state, 2, bucket)
    la = lg.nn.index_params(params["log_assignment"], 1)
    sc = lg.asg.get_matchability(la, st.state.desc0.float())
    kept = torch.take_along_dim(sc, ind0, 1)
    dropped = sc.masked_fill(
        torch.zeros_like(st.state.act0).scatter(1, ind0, True)
        | ~st.state.act0, -1.0)
    assert (kept.min(1).values >= dropped.max(1).values).all()
    assert small.act0.all()
    # the points not in the bucket come back unmatched, at the prefix depth
    out0 = torch.ones_like(st.state.act0).scatter(1, ind0, False)
    assert (got.matches0[out0] == -1).all()
    assert torch.equal(got.prune0[out0], st.state.prune0[out0])


@pytest.fixture(scope="module")
def trained():
    """The trained npz in both packages and 1024 planted keypoints, B 1,
    with padded tails (the JAX bench's headline size)."""
    pr = planted_pairs(np.random.default_rng(60), 1, 1024)
    mask0 = np.ones((1, 1024), bool)
    mask1 = np.ones((1, 1024), bool)
    mask0[0, 1000:] = False
    mask1[0, 990:] = False
    args = dict(kpts0=pr["keypoints0"], kpts1=pr["keypoints1"],
                desc0=pr["descriptors0"], desc1=pr["descriptors1"],
                size0=pr["image_size"], size1=pr["image_size"],
                mask0=mask0, mask1=mask1)
    return (jweights.load_params(NPZ, dtype=np.float32),
            weights.load_params(NPZ), args)


HEADLINE = dict(compaction_bucket=640, compaction_prefix=3,
                self_softmax_shift=12.0, cross_softmax_shift=12.0)


@pytest.mark.parametrize("mp", [False, True])
def test_full_width_trained_vs_jax(trained, mp):
    """1024 keypoints, prefix 3, bucket 640, shift 12 (JAX on the CPU runs
    its exact XLA softmax; the shift moves no result there): fp32 exactly
    equal, mp under test_matcher_mp_vs_jax_mp's bars."""
    jparams, params, args = trained
    conf = configs.lightglue_config("superpoint", mp=mp, **HEADLINE)
    assert lg.twostage(conf, 1024, 1024)
    want = _jit_forward(jparams, jconfigs.lightglue_config(
        "superpoint", mp=mp, **HEADLINE), **_j(args))
    got = lg.forward(params, conf, **_t(args))
    assert got.stop >= conf.compaction_prefix
    if not mp:
        _equal(got, want)
        return
    m0, wm0 = got.matches0.numpy(), np.asarray(want.matches0)
    assert float((m0 == wm0).mean()) >= 0.99
    assert got.stop == int(want.stop)
    for f in ("prune0", "prune1"):
        agree = float((getattr(got, f).numpy()
                       == np.asarray(getattr(want, f))).mean())
        assert agree >= 0.99, f"{f} equal on {agree:.4f}"
    both = (m0 >= 0) & (wm0 >= 0)
    gap = np.abs(got.matching_scores0.numpy()
                 - np.asarray(want.matching_scores0))[both]
    assert both.sum() > 100 and gap.max() <= 3e-2, f"score gap {gap.max():.3e}"


def _same_as_forward(bm, conf, pairs, results):
    seen = set()
    for chunk, f0, f1 in bm.padded_batches(pairs):
        seen.add(f0["keypoints"].shape[1])
        inp = batching.batch_inputs(conf, f0, f1)
        want = lg.forward(bm.params, conf, **{
            k: None if v is None else torch.from_numpy(v)
            for k, v in inp.items()})
        for j, i in enumerate(chunk):
            k0 = pairs[i][0]["keypoints"].shape[0]
            for f in ("matches0", "matching_scores0"):
                np.testing.assert_array_equal(
                    results[i][f], getattr(want, f)[j, :k0].numpy(), f)
            assert results[i]["stop"] == want.stop
    return seen


@pytest.mark.parametrize("mp", [False, True])
def test_batch_matcher_twostage_equals_eager(mp):
    """BatchMatcher on the CPU with compaction bucket 96 over buckets 64
    (masked adaptive) and 128 (two-stage), the trained npz: each pair
    equal to the bit to models.lightglue.forward on its padded batch."""
    conf = configs.lightglue_config("superpoint", mp=mp, pruning_min_kpts=32,
                                    compaction_bucket=96, compaction_prefix=2)
    params = weights.load_params(NPZ)
    rng = np.random.default_rng(61)
    pairs = (_planted(planted_pairs(rng, 2, 64), (64, 50))
             + _planted(planted_pairs(rng, 3, 128), (128, 120, 100)))
    bm = BatchMatcher(conf, params, buckets=(64, 128), max_batch=4,
                      device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", diagnostics.DegradedModeWarning)
        results = bm.match_pairs(pairs)
        assert _same_as_forward(bm, conf, pairs, results) == {64, 128}


@pytest.mark.parametrize("depth", [0.95, 0.5, -1.0])
def test_graph_runner_twostage_replays_like_forward(recorded_graphs, depth):
    """The two-stage graph set: prefix segments, the compaction graph,
    suffix segments and exits with the scatter back, against
    models.lightglue.forward to the bit, twice; with depth 0.5 the loop
    stops inside the prefix (an exit with its own compaction), with 0.95
    after it, with -1 never."""
    conf = configs.lightglue_config(
        "superpoint", depth_confidence=depth, pruning_min_kpts=32,
        compaction_bucket=96, compaction_prefix=3)
    params = weights.load_params(NPZ)
    bm = BatchMatcher(conf, params, buckets=(128,), max_batch=4, device="cpu")
    bm._matcher = gm = graphs.GraphMatcher(conf, bm.params,
                                           torch.device("cpu"))
    pairs = _planted(planted_pairs(np.random.default_rng(62), 3, 128),
                     (128, 112, 100))
    _build.reset_launch_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", diagnostics.DegradedModeWarning)
        for _ in range(2):
            results = bm.match_pairs(pairs)
            _same_as_forward(bm, conf, pairs, results)
            for chunk, f0, f1 in bm.padded_batches(pairs):
                got = bm.match_batch(f0, f1)
                inp = batching.batch_inputs(conf, f0, f1)
                want = lg.forward(bm.params, conf, **{
                    k: None if v is None else torch.from_numpy(v)
                    for k, v in inp.items()})
                for f in graphs.OUTPUTS:
                    np.testing.assert_array_equal(
                        getattr(got, f), getattr(want, f).numpy(), err_msg=f)
                assert got.stop == want.stop
    gs = next(iter(gm.sets.values()))
    assert len(gm.sets) == 1 and gs.prefix == 3
    assert len(gs.compaction) == 1 and len(gs.compacted) == 1
    assert gs.states[2].desc0.shape[1] == 128
    assert gs.states[3].desc0.shape[1] == 96
    # segments up to the stop, the compaction once the prefix has run, an exit
    graphs_run = got.stop + (got.stop >= 3) + 1
    assert _build.launch_counts()["fused_filter_matches"] == 4 * graphs_run
    assert {0.95: 3 <= got.stop < 9, 0.5: got.stop < 3,
            -1.0: got.stop == 9}[depth], got.stop
