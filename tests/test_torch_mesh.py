"""The port's data-parallel mesh (lightglue_tpu_torch.parallel.mesh and the
``mesh=`` paths) against the JAX package's mesh on the 8 virtual CPU
devices of tests/conftest.py, the port's slots CPU devices.

The matcher is the trained npz cut to its first 3 layers (at 64 keypoints,
composed blocks, as the port's tests run the JAX matcher), so that the
confidence heads are trained and the adaptive stop means something; the
windowed pipeline and the training step run as tests/test_end_to_end.py
and tests/test_torch_train.py run them. Tolerances: matches0, matches1,
stop, prune0 and prune1 exactly equal, matching scores within 1e-5; the
training step's loss within 1e-5 relative and each leaf's gradient within
1e-4 of its largest |grad| (tests/test_torch_train.py's); pipeline
keypoints and matches exact, descriptors within 1e-5, keypoint scores
within 2e-5 (tests/test_torch_sequence.py's).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu import configs as jconfigs
from lightglue_tpu import end_to_end as jend_to_end
from lightglue_tpu import train as jtrain
from lightglue_tpu import weights as jweights
from lightglue_tpu.models import lightglue as jlg
from lightglue_tpu.models import superpoint as jsp
from lightglue_tpu.parallel import batching as jbatching
from lightglue_tpu.parallel import mesh as jmesh
from lightglue_tpu_torch import BatchMatcher, configs, end_to_end, nn, weights
from lightglue_tpu_torch import train as T
from lightglue_tpu_torch.models import lightglue as lg
from lightglue_tpu_torch.models import superpoint as sp
from lightglue_tpu_torch.parallel import batching
from lightglue_tpu_torch.parallel import mesh as mesh_lib
from lightglue_tpu_torch.synthetic import planted_pairs
from test_torch_serving import recorded_graphs  # noqa: F401

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "weights", "synthetic_superpoint_lightglue.npz")
LAYERS = 3
BLOCKS = dict(fused_self=False, fused_cross=False)
MODES = {"fixed": dict(depth_confidence=-1.0, width_confidence=-1.0),
         "adaptive": dict(pruning_min_kpts=16)}
K = 64
OUTPUTS = ("matches0", "matches1", "prune0", "prune1")


def cpu_mesh(n, shape=None):
    names = ("dcn", "data") if shape else ("data",)
    return mesh_lib.make_mesh(devices=["cpu"] * n, axis_names=names,
                              shape=shape)


def jax_mesh(n, shape=None):
    if shape:
        return jmesh.make_mesh(n, axis_names=("dcn", "data"), shape=shape)
    return jmesh.make_mesh(n)


@pytest.fixture(scope="module")
def flat3():
    """The trained npz's first LAYERS layers (float32)."""
    with np.load(NPZ) as f:
        flat = {k: f[k].astype(np.float32) for k in f.files}
    for k, v in flat.items():
        if k.startswith(("transformers/", "log_assignment/")):
            flat[k] = v[:LAYERS]
        elif k.startswith("token_confidence/"):
            flat[k] = v[:LAYERS - 1]
    return flat


def confs(**over):
    over = dict(n_layers=LAYERS, **BLOCKS, **over)
    return (configs.lightglue_config("superpoint", **over),
            jconfigs.lightglue_config("superpoint", **over))


def trees(flat, conf):
    return weights.from_jax_params(flat, conf), jweights.unflatten_tree(flat)


def feature_batches(seed, b=8, counts=None):
    """Planted pairs as two padded batches (image 0 of pair i cut to
    ``counts[i]`` valid keypoints)."""
    pr = planted_pairs(np.random.default_rng(seed), b, K)
    valid = np.ones((b, K), bool)
    for i, c in enumerate(counts or ()):
        valid[i, c:] = False

    def side(s, v):
        return {"keypoints": pr[f"keypoints{s}"],
                "descriptors": pr[f"descriptors{s}"], "valid": v,
                "image_size": pr["image_size"]}
    return side(0, valid), side(1, np.ones((b, K), bool))


def same_output(got, want, tol=1e-5):
    for f in OUTPUTS:
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert got.stop == int(want.stop)
    for f in ("matching_scores0", "matching_scores1"):
        np.testing.assert_allclose(getattr(got, f),
                                   np.asarray(getattr(want, f)), atol=tol,
                                   rtol=0, err_msg=f)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("shape", [None, (2, 4)])
def test_match_feature_batch_over_a_mesh(flat3, mode, shape):
    """8 slots (1-D and the (2, 4) hosts x chips layout) against the JAX
    mesh's result and the port's one-slot result."""
    conf, jconf = confs(**MODES[mode])
    params, jparams = trees(flat3, conf)
    f0, f1 = feature_batches(3, counts=(64, 40, 64, 52, 64, 64, 30, 64))
    got = batching.match_feature_batch(params, conf, f0, f1,
                                       mesh=cpu_mesh(8, shape))
    want = jbatching.match_feature_batch(jparams, jconf, f0, f1,
                                         mesh=jax_mesh(8, shape))
    same_output(got, want)
    one = batching.match_feature_batch(params, conf, f0, f1, device="cpu")
    same_output(got, one)
    assert (got.matches0 >= 0).sum() > 100
    if mode == "adaptive":
        assert (got.prune0 < got.stop).any()


def shard_ratios(params, conf, f0, f1, slots, layer):
    """Each slot's own stop ratio after ``layer`` (1 - unconfident /
    valid over its rows), and the pooled one, from the port's layers."""
    kw = batching.batch_inputs(conf, f0, f1)
    kw = {k: None if v is None else torch.from_numpy(v) for k, v in kw.items()}
    counts = []
    for a, b in mesh_lib.row_bounds(f0["keypoints"].shape[0], slots):
        s = lg.adaptive_start(params, conf, **{
            k: None if v is None else v[a:b] for k, v in kw.items()})
        fused = lg._block_weights(params, conf)
        for i in range(layer + 1):
            s, _, c = lg.adaptive_layer(params, conf, i, s, fused)
        counts.append(c.tolist())
    own = [1 - u / n for u, n in counts]
    pooled = 1 - sum(u for u, _ in counts) / sum(n for _, n in counts)
    return own, pooled


@pytest.mark.parametrize("case", ["pooled goes on", "pooled stops"])
def test_the_stop_pools_over_every_slot(flat3, case):
    """A planted batch whose slots would decide otherwise alone: the depth
    confidence is set between one slot's own ratio after layer 1 and the
    pooled ratio, so that slot alone stops after layer 2 and the pooled
    batch runs all 3 ("pooled goes on"), or the reverse. The 8-slot mesh
    and JAX's 8-device mesh follow the pooled count."""
    conf, _ = confs(**MODES["adaptive"])
    params, jparams = trees(flat3, conf)
    f0, f1 = feature_batches(0)
    own, pooled = shard_ratios(params, conf, f0, f1, 8, layer=1)
    k = int(np.argmax(own) if case == "pooled goes on" else np.argmin(own))
    assert abs(own[k] - pooled) > 0.01, (own, pooled)
    dc = (own[k] + pooled) / 2
    conf, jconf = confs(**MODES["adaptive"], depth_confidence=dc)
    got = batching.match_feature_batch(params, conf, f0, f1,
                                       mesh=cpu_mesh(8))
    want = jbatching.match_feature_batch(jparams, jconf, f0, f1,
                                         mesh=jax_mesh(8))
    same_output(got, want)
    alone = batching.match_feature_batch(
        params, conf, *({k_: v[k:k + 1] for k_, v in f.items()}
                        for f in (f0, f1)), device="cpu")
    if case == "pooled goes on":
        assert (got.stop, alone.stop) == (3, 2)
    else:
        assert (got.stop, alone.stop) == (2, 3)


def ragged_pairs(seed, n=13):
    rng = np.random.default_rng(seed)

    def feats(k):
        return {"keypoints": rng.uniform(0, 64, (k, 2)).astype(np.float32),
                "descriptors": rng.standard_normal((k, 256)).astype(np.float32),
                "image_size": np.array([64.0, 48.0], np.float32)}
    return [(feats(40 + i), feats(60 - i)) for i in range(n)]


@pytest.mark.parametrize("slots", [8, 3])
def test_batch_matcher_ragged_over_a_mesh(flat3, slots):
    """13 ragged pairs (the JAX dry run's) over 8 and 3 slots: the batch
    rounded to 16 and 18 with copies of the first pair, which count in the
    pooled stop, each pair's results in input order as the JAX
    BatchMatcher's over the same mesh."""
    conf, jconf = confs(**MODES["adaptive"], filter_threshold=0.0)
    params, jparams = trees(flat3, conf)
    bm = BatchMatcher(conf, params, buckets=(64,), max_batch=16,
                      mesh=cpu_mesh(slots))
    jbm = jbatching.BatchMatcher(jconf, jparams, mesh=jax_mesh(slots),
                                 buckets=(64,), max_batch=16)
    assert bm._round_batch(13, 16) == jbm._round_batch(13, 16) == (
        16 if slots == 8 else 18)
    pairs = ragged_pairs(5)
    got, want = bm.match_pairs(pairs), jbm.match_pairs(pairs)
    assert len(got) == 13
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["matches0"].shape == (40 + i,)
        for f in ("matches", "matches0", "matches1"):
            np.testing.assert_array_equal(g[f], np.asarray(w[f]), err_msg=f)
        assert g["stop"] == w["stop"]
        np.testing.assert_allclose(g["matching_scores0"],
                                   np.asarray(w["matching_scores0"]),
                                   atol=1e-5, rtol=0)
    # the dummies count: the 13 pairs alone pool to another batch
    solo = BatchMatcher(conf, params, buckets=(64,), max_batch=16,
                        device="cpu")
    assert got[0]["stop"] == solo.match_pairs(pairs + pairs[:3])[0]["stop"]


@pytest.mark.parametrize("compact", [False, True])
def test_graph_slots_pool_the_stop(recorded_graphs, flat3, compact):
    """The card's runner over 4 slots (graphs recorded as calls, as
    tests/test_torch_serving.py records them): every slot replays each
    layer, the host pools the slots' counts and every slot replays the
    next layer or the exit; the outputs equal the eager forward on the
    whole batch, each slot counts its own replays. With compaction (prefix
    1, bucket 48) the compaction graph keeps its place."""
    over = dict(MODES["adaptive"], compaction_bucket=48 if compact else 0,
                compaction_prefix=1)
    conf, _ = confs(**over)
    params, _ = trees(flat3, conf)
    runner = batching.MeshGraphMatcher(conf, [params] * 4,
                                       [torch.device("cpu")] * 4)
    f0, f1 = feature_batches(0)
    inputs = batching.batch_inputs(conf, f0, f1)
    for _ in range(2):
        got = runner(inputs)
        want = lg.forward(params, conf, **{
            k: None if v is None else torch.from_numpy(v)
            for k, v in inputs.items()})
        same_output(got, lg.MatchOutput(*(
            f if isinstance(f, int) else f.numpy() for f in want)), tol=0)
    replays = got.stop + (compact and got.stop >= 1) + 1
    assert runner.launches == [{"fused_filter_matches": 2 * replays}] * 4
    assert [len(s.sets) for s in runner.slots] == [1] * 4
    assert next(iter(runner.slots[0].sets)).batch == 2


def test_train_step_over_a_mesh(flat3):
    """One data-parallel step over 4 slots against JAX's value_and_grad
    jitted over a 4-device mesh (the JAX dry run's form): the loss and
    every leaf's gradient. The slots hold unequal matches, so a mean of
    the slots' own losses is not the batch's; the mesh's is."""
    over = dict(n_layers=2, flash=False, mp=False, depth_confidence=-1.0,
                width_confidence=-1.0, compaction_bucket=0)
    jconf = jconfigs.lightglue_config("superpoint", **over)
    conf = configs.lightglue_config("superpoint", **over)
    jp = jax.jit(lambda k: jlg.init_params(k, jconf))(jax.random.key(1))
    jb = jax.jit(lambda k: jtrain.synthetic_batch(k, 8, 32))(jax.random.key(2))
    jm = jax_mesh(4)
    data = jax.sharding.NamedSharding(jm, jax.sharding.PartitionSpec("data"))
    repl = jax.sharding.NamedSharding(jm, jax.sharding.PartitionSpec())
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, d: jtrain.matcher_loss(p, jconf, d), has_aux=True))(
            jax.device_put(jp, repl), jax.tree.map(
                lambda a: None if a is None else jax.device_put(a, data), jb))
    flat = {k: np.asarray(v) for k, v in
            jweights.flatten_tree(jax.device_get(jp)).items()}
    batch = T.SyntheticBatch(*(None if a is None else torch.from_numpy(
        np.array(a)) for a in jb))
    mesh = cpu_mesh(4)
    matched = [int((p.gt_matches0 >= 0).sum())
               for p in mesh_lib.shard_rows(mesh, batch)]
    assert len(set(matched)) > 1, matched

    params = weights.from_jax_params(flat, conf)
    for t in T.leaves(params):
        t.requires_grad_(True)
    aux = T.mesh_backward({torch.device("cpu"): params}, conf, batch, mesh)
    rel = abs(float(aux["loss"]) - float(jloss)) / abs(float(jloss))
    assert rel <= 1e-5, rel
    got = weights.flatten_params(nn.map_params(params, lambda t: t.grad))
    want = {k: np.asarray(v) for k, v in
            jweights.flatten_tree(jax.device_get(jgrads)).items()}
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= 1e-4 * np.abs(w).max(), k
    own = np.mean([float(T.matcher_loss(weights.from_jax_params(flat, conf),
                                        conf, p)[0])
                   for p in mesh_lib.shard_rows(mesh, batch)])
    # ten times the tolerance the mesh's loss is held to
    assert abs(own - float(jloss)) / abs(float(jloss)) > 1e-4


@pytest.mark.parametrize("slots", [1, 4])
def test_feed_steps_over_a_mesh(flat3, slots):
    """Three optimizer steps over 4 slots against three steps without a
    mesh (parameters within 1e-5); a one-slot mesh is the step without
    one, to the bit."""
    over = dict(n_layers=2, flash=False, mp=False, depth_confidence=-1.0,
                width_confidence=-1.0, compaction_bucket=0)
    conf = configs.lightglue_config("superpoint", **over)
    init = lg.init_params(conf, torch.Generator().manual_seed(3))
    runs = []
    for mesh in (None, cpu_mesh(slots)):
        params = nn.map_params(init, lambda t: t.clone())
        step = T.make_feed_train_step(conf, T.make_optimizer(params, 2e-4, 10),
                                      mesh)
        gen = torch.Generator().manual_seed(4)
        losses = [float(step(T.synthetic_batch(gen, 8, 32))["loss"])
                  for _ in range(3)]
        runs.append((losses, weights.flatten_params(params)))
    (l0, p0), (l1, p1) = runs
    tol = 0 if slots == 1 else 1e-5
    np.testing.assert_allclose(l1, l0, rtol=tol, atol=0)
    for k in p0:
        np.testing.assert_allclose(p1[k], p0[k], rtol=0, atol=tol, err_msg=k)
    assert max(np.abs(p1[k] - weights.flatten_params(init)[k]).max()
               for k in p0) > 1e-5


@pytest.fixture(scope="module")
def pipelines():
    """SuperPoint (the JAX init, key 0, conv weights times 3, as
    tests/test_torch_sequence.py) into the 3-layer matcher; the port's and
    JAX's windowed programs, window 2."""
    jflat = jweights.flatten_tree(jsp.init_params(jax.random.key(0)))
    sflat = {k: np.asarray(v) * (3.0 if k.endswith("/w") else 1.0)
             for k, v in jflat.items()}
    with np.load(NPZ) as f:
        mflat = {k: f[k].astype(np.float32) for k in f.files}
    for k, v in mflat.items():
        if k.startswith(("transformers/", "log_assignment/")):
            mflat[k] = v[:LAYERS]
        elif k.startswith("token_confidence/"):
            mflat[k] = v[:LAYERS - 1]
    sconf = configs.SuperPointConfig(max_num_keypoints=K)
    jsconf = jconfigs.SuperPointConfig(max_num_keypoints=K)

    def build(mode, mesh=None, name="make_windowed_sequence_end_to_end",
              **kw):
        conf, jconf = confs(**MODES[mode], filter_threshold=0.0)
        port = getattr(end_to_end, name)(
            sp.forward, weights.superpoint_from_jax_params(sflat), sconf,
            weights.from_jax_params(mflat, conf), conf, mesh=mesh, **kw)
        jrun = getattr(jend_to_end, name)(
            jsp.forward, jweights.unflatten_tree(sflat), jsconf,
            jweights.unflatten_tree(mflat), jconf, **kw)
        return port, jrun
    return build


@pytest.mark.parametrize("slots,mode", [(8, "adaptive"), (3, "fixed")])
def test_windowed_pipeline_over_a_mesh(pipelines, mode, slots):
    """tests/test_end_to_end.py:88's pipeline (8 frames, window 2: 13
    pairs across block boundaries) over 8 slots, adaptive, and 3 slots
    (uneven blocks), fixed, against JAX's program under its 8-device mesh,
    and the 8-slot run against the port's unsharded run; each slot
    extracts and matches its own blocks."""
    port, jrun = pipelines(mode, cpu_mesh(slots), window=2)
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 1, (8, 64, 80, 1)).astype(np.float32)
    sizes = np.tile([[80.0, 64.0]], (8, 1)).astype(np.float32)
    got = port(torch.from_numpy(imgs), torch.from_numpy(sizes))
    jm = jax_mesh(8)
    shard = jax.sharding.NamedSharding(jm, jax.sharding.PartitionSpec("data"))
    with jm:
        want = jrun(jax.device_put(jnp.asarray(imgs), shard),
                    jax.device_put(jnp.asarray(sizes), shard))
    assert got.matches.matches0.shape == (13, K)
    for side in ("feats0", "feats1"):
        g, w = getattr(got, side), getattr(want, side)
        np.testing.assert_array_equal(g.keypoints.numpy(),
                                      np.asarray(w.keypoints))
        np.testing.assert_array_equal(g.valid.numpy(), np.asarray(w.valid))
        np.testing.assert_allclose(g.descriptors.numpy(),
                                   np.asarray(w.descriptors), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(g.keypoint_scores.numpy(),
                                   np.asarray(w.keypoint_scores), atol=2e-5,
                                   rtol=0)
    same_output(lg.MatchOutput(*(f if isinstance(f, int) else f.numpy()
                                 for f in got.matches)), want.matches)
    assert (got.matches.matches0 >= 0).sum() > 50
    # SuperPoint's and the matcher's work on every slot
    for k, counts in enumerate(port.launches):
        assert counts.get("fused_stem", 0) == 0  # the CPU runs plain versions
    if slots == 8:
        flat, _ = pipelines(mode, window=2)
        one = flat(torch.from_numpy(imgs), torch.from_numpy(sizes))
        for f in OUTPUTS:
            assert torch.equal(getattr(got.matches, f), getattr(one.matches, f))
        assert got.matches.stop == one.matches.stop


@pytest.mark.parametrize("name,slots", [("make_end_to_end", 2),
                                        ("make_sequence_end_to_end", 3)])
def test_pair_and_sequence_pipelines_over_a_mesh(pipelines, name, slots):
    """make_end_to_end (3 pairs over 2 slots: blocks of 2 and 1) and
    make_sequence_end_to_end (5 frames, 4 pairs over 3 slots) with the
    adaptive matcher, against the same program without a mesh: features
    and matches equal."""
    mesh_run, _ = pipelines("adaptive", cpu_mesh(slots), name)
    one, _ = pipelines("adaptive", None, name)
    rng = np.random.default_rng(1)
    imgs = torch.from_numpy(rng.uniform(0, 1, (6, 64, 80, 1)).astype(np.float32))
    sizes = torch.tensor([[80.0, 64.0]] * 6)
    args = ((imgs[:3], imgs[3:], sizes[:3], sizes[3:]) if slots == 2
            else (imgs[:5], sizes[:5]))
    got, want = mesh_run(*args), one(*args)
    for side in ("feats0", "feats1"):
        for f in ("keypoints", "valid"):
            assert torch.equal(getattr(getattr(got, side), f),
                               getattr(getattr(want, side), f)), (side, f)
    for f in OUTPUTS:
        assert torch.equal(getattr(got.matches, f), getattr(want.matches, f)), f
    assert got.matches.stop == want.matches.stop
    assert (got.matches.matches0 >= 0).sum() > 20
    assert all(c == {} for c in mesh_run.launches)  # the CPU: plain versions


def test_mesh_errors_and_one_slot():
    """A mesh naming a card that is not there raises, as do a 2-axis mesh
    without a shape, a shape that does not fit and a batch that does not
    divide; a one-slot mesh is the runner on its device."""
    with pytest.raises(ValueError, match="cuda:1"):
        mesh_lib.make_mesh(devices=["cpu", "cuda:1"])
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no CUDA device"):
            mesh_lib.make_mesh()
    with pytest.raises(ValueError, match="explicit shape"):
        mesh_lib.make_mesh(devices=["cpu"] * 4, axis_names=("dcn", "data"))
    with pytest.raises(ValueError, match="shape"):
        mesh_lib.make_mesh(devices=["cpu"] * 4, shape=(3,))
    with pytest.raises(ValueError, match="asked"):
        mesh_lib.make_mesh(5, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="does not divide"):
        mesh_lib.row_bounds(13, 4)
    assert mesh_lib.row_bounds(13, 3, even=False) == [(0, 5), (5, 9), (9, 13)]
    m = cpu_mesh(8, (2, 4))
    assert m.shape == {"dcn": 2, "data": 4} and m.distinct == [torch.device("cpu")]
    t = torch.zeros(3)
    assert mesh_lib.gather([t]) is t  # one part as it is
    assert mesh_lib.params_mesh({"a": {"b": t}}) == cpu_mesh(1)
    assert mesh_lib.replicate(cpu_mesh(2), None) == {torch.device("cpu"): None}
    assert hash(m) == hash(cpu_mesh(8, (2, 4))) and m != cpu_mesh(8)
    conf = configs.lightglue_config("superpoint", n_layers=2)
    params = lg.init_params(conf, torch.Generator().manual_seed(0))
    one = batching.make_batched_matcher(conf, params, "cuda", cpu_mesh(1))
    assert isinstance(one, batching.EagerMatcher) and one.devices == [
        torch.device("cpu")]
    f0, f1 = feature_batches(1, b=4)
    with pytest.raises(ValueError, match="does not divide"):
        batching.match_feature_batch(params, conf, f0, f1, mesh=cpu_mesh(3))
    pairs = ragged_pairs(2, 5)
    a = BatchMatcher(conf, params, buckets=(64,), max_batch=4,
                     mesh=cpu_mesh(1)).match_pairs(pairs)
    b = BatchMatcher(conf, params, buckets=(64,), max_batch=4,
                     device="cpu").match_pairs(pairs)
    for x, y in zip(a, b):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_mesh_paths_run_without_jax():
    """parallel.mesh and the mesh= paths (BatchMatcher, match_feature_batch,
    a training step, the windowed pipeline) over CPU slots with JAX
    blocked."""
    code = (
        "import sys; sys.modules['jax'] = None; "
        "import numpy as np, torch; "
        "from lightglue_tpu_torch import BatchMatcher, configs, end_to_end; "
        "from lightglue_tpu_torch import train as T; "
        "from lightglue_tpu_torch.models import lightglue as lg, superpoint as sp; "
        "from lightglue_tpu_torch.parallel import mesh as M; "
        "m = M.make_mesh(devices=['cpu', 'cpu']); "
        "conf = configs.lightglue_config('superpoint', n_layers=2); "
        "p = lg.init_params(conf, torch.Generator().manual_seed(0)); "
        "r = np.random.default_rng(0); "
        "f = lambda n: {'keypoints': r.uniform(0, 64, (n, 2)).astype(np.float32), "
        "'descriptors': r.standard_normal((n, 256)).astype(np.float32)}; "
        "out = BatchMatcher(conf, p, buckets=(32,), max_batch=4, mesh=m)"
        ".match_pairs([(f(20), f(30)) for _ in range(3)]); "
        "assert len(out) == 3; "
        "tc = conf.replace(flash=False, depth_confidence=-1.0, width_confidence=-1.0); "
        "tp = lg.init_params(tc, torch.Generator().manual_seed(1)); "
        "step = T.make_feed_train_step(tc, T.make_optimizer(tp, 2e-4, 10), m); "
        "step(T.synthetic_batch(torch.Generator().manual_seed(2), 2, 16)); "
        "sc = configs.SuperPointConfig(max_num_keypoints=16); "
        "run = end_to_end.make_windowed_sequence_end_to_end(sp.forward, "
        "sp.init_params(sc, torch.Generator().manual_seed(3)), sc, p, conf, "
        "window=2, mesh=m); "
        "e = run(torch.rand(4, 32, 40, 1), torch.tensor([[40.0, 32.0]] * 4)); "
        "assert e.matches.matches0.shape == (5, 16); "
        "bad = [k for k, mod in sys.modules.items() if mod is not None "
        "and k.split('.')[0] in ('jax', 'lightglue_tpu')]; "
        "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=300)
