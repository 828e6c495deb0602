"""lightglue_tpu_torch.train against the JAX trainer (lightglue_tpu/train.py)
on the CPU: the same parameters (the JAX init carried across by
weights.from_jax_params) and the same batches (JAX's synthetic_batch as
numpy) through both, at 2 layers of the superpoint preset and of the sift
preset (input projection 128 -> 256, scales and orientations), B 2, m 32.

Tolerances: assignment_nll within 1e-6; loss, nll and confidence_bce
within 1e-5 relative; each leaf's gradient within 1e-4 of that leaf's
largest |grad|; three optimizer steps (optax's chain, steps=10, so warmup
2 and step 0's rate 0) with the parameters within 1e-5 after each. The
JAX side is jitted once per preset in module-scoped fixtures."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from lightglue_tpu import train as jtrain
from lightglue_tpu import weights as jweights
from lightglue_tpu.configs import lightglue_config as jax_lightglue_config
from lightglue_tpu.models import lightglue as jlg

from lightglue_tpu_torch import LightGlue, nn
from lightglue_tpu_torch import train as T
from lightglue_tpu_torch import weights as W
from lightglue_tpu_torch.configs import lightglue_config
from lightglue_tpu_torch.models import lightglue as lg
from lightglue_tpu_torch.synthetic import planted_pairs

TRAIN_CONF = dict(flash=False, mp=False, depth_confidence=-1.0,
                  width_confidence=-1.0, compaction_bucket=0)
STEPS, LR = 10, 2e-4  # the optax schedule's length: warmup 2


def to_torch(jbatch) -> T.SyntheticBatch:
    return T.SyntheticBatch(*(None if a is None else torch.from_numpy(
        np.array(a)) for a in jbatch))


def flat_numpy(tree):
    return {k: np.array(v) for k, v in W.flatten_params(tree).items()}


@pytest.fixture(scope="module", params=["superpoint", "sift"])
def case(request):
    """The JAX side of one preset, computed once: the init, four batches,
    value_and_grad on the first, and three make_feed_train_step steps on
    the other three (the parameters after each)."""
    jconf = jax_lightglue_config(request.param, n_layers=2).replace(**TRAIN_CONF)
    conf = lightglue_config(request.param, n_layers=2).replace(**TRAIN_CONF)
    jp = jax.jit(lambda k: jlg.init_params(k, jconf))(jax.random.key(0))
    sample = jax.jit(lambda k: jtrain.synthetic_batch(
        k, 2, 32, desc_dim=jconf.input_dim, with_scale_ori=jconf.add_scale_ori))
    batches = [sample(jax.random.key(s)) for s in (1, 2, 3, 4)]
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p, d: jtrain.matcher_loss(p, jconf, d), has_aux=True))(
            jp, batches[0])
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        optax.warmup_cosine_decay_schedule(
            0.0, LR, min(100, STEPS // 10 + 1), STEPS)))
    step = jtrain.make_feed_train_step(jconf, opt)
    state, p, after = opt.init(jp), jp, []
    for b in batches[1:]:
        p, state, _ = step(p, state, b)
        after.append(jweights.flatten_tree(jax.device_get(p)))
    flat = jweights.flatten_tree(jax.device_get(jp))
    return dict(
        preset=request.param, conf=conf,
        flat={k: np.asarray(v) for k, v in flat.items()},
        batches=[to_torch(b) for b in batches],
        loss=float(loss), aux={k: float(v) for k, v in aux.items()},
        grads={k: np.asarray(v) for k, v in
               jweights.flatten_tree(jax.device_get(grads)).items()},
        after=[{k: np.asarray(v) for k, v in a.items()} for a in after])


def tree(case):
    return W.from_jax_params(case["flat"], case["conf"])


def test_assignment_nll_matches_jax():
    rng = np.random.default_rng(0)
    b, m, n = 2, 7, 9
    scores = (rng.standard_normal((b, m + 1, n + 1)) * 3).astype(np.float32)
    gt = np.array([[3, -1, 0, 8, -1, 5, 2],
                   [4, 4, -1, 1, 7, -1, 0]], np.int32)  # a duplicate column
    got = float(T.assignment_nll(torch.from_numpy(scores), torch.from_numpy(gt)))
    want = float(jtrain.assignment_nll(jnp.asarray(scores), jnp.asarray(gt)))
    print(f"assignment_nll {got} vs JAX {want}: {abs(got - want):.3e}")
    assert abs(got - want) <= 1e-6
    # nothing matched: the positive term is 0, every column to the dustbin
    none = np.full((b, m), -1, np.int32)
    got = float(T.assignment_nll(torch.from_numpy(scores), torch.from_numpy(none)))
    want = float(jtrain.assignment_nll(jnp.asarray(scores), jnp.asarray(none)))
    assert abs(got - want) <= 1e-6


def test_assignment_nll_prefers_correct_assignment():
    """The JAX test's case (test_train.py): 0.1 + 0.5 (0.1 + 0.1) on the
    planted assignment, more on a shuffled one."""
    m = n = 8
    gt = torch.tensor([[1, 0, 3, 2, -1, -1, 7, 6]], dtype=torch.int32)
    good = torch.full((1, m + 1, n + 1), -10.0)
    for i, j in enumerate(gt[0].tolist()):
        good[0, i, j if j >= 0 else n] = -0.1
    good[0, m, 4] = good[0, m, 5] = -0.1
    bad = torch.cat([torch.roll(good[:, :m], 1, 1), good[:, m:]], 1)
    assert float(T.assignment_nll(good, gt)) == pytest.approx(0.2, abs=1e-5)
    assert float(T.assignment_nll(good, gt)) < float(T.assignment_nll(bad, gt))


def test_matcher_loss_matches_jax(case):
    loss, aux = T.matcher_loss(tree(case), case["conf"], case["batches"][0])
    got = {"loss": float(loss), **{k: float(v) for k, v in aux.items()}}
    want = {"loss": case["loss"], **case["aux"]}
    for k in want:
        rel = abs(got[k] - want[k]) / abs(want[k])
        print(f"{case['preset']} {k}: {got[k]:.7f} vs JAX {want[k]:.7f}, "
              f"relative {rel:.3e}")
        assert rel <= 1e-5, k


def test_gradients_match_jax(case):
    params = tree(case)
    for t in T.leaves(params):
        t.requires_grad_(True)
    loss, _ = T.matcher_loss(params, case["conf"], case["batches"][0])
    loss.backward()
    got = W.flatten_params(nn.map_params(params, lambda t: t.grad))
    assert got.keys() == case["grads"].keys()
    worst = 0.0
    for k, want in case["grads"].items():
        scale = np.abs(want).max()
        assert scale > 0, f"{k}: no gradient on the JAX side"
        err = np.abs(got[k] - want).max() / scale
        worst = max(worst, err)
        assert err <= 1e-4, f"{k}: {err}"
    print(f"{case['preset']}: largest gradient error {worst:.3e} of its leaf's "
          f"largest |grad|, over {len(got)} leaves")


def test_feed_steps_match_optax(case):
    params = tree(case)
    start = flat_numpy(params)
    step = T.make_feed_train_step(case["conf"], T.make_optimizer(params, LR, STEPS))
    for i, (batch, want) in enumerate(zip(case["batches"][1:], case["after"])):
        aux = step(batch)
        assert set(aux) == {"loss", "nll", "confidence_bce"}
        got = flat_numpy(params)
        err = max(np.abs(got[k] - want[k]).max() for k in want)
        moved = max(np.abs(got[k] - start[k]).max() for k in want)
        print(f"{case['preset']} step {i}: parameters within {err:.3e} of "
              f"optax's, moved {moved:.3e}")
        assert err <= 1e-5
        if i == 0:  # the first update's rate is 0
            assert moved == 0.0
        else:
            assert moved > 1e-5


def test_optimizer_matches_optax():
    """Five updates on a toy tree against optax's chain, the global norm
    above 1 (clipped) in some and below it in others, so that clipping
    changes how Adam's moments mix. At a rate of 0.1 the updates move the
    values by about 0.4; optax rounds its bias corrections in fp32 (b2 =
    0.999 is 1.3e-5 off in 1 - b2), 6e-6 of each update: held within 1e-5."""
    rng = np.random.default_rng(5)
    params = {"a": {"w": rng.standard_normal((3, 4)).astype(np.float32)},
              "b": rng.standard_normal(5).astype(np.float32)}
    grads = [jax.tree.map(lambda x: (rng.standard_normal(x.shape) * scale
                                     ).astype(np.float32), params)
             for scale in (10.0, 1e-2, 3.0, 1e-3, 1e-2)]
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        optax.warmup_cosine_decay_schedule(0.0, 0.1, 2, 10)))
    jp, state = params, opt.init(params)
    tp = nn.map_params(params, lambda x: torch.tensor(x))
    o = T.make_optimizer(tp, 0.1, 10)
    for g in grads:
        u, state = opt.update(g, state, jp)
        jp = optax.apply_updates(jp, u)
        for t, gt in zip(T.leaves(tp), (g["a"]["w"], g["b"])):
            t.grad = torch.tensor(gt)
        norm = float(o.step())
        want = float(optax.global_norm(g))
        assert norm == pytest.approx(want, rel=1e-6)
        for t, want in zip(T.leaves(tp), (jp["a"]["w"], jp["b"])):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(want),
                                       rtol=0, atol=1e-5)


@pytest.mark.parametrize("steps", [10, 200, 2500])
def test_schedule_matches_optax(steps):
    """Every count's rate within 1e-6 of the peak rate: optax evaluates the
    schedule in fp32 (its cosine near the end only to fp32's absolute
    precision)."""
    sched = optax.warmup_cosine_decay_schedule(
        0.0, 2e-4, min(100, steps // 10 + 1), steps)
    mine = T.warmup_cosine_schedule(2e-4, steps)
    assert mine(0) == 0.0
    for c in range(steps + 3):
        assert abs(mine(c) - float(sched(c))) <= 1e-6 * 2e-4


def test_synthetic_batch_geometry():
    """As tests/test_train.py checks the JAX generator."""
    b = T.synthetic_batch(torch.Generator().manual_seed(0), 4, 64, desc_dim=64)
    assert b.kpts0.shape == (4, 64, 2) and b.desc1.shape == (4, 64, 64)
    assert b.gt_matches0.dtype == torch.int32
    gt = b.gt_matches0.numpy()
    matched = gt >= 0
    assert 0.05 < matched.mean() < 0.95
    np.testing.assert_allclose(np.linalg.norm(b.desc0.numpy(), axis=-1), 1.0,
                               atol=1e-5)
    d0, d1 = b.desc0.numpy(), b.desc1.numpy()
    cos = np.einsum("bmd,bmd->bm", d0,
                    d1[np.arange(4)[:, None], np.clip(gt, 0, 63)])
    assert cos[matched].mean() > 0.5
    assert abs(cos[~matched].mean()) < 0.2
    for i in range(4):  # a partial injection
        tgt = gt[i][matched[i]]
        assert len(set(tgt.tolist())) == len(tgt)
    k1 = b.kpts1.numpy()
    assert (k1 >= 0).all() and (k1[..., 0] < 1024).all() and (k1[..., 1] < 768).all()
    np.testing.assert_array_equal(b.size0.numpy(), [[1024, 768]] * 4)


def test_synthetic_batch_seeded_and_scale_ori():
    def draw(seed):
        return T.synthetic_batch(torch.Generator().manual_seed(seed), 3, 48,
                                 desc_dim=128, with_scale_ori=True)

    a, b, c = draw(7), draw(7), draw(8)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a.desc0, c.desc0)
    # matched points carry the pair's similarity: scale ratios and
    # orientation shifts agree within the 0.05 jitter
    gt = a.gt_matches0.long()
    for i in range(3):
        rows = (gt[i] >= 0).nonzero()[:, 0]
        if len(rows) < 5:
            continue
        ratio = torch.log(a.scales1[i, gt[i, rows]] / a.scales0[i, rows])
        assert float(ratio.std()) < 0.1
        turn = torch.remainder(a.oris1[i, gt[i, rows]] - a.oris0[i, rows]
                               + torch.pi, 2 * torch.pi) - torch.pi
        turn = torch.remainder(turn - turn[0] + torch.pi, 2 * torch.pi) - torch.pi
        assert float(turn.abs().max()) < 0.5
    assert (a.scales0 >= 1.6 - 1e-4).all() and (a.scales0 <= 32 + 1e-3).all()
    assert (a.oris1.abs() <= torch.pi + 1e-6).all()


def test_forward_all_layers_refuses_kernels():
    conf = lightglue_config("superpoint", n_layers=2)  # flash on
    params = lg.init_params(conf, torch.Generator().manual_seed(0))
    batch = T.synthetic_batch(torch.Generator().manual_seed(1), 1, 16)
    with pytest.raises(ValueError, match="flash=False"):
        T.forward_all_layers(params, conf, batch)


def test_train_synthetic_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.train_synthetic(lightglue_config("superpoint", n_layers=2), steps=10)


def test_train_synthetic_lowers_the_loss():
    conf = lightglue_config("superpoint", n_layers=2)
    params, train_conf, hist = T.train_synthetic(
        conf, steps=30, batch=4, m=64, lr=1e-3, log_every=29, verbose=False,
        device="cpu")
    assert not train_conf.flash and train_conf.depth_confidence < 0
    assert [h["step"] for h in hist] == [0, 29]
    print(f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert hist[-1]["nll"] < hist[0]["nll"]
    assert not any(t.requires_grad for t in T.leaves(params))


def test_served_tree_after_training_equals_a_fresh_tree():
    """The matcher serves the trained tree as it serves a fresh copy of its
    values, after serving the initial tree (whose B5/B6 weights are cached
    by tensor identity): train_synthetic leaves the given tree as it was
    and returns new tensors."""
    conf = lightglue_config("superpoint", n_layers=2)
    init = lg.init_params(conf, torch.Generator().manual_seed(0))
    pr = planted_pairs(np.random.default_rng(3), 1, 128)
    data = {f"image{i}": {"keypoints": pr[f"keypoints{i}"],
                          "descriptors": pr[f"descriptors{i}"],
                          "image_size": pr["image_size"]} for i in (0, 1)}
    before = LightGlue(conf=conf, params=init, device="cpu")(data)
    start = flat_numpy(init)
    trained, _, _ = T.train_synthetic(conf, steps=12, batch=2, m=32, lr=1e-3,
                                      params=init, verbose=False, device="cpu")
    assert all(np.array_equal(v, flat_numpy(init)[k]) for k, v in start.items())
    moved = max(np.abs(flat_numpy(trained)[k] - v).max() for k, v in start.items())
    assert moved > 1e-4
    got = LightGlue(conf=conf, params=trained, device="cpu")(data)
    fresh = LightGlue(conf=conf, params=W.from_jax_params(
        flat_numpy(trained), conf), device="cpu")(data)
    again = LightGlue(conf=conf, params=init, device="cpu")(data)
    for k in ("matches0", "matches1", "matching_scores0", "matching_scores1",
              "prune0", "prune1"):
        np.testing.assert_array_equal(got[k], fresh[k], err_msg=k)
        np.testing.assert_array_equal(again[k], before[k], err_msg=k)
    assert not np.array_equal(got["matching_scores0"], before["matching_scores0"])


def test_train_script_writes_a_loadable_checkpoint(tmp_path):
    from lightglue_tpu_torch.scripts import train_synthetic as script

    conf = lightglue_config("superpoint", n_layers=2)
    params, train_conf, hist = T.train_synthetic(
        conf, steps=3, batch=2, m=32, log_every=100, verbose=False,
        device="cpu")
    out = tmp_path / "m.npz"
    hist_path = script.save(out, params, train_conf, hist,
                            features="superpoint", steps=3)
    loaded = W.load_params(str(out), conf)
    with np.load(out) as f:
        assert all(f[k].dtype == np.float16 for k in f.files)
    assert set(W.flatten_params(loaded)) == set(W.expected_shapes(conf))
    assert hist_path == tmp_path / "train_synthetic_history.json"
    saved = json.loads(hist_path.read_text())
    assert [h["step"] for h in saved["history"]] == [0, 2]
    assert saved["n_layers"] == 2 and saved["steps"] == 3
    with pytest.raises(SystemExit):  # never onto the JAX trainer's files
        script.main(["--steps", "3", "--out",
                     str(script.ROOT / "weights" / "x.npz")])
