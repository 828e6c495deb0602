"""The plain references against the port's CPU path at small sizes.

The port's CPU path (its plain versions, which its own tests hold against
the JAX package) and the benchmark's references are written apart; here
they agree: the adaptive matcher's stop, pruning and matches, SuperPoint's
keypoints, scores, descriptors and selection.
"""

import numpy as np
import pytest
import torch

from portbench.core import weights as W
from portbench.core.layout import ROOT
from portbench.judge import matcher as judge
from portbench.judge.extractor import cut_gaps
from portbench.reference.lightglue import Matcher, load_npz
from portbench.reference.precision import Precision
from portbench.reference.superpoint import SuperPoint
from portbench.traffic import image_pairs, planted_pairs

NPZ = str(ROOT / "weights" / "synthetic_superpoint_lightglue.npz")
CONF = {"input_dim": 256, "descriptor_dim": 256, "n_layers": 9,
        "num_heads": 4, "depth_confidence": 0.95, "width_confidence": 0.99,
        "filter_threshold": 0.1, "pruning_min_kpts": 100}


@pytest.mark.parametrize("adaptive", [True, False])
def test_matcher_against_port(adaptive):
    from lightglue_tpu_torch.configs import lightglue_config
    from lightglue_tpu_torch.models import lightglue as lg
    conf = dict(CONF) if adaptive else dict(CONF, depth_confidence=-1.0,
                                             width_confidence=-1.0)
    g = torch.Generator().manual_seed(3)
    pairs = [planted_pairs.pair(g, n0, n1, {"image_size": [320, 240]},
                                "cpu") for n0, n1 in ((220, 250), (260, 210))]
    pairs = [tuple({k: v.numpy() for k, v in f.items()} for f in p)
             for p in pairs]
    batch = judge.padded(pairs, 512, "cpu")
    ref = Matcher(load_npz(NPZ, "cpu"), conf, Precision())(**batch)
    pc = lightglue_config("superpoint", fused_self=False, fused_cross=False,
                          flash=False, **{k: conf[k] for k in conf
                                          if k != "input_dim"})
    params = load_npz(NPZ, "cpu")
    out = lg.forward(params, pc, kpts0=batch["kpts0"], kpts1=batch["kpts1"],
                     desc0=batch["desc0"], desc1=batch["desc1"],
                     size0=batch["size0"], size1=batch["size1"],
                     mask0=batch["mask0"], mask1=batch["mask1"])
    assert out.stop == ref["stop"]
    if adaptive:
        assert out.stop < 9
    assert torch.equal(out.matches0.long(), ref["matches0"].long())
    assert float((out.matching_scores0 - ref["matching_scores0"]).abs()
                 .max()) < 1e-4
    # pruning: the port's survivors at the end are the reference's
    alive = out.prune0 == out.stop
    assert torch.equal(alive & batch["mask0"], ref["act0"])
    if adaptive:
        # every point the test kept has its margin, none negative
        for kept in ref["kept"]:
            assert bool((kept >= 0).all())
        assert bool(torch.isfinite(ref["kept"][0][ref["act0"]]).all())


def _images():
    pool = image_pairs.make({"height": 128, "width": 160,
                             "pairs_per_request": 2, "requests": 1,
                             "channels": 3}, 3, "cpu")
    return torch.from_numpy(pool[0][0]).float() / 255, torch.from_numpy(
        pool[0][2])


def _same_points(f, r):
    """The port's and the reference's valid keypoints are the same set
    (near ties may order them differently): each point's nearest on the
    other side within 1e-3 px, but for a near-tie swap at the top-k's cut
    in one image in a hundred points."""
    from portbench.judge.extractor import keypoint_gaps
    for b in range(f.keypoints.shape[0]):
        g = keypoint_gaps(f.keypoints[b], f.valid[b], r["keypoints"][b],
                          r["valid"][b])
        assert int(f.valid[b].sum()) > 100
        assert float((g > 1e-3).double().mean()) < 0.01


def test_superpoint_against_port():
    from lightglue_tpu_torch.configs import SuperPointConfig
    from lightglue_tpu_torch.models import superpoint as sp
    img, size = _images()
    conf = {"descriptor_dim": 256, "nms_radius": 4, "max_num_keypoints": 256,
            "detection_threshold": 0.0005, "remove_borders": 4,
            "weight_scale": 3.0}
    p = W.tree(W.superpoint_leaves(conf), 9, "cpu")
    f = sp.forward(p, SuperPointConfig(max_num_keypoints=256), img[..., :1],
                   size)
    ref = SuperPoint(p, conf, Precision())
    r = ref(img[..., :1].permute(0, 3, 1, 2), size)
    _same_points(f, r)
    v = f.valid
    at = ref.score_at(r, f.keypoints)
    assert float((f.keypoint_scores - at)[v].abs().max()) < 1e-5
    assert float((f.descriptors - ref.describe(r, f.keypoints))[v].abs()
                 .max()) < 1e-5
    # the port's points are the reference's peaks above its cut
    for b in range(len(size)):
        g = cut_gaps(r["peak_map"][b], r["cut"][b], f.keypoints[b], v[b])
        assert float(g.mean()) < 1e-7


def test_fp8_control_rounds_every_product():
    x = torch.tensor([1.0, 1.07, 300.0, 0.0123])
    y = Precision("fp8")(x)
    assert torch.equal(Precision("fp32")(x), x)
    assert not torch.equal(y, x)
    assert torch.equal(y, x.to(torch.float8_e4m3fn).float())
    np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=0.07)


def test_near_tie_taken_the_other_way_is_judged_sound():
    """Answers of a run that took a pruning test the other way (the
    reference with that decision flipped, standing in for a program whose
    rounding did) read gaps against the reference's own decision, and none
    once the judge takes that test both ways (``judge_ties``)."""
    g = torch.Generator().manual_seed(5)
    pair = planted_pairs.pair(g, 240, 230, {"image_size": [320, 240]}, "cpu")
    pairs = [tuple({k: v.numpy() for k, v in f.items()} for f in pair)]
    batch = judge.padded(pairs, 256, "cpu")
    ref = Matcher(load_npz(NPZ, "cpu"), CONF, Precision())
    base = ref(**batch, tie=10.0)
    stop = base["stop"]
    n0s, n1s = [240], [230]
    th = CONF["filter_threshold"]

    def answers(out):
        return [{"matches0": out["matches0"][0, :240].numpy(),
                 "matching_scores0": out["matching_scores0"][0, :240].numpy(),
                 "stop": stop}]

    # the nearest test whose flip moves the answers
    for t in base["ties"]:
        alt = ref(**batch, layers=stop, flips=[t])
        if not torch.equal(alt["matching_scores0"],
                           base["matching_scores0"]):
            break
    else:
        pytest.fail("no flip moved the answers")
    res = answers(alt)
    plain = ref(**batch, layers=stop)
    gaps, _ = judge.judge_batch(plain, res, n0s, n1s, stop, th)
    assert judge._reading(gaps[0]) > (0.0, 0.0)
    near = ref(**batch, layers=stop, tie=t[0] * 1.01)
    assert near["ties"][-1][1:] == t[1:]
    assert len(near["ties"]) <= judge.MAX_FLIPS
    gaps, stop_gap = judge.judge_ties(
        lambda flips: ref(**batch, layers=stop, flips=flips), near, res,
        n0s, n1s, stop, th)
    decision, score = judge._reading(gaps[0])
    assert decision == 0.0 and score < 1e-6  # exp's rounding
    assert stop_gap == 0.0
    # the judge takes no test both ways without the tie
    gaps, _ = judge.judge_ties(
        lambda flips: ref(**batch, layers=stop, flips=flips), plain, res,
        n0s, n1s, stop, th)
    assert judge._reading(gaps[0]) > (0.0, 0.0)


def test_below_threshold_point_judged_over_its_partners():
    """A mutual point below the threshold names no partner: where its row
    holds a near tie, the program's partner may be the runner-up, mutual
    with it, and the point reads that tie; where no column of its row
    could be its mutual partner, it reads the column's margin."""
    neg = -30.0
    # row 0 ties columns 0 and 1 within 5e-5; column 0's best is row 1,
    # column 1's best is row 0
    s = torch.full((3, 3), neg, dtype=torch.float64)
    s[0, 0], s[0, 1] = -14.34231, -14.34236
    s[1, 0], s[1, 2] = -6.0, -6.2
    s[2, 2] = -1.0
    scores = torch.zeros(4, 4, dtype=torch.float64)
    scores[:3, :3] = s
    act = torch.ones(3, dtype=torch.bool)
    zero, inf = torch.zeros(3), torch.full((3,), float("inf"))
    m0 = np.array([-1, -1, 2])
    ms0 = np.array([np.exp(-14.34236), 0.0, np.exp(-1.0)], np.float32)
    g = judge.pair_gaps(scores, act, act, zero, zero, inf, inf, m0, ms0, 0.1)
    assert float(g["decision"][0]) == pytest.approx(5e-5, abs=1e-5)
    # without the tie (column 1 far below in row 0) the point reads
    # column 0's margin, or column 1's row margin, whichever is less
    s[0, 1] = -20.0
    scores[:3, :3] = s
    ms0[0] = np.exp(-14.34231)
    g = judge.pair_gaps(scores, act, act, zero, zero, inf, inf, m0, ms0, 0.1)
    assert float(g["decision"][0]) == pytest.approx(20.0 - 14.34231, abs=1e-4)
