"""The comparison that decides ``correct`` for a matcher's outputs.

The reference (``reference/lightglue.py``, fp32, TF32 off) runs each batch
the program ran, for as many layers as the program ran. Each point of
image 0 gets a decision gap (logits): the margin by which the reference
disagrees with the program's decision on it. A point's decision is
matched to j, mutual below the threshold (scored, not matched) or not
mutual. A match i -> j: how far S[i, j] lies below the best of its row or
of its column, or below log(filter_threshold); a mutual point below the
threshold names no partner: the least, over the partners j it may have,
of how far S[i, j] lies below its row's or its column's best or above
the threshold (a partner that the reference pruned: its pruning margin),
so that a near tie in its row, taken the other way, reads that tie; a
point the program leaves unscored: how
strongly the reference makes it mutual; a point that the program scored
and the reference pruned: how far the reference's pruning test cleared its
thresholds (matchability and confidence logits). Where the reference's
alternative rests on a point that it kept by a smaller margin than that
(the rival of a row or a column, or the point itself), the gap is that
margin: the program may have pruned the point at a near tie, since
``match_pairs`` returns no survival depths. Points that both sides score
get a score gap, |program score - exp(S[i, j])| over the larger of the
two.

A pruning test that the reference's point cleared by less than the cell's
``tie_logits`` is a near tie that the program's rounding may take the other
way; such a flip moves the pair's later layers, and where it moves a count
across ``pruning_min_kpts`` it decides whether a later layer prunes at
all. ``judge_ties`` judges each pair also against the reference's runs
with its nearest ties (``MAX_FLIPS``) taken the other way, in every
combination, and keeps the run that the program's answers lie nearest.

The stop is judged apart: a batch's stop gap is how far every
token-confidence logit would have to move for the published stop test, at
each layer the program ran, to take the program's decision there (0 where
it does).

A request's numbers (``request_numbers``): the largest of its decision
gaps, the mean of its score gaps, the number of points that one side
scores and the other does not, the number that both score, and its
largest stop gap. A run's numbers (``run_numbers``): the largest over its
judged requests, so that a fault in a few requests (one bucket's graphs)
moves them, and ``one_sided_share``: the points that one side scores and
the other does not, over all that either side scores, pooled over the
judged requests.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

INF = float("inf")
MAX_FLIPS = 3  # a pair's nearest ties taken both ways: 2**3 runs at most


def round_batch(n: int, max_batch: int) -> int:
    """A chunk's batch: n rounded up to a power of two, at most max_batch."""
    b = 1
    while b < n and b < max_batch:
        b *= 2
    return b


def chunks(pairs, buckets: Sequence[int], max_batch: int):
    """The batches a ``BatchMatcher`` forms (its documented rules): pairs
    grouped by the smallest bucket that holds both images, in order of a
    bucket's first pair, cut into chunks of at most ``max_batch``, each
    rounded up to a power of two with copies of its first pair. Yields
    (bucket, the chunk's pair indices, the padded chunk's pairs)."""
    groups: Dict[int, List[int]] = {}
    for i, (f0, f1) in enumerate(pairs):
        n = max(len(f0["keypoints"]), len(f1["keypoints"]))
        bucket = next((b for b in buckets if b >= n), n)
        groups.setdefault(bucket, []).append(i)
    for bucket, idx in groups.items():
        for a in range(0, len(idx), max_batch):
            chunk = idx[a:a + max_batch]
            sel = [pairs[i] for i in chunk]
            sel += [sel[0]] * (round_batch(len(chunk), max_batch) - len(sel))
            yield bucket, chunk, sel


def padded(sel, bucket: int, device) -> Dict[str, torch.Tensor]:
    """A chunk as the reference's padded batch (masks mark real points)."""
    b = len(sel)
    out = {}
    for side in (0, 1):
        d = sel[0][side]["descriptors"].shape[-1]
        kp = torch.ones(b, bucket, 2)
        de = torch.ones(b, bucket, d)
        mask = torch.zeros(b, bucket, dtype=torch.bool)
        size = torch.zeros(b, 2)
        for j, pr in enumerate(sel):
            f = pr[side]
            n = len(f["keypoints"])
            kp[j, :n] = torch.as_tensor(np.asarray(f["keypoints"]))
            de[j, :n] = torch.as_tensor(np.asarray(f["descriptors"]))
            mask[j, :n] = True
            size[j] = torch.as_tensor(np.asarray(f["image_size"]))
        out.update({f"kpts{side}": kp, f"desc{side}": de,
                    f"mask{side}": mask, f"size{side}": size})
    return {k: v.to(device) for k, v in out.items()}


def stop_margin(test: Dict, stopped: bool) -> float:
    """How far (logits) every active point's token-confidence logit must
    move for the published stop test to decide ``stopped`` (0 if it
    does)."""
    t = test["t"][test["act"]].double()
    th = test["th"]
    big_t = math.log(th / (1.0 - th))
    points = np.float32(test["points"])
    dc = np.float32(test["dc"])

    def stops(u: int) -> bool:
        return bool(np.float32(1.0) - np.float32(u) / points > dc)

    # the most unconfident points that still stop
    u0 = int(float(points) * (1.0 - float(dc)))
    ustar = max((u for u in range(max(u0 - 3, 0), u0 + 4) if stops(u)),
                default=-1)
    unconf = int((torch.sigmoid(t) < th).sum())
    if stops(unconf) == stopped:
        return 0.0
    ts = torch.sort(t).values
    if ustar + 1 > len(ts) or ustar < 0:
        return INF
    v = float(ts[ustar])
    return max(big_t - v, 0.0) if stopped else max(v - big_t, 0.0)


def pair_gaps(scores: torch.Tensor, act0, act1, pruned0, pruned1,
              kept0, kept1, m0: np.ndarray, ms0: np.ndarray,
              th: float) -> Dict[str, torch.Tensor]:
    """Per point of image 0 of one pair: ``decision`` (the reference's
    margin against the program's decision, logits, 0 where they agree;
    every point), ``score`` (over the points that both sides score) and
    ``one_sided`` (the number of points that one side scores and the other
    does not). ``scores`` the reference's (M + 1,
    N + 1) log assignment; ``kept0`` / ``kept1`` its keep margins;
    ``m0`` / ``ms0`` the program's matches0 and matching_scores0 over the
    pair's n0 points."""
    dev = scores.device
    n0 = len(m0)
    n1 = int(act1.shape[0])
    inf = torch.full((max(n0, 1),), INF, dtype=torch.float64, device=dev)
    broken = {"decision": inf, "score": inf[:1], "one_sided": inf[:1]}
    if len(ms0) != n0 or n0 != int(act0.shape[0]):
        return broken
    m0 = torch.as_tensor(np.asarray(m0, np.int64), device=dev)
    ms0 = torch.as_tensor(np.asarray(ms0, np.float32), device=dev).double()
    if bool(((m0 < -1) | (m0 >= n1)).any()) or not bool(
            torch.isfinite(ms0).all()) or bool((ms0 < 0).any()):
        return broken
    s = scores[:n0, :n1].double()
    k0, k1 = kept0[:n0].double(), kept1[:n1].double()
    log_th = math.log(th)
    top_r = s.topk(min(2, n1), dim=1)
    top_c = s.topk(min(2, n0), dim=0)
    ar = torch.arange(n0, device=dev)
    # the reference's state of each point: its row's best j, whether that
    # pair is mutual, and how strongly (logits) it is mutual
    jr = top_r.indices[:, 0]
    sr = top_r.values[:, 0]
    mutual_r = (top_c.indices[0, jr] == ar) & act0 & act1[jr]
    strength = torch.minimum(sr - top_r.values[:, -1], sr - top_c.values[-1, jr])
    matched = m0 >= 0
    below = (~matched) & (ms0 > 0)
    none = (~matched) & (ms0 == 0)
    j = torch.where(matched, m0, jr)
    sij = s[ar, j]
    # the best rival of j in row i and of i in column j, and the margin by
    # which the reference kept that rival
    rival_r = torch.where(jr == j, top_r.indices[:, -1], jr)
    row_other = torch.where(jr == j, top_r.values[:, -1], sr)
    ic = top_c.indices[0, j]
    rival_c = torch.where(ic == ar, top_c.indices[-1, j], ic)
    col_other = torch.where(ic == ar, top_c.values[-1, j], top_c.values[0, j])
    row = torch.minimum(row_other - sij, k1[rival_r])
    col = torch.minimum(col_other - sij, k0[rival_c])
    # the program's claim against the reference, by state
    claim = torch.zeros(n0, dtype=torch.float64, device=dev)
    claim = torch.where(matched, torch.stack([row, col, log_th - sij]).amax(0),
                        claim)
    claim = torch.where(below, torch.maximum(col, sij - log_th), claim)
    claim = torch.where(none & mutual_r, torch.stack(
        [strength, k0, k1[jr]]).amin(0), claim)
    claim = claim.clamp(min=0)
    active = act0 & act1[j]
    prune = torch.maximum(torch.where(act0, 0.0, pruned0[:n0].double()),
                          torch.where(act1[j], 0.0, pruned1[j].double()))
    # a point the reference pruned is judged by its pruning margin where
    # the program gave it a score; else the two agree (no score, no match)
    gap = torch.where(active, claim, torch.where(none, 0.0, prune))
    # a mutual point below the threshold: the least claim over its partners
    bi = (below & act0).nonzero()[:, 0]
    if len(bi):
        sb = s[bi]
        cols = torch.arange(n1, device=dev)
        row_b = torch.where(cols[None] == jr[bi, None], 0.0, torch.minimum(
            sr[bi, None] - sb, k1[jr[bi]][:, None]))
        col_b = torch.where(
            top_c.indices[0][None] == bi[:, None],
            torch.minimum(top_c.values[-1][None] - sb,
                          k0[top_c.indices[-1]][None]),
            torch.minimum(top_c.values[0][None] - sb,
                          k0[top_c.indices[0]][None]))
        each = torch.stack([row_b, col_b, sb - log_th]).amax(0).clamp(min=0)
        each = torch.where(act1[None], each, pruned1[:n1].double()[None])
        gap[bi] = each.amin(1)
    both = active & ~none & mutual_r
    p = sij.exp()
    score = ((ms0 - p).abs() / torch.maximum(ms0, p).clamp(min=1e-30))[both]
    one_sided = (~none) != (active & mutual_r)
    return {"decision": gap, "score": score,
            "one_sided": one_sided.sum().double()[None]}


def judge_batch(ref: Dict, results: List[Dict], n0s, n1s, stop: int,
                th: float) -> Tuple[List[Dict[str, torch.Tensor]], float]:
    """``pair_gaps`` of each real pair of one batch, and the batch's stop
    gap: ``ref`` the reference's run of it (``layers`` = the program's
    ``stop``), ``results`` the program's answers (matches0,
    matching_scores0) of its real pairs."""
    stop_gap = max([stop_margin(t, stop == k + 1)
                    for k, t in enumerate(ref["tests"])], default=0.0)
    out = []
    for j, r in enumerate(results):
        out.append(pair_gaps(
            ref["scores"][j], ref["act0"][j, :n0s[j]],
            ref["act1"][j, :n1s[j]], ref["pruned"][0][j], ref["pruned"][1][j],
            ref["kept"][0][j], ref["kept"][1][j], r["matches0"],
            r["matching_scores0"], th))
    return out, stop_gap


def _reading(g: Dict[str, torch.Tensor]) -> Tuple[float, float]:
    """A pair's largest decision gap and mean score gap."""
    d, sc = g["decision"], g["score"]
    return (float(d.max()) if len(d) else 0.0,
            float(sc.mean()) if len(sc) else 0.0)


def judge_ties(run, out: Dict, results: List[Dict], n0s, n1s, stop: int,
               th: float) -> Tuple[List[Dict[str, torch.Tensor]], float]:
    """``judge_batch`` of the reference's run ``out`` (made with the
    cell's ``tie``), with each pair's nearest ties also taken the other way:
    ``run(flips)`` reruns the batch with those decisions flipped. Each pair
    keeps the run whose decision and score gaps its answers read lowest;
    the stop gap is the lowest over the runs."""
    gaps, stop_gap = judge_batch(out, results, n0s, n1s, stop, th)
    for j in range(len(results)):
        near = [t for t in out["ties"] if t[3] == j][:MAX_FLIPS]
        for k in range(1, 2 ** len(near)):
            alt = run([t for b, t in enumerate(near) if k >> b & 1])
            g, sg = judge_batch(alt, results, n0s, n1s, stop, th)
            if _reading(g[j]) < _reading(gaps[j]):
                gaps[j] = g[j]
            stop_gap = min(stop_gap, sg)
            del alt
    return gaps, stop_gap


def request_numbers(gaps: List[Dict[str, torch.Tensor]],
                    stop_gap: float = 0.0) -> Dict[str, float]:
    """One request's numbers from its pairs' ``pair_gaps`` and its largest
    stop gap (see the module's note)."""
    cat = {k: torch.cat([g[k] for g in gaps]) for k in gaps[0]}
    if not all(bool(torch.isfinite(v).all()) for v in cat.values()):
        return {"decision_gap": INF, "score_gap": INF, "one_sided": INF,
                "scored": 0.0, "stop_gap": INF}
    d, sc = cat["decision"], cat["score"]
    return {"decision_gap": float(d.max()) if len(d) else 0.0,
            "score_gap": float(sc.mean()) if len(sc) else 0.0,
            "one_sided": float(cat["one_sided"].sum()),
            "scored": float(len(sc)),
            "stop_gap": float(stop_gap)}


def run_numbers(per_request: List[Dict[str, float]]) -> Dict[str, float]:
    """A run's numbers: the largest over its judged requests of each
    request's number but the two counts, and the pooled
    ``one_sided_share`` (inf where no request was judged)."""
    if not per_request:
        return {k: INF for k in ("decision_gap", "score_gap", "stop_gap",
                                 "one_sided_share")}
    out = {k: max(r[k] for r in per_request) for k in per_request[0]
           if k not in ("one_sided", "scored")}
    one = sum(r["one_sided"] for r in per_request)
    every = one + sum(r["scored"] for r in per_request)
    out["one_sided_share"] = one / max(every, 1.0) if one < INF else INF
    return out
