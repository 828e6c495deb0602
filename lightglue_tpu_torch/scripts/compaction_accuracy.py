"""Measure what two-stage compaction's survivor cap costs in accuracy
(counterpart of scripts/compaction_accuracy.py, with its arguments and
rows).

Two-stage compaction (``models/lightglue.py::forward_adaptive_twostage``)
gathers the points that survive pruning after a prefix of layers into a
static bucket; when more survive than fit, the least matchable are dropped,
where the reference's pruning never drops an unpruned point (reference
lightglue.py:636-643). On the trained weights and held-out synthetic pairs
this compares the compacted path with the exact masked adaptive path
(``forward_adaptive``) and reports, a row per (keypoints, prefix, bucket):

* agreement: precision / recall / f1 of the (i -> j) matches against the
  masked path's;
* gt_precision / gt_recall of both paths against the planted matches;
* the survivors after the prefix (``forward_prefix``): how full the bucket
  runs (they follow the share of points with a planted match, which the
  output records as ``planted_share``).

    python lightglue_tpu_torch/scripts/compaction_accuracy.py \\
        [--weights weights/synthetic_superpoint_lightglue.npz] \\
        [--kpts 1024 2048] [--buckets 256 384 512] [--prefix 1 3] \\
        [--batch 8] [--seeds 3] [--mp] [--out rows.json]

It runs on the card (the kernels). The batches are
``train.synthetic_batch``'s, drawn there from a ``torch.Generator`` seeded
1000 + seed (the JAX script draws its own from
``jax.random.key(1000 + seed)``: the same distributions, another stream).
``--mp`` runs the matcher in bf16. Rows are printed; the JSON is written
only to ``--out``, never into ``benchmarks/`` (the JAX script's).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from lightglue_tpu_torch import nn  # noqa: E402
from lightglue_tpu_torch import train as T  # noqa: E402
from lightglue_tpu_torch import weights as W  # noqa: E402
from lightglue_tpu_torch.configs import lightglue_config  # noqa: E402
from lightglue_tpu_torch.models import lightglue as lg  # noqa: E402

WEIGHTS = ROOT / "weights" / "synthetic_superpoint_lightglue.npz"


def pair_set(m0):
    """(M,) matches0 row -> set of (i, j) matched pairs."""
    return {(i, int(j)) for i, j in enumerate(m0) if j >= 0}


def agreement(m0_test: np.ndarray, m0_ref: np.ndarray):
    """Precision/recall of test matches vs reference matches, pooled over
    the batch."""
    tp = fp = fn = 0
    for t, r in zip(m0_test, m0_ref):
        ts, rs = pair_set(t), pair_set(r)
        tp += len(ts & rs)
        fp += len(ts - rs)
        fn += len(rs - ts)
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    f1 = 2 * prec * rec / max(prec + rec, 1e-9)
    return {"precision": round(prec, 4), "recall": round(rec, 4),
            "f1": round(f1, 4)}


def gt_scores(m0: np.ndarray, gt: np.ndarray):
    pred = m0 >= 0
    correct = (m0 == gt) & pred & (gt >= 0)
    prec = correct.sum() / max(pred.sum(), 1)
    rec = correct.sum() / max((gt >= 0).sum(), 1)
    return {"gt_precision": round(float(prec), 4),
            "gt_recall": round(float(rec), 4)}


def _inputs(data: T.SyntheticBatch) -> dict:
    return dict(kpts0=data.kpts0, kpts1=data.kpts1, desc0=data.desc0,
                desc1=data.desc1, size0=data.size0, size1=data.size1)


def masked_matches(params, conf, batches) -> list:
    """matches0 of the exact masked adaptive path, a batch each."""
    return [lg.forward_adaptive(params, conf, **_inputs(d)).matches0.cpu().numpy()
            for d in batches]


def survivors(params, conf, batches, n_prefix: int) -> np.ndarray:
    """Each image's active points after ``n_prefix`` layers, every batch's
    image 0 rows then image 1 rows."""
    surv = []
    for d in batches:
        st = lg.forward_prefix(params, conf, n_prefix, **_inputs(d)).state
        surv += [st.act0.sum(1).cpu().numpy(), st.act1.sum(1).cpu().numpy()]
    return np.concatenate(surv)


def twostage_matches(params, conf, batches, n_prefix: int, bucket: int) -> list:
    """matches0 of the two-stage path, a batch each."""
    return [lg.forward_adaptive_twostage(params, conf, n_prefix, bucket,
                                         **_inputs(d)).matches0.cpu().numpy()
            for d in batches]


def row(m: int, n_prefix: int, bucket: int, surv: np.ndarray, got: list,
        refs: list, gts: list) -> dict:
    """One row of the JAX script's form from the two paths' matches0 and
    the planted truth, a batch each."""
    gt_t = [gt_scores(m0, gt) for m0, gt in zip(got, gts)]
    gt_r = [gt_scores(ref, gt) for ref, gt in zip(refs, gts)]
    return {
        "kpts": m, "prefix": n_prefix, "bucket": bucket,
        "survivors_mean": round(float(surv.mean()), 1),
        "survivors_p95": round(float(np.percentile(surv, 95)), 1),
        "overflow_frac": round(float((surv > bucket).mean()), 3),
        "agreement": agreement(np.concatenate(got), np.concatenate(refs)),
        "compacted": {k: round(float(np.mean([d[k] for d in gt_t])), 4)
                      for k in gt_t[0]},
        "exact_masked": {k: round(float(np.mean([d[k] for d in gt_r])), 4)
                         for k in gt_r[0]},
    }


def grid(params, conf, batches_by_kpts: dict, prefixes, buckets,
         log=print) -> list:
    """Every row: for each keypoint count (its batches), prefix and bucket
    below the keypoint count, as the JAX script loops."""
    rows = []
    for m, batches in batches_by_kpts.items():
        refs = masked_matches(params, conf, batches)
        gts = [d.gt_matches0.cpu().numpy() for d in batches]
        for n_prefix in prefixes:
            surv = survivors(params, conf, batches, n_prefix)
            for bucket in buckets:
                if bucket >= m:
                    continue
                got = twostage_matches(params, conf, batches, n_prefix, bucket)
                rows.append(row(m, n_prefix, bucket, surv, got, refs, gts))
                log(json.dumps(rows[-1]))
    return rows


def batches(kpts, batch: int, seeds: int, device) -> dict:
    """{keypoints: [synthetic_batch of seed 1000 + s for each seed]} on
    ``device``."""
    return {m: [T.synthetic_batch(torch.Generator(device).manual_seed(1000 + s),
                                  batch, m, device=device)
                for s in range(seeds)]
            for m in kpts}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--weights", default=str(WEIGHTS))
    ap.add_argument("--kpts", type=int, nargs="+", default=[1024, 2048])
    ap.add_argument("--buckets", type=int, nargs="+", default=[256, 384, 512])
    ap.add_argument("--prefix", type=int, nargs="+", default=[1, 3])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--mp", action="store_true", help="the matcher in bf16")
    ap.add_argument("--out", default=None, help="write the rows' JSON here")
    args = ap.parse_args(argv)
    if args.out and (ROOT / "benchmarks").resolve() in Path(
            args.out).resolve().parents:
        raise SystemExit(f"{args.out}: benchmarks/ holds the JAX script's "
                         "rows; write elsewhere")

    from lightglue_tpu_torch.scripts.train_synthetic import card

    device = torch.device("cuda")
    conf = lightglue_config("superpoint", mp=args.mp)  # default confidences
    params = nn.params_to(W.load_params(args.weights, conf), device)
    drawn = batches(args.kpts, args.batch, args.seeds, device)
    # the share of image-0 points with a planted match: the pairs' draw of
    # p_match sets it, and the survivors after the prefix follow it
    share = {m: round(float(np.mean([(d.gt_matches0 >= 0).float().mean().item()
                                     for d in bs])), 4)
             for m, bs in drawn.items()}
    print(f"planted share of the points: {share}", flush=True)
    t0 = time.perf_counter()
    rows = grid(params, conf, drawn, args.prefix, args.buckets)
    wall = time.perf_counter() - t0
    who = card()
    print(f"{len(rows)} rows in {wall:.1f} s on {who}", flush=True)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(
            {"weights": Path(args.weights).name, "batch": args.batch,
             "seeds": args.seeds, "mp": args.mp, "device": who, "wall_s": wall,
             "planted_share": share,
             "workload": ("lightglue_tpu_torch.train.synthetic_batch "
                          "difficulty-jittered, drawn on the device from "
                          "torch.Generator seeds 1000 + seed"),
             "note": ("agreement = compacted vs exact masked adaptive path "
                      "(reference semantics); gt_* = vs planted "
                      "correspondences"),
             "rows": rows}, indent=1))
        print("->", out)


if __name__ == "__main__":
    main()
