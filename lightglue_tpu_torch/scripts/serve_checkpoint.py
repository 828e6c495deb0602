"""How a trained matcher checkpoint serves: the npz through ``BatchMatcher``
adaptive at 1024 keypoints on 16 planted pairs (superpoint preset), one
pair a batch and all in one batch, beside the committed
``weights/synthetic_superpoint_lightglue.npz``. For each it prints the
layers run (stop) and the share of matches that are planted pairs.

    python lightglue_tpu_torch/scripts/serve_checkpoint.py \\
        train_out/synthetic_superpoint_lightglue.npz
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from lightglue_tpu_torch import weights as W  # noqa: E402
from lightglue_tpu_torch.configs import lightglue_config  # noqa: E402
from lightglue_tpu_torch.parallel.batching import BatchMatcher  # noqa: E402
from lightglue_tpu_torch.synthetic import planted_pairs  # noqa: E402

KEYPOINTS, PAIRS = 1024, 16
COMMITTED = ROOT / "weights" / "synthetic_superpoint_lightglue.npz"


def serve(path: Path):
    """The checkpoint at ``path`` through BatchMatcher on the card,
    adaptive, on PAIRS planted pairs: (max_batch, mean stop, the stops,
    matches, precision) for one pair a batch and for all in one."""
    conf = lightglue_config("superpoint")
    params = W.load_params(str(path), conf)
    pr = planted_pairs(np.random.default_rng(0), PAIRS, KEYPOINTS,
                       desc_dim=conf.input_dim)
    feats = [tuple({"keypoints": pr[f"keypoints{s}"][i],
                    "descriptors": pr[f"descriptors{s}"][i],
                    "image_size": pr["image_size"][i]} for s in (0, 1))
             for i in range(PAIRS)]
    rows = []
    for max_batch in (1, PAIRS):
        bm = BatchMatcher(conf, params, buckets=(KEYPOINTS,),
                          max_batch=max_batch)
        res = bm.match_pairs(feats)
        m0 = np.stack([r["matches0"] for r in res])
        pred = m0 >= 0
        stops = [r["stop"] for r in res]
        prec = (float((m0[pred] == pr["gt_matches0"][pred]).mean())
                if pred.any() else 0.0)
        rows.append((max_batch, float(np.mean(stops)), sorted(set(stops)),
                     int(pred.sum()), prec))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("npz", help="a superpoint-preset matcher checkpoint")
    args = ap.parse_args(argv)
    for label, path in (("given", Path(args.npz)), ("committed", COMMITTED)):
        for max_batch, stop, stops, k, prec in serve(path):
            print(f"{label} ({path.name}): BatchMatcher adaptive, {KEYPOINTS} "
                  f"keypoints, {PAIRS} planted pairs, max_batch "
                  f"{max_batch}: mean stop {stop:.2f} {stops}, {k} matches, "
                  f"precision {prec:.4f}", flush=True)


if __name__ == "__main__":
    main()
