"""The matcher's latency at B 1, where the host bounds it: wall ms per call
of ``pipeline.LightGlue`` (the trained synthetic layers, a planted pair of
1024 keypoints, fixed and adaptive) with the default blocks and with two
heads of 128, each cell timed in several rounds in turns, beside the host
time each call spends inside the block and assignment wrappers (B5, B6,
the composed cross block and B2: the Python work before their launches
return, as the launches do not wait for the card). ``--unsplit`` adds the
default blocks with K2's exact walks run unsplit (one launch and no merge a
direction), the host-light form of B6's attention.

It uses only entry points that every version of the port has, so two
checkouts compare on one card by running this file with ``PYTHONPATH`` set
to each root in turns (a process each)::

    PYTHONPATH=. python lightglue_tpu_torch/scripts/host_latency.py --unsplit
    PYTHONPATH=<other checkout> python lightglue_tpu_torch/scripts/host_latency.py
"""

from __future__ import annotations

import argparse
import functools
import time
from pathlib import Path

import numpy as np
import torch

import lightglue_tpu_torch
from lightglue_tpu_torch import LightGlue
from lightglue_tpu_torch import weights as weights_lib
from lightglue_tpu_torch.ops import assignment_fused, flash_cross
from lightglue_tpu_torch.ops import flash_cross_block, flash_self
from lightglue_tpu_torch.synthetic import planted_pairs

ROOT = Path(lightglue_tpu_torch.__file__).resolve().parents[1]
WEIGHTS = ROOT / "weights" / "synthetic_superpoint_lightglue.npz"
FIXED = dict(depth_confidence=-1.0, width_confidence=-1.0)
# (module, attribute) of the wrappers whose host time is summed per call
WRAPPERS = ((flash_self, "fused_self_block"),
            (flash_cross_block, "fused_cross_block"),
            (flash_cross, "fused_cross_attention"),
            (assignment_fused, "fused_filter_matches"))
HOST_MS = {attr: 0.0 for _, attr in WRAPPERS}


def timed(attr, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        HOST_MS[attr] += (time.perf_counter() - t0) * 1e3
        return out
    return wrapper


def unsplit_exact(plan):
    """K2's split plan with the exact modes' walks unsplit."""
    @functools.wraps(plan)
    def wrapper(dev, b, h, m, n, mode):
        return plan(dev, b, h, m, n, mode) if mode == flash_cross.SHIFT else (1, 1)
    return wrapper


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--calls", type=int, default=15)
    ap.add_argument("--unsplit", action="store_true",
                    help="add the default blocks with K2's exact walks unsplit")
    ap.add_argument("--device", default="cuda",
                    help="cpu: the plain versions, to rehearse the script")
    args = ap.parse_args()
    for mod, attr in WRAPPERS:
        setattr(mod, attr, timed(attr, getattr(mod, attr)))
    params = weights_lib.load_params(str(WEIGHTS))
    w = params["posenc"]["Wr"]["w"]
    params2 = dict(params, posenc={"Wr": {"w": torch.cat([w, w], 1)}})
    pr = planted_pairs(np.random.default_rng(11), 1, 1024)
    data = {f"image{i}": {"keypoints": pr[f"keypoints{i}"],
                          "descriptors": pr[f"descriptors{i}"],
                          "image_size": pr["image_size"]} for i in (0, 1)}
    cells = {}
    for mode, conf in (("fixed", FIXED), ("adaptive", {})):
        cells[f"{mode}, default"] = (LightGlue("superpoint", params=params,
                                               device=args.device, **conf),
                                     False)
        if args.unsplit:
            cells[f"{mode}, default, K2 unsplit"] = (cells[f"{mode}, default"][0],
                                                     True)
        cells[f"{mode}, 2 heads"] = (LightGlue("superpoint", params=params2,
                                               num_heads=2, device=args.device,
                                               **conf), False)
    plan = flash_cross.cross_splits if args.unsplit else None
    ms = {name: [] for name in cells}
    host = {name: dict.fromkeys(HOST_MS, 0.0) for name in cells}
    stops = {}
    for r in range(args.rounds):
        order = list(cells) if r % 2 == 0 else list(reversed(cells))
        for name in order:
            matcher, unsplit = cells[name]
            if plan is not None:
                flash_cross.cross_splits = unsplit_exact(plan) if unsplit else plan
            for _ in range(2):
                out = matcher(data)
            HOST_MS.update(dict.fromkeys(HOST_MS, 0.0))
            times = []
            for _ in range(args.calls):
                t0 = time.perf_counter()
                out = matcher(data)
                times.append((time.perf_counter() - t0) * 1e3)
            ms[name].append(times)
            for k, v in HOST_MS.items():
                host[name][k] += v / (args.calls * args.rounds)
            stops[name] = out["stop"]
        if plan is not None:
            flash_cross.cross_splits = plan
    card = (torch.cuda.get_device_name(0) if args.device == "cuda"
            else args.device)
    print(f"package {ROOT}, {card}, "
          f"{args.rounds} rounds of {args.calls} calls a cell after 2 warm-ups",
          flush=True)
    for name, rounds in ms.items():
        allc = np.concatenate(rounds)
        q1, med, q3 = np.percentile(allc, [25, 50, 75])
        per_round = " ".join(f"{np.median(t):.2f}" for t in rounds)
        wrappers = ", ".join(f"{k} {v:.3f}" for k, v in host[name].items() if v)
        print(f"  B 1 {name}: median {med:.3f} ms per call (quartiles "
              f"{q1:.3f}-{q3:.3f}; round medians {per_round}); host ms per "
              f"call in {wrappers}; stop {stops[name]}", flush=True)


if __name__ == "__main__":
    main()
