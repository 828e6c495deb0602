"""Benchmark of the PyTorch and CUDA port of LightGlue on one H100.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell's system, makes its traffic from the seed, warms up every
shape that traffic uses (set-up), serves requests in closed loop for
``--seconds``, checks what the timed path produced against the plain
reference, and prints one JSON line: the cell's end-to-end metrics
(``--trace 0``) or its per-layer metrics from a profiled slice after the
window (``--trace 1``). Without a CUDA card it exits 2 and prints no
result. See portbench/README.md.
"""

from __future__ import annotations

import time

T0 = time.time()  # process start, as near as the interpreter allows

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.core import device, layout, trace, window  # noqa: E402

# top-level module names that may not be loaded in a run (compared whole:
# lightglue_tpu_torch, the port, is allowed)
FORBIDDEN = ("jax", "jaxlib", "flax", "lightglue_tpu")


def forbidden_modules():
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


class Run:
    """What the readers in ``metrics/`` read."""

    def __init__(self, cell, entry, setup_s, win, slc, slice_requests):
        self.cell, self.entry, self.setup_s = cell, entry, setup_s
        self.window, self.slice = win, slc
        self.slice_requests = slice_requests
        self.precision = cell.cell["precision"]


def sample(kept: dict, n, seed: int) -> dict:
    """The kept answers the check runs on: all of them, or ``n`` drawn from
    the seed where the cell names a number."""
    if not n or len(kept) <= n:
        return kept
    keys = np.random.default_rng(seed).choice(sorted(kept), n, replace=False)
    return {int(k): kept[int(k)] for k in sorted(keys)}


def execute(cell, seed: int, seconds: float, traced: bool, dev: str,
            t0: float = T0) -> dict:
    """One run of ``cell`` on ``dev`` (``cuda``; ``cpu`` only in the
    tests' rehearsal); returns the result line's object."""
    import torch

    entry = cell.entry().Entry(cell, dev)
    entry.build(seed)
    entry.make_pool(seed)
    entry.warm()
    if dev == "cuda":
        torch.cuda.synchronize()
    setup_s = time.time() - t0
    entry.record_spans(traced)
    win = window.run(entry.serve, len(entry.pool), seconds, seed)
    slc, first = None, len(win.requests)
    count = cell.cell["trace_requests"]
    if traced:
        _, slc = trace.profile(entry.serve, first, count)
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    entry.finish()
    entry.release()
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.time()
    numbers = entry.judge(sample(win.kept, cell.cell.get("judge_requests"),
                                 seed))
    print(f"reference check {time.time() - t_judge:.1f} s", file=sys.stderr)
    limits = cell.cell["limits"]
    # a broken answer reads inf; the line carries a finite stand-in
    check = {k: {"value": min(numbers.get(k, float("inf")), 1e30),
                 "limit": limits[k]} for k in limits}
    # every request answered, every pool entry answered, every number
    # within its limit
    correct = (win.failed == 0 and len(win.kept) == len(entry.pool)
               and all(v["value"] <= v["limit"] for v in check.values()))
    run = Run(cell, entry, setup_s, win, slc, range(first, first + count))
    metrics = {}
    for m in cell.metrics(traced):
        value = layout.module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = (device.describe(cell.workload["chips"]) if dev == "cuda"
                else {"platform": "cpu", "kind": "cpu", "count": 1})
    dev_info["memory_peak_bytes"] = peak
    line = {"correct": correct, "attempted": len(win.requests),
            "failed": win.failed, "metrics": metrics, "device": dev_info}
    if traced:
        dev_info["busy_s"] = slc.busy_s
        dev_info["window_s"] = slc.window_s
        line["breakdown"] = slc.breakdown()
    line["check"] = check
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = layout.Cell(args.workload)
    try:
        device.require(cell.workload["chips"])
    except device.NoCard as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    line = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"no result: modules loaded that the port may not use: {bad}",
              file=sys.stderr)
        return 3
    for name, c in line["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
