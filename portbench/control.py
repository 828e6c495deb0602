"""The readings that the limits of ``correct`` are set from.

    python3 portbench/control.py --workload <cell> --system <program|tf32|fp8> \
        --seeds 1 2 3 [--fault <name>] [--out file.jsonl] [--detail file.jsonl]

Builds the cell's system once (the program, or the plain reference in its
place computed in the precision named: the control), and for each seed
makes the cell's traffic pool, serves every request of it once, as a run's
window does (the control: only those that the check samples), and judges
the answers that a run would judge, as a run judges them. ``--fault``
plants one of ``faults.FAULTS`` in the program first. Prints one JSON line
a seed with every number the check computes and those above the cell's
limits; ``--detail`` writes each judged request's numbers. The benchmark's
runs do not run this; ``tests/test_portbench_control.py`` runs it at a
test's size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import faults, run  # noqa: E402
from portbench.core import layout  # noqa: E402

# the nearest precision below each cell's: float32 with TF32 off -> TF32;
# bf16 -> fp8
CONTROL = {"fp32": "tf32", "bf16": "fp8"}


def failed(cell, numbers) -> list:
    """The numbers above the cell's limits."""
    return [k for k, lim in cell.cell["limits"].items()
            if not numbers.get(k, float("inf")) <= lim]


def readings(cell, system: str, seeds, dev: str = "cuda"):
    """Yield (seed, numbers, each judged request's numbers) for each seed;
    ``system`` "control" is the cell's control."""
    if system == "control":
        system = CONTROL[cell.cell["precision"]]
    entry = cell.entry().Entry(cell, dev, system)
    n = cell.cell.get("judge_requests")
    for seed in seeds:
        entry.build(seed)
        entry.make_pool(seed)
        every = range(len(entry.pool))
        judged = run.sample(dict.fromkeys(every), n, seed)
        kept = {p: entry.serve(p)[0] for p in every
                if system == "program" or p in judged}
        entry.finish()
        yield seed, entry.judge({p: kept[p] for p in judged}), entry.detail


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--system", default="program",
                    help="program, control (the cell's), tf32 or fp8")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    ap.add_argument("--out")
    ap.add_argument("--detail")
    args = ap.parse_args(argv)
    cell = layout.Cell(args.workload)
    if args.fault:
        faults.FAULTS[args.fault](faults.Plant)
    tag = {"workload": args.workload, "system": args.system,
           "fault": args.fault}
    for seed, numbers, detail in readings(cell, args.system, args.seeds):
        line = json.dumps({**tag, "seed": seed, "time": time.time(),
                           **numbers, "above_limits": failed(cell, numbers)})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        if args.detail:
            with open(args.detail, "a") as f:
                f.write(json.dumps({**tag, "seed": seed,
                                    "requests": detail}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
