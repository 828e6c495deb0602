"""Where the benchmark's files are, found by the names in BENCHMARK.json.

A cell is ``BENCHMARK.json``'s workload entry (its configuration and
traffic names) with ``cells/<cell>.json`` (entry kind, precision, batch,
limits); ``configs/<config>.json`` holds the model's sizes,
``traffic/<traffic>.json`` the traffic mix, whose ``kind`` names the
generator ``traffic/<kind>.py``; ``entries/<entry>.py`` drives the
program; ``metrics/<metric>.py`` reads one metric. Adding any of them is
adding a file.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return read_json(ROOT / "BENCHMARK.json")


def module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    key = f"portbench.{kind}._file_{name.replace('.', '_').replace('-', '_')}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


class Cell:
    """One workload: its BENCHMARK.json entry and its files."""

    def __init__(self, name: str, bench: Dict = None):
        bench = bench or benchmark()
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.bench = name, bench
        self.workload = entries[name]
        self.cell = read_json(BENCH / "cells" / f"{name}.json")
        self.config = read_json(BENCH / "configs"
                                / f"{self.workload['config']}.json")
        self.traffic = read_json(BENCH / "traffic"
                                 / f"{self.workload['traffic']}.json")

    def metrics(self, trace: bool) -> List[Dict]:
        """The metrics this cell reports: end-to-end without trace,
        per-layer with it (each listing this cell, or listing none)."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if self.name in m.get("workloads", [self.name])]

    def entry(self):
        return module("entries", self.cell["entry"])

    def generator(self):
        return module("traffic", self.traffic["kind"])
