"""The harness is driven by files: a cell added as files is found and run
without an edit to any code."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def test_a_new_cell_runs_from_files_alone(tmp_path):
    """Copy the benchmark beside the port, add a traffic mix, a cell file,
    a metric's reader and their BENCHMARK.json entries, and rehearse it."""
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "lightglue_tpu_torch").symlink_to(ROOT / "lightglue_tpu_torch")
    (tmp_path / "weights").symlink_to(ROOT / "weights")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "sp-lg.pairs-b4-new", "config": "superpoint-lightglue",
        "traffic": "tiny-pairs-new", "chips": 1, "why": "a test's cell"})
    bench["end_to_end"].append({
        "name": "match_pairs_per_s", "unit": "pairs/s", "better": "higher",
        "bound": 0.25, "source": "host_clock",
        "workloads": ["sp-lg.pairs-b4-new"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "portbench/traffic/tiny-pairs-new.json").write_text(
        json.dumps({"kind": "planted_pairs", "pairs_per_request": 3,
                    "requests": 2, "keypoints": [150, 250], "size_seed": 1,
                    "image_size": [320, 240], "desc_dim": 256}))
    (tmp_path / "portbench/metrics/match_pairs_per_s.py").write_text(
        "from portbench.core.readers import pairs_per_s as read\n")
    (tmp_path / "portbench/cells/sp-lg.pairs-b4-new.json").write_text(
        json.dumps({"entry": "batch_matcher", "precision": "fp32",
                    "adaptive": True, "max_batch": 4, "trace_requests": 2,
                    "limits": {"score_gap": 1e-3}}))
    code = ("import sys, json; sys.path.insert(0, '.');"
            "from portbench.core import layout; from portbench import run;"
            "line = run.execute(layout.Cell('sp-lg.pairs-b4-new'), 11, 5.0,"
            " False, 'cpu'); print(json.dumps(line))")
    # two threads: a rehearsal beside parallel test workers on all cores
    # serves a request past its window
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(tmp_path), env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["check"]
    assert set(line["metrics"]) == {"match_pairs_per_s", "setup_s"}
    assert line["metrics"]["match_pairs_per_s"]["value"] > 0
