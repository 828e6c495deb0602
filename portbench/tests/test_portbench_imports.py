"""What the benchmark loads: never JAX, never the JAX package; and its
references nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

REHEARSAL = """
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import tiny
from portbench import run
run.execute(tiny.cell({cell!r}), 2**31 + 5, 0.5, False, "cpu")
print(json.dumps({{"modules": sorted({{m.split(".")[0] for m in sys.modules}}),
                  "forbidden": run.forbidden_modules()}}))
"""


@pytest.mark.parametrize("cell", ["sp-lg.latency-b1", "sp-lg.images-b8"])
def test_a_run_loads_no_jax(cell):
    """A whole run (its CPU rehearsal) in a fresh process: no module whose
    top-level name is jax, jaxlib, flax or lightglue_tpu (compared whole:
    lightglue_tpu_torch is the port)."""
    code = REHEARSAL.format(root=str(ROOT), tests=str(BENCH / "tests"),
                            cell=cell)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["forbidden"] == []
    assert "lightglue_tpu_torch" in res["modules"]
    assert not {"jax", "jaxlib", "flax", "lightglue_tpu"} & set(res["modules"])


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield ("." * node.level) + (node.module or "")


def test_sources_name_no_jax():
    for path in BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path) if m[:1] != "."}
        assert not tops & {"jax", "jaxlib", "flax", "lightglue_tpu"}, path


def test_references_import_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        for mod in _imports(path):
            assert not mod.startswith("lightglue_tpu"), (path, mod)
            assert mod.startswith((".", "__future__", "math", "typing",
                                   "contextlib", "numpy", "torch")), (
                path, mod)


def test_no_card_no_result():
    """Without CUDA the command exits 2 and prints no result."""
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "sp-lg.latency-b1", "--seed", str(2**31 + 9), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=str(ROOT))
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "cuda" in out.stderr.lower()
