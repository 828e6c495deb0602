"""B2's score tiles on the card: the step sums and the tile, each checked
and timed.

    python -m lightglue_tpu_torch.scripts.assign_study

Builds csrc/assignment_fused.cu (with csrc/gemm_tc.cuh) twice, one nvcc
each, both started together: as committed, where each 8-deep step's three
tf32 products are summed into a zeroed register tile and added to the
accumulator in fp32 (``kStepSums``), and with the products accumulated in
place by the tensor core. For each build and each tile of gemm_tc.cuh it
runs B2 (``_filter_reductions_kernel``) at B 1, 4 and 16 on 1024 x 1024
scores of D 256, on two inputs: planted pairs with descriptors times 3 and
exact ties (chip_smoke.py's kind), and standard normals times 0.4 with rows
planted as four times a column (scores up to about 160), where the
accumulator grows large. It prints the maxima's largest error against the
fp32 plain version and against a float64 one (and the plain version's own
against float64), whether every argmax with a top-two gap over 1e-3 is
equal, and the device time from CUDA-graph replays, with the tile that
``tile_plan`` takes marked. Prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from ..ops import assignment_fused as af
from ..ops import block_tc
from ..synthetic import planted_pairs
from .attn_split import graph_ms

ROOT = Path(__file__).resolve().parents[2]
STEP_SUMS = "mainloop<T, RowSrc, true, true>"
VARIANTS = {"committed (step sums)": STEP_SUMS,
            "sums in place": "mainloop<T, RowSrc, true, false>"}
ENTRIES = ("lg_assign_tiles", "lg_assign_merge_lse", "lg_assign_merge_argmax")


def build_variants(out_dir: Path) -> dict:
    """{variant: library path}, one nvcc process per variant."""
    jobs = {}
    for i, (name, text) in enumerate(VARIANTS.items()):
        src = out_dir / f"v{i}"
        shutil.copytree(_build.CSRC, src)
        cu = src / "assignment_fused.cu"
        code = cu.read_text()
        if STEP_SUMS not in code:
            raise RuntimeError(f"{STEP_SUMS!r} not in assignment_fused.cu")
        cu.write_text(code.replace(STEP_SUMS, text))
        lib = out_dir / f"v{i}.so"
        jobs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log = proc.communicate(timeout=900)[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        libs[name] = lib
    return libs


def use(lib_path: Path) -> None:
    """Route _build.launch's B2 entry points to this variant's library."""
    lib = ctypes.CDLL(str(lib_path))
    for entry in ENTRIES:
        fn = getattr(lib, entry)
        fn.argtypes = _build.SIGNATURES[entry]
        fn.restype = ctypes.c_int
    _build._lib = lib


def inputs(kind: str, b: int, seed: int) -> tuple:
    """(mdesc0, mdesc1, ls0, ls1, mask0, mask1) at 1024 x 1024, D 256."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = 1024
    if kind == "planted":
        pr = planted_pairs(np.random.default_rng(seed), b, n)
        d0, d1 = (torch.from_numpy(pr[f"descriptors{i}"]).cuda() * 3.0
                  for i in (0, 1))
        d0[:, 5] = d1[:, 100] * 4.0
        d1[:, 700] = d1[:, 100]
    else:
        d0 = torch.randn(b, n, 256, generator=g, device="cuda") * 0.4
        d1 = torch.randn(b, n, 256, generator=g, device="cuda") * 0.4
        for i, j in ((5, 100), (300, 650), (900, 20)):
            d0[:, i] = d1[:, j] * 4.0
    z0, z1 = (torch.randn(b, n, generator=g, device="cuda") for _ in "01")
    masks = [torch.rand(b, n, generator=g, device="cuda") < 0.9
             for _ in "01"]
    return d0, d1, F.logsigmoid(z0), F.logsigmoid(z1), *masks


def launch_at(x, tile: int):
    """B2's launches on inputs ``x`` at the score tile ``tile`` (an index
    into TILES) in place of the one ``tile_plan`` picks."""
    plan = af.tile_plan
    af.tile_plan = lambda *_: tile
    try:
        return af._filter_reductions_kernel(*x)
    finally:
        af.tile_plan = plan


def errors(x) -> tuple:
    """(kernel vs fp32 plain, kernel vs float64, fp32 plain vs float64) of
    the maxima on valid rows and columns, and whether the argmax agrees on
    every row and column with a clear maximum."""
    got = af._filter_reductions_kernel(*x)
    want = af.filter_reductions_plain(*x)
    x64 = [t.double() if t.is_floating_point() else t for t in x]
    ref = af.filter_reductions_plain(*x64)
    mk0, mk1 = x[4], x[5]

    def err(a, c):
        return max(float((a[1] - c[1]).abs()[mk0].max()),
                   float((a[3] - c[3]).abs()[mk1].max()))

    b, m, _ = x[0].shape
    sim = x64[0] @ x64[1].transpose(1, 2)
    bias0 = af._bias(mk0, b, m, "cuda")[:, :, None].double()
    bias1 = af._bias(mk1, b, x[1].shape[1], "cuda")[:, None, :].double()
    s = sim + bias1 + bias0
    rterm = af._terms(x64[2], torch.logsumexp(s, 2), mk0)
    cterm = af._terms(x64[3], torch.logsumexp(s, 1), mk1)
    t = sim * 2 + bias1 + bias0
    top0 = (t + cterm[:, None, :]).topk(2, dim=2).values
    top1 = (t + rterm[:, :, None]).topk(2, dim=1).values
    sure0 = ((top0[..., 0] - top0[..., 1]) > 1e-3) & mk0
    sure1 = ((top1[:, 0] - top1[:, 1]) > 1e-3) & mk1
    agree = (bool((got[0].long() == ref[0])[sure0].all())
             and bool((got[2].long() == ref[2])[sure1].all()))
    return err(got, want), err(got, ref), err(want, ref), agree


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"  {smi}")
    sms = block_tc.sms(0)
    data = {(kind, b): inputs(kind, b, 7 + b)
            for kind in ("planted", "normal") for b in (1, 4, 16)}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(Path(tmp))
        try:
            for name, lib in libs.items():
                use(lib)
                print(f"  {name}:", flush=True)
                for (kind, b), x in data.items():
                    plan = af.tile_plan(b, 1024, 1024, sms)
                    e = errors(x)
                    times = []
                    for tile in range(len(block_tc.TILES)):
                        ms = graph_ms(lambda: launch_at(x, tile))
                        bm, bn = block_tc.TILES[tile]
                        times.append(f"{bm}x{bn}{'*' if tile == plan else ''}"
                                     f" {ms:.4f}")
                    print(f"    {kind} B {b}: max err {e[0]:.2e} against "
                          f"fp32, {e[1]:.2e} against float64 (plain: "
                          f"{e[2]:.2e}); argmax {'equal' if e[3] else 'DIFFERS'}"
                          f" on clear maxima; device ms by tile (* the plan's)"
                          f": {', '.join(times)}", flush=True)
        finally:
            _build._lib = None  # the full library again, built on next use


if __name__ == "__main__":
    os.chdir(ROOT)
    main()
