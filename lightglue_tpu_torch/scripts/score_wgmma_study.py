"""B11's and B12's bf16 forms (csrc/score_wgmma.cuh) in variants, on the
card.

    python -m lightglue_tpu_torch.scripts.score_wgmma_study [--time]

Builds csrc/score_head.cu from patched copies of the sources, one nvcc
process per variant, all started together, and prints each variant's
registers and spills (``-Xptxas -v``) and its SASS counted by pipe and
opcode for both kernels (``sass_counts``). Each variant then runs in a
process of its own (a variant that faults cannot take the others down):
``score_head.score_head_cplane_kernel`` and ``score_head_lazy_kernel`` at
mp on ALIKED's score parts of generated 768 x 1024 images at B 2
(``extract_times.aliked_params``' random weights) and on ragged random
parts (1 x 40 x 72, 1 x 61 x 83: a width TMA cannot address, the wrapper's
padded copy; 2 x 33 x 130: an odd height and a strip of 6 columns; 1 x 32 x
72: a branch of one row), against the plain versions at mp with
chip_smoke.py's flip check (|kernel - plain| <= 2e-2 max(1, |plain|) and
<= 2^-6 (|plain| + rms(plain row)) at all but 1e-4 of the outputs; the
share not equal is printed, the map being fp32), each launch twice, equal
to the bit. With ``--time``
each variant that passes is timed at B 1, 2 and 8 (768 x 1024) as device
ms from CUDA-graph replays.

Variants (``VARIANTS``): as committed (N filled with two rows x 4
channels, conv 4->1 on the CUDA cores: 36 FFMA a pixel from the stage-2
ring, one producer and one consumer warpgroup a block, three blocks an SM,
setmaxnreg 72 / 88); N one row of 4 channels (half of each accumulator
padding); conv 4->1 on wgmma; two consumers a block (one 64-pixel tile of
every stage each) and two blocks an SM (these three are unified diffs
against the header in ``score_wgmma_variants/``, applied by their hunks'
text, not their line numbers); two blocks an SM, or one; no setmaxnreg;
setmaxnreg 56 / 104; and, timed only, probes with a part cut out: B11 without its lerps, no consumer epilogue (the stage rings keep
their zeros; the score's sums still go out), no producer epilogue (s0 not
rounded nor SELU'd), no products. ``--debug`` records the barrier wait
that timed out and the last point each warp passed (``MARKS``) in host
memory, where a trap cannot lose them. ``--trace`` clocks one block's
consumer steps and producer rows (``TRACES``) and prints the clocks from
each mark to the next.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from lightglue_tpu_torch import _build
from lightglue_tpu_torch.models import aliked as al
from lightglue_tpu_torch.ops import score_head
from lightglue_tpu_torch.scripts.aliked_wgmma_study import (DEBUG_DEF, DEBUG_INIT,
                                                            DEBUG_N, DEBUG_WAIT,
                                                            PIPES, debug_report,
                                                            flips, rgb)
from lightglue_tpu_torch.scripts.extract_times import aliked_params, graph_ms
from lightglue_tpu_torch.synthetic import image_pair

H, W = 768, 1024
FLIPS = 1e-4  # chip_smoke.py's (its fp32 outputs' check)
HEADER = "score_wgmma.cuh"
PATCHES = Path(__file__).resolve().parent / "score_wgmma_variants"

REGS = "constexpr int kRegsP = 72, kRegsC = 88;"
PER_SM = "constexpr int PER_SM = 3;"


def blocks(per_sm, regs):
    """Patches for the blocks an SM and the setmaxnreg split."""
    return [(PER_SM, f"constexpr int PER_SM = {per_sm};"),
            (REGS, "constexpr int kRegsP = %d, kRegsC = %d;" % regs)]


def apply_diff(text: str, diff: str) -> str:
    """text with a unified diff's hunks applied, each found by its old text
    (context and removed lines), which must occur once; the hunks' line
    numbers are not read."""
    for hunk in re.split(r"^@@[^\n]*@@\n", diff, flags=re.M)[1:]:
        old, new = [], []
        for line in hunk.splitlines(keepends=True):
            if line[0] in " -":
                old.append(line[1:])
            if line[0] in " +":
                new.append(line[1:])
        old, new = "".join(old), "".join(new)
        if text.count(old) != 1:
            raise RuntimeError(f"a hunk's text occurs {text.count(old)} times:\n{old}")
        text = text.replace(old, new)
    return text


# name -> (patches to score_wgmma.cuh: (old, new), (file, old, new) for
# another file of csrc, or a Path of a unified diff; checked against the
# plain version; blocks an SM)
VARIANTS = {
    "as committed": ([], True, 3),
    "N one row of 4 channels": ([PATCHES / "one_row.patch"], True, 3),
    "conv 4->1 on wgmma": ([PATCHES / "conv3_wgmma.patch"], True, 3),
    "two consumers a block, two blocks an SM": (
        [PATCHES / "two_consumers.patch"] + blocks(2, (64, 88)), True, 2),
    "two blocks an SM": (blocks(2, (120, 136)), True, 2),
    "one block an SM": (blocks(1, (120, 240)), True, 1),
    "an s0 ring of 10 rows (B11 at two blocks an SM)": ([
        ("constexpr int R0 = 8, R1", "constexpr int R0 = 10, R1")], True, 3),
    "6 input rows in flight, 5 ahead (B11 at two blocks an SM)": ([
        ("constexpr int IMG_SLOTS = 4, IMG_AHEAD = 3;",
         "constexpr int IMG_SLOTS = 6, IMG_AHEAD = 5;")], True, 3),
    "no setmaxnreg": ([("    wg::regs_dec<kRegsP>();\n", ""),
                       ("  wg::regs_inc<kRegsC>();\n", "")], True, 3),
    "setmaxnreg 56 / 104": (blocks(3, (56, 104)), True, 3),
    # probes: a part cut out, timed only (their outputs are not the function's)
    "probe: no lerps (timing only)": ([
        ("            if constexpr (LAZY) {\n#pragma unroll\n              for (int kb = 0;",
         "            if constexpr (false) {\n#pragma unroll\n              for (int kb = 0;"),
        ("        const bool ahead = LAZY && l + 1 < nr",
         "        const bool ahead = false && l + 1 < nr"),
        ("        if (ra >= 0 && ra < H)  // row 0's windows",
         "        if (false)  // row 0's windows")], False, 3),
    "probe: no consumer epilogue (timing only)": ([
        ("        if (a1) {  // stage 1:", "        if (false) {  // stage 1:"),
        ("        if (a2) {  // stage 2:", "        if (false) {  // stage 2:")],
        False, 3),
    "probe: no producer epilogue (timing only)": ([
        ("            for (int j = 0; j < 4; ++j) wd[j] = round_selu2(v[2 * j], v[2 * j + 1]);",
         "            for (int j = 0; j < 4; ++j) wd[j] = __float_as_uint(v[2 * j] + v[2 * j + 1]);")],
        False, 3),
    "probe: no products (timing only)": ([
        ("        if (a1) conv1(ti, s);\n", "        if (a1 && H < 0) conv1(ti, s);\n"),
        ("        if (s % 2 == 0 && a2) conv2(ti, s / 2);\n",
         "        if (s % 2 == 0 && a2 && H < 0) conv2(ti, s / 2);\n"),
        ("  float acc[2][TILES][4];", "  float acc[2][TILES][4] = {};")],
        False, 3),
    "probe: no consumer fence (timing only)": ([
        ("    wg::fence_async_smem();  // the stage rows, seen by wgmma\n", "")], False, 3),
    "probe: sigmoid by an approximate division (timing only)": ([
        ("score_common.cuh", "  return __frcp_rn(1.f + ex2(-x * 1.4426950408889634f));",
         "  return __fdividef(1.f, 1.f + ex2(-x * 1.4426950408889634f));")], False, 3),
    "probe: no packed duplicates (timing only)": ([
        ("          if (p > 0) *reinterpret_cast<uint32_t*>(d + 16 * p - 8) = v;\n", "")],
        False, 3),
}
ENTRIES = ("lg_score_head_bf16", "lg_score_head_lazy_bf16", "lg_score_head_bf16_map")
# (anchor, mark): LG_MARK(mark) inserted after the anchor (--debug; an
# anchor that a variant's patches removed goes without its mark)
MARKS = [
    ("    wg::regs_dec<kRegsP>();\n", 1),
    ("        wg::named_sync(2, 128);\n", 3),
    ("        wg::bar_wait(&ifull[n % IMG_SLOTS], (n / IMG_SLOTS) & 1);\n", 4),
    ("        wg::bar_wait(&empty[k % R0], ((k / R0) & 1) ^ 1);\n", 5),
    ("        wg::bar_arrive(&full[k % R0]);\n", 6),
    ("  wg::regs_inc<kRegsC>();\n", 11),
    ("  wg::bar_wait(wbar, 0);\n  wg::named_sync(1, 128);\n", 12),
    ("        wg::bar_wait(&full[(k1 + i) % R0], ((k1 + i) / R0) & 1);\n", 13),
    ("      issue(J, n, kseg);\n      wg::mma_wait<0>();\n", 14),
    ("    wg::named_sync(1, 128);\n", 15),
]


# --trace: clock64 at these points (anchor, mark, before) by thread 0 of
# each warpgroup of block TRACE_BLOCK, into host memory: the consumer's
# steps (0 start, 1 rows waited for, 2 products done, 3 epilogues written,
# 4 barrier passed) and the producer's rows (10 barrier passed, 11 input
# row landed, 12 row computed, 13 slot free, 14 row handed on)
TRACE_BLOCK = 0
TRACE_N = 8192  # marks a warpgroup
TRACES = [
    ("    for (int J = 0; J < steps; ++J) {\n", 0, False),
    ("    wg::mma_fence();\n#pragma unroll\n    for (int s = 0;", 1, True),
    ("      issue(J, n, kseg);\n      wg::mma_wait<0>();\n", 2, False),
    ("    wg::fence_async_smem();  // the stage rows, seen by wgmma\n", 3, False),
    ("    wg::named_sync(1, 128);\n", 4, False),
    ("        wg::named_sync(2, 128);\n", 10, False),
    ("        wg::bar_wait(&ifull[n % IMG_SLOTS], (n / IMG_SLOTS) & 1);\n", 11, False),
    ("        wg::bar_wait(&empty[k % R0], ((k / R0) & 1) ^ 1);\n", 12, True),
    ("        wg::bar_wait(&empty[k % R0], ((k / R0) & 1) ^ 1);\n", 13, False),
    ("        wg::bar_arrive(&full[k % R0]);\n", 14, False),
]
TRACE_DEF = """
__device__ long long* lg_trace_ptr;
#define LG_TRACE(m) do { if (lg_trace_ptr != nullptr && blockIdx.x == %d && \\
    (threadIdx.x & 127) == 0 && lg_ti < %d) lg_trace_ptr[(threadIdx.x >> 7) * %d + lg_ti++] = \\
    (clock64() << 8) | (m); } while (0)
""" % (TRACE_BLOCK, TRACE_N, TRACE_N)
TRACE_INIT = """
extern "C" void* lg_trace_init(int n) {
  void* h = nullptr;
  void* d = nullptr;
  if (cudaHostAlloc(&h, n * 8, cudaHostAllocMapped) != cudaSuccess) return nullptr;
  memset(h, 0, n * 8);
  cudaHostGetDevicePointer(&d, h, 0);
  cudaMemcpyToSymbol(lg_trace_ptr, &d, sizeof d);
  return h;
}
"""


def add_marks(name: str, text: str, marks, macro: str) -> str:
    """text with ``macro(mark)`` at each (anchor, mark[, before]) of marks:
    after the anchor, or before it; a variant without the anchor goes
    without the mark."""
    for anchor, mark, *before in marks:
        if text.count(anchor) != 1:
            print(f"  {name}: no {macro} {mark}", flush=True)
            continue
        text = text.replace(anchor, f"{macro}({mark});\n" + anchor if before and before[0]
                            else anchor + f"{macro}({mark});\n")
    return text


def add_trace(name: str, text: str) -> str:
    """score_wgmma.cuh with the LG_TRACE marks (--trace)."""
    anchor = "  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;\n"
    assert text.count(anchor) == 1
    text = text.replace(anchor, anchor + "  int lg_ti = 0;\n")
    text = text.replace("namespace lg {\nnamespace swg {", TRACE_DEF + "namespace lg {\nnamespace swg {")
    return add_marks(name, text, TRACES, "LG_TRACE")


def build_variants(out_dir: Path, debug: bool = False, trace: bool = False) -> dict:
    jobs = {}
    for i, (name, (patches, _, _)) in enumerate(VARIANTS.items()):
        src = out_dir / f"v{i}"
        shutil.copytree(_build.CSRC, src)
        if trace:
            with open(src / "score_head.cu", "a") as f:
                f.write(TRACE_INIT)
        if debug:
            text = (src / "wgmma.cuh").read_text()
            for old, new in (DEBUG_WAIT, DEBUG_DEF):
                assert old in text, old
                text = text.replace(old, new)
            (src / "wgmma.cuh").write_text(text)
            with open(src / "score_head.cu", "a") as f:
                f.write(DEBUG_INIT)
        for patch in patches:
            if isinstance(patch, Path):
                text = apply_diff((src / HEADER).read_text(), patch.read_text())
                (src / HEADER).write_text(text)
                continue
            file, old, new = patch if len(patch) == 3 else (HEADER, *patch)
            text = (src / file).read_text()
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not in {file}")
            (src / file).write_text(text.replace(old, new))
        text = (src / HEADER).read_text()
        if debug:
            text = add_marks(name, text, MARKS, "LG_MARK")
        if trace:
            text = add_trace(name, text)
        (src / HEADER).write_text(text)
        lib = out_dir / f"v{i}.so"
        jobs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
             str(src / "score_head.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log = proc.communicate(timeout=900)[0]
        if proc.returncode != 0:
            print(f"  {name}: nvcc failed\n{log}", flush=True)
            continue
        fn = "?"
        for line in log.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif ("Used" in line or "spill" in line or "setmaxnreg" in line
                  or "wgmma" in line) and "score_wg_kernel" in fn:
                lazy = re.search(r"ILb(\d)E", fn).group(1)
                print(f"  {name}: score_wg_kernel<lazy {lazy}>: "
                      f"{line.split(':', 1)[-1].strip()}", flush=True)
        libs[name] = lib
        sass_counts(name, lib)
    return libs


def sass_counts(name: str, lib_path: Path) -> None:
    """score_wg_kernel's SASS (cuobjdump -sass) of each form, counted by
    pipe and by opcode. Its loops are not unrolled across rows: the
    producer's body runs once a staged s0 row (128 pixels), the consumer's
    once a step (two rows of 122 outputs); a variant without a part counts
    that part by difference."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        print("  cuobjdump not found: no instruction counts", flush=True)
        return
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    seqs, cur = {}, None
    for ln in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            k = re.search(r"score_wg_kernelILb(\d)E", m.group(1))
            cur = f"lazy {k.group(1)}" if k else None
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", ln)
        if cur and m:
            seqs.setdefault(cur, []).append(m.group(1).split(".")[0])
    for form, seq in sorted(seqs.items()):
        pipes, ops = {}, {}
        for op in seq:
            pipe = next((k for k, v in PIPES.items() if op in v), "other")
            pipes[pipe] = pipes.get(pipe, 0) + 1
            ops[op] = ops.get(op, 0) + 1
        print(f"  {name}: SASS of score_wg_kernel<{form}>, {len(seq)} instructions: "
              + ", ".join(f"{k} {v}" for k, v in sorted(pipes.items(), key=lambda kv: -kv[1]))
              + "; by opcode: " + ", ".join(f"{k} {v}" for k, v in sorted(
                  ops.items(), key=lambda kv: -kv[1])[:16]), flush=True)


def trace_report(lib) -> None:
    """B12 and B11 at B 2 on ALIKED's parts, traced (--trace): for block
    TRACE_BLOCK's consumer and producer, the mean, least and most clocks
    from each mark to the next, by the pair of marks, and the marks' span."""
    lib.lg_trace_init.restype = ctypes.c_void_p
    lib.lg_trace_init.argtypes = [ctypes.c_int]
    host = lib.lg_trace_init(2 * TRACE_N)
    buf = (ctypes.c_longlong * (2 * TRACE_N)).from_address(host)
    sh, parts = aliked_parts(2)
    s0 = score_head.upsampled_sum(*parts)
    for name, fn in (("B12", lambda: score_head.score_head_cplane_kernel(sh, s0, mp=True)),
                     ("B11", lambda: score_head.score_head_lazy_kernel(sh, *parts, mp=True))):
        fn()
        torch.cuda.synchronize()
        ctypes.memset(host, 0, 2 * TRACE_N * 8)
        fn()
        torch.cuda.synchronize()
        for wgi, who in ((0, "consumer"), (1, "producer")):
            recs = [(buf[wgi * TRACE_N + i] >> 8, buf[wgi * TRACE_N + i] & 255)
                    for i in range(TRACE_N) if buf[wgi * TRACE_N + i]]
            if not recs:
                print(f"    {name} {who}: no marks", flush=True)
                continue
            gaps = {}
            for (t0, m0), (t1, m1) in zip(recs, recs[1:]):
                gaps.setdefault((m0, m1), []).append(t1 - t0)
            print(f"    {name} {who}: {len(recs)} marks over {recs[-1][0] - recs[0][0]} "
                  "clocks; mark -> mark: mean / least / most clocks (count)", flush=True)
            for (m0, m1), v in sorted(gaps.items()):
                print(f"      {m0:2d} -> {m1:2d}: {sum(v) / len(v):8.0f} / {min(v):6d} / "
                      f"{max(v):6d} ({len(v)})", flush=True)


def use(lib_path: str, debug: bool = False):
    lib = ctypes.CDLL(lib_path)
    for entry in ENTRIES:
        fn = getattr(lib, entry)
        fn.argtypes = _build.SIGNATURES[entry]
        fn.restype = ctypes.c_int
    _build._lib = lib
    if debug:
        lib.lg_dbg_init.restype = ctypes.c_void_p
        lib.lg_dbg_init.argtypes = [ctypes.c_int]
        return lib.lg_dbg_init(DEBUG_N)
    return None


def aliked_parts(b: int):
    """ALIKED's score parts (s1 .. s4, fp32) of b generated 768 x 1024
    images, and the score head's weights (``extract_times.aliked_params``)."""
    rng = np.random.default_rng(5)
    gray = np.stack([image_pair(rng, H, W)[0] for _ in range(b)])
    ap = aliked_params()
    img = torch.from_numpy(rgb(gray)).cuda()
    with torch.inference_mode():
        ys, _ = al._dense_branches(ap, img, fused_stem=False)
        parts = al._score_parts(ap["score_head"], ys, True)
    return ap["score_head"], [p.contiguous() for p in parts]


def ragged_parts(g, b, h, w):
    return [torch.randn(b, 8, max(1, h // f), max(1, w // f), generator=g,
                        device="cuda") for f in (1, 2, 8, 32)]


def cases():
    """(label, weights, parts): ALIKED's at B 2 and the ragged ones."""
    sh, parts = aliked_parts(2)
    g = torch.Generator(device="cuda").manual_seed(6)
    out = [("aliked B 2", sh, parts)]
    for shape in ((1, 40, 72), (1, 61, 83), (2, 33, 130), (1, 32, 72)):
        out.append((f"{shape}", sh, ragged_parts(g, *shape)))
    return out


def checks(host=None) -> bool:
    ok = True
    for label, sh, parts in cases():
        s0 = score_head.upsampled_sum(*parts)
        for name, kern, plain in (
                ("B12", lambda: score_head.score_head_cplane_kernel(sh, s0, mp=True),
                 lambda: score_head.score_tail_plain(sh, s0, mp=True)),
                ("B11", lambda: score_head.score_head_lazy_kernel(sh, *parts, mp=True),
                 lambda: score_head.score_head_lazy_plain(sh, *parts, mp=True))):
            try:
                a, b = kern(), kern()
                torch.cuda.synchronize()
            except RuntimeError as e:
                print(f"    {name} {label}: {e}", flush=True)
                debug_report(host)
                return False
            over, differ, err = flips(a, plain())
            same = torch.equal(a, b)
            # an fp32 map: its sums in another order differ in the last
            # bits everywhere, so only the share over either bound counts
            good = over <= FLIPS and same and bool(torch.isfinite(a).all())
            ok &= good
            print(f"    {name} {label}: over {over:.2e}, not equal {differ:.2e}, "
                  f"max_abs_err {err:.3e}, twice equal {same}"
                  f"{'' if good else '  FAILS'}", flush=True)
    return ok


def launches(host=None) -> bool:
    """An unchecked variant's launches on ALIKED's parts at B 2: that they
    run (their outputs are not the function's)."""
    sh, parts = aliked_parts(2)
    s0 = score_head.upsampled_sum(*parts)
    try:
        score_head.score_head_cplane_kernel(sh, s0, mp=True)
        score_head.score_head_lazy_kernel(sh, *parts, mp=True)
        torch.cuda.synchronize()
    except RuntimeError as e:
        print(f"    {e}", flush=True)
        debug_report(host)
        return False
    print("    B12, B11 at B 2: run", flush=True)
    return True


def times() -> None:
    sh, parts8 = aliked_parts(8)
    for b in (1, 2, 8):
        parts = [p[:b].contiguous() for p in parts8]
        s0 = score_head.upsampled_sum(*parts)
        t12 = graph_ms(lambda: score_head.score_head_cplane_kernel(sh, s0, mp=True))
        t11 = graph_ms(lambda: score_head.score_head_lazy_kernel(sh, *parts, mp=True))
        print(f"    B {b}: B12 {t12:.4f} ms, B11 {t11:.4f} ms (device, CUDA "
              "graphs)", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--run", help=argparse.SUPPRESS)
    ap.add_argument("--per-sm", type=int, default=3, help=argparse.SUPPRESS)
    ap.add_argument("--unchecked", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--debug", action="store_true",
                    help="record timed-out barrier waits before the trap")
    ap.add_argument("--trace", action="store_true",
                    help="clock the steps and rows of one block (marks TRACES)")
    ap.add_argument("--only", nargs="*", default=None,
                    help="variants whose name holds one of these words")
    args = ap.parse_args()
    if args.run:  # one variant, in its own process
        host = use(args.run, args.debug)
        score_head.PER_SM = args.per_sm
        if args.trace:
            trace_report(_build._lib)
            sys.exit(0)
        ok = launches(host) if args.unchecked else checks(host)
        if ok and args.time:
            times()
        sys.exit(0 if ok else 1)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"  {card}", flush=True)
    if args.only is not None:
        for name in list(VARIANTS):
            if not any(w in name for w in args.only):
                del VARIANTS[name]
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(Path(tmp), args.debug, args.trace)
        for name, lib in libs.items():
            _, checked, per_sm = VARIANTS[name]
            print(f"  {name}:", flush=True)
            cmd = [sys.executable, "-m",
                   "lightglue_tpu_torch.scripts.score_wgmma_study", "--run",
                   str(lib), "--per-sm", str(per_sm)] + (
                       ["--time"] if args.time else []) + (
                       [] if checked else ["--unchecked"]) + (
                       ["--debug"] if args.debug else []) + (
                       ["--trace"] if args.trace else [])
            try:
                res = subprocess.run(cmd, timeout=600)
                print(f"  {name}: exit {res.returncode}", flush=True)
            except subprocess.TimeoutExpired:
                print(f"  {name}: timed out", flush=True)


if __name__ == "__main__":
    main()
