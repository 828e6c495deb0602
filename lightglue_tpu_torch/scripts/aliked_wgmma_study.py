"""B10's bf16 form (csrc/aliked_wgmma.cuh) in variants, on the card.

    python -m lightglue_tpu_torch.scripts.aliked_wgmma_study [--time]

Builds csrc/aliked_stem.cu from patched copies of the sources, one nvcc
process per variant, all started together, and prints each variant's
registers and spills (``-Xptxas -v``). Each variant then runs in a process
of its own (a variant that faults cannot take the others down):
``aliked_stem.fused_aliked_stem_kernel`` on bf16 images at aliked-n16 and
aliked-t16 (``extract_times.aliked_params``), 768 x 1024 at B 2 and ragged
34 x 70 (a width TMA cannot address: the wrapper's padded copy), 40 x 200
and 40 x 72, against ``fused_aliked_stem_plain`` with chip_smoke.py's flip
check (|kernel - plain| <= 2e-2 max(1, |plain|) and <= 2^-6 (|plain| +
rms(plain row)) at all but 1e-4 of the outputs, equal at all but 1e-2),
each launch twice, equal to the bit. With ``--time`` each variant that
passes is timed at aliked-n16, B 1, 2 and 8 (768 x 1024) as device ms from
CUDA-graph replays. Each variant's SASS (``cuobjdump -sass``) is counted
by pipe and opcode (``sass_counts``).

Variants (``VARIANTS``): as committed; the 1x1 as CY / 8 ``mma.sync``
m16n8k16 a warp (A from the same registers, B fragments from shared
memory) in place of one ``wgmma`` m64nCYk16 a row; a ring of 12 staged rows
and 7 image slots (modulo a non-power of two); two consumer warpgroups a
block and two blocks an SM (the first design); one block an SM, or four
(48 / 80 registers); no ``setmaxnreg``; and, timed only, conv1 without its products (the
producer stages its rows from zero sums), and the consumer's or the
producer's epilogue compiled out (their SASS counted by difference). ``--debug`` records
the barrier wait that timed out and the last point each warp passed
(``MARKS``) in host memory, where a trap cannot lose them.
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
from lightglue_tpu_torch.ops import aliked_stem
from lightglue_tpu_torch.scripts.extract_times import aliked_params, graph_ms
from lightglue_tpu_torch.synthetic import image_pair

H, W = 768, 1024
BF = torch.bfloat16
REL, SCALED, FLIPS, DIFFER = 2e-2, 2.0 ** -6, 1e-4, 1e-2  # chip_smoke.py's

# the committed 1x1 (one wgmma a row) and its alternative, CY / 8 mma.sync
# m16n8k16 a warp from the same registers, B fragments from shared memory
ONE_WGMMA = """      float ya[2][CY / 2];
      wg::mma_fence();
      mma_rs<CY>(ya[0], a[0], dwy);
      mma_rs<CY>(ya[1], a[1], dwy);
      wg::mma_commit();
"""
MMA_SYNC = """      float ya[2][CY / 2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int nt = 0; nt < CY / 8; ++nt) {
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          const uint32_t bb[2] = {
              *reinterpret_cast<const uint32_t*>(Ws + G::oWY + (8 * nt + g) * 16 + 4 * t),
              *reinterpret_cast<const uint32_t*>(Ws + G::oWY + (CY + 8 * nt + g) * 16 + 4 * t)};
          tc::mma_bf16(c, a[r], bb);
#pragma unroll
          for (int e = 0; e < 4; ++e) ya[r][4 * nt + e] = c[e];
        }
"""
YA_WAIT = "      wg::mma_wait<0>();\n      wg::reg_fence(ya[0]);\n      wg::reg_fence(ya[1]);\n"
RING12 = [("constexpr int IMG_SLOTS = 8, IMG_AHEAD = 3;", "constexpr int IMG_SLOTS = 7, IMG_AHEAD = 3;"),
          ("static constexpr int R = 8;", "static constexpr int R = 12;")]
# name -> (patches to aliked_wgmma.cuh, checked against the plain version,
# blocks an SM)
VARIANTS = {
    "as committed": ([], True, 3),
    "1x1 on mma.sync m16n8k16": ([(ONE_WGMMA, MMA_SYNC), (YA_WAIT, "")], True, 3),
    "a ring of 12 rows, 7 image slots": (RING12, True, 3),
    "two consumers a block, two blocks an SM": ([
        ("constexpr int NCONS = 1;", "constexpr int NCONS = 2;"),
        ("constexpr int PER_SM = 3;", "constexpr int PER_SM = 2;"),
        ("kProdRegs = 72, kConsRegs = 88;", "kProdRegs = 56, kConsRegs = 88;")], True, 2),
    "one block an SM": ([("constexpr int PER_SM = 3;", "constexpr int PER_SM = 1;")],
                        True, 1),
    "four blocks an SM": ([
        ("constexpr int PER_SM = 3;", "constexpr int PER_SM = 4;"),
        ("kProdRegs = 72, kConsRegs = 88;", "kProdRegs = 48, kConsRegs = 80;")], True, 4),
    "no setmaxnreg": ([("    wg::regs_dec<kProdRegs>();\n", ""),
                       ("  wg::regs_inc<kConsRegs>();\n", "")], True, 3),
    "conv1 without its products (timing only)": ([
        ("              mma_ss<C1>(acc[ti], dtaps",
         "              if (H < 0) mma_ss<C1>(acc[ti], dtaps"),
        ("        float acc[3][C1 / 2];",
         "        float acc[3][C1 / 2] = {};")], False, 3),
    # the epilogues compiled out: their SASS counts by difference
    "no consumer epilogue (timing only)": ([
        ("    wg::named_sync(1 + wgi, 128);  // the staging's last reads are done\n",
         "    continue;\n"
         "    wg::named_sync(1 + wgi, 128);  // the staging's last reads are done\n")],
        False, 3),
    "no producer epilogue (timing only)": ([
        ("        if (in) {\n          // acc[ti][4 j + 2 h + e]",
         "        if (false) {\n          // acc[ti][4 j + 2 h + e]")], False, 3),
}
ENTRIES = ("lg_aliked_stem_bf16", "lg_aliked_stem_bf16_map", "lg_aliked_stem")
# --debug: a barrier wait that times out (2^31 clocks) records its warp's
# (1, thread, barrier address, parity) in host memory, waits 2^28 clocks
# more (so that the others record too) and traps; marks (LG_MARK) record
# the last point each warp passed (block x 16 + warp)
SLOTS = 16 * 512
DEBUG_WAIT = ("    if (clock64() - t0 > (1ll << 33)) __trap();",
              """    if (clock64() - t0 > (1ll << 31)) {
      int* p = lg_dbg_ptr;
      if (p != nullptr) {
        int* q = p + 4 * (blockIdx.x * 16 + (threadIdx.x >> 5) % 16);
        q[0] = 1, q[1] = threadIdx.x, q[2] = (int)a, q[3] = parity;
        __threadfence_system();
      }
      const long long t1 = clock64();
      while (clock64() - t1 < (1ll << 28)) {
      }
      __trap();
    }""")
DEBUG_DEF = ("namespace lg {\nnamespace wg {",
             "__device__ int* lg_dbg_ptr;\n#define LG_MARK(n) do { if (lg_dbg_ptr != nullptr "
             "&& (threadIdx.x & 31) == 0) { lg_dbg_ptr[%d + blockIdx.x * 16 + "
             "(threadIdx.x >> 5)] = (n); __threadfence_system(); } } while (0)\n\n"
             "namespace lg {\nnamespace wg {" % (4 * SLOTS))
# (anchor, mark): LG_MARK(mark) inserted after the anchor
MARKS = [
    ("    wg::regs_dec<kProdRegs>();\n", 1),
    ("\n    wg::bar_wait(wbar, 0);\n", 2),
    ("its image rows and taps read\n        wg::named_sync(3, 128);\n", 7),
    ("                          ra - 1 + issued, 3 * b);\n          }\n", 8),
    ("          wg::bar_wait(&ifull[n % IMG_SLOTS], (n / IMG_SLOTS) & 1);\n        }\n", 3),
    ("\n          wg::mma_wait<0>();\n", 4),
    ("        wg::bar_wait(&empty[s], ((k / R) & 1) ^ 1);\n", 5),
    ("        wg::bar_arrive(&full[s]);\n", 6),
    ("  wg::regs_inc<kConsRegs>();\n", 11),
    ("\n  wg::bar_wait(wbar, 0);\n", 12),
    ("      wg::bar_wait(&full[(k0 + i) % R], ((k0 + i) / R) & 1);\n", 13),
    ("\n    wg::mma_wait<0>();\n", 14),
    ("      // the pool: the rows (round(upper) is the A fragment's half), then\n", 15),
    ("    // x1p: C1 channel rows of 64 pooled columns, 16 bytes a thread\n", 16),
]
DEBUG_INIT = """
extern "C" void* lg_dbg_init(int n) {
  void* h = nullptr;
  void* d = nullptr;
  if (cudaHostAlloc(&h, n * 4, cudaHostAllocMapped) != cudaSuccess) return nullptr;
  memset(h, 0, n * 4);
  cudaHostGetDevicePointer(&d, h, 0);
  cudaMemcpyToSymbol(lg_dbg_ptr, &d, sizeof d);
  return h;
}
"""
DEBUG_N = 5 * SLOTS


def build_variants(out_dir: Path, debug: bool = False) -> dict:
    jobs = {}
    for i, (name, (patches, _, _)) in enumerate(VARIANTS.items()):
        src = out_dir / f"v{i}"
        shutil.copytree(_build.CSRC, src)
        if debug:
            text = (src / "wgmma.cuh").read_text()
            for old, new in (DEBUG_WAIT, DEBUG_DEF):
                assert old in text, old
                text = text.replace(old, new)
            (src / "wgmma.cuh").write_text(text)
            with open(src / "aliked_stem.cu", "a") as f:
                f.write(DEBUG_INIT)
        text = (src / "aliked_wgmma.cuh").read_text()
        if debug:
            for anchor, mark in MARKS:
                assert text.count(anchor) == 1, anchor
                text = text.replace(anchor, anchor + f"LG_MARK({mark});\n")
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not in aliked_wgmma.cuh")
            text = text.replace(old, new)
        (src / "aliked_wgmma.cuh").write_text(text)
        lib = out_dir / f"v{i}.so"
        jobs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
             str(src / "aliked_stem.cu")],
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
            elif ("Used" in line or "spill" in line or "setmaxnreg" in line) \
                    and "aliked_wg_kernel" in fn:
                c1 = re.search(r"ILi(\d+)E", fn).group(1)
                print(f"  {name}: aliked_wg_kernel<C1 {c1}>: "
                      f"{line.split(':', 1)[-1].strip()}", flush=True)
        libs[name] = lib
        sass_counts(name, lib)
    return libs


# SASS opcodes by the pipe that issues them (the rest: "other")
PIPES = {
    "MUFU": ("MUFU",),
    "FMA": ("FFMA", "FMUL", "FADD", "FMNMX", "FSEL", "FSETP", "FCHK"),
    "bf16x2 / convert": ("HFMA2", "HMUL2", "HADD2", "F2FP", "F2F", "I2F", "F2I"),
    "ALU": ("PRMT", "SHF", "LOP3", "IADD3", "IMAD", "ISETP", "SEL", "LEA", "MOV",
            "IABS", "IMNMX", "SHL", "SHR", "BMSK", "PLOP3", "R2P", "P2R", "VIADD"),
    "memory": ("LDS", "STS", "LDG", "STG", "LDC", "ULDC", "SHFL", "LDSM"),
    "tensor": ("HGMMA", "HMMA", "WARPGROUP", "UTMALDG", "UBLKCP", "SYNCS", "BAR"),
}


def sass_counts(name: str, lib_path: Path) -> None:
    """aliked_wg_kernel<16>'s SASS (cuobjdump -sass) counted by pipe and
    by opcode. Its loops are unrolled inside: the consumer's body runs
    once a row pair (256 pixels, 128 threads), the producer's once a conv1
    row (130 pixels); a variant without a part counts that part by
    difference."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        print("  cuobjdump not found: no instruction counts", flush=True)
        return
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    seq, cur = [], False
    for ln in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            cur = "aliked_wg_kernelILi16E" in m.group(1)
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", ln)
        if cur and m:
            seq.append(m.group(1).split(".")[0])
    pipes, ops = {}, {}
    for op in seq:
        pipe = next((k for k, v in PIPES.items() if op in v), "other")
        pipes[pipe] = pipes.get(pipe, 0) + 1
        ops[op] = ops.get(op, 0) + 1
    print(f"  {name}: SASS of aliked_wg_kernel<C1 16>, {len(seq)} instructions: "
          + ", ".join(f"{k} {v}" for k, v in sorted(pipes.items(), key=lambda kv: -kv[1]))
          + "; by opcode: " + ", ".join(f"{k} {v}" for k, v in sorted(
              ops.items(), key=lambda kv: -kv[1])[:16]), flush=True)


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


def debug_report(host) -> None:
    """The timed-out waits recorded in host memory: (block, thread,
    barrier address, parity), the first 24, and their kinds; the last
    mark of each warp of the first blocks, and the marks' counts."""
    if not host:
        return
    buf = (ctypes.c_int * DEBUG_N).from_address(host)
    recs = [(i // 16, buf[4 * i + 1], buf[4 * i + 2], buf[4 * i + 3])
            for i in range(SLOTS) if buf[4 * i] == 1]
    print(f"    {len(recs)} warps timed out; first: {recs[:24]}", flush=True)
    kinds = {}
    for _, th, a, par in recs:
        kinds[(th // 128, a, par)] = kinds.get((th // 128, a, par), 0) + 1
    print(f"    (warpgroup, barrier address, parity): warps {sorted(kinds.items())[:40]}",
          flush=True)
    marks = [buf[4 * SLOTS + i] for i in range(SLOTS)]
    for blk in range(4):
        print(f"    block {blk} last marks by warp: {marks[16 * blk:16 * blk + 12]}",
              flush=True)
    counts = {}
    for i, m in enumerate(marks):
        if i % 16 < 12:
            counts[m] = counts.get(m, 0) + 1
    print(f"    last mark: warps {sorted(counts.items())}", flush=True)


def rgb(gray):
    """Three channels of a gray image stack (B, H, W): g, sqrt g, g^2."""
    return np.stack([gray, np.sqrt(gray), gray * gray], 1).astype(np.float32)


def flips(got, ref):
    """(share over either bound, share not equal, largest |got - ref|)."""
    g, r = got.float(), ref.float()
    d = (g - r).abs()
    rms = r.square().mean(-1, keepdim=True).sqrt()
    over = (d > REL * r.abs().clamp(min=1.0)) | (d > SCALED * (r.abs() + rms))
    return (float(over.float().mean()), float((d > 0).float().mean()),
            float(d.max()))


def stem_params(name):
    p = aliked_params(name)
    return {"block1": p["block1"], "conv1": p["conv1"]}


def checks(host=None) -> bool:
    rng = np.random.default_rng(5)
    g = torch.Generator(device="cuda").manual_seed(6)
    imgs = [torch.from_numpy(rgb(np.stack([image_pair(rng, H, W)[0]
                                           for _ in range(2)]))).cuda().to(BF),
            torch.rand(1, 3, 34, 70, generator=g, device="cuda").to(BF),
            torch.rand(2, 3, 40, 200, generator=g, device="cuda").to(BF),
            torch.rand(1, 3, 40, 72, generator=g, device="cuda").to(BF)]
    ok = True
    for name in ("aliked-n16", "aliked-t16"):
        p = stem_params(name)
        for img in imgs:
            try:
                a, b = (aliked_stem.fused_aliked_stem_kernel(p, img)
                        for _ in range(2))
                torch.cuda.synchronize()
            except RuntimeError as e:
                print(f"    {name} {tuple(img.shape)}: {e}", flush=True)
                debug_report(host)
                return False
            ref = aliked_stem.fused_aliked_stem_plain(p, img)
            for part, x, y, z in zip(("y1", "x1p"), a, b, ref):
                over, differ, err = flips(x, z)
                same = torch.equal(x, y)
                good = over <= FLIPS and differ <= DIFFER and same
                ok &= good
                print(f"    {name} {tuple(img.shape)} {part}: over {over:.2e}, "
                      f"not equal {differ:.2e}, max_abs_err {err:.3e}, twice "
                      f"equal {same}{'' if good else '  FAILS'}", flush=True)
    return ok


def launches(host=None) -> bool:
    """An unchecked variant's launches at B 2, 768 x 1024, both widths:
    that they run (their outputs are not the function's)."""
    rng = np.random.default_rng(5)
    img = torch.from_numpy(rgb(np.stack([image_pair(rng, H, W)[0]
                                         for _ in range(2)]))).cuda().to(BF)
    for name in ("aliked-n16", "aliked-t16"):
        try:
            aliked_stem.fused_aliked_stem_kernel(stem_params(name), img)
            torch.cuda.synchronize()
        except RuntimeError as e:
            print(f"    {name} {tuple(img.shape)}: {e}", flush=True)
            debug_report(host)
            return False
        print(f"    {name} {tuple(img.shape)}: runs", flush=True)
    return True


def times() -> None:
    rng = np.random.default_rng(7)
    imgs = torch.from_numpy(rgb(np.stack([image_pair(rng, H, W)[0]
                                          for _ in range(8)]))).cuda().to(BF)
    p = stem_params("aliked-n16")
    for b in (1, 2, 8):
        img = imgs[:b].contiguous()
        t = graph_ms(lambda: aliked_stem.fused_aliked_stem_kernel(p, img))
        print(f"    B {b}: {t:.4f} ms (device, CUDA graphs)", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--run", help=argparse.SUPPRESS)
    ap.add_argument("--per-sm", type=int, default=3, help=argparse.SUPPRESS)
    ap.add_argument("--unchecked", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--debug", action="store_true",
                    help="record timed-out barrier waits before the trap")
    ap.add_argument("--only", nargs="*", default=None,
                    help="variants whose name holds one of these words")
    args = ap.parse_args()
    if args.run:  # one variant, in its own process
        host = use(args.run, args.debug)
        aliked_stem.PER_SM = args.per_sm
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
        libs = build_variants(Path(tmp), args.debug)
        for name, lib in libs.items():
            _, checked, per_sm = VARIANTS[name]
            print(f"  {name}:", flush=True)
            cmd = [sys.executable, "-m",
                   "lightglue_tpu_torch.scripts.aliked_wgmma_study", "--run",
                   str(lib), "--per-sm", str(per_sm)] + (
                       ["--time"] if args.time else []) + (
                       [] if checked else ["--unchecked"]) + (
                       ["--debug"] if args.debug else [])
            try:
                res = subprocess.run(cmd, timeout=600)
                print(f"  {name}: exit {res.returncode}", flush=True)
            except subprocess.TimeoutExpired:
                print(f"  {name}: timed out", flush=True)


if __name__ == "__main__":
    main()
