"""Variants of B11 and B12 (ALIKED's score-head tail, csrc/score_head.cu),
timed on the card.

    python -m lightglue_tpu_torch.scripts.score_study

Builds csrc/score_head.cu several times from patched copies, one nvcc per
variant, all started together, and prints each one's registers, spills and
blocks an SM (the runtime's occupancy calculator). The variants: three
blocks an SM instead of four (more registers a thread), for both kernels or
for B11 with its SELU loop unrolled by nine; the weights without
``__grid_constant__``; the staging loops' forms (the copies rolled, the
rows' bounds free to be hoisted out of the channel loop, the SELU loops
rolled, B11's unrolled by nine); other micro-tile rows in conv 4->4 and conv
4->1; a 32 x 32 tile. Every variant is checked against the plain versions
(1e-5, chip_smoke.py's SCORE_TOL) on ALIKED's branch parts of generated
768 x 1024 images (``extract_times.aliked_params``' random weights) and
launched twice, equal to the bit, then timed at B 1, 2 and 8.

Then timing probes, which are not variants: the committed kernels with one
part cut out or replaced (conv 8->4's products, the staging's global loads,
the staging's SELU, the barrier before conv 8->4, the weights' constant
operands, the 4-channel convs' products), whose outputs are wrong and go
unchecked; against the committed kernels' times they say what each part
costs inside the whole. Last, the committed library's instructions by kind
for each kernel (``cuobjdump -sass``, where the toolkit has it).

Times are device ms per launch from CUDA-graph replays. The committed
source is the first variant. Prints the card's name and power limit first
and needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from .. import _build
from ..models import aliked as al
from ..ops import score_head
from ..synthetic import image_pair
from .attn_split import graph_ms
from .extract_times import aliked_params
from .micro_gather2 import card

H, W = 768, 1024
SCORE_TOL = 1e-5
ENTRIES = ("lg_score_head", "lg_score_head_lazy", "lg_score_head_blocks")
TILE = "using Tile = ScoreTile<48, 32, 4, 2, 4>;"
VARIANTS = {
    "committed": (),
    "3 blocks an SM": (("constexpr int kBlocksSM = 4;",
                        "constexpr int kBlocksSM = 3;"),),
    "weights without __grid_constant__": (
        ("const Branches br, const __grid_constant__ Weights wt,",
         "const Branches br, const Weights wt,"),),
    "B11's SELU loop unrolled by 9": (("constexpr int kSeluUnrollLazy = 3;",
                                       "constexpr int kSeluUnrollLazy = 9;"),),
    "B11 at 3 blocks an SM, its SELU loop unrolled by 9": (
        ("__launch_bounds__(NT, kBlocksSM)",
         "__launch_bounds__(NT, LAZY ? 3 : kBlocksSM)"),
        ("constexpr int kSeluUnrollLazy = 3;", "constexpr int kSeluUnrollLazy = 9;")),
    "copy loop rolled": (("constexpr int kCopyUnroll = 9;",
                          "constexpr int kCopyUnroll = 1;"),),
    "staging bounds hoisted": (("  asm volatile(\"\" : \"+r\"(v));\n", ""),),
    "conv 4->1 micro-tiles of 6 rows": (
        (TILE, "using Tile = ScoreTile<48, 32, 4, 2, 6>;"),),
    "SELU loops rolled": (("constexpr int kSeluUnroll = 9;",
                           "constexpr int kSeluUnroll = 1;"),
                          ("constexpr int kSeluUnrollLazy = 3;",
                           "constexpr int kSeluUnrollLazy = 1;")),
    "conv 4->4 micro-tiles of 5 rows": (
        (TILE, "using Tile = ScoreTile<48, 32, 4, 5, 4>;"),),
    "tile 32 x 32": ((TILE, "using Tile = ScoreTile<32, 32, 4, 2, 4>;"),),
}
PROBES = {
    "probe: no conv 8->4 products": ((
        "      conv1_channel<T>(ci, P + band1 * T::R1 * T::PW + 2 * mc1, wt, acc);",
        "      acc[0][0][0] += P[band1 * T::R1 * T::PW + 2 * mc1];"),),
    "probe: no staging loads": (
        ("copy4(P + r * T::PW + pc, ok ? sp + (size_t)gy * W + gx : sp, ok);",
         "P[r * T::PW + pc] = (float)(gy - gx);"),
        ("copy4(dst + i * g.nc + j, src + (size_t)i * br.w[k] + j, true);",
         "dst[i * g.nc + j] = (float)(i - j);")),
    "probe: no staging SELU": (
        ("P[r * T::PW + pc] = ok ? selu(v) : 0.f;",
         "P[r * T::PW + pc] = ok ? v : 0.f;"),),
    "probe: no barrier before conv 1": ((
        "    __syncthreads();\n    if (ci < 7) prefetch(ci + 1);",
        "    if (ci < 7) prefetch(ci + 1);"),),
    "probe: conv weights all one constant": (
        ("wt.w[OFF + (dy * 3 + dx) * CO + co]", "1.0001f"),),
    "probe: no 4-channel conv products": tuple(
        (f"    conv_in<T::R{s}, {co}, T::W{s - 1}, O{s} + {ci} * {9 * co}>"
         f"(src + {ci} * T::H{s - 1} * T::W{s - 1}, wt, a{s});", "")
        for s, co in ((2, 4), (3, 1)) for ci in range(4)),
}


def build_variants(out_dir: Path) -> dict:
    jobs = {}
    for i, (name, subs) in enumerate({**VARIANTS, **PROBES}.items()):
        src = out_dir / f"v{i}"
        shutil.copytree(_build.CSRC, src)
        text = (src / "score_head.cu").read_text()
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not in score_head.cu")
            text = text.replace(old, new)
        (src / "score_head.cu").write_text(text)
        lib = out_dir / f"v{i}.so"
        jobs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
             str(src / "score_head.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log = proc.communicate(timeout=900)[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        regs = [ln.split("Used", 1)[1].split(",")[0].strip()
                for ln in log.splitlines() if "Used" in ln]
        spills = [ln.strip() for ln in log.splitlines() if "spill" in ln]
        print(f"  {name}: registers {', '.join(regs)}; "
              + "; ".join(spills), flush=True)
        libs[name] = lib
    return libs


def use(lib_path: Path) -> None:
    lib = ctypes.CDLL(str(lib_path))
    for entry in ENTRIES:
        fn = getattr(lib, entry)
        fn.argtypes = _build.SIGNATURES[entry]
        fn.restype = ctypes.c_int
    _build._lib = lib


def sass_histogram(lib_path: Path) -> None:
    """Instructions by kind of each score-head kernel in the library."""
    tool = "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        print("  cuobjdump not found: no instruction counts")
        return
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    hist, cur = {}, None
    for ln in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            cur = m.group(1) if "score_head_kernel" in m.group(1) else None
            if cur:
                hist[cur] = {}
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", ln)
        if cur and m:
            hist[cur][m.group(1)] = hist[cur].get(m.group(1), 0) + 1
    for name, h in hist.items():
        lazy = "ILb1E" in name
        top = sorted(h.items(), key=lambda kv: -kv[1])[:16]
        print(f"  {'B11' if lazy else 'B12'} ({sum(h.values())} instructions): "
              + ", ".join(f"{op} {n}" for op, n in top), flush=True)


def main() -> None:
    print(f"  {card()}")
    rng = np.random.default_rng(41)
    gray = np.stack([image_pair(rng, H, W)[0] for _ in range(8)])
    img = torch.from_numpy(np.stack([gray, np.sqrt(gray), gray * gray], 1)
                           .astype(np.float32)).cuda()
    ap = aliked_params()
    sh = ap["score_head"]
    with torch.inference_mode():
        ys, _ = al._dense_branches(ap, img, fused_stem=False)
        parts8 = al._score_parts(sh, ys, True)
    cases = {}
    for b in (1, 2, 8):
        parts = [p[:b].contiguous() for p in parts8]
        s0 = score_head.upsampled_sum(*parts)
        cases[b] = (parts, s0, score_head.score_head_lazy_plain(sh, *parts),
                    score_head.score_tail_plain(sh, s0))
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(Path(tmp))
        try:
            for name, lib in libs.items():
                use(lib)
                dev = torch.device("cuda")
                occ = (score_head.blocks_per_sm(True, dev),
                       score_head.blocks_per_sm(False, dev))
                for b, (parts, s0, ref_l, ref_c) in cases.items():
                    lazy = lambda: score_head.score_head_lazy_kernel(sh, *parts)  # noqa
                    cpl = lambda: score_head.score_head_cplane_kernel(sh, s0)  # noqa
                    if name in VARIANTS:
                        for fn, ref, what in ((lazy, ref_l, "B11"), (cpl, ref_c, "B12")):
                            got, again = fn(), fn()
                            err = float((got - ref).abs().max())
                            if not err <= SCORE_TOL:
                                raise AssertionError(f"{name} {what} B {b}: {err}")
                            if not torch.equal(got, again):
                                raise AssertionError(f"{name} {what} B {b}: runs differ")
                    times[name, b] = (graph_ms(lazy, calls=10), graph_ms(cpl, calls=10))
                print(f"  {name}: blocks an SM {occ[0]} (B11), {occ[1]} (B12); "
                      + ("checked, twice to the bit; " if name in VARIANTS else "")
                      + ", ".join(f"B {b} B11 {times[name, b][0]:.4f} B12 "
                                  f"{times[name, b][1]:.4f}" for b in cases),
                      flush=True)
            sass_histogram(libs["committed"])
        finally:
            _build._lib = None  # the full library again, built on next use


if __name__ == "__main__":
    main()
