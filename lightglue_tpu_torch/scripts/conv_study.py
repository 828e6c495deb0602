"""Variants of the implicit-GEMM 3x3 convolution behind B7 and B8, timed on
the card.

    python -m lightglue_tpu_torch.scripts.conv_study

Builds csrc/stem.cu and csrc/stem2.cu (with csrc/conv_tc.cuh) several times
from patched copies, each with another block tile (TH x TW output pixels,
one thread a pixel: 8 warps, or 4 and two blocks an SM), number of
input-channel groups NQ (a weight slot is one tap of 64 / NQ input
channels), ring depth (STAGES), the k-step before which the next slot's
copies are issued (LOAD_AT) or with per-step sums (each 8-deep step's
products summed in a zeroed register tile, then added in fp32) instead of
the tensor core's in-place sums, one nvcc per variant, all started
together. For each variant it checks B7 (the stem), B8's conv2a
launch (full resolution) and B8 (conv2a, then conv2b with the pool) against
their plain versions on two generated 768 x 1024 images (within 1e-4 of
max(1, max |plain|), and equal to the bit run to run), prints their largest
error against float64 (the same chain in float64 on the card, from the
same fp32 inputs) beside the fp32 plain version's, then times each launch
at B 1, 2 and 8 as device time from CUDA-graph replays, with the rate of the
fp32 function. The committed sources are the first variant. Prints the
card's name and power limit first.
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

from .. import SuperPointConfig, _build, nn
from ..models import superpoint as sp
from ..ops import stem, stem2
from ..synthetic import image_pair
from .attn_split import graph_ms

ROOT = Path(__file__).resolve().parents[2]
H, W = 768, 1024
TOL = 1e-4  # chip_smoke.py's CONV_TOL, relative to max(1, max |plain|)
COMMITTED = "using StemTile = Tile<8, 32, 1, 2>;\nusing MapTile = Tile<16, 16, 1, 2>;"
LOAD_AT = "static constexpr int LOAD_AT = CHUNKS / 2;"
IN_PLACE = "          tc::mma3(acc[mt][nt], ab[mt], as[mt], bb, bs);"
STEP_SUMS = """          {  // each step's products in a zeroed tile, then an fp32 add
            float d[4] = {0.f, 0.f, 0.f, 0.f};
            tc::mma3(d, ab[mt], as[mt], bb, bs);
            for (int j = 0; j < 4; ++j) acc[mt][nt][j] += d[j];
          }"""


def tile(th, tw, nq, stages):
    t = f"Tile<{th}, {tw}, {nq}, {stages}>"
    return [(COMMITTED, f"using StemTile = {t};\nusing MapTile = {t};")]


# name -> [(committed text of conv_tc.cuh, variant text)]
VARIANTS = {
    "committed: stem 8x32, map 16x16, NQ 1, 2 stages": [],
    "step sums": [(IN_PLACE, STEP_SUMS)],
    "next slot's copies first": [
        (LOAD_AT, "static constexpr int LOAD_AT = 0;")],
    "next slot's copies after k-step 1": [
        (LOAD_AT, "static constexpr int LOAD_AT = 1;")],
    "both 16x16, NQ 1, 2 stages": tile(16, 16, 1, 2),
    "both 8x32, NQ 1, 2 stages": tile(8, 32, 1, 2),
    "16x16, NQ 1, 3 stages": tile(16, 16, 1, 3),
    "16x16, NQ 2, 3 stages": tile(16, 16, 2, 3),
    "16x16, NQ 4, 4 stages": tile(16, 16, 4, 4),
    # 4 warps a block, two blocks an SM
    "8x16, NQ 2, 2 stages": tile(8, 16, 2, 2),
}
LAUNCHES = ("stem", "conv2a", "conv2b + pool")
# The ceiling of the kernels' inner loop: 8 warps a block, each issuing its
# 2 x 8 tiles' 3xTF32 mma.sync products (in place) from registers, nothing
# else; two blocks an SM.
PEAK_SRC = r"""
#include "tc.cuh"
__global__ void __launch_bounds__(256, 2) mma_peak_kernel(float* out,
                                                          int iters) {
  const float x = 1.f + 1e-3f * threadIdx.x;
  uint32_t ab[4], as[4], bb[2], bs[2];
  for (int i = 0; i < 4; ++i) lg::tc::split_tf32(x + i, ab[i], as[i]);
  for (int i = 0; i < 2; ++i) lg::tc::split_tf32(x - i, bb[i], bs[i]);
  float acc[2][8][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) lg::tc::mma3(acc[mt][nt], ab, as, bb, bs);
  float s = 0.f;
  for (int mt = 0; mt < 2; ++mt)
    for (int nt = 0; nt < 8; ++nt)
      for (int j = 0; j < 4; ++j) s += acc[mt][nt][j];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}
extern "C" cudaError_t lg_mma_peak(float* out, int blocks, int iters,
                                   cudaStream_t stream) {
  mma_peak_kernel<<<blocks, 256, 0, stream>>>(out, iters);
  return cudaGetLastError();
}
"""


def build_variants(out_dir: Path) -> dict:
    jobs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        src = out_dir / f"v{i}"
        shutil.copytree(_build.CSRC, src)
        text = (src / "conv_tc.cuh").read_text()
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not in conv_tc.cuh")
            text = text.replace(old, new)
        (src / "conv_tc.cuh").write_text(text)
        lib = out_dir / f"v{i}.so"
        jobs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
             str(src / "stem.cu"), str(src / "stem2.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    (out_dir / "peak").mkdir()
    shutil.copy(_build.CSRC / "tc.cuh", out_dir / "peak" / "tc.cuh")
    (out_dir / "peak" / "peak.cu").write_text(PEAK_SRC)
    jobs["mma.sync ceiling"] = (out_dir / "peak.so", subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
         str(out_dir / "peak.so"), str(out_dir / "peak" / "peak.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log = proc.communicate(timeout=900)[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        regs = sorted({ln.split("Used", 1)[1].split(",")[0].strip()
                       for ln in log.splitlines() if "Used" in ln})
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and not ln.strip().startswith(
                      "0 bytes stack frame, 0 bytes spill stores")]
        print(f"  {name}: built, {', '.join(regs)}"
              + (f"; spills: {spills}" if spills else "; no spill"),
              flush=True)
        libs[name] = lib
    return libs


def use(lib_path: Path) -> None:
    lib = ctypes.CDLL(str(lib_path))
    for entry in ("lg_fused_stem", "lg_conv3x3"):
        fn = getattr(lib, entry)
        fn.argtypes = _build.SIGNATURES[entry]
        fn.restype = ctypes.c_int
    _build._lib = lib


def chain64(params, img):
    """(stem, conv2a, block 2) in float64 from the fp32 inputs: block 2 on
    the fp32 plain stem's output, as the kernels take it."""
    def cbr(name, x):
        p = params[name]
        return torch.relu(F.conv2d(x.double(), p["w"].double(),
                                   p["b"].double(), padding=1))
    x1 = nn.max_pool(cbr("conv1b", cbr("conv1a", img)), 2)
    x = stem.fused_stem_plain(params, img)
    a = cbr("conv2a", x)
    return x1, a, nn.max_pool(cbr("conv2b", a), 2)


def runs(params, img, x):
    p2a = params["conv2a"]
    a = stem2.conv3x3_relu_plain(p2a, x)
    return {
        "stem": (lambda: stem.fused_stem(params, img),
                 lambda: stem.fused_stem_plain(params, img)),
        "conv2a": (lambda: stem2.conv3x3_relu(p2a, x),
                   lambda: stem2.conv3x3_relu_plain(p2a, x)),
        "conv2b + pool": (
            lambda: stem2._launch(params["conv2b"], a, True),
            lambda: nn.max_pool(stem2.conv3x3_relu_plain(params["conv2b"],
                                                         a), 2)),
        "block 2": (lambda: stem2.fused_block2(params, x),
                    lambda: stem2.fused_block2_plain(params, x)),
    }


def check(name, params, img, x, ref64) -> None:
    errs = []
    for (launch, (kern, plain)), r64 in zip(
            [(k, v) for k, v in runs(params, img, x).items()
             if k != "conv2b + pool"], ref64):
        got, again, want = kern(), kern(), plain()
        scale = max(1.0, float(want.abs().max()))
        err = float((got - want).abs().max()) / scale
        if not err <= TOL:
            raise AssertionError(f"{name} {launch}: {err} > {TOL}")
        if not torch.equal(got, again):
            raise AssertionError(f"{name} {launch}: runs differ")
        e64 = float((got.double() - r64).abs().max()) / scale
        p64 = float((want.double() - r64).abs().max()) / scale
        errs.append(f"{launch} {err:.2e} (float64: {e64:.2e}, plain "
                    f"{p64:.2e})")
    print(f"  {name}: against plain / max(1, max|plain|): {'; '.join(errs)}",
          flush=True)


def mma_ceiling(lib_path: Path) -> float:
    """TFLOP/s of fp32-equivalent work (a 3xTF32 product counted once) of
    mma_peak_kernel over 132 x 8 blocks."""
    fn = ctypes.CDLL(str(lib_path)).lg_mma_peak
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    blocks, iters = 132 * 8, 2048
    out = torch.empty(blocks * 256, device="cuda")

    def run():
        err = fn(out.data_ptr(), blocks, iters,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"lg_mma_peak: CUDA error {err}")
    ms = graph_ms(run, calls=5)
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("mma_peak_kernel: non-finite sums")
    return blocks * 8 * iters * 16 * 2 * 16 * 8 * 8 / ms / 1e9


def flops(launch: str, b: int) -> float:
    px = b * H * W
    return {"stem": px * 2 * 9 * (64 + 64 * 64),
            "conv2a": px / 4 * 2 * 9 * 64 * 64,
            "conv2b + pool": px / 4 * 2 * 9 * 64 * 64}[launch]


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"  {smi}")
    g = torch.Generator().manual_seed(0)
    params = {k: {"w": v["w"].cuda() * 3.0, "b": v["b"].cuda()}
              for k, v in sp.init_params(SuperPointConfig(), g).items()}
    rng = np.random.default_rng(5)
    imgs = torch.from_numpy(np.stack([image_pair(rng, H, W)[i]
                                      for i in range(2) for _ in range(4)])
                            ).cuda()[:, None]
    inputs = {b: (imgs[:b], stem.fused_stem_plain(params, imgs[:b]))
              for b in (1, 2, 8)}
    ref64 = chain64(params, inputs[2][0])
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(Path(tmp))
        table = {}
        peak = mma_ceiling(libs.pop("mma.sync ceiling"))
        print(f"  mma.sync ceiling (3xTF32 in place, from registers): "
              f"{peak:.1f} TFLOP/s of fp32 work", flush=True)
        try:
            for name, lib in libs.items():
                use(lib)
                check(name, params, *inputs[2], ref64)
                for b, (img, x) in inputs.items():
                    r = runs(params, img, x)
                    for launch in LAUNCHES:
                        table[name, launch, b] = graph_ms(r[launch][0],
                                                          calls=10)
        finally:
            _build._lib = None  # the full library again, built on next use
    for b in (1, 2, 8):
        print(f"  B {b}, device ms (TFLOP/s of the fp32 function):")
        for name in libs:
            cells = ", ".join(
                f"{launch} {table[name, launch, b]:.4f} "
                f"({flops(launch, b) / table[name, launch, b] / 1e9:.1f})"
                for launch in LAUNCHES)
            print(f"    {name}: {cells}", flush=True)


if __name__ == "__main__":
    os.chdir(ROOT)
    main()
