"""Variants of the extractors' last first-design kernels, B9 (NMS) and B10
(ALIKED's stem), timed on the card.

    python -m lightglue_tpu_torch.scripts.extract_study

Builds csrc/nms.cu and csrc/aliked_stem.cu several times from patched
copies, one nvcc per variant, all started together:

- B9: both plans (three launches that keep bit masks in L2, committed, or
  one launch with a 5 r halo) at several tiles (rows x columns; the fused
  plan's columns those of a 128- or 160-column buffer), and the score tile
  staged by cp.async instead of plain loads. Every variant is
  checked equal to the plain version to the bit on SuperPoint's score maps
  at r 4 and ALIKED's at r 2, then timed at B 2 and B 16 (the B 2 maps
  repeated) beside the plain version.
- B10 (aliked-n16, ``extract_times.aliked_params``' random weights and
  batch-norm statistics): tiles (output rows x columns, m16 tiles a warp,
  conv1's column run), conv1's outputs split once or on every read, conv2's
  products summed in place or a step at a time, SELU's expm1f against the
  exp form, conv2's loop over the rows of taps unrolled or not, the image
  tile by plain loads instead of cp.async, registers for three blocks an
  SM. Every variant is checked against the plain version (1e-4 of
  max(1, max |plain|)), twice to the bit, and against the same chain in
  float64 on the card, then timed at B 1, 2 and 8.

Then timing probes, which are not variants: the committed B10 with one
part cut out (conv1, conv2, the 1x1 products, SELU, the y1 stores), whose
outputs are wrong and go unchecked; against the committed kernel's time
they say what each part costs inside the whole.

Times are device ms per launch from CUDA-graph replays. The committed
sources are the first variant of each kernel. Prints the card's name and
power limit first and needs a CUDA device.
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
from ..models import aliked as al
from ..models import superpoint as sp
from ..ops import aliked_stem, nms
from ..synthetic import image_pair
from .attn_split import graph_ms
from .extract_times import aliked_params
from .micro_gather2 import card

ROOT = Path(__file__).resolve().parents[2]
H, W = 768, 1024
TOL = 1e-4  # chip_smoke.py's CONV_TOL, relative to max(1, max |plain|)

NMS_FUSED = "template <int R> using FusedTile = Geo<R, 64, 128 - 10 * R, kFused>;"
NMS_PASS = "template <int R, int MODE> using PassTile = Geo<R, 32, 128, MODE>;"
FUSED_PLAN = ("constexpr bool kFusedPlan = false;",
              "constexpr bool kFusedPlan = true;")
STEM_TILE = "using TileN16 = StemTile<16, 32, 16, 32, 4, 3>;"
IMG_ASYNC = ("""    const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
    tc::cp_async4(I + i, ok ? im + ((size_t)c * H + gy) * W + gx : im, ok);""",
             """    I[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
               ? im[((size_t)c * H + gy) * W + gx] : 0.f;""")


# the score tile staged by cp.async (in-image) and stores of -inf, instead of
# plain loads: 2-5 % faster at B 16, 8-9 % slower at B 2 on an H100
S_ASYNC = ("""      *dst = (rin && c < G::BW && gx >= 0 && gx < W)
                 ? src[(size_t)gy * W + gx] : -INFINITY;""",
           """      if (rin && c < G::BW && gx >= 0 && gx < W)
        lg::tc::cp_async4(dst, src + (size_t)gy * W + gx, true);
      else
        *dst = -INFINITY;"""), (
    "  __syncthreads();\n  if constexpr (G::FIRST) {",
    "  lg::tc::cp_async_commit();\n  lg::tc::cp_async_wait<0>();\n"
    "  __syncthreads();\n  if constexpr (G::FIRST) {"), (
    "#include <utility>\n", "#include <utility>\n\n#include \"tc.cuh\"\n")


def nms_passes(th, tw):
    return [(NMS_PASS, "template <int R, int MODE> using PassTile = "
             f"Geo<R, {th}, {tw}, MODE>;")]


def nms_fused(th, cols):
    return [FUSED_PLAN, (NMS_FUSED, "template <int R> using FusedTile = "
                         f"Geo<R, {th}, {cols} - 10 * R, kFused>;")]


def stem_tile(th, tw, mt, vp):
    return [(STEM_TILE,
             f"using TileN16 = StemTile<16, 32, {th}, {tw}, {mt}, {vp}>;")]


# name -> [(committed text, variant text)]
NMS_VARIANTS = {
    "committed: passes, 32 x 128": [],
    "passes, score tile by cp.async": list(S_ASYNC),
    "passes, 16 x 128": nms_passes(16, 128),
    "passes, 64 x 64": nms_passes(64, 64),
    "passes, 32 x 256": nms_passes(32, 256),
    "fused, 64 x (128 - 10 r)": nms_fused(64, 128),
    "fused, 32 x (128 - 10 r)": nms_fused(32, 128),
    "fused, 48 x (128 - 10 r)": nms_fused(48, 128),
    "fused, 64 x (160 - 10 r)": nms_fused(64, 160),
}
STEM_VARIANTS = {
    "committed: 16 x 32, 4 m16 tiles a warp, split once, in place, exp form, "
    "a loop over the rows of taps": [],
    "SELU by expm1f": [("constexpr bool kExpForm = true;",
                        "constexpr bool kExpForm = false;")],
    "split on read": [("constexpr bool kSplitOnce = true;",
                       "constexpr bool kSplitOnce = false;")],
    "step sums": [("constexpr bool kStepSums = false;",
                   "constexpr bool kStepSums = true;")],
    "split on read, registers for 3 blocks an SM": [
        ("constexpr bool kSplitOnce = true;",
         "constexpr bool kSplitOnce = false;"),
        ("constexpr int kBlocksPerSM = 2;", "constexpr int kBlocksPerSM = 3;")],
    "image tile by plain loads": [IMG_ASYNC],
    "rows of taps unrolled": [("constexpr int kRowUnroll = 1;",
                               "constexpr int kRowUnroll = 3;")],
    "8 x 32, 4 m16 tiles a warp (4 warps)": stem_tile(8, 32, 4, 2),
    "16 x 16, 2 m16 tiles a warp": stem_tile(16, 16, 2, 3),
    "32 x 32, 4 m16 tiles a warp (16 warps, one block an SM)": stem_tile(
        32, 32, 4, 2) + [("constexpr int kBlocksPerSM = 2;",
                          "constexpr int kBlocksPerSM = 1;")],
    "16 x 16, 2 m16 tiles a warp, split on read": stem_tile(16, 16, 2, 3) + [
        ("constexpr bool kSplitOnce = true;",
         "constexpr bool kSplitOnce = false;")],
}

CONV1 = ("for (int i = tid; i < T::AR / T::VP * T::AC; i += T::THREADS) {",
         "for (int i = tid; i < 0; i += T::THREADS) {")
CONV2 = ("for (int dy = 0; dy < 3; ++dy) {", "for (int dy = 0; dy < 0; ++dy) {")
MMA_1X1 = ("tc::mma3(ya[n], ab, as, bb, bs);",
           "ya[n][0] += __uint_as_float(ab[0]);")
SELU = ("  if constexpr (kExpForm)\n", "  return x;\n  if constexpr (kExpForm)\n")
Y1_STORE = ("      if (gy < H && gx < W)\n        *reinterpret_cast<float4*>(y1",
            "      if (gy < 0)\n        *reinterpret_cast<float4*>(y1")
# Timing probes, not variants: the committed B10 with a part cut out. Their
# outputs are wrong and go unchecked; their times say what each part costs
# inside the whole (each cut's time against the committed kernel's).
STEM_PROBES = {
    "probe: no conv1": [CONV1],
    "probe: no conv2": [CONV2],
    "probe: no 1x1 products": [MMA_1X1],
    "probe: no SELU": [SELU],
    "probe: no y1 stores": [Y1_STORE],
    "probe: no conv1 and conv2": [CONV1, CONV2],
    "probe: loads, staging and stores only": [CONV1, CONV2, MMA_1X1, SELU],
}


def build_variants(out_dir: Path) -> dict:
    jobs = {}
    for kind, src_name, variants in (
            ("nms", "nms.cu", NMS_VARIANTS),
            ("stem", "aliked_stem.cu", {**STEM_VARIANTS, **STEM_PROBES})):
        for i, (name, subs) in enumerate(variants.items()):
            src = out_dir / f"{kind}{i}"
            shutil.copytree(_build.CSRC, src)
            text = (src / src_name).read_text()
            for old, new in subs:
                if old not in text:
                    raise RuntimeError(f"{name}: {old!r} not in {src_name}")
                text = text.replace(old, new)
            (src / src_name).write_text(text)
            lib = out_dir / f"{kind}{i}.so"
            jobs[kind, name] = (lib, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
                 str(src / src_name)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (kind, name), (lib, proc) in jobs.items():
        log = proc.communicate(timeout=900)[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        regs = sorted({ln.split("Used", 1)[1].split(",")[0].strip()
                       for ln in log.splitlines() if "Used" in ln})
        spills = sorted({ln.strip() for ln in log.splitlines()
                         if "spill" in ln and not ln.strip().startswith(
                             "0 bytes stack frame, 0 bytes spill stores")})
        print(f"  {kind} {name}: built, {', '.join(regs)}"
              + (f"; spills: {spills}" if spills else "; no spill"),
              flush=True)
        libs[kind, name] = lib
    return libs


def use(lib_path: Path, entry: str) -> None:
    lib = ctypes.CDLL(str(lib_path))
    fn = getattr(lib, entry)
    fn.argtypes = _build.SIGNATURES[entry]
    fn.restype = ctypes.c_int
    _build._lib = lib


def stem64(params, img):
    """B10's function in float64 from the fp32 inputs."""
    bp = params["block1"]

    def cbs(name, bn, x):
        s, b = (v.double() for v in nn.fold_batch_norm(bp[bn]))
        y = F.conv2d(x, bp[name]["w"].double(), padding=1)
        return F.selu(y * s[:, None, None] + b[:, None, None])

    x1 = cbs("conv2", "bn2", cbs("conv1", "bn1", img.double()))
    y1 = F.selu(F.conv2d(x1, params["conv1"]["w"].double()))
    return y1.permute(0, 2, 3, 1), F.avg_pool2d(x1, 2)


def stem_check(name, params, img, ref64):
    got = aliked_stem.fused_aliked_stem_kernel(params, img)
    again = aliked_stem.fused_aliked_stem_kernel(params, img)
    want = aliked_stem.fused_aliked_stem_plain(params, img)
    cells = []
    for part, a, b, r, r64 in zip(("y1", "x1p"), got, again, want, ref64):
        scale = max(1.0, float(r.abs().max()))
        err = float((a - r).abs().max()) / scale
        if not err <= TOL:
            raise AssertionError(f"{name} {part}: {err} > {TOL}")
        if not torch.equal(a, b):
            raise AssertionError(f"{name} {part}: runs differ")
        cells.append(f"{part} {err:.2e} (float64 {float((a.double() - r64).abs().max()) / scale:.2e}, "
                     f"plain {float((r.double() - r64).abs().max()) / scale:.2e})")
    print(f"  {name}: against plain / max(1, max|plain|): {'; '.join(cells)}",
          flush=True)


def score_maps():
    """SuperPoint's (conv weights x 3) and ALIKED's (extract_times'
    weights) score maps of two generated 768 x 1024 images."""
    rng = np.random.default_rng(5)
    gray = np.stack([image_pair(rng, H, W)[0] for _ in range(2)])
    g = torch.Generator().manual_seed(0)
    spp = {k: {"w": v["w"].cuda() * 3.0, "b": v["b"].cuda()}
           for k, v in sp.init_params(SuperPointConfig(), g).items()}
    rgb = np.stack([gray, np.sqrt(gray), gray * gray], 1).astype(np.float32)
    with torch.inference_mode():
        s4, _ = sp.dense_forward(spp, torch.from_numpy(gray).cuda()[..., None])
        _, s2 = al._dense_branches(aliked_params(), torch.from_numpy(rgb).cuda(),
                                   fused_stem=False)
    return {4: s4.contiguous(), 2: s2.contiguous()}


def main() -> None:
    print(f"  {card()}")
    maps = score_maps()
    ap = aliked_params()
    params = {"block1": ap["block1"], "conv1": ap["conv1"]}
    rng = np.random.default_rng(41)
    gray = np.stack([image_pair(rng, H, W)[0] for _ in range(8)])
    imgs = torch.from_numpy(np.stack([gray, np.sqrt(gray), gray * gray], 1)
                            .astype(np.float32)).cuda()
    ref64 = stem64(params, imgs[:2])
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(Path(tmp))
        nms_t, stem_t = {}, {}
        try:
            for (kind, name), lib in libs.items():
                if kind == "nms":
                    use(lib, "lg_simple_nms")
                    for r, s in maps.items():
                        for b in (2, 16):
                            x = s.repeat(b // 2, 1, 1)
                            got = nms.simple_nms_kernel(x, r)
                            want = nms.simple_nms_plain(x, r)
                            if not torch.equal(got.view(torch.int32),
                                               want.view(torch.int32)):
                                raise AssertionError(f"{name} r {r} B {b}: "
                                                     "differs")
                            nms_t[name, r, b] = graph_ms(
                                lambda: nms.simple_nms_kernel(x, r), calls=10)
                            if name.startswith("committed"):
                                nms_t["plain", r, b] = graph_ms(
                                    lambda: nms.simple_nms_plain(x, r), calls=5)
                    print(f"  nms {name}: equal to plain to the bit at r 4 and "
                          "r 2, B 2 and 16", flush=True)
                else:
                    use(lib, "lg_aliked_stem")
                    if name in STEM_PROBES:  # timing only
                        stem_t[name, 2] = graph_ms(
                            lambda: aliked_stem.fused_aliked_stem_kernel(
                                params, imgs[:2]), calls=10)
                        continue
                    stem_check(name, params, imgs[:2], ref64)
                    for b in (1, 2, 8):
                        stem_t[name, b] = graph_ms(
                            lambda: aliked_stem.fused_aliked_stem_kernel(
                                params, imgs[:b]), calls=10)
                        if name.startswith("committed"):
                            stem_t["plain", b] = graph_ms(
                                lambda: aliked_stem.fused_aliked_stem_plain(
                                    params, imgs[:b]), calls=5)
        finally:
            _build._lib = None  # the full library again, built on next use
    print("  B9, device ms (CUDA graph) at r 4 (SuperPoint) and r 2 (ALIKED):")
    for name in list(NMS_VARIANTS) + ["plain"]:
        print(f"    {name}: " + ", ".join(
            f"r {r} B {b} {nms_t[name, r, b]:.4f}"
            for r in (4, 2) for b in (2, 16)), flush=True)
    flops = 2 * H * W * (27 * 16 + 9 * 16 * 16 + 16 * 32)
    print("  B10 aliked-n16, device ms (CUDA graph; TFLOP/s of the fp32 "
          "function):")
    for name in list(STEM_VARIANTS) + ["plain"]:
        print(f"    {name}: " + ", ".join(
            f"B {b} {stem_t[name, b]:.4f} ({b * flops / stem_t[name, b] / 1e9:.1f})"
            for b in (1, 2, 8)), flush=True)
    print("  B10 timing probes (outputs not checked), device ms at B 2:")
    for name in STEM_PROBES:
        print(f"    {name}: {stem_t[name, 2]:.4f}", flush=True)


if __name__ == "__main__":
    os.chdir(ROOT)
    main()
