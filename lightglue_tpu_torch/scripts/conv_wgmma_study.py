"""The bf16 3x3 convolution (csrc/conv_wgmma.cuh: B7's and B8's bf16 forms)
in variants, on the card.

    python -m lightglue_tpu_torch.scripts.conv_wgmma_study [--time]

Builds csrc/stem.cu and csrc/stem2.cu from patched copies of the sources,
one nvcc process per variant, all started together, and prints each
variant's registers and spills (``-Xptxas -v``). Each variant then runs in
a process of its own (a variant that faults cannot take the others down):
B7 (``stem.fused_stem(..., mp=True)``), B8 (``stem2.fused_block2``) and
B8's conv2a launch (``stem2.conv3x3_relu``) against their plain versions on
generated images, 768 x 1024 at B 2 and ragged 24 x 136 and 40 x 72
shapes, with chip_smoke.py's flip check (|kernel - plain| <= 2e-2 max(1,
|plain|) and <= 2^-6 (|plain| + rms(plain row)) at all but 1e-4 of the
outputs, equal at all but 1e-2), each launch twice, equal to the bit. With
``--time`` each variant that passes is timed at B 1, 2 and 8 (768 x 1024)
as device ms from CUDA-graph replays, beside cuDNN's bf16 ``F.conv2d``
(channels_last) on conv1b's and conv2a's shapes: the same products without
the rounding before the bias, a yardstick the port never calls.

Variants (``VARIANTS``): as committed; the B descriptors of taps dx = 1, 2
with base offset dx (the probe of how wgmma reads a matrix that starts
inside the 1024-byte swizzle pattern: it swizzles by the address bits, and
with the offset every output is wrong); and, timed only, the stem without
conv1a (its producer stages zeros), every launch without its epilogue, and
the main loop with pixels as M (A from registers by ``ldmatrix``, wgmma
m64n64k16, the weights as B), the other orientation, its sums fed
unconverted to the epilogues: a lower bound on that design's time.
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
import torch.nn.functional as F

from lightglue_tpu_torch import SuperPointConfig, _build
from lightglue_tpu_torch.models import superpoint as sp
from lightglue_tpu_torch.ops import stem, stem2
from lightglue_tpu_torch.scripts.extract_times import graph_ms
from lightglue_tpu_torch.synthetic import image_pair

H, W = 768, 1024
BF = torch.bfloat16
REL, SCALED, FLIPS, DIFFER = 2e-2, 2.0 ** -6, 1e-4, 1e-2  # chip_smoke.py's


def _one_product() -> str:
    """wgmma m64n136k16 (68 accumulators), for the variant that takes a
    staged row's conv1a in one product."""
    n = 68
    regs = ", ".join(f"%{i}" for i in range(n))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(n))
    return (
        "__device__ __forceinline__ void mma_ss136(float (&d)[68], uint64_t da,"
        " uint64_t db, int acc) {\n"
        '  asm volatile("{\\n.reg .pred p;\\nsetp.ne.b32 p, %70, 0;\\n"\n'
        '      "wgmma.mma_async.sync.aligned.m64n136k16.f32.bf16.bf16 {'
        + regs + '}, %68, %69, p, 1, 1, 0, 0;\\n}\\n"\n'
        "      : " + outs + '\n      : "l"(da), "l"(db), "r"(acc));\n}\n\n')


ONE_PRODUCT = _one_product()
# the committed consumer main loop, and the pixels-as-M one that replaces it
MAIN_LOOP = """    wg::mma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const unsigned char* r0 = ring + ((k0 + dy) % R) * kRow + dx * 128;
      const unsigned char* r1 = ring + ((k0 + 1 + dy) % R) * kRow + dx * 128;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = wg::desc_sw128(Ws + tap * kTap + 32 * kk, 16, 1024);
        const int on = tap > 0 || kk > 0;
        wg::mma_ss128<0, 0>(acc0, da, wg::desc_sw128(r0 + 32 * kk, 16, 1024), on);
        wg::mma_ss128<0, 0>(acc1, da, wg::desc_sw128(r1 + 32 * kk, 16, 1024), on);
      }
    }
    wg::mma_commit();
    wg::mma_wait<0>();
"""
PIXELS_M = r"""    // pixels as M: four m64 tiles (row 2q + (mt >> 1), pixels 64 (mt & 1)
    // ..), all 64 channels as N, A from the staged rows by ldmatrix into
    // registers (two buffers, a step's four products in flight while the
    // next step's fragments load), the weights as B
    float acc[4][32];
    uint32_t af[2][4][4];
#pragma unroll
    for (int st = 0; st < 36; ++st) {
      const int tap = st / 4, kk = st % 4, dy = tap / 3, dx = tap % 3;
      if (st >= 2) {
        wg::mma_wait<1>();  // step st - 2, which read buffer st % 2, is done
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          asm volatile("" ::"r"(af[st % 2][mt][0]), "r"(af[st % 2][mt][1]),
                       "r"(af[st % 2][mt][2]), "r"(af[st % 2][mt][3]));
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const unsigned char* row = ring + ((k0 + (mt >> 1) + dy) % R) * kRow;
        const int px = 64 * (mt & 1) + 16 * warp + (lane & 15) + dx;
        const int ch = 2 * kk + (lane >> 4);
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
            : "=r"(af[st % 2][mt][0]), "=r"(af[st % 2][mt][1]),
              "=r"(af[st % 2][mt][2]), "=r"(af[st % 2][mt][3])
            : "r"(wg::smem_addr(row + px * 128 + ((ch ^ (px & 7)) << 4))));
      }
      wg::mma_fence();
      const uint64_t db = wg::desc_sw128(Ws + tap * kTap + 32 * kk, 16, 1024);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        wg::mma_rs64<0>(acc[mt], af[st % 2][mt], db, st > 0);
      wg::mma_commit();
    }
    wg::mma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) wg::reg_fence(acc[mt]);
    // timing only: the epilogues read the sums in the other layout
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      acc0[i] = acc[0][i], acc0[32 + i] = acc[1][i];
      acc1[i] = acc[2][i], acc1[32 + i] = acc[3][i];
    }
"""
# name -> (patches of conv_wgmma.cuh, checked against the plain versions)
VARIANTS = {
    "as committed": ([], True),
    # the B descriptors of taps dx = 1, 2 with base offset dx: how wgmma
    # reads a matrix that starts inside the 1024-byte swizzle pattern
    "base offset dx": ([(f"wg::desc_sw128({r} + 32 * kk, 16, 1024)",
                         f"(wg::desc_sw128({r} + 32 * kk, 16, 1024) | "
                         "((uint64_t)dx << 49))") for r in ("r0", "r1")], True),
    # conv1a's row as one m64n136k16 product (68 accumulators: producer 88,
    # consumers 208 registers) instead of two
    "conv1a in one product": ([
        ("template <int N>\n__device__ __forceinline__ void conv1a_part(",
         ONE_PRODUCT + "template <int N>\n__device__ __forceinline__ void conv1a_part("),
        ("            conv1a_part<64>(W1, Col, 0, b1, dst, x0, W, warp, g, t);\n"
         "            conv1a_part<72>(W1, Col, 64, b1, dst, x0, W, warp, g, t);\n",
         "            conv1a_part<136>(W1, Col, 0, b1, dst, x0, W, warp, g, t);\n"),
        ("  if constexpr (N == 64)\n", "  if constexpr (N == 136)\n"
         "    mma_ss136(c, desc_sw32(W1), desc_sw32(Col + 32 * p0), 0);\n"
         "  else if constexpr (N == 64)\n"),
        ("kProdRegs = kSrc == kImage ? 72 : 40", "kProdRegs = kSrc == kImage ? 88 : 40"),
        ("kConsRegs = kSrc == kImage ? 216 : 232", "kConsRegs = kSrc == kImage ? 208 : 232")],
        True),
    # timing only: the stem's producer stages zeros instead of conv1a
    "no conv1a (timing only)": ([("          if (r >= 0 && r < H) {",
                                  "          if (r >= 0 && r < H && H < 0) {")],
                                False),
    # timing only: the main loop with pixels as M (4 m64 tiles of a pair,
    # wgmma m64n64k16 with A from registers by ldmatrix, B the weights) in
    # place of channels as M: the other orientation's products alone, its
    # sums handed to the committed epilogues unconverted
    "pixels as M, main loop (timing only)": ([(MAIN_LOOP, PIXELS_M)], False),
    # timing only: the consumers write nothing
    "no epilogue (timing only)": ([("    if constexpr (kEpi == kFullNHWC) {\n",
                                    "    if (H < 0) {\n    } else if constexpr "
                                    "(kEpi == kFullNHWC) {\n")], False),
}
ENTRIES = ("lg_fused_stem_bf16", "lg_conv3x3_bf16", "lg_fused_stem",
           "lg_conv3x3")


def build_variants(out_dir: Path) -> dict:
    jobs = {}
    for i, (name, (patches, _)) in enumerate(VARIANTS.items()):
        src = out_dir / f"v{i}"
        shutil.copytree(_build.CSRC, src)
        text = (src / "conv_wgmma.cuh").read_text()
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not in conv_wgmma.cuh")
            text = text.replace(old, new)
        (src / "conv_wgmma.cuh").write_text(text)
        lib = out_dir / f"v{i}.so"
        jobs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
             str(src / "stem.cu"), str(src / "stem2.cu")],
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
                    and "conv_wg_kernel" in fn:
                tmpl = re.search(r"ILi(\d)ELi(\d)E", fn)
                print(f"  {name}: conv_wg_kernel<src {tmpl.group(1)}, epi "
                      f"{tmpl.group(2)}>: {line.split(':', 1)[-1].strip()}",
                      flush=True)
        libs[name] = lib
    return libs


def use(lib_path: str) -> None:
    lib = ctypes.CDLL(lib_path)
    for entry in ENTRIES:
        fn = getattr(lib, entry)
        fn.argtypes = _build.SIGNATURES[entry]
        fn.restype = ctypes.c_int
    _build._lib = lib


def params():
    return {k: {"w": v["w"].cuda() * 3.0, "b": v["b"].cuda()}
            for k, v in sp.init_params(SuperPointConfig(),
                                       torch.Generator().manual_seed(0)).items()}


def flips(got, ref):
    """(share over either bound, share not equal, largest |got - ref|)."""
    g, r = got.float(), ref.float()
    d = (g - r).abs()
    rms = r.square().mean(-1, keepdim=True).sqrt()
    over = (d > REL * r.abs().clamp(min=1.0)) | (d > SCALED * (r.abs() + rms))
    return (float(over.float().mean()), float((d > 0).float().mean()),
            float(d.max()))


def checks(spp) -> bool:
    p1 = {"conv1a": spp["conv1a"], "conv1b": spp["conv1b"]}
    p2 = {"conv2a": spp["conv2a"], "conv2b": spp["conv2b"]}
    rng = np.random.default_rng(5)
    g = torch.Generator(device="cuda").manual_seed(6)
    imgs = [torch.from_numpy(np.stack([image_pair(rng, H, W)[0] for _ in range(2)])
                             ).cuda()[:, None],
            torch.rand(1, 1, 24, 136, generator=g, device="cuda"),
            torch.rand(2, 1, 40, 72, generator=g, device="cuda")]
    ok = True
    for img in imgs:
        x2 = stem.fused_stem_plain(p1, img, mp=True)
        for label, kern, plain in (
                ("B7", lambda: stem.fused_stem(p1, img, mp=True), lambda: x2),
                ("B8", lambda: stem2.fused_block2(p2, x2),
                 lambda: stem2.fused_block2_plain(p2, x2)),
                ("B8's conv2a", lambda: stem2.conv3x3_relu(p2["conv2a"], x2),
                 lambda: stem2.conv3x3_relu_plain(p2["conv2a"], x2))):
            try:
                a, b = kern(), kern()
                torch.cuda.synchronize()
            except RuntimeError as e:
                print(f"    {label} {tuple(img.shape)}: {e}", flush=True)
                return False
            ref = plain()
            over, differ, err = flips(a, ref)
            same = torch.equal(a, b)
            good = over <= FLIPS and differ <= DIFFER and same
            ok &= good
            print(f"    {label} {tuple(img.shape)}: over {over:.2e}, not equal "
                  f"{differ:.2e}, max_abs_err {err:.3e}, twice equal {same}"
                  f"{'' if good else '  FAILS'}", flush=True)
    return ok


def times(spp) -> None:
    p1 = {"conv1a": spp["conv1a"], "conv1b": spp["conv1b"]}
    p2 = {"conv2a": spp["conv2a"], "conv2b": spp["conv2b"]}
    rng = np.random.default_rng(7)
    imgs = torch.from_numpy(np.stack([image_pair(rng, H, W)[0] for _ in range(8)])
                            ).cuda()[:, None]
    w1b = spp["conv1b"]["w"].to(BF).contiguous(memory_format=torch.channels_last)
    w2a = spp["conv2a"]["w"].to(BF).contiguous(memory_format=torch.channels_last)
    for b in (1, 2, 8):
        img = imgs[:b].contiguous()
        x2 = stem.fused_stem(p1, img, mp=True)
        a1 = torch.rand(b, 64, H, W, device="cuda").to(BF).contiguous(
            memory_format=torch.channels_last)
        t7 = graph_ms(lambda: stem.fused_stem(p1, img, mp=True))
        t8 = graph_ms(lambda: stem2.fused_block2(p2, x2))
        t2a = graph_ms(lambda: stem2.conv3x3_relu(p2["conv2a"], x2))
        c1b = graph_ms(lambda: F.conv2d(a1, w1b, padding=1))
        c2a = graph_ms(lambda: F.conv2d(x2, w2a, padding=1))
        print(f"    B {b}: B7 {t7:.4f} ms, B8 {t8:.4f} (conv2a {t2a:.4f}); "
              f"cuDNN bf16 conv1b {c1b:.4f}, conv2a {c2a:.4f} (device ms, "
              "CUDA graphs)", flush=True)
        del a1


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--run", help=argparse.SUPPRESS)
    ap.add_argument("--unchecked", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:  # one variant, in its own process
        use(args.run)
        spp = params()
        ok = args.unchecked or checks(spp)
        if ok and args.time:
            times(spp)
        sys.exit(0 if ok else 1)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"  {card}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(Path(tmp))
        for name, lib in libs.items():
            print(f"  {name}:", flush=True)
            cmd = [sys.executable, "-m", "lightglue_tpu_torch.scripts.conv_wgmma_study",
                   "--run", str(lib)] + (["--time"] if args.time else []) + (
                       [] if VARIANTS[name][1] else ["--unchecked"])
            try:
                res = subprocess.run(cmd, timeout=600)
                print(f"  {name}: exit {res.returncode}", flush=True)
            except subprocess.TimeoutExpired:
                print(f"  {name}: timed out", flush=True)


if __name__ == "__main__":
    main()
