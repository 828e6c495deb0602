"""Variants of the tile product behind B5's and B6's launches, timed on
the card.

    python -m lightglue_tpu_torch.scripts.tile_study

Builds csrc/blocks.cu (with csrc/gemm_tc.cuh) several times from patched
copies, each with another form of lin2's LayerNorm + GELU, shape of the
largest tile (the one B 16 takes), ring depth (STAGES), k-step depth (BK),
warp tile, or sums (lin1 and lin2, B4's launches, with gemm_tc.cuh's step
sums), one nvcc per variant, all started together.
For each variant it checks every launch of the projection and the tail
against its plain version (ops/block_tc.py, layer 0 of the trained matcher,
B 4; the largest error relative to max(1, max |plain|) printed) and then
times each launch at B 1, 4 and 16 (1024 keypoints, D 256,
four heads) as device time from CUDA-graph replays, with the FLOP rate of
the fp32 function. The committed sources are the first variant. Prints
the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from .. import _build, nn
from .. import weights as weights_lib
from ..ops import block_tc, flash_self
from .attn_split import graph_ms

ROOT = Path(__file__).resolve().parents[2]
# name -> {file: [(committed text, variant text)]}
VARIANTS = {
    "committed": {},
    # lin2's LayerNorm + GELU one element a thread, gamma and beta loaded
    # per element
    "transform by element": {"blocks.cu": [(
        """    constexpr int CH = BK / 4;
    static_assert(T::THREADS % CH == 0, "a thread keeps its column");
    const int c = 4 * (threadIdx.x % CH);
    const float4 ga = *reinterpret_cast<const float4*>(gamma + k0 + c);
    const float4 be = *reinterpret_cast<const float4*>(beta + k0 + c);
    for (int r = threadIdx.x / CH; r < T::BM; r += T::THREADS / CH) {
      float4* p = reinterpret_cast<float4*>(As + r * LDS + c);
      const float mean = extra[r], rstd = extra[T::BM + r];
      float4 v = *p;
      v.x = gelu((v.x - mean) * rstd * ga.x + be.x);
      v.y = gelu((v.y - mean) * rstd * ga.y + be.y);
      v.z = gelu((v.z - mean) * rstd * ga.z + be.z);
      v.w = gelu((v.w - mean) * rstd * ga.w + be.w);
      *p = v;
    }""",
        """    for (int idx = threadIdx.x; idx < T::BM * BK; idx += T::THREADS) {
      const int r = idx / BK, c = idx % BK;
      float* p = As + r * LDS + c;
      *p = gelu((*p - extra[r]) * extra[T::BM + r] * gamma[k0 + c]
                + beta[k0 + c]);
    }""")]},
    # other shapes of the largest tile: lin2's LayerNorm + GELU is redone
    # for each of its D / BN column tiles
    "tile 0 128x64": {"gemm_tc.cuh": [(
        "using Tile0 = Tile<64, 128, 32, 32>;",
        "using Tile0 = Tile<128, 64, 32, 32>;")]},
    "tile 0 32x256": {"gemm_tc.cuh": [(
        "using Tile0 = Tile<64, 128, 32, 32>;",
        "using Tile0 = Tile<32, 256, 32, 32>;")]},
    "3 stages": {"gemm_tc.cuh": [("constexpr int STAGES = 2;",
                                  "constexpr int STAGES = 3;")]},
    "4 stages": {"gemm_tc.cuh": [("constexpr int STAGES = 2;",
                                  "constexpr int STAGES = 4;")]},
    "k-step 64": {"gemm_tc.cuh": [("constexpr int BK = 32;",
                                   "constexpr int BK = 64;")]},
    # lin1 and lin2 (B4, and the tail's last two launches) with each 8-deep
    # step's products summed apart and added in fp32, as B2 does
    "lin1, lin2 step sums": {"blocks.cu": [
        ("    lin1_tc_kernel(CatSrc<E> a, const E* __restrict__ w, StatsEpi e, int K,\n"
         "                   int R) {\n  lg::gemm::product<T>(",
         "    lin1_tc_kernel(CatSrc<E> a, const E* __restrict__ w, StatsEpi e, int K,\n"
         "                   int R) {\n  lg::gemm::product<T, true>("),
        ("    lin2_tc_kernel(LnSrc a, const E* __restrict__ w, ResidualEpi<E> e,\n"
         "                   int K, int R) {\n  lg::gemm::product<T>(",
         "    lin2_tc_kernel(LnSrc a, const E* __restrict__ w, ResidualEpi<E> e,\n"
         "                   int K, int R) {\n  lg::gemm::product<T, true>(")]},
    "3 stages, warp 64x32": {"gemm_tc.cuh": [
        ("constexpr int STAGES = 2;", "constexpr int STAGES = 3;"),
        ("using Tile0 = Tile<64, 128, 32, 32>;",
         "using Tile0 = Tile<64, 128, 64, 32>;")]},
}
LAUNCHES = ("project", "tail_out_proj", "tail_lin1", "tail_lin2")


def build_variants(out_dir: Path) -> dict:
    """{variant: library path}, one nvcc process per variant."""
    jobs = {}
    for i, (name, patches) in enumerate(VARIANTS.items()):
        src = out_dir / f"v{i}"
        shutil.copytree(_build.CSRC, src)
        for fname, subs in patches.items():
            text = (src / fname).read_text()
            for old, new in subs:
                if old not in text:
                    raise RuntimeError(f"{name}: {old!r} not in {fname}")
                text = text.replace(old, new)
            (src / fname).write_text(text)
        lib = out_dir / f"v{i}.so"
        jobs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
             str(src / "blocks.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log = proc.communicate(timeout=900)[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and not ln.strip().startswith(
                      "0 bytes stack frame, 0 bytes spill stores")]
        print(f"  {name}: built{'; spills: ' + str(spills) if spills else ''}")
        libs[name] = lib
    return libs


def use(lib_path: Path) -> None:
    """Route _build.launch's block entry points to this variant's library."""
    lib = ctypes.CDLL(str(lib_path))
    for entry in ("lg_project_heads", "lg_tail_out_proj", "lg_tail_lin1",
                  "lg_tail_lin2"):
        fn = getattr(lib, entry)
        fn.argtypes = _build.SIGNATURES[entry]
        fn.restype = ctypes.c_int
    _build._lib = lib


def launches(w, x, enc, ctx, msg, h, st):
    """The four launches of B5 (kernel, plain) on the given inputs."""
    return {
        "project": (lambda: block_tc.project(w, [x], 3, enc),
                    lambda: block_tc.project_plain(w, [x], 3, enc)),
        "tail_out_proj": (lambda: block_tc.tail_out_proj(w, [ctx]),
                          lambda: block_tc.tail_out_proj_plain(w, [ctx])),
        "tail_lin1": (lambda: block_tc.tail_lin1(w, [x], [msg]),
                      lambda: block_tc.tail_lin1_plain(w, [x], [msg])),
        "tail_lin2": (lambda: block_tc.tail_lin2(w, h, st, [x]),
                      lambda: block_tc.tail_lin2_plain(w, h, st, [x])),
    }


def measure(name, lib, w, inputs, table) -> None:
    """Check each launch of variant ``name`` against its plain version at B
    4, then time it at B 1, 4 and 16 into table[name, launch, B]."""
    use(lib)
    runs = launches(w, *inputs[4])
    errs = {}
    for launch, (kern, plain) in runs.items():
        got, want = kern(), plain()
        got = got if isinstance(got, (list, tuple)) else (got,)
        want = want if isinstance(want, (list, tuple)) else (want,)
        err = errs[launch] = max(float((a - c).abs().max() / c.abs().max(
        ).clamp(min=1.0)) for a, c in zip(got, want))
        if not err < 1e-5:
            raise AssertionError(f"{name} {launch}: {err}")
    for b in (1, 4, 16):
        runs = launches(w, *inputs[b])
        for launch in LAUNCHES:
            table[name, launch, b] = graph_ms(runs[launch][0])
    print(f"  {name}: checked against the plain versions, error relative to "
          "max(1, max |plain|): " + ", ".join(f"{k} {e:.2e}"
                                              for k, e in errs.items()),
          flush=True)


def flops(name: str, rows: int, d: int = 256) -> float:
    return 2 * rows * d * {"project": 3 * d, "tail_out_proj": d,
                           "tail_lin1": 4 * d, "tail_lin2": 2 * d}[name]


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"  {smi}")
    params = weights_lib.load_params(str(ROOT / "weights" /
                                         "synthetic_superpoint_lightglue.npz"))
    layer = nn.index_params(nn.params_to(params["transformers"], "cuda"), 0)
    w = flash_self.prepare(layer["self_attn"], 4)
    g = torch.Generator(device="cuda").manual_seed(0)
    inputs = {}
    for b in (1, 4, 16):
        x = torch.randn(b, 1024, 256, generator=g, device="cuda")
        ang = torch.rand(b, 1, 1024, 32, generator=g, device="cuda") * 6 - 3
        enc = torch.stack([ang.cos(), ang.sin()])
        ctx = torch.randn(b, 4, 1024, 64, generator=g, device="cuda")
        msg = block_tc.tail_out_proj_plain(w, [ctx])
        h, st = block_tc.tail_lin1_plain(w, [x], [msg])
        inputs[b] = (x, enc, ctx, msg, h, st)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(Path(tmp))
        table = {}
        try:
            for name, lib in libs.items():
                measure(name, lib, w, inputs, table)
        finally:
            _build._lib = None  # the full library again, built on next use
    for b in (1, 4, 16):
        print(f"  B {b}, device ms (TFLOP/s of the fp32 function):")
        for name in libs:
            ms = {launch: table[name, launch, b] for launch in LAUNCHES}
            cells = ", ".join(
                f"{launch} {t:.4f} ({flops(launch, b * 1024) / t / 1e9:.1f})"
                for launch, t in ms.items())
            print(f"    {name}: {cells}; sum {sum(ms.values()):.4f}")


if __name__ == "__main__":
    os.chdir(ROOT)
    main()
