"""The attention walk's P V sums on the card: each key tile's sums in a
register tile (``Config<D>::kTileSums`` in csrc/attn_tc.cuh, as committed
at head_dim 64 and 128) against other orders, checked on the matcher's own
inputs against float64 and timed.

    python -m lightglue_tpu_torch.scripts.walk_sums [--calls N]

Builds the kernel library from copies of csrc/ (``_build``'s build, one
nvcc per source, all started together): as committed; with the products
accumulated in place into O at 64 and at 128; and at 128 by O's 8-wide
column tiles in turn, each summing the key tile's steps in four zeroed
registers (the same sums as the register tile), with P's split fragments
held for the key tile or split again for each column tile. Prints each
build's walk kernels' registers and spills. With the committed build it
runs the trained synthetic matcher on a planted pair (fixed, ``N`` calls a
path) and keeps the inputs of every walk it launches: at four heads of 64
with shift 12 at 2048 keypoints (the composed cross block: K2's shift walk)
and exact at 1024 (B6: K2's exact walks), and at two heads of 128 (the
trained layers regrouped, as chip_smoke.py's two_head_params) exact and
with shift 12 at 2048 keypoints (K1 at d 128 inside B5, and B1'). For each
build it prints, over those launches (K2, K1 at d 64 and at 128, B1'),
the largest error on valid rows against the fp32 plain version and against
a float64 one (and the fp32 plain version's own against float64, and the
largest float64 output), then each of ``N`` calls' largest matching-score
gap to the CPU port's second call, whether the calls repeat to the bit,
and their matches0 agreement with it (beside the gap between the CPU
port's first call and its second: the first call in a process can differ,
scripts/cpu_repeat.py). Then the device time from CUDA-graph replays of
K2 (modes 0, 1, 2) at (B, 4, M 1024 / N 768, 64), K1 at (B, 4, 1024, 64)
and (B, 2, 1024, 128) and B1' at (B, 2, M 1024 / N 768, 128), B 1, 4 and
16, in the order of the builds and back. Prints the card's name and power
limit first. Run it in two processes to see whether a result repeats
across processes.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from .. import LightGlue, _build
from .. import weights as weights_lib
from ..ops import flash, flash_cross, flash_cross_block, flash_self
from ..synthetic import planted_pairs
from .attn_split import graph_ms

ROOT = Path(__file__).resolve().parents[2]
WEIGHTS = ROOT / "weights" / "synthetic_superpoint_lightglue.npz"
SUMS = "  static constexpr bool kTileSums = true;\n"
SUMS64 = "  static constexpr int kUnrollKs = 4;  // of the 8 steps of Q K^T\n" + SUMS
SUMS128 = ("  static constexpr int kUnrollKs = 16;  // all: 1-5 % faster than 4 "
           "here\n" + SUMS)
# The P V sums of the d-128 walk by O's 8-wide column tiles in turn, each
# summing the key tile's steps in four zeroed registers (the same sums in
# the same order as the register tile), P's split fragments held for the
# key tile or split again for each column tile (RESPLIT)
PV_BEGIN = "    constexpr bool kTileSums = Config<D>::kTileSums;\n"
PV_END = ("        for (int i = 0; i < 4; ++i) o[n][i] += pv[n][i];\n    }\n"
          "    __syncthreads();  // every read of this stage is done before its"
          " reload")
COLUMNS = """    if constexpr (D == 128) {
      constexpr bool kResplit = RESPLIT;
      uint32_t pb[kResplit ? 1 : NJ][4], ps[kResplit ? 1 : NJ][4];
      auto split_p = [&](int j, int q) {
        split_tf32(s[j][0], pb[q][0], ps[q][0]);
        split_tf32(s[j][2], pb[q][1], ps[q][1]);
        split_tf32(s[j][1], pb[q][2], ps[q][2]);
        split_tf32(s[j][3], pb[q][3], ps[q][3]);
      };
      if constexpr (!kResplit) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) split_p(j, j);
      }
#pragma unroll
      for (int n = 0; n < S::KS; ++n) {
        float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if constexpr (kResplit) split_p(j, 0);
          const float* vp = Vs + (8 * j + 2 * t) * S::LDV + g + 8 * n;
          uint32_t bb[2], bs[2];
          split_tf32(vp[0], bb[0], bs[0]);
          split_tf32(vp[S::LDV], bb[1], bs[1]);
          mma3(pv, pb[kResplit ? 0 : j], ps[kResplit ? 0 : j], bb, bs);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) o[n][i] += pv[i];
      }
    } else {
"""


def columns(resplit: bool) -> list:
    """attn_tc.cuh's edits of the column-tile forms at head_dim 128."""
    return [(PV_BEGIN, COLUMNS.replace("RESPLIT", str(resplit).lower())
             + PV_BEGIN),
            (PV_END, PV_END.replace("    __syncthreads()",
                                    "    }\n    __syncthreads()"))]


# build name -> attn_tc.cuh's edits, (text, replacement) each
VARIANTS = {
    "committed": [],
    "d 64 in place": [(SUMS64, SUMS64.replace("true", "false"))],
    "d 128 in place": [(SUMS128, SUMS128.replace("true", "false"))],
    "d 128 columns": columns(False),
    "d 128 columns, P split again": columns(True),
}
WALK_KERNELS = ("flash_sdpa_kernel", "flash_cross_pair_kernel",
                "cross_rows_kernel", "cross_cols_kernel", "cross_shift_kernel")
FIXED = dict(depth_confidence=-1.0, width_confidence=-1.0)
SHIFTED = dict(self_softmax_shift=12.0, cross_softmax_shift=12.0)
# (label, heads, matcher options, keypoints): the paths whose walks are kept
PATHS = (("4 x 64, shift 12, 2048 keypoints (B5, B3s)", 4, SHIFTED, 2048),
         ("4 x 64, exact, 1024 keypoints (B5, B6)", 4, {}, 1024),
         ("2 x 128, exact, 2048 keypoints (B5, B1')", 2, {}, 2048),
         ("2 x 128, shift 12, 2048 keypoints (B5, B1')", 2, SHIFTED, 2048))


def build_variant(tmp: Path, name: str, edits: list) -> ctypes.CDLL:
    """The kernel library built from a copy of csrc/ with ``edits`` made to
    attn_tc.cuh, each (text found once, replacement). Prints the walk
    kernels' registers and spills."""
    src = tmp / f"v{len(os.listdir(tmp))}"
    shutil.copytree(_build.CSRC, src / "csrc")
    cuh = src / "csrc" / "attn_tc.cuh"
    code = cuh.read_text()
    for old, new in edits:
        if code.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} not once in attn_tc.cuh")
        code = code.replace(old, new)
    cuh.write_text(code)
    saved = _build.CSRC, _build.BUILD_DIR, _build._lib
    _build.CSRC, _build.BUILD_DIR, _build._lib = src / "csrc", src / "build", None
    try:
        log = _build.build()[1]
        lib = _build.library()
    finally:
        _build.CSRC, _build.BUILD_DIR, _build._lib = saved
    kernel, seen = "?", []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "Used" in line and any(k in kernel for k in WALK_KERNELS):
            name_ = next(k for k in WALK_KERNELS if k in kernel)
            dim = re.search(r"Li(64|128)E", kernel)
            regs = re.search(r"Used (\d+) registers", line)[1]
            seen.append(f"{name_}{'' if dim is None else ' d ' + dim[1]} "
                        f"{regs}")
        elif "spill" in line and any(k in kernel for k in WALK_KERNELS) \
                and not line.strip().startswith("0 bytes stack frame, 0 bytes "
                                                "spill stores"):
            seen.append(f"SPILLS: {line.strip()}")
    print(f"  built {name}: " + ", ".join(seen), flush=True)
    return lib


def pair_data(n: int) -> dict:
    pr = planted_pairs(np.random.default_rng(7), 1, n)
    return {f"image{i}": {"keypoints": pr[f"keypoints{i}"],
                          "descriptors": pr[f"descriptors{i}"],
                          "image_size": pr["image_size"]} for i in (0, 1)}


def capture(matcher, data) -> dict:
    """The arguments of every K2 launch and of every walk of K1 and B1'
    (``launch_attention``) of one call, cloned."""
    kept = {"K2": [], "walk": []}
    cross, attn = flash_cross.launch_cross, flash.launch_attention
    clone = lambda a: a.clone() if isinstance(a, torch.Tensor) else a  # noqa

    def keep_cross(*args, **kwargs):
        kept["K2"].append(tuple(map(clone, args)) + tuple(kwargs.values()))
        return cross(*args, **kwargs)

    def keep_walk(dev, walks, scale, shift2, splits=None):
        kept["walk"].append(([tuple(map(clone, w)) for w in walks], scale,
                             shift2))
        return attn(dev, walks, scale, shift2, splits)

    flash_cross.launch_cross = flash_cross_block.launch_cross = keep_cross
    flash.launch_attention = flash_self.launch_attention = keep_walk
    try:
        matcher(data)
    finally:
        flash_cross.launch_cross = flash_cross_block.launch_cross = cross
        flash.launch_attention = flash_self.launch_attention = attn
    return kept


def rows_err(a, b, valid) -> float:
    d = (a.double() - b.double()).abs().amax((1, 3))
    d = d if valid is None else d[valid]
    return float(d.max()) if d.numel() else 0.0


def walk_plain(q, k, v, valid, scale, shift2):
    """The walk's function in plain PyTorch at q's precision:
    softmax(scale q k^T + key bias) v, exact (rows of an entry without a
    valid key 0) or with the constant shift ``shift2`` (log2 domain)."""
    s = (q * scale) @ k.transpose(-1, -2)
    if valid is not None:
        s = s + flash.key_bias(valid).to(s.dtype)[:, None, None, :]
    if shift2 is not None:
        e = flash.shift_weights(s, shift2)
        return (e @ v) / torch.clamp(e.sum(-1, keepdim=True), min=1e-30)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    o = (e @ v) / e.sum(-1, keepdim=True)
    if valid is not None:
        o = torch.where(valid.any(-1)[:, None, None, None], o,
                        torch.zeros_like(o))
    return o


def launch_errors(kept) -> dict:
    """{kind: (kernel vs fp32 plain, kernel vs float64, fp32 plain vs
    float64, largest |float64|)}, the largest over the launches and their
    directions, on valid query rows; kinds K2, K1 d 64, K1 d 128 (inside
    B5) and B1'."""
    out = {}

    def note(kind, got, plain, ref, valid):
        e = out.setdefault(kind, [0.0, 0.0, 0.0, 0.0])
        for i, (a, b) in enumerate(((got, plain), (got, ref), (plain, ref))):
            e[i] = max(e[i], rows_err(a, b, valid))
        e[3] = max(e[3], rows_err(ref, torch.zeros_like(ref), valid))

    for args in kept["K2"]:
        qk0, qk1, v0, v1, va0, va1, mode, scale = args[:8]
        shift2 = args[8] if len(args) > 8 else 0.0
        got = flash_cross.launch_cross(qk0, qk1, v0, v1, va0, va1, mode,
                                       scale, shift2)
        plain = flash_cross.cross_launches_plain(
            qk0, qk1, v0, v1, va0, va1, mode, scale, shift2)
        ref = flash_cross.cross_launches_plain(
            qk0.double(), qk1.double(), v0.double(), v1.double(), va0, va1,
            mode, scale, shift2)
        for i, valid in enumerate((va0, va1)):
            note("K2", got[i], plain[i], ref[i], valid)
    for walks, scale, shift2 in kept["walk"]:
        outs = [torch.empty_like(w[0]) for w in walks]
        flash.launch_attention(
            walks[0][0].device, [(*w[:4], o) for w, o in zip(walks, outs)],
            scale, shift2)
        kind = "B1'" if len(walks) == 2 else f"K1 d {walks[0][0].shape[-1]}"
        # the queries' mask: B1' walk 0 queries image 0, whose keys are
        # walk 1's; K1 inside B5 attends within one image
        qvalid = ([walks[1][3], walks[0][3]] if len(walks) == 2
                  else [walks[0][3]])
        for (q, k, v, valid, _), got, qv in zip(walks, outs, qvalid):
            note(kind, got, walk_plain(q, k, v, valid, scale, shift2),
                 walk_plain(q.double(), k.double(), v.double(), valid, scale,
                            shift2), qv)
    return out


def score_gap(got, ref) -> float:
    return max(float(np.abs(got[f] - ref[f]).max())
               for f in ("matching_scores0", "matching_scores1"))


def timing_cases() -> dict:
    """name -> launch: K2 (B, 4, M 1024 / N 768, 64) masked in modes 0, 1,
    2; K1 (B, 4, 1024, 64) and (B, 2, 1024, 128); B1' (B, 2, M 1024 / N
    768, 128) masked; B 1, 4 and 16."""
    g = torch.Generator(device="cuda").manual_seed(3)
    cases = {}
    for b in (1, 4, 16):
        r = lambda h, n, d=64: torch.randn(b, h, n, d, generator=g,  # noqa
                                           device="cuda")
        qk0, v0, qk1, v1 = r(4, 1024), r(4, 1024), r(4, 768), r(4, 768)
        va0 = torch.rand(b, 1024, generator=g, device="cuda") < 0.9
        va1 = torch.rand(b, 768, generator=g, device="cuda") < 0.9
        for mode, scale, shift2 in ((0, 0.125, 0.0), (1, 0.125, 0.0),
                                    (2, 0.125 * flash.LOG2E, 12 * flash.LOG2E)):
            cases[f"K2 mode {mode} B {b}"] = (
                lambda x=(qk0, qk1, v0, v1, va0, va1, mode, scale, shift2):
                flash_cross.launch_cross(*x))
        q, k, v = r(4, 1024), r(4, 1024), r(4, 1024)
        cases[f"K1 B {b}"] = lambda x=(q, k, v): flash.flash_sdpa(*x)
        q, k, v = r(2, 1024, 128), r(2, 1024, 128), r(2, 1024, 128)
        cases[f"K1 d 128 B {b}"] = lambda x=(q, k, v): flash.flash_sdpa(*x)
        p = (r(2, 1024, 128), r(2, 768, 128), r(2, 1024, 128),
             r(2, 768, 128), va0, va1)
        cases[f"B1' d 128 B {b}"] = lambda x=p: flash.flash_cross_pair(*x)
    return cases


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=3,
                    help="matcher calls a path and build")
    calls = ap.parse_args().calls
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"  {smi}", flush=True)
    params = weights_lib.load_params(str(WEIGHTS))
    w = params["posenc"]["Wr"]["w"]
    two_heads = dict(params, posenc={"Wr": {"w": torch.cat([w, w], 1)}})
    with tempfile.TemporaryDirectory() as tmp:
        libs = {name: build_variant(Path(tmp), name, edits)
                for name, edits in VARIANTS.items()}
        try:
            paths = []
            _build._lib = libs["committed"]
            for label, heads, conf, n in PATHS:
                data = pair_data(n)
                mp = params if heads == 4 else two_heads
                gpu = LightGlue("superpoint", params=mp, num_heads=heads,
                                **FIXED, **conf).compile((n // 2, n))
                cpu = LightGlue("superpoint", params=mp, num_heads=heads,
                                device="cpu", **FIXED, **conf)
                # the reference is the CPU port's second call: its first
                # call in a process has read up to 3.1e-5 off its later ones
                first = cpu(data)
                ref = cpu(data)
                print(f"    {label}: the CPU port's first call against its "
                      f"second: {score_gap(first, ref):.3e}", flush=True)
                paths.append((label, gpu, data, ref, capture(gpu, data)))
            for name, lib in libs.items():
                _build._lib = lib
                print(f"  {name}:", flush=True)
                for label, gpu, data, ref, kept in paths:
                    errs = launch_errors(kept)
                    outs = [gpu(data) for _ in range(calls)]
                    same = all(np.array_equal(o[f], outs[0][f])
                               for o in outs[1:] for f in outs[0]
                               if isinstance(outs[0][f], np.ndarray))
                    agree = float((outs[0]["matches0"]
                                   == ref["matches0"]).mean())
                    print(f"    {label}: " + "; ".join(
                        f"{k}: {e[0]:.3e} against fp32 plain, {e[1]:.3e} "
                        f"against float64 (fp32 plain {e[2]:.3e}; largest "
                        f"|float64| {e[3]:.3g})" for k, e in errs.items())
                        + f"; matching scores from the CPU port, {calls} "
                        "calls: " + "/".join(f"{score_gap(o, ref):.6e}"
                                             for o in outs)
                        + f" ({'equal' if same else 'NOT equal'} to the "
                        f"bit), matches0 agreement {agree:.6f}", flush=True)
            cases = timing_cases()
            names = list(libs)
            order = names + names[::-1]
            for case, fn in cases.items():
                ms = {name: [] for name in names}
                for name in order:
                    _build._lib = libs[name]
                    ms[name].append(graph_ms(fn))
                print(f"    {case}: device ms " + ", ".join(
                    f"{name} {np.mean(t):.4f} ({'/'.join(f'{x:.4f}' for x in t)})"
                    for name, t in ms.items()), flush=True)
        finally:
            _build._lib = None  # the committed library again, on next use


if __name__ == "__main__":
    os.chdir(ROOT)
    main()
