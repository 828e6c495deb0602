"""The attention walk's P V sums on the card: a register tile per key tile
(``Config<64>::kTileSums`` in csrc/attn_tc.cuh, as committed) against the
products accumulated in place into O, each checked on the matcher's own
inputs and timed.

    python -m lightglue_tpu_torch.scripts.walk_sums

Builds the kernel library twice from copies of csrc/ (``_build``'s build,
one nvcc per source, all started together): as committed, and with
``kTileSums`` false at head_dim 64. With the committed build it runs the
trained synthetic matcher on a planted pair at 2048 keypoints with shift 12
(the composed cross block: K2's shift walk) and at 1024 keypoints exact (B6:
K2's exact walks) and keeps the inputs of every K2 launch. For each build it
prints, over those launches, K2's largest error on valid rows against the
fp32 plain version and against a float64 one (and the fp32 plain version's
own against float64), then both matchers' largest matching-score gap to the
CPU port and their matches0 agreement with it (beside the CPU port's gap to
a second call of itself), then the device time from CUDA-graph replays of
K2 (modes 0, 1, 2) and of K1 (``flash_sdpa``) at B 1, 4 and 16, in the
order committed, in place, in place, committed. Prints the card's name and
power limit first.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .. import LightGlue, _build
from .. import weights as weights_lib
from ..ops import flash, flash_cross, flash_cross_block
from ..synthetic import planted_pairs
from .attn_split import graph_ms

ROOT = Path(__file__).resolve().parents[2]
WEIGHTS = ROOT / "weights" / "synthetic_superpoint_lightglue.npz"
TILE_SUMS = "  static constexpr bool kTileSums = true;\n"
VARIANTS = {"tile sums (committed)": None,
            "in place": TILE_SUMS.replace("true", "false")}
FIXED = dict(depth_confidence=-1.0, width_confidence=-1.0)
# (label, matcher options, keypoints): the paths whose K2 launches are kept
PATHS = (("shift 12, 2048 keypoints (B3s)",
          dict(self_softmax_shift=12.0, cross_softmax_shift=12.0), 2048),
         ("exact, 1024 keypoints (B6)", {}, 1024))


def build_variant(tmp: Path, name: str, text: Optional[str]) -> ctypes.CDLL:
    """The kernel library built from a copy of csrc/ with Config<64>'s
    kTileSums line replaced by ``text`` (None: as committed)."""
    src = tmp / f"v{len(os.listdir(tmp))}"
    shutil.copytree(_build.CSRC, src / "csrc")
    if text is not None:
        cuh = src / "csrc" / "attn_tc.cuh"
        code = cuh.read_text()
        if code.count(TILE_SUMS) != 1:
            raise RuntimeError(f"{TILE_SUMS!r} not once in attn_tc.cuh")
        cuh.write_text(code.replace(TILE_SUMS, text))
    saved = _build.CSRC, _build.BUILD_DIR, _build._lib
    _build.CSRC, _build.BUILD_DIR, _build._lib = src / "csrc", src / "build", None
    try:
        lib = _build.library()
    finally:
        _build.CSRC, _build.BUILD_DIR, _build._lib = saved
    print(f"  built {name}", flush=True)
    return lib


def pair_data(n: int) -> dict:
    pr = planted_pairs(np.random.default_rng(7), 1, n)
    return {f"image{i}": {"keypoints": pr[f"keypoints{i}"],
                          "descriptors": pr[f"descriptors{i}"],
                          "image_size": pr["image_size"]} for i in (0, 1)}


def capture(matcher, data) -> list:
    """The arguments of every K2 launch of one call, cloned."""
    kept, cross = [], flash_cross.launch_cross

    def keep(*args, **kwargs):
        kept.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a
                          for a in args) + tuple(kwargs.values()))
        return cross(*args, **kwargs)

    flash_cross.launch_cross = flash_cross_block.launch_cross = keep
    try:
        matcher(data)
    finally:
        flash_cross.launch_cross = flash_cross_block.launch_cross = cross
    return kept


def rows_err(a, b, valid) -> float:
    d = (a.double() - b.double()).abs().amax((1, 3))
    d = d if valid is None else d[valid]
    return float(d.max()) if d.numel() else 0.0


def launch_errors(launches) -> tuple:
    """(kernel vs fp32 plain, kernel vs float64, fp32 plain vs float64),
    the largest over the launches and both directions, valid rows."""
    out = [0.0, 0.0, 0.0]
    for args in launches:
        qk0, qk1, v0, v1, va0, va1, mode, scale = args[:8]
        shift2 = args[8] if len(args) > 8 else 0.0
        got = flash_cross.launch_cross(qk0, qk1, v0, v1, va0, va1, mode, scale,
                                       shift2)
        plain = flash_cross.cross_launches_plain(qk0, qk1, v0, v1, va0, va1,
                                                 mode, scale, shift2)
        ref = flash_cross.cross_launches_plain(
            qk0.double(), qk1.double(), v0.double(), v1.double(), va0, va1,
            mode, scale, shift2)
        for i, (a, b) in enumerate(((got, plain), (got, ref), (plain, ref))):
            out[i] = max(out[i], rows_err(a[0], b[0], va0),
                         rows_err(a[1], b[1], va1))
    return tuple(out)


def score_gap(got, ref) -> float:
    return max(float(np.abs(got[f] - ref[f]).max())
               for f in ("matching_scores0", "matching_scores1"))


def timing_cases() -> dict:
    """name -> launch at phase 4's shapes: K2 (B, 4, M 1024 / N 768, 64)
    masked in modes 0, 1, 2, and K1 (B, 4, 1024, 64)."""
    g = torch.Generator(device="cuda").manual_seed(3)
    cases = {}
    for b in (1, 4, 16):
        r = lambda n: torch.randn(b, 4, n, 64, generator=g, device="cuda")  # noqa
        qk0, v0, qk1, v1 = r(1024), r(1024), r(768), r(768)
        va0 = torch.rand(b, 1024, generator=g, device="cuda") < 0.9
        va1 = torch.rand(b, 768, generator=g, device="cuda") < 0.9
        for mode, scale, shift2 in ((0, 0.125, 0.0), (1, 0.125, 0.0),
                                    (2, 0.125 * flash.LOG2E, 12 * flash.LOG2E)):
            cases[f"K2 mode {mode} B {b}"] = (
                lambda x=(qk0, qk1, v0, v1, va0, va1, mode, scale, shift2):
                flash_cross.launch_cross(*x))
        q, k, v = r(1024), r(1024), r(1024)
        cases[f"K1 B {b}"] = lambda x=(q, k, v): flash.flash_sdpa(*x)
    return cases


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"  {smi}", flush=True)
    params = weights_lib.load_params(str(WEIGHTS))
    with tempfile.TemporaryDirectory() as tmp:
        libs = {name: build_variant(Path(tmp), name, text)
                for name, text in VARIANTS.items()}
        try:
            paths = []
            _build._lib = libs["tile sums (committed)"]
            for label, conf, n in PATHS:
                data = pair_data(n)
                gpu = LightGlue("superpoint", params=params, **FIXED,
                                **conf).compile((n // 2, n))
                cpu = LightGlue("superpoint", params=params, device="cpu",
                                **FIXED, **conf)
                ref = cpu(data)
                print(f"    {label}: the CPU port against itself, a second "
                      f"call: {score_gap(cpu(data), ref):.3e}", flush=True)
                paths.append((label, gpu, data, ref, capture(gpu, data)))
            for name, lib in libs.items():
                _build._lib = lib
                print(f"  {name}:", flush=True)
                for label, gpu, data, ref, launches in paths:
                    e = launch_errors(launches)
                    got = gpu(data)
                    agree = float((got["matches0"] == ref["matches0"]).mean())
                    print(f"    {label}: K2 over {len(launches)} launches: "
                          f"{e[0]:.3e} against fp32 plain, {e[1]:.3e} against "
                          f"float64 (fp32 plain {e[2]:.3e}); matching scores "
                          f"{score_gap(got, ref):.3e} from the CPU port, "
                          f"matches0 agreement {agree:.6f}", flush=True)
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
