"""Shared-memory carve of the attention walk at head_dim 128, measured.

    python -m lightglue_tpu_torch.scripts.attn_carve [--seed 0] [--reps 50]

csrc/common.cuh::AttnShape lets the 64 x 128 value tile overwrite the two
64-channel key chunks once a tile's scores are taken: 83.7 KB of shared
memory a block, two blocks an SM. The alternative keeps the values in a
buffer of their own, loaded with the keys as at head_dim 64: 117 KB, one
block an SM, one barrier less per key tile. This builds that alternative
from a copy of csrc/ with the one line changed (into _build/carve/), and
times K1 (exact) and B1' at head_dim 128 with both libraries at B 1, 4
and 16, in mirrored order (committed, alternative, alternative,
committed), with CUDA events, after checking both against the plain
versions. It prints the card's name and power limit first and needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
from typing import Optional, Sequence

import torch

from .. import _build
from ..ops import flash
from .micro_gather2 import card, time_ms

COMMITTED = "static constexpr bool kVOverK = NC > 1;"
OWN_BUFFER = "static constexpr bool kVOverK = false;"


def _library(csrc, build_dir) -> ctypes.CDLL:
    """Build (or find) the kernel library of the sources in ``csrc``."""
    saved = _build.CSRC, _build.BUILD_DIR
    _build.CSRC, _build.BUILD_DIR = csrc, build_dir
    try:
        lib = ctypes.CDLL(str(_build.build()[0]))
    finally:
        _build.CSRC, _build.BUILD_DIR = saved
    for name, argtypes in _build.SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _max_err(got, want) -> float:
    """Max-abs difference of a tensor or of a pair of tensors (every row:
    neither B1' form zeroes the rows of masked queries)."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


def own_buffer_library() -> ctypes.CDLL:
    """The alternative carve, built from a patched copy of csrc/."""
    root = _build.BUILD_DIR / "carve"
    src = root / "csrc"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build.CSRC, src)
    common = src / "common.cuh"
    text = common.read_text()
    if COMMITTED not in text:
        raise RuntimeError("csrc/common.cuh no longer has the carve line")
    common.write_text(text.replace(COMMITTED, OWN_BUFFER))
    return _library(src, root)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attn_carve needs a CUDA device")
    print(card(), flush=True)
    libs = {"values over keys (committed)": _build.library(),
            "values in their own buffer": own_buffer_library()}
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    out = {}
    try:
        for b in (1, 4, 16):
            q, k, v = (torch.randn(b, 2, 1024, 128, generator=g, device="cuda")
                       for _ in range(3))
            qk1, v1 = (torch.randn(b, 2, 768, 128, generator=g, device="cuda")
                       for _ in range(2))
            va0 = torch.rand(b, 1024, generator=g, device="cuda") < 0.9
            va1 = torch.rand(b, 768, generator=g, device="cuda") < 0.9
            calls = {
                "K1 d 128 (B, 2, 1024, 1024)": (
                    lambda: flash.flash_sdpa(q, k, v),
                    lambda: flash.flash_sdpa_plain(q, k, v)),
                "B1' d 128 (B, 2, M 1024 / N 768)": (
                    lambda: flash.flash_cross_pair(q, qk1, v, v1, va0, va1),
                    lambda: flash.flash_cross_pair_plain(q, qk1, v, v1, va0,
                                                         va1)),
            }
            for name, (kern, plain) in calls.items():
                want = plain()
                for lib in libs.values():
                    _build._lib = lib
                    if not _max_err(kern(), want) <= 1e-4:
                        raise AssertionError(f"{name}: a carve disagrees")
                runs = {label: [] for label in libs}
                for label in list(libs) + list(libs)[::-1]:
                    _build._lib = libs[label]
                    runs[label].append(time_ms(kern, args.reps))
                for label, t in runs.items():
                    ms = sum(t) / len(t)
                    out[name.replace("B,", f"{b},"), label] = ms
                    print(f"  {name.replace('B,', f'{b},'):36s} {label:30s} "
                          f"{ms:.4f} ms ({t[0]:.4f} / {t[1]:.4f})", flush=True)
    finally:
        _build._lib = libs["values over keys (committed)"]
    return out


if __name__ == "__main__":
    main()
