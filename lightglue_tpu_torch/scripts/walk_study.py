"""The bf16 attention walk (csrc/attn_wgmma.cuh) in variants, on the card.

Builds csrc/flash_sdpa.cu from patched copies of the sources, one nvcc
process per variant, all started together: the walk as committed; each
key tile walked in turn (S, softmax, P V) where the committed form runs
tile i's softmax beside tile i - 1's P V (at d 64 as committed); and
beside at d 128 too. For each it prints the walk kernels' registers and
spills, checks K1 at (2, 2, 200, 77) and (4, 4, 1024, 64) masked against
the plain version (2e-2 max(1, |plain|)), and times K1 masked at (4, 4,
4096, 64), (4, 2, 4096, 128), (4, 4, 1024, 64) and (16, 4, 1024, 64) and
B1' at (4, 2, M 1024 / N 768, 128) as device ms from CUDA-graph replays,
with the card's name and power limit::

    python -m lightglue_tpu_torch.scripts.walk_study
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from lightglue_tpu_torch import _build
from lightglue_tpu_torch.ops import flash
from lightglue_tpu_torch.scripts.extract_times import graph_ms

BF = torch.bfloat16
PIPE = "  static constexpr bool kPipelined = D == 64;"
VARIANTS = {
    "as committed": [],
    "in turn at d 64": [(PIPE, "  static constexpr bool kPipelined = false;")],
    "beside at d 128 too": [(PIPE,
                             "  static constexpr bool kPipelined = true;")],
}
ENTRIES = ("lg_flash_sdpa_bf16", "lg_flash_cross_pair_bf16",
           "lg_attention_shape_bf16")


def build_variants(out_dir: Path) -> dict:
    jobs = {}
    for i, (name, patches) in enumerate(VARIANTS.items()):
        src = out_dir / f"v{i}"
        shutil.copytree(_build.CSRC, src)
        text = (src / "attn_wgmma.cuh").read_text()
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not in attn_wgmma.cuh")
            text = text.replace(old, new)
        (src / "attn_wgmma.cuh").write_text(text)
        lib = out_dir / f"v{i}.so"
        jobs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
             str(src / "flash_sdpa.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log = proc.communicate(timeout=900)[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        lines = log.splitlines()
        spills = [lines[i + 1].strip() for i, ln in enumerate(lines[:-1])
                  if "Function properties" in ln and "_wg_" in ln
                  and "0 bytes spill stores" not in lines[i + 1]]
        print(f"  {name}: built; {'spills ' + str(spills) if spills else 'no spill'}",
              flush=True)
        libs[name] = lib
    return libs


def use(lib_path: Path) -> None:
    lib = ctypes.CDLL(str(lib_path))
    for entry in ENTRIES:
        fn = getattr(lib, entry)
        fn.argtypes = _build.SIGNATURES[entry]
        fn.restype = ctypes.c_int
    _build._lib = lib
    flash.walk_shape.cache_clear()
    flash.split_plan.cache_clear()


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"  {smi}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(3)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda").to(BF)  # noqa
    mask = lambda b, n: torch.rand(b, n, generator=g, device="cuda") < 0.9  # noqa
    checks = [(r(2, 2, 200, 64), r(2, 2, 77, 64), r(2, 2, 77, 64), mask(2, 77)),
              (r(4, 4, 1024, 64), r(4, 4, 1024, 64), r(4, 4, 1024, 64),
               mask(4, 1024)),
              (r(2, 2, 200, 128), r(2, 2, 333, 128), r(2, 2, 333, 128),
               mask(2, 333))]
    times = {s: (r(*s), r(*s), r(*s), mask(s[0], s[2])) for s in (
        (4, 4, 4096, 64), (4, 2, 4096, 128), (4, 4, 1024, 64),
        (16, 4, 1024, 64))}
    pair = (r(4, 2, 1024, 128), r(4, 2, 768, 128), r(4, 2, 1024, 128),
            r(4, 2, 768, 128))
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(Path(tmp))
        for name, lib in libs.items():
            use(lib)
            for q, k, v, valid in checks:
                got = flash.flash_sdpa(q, k, v, valid).float()
                ref = flash.flash_sdpa_plain(q, k, v, valid).float()
                err = float(((got - ref).abs() / ref.abs().clamp(min=1)).max())
                if not err <= 2e-2:
                    raise AssertionError(f"{name} {tuple(q.shape)}: {err}")
            row = [f"K1 {s}: {graph_ms(lambda: flash.flash_sdpa(*t)):.4f}"
                   for s, t in times.items()]
            row.append(f"B1' (4, 2, 1024 / 768, 128): "
                       f"{graph_ms(lambda: flash.flash_cross_pair(*pair)):.4f}")
            print(f"  {name}: " + "; ".join(row), flush=True)


if __name__ == "__main__":
    main()
