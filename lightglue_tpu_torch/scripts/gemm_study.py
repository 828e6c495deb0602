"""The bf16 tile product (csrc/gemm_wgmma.cuh) in variants, on the card.

Builds csrc/blocks.cu from patched copies of the sources, one nvcc process
per variant, all started together: the product as committed, and without
the epilogue (timing only: every output is left unwritten, so nothing is
checked). For each it times B5's four launches (1024 keypoints, D 256: the
projection, out_proj, lin1, lin2) at B 1, 4 and 16 and B6's (both images,
1024 and 768 keypoints) at B 1 and 16, at every bf16 tile with its
persistent grid (``block_tc.bf16_plan``'s blocks an SM) and at the tile
that ``bf16_plan`` picks, as device ms from CUDA-graph replays, beside
``torch.addmm`` in bf16 on B5's shapes, with the card's name and power
limit; the committed form's outputs are checked against the plain versions
first::

    python -m lightglue_tpu_torch.scripts.gemm_study
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from lightglue_tpu_torch import _build, nn, weights
from lightglue_tpu_torch.ops import block_tc, flash_cross_block, flash_self
from lightglue_tpu_torch.scripts.extract_times import graph_ms

BF = torch.bfloat16
VARIANTS = {
    "as committed": [],
    "no epilogue (timing only)": [(
        "      epi.template store<T>(",
        "      if (R < 0) epi.template store<T>(")],
}
ENTRIES = ("lg_project_heads_bf16", "lg_tail_out_proj_bf16",
           "lg_tail_lin1_bf16", "lg_tail_lin2_bf16")
NPZ = Path(__file__).resolve().parents[2] / "weights" / \
    "synthetic_superpoint_lightglue.npz"


def build_variants(out_dir: Path) -> dict:
    jobs = {}
    for i, (name, patches) in enumerate(VARIANTS.items()):
        src = out_dir / f"v{i}"
        shutil.copytree(_build.CSRC, src)
        text = (src / "gemm_wgmma.cuh").read_text()
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not in gemm_wgmma.cuh")
            text = text.replace(old, new)
        (src / "gemm_wgmma.cuh").write_text(text)
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
        libs[name] = lib
        print(f"  {name}: built", flush=True)
    return libs


def use(lib_path: Path) -> None:
    lib = ctypes.CDLL(str(lib_path))
    for entry in ENTRIES:
        fn = getattr(lib, entry)
        fn.argtypes = _build.SIGNATURES[entry]
        fn.restype = ctypes.c_int
    _build._lib = lib


def launches(w, b, n0, n1, g):
    """{launch: (kernel call, plain call)} of a block's four launches over
    the rows of one segment (B5: n1 0) or two (B6)."""
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    xs = [r(b, n, 256).to(BF) for n in (n0, n1) if n]
    msgs = [r(b, n, 256).to(BF) for n in (n0, n1) if n]
    ctxs = [r(b, 4, n, 64).to(BF) for n in (n0, n1) if n]
    groups = 3 if n1 == 0 else 2
    enc = None
    if n1 == 0:
        ang = r(b, 1, n0, 32)
        enc = torch.stack([ang.cos(), ang.sin()])
    h, st = block_tc.tail_lin1_plain(w, xs, msgs)
    return {
        "projection": (lambda: block_tc.project(w, xs, groups, enc)[0],
                       lambda: block_tc.project_plain(w, xs, groups, enc)[0]),
        "out_proj": (lambda: block_tc.tail_out_proj(w, ctxs),
                     lambda: block_tc.tail_out_proj_plain(w, ctxs)),
        "lin1": (lambda: block_tc.tail_lin1(w, xs, msgs)[0],
                 lambda: block_tc.tail_lin1_plain(w, xs, msgs)[0]),
        "lin2": (lambda: block_tc.tail_lin2(w, h, st, xs)[0],
                 lambda: block_tc.tail_lin2_plain(w, h, st, xs)[0]),
    }


def forced(tile):
    """A stand-in for block_tc._tile that takes bf16 tile ``tile`` with its
    persistent grid."""
    def plan(dev, rows, cols, dtype, launch):
        bm, bn = block_tc.TILES_BF16[tile]
        count = -(-rows // bm) * (cols // bn)
        return tile, min(count, block_tc.BLOCKS_BF16[tile]
                         * block_tc.sms(dev.index))
    return plan


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"  {smi}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(9)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    layer = nn.index_params(nn.params_to(
        weights.load_params(str(NPZ))["transformers"], "cuda"), 0)
    w5 = flash_self.prepare(layer["self_attn"], 4, None, mp=True)
    w6 = flash_cross_block.prepare(layer["cross_attn"], 4, None, mp=True)
    cases = {f"B5 B {b}": launches(w5, b, 1024, 0, g) for b in (1, 4, 16)}
    cases.update({f"B6 B {b}": launches(w6, b, 1024, 768, g)
                  for b in (1, 16)})
    for b in (1, 4, 16):
        a = r(b * 1024, 256).to(BF)
        lib_rows = {
            "projection": (a, r(768, 256).to(BF)),
            "out_proj": (a, r(256, 256).to(BF)),
            "lin1": (r(b * 1024, 512).to(BF), r(512, 512).to(BF)),
            "lin2": (r(b * 1024, 512).to(BF), r(256, 512).to(BF))}
        print(f"  addmm bf16, B5 B {b}: " + "; ".join(
            f"{k} {graph_ms(lambda a=a_, w=w_: torch.addmm(w[:, 0], a, w.t())):.4f}"
            for k, (a_, w_) in lib_rows.items()), flush=True)
    orig = block_tc._tile
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(Path(tmp))
        for name, lib in libs.items():
            use(lib)
            for case, calls in cases.items():
                plans = [(f"tile {t}" + (", k split" if
                                          block_tc.SPLIT_BF16[i] > 1 else ""),
                          forced(i))
                         for i, t in enumerate(block_tc.TILES_BF16)]
                for label, plan in plans + [("bf16_plan", orig)]:
                    block_tc._tile = plan
                    row = []
                    for lname, (fn, plain) in calls.items():
                        if "timing only" not in name:
                            got, ref = fn().float(), plain().float()
                            err = float(((got - ref).abs()
                                         / ref.abs().clamp(min=1)).max())
                            if not err <= 2e-2:
                                raise AssertionError(
                                    f"{name} {case} {label} {lname}: {err}")
                        row.append(f"{lname} {graph_ms(fn):.4f}")
                    print(f"  {name}, {case}, {label}: " + "; ".join(row),
                          flush=True)
    block_tc._tile = orig


if __name__ == "__main__":
    main()
