"""Build the CUDA kernels in ``csrc/`` and load them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` for sm_90a, one process per source, all
started together, and links the objects into one shared library with a
plain C interface, written to ``_build/`` under a name that carries a hash
of the sources and flags, so an edited source builds anew. Nothing here runs
at import: the first kernel launch (or ``build()``) compiles. Each C entry
point returns a ``cudaError_t``, and ``launch`` raises if it is not 0.

Each op wrapper counts its launches here (``count``), so a caller can show
that a run went through the kernels. A CUDA graph replays its kernels
without the wrappers: ``parallel/graphs.py`` records the counts a capture
made and adds them at each replay (``add_launches``). ``tally`` gives a
mesh slot its own share of the counts.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argument types (pointers and the stream as c_void_p).
SIGNATURES = {
    "lg_flash_sdpa": [_P] * 7 + [_I] * 7 + [_F] * 2 + [_P],
    "lg_flash_cross_pair": [_P] * 12 + [_I] * 7 + [_F] + [_P],
    "lg_attention_shape": [_I] + [ctypes.POINTER(_I)] * 3 + [_P],
    "lg_fused_cross": [_P] * 13 + [_I] * 7 + [_F] * 2 + [_P],
    "lg_project_heads": [_P] * 8 + [_I] * 8 + [_P],
    "lg_tail_out_proj": [_P] * 5 + [_I] * 6 + [_P],
    "lg_tail_lin1": [_P] * 8 + [_I] * 5 + [_P],
    "lg_tail_lin2": [_P] * 10 + [_I] * 5 + [_P],
    "lg_assign_tiles": [_P] * 8 + [_I] * 5 + [_P],
    "lg_assign_merge_lse": [_P] * 8 + [_I] * 5 + [_P],
    "lg_assign_merge_argmax": [_P] * 8 + [_I] * 5 + [_P],
    "lg_simple_nms": [_P] * 3 + [_I] * 4 + [_P],
    "lg_fused_stem": [_P] * 6 + [_I] * 3 + [_P],
    "lg_conv3x3": [_P] * 4 + [_I] * 4 + [_P],
    "lg_aliked_stem": [_P] * 6 + [_I] * 5 + [_P],
    "lg_score_head": [_P] * 3 + [_I] * 3 + [_P],
    "lg_score_head_lazy": [_P] * 6 + [_I] * 9 + [_P],
    "lg_score_head_blocks": [_I, ctypes.POINTER(_I), _P],
    "lg_gather_rows": [_P] * 3 + [_I] * 3 + [_P],
}
# The bf16 forms (mp) take the arguments of their fp32 entry points; the
# block launches' and the convolutions' take one more, the persistent grid
# last; B10's, B11's and B12's a tensor map of their input (encoded by its
# own entry point) and the prepared weights, then the shape and the grid.
SIGNATURES.update({
    f"{name}_bf16": SIGNATURES[name] for name in (
        "lg_flash_sdpa", "lg_flash_cross_pair", "lg_attention_shape",
        "lg_fused_cross")})
SIGNATURES.update({
    "lg_aliked_stem_bf16_map": [_P] * 2 + [_I] * 3 + [_P],
    "lg_aliked_stem_bf16": [_P] * 4 + [_I] * 6 + [_P],
    # B11's and B12's: s0's or s1's tensor map (its own entry point), then
    # the fp32 form's arguments with the prepared blob for the weights, the
    # persistent grid last
    "lg_score_head_bf16_map": [_P] * 2 + [_I] * 3 + [_P],
    "lg_score_head_bf16": [_P] * 3 + [_I] * 4 + [_P],
    "lg_score_head_lazy_bf16": [_P] * 6 + [_I] * 10 + [_P],
})
SIGNATURES.update({
    f"{name}_bf16": SIGNATURES[name][:-1] + [_I, _P] for name in (
        "lg_project_heads", "lg_tail_out_proj", "lg_tail_lin1",
        "lg_tail_lin2", "lg_fused_stem", "lg_conv3x3")})

# Op wrapper -> launches since the last reset.
KERNELS = (
    "flash_sdpa", "fused_cross_attention", "fused_ffn_residual",
    "fused_filter_matches", "fused_stem", "fused_block2", "simple_nms",
    "fused_self_block", "fused_cross_block", "flash_sdpa_shift",
    "fused_cross_attention_shift", "fused_aliked_stem", "score_head_lazy",
    "score_head_cplane", "flash_cross_pair", "gather_rows",
    # the bf16 forms of the matcher's kernels (mp)
    "flash_sdpa_bf16", "flash_sdpa_shift_bf16", "fused_cross_attention_bf16",
    "fused_cross_attention_shift_bf16", "fused_ffn_residual_bf16",
    "fused_self_block_bf16", "fused_cross_block_bf16",
    # B1''s bf16 form, and K1's and B5's at head_dim 128 (two heads)
    "flash_cross_pair_bf16", "flash_sdpa_bf16_d128",
    "flash_sdpa_shift_bf16_d128", "fused_self_block_bf16_d128",
    # the bf16 forms of the extractors' kernels (mp)
    "fused_stem_bf16", "fused_block2_bf16", "fused_aliked_stem_bf16",
    "score_head_lazy_bf16", "score_head_cplane_bf16",
)
_launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)
_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def count(op: str) -> None:
    _launches[op] += 1


def typed(name: str, dtype: torch.dtype, head_dim: int = 64) -> str:
    """The bf16 form's name of an entry point or a launch count (``name``
    with ``_bf16``) for a bf16 launch, else ``name``; a count of a bf16
    attention launch at ``head_dim`` 128 ends in ``_d128``."""
    if dtype != torch.bfloat16:
        return name
    return name + ("_bf16_d128" if head_dim == 128 else "_bf16")


def add_launches(counts: Dict[str, int]) -> None:
    """Add the launches of one CUDA graph replay (its capture's counts)."""
    for op, n in counts.items():
        _launches[op] += n


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


@contextlib.contextmanager
def tally(into: Optional[Dict[str, int]]):
    """Add the launches counted inside the block to ``into`` too (one slot's
    share of a mesh run); None: nothing."""
    if into is None:
        yield
        return
    before = dict(_launches)
    try:
        yield
    finally:
        for op, n in _launches.items():
            if n != before[op]:
                into[op] = into.get(op, 0) + n - before[op]


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(
            os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels of lightglue_tpu_torch are built from csrc/ at first use"
    )


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"liblg_kernels_{h.hexdigest()[:16]}.so"


def build() -> Tuple[Path, str]:
    """Compile the kernels unless this source hash is built already.
    Returns (library path, compiler output; empty when already built)."""
    out = library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        jobs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _, proc in jobs:
        log = proc.communicate(timeout=900)[0]
        logs.append(log)
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{log}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({res.returncode}):\n{res.stdout}\n"
                f"{res.stderr}")
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out, "".join(logs)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()[0]))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check_cuda(*, dtype: torch.dtype = torch.float32,
               **tensors: Optional[torch.Tensor]) -> torch.device:
    """Raise unless every given tensor is a contiguous CUDA tensor of
    ``dtype`` (float32 unless a launch takes bf16) on one device; return
    that device. The type is checked first: nothing converts it."""
    tensors = {k: t for k, t in tensors.items() if t is not None}
    for name, t in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    device = None
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
    return device


def launch(entry: str, device: torch.device, *args) -> None:
    """Call C entry point ``entry`` on ``device``'s current stream. Tensors
    pass as their data pointers, None as a null pointer."""
    conv = [
        ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
        else a for a in args
    ]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(library(), entry)(*conv, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err}")
