"""Build the CUDA kernels in ``csrc/`` and load them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` for sm_90a into one shared library with
a plain C interface, written to ``_build/`` under a name that carries a hash
of the sources and flags, so an edited source builds anew. Nothing here runs
at import: the first kernel launch (or ``build()``) compiles. Each C entry
point returns a ``cudaError_t``, and ``launch`` raises if it is not 0.

Each op wrapper counts its launches here (``count``), so a caller can show
that a run went through the kernels.
"""

from __future__ import annotations

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
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point -> argument types (pointers and the stream as c_void_p).
SIGNATURES = {
    "lg_flash_sdpa": [_P] * 5 + [_I] * 4 + [_P],
    "lg_fused_cross": [_P] * 9 + [_I] * 4 + [_P],
    "lg_ffn_residual": [_P] * 9 + [_I] * 2 + [_P],
    "lg_assign_lse": [_P] * 5 + [_I] * 4 + [_P],
    "lg_assign_argmax": [_P] * 8 + [_I] * 4 + [_P],
}

# Op wrapper -> launches since the last reset.
KERNELS = (
    "flash_sdpa", "fused_cross_attention", "fused_ffn_residual",
    "fused_filter_matches",
)
_launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)
_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def count(op: str) -> None:
    _launches[op] += 1


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


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
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sorted(CSRC.glob("*.cu"))]]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    return out, res.stdout + res.stderr


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


def check_cuda(**tensors: Optional[torch.Tensor]) -> torch.device:
    """Raise unless every given tensor is a contiguous float32 CUDA tensor on
    one device; return that device."""
    device = None
    for name, t in tensors.items():
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
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
