"""ctypes binding of the C++ host runtime (counterpart of
lightglue_tpu/native.py; the source is the port's own copy,
``csrc/host/lg_host.cpp``).

The library is built at first use, ``g++ -O3 -fPIC -shared``, into
``_build/`` under a name that hashes the source and the flags (as
``_build.py`` names the kernels' library), so an edited source builds anew.
A failed build raises with the compiler's output: nothing falls back to
numpy behind the caller's back. Each entry point has its numpy form beside
it (``*_numpy``), the plain version the tests hold the library against.
``pipeline.compact_matches`` (and so ``LightGlue``, ``match_sequence`` and
``BatchMatcher``) goes through the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "csrc" / "host" / "lg_host.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_P, _I64, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
# C entry point -> (argument types, result type)
SIGNATURES = {
    "compact_matches": ([_P, _P, _I64, _I64, _P, _P, _P], _I64),
    "pack_ragged": ([_P, _P, _I64, _I64, _I64, _F, _P, _P], None),
    "filter_matches_host": ([_P, _I64, _I64, _F, _P, _P], None),
}
_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"liblg_host_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source unless this hash is built already; raise with the
    compiler's output if it fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++, or $CXX) on PATH: the host "
                           f"runtime {SOURCE.name} is built at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed ({res.returncode}):"
                           f"\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded host library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def compact_matches(
    matches0: np.ndarray, mscores0: np.ndarray
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """(B, M) matches0 (-1: none) and scores -> per batch entry ((K, 2)
    int32 index pairs, (K,) float32 scores)."""
    matches0 = np.ascontiguousarray(matches0, np.int32)
    mscores0 = np.ascontiguousarray(mscores0, np.float32)
    b, m = matches0.shape
    pairs = np.empty((b * m, 2), np.int32)
    scores = np.empty((b * m,), np.float32)
    counts = np.empty((b,), np.int64)
    library().compact_matches(
        matches0.ctypes.data, mscores0.ctypes.data, b, m,
        pairs.ctypes.data, scores.ctypes.data, counts.ctypes.data)
    ends = np.cumsum(counts)
    return ([pairs[e - c:e].copy() for c, e in zip(counts, ends)],
            [scores[e - c:e].copy() for c, e in zip(counts, ends)])


def compact_matches_numpy(
    matches0: np.ndarray, mscores0: np.ndarray
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """``compact_matches`` in numpy."""
    matches0 = np.asarray(matches0, np.int32)
    mscores0 = np.asarray(mscores0, np.float32)
    out_m, out_s = [], []
    for row, scores in zip(matches0, mscores0):
        idx = np.nonzero(row > -1)[0]
        out_m.append(np.stack([idx, row[idx]], -1).astype(np.int32))
        out_s.append(scores[idx])
    return out_m, out_s


def pack_ragged(arrays: List[np.ndarray], k: int,
                pad_value: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """A list of (n_i, D) float32 arrays -> ((B, K, D) padded with
    ``pad_value``, each cut to its first K rows; (B, K) valid)."""
    b, d = len(arrays), arrays[0].shape[1]
    rows = np.ascontiguousarray(np.concatenate(arrays, 0), np.float32)
    offsets = np.zeros((b + 1,), np.int64)
    np.cumsum([len(a) for a in arrays], out=offsets[1:])
    out = np.empty((b, k, d), np.float32)
    valid = np.empty((b, k), np.uint8)
    library().pack_ragged(rows.ctypes.data, offsets.ctypes.data, b, k, d,
                          pad_value, out.ctypes.data, valid.ctypes.data)
    return out, valid.astype(bool)


def pack_ragged_numpy(arrays: List[np.ndarray], k: int,
                      pad_value: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """``pack_ragged`` in numpy."""
    b, d = len(arrays), arrays[0].shape[1]
    out = np.full((b, k, d), pad_value, np.float32)
    valid = np.zeros((b, k), bool)
    for i, a in enumerate(arrays):
        n = min(len(a), k)
        out[i, :n] = a[:n]
        valid[i, :n] = True
    return out, valid


def filter_matches_host(scores: np.ndarray,
                        threshold: float) -> Tuple[np.ndarray, np.ndarray]:
    """(M, N) inner log assignment -> mutual nearest neighbours (reference
    lightglue.py:302-318): matches0 (M,) int32 (-1 below the threshold or
    not mutual), mscores0 (M,) (exp of the row max where mutual, else 0).
    Ties go to the lowest index."""
    scores = np.ascontiguousarray(scores, np.float32)
    m, n = scores.shape
    if n == 0 and m:
        raise ValueError("filter_matches_host: no columns")
    matches0 = np.empty((m,), np.int32)
    mscores0 = np.empty((m,), np.float32)
    library().filter_matches_host(scores.ctypes.data, m, n, threshold,
                                  matches0.ctypes.data, mscores0.ctypes.data)
    return matches0, mscores0


def filter_matches_host_numpy(
        scores: np.ndarray, threshold: float) -> Tuple[np.ndarray, np.ndarray]:
    """``filter_matches_host`` in numpy."""
    scores = np.asarray(scores, np.float32)
    m = scores.shape[0]
    m0 = scores.argmax(1)
    m1 = scores.argmax(0)
    mutual = m1[m0] == np.arange(m)
    sc = np.exp(scores[np.arange(m), m0])
    ok = mutual & (sc > threshold)
    return (np.where(ok, m0, -1).astype(np.int32),
            np.where(mutual, sc, 0.0).astype(np.float32))
