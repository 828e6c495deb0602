"""Row gather, out[i, :] = tbl[idx[i], :]: kernel S1 and its plain version.

Counterpart of the two Pallas kernels of scripts/micro_gather2.py (the
VMEM-resident row loop, :60-82, and the one-hot matrix product, :93-115),
which both compute this gather. On a CUDA tensor ``gather_rows`` launches
``csrc/gather.cu`` or raises; on a CPU tensor it runs ``gather_rows_plain``.
The kernel does not check its indices, as the TPU kernels do not: the
wrapper checks them on the host, one device read per call.
"""

from __future__ import annotations

import torch

from .. import _build


def gather_rows_plain(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tbl (R, C); idx (n,) integer row indices -> (n, C)."""
    return tbl[idx.long()]


def _word_bytes(*nbytes: int) -> int:
    """The widest of 16, 4 and 2 bytes that divides every number given."""
    for w in (16, 4, 2):
        if all(b % w == 0 for b in nbytes):
            return w
    raise ValueError("rows and addresses must be multiples of 2 bytes")


def gather_rows(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """S1 on CUDA tensors, the plain version on CPU tensors. tbl (R, C)
    contiguous with 2- or 4-byte elements; idx (n,) int32 in [0, R)."""
    if tbl.device.type == "cpu":
        return gather_rows_plain(tbl, idx)
    if not tbl.is_cuda or idx.device != tbl.device:
        raise ValueError(f"tbl and idx must be on one CUDA device, got "
                         f"{tbl.device} and {idx.device}")
    if tbl.dim() != 2 or not tbl.is_contiguous() or tbl.element_size() not in (2, 4):
        raise ValueError(f"tbl must be a contiguous 2-D tensor of 2- or 4-byte "
                         f"elements, got {tuple(tbl.shape)} {tbl.dtype}")
    if idx.dim() != 1 or idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError(f"idx must be a contiguous 1-D int32 tensor, got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    rows = tbl.shape[0]
    if idx.numel():
        lo, hi = (int(v) for v in torch.aminmax(idx))
        if lo < 0 or hi >= rows:
            raise IndexError(f"gather_rows: indices in [{lo}, {hi}] outside "
                             f"the table's {rows} rows")
    return launch_gather(tbl, idx)


def launch_gather(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The kernel's launch on arguments ``gather_rows`` has checked (the
    indices unchecked, as in the TPU kernels)."""
    n, cols = idx.numel(), tbl.shape[1]
    out = torch.empty(n, cols, dtype=tbl.dtype, device=tbl.device)
    if n == 0 or cols == 0:
        return out
    row_bytes = cols * tbl.element_size()
    word = _word_bytes(row_bytes, tbl.data_ptr(), out.data_ptr())
    _build.launch("lg_gather_rows", tbl.device, tbl, idx, out, n, row_bytes,
                  word)
    _build.count("gather_rows")
    return out
