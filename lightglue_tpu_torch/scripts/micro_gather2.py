"""Row-gather study on a CUDA device: counterpart of scripts/micro_gather2.py.

    python -m lightglue_tpu_torch.scripts.micro_gather2 [--seed 0] [--reps 50]

At the JAX study's shapes, a (12288, 256) bf16 table and 110592 int32 row
indices drawn from ``--seed``, it times ms per call with CUDA events, each
variant twice in mirrored order (a, b, ..., b, a) and averaged:
  - ``tbl[idx]``, the library call;
  - ``index_select``;
  - kernel S1 (ops/gather.py), the launch alone and through ``gather_rows``
    with its host-side index check;
  - the one-hot product per 1024-row block, ``F.one_hot(idx) @ tbl``: the
    TPU study's MXU trick, kept in plain PyTorch;
and checks that every variant equals ``tbl[idx]`` bit for bit. It prints the
card's name and power limit first and needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import gather

N_ROWS = 12288  # table rows (scripts/micro_gather2.py:35)
N_IDX = 110592  # indices (scripts/micro_gather2.py:36)
WIDTH = 256  # table columns
BLK = 1024  # index rows per one-hot product (scripts/micro_gather2.py:62)


def make_inputs(seed: int, device: str = "cuda"):
    """The study's table (standard normal, rounded to bf16) and indices."""
    rng = np.random.default_rng(seed)
    tbl = torch.from_numpy(rng.standard_normal((N_ROWS, WIDTH)).astype(
        np.float32)).to(device, torch.bfloat16)
    idx = torch.from_numpy(rng.integers(0, N_ROWS, (N_IDX,)).astype(
        np.int32)).to(device)
    return tbl, idx


def one_hot_gather(tbl: torch.Tensor, idx: torch.Tensor,
                   blk: int = BLK) -> torch.Tensor:
    """The gather as one-hot products, one (blk, R) x (R, C) per block: each
    output row sums one table row, so the result is exact."""
    return torch.cat([F.one_hot(idx[i:i + blk].long(), tbl.shape[0]).to(
        tbl.dtype) @ tbl for i in range(0, idx.numel(), blk)])


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("micro_gather2 needs a CUDA device")
    print(card(), flush=True)
    tbl, idx = make_inputs(args.seed)
    idx_long = idx.long()
    want = tbl[idx_long]
    variants = {
        "tbl[idx] (library)": lambda: tbl[idx_long],
        "index_select": lambda: tbl.index_select(0, idx),
        "kernel S1 (launch)": lambda: gather.launch_gather(tbl, idx),
        "gather_rows (with the index check)": lambda: gather.gather_rows(
            tbl, idx),
        "one-hot product per 1024 rows": lambda: one_hot_gather(tbl, idx),
    }
    for name, fn in variants.items():
        if not torch.equal(fn(), want):
            raise AssertionError(f"{name} differs from tbl[idx]")
    order = list(variants)
    runs: Dict[str, list] = {name: [] for name in order}
    for name in order + order[::-1]:
        runs[name].append(time_ms(variants[name], args.reps))
    ms = {name: sum(t) / len(t) for name, t in runs.items()}
    print(f"table ({N_ROWS}, {WIDTH}) bf16, {N_IDX} int32 indices, seed "
          f"{args.seed}; ms per call (mean of two runs):")
    for name, t in ms.items():
        print(f"  {name:36s} {t:8.4f}  ({runs[name][0]:.4f} / "
              f"{runs[name][1]:.4f})", flush=True)
    return ms


if __name__ == "__main__":
    main()
