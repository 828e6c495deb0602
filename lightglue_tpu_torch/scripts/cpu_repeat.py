"""Whether the CPU port repeats itself: the matcher's plain versions on the
CPU called several times in one process on one input, compared to the bit.

    python -m lightglue_tpu_torch.scripts.cpu_repeat [--calls N]
        [--keypoints N] [--shift S] [--matmuls]

The trained synthetic matcher (fixed, default blocks, on the CPU) on
walk_sums' planted pair, 2048 keypoints with shift 12 by default: the path
whose gap between the card and the CPU port moved from run to run. Every op
call the matcher makes (the keypoints' normalisation and rotary encoding,
``nn.linear``, the self block, the cross block or the cross attention and
the FFN residual, the assignment's reductions; with ``--matmuls`` every
``@`` of a tensor too) is kept with its inputs and output, and each later
matcher call is compared with the first op call by op call. It prints the
first op call whose output differs: whether its inputs repeated to the
bit and, if they did, the distinct outputs of 20 more runs on the kept
inputs; then each matcher call's largest matching-score gap to the first.
Prints torch's version and parallel settings first. Needs no GPU.
"""

from __future__ import annotations

import argparse
import hashlib
import os
from pathlib import Path

import numpy as np
import torch

from .. import LightGlue, nn
from .. import weights as weights_lib
from ..models import lightglue as lg
from ..ops import (assignment_fused, ffn, flash_cross, flash_cross_block,
                   flash_self, rotary)
from .walk_sums import FIXED, pair_data, score_gap

ROOT = Path(__file__).resolve().parents[2]
# (module, function) of the ops whose calls are kept
OPS = ((lg, "normalize_keypoints"), (rotary, "fourier_posenc"),
       (nn, "linear"), (flash_self, "fused_self_block"),
       (flash_cross_block, "fused_cross_block"),
       (flash_cross, "fused_cross_attention"),
       (ffn, "fused_ffn_residual_pair"),
       (assignment_fused, "fused_filter_matches"))


def tensors(x) -> list:
    """The tensors in x (nested tuples and lists; dicts of weights
    skipped)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in tensors(v)]
    return []


def cloned(x):
    """x with its tensors (in nested tuples and lists) cloned."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (tuple, list)):
        return type(x)(cloned(v) for v in x)
    return x


def digest(ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def kept_call(matcher, data, keep: bool, matmuls: bool) -> tuple:
    """(matcher output, [(op, its function, its arguments cloned when
    ``keep`` else None, input digest, output digest)]) of one call."""
    ops = OPS + (((torch.Tensor, "__matmul__"),) if matmuls else ())
    log, saved = [], [(m, f, getattr(m, f)) for m, f in ops]

    def wrap(name, fn):
        def run(*args, **kwargs):
            kept = cloned((args, kwargs)) if keep else None
            din = digest(tensors(args))
            out = fn(*args, **kwargs)
            log.append((name, fn, kept, din, digest(tensors(out))))
            return out
        return run

    for m, f, fn in saved:
        setattr(m, f, wrap(f, fn))
    try:
        out = matcher(data)
    finally:
        for m, f, fn in saved:
            setattr(m, f, fn)
    return out, log


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=4)
    ap.add_argument("--keypoints", type=int, default=2048)
    ap.add_argument("--shift", type=float, default=12.0,
                    help="self_ and cross_softmax_shift; 0 for the exact form")
    ap.add_argument("--matmuls", action="store_true",
                    help="keep every tensor @ too")
    a = ap.parse_args()
    print(f"  torch {torch.__version__}, {torch.get_num_threads()} threads, "
          f"{os.cpu_count()} CPUs; "
          + " ".join(ln.strip() for ln in torch.__config__.parallel_info()
                     .splitlines() if "backend" in ln or "Library" in ln),
          flush=True)
    shift = {} if a.shift == 0 else dict(self_softmax_shift=a.shift,
                                         cross_softmax_shift=a.shift)
    params = weights_lib.load_params(str(ROOT / "weights" /
                                         "synthetic_superpoint_lightglue.npz"))
    matcher = LightGlue("superpoint", params=params, device="cpu", **FIXED,
                        **shift)
    data = pair_data(a.keypoints)
    first, ref_log = kept_call(matcher, data, True, a.matmuls)
    print(f"  {len(ref_log)} op calls a matcher call", flush=True)
    reported = False
    for c in range(1, a.calls):
        out, log = kept_call(matcher, data, False, a.matmuls)
        for i, (ref, got) in enumerate(zip(ref_log, log)):
            if ref[4] == got[4]:
                continue
            if not reported:
                name, fn, (args, kwargs) = ref[:3]
                if ref[3] == got[3]:
                    outs = {digest(tensors(fn(*cloned(args), **kwargs)))
                            for _ in range(20)}
                    more = (f"repeats its inputs to the bit; on the kept "
                            f"inputs 20 more runs give {len(outs)} distinct "
                            "outputs")
                else:
                    more = "its inputs differ too"
                print(f"  call {c}: the first op call whose output differs "
                      f"is {i} of {len(log)} ({name}): {more}", flush=True)
                reported = True
            break
        print(f"  call {c}: matching scores {score_gap(out, first):.3e} from "
              f"the first call, matches0 equal "
              f"{bool(np.array_equal(out['matches0'], first['matches0']))}",
              flush=True)
    if not reported:
        print("  every op call repeated its output to the bit", flush=True)


if __name__ == "__main__":
    main()
