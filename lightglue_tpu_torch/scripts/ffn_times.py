"""B4 (``ops.ffn.fused_ffn_residual``) timed on the card through an entry
point that every version of the port has, so that two checkouts compare on
one card.

At (4, 1024, 256), (1, 2048, 256) and (16, 1024, 256), and over both images
of a composed cross block (B 1 at 2048 keypoints each, B 16 at 1024) as two
calls and, where the checkout has it, as one ``fused_ffn_residual_pair``
call, all with seeded random weights of the trained layers' scale, it
checks each call against the plain version (within 1e-4) and prints its
time by CUDA events (mean of 20 calls after 3) and as device time from
CUDA-graph replays, beside the plain version's events time, and the card's
name and power limit. Run it with ``PYTHONPATH`` set to each root in turns,
a process each (parent, this, this, parent)::

    PYTHONPATH=. python lightglue_tpu_torch/scripts/ffn_times.py
    PYTHONPATH=<other checkout> python lightglue_tpu_torch/scripts/ffn_times.py
"""

from __future__ import annotations

import subprocess

import torch

import lightglue_tpu_torch
from lightglue_tpu_torch.ops import ffn
from lightglue_tpu_torch.scripts.extract_times import events_ms, graph_ms

TOL = 1e-4
D = 256


def ffn_params(g):
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa
    return {"lin1": {"w": r(2 * D, 2 * D) / (2 * D) ** 0.5, "b": r(2 * D) * 0.1},
            "ln": {"scale": 1 + r(2 * D) * 0.1, "bias": r(2 * D) * 0.1},
            "lin2": {"w": r(2 * D, D) / (2 * D) ** 0.5, "b": r(D) * 0.1}}


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"  {smi}; lightglue_tpu_torch from "
          f"{lightglue_tpu_torch.__file__}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(5)
    p = ffn_params(g)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa
    pair = getattr(ffn, "fused_ffn_residual_pair", None)
    cases = {}
    for b, n in ((4, 1024), (1, 2048), (16, 1024)):
        x, m = r(b, n, D), r(b, n, D)
        cases[f"({b}, {n}, {D})"] = (
            lambda x=x, m=m: [ffn.fused_ffn_residual(x, m, p)], [x], [m])
    for b, n in ((1, 2048), (16, 1024)):
        xs, ms = [r(b, n, D), r(b, n, D)], [r(b, n, D), r(b, n, D)]
        cases[f"both images B {b}, {n} each, two calls"] = (
            lambda xs=xs, ms=ms: [ffn.fused_ffn_residual(x, m, p)
                                  for x, m in zip(xs, ms)], xs, ms)
        if pair is not None:
            cases[f"both images B {b}, {n} each, one pair call"] = (
                lambda xs=xs, ms=ms: list(pair(xs[0], ms[0], xs[1], ms[1], p)),
                xs, ms)
    for name, (fn, xs, ms) in cases.items():
        got = fn()
        err = max(float((a - ffn.fused_ffn_residual_plain(x, m, p)).abs().max())
                  for a, x, m in zip(got, xs, ms))
        if not err <= TOL:
            raise AssertionError(f"B4 {name}: {err} > {TOL}")
        plain = lambda xs=xs, ms=ms: [ffn.fused_ffn_residual_plain(x, m, p)  # noqa
                                      for x, m in zip(xs, ms)]
        print(f"  B4 {name}: events {events_ms(fn):.4f} ms, device "
              f"{graph_ms(fn):.4f} ms, plain {events_ms(plain):.4f} ms, "
              f"max_abs_err {err:.3e}", flush=True)


if __name__ == "__main__":
    main()
