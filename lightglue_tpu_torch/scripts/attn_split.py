"""Key-split study of the attention walk (K1 and B1') on a CUDA device.

    python -m lightglue_tpu_torch.scripts.attn_split [--seed 0] [--calls 20]

For K1 at head_dim 64 (B, 4, 1024, 64) and 128 (B, 2, 1024, 128) and for
B1' at head_dim 128 (B, 2, M 1024 / N 768, masked keys), at B 1, 4 and 16,
it runs the walk with each candidate number of key splits S (1, 2, 3, 4,
6, 8, at most the key tiles), checks each against the plain version
(1e-4), and times each in mirrored order (1 .. 8 .. 1) with CUDA events
over CUDA-graph replays of ``--calls`` launches, so that the times are the
device's and not the host's. Beside them: the S that ``flash.split_plan``
picks and one PyTorch call computing the same function (SDPA; two for
B1'). It prints the card's name and power limit first and needs a CUDA
device.
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, Optional, Sequence

import torch

from ..ops import flash
from .micro_gather2 import card

CANDIDATES = (1, 2, 3, 4, 6, 8)
TOL = 1e-4  # the smoke's tolerance of K1 and B1' against their plain versions


def graph_ms(fn: Callable[[], object], calls: int = 20, replays: int = 3
             ) -> float:
    """Device ms per call of ``fn``: ``calls`` calls captured in one CUDA
    graph, replayed ``replays`` times between two CUDA events (after a
    warm-up replay). ``fn`` must launch on the current stream only."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(calls):
                fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def _cases(b: int, g: torch.Generator) -> Dict[str, tuple]:
    """name -> (walks, scale, plain outputs, rows compared, library call)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    out = {}
    for d, h in ((64, 4), (128, 2)):
        q, k, v = (rnd(b, h, 1024, d) for _ in range(3))
        zero = torch.zeros(b, 1, 1, 1024, device="cuda")
        out[f"K1 ({b}, {h}, 1024, {d})"] = (
            [(q, k, v, None, torch.empty_like(q))], d ** -0.5,
            (flash.flash_sdpa_plain(q, k, v),), (None,),
            lambda q=q, k=k, v=v, z=zero: sdpa(q, k, v, attn_mask=z))
    qk0, v0 = rnd(b, 2, 1024, 128), rnd(b, 2, 1024, 128)
    qk1, v1 = rnd(b, 2, 768, 128), rnd(b, 2, 768, 128)
    va0 = torch.rand(b, 1024, generator=g, device="cuda") < 0.9
    va1 = torch.rand(b, 768, generator=g, device="cuda") < 0.9
    b0, b1 = flash.key_bias(va0), flash.key_bias(va1)
    out[f"B1' ({b}, 2, M 1024 / N 768, 128)"] = (
        [(qk0, qk1, v1, va1, torch.empty_like(qk0)),
         (qk1, qk0, v0, va0, torch.empty_like(qk1))], 128 ** -0.5,
        flash.flash_cross_pair_plain(qk0, qk1, v0, v1, va0, va1),
        (va0[:, None].expand(-1, 2, -1), va1[:, None].expand(-1, 2, -1)),
        lambda: (sdpa(qk0, qk1, v1, attn_mask=b1[:, None, None]),
                 sdpa(qk1, qk0, v0, attn_mask=b0[:, None, None])))
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict[tuple, float]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attn_split needs a CUDA device")
    print(card(), flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    res: Dict[tuple, float] = {}
    for b in (1, 4, 16):
        for name, (walks, scale, want, rows, library) in _cases(b, g).items():
            d = walks[0][0].shape[-1]
            key_tile = flash.walk_shape(dev.index, d)[0]
            tiles = [-(-w[1].shape[2] // key_tile) for w in walks]
            plan = flash.planned_splits(walks)
            cands = [s for s in CANDIDATES if s <= max(tiles)]
            runs = {}
            for s in cands:
                splits = [min(s, t) for t in tiles]
                runs[s] = lambda splits=splits: flash.launch_attention(
                    dev, walks, scale, None, splits)
                runs[s]()
                for w, ref, r in zip(walks, want, rows):
                    diff = (w[4] - ref).abs()
                    err = float((diff if r is None else diff[r]).max())
                    if not err <= TOL:
                        raise AssertionError(f"{name} S {s}: {err} > {TOL}")
            times = {s: [] for s in cands}
            for s in cands + cands[::-1]:
                times[s].append(graph_ms(runs[s], args.calls))
            lib = graph_ms(library, args.calls)
            print(f"{name}: key tile {key_tile}, plan S {plan}; library "
                  f"{lib:.4f} ms", flush=True)
            for s, t in times.items():
                ms = sum(t) / len(t)
                res[name, s] = ms
                print(f"  S {s}: {ms:.4f} ms ({t[0]:.4f} / {t[1]:.4f})"
                      + ("  <- plan" if s == max(plan) else ""), flush=True)
            res[name, "library"] = lib
    return res


if __name__ == "__main__":
    main()
