"""B9-B12 timed on the card through entry points that every version of the
port has, so that two checkouts compare on one card.

For B9 (``ops.nms.simple_nms_kernel``) at r 4 on SuperPoint's score maps and
at r 2 on ALIKED's, and for B10 (``ops.aliked_stem.fused_aliked_stem_kernel``,
aliked-n16), all at B 2 and 768 x 1024 (random weights: ``aliked_params``
below, and SuperPoint's conv weights times 3), and for B11
(``ops.score_head.score_head_lazy_kernel``) and B12
(``score_head_cplane_kernel``) on ALIKED's branch parts of the same
images at B 1, 2 and 8, it checks each launch against the plain version
(B9 to the bit, B10 within 1e-4 of max(1, max |plain|), B11 and B12
within 1e-5), then prints the kernel's time by CUDA events (mean of 20
launches after 3) and as device time from CUDA-graph replays, beside the
plain version's events time, and the card's name and power limit. Run it
with ``PYTHONPATH`` set to each root in turns, a process each (parent,
this, this, parent)::

    PYTHONPATH=. python lightglue_tpu_torch/scripts/extract_times.py
    PYTHONPATH=<other checkout> python lightglue_tpu_torch/scripts/extract_times.py
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

import lightglue_tpu_torch
from lightglue_tpu_torch import ALIKEDConfig, SuperPointConfig
from lightglue_tpu_torch.models import aliked as al
from lightglue_tpu_torch.models import superpoint as sp
from lightglue_tpu_torch.ops import aliked_stem, nms, score_head
from lightglue_tpu_torch.synthetic import image_pair

H, W = 768, 1024
TOL = 1e-4
SCORE_TOL = 1e-5  # chip_smoke.py's, absolute


def events_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls=10, replays=3):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream), torch.cuda.graph(graph, stream=stream):
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


def aliked_params(model_name="aliked-n16", device="cuda"):
    """ALIKED at its published widths with seeded random weights: encoder
    and aggregation conv weights times 2, the score head's times 3, the
    offset convs and the descriptor head as drawn (with the init's own
    scale every score lies within about 1e-3 of 0.5); random batch-norm
    statistics per channel (scale and var U(0.5, 1.5), bias and mean
    N(0, 0.1)), so that a kernel that skipped or swapped its folded batch
    norms would not agree with its plain version."""
    g = torch.Generator().manual_seed(1)

    def walk(node, gain):
        out = {}
        for k, v in node.items():
            if k in ("bn1", "bn2"):
                d = len(v["scale"])
                v = {"scale": 0.5 + torch.rand(d, generator=g),
                     "bias": 0.1 * torch.randn(d, generator=g),
                     "mean": 0.1 * torch.randn(d, generator=g),
                     "var": 0.5 + torch.rand(d, generator=g)}
            if isinstance(v, dict):
                out[k] = walk(v, 1.0 if k in ("offset_conv", "desc_head")
                              else 3.0 if k == "score_head" else gain)
            else:
                out[k] = (v * gain if k == "w" else v).to(device)
        return out

    return walk(al.init_params(ALIKEDConfig(model_name=model_name),
                               torch.Generator().manual_seed(0)), 2.0)


def main() -> None:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"  {card}; {lightglue_tpu_torch.__file__}")
    rng = np.random.default_rng(5)
    gray = np.stack([image_pair(rng, H, W)[0] for _ in range(8)])
    spp = {k: {"w": v["w"].cuda() * 3.0, "b": v["b"].cuda()}
           for k, v in sp.init_params(SuperPointConfig(),
                                      torch.Generator().manual_seed(0)).items()}
    ap = aliked_params()
    img = torch.from_numpy(np.stack([gray, np.sqrt(gray), gray * gray], 1)
                           .astype(np.float32)).cuda()
    with torch.inference_mode():
        s4, _ = sp.dense_forward(spp, torch.from_numpy(gray[:2]).cuda()[..., None])
        ys, s2 = al._dense_branches(ap, img, fused_stem=False)
        parts8 = al._score_parts(ap["score_head"], ys, True)
    s4, s2 = s4.contiguous(), s2[:2].contiguous()
    img = img[:2].contiguous()
    sh = ap["score_head"]
    stem_p = {"block1": ap["block1"], "conv1": ap["conv1"]}
    rows = {
        "simple_nms r 4": (lambda: nms.simple_nms_kernel(s4, 4),
                           lambda: nms.simple_nms_plain(s4, 4)),
        "simple_nms r 2": (lambda: nms.simple_nms_kernel(s2, 2),
                           lambda: nms.simple_nms_plain(s2, 2)),
        "fused_aliked_stem": (
            lambda: aliked_stem.fused_aliked_stem_kernel(stem_p, img),
            lambda: aliked_stem.fused_aliked_stem_plain(stem_p, img)),
    }
    for b in (1, 2, 8):
        parts = [p[:b].contiguous() for p in parts8]
        s0 = score_head.upsampled_sum(*parts)
        rows[f"score_head_lazy B {b}"] = (
            lambda parts=parts: score_head.score_head_lazy_kernel(sh, *parts),
            lambda parts=parts: score_head.score_head_lazy_plain(sh, *parts))
        rows[f"score_head_cplane B {b}"] = (
            lambda s0=s0: score_head.score_head_cplane_kernel(sh, s0),
            lambda s0=s0: score_head.score_tail_plain(sh, s0))
    for name, (kern, plain) in rows.items():
        got, want = kern(), plain()
        if name.startswith("simple_nms"):
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"{name} differs from its plain version")
        elif name.startswith("score_head"):
            err = float((got - want).abs().max())
            if not err <= SCORE_TOL:
                raise AssertionError(f"{name}: {err} > {SCORE_TOL}")
        else:
            for a, b in zip(got, want):
                err = float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                if not err <= TOL:
                    raise AssertionError(f"{name}: {err} > {TOL}")
        p, k, dev = events_ms(plain), events_ms(kern), graph_ms(kern)
        at = f"{H}x{W}" if name.startswith("score_head") else f"B 2, {H}x{W}"
        print(f"  {name} ({at}): kernel {k:.4f} ms by events, device "
              f"{dev:.4f} ms (CUDA graph); plain {p:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
