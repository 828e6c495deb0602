"""B7 and B8 in bf16 and B9-B12 (B11 and B12 also in bf16) timed on the card
through entry points that every version of the port has, so that two
checkouts compare on one card.

For B7's and B8's bf16 forms (``stem.fused_stem(..., mp=True)``,
``stem2.fused_block2`` on B7's bf16 output as the main path hands it on)
and B10's (``aliked_stem.fused_aliked_stem_kernel`` on a bf16 image,
aliked-n16, y1 and x1p each) at B 1, 2 and 8, 768 x 1024 (SuperPoint's conv
weights times 3; ``aliked_params`` below), each launch is first held
against its plain version under chip_smoke.py's flip check
(within 2e-2 max(1, |plain|) and 2^-6 (|plain| + rms(plain row)) at all
but 1e-4 of the outputs, equal at all but 1e-2), and cuDNN's bf16
``F.conv2d`` (channels_last) on conv1b's and conv2a's shapes is timed
beside them: the same products without the rounding before the bias, a
yardstick the port never calls. B11's and B12's bf16 forms
(``score_head_lazy_kernel`` / ``score_head_cplane_kernel`` with ``mp=True``)
run on the same parts at B 1, 2 and 8 and are held to the same bounds at
all but 1e-4 of the outputs and launched twice, equal to the bit (their map
is fp32, whose last bits differ wherever the sums run in another order).

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
this, this, parent); ``--only`` keeps the rows whose name holds one of the
words given (``--only bf16``: the bf16 forms; ``--only score_head``: B11's
and B12's, fp32 and bf16)::

    PYTHONPATH=. python lightglue_tpu_torch/scripts/extract_times.py
    PYTHONPATH=<other checkout> python lightglue_tpu_torch/scripts/extract_times.py

``--e2e`` times ALIKED's whole extraction (``models.aliked.forward``, aliked-n16,
the weights above) at mp on 8 generated 768 x 1024 images, in its default
configuration and with ``fused_score_head`` (B11), ms an image by CUDA events
(the mean of 5 calls after 2), in place of the kernel rows.
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

import lightglue_tpu_torch
from lightglue_tpu_torch import ALIKEDConfig, SuperPointConfig
from lightglue_tpu_torch.models import aliked as al
from lightglue_tpu_torch.models import superpoint as sp
from lightglue_tpu_torch.ops import aliked_stem, nms, score_head, stem, stem2
from lightglue_tpu_torch.synthetic import image_pair

H, W = 768, 1024
TOL = 1e-4
SCORE_TOL = 1e-5  # chip_smoke.py's, absolute
REL, SCALED, FLIPS, DIFFER = 2e-2, 2.0 ** -6, 1e-4, 1e-2  # its flip check


def flips(got, want):
    """(share of outputs over either bf16 bound, share not equal)."""
    g, r = got.float(), want.float()
    d = (g - r).abs()
    rms = r.square().mean(-1, keepdim=True).sqrt()
    over = (d > REL * r.abs().clamp(min=1.0)) | (d > SCALED * (r.abs() + rms))
    return float(over.float().mean()), float((d > 0).float().mean())


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
    parser = argparse.ArgumentParser()
    parser.add_argument("--only", nargs="*", default=None)
    parser.add_argument("--e2e", action="store_true",
                        help="ALIKED at mp, B 8, with and without fused_score_head")
    args = parser.parse_args()
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
    if args.e2e:
        colour = torch.from_numpy(np.stack([gray, np.sqrt(gray), gray * gray], -1)
                                  .astype(np.float32)).cuda()
        for label, fused in (("default", False), ("fused_score_head", True)):
            conf = ALIKEDConfig(mp=True, fused_score_head=fused)
            with torch.inference_mode():
                ms = events_ms(lambda: al.forward(ap, conf, colour), iters=5, warmup=2)
            print(f"  ALIKED at mp, {label}, B 8, {H}x{W}: {ms / 8:.4f} ms an image "
                  "(CUDA events)", flush=True)
        return
    s4, s2 = s4.contiguous(), s2[:2].contiguous()
    rgb16 = img.to(torch.bfloat16)
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
        rows[f"score_head_lazy_bf16 B {b}"] = (
            lambda parts=parts: score_head.score_head_lazy_kernel(sh, *parts, mp=True),
            lambda parts=parts: score_head.score_head_lazy_plain(sh, *parts, mp=True))
        rows[f"score_head_cplane_bf16 B {b}"] = (
            lambda s0=s0: score_head.score_head_cplane_kernel(sh, s0, mp=True),
            lambda s0=s0: score_head.score_tail_plain(sh, s0, mp=True))
    p1 = {"conv1a": spp["conv1a"], "conv1b": spp["conv1b"]}
    p2 = {"conv2a": spp["conv2a"], "conv2b": spp["conv2b"]}
    imgs = torch.from_numpy(gray).cuda()[:, None]
    for b in (1, 2, 8):
        x = imgs[:b].contiguous()
        y = stem.fused_stem(p1, x, mp=True)  # B8's input as the main path's
        rows[f"fused_stem_bf16 B {b}"] = (
            lambda x=x: stem.fused_stem(p1, x, mp=True),
            lambda x=x: stem.fused_stem_plain(p1, x, mp=True))
        rows[f"fused_block2_bf16 B {b}"] = (
            lambda y=y: stem2.fused_block2(p2, y),
            lambda y=y: stem2.fused_block2_plain(p2, y))
        x16 = rgb16[:b].contiguous()
        rows[f"fused_aliked_stem_bf16 B {b}"] = (
            lambda x=x16: aliked_stem.fused_aliked_stem_kernel(stem_p, x),
            lambda x=x16: aliked_stem.fused_aliked_stem_plain(stem_p, x))
    if args.only is not None:
        rows = {k: v for k, v in rows.items() if any(w in k for w in args.only)}
    for name, (kern, plain) in rows.items():
        got, want = kern(), plain()
        if "_bf16" in name:
            again = kern()
            for g, w, a in zip(*(t if isinstance(t, tuple) else (t,)
                                 for t in (got, want, again))):
                over, differ = flips(g, w)
                fp32 = g.dtype == torch.float32  # B11's and B12's maps
                if not (over <= FLIPS and (fp32 or differ <= DIFFER)
                        and torch.equal(g, a)):
                    raise AssertionError(f"{name}: over {over}, not equal {differ}")
        elif name.startswith("simple_nms"):
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
        at = (f"{H}x{W}" if name.startswith(("score_head", "fused_stem_bf16",
                                             "fused_block2_bf16",
                                             "fused_aliked_stem_bf16"))
              else f"B 2, {H}x{W}")
        print(f"  {name} ({at}): kernel {k:.4f} ms by events, device "
              f"{dev:.4f} ms (CUDA graph); plain {p:.4f} ms", flush=True)
    if args.only is None or any("bf16" in w for w in args.only):
        for b in (1, 2, 8):
            for label, shape, w in (
                    ("conv1b", (b, 64, H, W), spp["conv1b"]["w"]),
                    ("conv2a", (b, 64, H // 2, W // 2), spp["conv2a"]["w"])):
                xa = torch.rand(shape, device="cuda").to(torch.bfloat16).contiguous(
                    memory_format=torch.channels_last)
                wa = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
                dev = graph_ms(lambda: torch.nn.functional.conv2d(xa, wa, padding=1))
                print(f"  cuDNN bf16 conv2d (channels_last) on {label}'s shape "
                      f"{shape}: device {dev:.4f} ms (a yardstick, not the same "
                      "function)", flush=True)
                del xa


if __name__ == "__main__":
    main()
