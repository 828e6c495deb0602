"""The matcher's bf16 kernels (mp) timed on the card through entry points
that every version of the port with the matcher's bf16 forms has, so that
two checkouts compare on one card.

The attention walk: K1 masked at (4, 4, 4096, 64), (4, 2, 4096, 128) and
(4, 4, 1024, 64), B1s at (4, 4, 4096, 64), B1' at (4, 2, M 1024 / N 768,
128), K2 exact and shift 12 at (4, 4, M 2048 / N 1536) and B6's attention
(launch_cross in its mode EXACT_BLOCK) at (16, 4, 1024, 1024); each beside
one ``scaled_dot_product_attention`` call in bf16 on the same inputs (two
for B1', one a direction). The blocks: B5 (four heads of 64 and two of
128) and B6 bf16 at B 1, 4 and 16
(1024 keypoints, M 1024 / N 768 for B6), B4 bf16 over both images at B 16
(1024 / 768 each) and B5's projection (``block_tc.project``, 3 groups)
beside ``torch.addmm`` in bf16. The host time of one eager launch (B5's
projection at B 1 and K1 at (1, 4, 1024, 64), in bf16 and fp32: the
bf16 forms encode their TMA tensor maps at each launch), from 200 calls
with no synchronisation between them. Then ``BatchMatcher(mp=True)`` at
1024 keypoints, fixed at B 1 and 16 and adaptive with shift 12 at B 16
(the JAX headline): host wall ms a call (median and quartiles of 30 calls,
no profiler), then device ms a call (torch.profiler). Each kernel call is checked
against its plain version (2e-2 max(1, |plain|)) first. Times: device ms
from CUDA-graph replays, and the card's name and power limit. Run it with
``PYTHONPATH`` set to each root in turns, a process each (parent, this,
this, parent)::

    PYTHONPATH=. python lightglue_tpu_torch/scripts/bf16_times.py
    PYTHONPATH=<other checkout> python lightglue_tpu_torch/scripts/bf16_times.py
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch

import lightglue_tpu_torch
from lightglue_tpu_torch import BatchMatcher, nn, weights
from lightglue_tpu_torch.configs import lightglue_config
from lightglue_tpu_torch.ops import (block_tc, ffn, flash, flash_cross,
                                     flash_cross_block, flash_self)
from lightglue_tpu_torch.scripts.extract_times import graph_ms
from lightglue_tpu_torch.synthetic import planted_pairs

BF = torch.bfloat16
REL = 2e-2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(
    lightglue_tpu_torch.__file__)))
NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "weights", "synthetic_superpoint_lightglue.npz")


def close(name, got, ref):
    got = got if isinstance(got, (tuple, list)) else (got,)
    ref = ref if isinstance(ref, (tuple, list)) else (ref,)
    for a, b in zip(got, ref):
        a, b = a.float(), b.float()
        err = float(((a - b).abs() / b.abs().clamp(min=1)).max())
        if not err <= REL:
            raise AssertionError(f"{name}: {err:.3e} > {REL}")


def row(name, ms, lib=None, lib_name="SDPA bf16"):
    extra = "" if lib is None else f", {lib_name} {lib:.4f}"
    print(f"  {name}: device {ms:.4f} ms{extra}", flush=True)


def sdpa(q, k, v, valid=None):
    mask = None if valid is None else valid[:, None, None, :]
    return torch.nn.functional.scaled_dot_product_attention(q, k, v,
                                                            attn_mask=mask)


def walk_rows(g):
    r = lambda *s: torch.randn(*s, generator=g, device="cuda").to(BF)  # noqa
    for shape in ((4, 4, 4096, 64), (4, 2, 4096, 128), (4, 4, 1024, 64)):
        q, k, v = r(*shape), r(*shape), r(*shape)
        valid = torch.rand(shape[0], shape[2], generator=g,
                           device="cuda") < 0.9
        close(f"K1 {shape}", flash.flash_sdpa(q, k, v, valid),
              flash.flash_sdpa_plain(q, k, v, valid))
        row(f"K1 masked {shape}", graph_ms(lambda: flash.flash_sdpa(
            q, k, v, valid)), graph_ms(lambda: sdpa(q, k, v, valid)))
        if shape == (4, 4, 4096, 64):
            row(f"B1s masked {shape}", graph_ms(lambda: flash.flash_sdpa(
                q, k, v, valid, shift=12.0)))
    b, h, m, n = 4, 2, 1024, 768
    qk0, qk1, v0, v1 = r(b, h, m, 128), r(b, h, n, 128), r(b, h, m, 128), \
        r(b, h, n, 128)
    close("B1'", flash.flash_cross_pair(qk0, qk1, v0, v1),
          flash.flash_cross_pair_plain(qk0, qk1, v0, v1))
    row(f"B1' {(b, h, m, n)}", graph_ms(
        lambda: flash.flash_cross_pair(qk0, qk1, v0, v1)),
        graph_ms(lambda: (sdpa(qk0, qk1, v1), sdpa(qk1, qk0, v0))))
    for (b, h, m, n) in ((4, 4, 2048, 1536), (16, 4, 1024, 1024)):
        qk0, qk1, v0, v1 = r(b, h, m, 64), r(b, h, n, 64), r(b, h, m, 64), \
            r(b, h, n, 64)
        va0 = torch.rand(b, m, generator=g, device="cuda") < 0.9
        va1 = torch.rand(b, n, generator=g, device="cuda") < 0.9
        if m == 2048:
            for shift in (None, 12.0):
                close(f"K2 {shift}", flash_cross.fused_cross_attention(
                    qk0, qk1, v0, v1, va0, va1, shift),
                    flash_cross.fused_cross_attention_plain(
                        qk0, qk1, v0, v1, va0, va1, shift))
                row(f"K2 shift {shift} {(b, h, m, n)}", graph_ms(
                    lambda: flash_cross.fused_cross_attention(
                        qk0, qk1, v0, v1, va0, va1, shift)))
        else:
            s0 = (qk0.float() * 0.125).to(BF)
            s1 = (qk1.float() * 0.125).to(BF)
            call = lambda: flash_cross.launch_cross(  # noqa: E731
                s0, s1, v0, v1, va0, va1, flash_cross.EXACT_BLOCK, 1.0)
            got = call()
            ref = flash_cross_block.cross_block_attention_plain(
                s0, s1, v0, v1, va0, va1)
            rows = lambda v: v[:, None].expand(-1, h, -1)  # noqa: E731
            close("B6's attention (valid rows)",
                  (got[0][rows(va0)], got[1][rows(va1)]),
                  (ref[0][rows(va0)], ref[1][rows(va1)]))
            row(f"B6's attention {(b, h, m, n)}", graph_ms(call))


def block_rows(g, layer):
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa
    w5 = flash_self.prepare(layer["self_attn"], 4, None, mp=True)
    w5h2 = flash_self.prepare(layer["self_attn"], 2, None, mp=True)
    w6 = flash_cross_block.prepare(layer["cross_attn"], 4, None, mp=True)
    pf = layer["self_attn"]["ffn"]
    for b in (1, 4, 16):
        x = r(b, 1024, 256).to(BF)
        ang = torch.rand(b, 1, 1024, 32, generator=g, device="cuda") * 6 - 3
        enc = torch.stack([ang.cos(), ang.sin()])
        valid = torch.rand(b, 1024, generator=g, device="cuda") < 0.85
        close(f"B5 B {b}", flash_self.fused_self_block(w5, x, enc, valid),
              flash_self.fused_self_block_plain(w5, x, enc, valid))
        row(f"B5 bf16 B {b}", graph_ms(
            lambda: flash_self.fused_self_block(w5, x, enc, valid)))
        ang2 = torch.rand(b, 1, 1024, 64, generator=g, device="cuda") * 6 - 3
        enc2 = torch.stack([ang2.cos(), ang2.sin()])
        close(f"B5 two heads B {b}",
              flash_self.fused_self_block(w5h2, x, enc2, valid),
              flash_self.fused_self_block_plain(w5h2, x, enc2, valid))
        row(f"B5 bf16 two heads of 128 B {b}", graph_ms(
            lambda: flash_self.fused_self_block(w5h2, x, enc2, valid)))
        x0, x1 = r(b, 1024, 256).to(BF), r(b, 768, 256).to(BF)
        va0 = torch.rand(b, 1024, generator=g, device="cuda") < 0.9
        va1 = torch.rand(b, 768, generator=g, device="cuda") < 0.9
        got = flash_cross_block.fused_cross_block(w6, x0, x1, va0, va1)
        ref = flash_cross_block.fused_cross_block_plain(w6, x0, x1, va0, va1)
        close(f"B6 B {b}", (got[0][va0], got[1][va1]),
              (ref[0][va0], ref[1][va1]))
        row(f"B6 bf16 B {b}", graph_ms(
            lambda: flash_cross_block.fused_cross_block(w6, x0, x1, va0,
                                                        va1)))
        xr = x.reshape(-1, 256)
        wt, bias = w5["w_in"], w5["b_in"].to(BF)
        row(f"B5's projection B {b}", graph_ms(
            lambda: block_tc.project(w5, [x], 3, enc)), graph_ms(
            lambda: torch.addmm(bias, xr, wt.t())), "addmm bf16")
        if b == 16:
            m0, m1 = r(b, 1024, 256).to(BF), r(b, 768, 256).to(BF)
            close("B4 pair", ffn.fused_ffn_residual_pair(x0, m0, x1, m1, pf),
                  (ffn.fused_ffn_residual_plain(x0, m0, pf),
                   ffn.fused_ffn_residual_plain(x1, m1, pf)))
            row("B4 bf16 both images B 16", graph_ms(
                lambda: ffn.fused_ffn_residual_pair(x0, m0, x1, m1, pf)))


def host_us(fn, calls=200):
    """Host microseconds a call of ``fn``, no synchronisation between the
    calls (the launches queue on the card)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def eager_rows(g, layer):
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa
    for dt in (BF, torch.float32):
        w5 = flash_self.prepare(layer["self_attn"], 4, None,
                                mp=dt == BF)
        x = r(1, 1024, 256).to(dt)
        ang = r(1, 1, 1024, 32)
        enc = torch.stack([ang.cos(), ang.sin()])
        q, k, v = (r(1, 4, 1024, 64).to(dt) for _ in range(3))
        name = "bf16" if dt == BF else "fp32"
        print(f"  host us an eager launch, {name}: B5's projection B 1 "
              f"{host_us(lambda: block_tc.project(w5, [x], 3, enc)):.1f}, "
              f"K1 (1, 4, 1024, 64) "
              f"{host_us(lambda: flash.flash_sdpa(q, k, v)):.1f}",
              flush=True)


def device_ms(fn, calls=5, warmup=3):
    """Device ms a call, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = sum(e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA)
    return dev / 1e3 / calls


def wall_ms(fn, calls=30, warmup=3):
    """(median, first and third quartile) host wall ms a call."""
    for _ in range(warmup):
        fn()
    ms = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        ms.append((time.perf_counter() - t0) * 1e3)
    return np.percentile(ms, [50, 25, 75])


def serving_rows(params):
    pr = planted_pairs(np.random.default_rng(11), 16, 1024)
    pairs = [tuple({"keypoints": pr[f"keypoints{s}"][i],
                    "descriptors": pr[f"descriptors{s}"][i],
                    "image_size": pr["image_size"][i]} for s in (0, 1))
             for i in range(16)]
    fixed = dict(depth_confidence=-1.0, width_confidence=-1.0)
    shift = dict(self_softmax_shift=12.0, cross_softmax_shift=12.0)
    for label, conf, b in (("fixed", fixed, 1), ("fixed", fixed, 16),
                           ("adaptive, shift 12", shift, 16)):
        bm = BatchMatcher(lightglue_config("superpoint", mp=True, **conf),
                          params, buckets=(1024,), max_batch=16)
        bm.warmup([b])
        call = lambda: bm.match_pairs(pairs[:b])  # noqa: E731
        med, q1, q3 = wall_ms(call)
        dev = device_ms(call)
        print(f"  BatchMatcher mp {label} B {b}: host wall {med:.2f} ms "
              f"(quartiles {q1:.2f}-{q3:.2f}), device {dev:.2f} ms",
              flush=True)
        del bm


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"  {smi}; lightglue_tpu_torch from {ROOT}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(17)
    params = weights.load_params(NPZ)
    layer = nn.index_params(nn.params_to(params["transformers"], "cuda"), 0)
    walk_rows(g)
    block_rows(g, layer)
    eager_rows(g, layer)
    if "--no-serving" not in sys.argv:
        serving_rows(params)


if __name__ == "__main__":
    main()
