"""Smoke run of lightglue_tpu_torch on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, any failure raising (non-zero exit, no result line):
  0. device: the card's name and power limit, versions; TF32 off;
  1. build: nvcc compiles csrc/*.cu into _build/ (timed);
  2. each kernel against its plain PyTorch version at the main path's shapes,
     then at tiny and ragged shapes;
  3. the main path: pipeline.LightGlue with the trained matcher weights on
     planted pairs at 1024 keypoints (single pairs, one through padding
     buckets, and a batch of 8; fixed and adaptive), with every kernel's
     launch count read around it, and one pair held against the same call
     on CPU tensors;
  4. timing with CUDA events: each kernel beside its plain version, and
     end-to-end pairs/s.
The line before the last is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from lightglue_tpu_torch import LightGlue, _build  # noqa: E402
from lightglue_tpu_torch import weights as weights_lib  # noqa: E402
from lightglue_tpu_torch.ops import assignment_fused as af  # noqa: E402
from lightglue_tpu_torch.ops import ffn, flash, flash_cross  # noqa: E402
from lightglue_tpu_torch.synthetic import planted_pairs  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = os.path.join(ROOT, "weights", "synthetic_superpoint_lightglue.npz")
# The kernels sum in another order than the plain versions (tiles, online
# softmax, fma): fp32 outputs of O(1-10) agree to ~1e-6, checked at 1e-4.
TOL = 1e-4
KERNELS = {
    "flash_sdpa": ("lightglue_tpu_torch/csrc/flash_sdpa.cu",
                   "lightglue_tpu/ops/flash.py:94"),
    "fused_cross_attention": ("lightglue_tpu_torch/csrc/flash_cross.cu",
                              "lightglue_tpu/ops/flash_cross.py:44"),
    "fused_ffn_residual": ("lightglue_tpu_torch/csrc/ffn.cu",
                           "lightglue_tpu/ops/ffn.py:40"),
    "fused_filter_matches": ("lightglue_tpu_torch/csrc/assignment_fused.cu",
                             "lightglue_tpu/ops/assignment_fused.py:39"),
}


def phase(name):
    print(f"== {name}", flush=True)


def max_err(a, b, rows=None):
    d = (a.float() - b.float()).abs()
    if rows is not None:
        d = d[rows]
    return float(d.max())


def check(name, err, tol=TOL):
    print(f"  {name}: max_abs_err {err:.3e} (tol {tol:g})", flush=True)
    if not err <= tol:
        raise AssertionError(f"{name}: {err} > {tol}")
    return err


def device_phase():
    phase("0 device")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke.py runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"  {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    return smi


def build_phase():
    phase("1 build")
    t0 = time.time()
    path, log = _build.build()
    _build.library()
    for line in log.splitlines():
        if "Used" in line or "spill" in line:
            print("  " + line.strip())
    print(f"  built {os.path.relpath(path, ROOT)} in {time.time() - t0:.1f} s",
          flush=True)


def rand(gen, *shape):
    return torch.randn(*shape, generator=gen, device="cuda")


def kernel_inputs():
    """Main-path shapes of every kernel (B 4, 1024 keypoints, D 256)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    b, h, n = 4, 4, 1024
    mask1000 = torch.rand(b, 1000, generator=g, device="cuda") < 0.8
    mask1000[1] = False  # one batch row with every key masked
    p = {
        "lin1": {"w": rand(g, 512, 512) / 512**0.5, "b": rand(g, 512) * 0.1},
        "ln": {"scale": 1 + rand(g, 512) * 0.1, "bias": rand(g, 512) * 0.1},
        "lin2": {"w": rand(g, 512, 256) / 512**0.5, "b": rand(g, 256) * 0.1},
    }
    pairs = planted_pairs(np.random.default_rng(1), b, n)
    mdesc = [torch.from_numpy(pairs[f"descriptors{i}"]).cuda() * 3.0
             for i in (0, 1)]
    masks = [torch.rand(b, n, generator=g, device="cuda") < 0.9
             for _ in range(2)]
    z = [rand(g, b, n), rand(g, b, n)]
    # planted exact ties (copies with the same matchability): row 5 of
    # image 0 is a dominant match of column 100 of image 1, which is copied
    # to 700 and 900, and row 5 is copied to 800; the lowest index must win
    mdesc[0][:, 5] = mdesc[1][:, 100] * 4.0
    z[0][:, 5] = z[1][:, 100] = 5.0
    for j in (700, 900):
        mdesc[1][:, j] = mdesc[1][:, 100]
        z[1][:, j] = z[1][:, 100]
    mdesc[0][:, 800] = mdesc[0][:, 5]
    z[0][:, 800] = z[0][:, 5]
    masks[0][:, [5, 800]] = True
    masks[1][:, [100, 700, 900]] = True
    return {
        "k1": (rand(g, b, h, n, 64), rand(g, b, h, n, 64),
               rand(g, b, h, n, 64)),
        "k1_ragged": (rand(g, b, h, 1000, 64), rand(g, b, h, 1000, 64),
                      rand(g, b, h, 1000, 64), mask1000),
        "k2": (rand(g, b, h, 1024, 64), rand(g, b, h, 768, 64),
               rand(g, b, h, 1024, 64), rand(g, b, h, 768, 64),
               torch.rand(b, 1024, generator=g, device="cuda") < 0.9,
               torch.rand(b, 768, generator=g, device="cuda") < 0.9),
        "k3": (rand(g, b, n, 256), rand(g, b, n, 256), p),
        "k4": (mdesc[0], mdesc[1], z[0], z[1], *masks),
    }


def k4_margin_rows(mdesc0, mdesc1, ls0, ls1, mask0, mask1):
    """Rows/columns whose top-two gap of the argmax score exceeds 1e-3."""
    b, m, _ = mdesc0.shape
    n = mdesc1.shape[1]
    bias0 = af._bias(mask0, b, m, "cuda")[:, :, None]
    bias1 = af._bias(mask1, b, n, "cuda")[:, None, :]
    sim = mdesc0 @ mdesc1.transpose(1, 2)
    s = sim + bias1 + bias0
    rterm = af._terms(ls0, torch.logsumexp(s, 2), mask0)
    cterm = af._terms(ls1, torch.logsumexp(s, 1), mask1)
    s2 = sim * 2.0 + bias1 + bias0
    top0 = (s2 + cterm[:, None, :]).topk(2, dim=2).values
    top1 = (s2 + rterm[:, :, None]).topk(2, dim=1).values
    return ((top0[..., 0] - top0[..., 1]) > 1e-3) & mask0, \
        ((top1[:, 0] - top1[:, 1]) > 1e-3) & mask1


def kernel_phase(x):
    phase("2 kernels against their plain versions")
    errs = {}
    q, k, v = x["k1"]
    e1 = check("flash_sdpa (4,4,1024,64)",
               max_err(flash.flash_sdpa(q, k, v), flash.flash_sdpa_plain(q, k, v)))
    q, k, v, valid = x["k1_ragged"]
    got = flash.flash_sdpa(q, k, v, valid)
    e2 = check("flash_sdpa (4,4,1000,64) masked",
               max_err(got, flash.flash_sdpa_plain(q, k, v, valid)))
    if not bool((got[1] == 0).all()):
        raise AssertionError("flash_sdpa: the all-masked batch row is not 0")
    errs["flash_sdpa"] = max(e1, e2)

    qk0, qk1, v0, v1, va0, va1 = x["k2"]
    m0, m1 = flash_cross.fused_cross_attention(qk0, qk1, v0, v1, va0, va1)
    r0, r1 = flash_cross.fused_cross_attention_plain(qk0, qk1, v0, v1, va0, va1)
    rows0 = va0[:, None, :].expand(-1, 4, -1)  # compared on valid rows
    errs["fused_cross_attention"] = max(
        check("fused_cross_attention m0 (M 1024, N 768) masked",
              max_err(m0, r0, rows0)),
        check("fused_cross_attention m1", max_err(m1, r1)))

    xx, msg, p = x["k3"]
    errs["fused_ffn_residual"] = check(
        "fused_ffn_residual (4,1024,256)",
        max_err(ffn.fused_ffn_residual(xx, msg, p),
                ffn.fused_ffn_residual_plain(xx, msg, p)))

    d0, d1, z0, z1, mk0, mk1 = x["k4"]
    ls0, ls1 = torch.nn.functional.logsigmoid(z0), torch.nn.functional.logsigmoid(z1)
    km0, kv0, km1, kv1 = af._filter_reductions_kernel(d0, d1, ls0, ls1, mk0, mk1)
    pm0, pv0, pm1, pv1 = af.filter_reductions_plain(d0, d1, ls0, ls1, mk0, mk1)
    errs["fused_filter_matches"] = max(
        check("fused_filter_matches row max (4,1024,1024,256)",
              max_err(kv0, pv0, mk0)),
        check("fused_filter_matches column max", max_err(kv1, pv1, mk1)))
    sure0, sure1 = k4_margin_rows(d0, d1, ls0, ls1, mk0, mk1)
    eq0 = km0.long() == pm0
    eq1 = km1.long() == pm1
    print(f"  fused_filter_matches argmax agreement: rows "
          f"{float(eq0[mk0].float().mean()):.6f}, columns "
          f"{float(eq1[mk1].float().mean()):.6f}; on the "
          f"{int(sure0.sum())}+{int(sure1.sum())} with top-two gap > 1e-3: "
          f"{int(eq0[sure0].sum())}+{int(eq1[sure1].sum())} equal")
    if not (bool(eq0[sure0].all()) and bool(eq1[sure1].all())):
        raise AssertionError("fused_filter_matches: argmax differs on a "
                             "row with a clear maximum")
    ties = (km0[:, 5] == 100) & (km0[:, 800] == 100) & (km1[:, 100] == 5)
    print(f"  fused_filter_matches planted exact ties: lowest index wins in "
          f"{int(ties.sum())}/{len(ties)} pairs")
    if not bool(ties.all()):
        raise AssertionError("fused_filter_matches: a tie went to a higher index")
    torch.cuda.synchronize()
    return errs


def edge_phase():
    """Tiny and ragged shapes: single rows, partial tiles, D 128."""
    g = torch.Generator(device="cuda").manual_seed(2)
    errs = dict.fromkeys(KERNELS, 0.0)

    def mask(b, n):
        m = torch.rand(b, n, generator=g, device="cuda") < 0.7
        m[:, 0] = True
        return m

    for nq, nk in ((1, 1), (65, 63), (3, 130)):
        q, k, v = rand(g, 2, 1, nq, 64), rand(g, 2, 1, nk, 64), rand(g, 2, 1, nk, 64)
        valid = mask(2, nk)
        errs["flash_sdpa"] = max(errs["flash_sdpa"], max_err(
            flash.flash_sdpa(q, k, v, valid), flash.flash_sdpa_plain(q, k, v, valid)))
    for m, n in ((1, 1), (65, 130), (130, 3)):
        qk0, v0 = rand(g, 1, 2, m, 64), rand(g, 1, 2, m, 64)
        qk1, v1 = rand(g, 1, 2, n, 64), rand(g, 1, 2, n, 64)
        va0, va1 = mask(1, m), mask(1, n)
        got = flash_cross.fused_cross_attention(qk0, qk1, v0, v1, va0, va1)
        ref = flash_cross.fused_cross_attention_plain(qk0, qk1, v0, v1, va0, va1)
        rows0 = va0[:, None, :].expand(-1, 2, -1)
        errs["fused_cross_attention"] = max(
            errs["fused_cross_attention"], max_err(got[0], ref[0], rows0),
            max_err(got[1], ref[1]))
    for d, rows in ((256, 1), (128, 33)):
        x, msg = rand(g, 1, rows, d), rand(g, 1, rows, d)
        p = {"lin1": {"w": rand(g, 2 * d, 2 * d) / (2 * d) ** 0.5,
                      "b": rand(g, 2 * d) * 0.1},
             "ln": {"scale": 1 + rand(g, 2 * d) * 0.1, "bias": rand(g, 2 * d) * 0.1},
             "lin2": {"w": rand(g, 2 * d, d) / (2 * d) ** 0.5, "b": rand(g, d) * 0.1}}
        errs["fused_ffn_residual"] = max(errs["fused_ffn_residual"], max_err(
            ffn.fused_ffn_residual(x, msg, p), ffn.fused_ffn_residual_plain(x, msg, p)))
    for m, n, d in ((1, 1, 64), (65, 129, 64), (3, 70, 256)):
        d0, d1 = rand(g, 2, m, d) * 0.3, rand(g, 2, n, d) * 0.3
        ls0 = torch.nn.functional.logsigmoid(rand(g, 2, m))
        ls1 = torch.nn.functional.logsigmoid(rand(g, 2, n))
        mk0, mk1 = mask(2, m), mask(2, n)
        km0, kv0, km1, kv1 = af._filter_reductions_kernel(d0, d1, ls0, ls1, mk0, mk1)
        pm0, pv0, pm1, pv1 = af.filter_reductions_plain(d0, d1, ls0, ls1, mk0, mk1)
        if not (bool((km0.long() == pm0)[mk0].all())
                and bool((km1.long() == pm1)[mk1].all())):
            raise AssertionError(f"fused_filter_matches argmax at {(m, n, d)}")
        errs["fused_filter_matches"] = max(
            errs["fused_filter_matches"], max_err(kv0, pv0, mk0),
            max_err(kv1, pv1, mk1))
    for name, err in errs.items():
        check(f"{name} edge shapes", err)
    torch.cuda.synchronize()
    return errs


def feats(pairs, i):
    return {
        "keypoints": pairs[f"keypoints{i}"],
        "descriptors": pairs[f"descriptors{i}"],
        "image_size": pairs["image_size"],
    }


def precision(out, gt):
    """(number of matches, share of them that are planted pairs)."""
    m0 = out["matches0"]
    pred = m0 >= 0
    if not pred.any():
        return 0, 0.0
    return int(pred.sum()), float((m0[pred] == gt[pred]).mean())


def main_path_phase(params):
    phase("3 main path: pipeline.LightGlue, trained weights, 1024 keypoints")
    rng = np.random.default_rng(7)
    singles = [planted_pairs(rng, 1, 1024) for _ in range(3)]
    singles.append(planted_pairs(rng, 1, 900, 1024))  # unequal counts
    batch8 = planted_pairs(rng, 8, 1024)
    matchers = {
        "fixed": dict(depth_confidence=-1.0, width_confidence=-1.0),
        "adaptive": {},
    }
    gpu = {k: LightGlue("superpoint", params=params, device="cuda", **c)
           .compile((512, 768, 1024)) for k, c in matchers.items()}
    # an image without valid keypoints degrades to no matches, no NaN
    empty = {"image0": dict(feats(singles[0], 0), valid=np.zeros((1, 1024), bool)),
             "image1": feats(singles[0], 1)}
    for name, matcher in gpu.items():
        out = matcher(empty)
        if not ((out["matches0"] == -1).all() and (out["matches1"] == -1).all()
                and np.isfinite(out["matching_scores1"]).all()):
            raise AssertionError(f"{name}: an empty image 0 still matched")
    print("  image 0 without valid keypoints: no matches, finite scores")
    _build.reset_launch_counts()
    outs = {}
    for name, matcher in gpu.items():
        for i, pr in enumerate(singles):
            outs[name, i] = matcher({"image0": feats(pr, 0),
                                     "image1": feats(pr, 1)})
        outs[name, "b8"] = matcher({"image0": feats(batch8, 0),
                                    "image1": feats(batch8, 1)})
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    print(f"  launch counts: {counts}")
    for kname, c in counts.items():
        if c < 1:
            raise AssertionError(f"{kname} was not launched on the main path")

    for (name, i), out in outs.items():
        pr = batch8 if i == "b8" else singles[i]
        b, m = pr["gt_matches0"].shape
        n = pr["keypoints1"].shape[1]
        if out["matches0"].shape != (b, m) or out["matches1"].shape != (b, n):
            raise AssertionError(f"{name} {i}: bad output shapes")
        for f in ("matching_scores0", "matching_scores1"):
            if not np.isfinite(out[f]).all():
                raise AssertionError(f"{name} {i}: {f} not finite")
        k, prec = precision(out, pr["gt_matches0"])
        print(f"  {name} pair {i}: {m}x{n} kpts, stop {out['stop']}, "
              f"{k} matches, precision {prec:.3f} against the planted truth")
        if prec < 0.8:  # a floor that catches wrong matches, not a target
            raise AssertionError(f"{name} {i}: precision {prec}")

    for name, c in matchers.items():
        cpu = LightGlue("superpoint", params=params, device="cpu", **c)
        ref = cpu({"image0": feats(singles[0], 0), "image1": feats(singles[0], 1)})
        got = outs[name, 0]
        agree = float((ref["matches0"] == got["matches0"]).mean())
        print(f"  {name} pair 0 against the CPU port (plain versions): "
              f"matches0 agreement {agree:.6f}, stop {got['stop']} vs "
              f"{ref['stop']}, score diff "
              f"{np.abs(ref['matching_scores0'] - got['matching_scores0']).max():.2e}")
        if agree < 0.999 or ref["stop"] != got["stop"]:
            raise AssertionError(f"{name}: the card disagrees with the CPU port")
    return counts


def time_cuda(fn, iters=20, warmup=3):
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


def timing_phase(x, params):
    phase("4 timing (CUDA events; plain = the same function in plain PyTorch)")
    q, k, v = x["k1"]
    qk0, qk1, v0, v1, va0, va1 = x["k2"]
    xx, msg, p = x["k3"]
    d0, d1, z0, z1, mk0, mk1 = x["k4"]
    ls0, ls1 = torch.nn.functional.logsigmoid(z0), torch.nn.functional.logsigmoid(z1)
    pairs = {
        "flash_sdpa": (lambda: flash.flash_sdpa(q, k, v),
                       lambda: flash.flash_sdpa_plain(q, k, v)),
        "fused_cross_attention": (
            lambda: flash_cross.fused_cross_attention(qk0, qk1, v0, v1, va0, va1),
            lambda: flash_cross.fused_cross_attention_plain(qk0, qk1, v0, v1, va0, va1)),
        "fused_ffn_residual": (lambda: ffn.fused_ffn_residual(xx, msg, p),
                               lambda: ffn.fused_ffn_residual_plain(xx, msg, p)),
        "fused_filter_matches": (
            lambda: af._filter_reductions_kernel(d0, d1, ls0, ls1, mk0, mk1),
            lambda: af.filter_reductions_plain(d0, d1, ls0, ls1, mk0, mk1)),
    }
    times = {}
    for name, (kern, plain) in pairs.items():
        # plain, kernel, kernel, plain: report the mean of each pair
        a = time_cuda(plain)
        b = time_cuda(kern)
        c = time_cuda(kern)
        d = time_cuda(plain)
        times[name] = ((b + c) / 2, (a + d) / 2)
        print(f"  {name}: kernel {times[name][0]:.4f} ms, plain "
              f"{times[name][1]:.4f} ms (runs {b:.4f}/{c:.4f}, {a:.4f}/{d:.4f})",
              flush=True)

    # end to end: host clock per call (each call ends in a device-to-host
    # copy of its outputs), median over the calls after two warm-up calls
    rng = np.random.default_rng(11)
    for bsz, reps in ((1, 30), (16, 8)):
        pr = planted_pairs(rng, bsz, 1024)
        data = {"image0": feats(pr, 0), "image1": feats(pr, 1)}
        for name, c in (("fixed", dict(depth_confidence=-1.0,
                                       width_confidence=-1.0)),
                        ("adaptive", {})):
            matcher = LightGlue("superpoint", params=params, device="cuda", **c)
            for _ in range(2):
                matcher(data)
            ms = []
            for _ in range(reps):
                t0 = time.perf_counter()
                out = matcher(data)
                ms.append((time.perf_counter() - t0) * 1e3)
            q1, med, q3 = np.percentile(ms, [25, 50, 75])
            print(f"  end to end {name} B={bsz} 1024 kpts: "
                  f"{bsz * 1e3 / med:.1f} pairs/s (median {med:.2f} ms per "
                  f"call, quartiles {q1:.2f}-{q3:.2f}, {reps} calls, stop "
                  f"{out['stop']})", flush=True)
    return times


def main():
    smi = device_phase()
    build_phase()
    x = kernel_inputs()
    errs = kernel_phase(x)
    for name, err in edge_phase().items():
        errs[name] = max(errs[name], err)
    params = weights_lib.load_params(WEIGHTS)
    counts = main_path_phase(params)
    times = timing_phase(x, params)
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
