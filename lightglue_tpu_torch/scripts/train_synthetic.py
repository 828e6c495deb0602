"""Train the matcher on synthetic correspondences and save a checkpoint
(counterpart of scripts/train_synthetic.py, with its flags).

    python lightglue_tpu_torch/scripts/train_synthetic.py --steps 2500 \\
        --batch 16 --m 512 [--devices N]

runs ``lightglue_tpu_torch.train.train_synthetic`` on the card (with
``--devices N``, data-parallel over a mesh of the first N cards,
``parallel/mesh.py``: each card's rows of the batch, the gradients summed
on card 0) and writes,
into ``train_out/`` unless ``--out`` says otherwise (never into
``weights/`` or ``benchmarks/``, which hold the JAX trainer's checkpoints
and curves):

- ``synthetic_<features>_lightglue.npz``: the flat float16 npz that
  ``weights.load_params`` reads;
- ``train_synthetic_history[_<features>].json``: the logged losses, the
  wall time, the median ms a step from step 20 on (CUDA events), the
  step's FLOPs (``step_flops``) and the card's name and power limit.

``serve_checkpoint.py`` serves the saved npz beside the committed one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from lightglue_tpu_torch import train as T  # noqa: E402
from lightglue_tpu_torch import weights as W  # noqa: E402
from lightglue_tpu_torch.configs import lightglue_config  # noqa: E402
from lightglue_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

OUT_DIR = ROOT / "train_out"


def step_flops(conf, batch: int, m: int) -> float:
    """FLOPs of one training step at ``batch`` pairs of ``m`` points: the
    products of the forward (input projection, per layer the self blocks'
    Wqkv, QK^T, PV, out_proj, FFN, the cross block's to_qk, to_v, QK^T, the
    two PV, to_out, FFN, and each layer's assignment head: final_proj and
    its similarity), three times (the backward takes two products for each
    forward one). Elementwise work (softmax, LayerNorm, GELU, rotary) is
    left out."""
    d, n, rows = conf.descriptor_dim, m, 2 * m
    proj = 2 * rows * conf.input_dim * d if conf.input_dim != d else 0
    ffn = 2 * (2 * d) * (2 * d) + 2 * (2 * d) * d  # lin1 + lin2, a row
    self_block = 2 * (2 * n * d * 3 * d + 2 * 2 * n * n * d + 2 * n * d * d
                      + n * ffn)
    cross_block = (3 * 2 * rows * d * d + 3 * 2 * m * n * d + rows * ffn)
    assign = 2 * rows * d * d + 2 * m * n * d
    return 3.0 * batch * (proj + conf.n_layers * (
        self_block + cross_block + assign))


def card() -> str:
    """The card's name and power limit (nvidia-smi), or "cpu"."""
    if not torch.cuda.is_available():
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def save(out: Path, params, train_conf, hist, **meta) -> Path:
    """Write ``params`` to ``out`` as the flat float16 npz that
    ``weights.load_params`` reads, and the history JSON beside it (its
    name as the JAX script's); returns the JSON's path."""
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out, **{k: v.astype(np.float16) for k, v in
                                W.flatten_params(params).items()})
    print("saved", out, f"({out.stat().st_size / 1e6:.1f} MB)")
    suffix = "" if meta["features"] == "superpoint" else f"_{meta['features']}"
    hist_path = out.parent / f"train_synthetic_history{suffix}.json"
    hist_path.write_text(json.dumps(
        {**meta, "n_layers": train_conf.n_layers, "history": hist}, indent=1))
    print("history ->", hist_path)
    return hist_path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--m", type=int, default=512)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--devices", type=int, default=1,
                    help="cards the batch shards over (a mesh of the "
                         "first N; the batch must divide over them)")
    ap.add_argument("--features", default="superpoint",
                    help="matcher feature preset (sets input_dim / "
                         "add_scale_ori; configs.FEATURES)")
    ap.add_argument("--out", default=None,
                    help=f"the npz (default: {OUT_DIR.name}/"
                         "synthetic_<features>_lightglue.npz)")
    args = ap.parse_args(argv)
    out = Path(args.out) if args.out else (
        OUT_DIR / f"synthetic_{args.features}_lightglue.npz")
    for kept in ("weights", "benchmarks"):
        if (ROOT / kept).resolve() in out.resolve().parents:
            raise SystemExit(f"{out}: {kept}/ holds the JAX trainer's files; "
                             "write elsewhere")

    conf = lightglue_config(args.features)
    mesh = make_mesh(args.devices) if args.devices > 1 else None
    who = card()
    print(f"device cuda ({who}), torch {torch.__version__}", flush=True)
    step_ms: list = []
    t0 = time.perf_counter()
    params, train_conf, hist = T.train_synthetic(
        conf, steps=args.steps, batch=args.batch, m=args.m, lr=args.lr,
        seed=args.seed, step_ms=step_ms, mesh=mesh)
    wall = time.perf_counter() - t0
    flops = step_flops(train_conf, args.batch, args.m)
    ms = statistics.median(step_ms[20:]) if len(step_ms) > 20 else None
    print(f"trained {args.steps} steps in {wall:.1f} s"
          + ("" if ms is None else
             f"; {ms:.3f} ms a step (median from step 20, CUDA events), "
             f"{flops / 1e12:.4f} TFLOP a step: {flops / ms / 1e9:.1f} TFLOP/s, "
             f"bound {flops / 67e12 * 1e3:.3f} ms at 67 TFLOP/s fp32"),
          flush=True)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    save(out, params, train_conf, hist, features=args.features,
         steps=args.steps, batch=args.batch, m=args.m, lr=args.lr,
         seed=args.seed, devices=args.devices, card=who, wall_s=wall, ms_per_step_median=ms,
         flops_per_step=flops)


if __name__ == "__main__":
    main()
