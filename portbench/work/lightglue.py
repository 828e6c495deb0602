"""The work a LightGlue forward needs, counted from shapes.

The products of ``lightglue_tpu_torch/scripts/train_synthetic.py::
step_flops`` (lines 48-63), its forward part only and with the two images'
point counts apart: per layer the self blocks' Wqkv, QK^T, PV, out_proj
and FFN, the cross block's to_qk, to_v, QK^T, the two PV, to_out and FFN;
the token confidence and the pruning's matchability of a layer that tests
them; the last layer's assignment head (final_proj and its similarity).
A layer is counted over the points active when it runs (pruned and padded
points need no work), as the published loop computes them. Elementwise
work (softmax, LayerNorm, GELU, rotary) is left out: a lower bound.

Bytes: each input read once and each output written once (keypoints,
descriptors, matches and scores in fp32 / int32) and the weights of every
layer run read once a batch.
"""

from __future__ import annotations

from typing import Dict, Sequence


def flops(conf: Dict, active: Sequence[Sequence[int]]) -> float:
    """FLOPs of one pair whose layers ran over ``active`` [(n0, n1), ...]
    points (one entry a layer run)."""
    d = conf["descriptor_dim"]
    ffn = 2 * (2 * d) * (2 * d) + 2 * (2 * d) * d  # lin1 + lin2, a row
    total = 0.0
    if conf["input_dim"] != d:
        n0, n1 = active[0]
        total += 2.0 * (n0 + n1) * conf["input_dim"] * d
    layers = len(active)
    for i, (n0, n1) in enumerate(active):
        n0, n1 = float(n0), float(n1)
        rows = n0 + n1
        for n in (n0, n1):  # self blocks
            total += (2 * n * d * 3 * d + 2 * 2 * n * n * d + 2 * n * d * d
                      + n * ffn)
        total += 3 * 2 * rows * d * d + 3 * 2 * n0 * n1 * d + rows * ffn
        if i + 1 < conf["n_layers"] and conf["depth_confidence"] > 0:
            total += 2 * d * rows  # token confidence (the stop test)
        if i + 1 < layers and conf["width_confidence"] > 0:
            total += 2 * d * rows  # matchability (pruning)
    n0, n1 = (float(v) for v in active[-1])
    total += 2 * (n0 + n1) * d * d + 2 * n0 * n1 * d
    return total


def io_bytes(conf: Dict, n0: int, n1: int) -> float:
    """One pair's inputs in (keypoints, descriptors, sizes) and outputs
    out (matches0/1 int32, scores0/1), fp32."""
    rows = n0 + n1
    return 4.0 * (rows * (2 + conf["input_dim"]) + 4 + 2 * rows)


def weight_bytes(conf: Dict, layers: int) -> float:
    """The fp32 weights of ``layers`` layers and one assignment head, read
    once a batch."""
    d = conf["descriptor_dim"]
    block = (d * 3 * d + 3 * d + d * d + d  # Wqkv, out_proj
             + 3 * (d * d + d)  # to_qk, to_v, to_out
             + 2 * (2 * d * 2 * d + 2 * d + 2 * 2 * d + 2 * d * d + d))
    head = d * d + d + d + 1
    return 4.0 * (layers * (block + d + 1) + head)
