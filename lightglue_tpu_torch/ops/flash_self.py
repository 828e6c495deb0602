"""The whole SelfBlock in one op: kernel B5 and its plain version.

Counterpart of lightglue_tpu/ops/flash_self.py::fused_self_block
(``_kernel``, flash_self.py:84-302): for one SelfBlock (reference
lightglue.py:159-172)

    x + FFN(cat[x, out_proj(attention(rot(q), rot(k), v))]),

exact (``shift`` None: per-row maximum, an all-masked batch entry's context
is 0) or with the constant-shift exp2 softmax, at head_dim 64 or 128 (the
JAX kernel has no head_dim limit; the JAX matcher reaches it at both). On a
CUDA tensor ``fused_self_block`` runs its launches (the q, k, v projection
with rotary, ``block_tc.project``; K1's key walk of csrc/flash_sdpa.cu
through flash.launch_attention, with its key split; the out_proj + FFN
tail, ``block_tc.tail_chain``) or raises; on a CPU tensor it runs
``fused_self_block_plain``, the same steps' plain versions.

``prepare`` builds the kernel's weights once per parameter tree: the q, k
and v columns of the reference packing ``(head * hd + chan) * 3 + which``
regrouped head-major, the softmax scale (times log2(e) with a shift) folded
into Wq and bq, transposed so each output channel is a row. q and k keep
the natural interleaved rotary layout: scores do not change under a channel
permutation shared by q and k, so the TPU's deinterleaved layout, a lane
trick, is not needed.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from .. import _build, nn
from . import block_tc
from .flash import LOG2E, key_bias, launch_attention, mask_arg, shift_weights

MAX_FUSED_N = 2048  # the JAX package's limit; it decides which kernels run


@functools.lru_cache(maxsize=None)
def _qkv_columns(num_heads: int, head_dim: int) -> torch.Tensor:
    """Columns of the packed Wqkv output, ordered [q | k | v], each
    head-major with its channels in order."""
    d = num_heads * head_dim
    which = torch.arange(3)[:, None]
    chan = torch.arange(d)[None, :]  # head * hd + chan
    return (chan * 3 + which).reshape(-1)


def prepare(p: nn.Params, num_heads: int,
            shift: Optional[float] = None) -> dict:
    """Kernel weights from one layer's self_attn params {"Wqkv": {w (D, 3D),
    b}, "out_proj": {w (D, D), b}, "ffn": ...}: w_in (3D, D) and b_in (3D)
    with rows [q | k | v], q scaled; out_proj and the FFN K-major
    (block_tc.tail_weights)."""
    w, b = p["Wqkv"]["w"], p["Wqkv"]["b"]
    d = w.shape[0]
    cols = _qkv_columns(num_heads, d // num_heads).to(w.device)
    scale = (d // num_heads) ** -0.5 * (1.0 if shift is None else LOG2E)
    row_scale = torch.ones(3 * d, device=w.device)
    row_scale[:d] = scale
    return {
        "w_in": (w[:, cols] * row_scale).t().contiguous(),
        "b_in": (b[cols] * row_scale).contiguous(),
        **block_tc.tail_weights(p["out_proj"], p["ffn"]),
        "num_heads": num_heads,
        "shift": shift,
    }


def fused_self_block_plain(
    w: dict, x: torch.Tensor, enc: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """x (B, N, D); enc (2, B, 1, N, hd/2) rotary tables
    (rotary.fourier_posenc); key_mask (B, N) bool, True = valid."""
    q, k, v = block_tc.project_plain(w, [x], 3, enc)[0]
    s = q @ k.transpose(-1, -2)  # scale (and log2(e)) folded into q
    if key_mask is not None:
        s = s + key_bias(key_mask)[:, None, None, :]
    if w["shift"] is not None:
        e = shift_weights(s, w["shift"] * LOG2E)
    else:
        e = torch.exp(s - s.amax(-1, keepdim=True))
    ctx = (e @ v) / torch.clamp(e.sum(-1, keepdim=True), min=1e-30)
    if key_mask is not None and w["shift"] is None:
        ctx = torch.where(key_mask.any(-1)[:, None, None, None], ctx,
                          torch.zeros_like(ctx))
    return block_tc.tail_chain_plain(w, [ctx], [x])[0]


def fused_self_block(
    w: dict, x: torch.Tensor, enc: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """B5 on CUDA tensors, the plain version on CPU tensors. ``w`` from
    ``prepare``."""
    if x.device.type == "cpu":
        return fused_self_block_plain(w, x, enc, key_mask)
    b, n, d = x.shape
    dev = block_tc.check_block_weights(w, d)
    if _build.check_cuda(x=x) != dev or n < 1:
        raise ValueError(f"x {tuple(x.shape)} is on {x.device}, the weights "
                         f"on {dev}")
    qkv = block_tc.launch_project(dev, w, [x], 3, enc)[0]
    shift = w["shift"]
    ctx = torch.empty_like(qkv[0])
    # K1's key walk on the projected heads (the scale is in q already)
    launch_attention(dev, [(qkv[0], qkv[1], qkv[2],
                            mask_arg(key_mask, (b, n), dev), ctx)], 1.0,
                     None if shift is None else shift * LOG2E)
    out = block_tc.launch_tail(dev, w, [ctx], [x])[0]
    _build.count("fused_self_block")
    return out
