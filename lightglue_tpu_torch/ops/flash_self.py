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

Under ``mp`` (``prepare(..., mp=True)``, bf16 x) B5 runs its bf16 form, the
TPU kernel fed bf16 (flash_self.py:84-183, 222-240), rounding where it
rounds: Wq scaled, then rounded (:222); the rotary tables rounded (:234-235);
q, k and v rounded after bias and rotary (:106, :110, :121); fp32 scores,
softmax and row sums (:130); the weights rounded before P V (:132); the
context rounded before out_proj (:141); the message rounded once after the
heads' fp32 sum (:155); the LN + GELU hidden rounded before lin2 (:172); the
output rounded (:176). At head_dim 64 and 128 (two heads of 128: the
bf16 walk at d 128; out_proj sums both heads in fp32 and rounds once, as
the TPU kernel's per-head sum at :155).
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
            shift: Optional[float] = None, mp: bool = False) -> dict:
    """Kernel weights from one layer's self_attn params {"Wqkv": {w (D, 3D),
    b}, "out_proj": {w (D, D), b}, "ffn": ...}: w_in (3D, D) and b_in (3D)
    with rows [q | k | v], q scaled; out_proj and the FFN K-major
    (block_tc.tail_weights). ``mp``: the matrices rounded to bf16 after
    the scale is folded in, the biases fp32."""
    dt = torch.bfloat16 if mp else torch.float32
    w, b = p["Wqkv"]["w"], p["Wqkv"]["b"]
    d = w.shape[0]
    cols = _qkv_columns(num_heads, d // num_heads).to(w.device)
    scale = (d // num_heads) ** -0.5 * (1.0 if shift is None else LOG2E)
    row_scale = torch.ones(3 * d, device=w.device)
    row_scale[:d] = scale
    return {
        "w_in": (w[:, cols] * row_scale).t().to(dt).contiguous(),
        "b_in": (b[cols] * row_scale).contiguous(),
        **block_tc.tail_weights(p["out_proj"], p["ffn"], dt),
        "num_heads": num_heads,
        "shift": shift,
    }


def fused_self_block_plain(
    w: dict, x: torch.Tensor, enc: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """x (B, N, D); enc (2, B, 1, N, hd/2) rotary tables
    (rotary.fourier_posenc); key_mask (B, N) bool, True = valid. bf16 x
    (bf16 weights): the bf16 form, fp32 scores, softmax and sums, the
    weights rounded before P V, the context rounded before out_proj."""
    q, k, v = block_tc.project_plain(w, [x], 3, enc)[0]
    # scale (and log2(e)) folded into q
    s = q.float() @ k.float().transpose(-1, -2)
    if key_mask is not None:
        s = s + key_bias(key_mask)[:, None, None, :]
    if w["shift"] is not None:
        e = shift_weights(s, w["shift"] * LOG2E)
    else:
        e = torch.exp(s - s.amax(-1, keepdim=True))
    ctx = (e.to(x.dtype).float() @ v.float()) / torch.clamp(
        e.sum(-1, keepdim=True), min=1e-30)
    if key_mask is not None and w["shift"] is None:
        ctx = torch.where(key_mask.any(-1)[:, None, None, None], ctx,
                          torch.zeros_like(ctx))
    return block_tc.tail_chain_plain(w, [ctx.to(x.dtype)], [x])[0]


def fused_self_block(
    w: dict, x: torch.Tensor, enc: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """B5 on CUDA tensors (its bf16 form on bf16 weights and x), the plain
    version on CPU tensors. ``w`` from ``prepare``."""
    if x.device.type == "cpu":
        return fused_self_block_plain(w, x, enc, key_mask)
    b, n, d = x.shape
    dev = block_tc.check_block_weights(w, d)
    if _build.check_cuda(dtype=block_tc.wtype(w), x=x) != dev or n < 1:
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
    _build.count(_build.typed("fused_self_block", block_tc.wtype(w),
                              d // w["num_heads"]))
    return out
