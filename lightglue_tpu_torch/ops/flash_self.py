"""The whole SelfBlock in one op: kernel B5 and its plain version.

Counterpart of lightglue_tpu/ops/flash_self.py::fused_self_block
(``_kernel``, flash_self.py:84-302): for one SelfBlock (reference
lightglue.py:159-172)

    x + FFN(cat[x, out_proj(attention(rot(q), rot(k), v))]),

exact (``shift`` None: per-row maximum, an all-masked batch entry's context
is 0) or with the constant-shift exp2 softmax, at head_dim 64 or 128 (the
JAX kernel has no head_dim limit; the JAX matcher reaches it at both). On a
CUDA tensor ``fused_self_block`` runs its launches (csrc/blocks.cu: the q,
k, v projection with rotary, then K1's key walk of csrc/flash_sdpa.cu
through flash.launch_attention, with its key split, then the out_proj +
FFN tail) or raises; on a CPU tensor it runs ``fused_self_block_plain``.

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
from . import ffn as ffn_ops
from . import rotary
from .flash import (HEAD_DIMS, LOG2E, key_bias, launch_attention, mask_arg,
                    shift_weights)

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
    with rows [q | k | v], q scaled; out_proj and the FFN as they are."""
    w, b = p["Wqkv"]["w"], p["Wqkv"]["b"]
    d = w.shape[0]
    cols = _qkv_columns(num_heads, d // num_heads).to(w.device)
    scale = (d // num_heads) ** -0.5 * (1.0 if shift is None else LOG2E)
    row_scale = torch.ones(3 * d, device=w.device)
    row_scale[:d] = scale
    return {
        "w_in": (w[:, cols] * row_scale).t().contiguous(),
        "b_in": (b[cols] * row_scale).contiguous(),
        "wo": p["out_proj"]["w"].contiguous(),
        "bo": p["out_proj"]["b"].contiguous(),
        "ffn": p["ffn"],
        "num_heads": num_heads,
        "shift": shift,
    }


def project_heads(w: dict, x: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, N, D) -> (groups, B, H, N, D/H): x w_in^T + b_in split into
    groups of heads (the plain version of the projection launch)."""
    b, n, d = x.shape
    h = w["num_heads"]
    y = x @ w["w_in"].t() + w["b_in"]
    return y.reshape(b, n, groups, h, d // h).permute(2, 0, 3, 1, 4)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(B, H, N, hd) -> (B, N, H * hd)."""
    b, h, n, hd = t.shape
    return t.transpose(1, 2).reshape(b, n, h * hd)


def fused_self_block_plain(
    w: dict, x: torch.Tensor, enc: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """x (B, N, D); enc (2, B, 1, N, hd/2) rotary tables
    (rotary.fourier_posenc); key_mask (B, N) bool, True = valid."""
    q, k, v = project_heads(w, x, 3)
    q = rotary.apply_rotary(enc, q)
    k = rotary.apply_rotary(enc, k)
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
    msg = merge_heads(ctx) @ w["wo"] + w["bo"]
    return ffn_ops.fused_ffn_residual_plain(x, msg, w["ffn"])


def ffn_weights(p: nn.Params) -> tuple:
    """The FFN tensors in the order the block kernels take them."""
    return (p["lin1"]["w"], p["lin1"]["b"], p["ln"]["scale"], p["ln"]["bias"],
            p["lin2"]["w"], p["lin2"]["b"])


def check_block_weights(w: dict, d: int) -> torch.device:
    """Raise unless the block weights fit width ``d`` (head_dim in
    HEAD_DIMS) and lie on one CUDA device as contiguous float32; return the
    device."""
    h = w["num_heads"]
    if d not in ffn_ops.DIMS or d % h or d // h not in HEAD_DIMS:
        raise ValueError(f"the block kernels take D in {ffn_ops.DIMS} with "
                         f"head_dim in {HEAD_DIMS}, got D {d}, {h} heads")
    names = ("w1", "b1", "gamma", "beta", "w2", "b2")
    tensors = dict(w_in=w["w_in"], b_in=w["b_in"], wo=w["wo"], bo=w["bo"],
                   **dict(zip(names, ffn_weights(w["ffn"]))))
    want = dict(wo=(d, d), bo=(d,), w1=(2 * d, 2 * d), b1=(2 * d,),
                gamma=(2 * d,), beta=(2 * d,), w2=(2 * d, d), b2=(d,))
    for k, shape in want.items():
        if tuple(tensors[k].shape) != shape:
            raise ValueError(f"{k} must be {shape}, got "
                             f"{tuple(tensors[k].shape)}")
    if w["w_in"].shape[1:] != (d,) or w["b_in"].shape != w["w_in"].shape[:1]:
        raise ValueError(f"w_in/b_in do not fit D {d}")
    return _build.check_cuda(**tensors)


def launch_tail(w: dict, ctx: torch.Tensor, x: torch.Tensor, dev
                ) -> torch.Tensor:
    """The tail launch: x + FFN(cat[x, merge_heads(ctx) wo + bo]) from the
    per-head context ctx (B, H, N, hd)."""
    b, n, _ = x.shape
    out = torch.empty_like(x)
    _build.launch("lg_block_tail", dev, ctx, x, w["wo"], w["bo"],
                  *ffn_weights(w["ffn"]), out, b, w["num_heads"],
                  ctx.shape[-1], n)
    return out


def launch_project(w: dict, x: torch.Tensor, groups: int, dev,
                   cos=None, sin=None) -> torch.Tensor:
    """The projection launch: (groups, B, H, N, hd), rotary on the first
    two groups when ``cos``/``sin`` (B, N, hd/2) are given."""
    b, n, d = x.shape
    h = w["num_heads"]
    if w["w_in"].shape[0] != groups * d:
        raise ValueError(f"w_in must have {groups * d} rows")
    out = torch.empty(groups, b, h, n, d // h, device=dev)
    _build.launch("lg_project_heads", dev, x, w["w_in"], w["b_in"], cos, sin,
                  out, b, n, groups, h, d // h, 0 if cos is None else 2)
    return out


def fused_self_block(
    w: dict, x: torch.Tensor, enc: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """B5 on CUDA tensors, the plain version on CPU tensors. ``w`` from
    ``prepare``."""
    if x.device.type == "cpu":
        return fused_self_block_plain(w, x, enc, key_mask)
    b, n, d = x.shape
    cos = enc[0][:, 0].contiguous()
    sin = enc[1][:, 0].contiguous()
    dev = check_block_weights(w, d)
    hd = d // w["num_heads"]
    if _build.check_cuda(x=x, cos=cos, sin=sin) != dev:
        raise ValueError(f"x is on {x.device}, the weights on {dev}")
    if cos.shape != (b, n, hd // 2) or n < 1:
        raise ValueError(f"enc {tuple(enc.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    qkv = launch_project(w, x, 3, dev, cos, sin)
    shift = w["shift"]
    ctx = torch.empty_like(qkv[0])
    # K1's key walk on the projected heads (the scale is in q already)
    launch_attention(dev, [(qkv[0], qkv[1], qkv[2],
                            mask_arg(key_mask, (b, n), dev), ctx)], 1.0,
                     None if shift is None else shift * LOG2E)
    out = launch_tail(w, ctx, x, dev)
    _build.count("fused_self_block")
    return out
