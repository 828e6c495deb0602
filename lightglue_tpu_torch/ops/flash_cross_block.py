"""The whole CrossBlock for both images: kernel B6 and its plain version.

Counterpart of lightglue_tpu/ops/flash_cross_block.py::fused_cross_block
(``_kernel``, flash_cross_block.py:94-293): the reference CrossBlock
(lightglue.py:201-230) for both images,

    qk = to_qk(x), v = to_v(x), one score matrix softmaxed both ways,
    x + FFN(cat[x, to_out(message)])   for x0 and for x1,

with sqrt(scale [* log2(e)]) folded into the shared to_qk on each side.
Exact (``shift`` None): the row softmax is exact, the column weights are
e * exp(m_row - max m_row) on valid rows of image 0, and a direction's
messages are 0 where the other image has no valid point. Shift: one
exp2(min(s + bias0 + bias1 - shift * log2(e), 100)) serves both
directions, with no guards. On a CUDA tensor ``fused_cross_block`` runs
its launches (``block_tc.project``: the [qk | v] projection, one launch
over the rows of both images; the row and column walks of
csrc/flash_cross.cu, ``flash_cross.launch_cross`` in mode EXACT_BLOCK or
SHIFT; ``block_tc.tail_chain``: the to_out + FFN tail, each
of its launches over the rows of both images) or raises; on a CPU tensor
it runs ``fused_cross_block_plain``, the same steps' plain versions.

Under ``mp`` (``prepare(..., mp=True)``, bf16 x0 and x1) B6 runs its bf16
form, the TPU kernel fed bf16 (flash_cross_block.py:94-183), rounding
where it rounds: the scaled to_qk rounded to bf16; qk0, qk1 and v rounded
after the bias (:112-113, :115-116); e, and e_c from the rounded e, rounded
before each P V, the sums adding them (:124, :131, :135); m0 and m1
rounded before to_out (:147, :159); the message (:176-179), the FFN's
hidden (:67) and the output rounded.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _build, nn
from . import block_tc
from .flash import LOG2E, shift_weights
from .flash_cross import EXACT_BLOCK, SHIFT, _biases, launch_cross

MAX_FUSED_N = 1024  # the JAX package's limit; it decides which kernels run


def prepare(p: nn.Params, num_heads: int,
            shift: Optional[float] = None, mp: bool = False) -> dict:
    """Kernel weights from one layer's cross_attn params {"to_qk", "to_v",
    "to_out": {w (D, D), b}, "ffn": ...}: w_in (2D, D) and b_in (2D) with
    rows [qk | v], qk scaled by sqrt(scale [* log2(e)]); to_out and the FFN
    K-major (block_tc.tail_weights). ``mp``: the matrices rounded to bf16
    after the scale is folded in, the biases fp32."""
    dt = torch.bfloat16 if mp else torch.float32
    d = p["to_qk"]["w"].shape[0]
    root = ((d // num_heads) ** -0.5
            * (1.0 if shift is None else LOG2E)) ** 0.5
    return {
        "w_in": torch.cat([p["to_qk"]["w"] * root, p["to_v"]["w"]],
                          1).t().to(dt).contiguous(),
        "b_in": torch.cat([p["to_qk"]["b"] * root, p["to_v"]["b"]]),
        **block_tc.tail_weights(p["to_out"], p["ffn"], dt),
        "num_heads": num_heads,
        "shift": shift,
    }


def cross_block_attention_plain(
    qk0: torch.Tensor, qk1: torch.Tensor, v0: torch.Tensor, v1: torch.Tensor,
    mask0: Optional[torch.Tensor] = None,
    mask1: Optional[torch.Tensor] = None,
    shift: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B6's attention: (m0, m1) from qk0, v0 (B, H, M, hd) and qk1, v1 (B,
    H, N, hd), the scale already folded into qk0 and qk1; mask0 (B, M),
    mask1 (B, N) bool. bf16 inputs: fp32 scores and softmax, e and e_c
    (from the rounded e) rounded before P V and summed rounded, bf16
    messages."""
    dt = qk0.dtype
    b, _, m, _ = qk0.shape
    n = qk1.shape[2]
    bias0, bias1 = _biases(mask0, mask1, b, m, n, qk0.device)
    s = qk0.float() @ qk1.float().transpose(-1, -2)
    if bias0 is not None:
        s = s + bias0[:, None, :, None] + bias1[:, None, None, :]
    if shift is not None:
        e = ec = shift_weights(s, shift * LOG2E).to(dt).float()
    else:
        m_row = s.amax(-1, keepdim=True)
        e = torch.exp(s - m_row).to(dt).float()
        f = torch.exp(m_row - m_row.amax(-2, keepdim=True))
        if bias0 is not None:
            f = f * (bias0 >= 0).float()[:, None, :, None]
        ec = (e * f).to(dt).float()
    m0 = (e @ v1.float()) / torch.clamp(e.sum(-1, keepdim=True), min=1e-30)
    m1 = (ec.transpose(-1, -2) @ v0.float()) / torch.clamp(
        ec.sum(-2)[..., None], min=1e-30)
    if bias0 is not None and shift is None:
        zero = lambda t, bias: torch.where(  # noqa: E731
            (bias >= 0).any(-1)[:, None, None, None], t, torch.zeros_like(t))
        m0, m1 = zero(m0, bias1), zero(m1, bias0)
    return m0.to(dt), m1.to(dt)


def fused_cross_block_plain(
    w: dict, x0: torch.Tensor, x1: torch.Tensor,
    mask0: Optional[torch.Tensor] = None,
    mask1: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x0 (B, M, D), x1 (B, N, D); mask0 (B, M), mask1 (B, N) bool."""
    (qk0, v0), (qk1, v1) = block_tc.project_plain(w, [x0, x1], 2)
    m0, m1 = cross_block_attention_plain(qk0, qk1, v0, v1, mask0, mask1,
                                         w["shift"])
    out0, out1 = block_tc.tail_chain_plain(w, [m0, m1], [x0, x1])
    return out0, out1


def fused_cross_block(
    w: dict, x0: torch.Tensor, x1: torch.Tensor,
    mask0: Optional[torch.Tensor] = None,
    mask1: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B6 on CUDA tensors (its bf16 form on bf16 weights and inputs), the
    plain version on CPU tensors. ``w`` from ``prepare``."""
    if x0.device.type == "cpu":
        return fused_cross_block_plain(w, x0, x1, mask0, mask1)
    b, m, d = x0.shape
    n = x1.shape[1]
    dev = block_tc.check_block_weights(w, d)
    if _build.check_cuda(dtype=block_tc.wtype(w), x0=x0, x1=x1) != dev:
        raise ValueError(f"x0 is on {x0.device}, the weights on {dev}")
    if x1.shape != (b, n, d) or m < 1 or n < 1:
        raise ValueError(f"x0 {tuple(x0.shape)} and x1 {tuple(x1.shape)} "
                         "must be (B, M, D) and (B, N, D)")
    p0, p1 = block_tc.launch_project(dev, w, [x0, x1], 2, None)
    shift = w["shift"]
    if shift is None:
        m0, m1 = launch_cross(p0[0], p1[0], p0[1], p1[1], mask0, mask1,
                              EXACT_BLOCK, 1.0)
    else:
        m0, m1 = launch_cross(p0[0], p1[0], p0[1], p1[1], mask0, mask1,
                              SHIFT, 1.0, shift * LOG2E)
    out0, out1 = block_tc.launch_tail(dev, w, [m0, m1], [x0, x1])
    _build.count(_build.typed("fused_cross_block", block_tc.wtype(w)))
    return out0, out1
