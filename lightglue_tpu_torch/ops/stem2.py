"""SuperPoint's block 2, conv2a + ReLU, conv2b + ReLU, 2x2 max-pool at half
resolution: kernel B8 and its plain version.

Counterpart of lightglue_tpu/ops/stem2.py::fused_block2_pallas
(``_block2_kernel``, stem2.py:46-192) and of the XLA conv chain it replaces
(lightglue_tpu/models/superpoint.py:120-124). NCHW here: (B, 64, H2, W2)
-> (B, 64, H2/2, W2/2), fed by the stem's output as it is. On a CUDA tensor
``fused_block2`` launches ``csrc/stem2.cu`` twice (conv2a + ReLU into a
scratch map, then conv2b + ReLU + pool) or raises; on a CPU tensor it runs
``fused_block2_plain``. A bf16 input (B7's bf16 form, mp) takes the bf16
form: a bf16 scratch and output, each fp32 sum rounded to bf16 before its
bias, as ``_block2_kernel`` at mp (lightglue_tpu/ops/stem2.py:94-120).
"""

from __future__ import annotations

import torch

from .. import _build, nn
from .flash import aligned16
from .stem import check_conv, check_even_map, conv_relu_mp, prepared_conv


def fused_block2_plain(params: nn.Params, x: torch.Tensor) -> torch.Tensor:
    """conv -> bias -> ReLU, twice, then max-pool, cuDNN in fp32. params
    {"conv2a": {w (64, 64, 3, 3), b}, "conv2b": ...}. A bf16 x: fp32
    convolutions of the bf16 operands, each sum rounded before its bias,
    the scratch map and the output bf16."""
    if x.dtype == torch.bfloat16:
        a = conv3x3_relu_plain(params["conv2a"], x)
        x = conv_relu_mp(params["conv2b"], a.float())
        return nn.max_pool(x, 2).to(torch.bfloat16)
    with nn.fp32_convs():
        x = torch.relu(nn.conv2d(params["conv2a"], x))
        x = torch.relu(nn.conv2d(params["conv2b"], x))
    return nn.max_pool(x, 2)


def conv3x3_relu_plain(p: nn.Params, x: torch.Tensor) -> torch.Tensor:
    """relu(conv3x3(x) + b), cuDNN in fp32: B8's first launch (in bf16
    for a bf16 x, its sum rounded before the bias)."""
    if x.dtype == torch.bfloat16:
        return conv_relu_mp(p, x.float()).to(torch.bfloat16)
    with nn.fp32_convs():
        return torch.relu(nn.conv2d(p, x))


def _launch(p: nn.Params, x: torch.Tensor, pool: bool) -> torch.Tensor:
    n, _, h, w = x.shape
    out = torch.empty(n, 64, h // 2 if pool else h, w // 2 if pool else w,
                      device=x.device, dtype=x.dtype)
    _build.launch(_build.typed("lg_conv3x3", x.dtype), x.device, x,
                  prepared_conv(p["w"], x.dtype), p["b"], out, n, h, w,
                  int(pool))
    _build.count(_build.typed("fused_block2", x.dtype))
    return out


def _check(ps, x: torch.Tensor) -> torch.Tensor:
    """x as the kernel reads it: staged through an aligned copy when it
    does not start on a 16-byte boundary (the kernel reads its rows in
    16-byte pieces from there: 4 fp32 or 8 bf16 elements). x is fp32 or
    bf16, the weights and biases fp32."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    dev = _build.check_cuda(dtype=x.dtype, x=x)
    if _build.check_cuda(**{f"{i}{k}": p[k] for i, p in enumerate(ps)
                            for k in ("w", "b")}) != dev:
        raise ValueError("the weights are on another device than x")
    check_even_map(x, 64, "x")
    for i, p in enumerate(ps):
        check_conv(p, 64, f"conv {i}")
    return aligned16(x)


def conv3x3_relu(p: nn.Params, x: torch.Tensor) -> torch.Tensor:
    """B8's first launch alone on CUDA tensors (conv2a: relu(conv3x3(x) +
    b) at full resolution), the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return conv3x3_relu_plain(p, x)
    return _launch(p, _check([p], x), False)


def fused_block2(params: nn.Params, x: torch.Tensor) -> torch.Tensor:
    """B8 on CUDA tensors (two launches, each counted), the plain version
    on CPU tensors."""
    if x.device.type == "cpu":
        return fused_block2_plain(params, x)
    a, b = params["conv2a"], params["conv2b"]
    return _launch(b, _launch(a, _check([a, b], x), False), True)
