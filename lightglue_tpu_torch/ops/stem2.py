"""SuperPoint's block 2, conv2a + ReLU, conv2b + ReLU, 2x2 max-pool at half
resolution: kernel B8 and its plain version.

Counterpart of lightglue_tpu/ops/stem2.py::fused_block2_pallas
(``_block2_kernel``, stem2.py:46-192) and of the XLA conv chain it replaces
(lightglue_tpu/models/superpoint.py:120-124). NCHW here: (B, 64, H2, W2)
-> (B, 64, H2/2, W2/2), fed by the stem's output as it is. On a CUDA tensor
``fused_block2`` launches ``csrc/stem2.cu`` twice (conv2a + ReLU into a
scratch map, then conv2b + ReLU + pool) or raises; on a CPU tensor it runs
``fused_block2_plain``.
"""

from __future__ import annotations

import torch

from .. import _build, nn
from .flash import aligned16
from .stem import check_conv, check_even_map, prepared_conv


def fused_block2_plain(params: nn.Params, x: torch.Tensor) -> torch.Tensor:
    """conv -> bias -> ReLU, twice, then max-pool, cuDNN in fp32. params
    {"conv2a": {w (64, 64, 3, 3), b}, "conv2b": ...}."""
    with nn.fp32_convs():
        x = torch.relu(nn.conv2d(params["conv2a"], x))
        x = torch.relu(nn.conv2d(params["conv2b"], x))
    return nn.max_pool(x, 2)


def conv3x3_relu_plain(p: nn.Params, x: torch.Tensor) -> torch.Tensor:
    """relu(conv3x3(x) + b), cuDNN in fp32: B8's first launch."""
    with nn.fp32_convs():
        return torch.relu(nn.conv2d(p, x))


def _launch(p: nn.Params, x: torch.Tensor, pool: bool) -> torch.Tensor:
    n, _, h, w = x.shape
    out = torch.empty(n, 64, h // 2 if pool else h, w // 2 if pool else w,
                      device=x.device)
    _build.launch("lg_conv3x3", x.device, x, prepared_conv(p["w"]), p["b"],
                  out, n, h, w, int(pool))
    _build.count("fused_block2")
    return out


def _check(ps, x: torch.Tensor) -> torch.Tensor:
    """x as the kernel reads it: staged through an aligned copy when it
    does not start on a 16-byte boundary (the kernel copies its rows in
    16-byte pieces from there)."""
    _build.check_cuda(x=x, **{f"{i}{k}": p[k] for i, p in enumerate(ps)
                              for k in ("w", "b")})
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
