"""SuperPoint's block 2, conv2a + ReLU, conv2b + ReLU, 2x2 max-pool at half
resolution: kernel B8 and its plain version.

Counterpart of lightglue_tpu/ops/stem2.py::fused_block2_pallas
(``_block2_kernel``, stem2.py:46-192) and of the XLA conv chain it replaces
(lightglue_tpu/models/superpoint.py:120-124). NCHW here: (B, 64, H2, W2)
-> (B, 64, H2/2, W2/2), fed by the stem's output as it is. On a CUDA tensor
``fused_block2`` launches ``csrc/stem2.cu`` or raises; on a CPU tensor it
runs ``fused_block2_plain``.
"""

from __future__ import annotations

import torch

from .. import _build, nn
from .stem import check_conv, check_even_map, conv_weights


def fused_block2_plain(params: nn.Params, x: torch.Tensor) -> torch.Tensor:
    """conv -> bias -> ReLU, twice, then max-pool, cuDNN in fp32. params
    {"conv2a": {w (64, 64, 3, 3), b}, "conv2b": ...}."""
    with nn.fp32_convs():
        x = torch.relu(nn.conv2d(params["conv2a"], x))
        x = torch.relu(nn.conv2d(params["conv2b"], x))
    return nn.max_pool(x, 2)


def fused_block2(params: nn.Params, x: torch.Tensor) -> torch.Tensor:
    """B8 on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return fused_block2_plain(params, x)
    a, b = params["conv2a"], params["conv2b"]
    dev = _build.check_cuda(x=x, w2a=a["w"], b2a=a["b"], w2b=b["w"],
                            b2b=b["b"])
    check_even_map(x, 64, "x")
    check_conv(a, 64, "conv2a")
    check_conv(b, 64, "conv2b")
    n, _, h2, w2 = x.shape
    out = torch.empty(n, 64, h2 // 2, w2 // 2, device=dev)
    _build.launch("lg_fused_block2", dev, x, conv_weights(a["w"]), a["b"],
                  conv_weights(b["w"]), b["b"], out, n, h2, w2)
    _build.count("fused_block2")
    return out
