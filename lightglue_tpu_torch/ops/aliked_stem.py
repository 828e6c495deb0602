"""ALIKED's block 1 and its two consumers: kernel B10 and its plain version.

Counterpart of lightglue_tpu/ops/aliked_stem.py::fused_aliked_stem
(``_aliked_stem_kernel``, aliked_stem.py:56-224) and of the composed ops it
replaces (lightglue_tpu/models/aliked.py:409-411: ``_conv_block``, ``conv1``
+ SELU, ``_avg_pool``). On a CUDA tensor ``fused_aliked_stem`` launches
``csrc/aliked_stem.cu`` or raises; on a CPU tensor it runs the plain version.

Layouts: the image (B, 3, H, W) and the pooled map x1p (B, C1, H/2, W/2)
are NCHW, x1p because block 2's cuDNN convs read it. The aggregation branch
y1 (B, H, W, CY) is channels-last: its readers take whole pixel rows of it,
the descriptor head's row gathers (``models.aliked._fm_rows_lazy``) and the
score head's 1x1 partial, a product over its channels.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import _build, nn
from .stem import conv_weights

WIDTHS = ((8, 16), (16, 32))  # (C1, CY): aliked-t16, the other models


def conv_block(p: nn.Params, x: torch.Tensor) -> torch.Tensor:
    """The reference ConvBlock (aliked.py:351-383): conv3x3 + BN + SELU,
    twice, NCHW."""
    with nn.fp32_convs():
        x = nn.selu(nn.batch_norm(p["bn1"], nn.conv2d(p["conv1"], x)))
        return nn.selu(nn.batch_norm(p["bn2"], nn.conv2d(p["conv2"], x)))


def fused_aliked_stem_plain(
    params: nn.Params, image: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """params {"block1": ConvBlock params, "conv1": {w (CY, C1, 1, 1)}};
    image (B, 3, H, W). Returns (y1 (B, H, W, CY), x1p (B, C1, H/2, W/2))."""
    x1 = conv_block(params["block1"], image)
    with nn.fp32_convs():
        y1 = nn.selu(nn.conv2d(params["conv1"], x1))
    return y1.permute(0, 2, 3, 1).contiguous(), nn.avg_pool(x1, 2)


def fused_aliked_stem(
    params: nn.Params, image: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B10 on CUDA tensors, the plain version on CPU tensors."""
    if image.device.type == "cpu":
        return fused_aliked_stem_plain(params, image)
    return fused_aliked_stem_kernel(params, image)


def fused_aliked_stem_kernel(
    params: nn.Params, image: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B10: one launch over CUDA tensors, H and W even."""
    bp, wy = params["block1"], params["conv1"]["w"]
    c1, cy = wy.shape[1], wy.shape[0]
    if (c1, cy) not in WIDTHS:
        raise ValueError(f"B10 takes (C1, CY) in {WIDTHS}, got {(c1, cy)}")
    convs = {"block1.conv1": (bp["conv1"], (c1, 3, 3, 3)),
             "block1.conv2": (bp["conv2"], (c1, c1, 3, 3)),
             "conv1": (params["conv1"], (cy, c1, 1, 1))}
    for name, (p, shape) in convs.items():
        if tuple(p["w"].shape) != shape or "b" in p:
            raise ValueError(f"{name}: weight {shape} without bias expected, "
                             f"got {tuple(p['w'].shape)}")
    if image.dim() != 4 or image.shape[1] != 3 or image.shape[0] < 1 \
            or image.shape[2] < 2 or image.shape[3] < 2 \
            or image.shape[2] % 2 or image.shape[3] % 2:
        raise ValueError(f"image must be (B >= 1, 3, H, W), H and W even, "
                         f"got {tuple(image.shape)}")
    bn = torch.stack([*nn.fold_batch_norm(bp["bn1"]),
                      *nn.fold_batch_norm(bp["bn2"])])
    w1 = bp["conv1"]["w"].reshape(c1, 27).t().contiguous()
    w2 = conv_weights(bp["conv2"]["w"])
    wyt = wy[:, :, 0, 0].t().contiguous()
    dev = _build.check_cuda(image=image, w1=w1, bn=bn, w2=w2, wy=wyt)
    b, _, h, w = image.shape
    y1 = torch.empty(b, h, w, cy, device=dev)
    x1p = torch.empty(b, c1, h // 2, w // 2, device=dev)
    _build.launch("lg_aliked_stem", dev, image, w1, bn, w2, wyt, y1, x1p,
                  b, h, w, c1, cy)
    _build.count("fused_aliked_stem")
    return y1, x1p
