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
from torch.utils.weak import WeakIdKeyDictionary

from .. import _build, nn
from .stem import split_tf32

WIDTHS = ((8, 16), (16, 32))  # (C1, CY): aliked-t16, the other models
_PREPARED = WeakIdKeyDictionary()


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


def prepare(params: nn.Params) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """B10's weights, as ``csrc/aliked_stem.cu`` reads them:

    - ``k1``: conv1's weights times bn1's folded scale, [ci dy dx][co]
      (27 C1), then bn1's folded bias and bn2's folded scale and bias (C1
      each);
    - ``w2``: conv2 (C1 -> C1, 3x3) as each lane's B fragments, (9, KC, KC,
      32, 4) with KC = C1 / 8: per tap (dy, dx), 8-deep input chunk kc and
      n8 tile nt, lane (g, t)'s {big ci t, big ci t + 4, small ci t, small
      ci t + 4} of output channel 8 nt + g (ci counted from 8 kc), split by
      ``stem.split_tf32``;
    - ``wy``: the 1x1 branch (C1 -> CY) likewise, (KC, CY / 8, 32, 4), with
      its K rows permuted: in chunk kk column t is channel 8 kk + 2t and
      column t + 4 channel 8 kk + 2t + 1, the order in which conv2's
      accumulators hold them."""
    bp = params["block1"]
    c1 = bp["conv2"]["w"].shape[0]
    cy = params["conv1"]["w"].shape[0]
    kc, nty = c1 // 8, cy // 8
    s1, b1 = nn.fold_batch_norm(bp["bn1"])
    s2, b2 = nn.fold_batch_norm(bp["bn2"])
    w1 = bp["conv1"]["w"].float().permute(1, 2, 3, 0).reshape(27, c1) * s1
    k1 = torch.cat([w1.reshape(-1), b1, s2, b2]).contiguous()
    # conv2: [tap][co = 8 nt + g][ci = 8 kc + 4 h + t]
    w = bp["conv2"]["w"].float().permute(2, 3, 0, 1).reshape(9, kc, 8, kc, 2, 4)
    big, small = split_tf32(w.contiguous())
    parts = torch.stack([big, small], 4)  # (tap, nt, g, kc, bs, h, t)
    w2 = parts.permute(0, 3, 1, 2, 6, 4, 5).reshape(9, kc, kc, 32, 4)
    # 1x1: [co = 8 n + g][ci = 8 kk + 2t + e]
    wy = params["conv1"]["w"].float()[:, :, 0, 0].reshape(nty, 8, kc, 4, 2)
    big, small = split_tf32(wy.contiguous())
    parts = torch.stack([big, small], 4)  # (n, g, kk, t, bs, e)
    wy = parts.permute(2, 0, 1, 3, 4, 5).reshape(kc, nty, 32, 4)
    return k1, w2.contiguous(), wy.contiguous()


def prepared(params: nn.Params):
    """``prepare(params)``, built once per parameter tree (keyed by its
    conv2 weight tensor, and rebuilt if any other tensor it reads is
    another object): an edit in place of a tensor is not seen, build a new
    tree."""
    bp = params["block1"]
    srcs = (bp["conv1"]["w"], *bp["bn1"].values(), *bp["bn2"].values(),
            params["conv1"]["w"])
    got = _PREPARED.get(bp["conv2"]["w"])
    if got is None or any(a is not b for a, b in zip(got[0], srcs)):
        got = _PREPARED[bp["conv2"]["w"]] = (srcs, prepare(params))
    return got[1]


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
    dev = _build.check_cuda(image=image, **{
        name: p["w"].contiguous() for name, (p, _) in convs.items()})
    k1, w2, wyp = prepared(params)
    b, _, h, w = image.shape
    y1 = torch.empty(b, h, w, cy, device=dev)
    x1p = torch.empty(b, c1, h // 2, w // 2, device=dev)
    _build.launch("lg_aliked_stem", dev, image, k1, w2, wyp, y1, x1p,
                  b, h, w, c1, cy)
    _build.count("fused_aliked_stem")
    return y1, x1p
