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

A bf16 image (mp) takes the bf16 form: y1 and x1p bf16, rounded where
``_aliked_stem_kernel`` rounds at mp (lightglue_tpu/ops/aliked_stem.py:
75-141), on a CUDA tensor ``csrc/aliked_wgmma.cuh`` (persistent blocks
walking strips as ``conv_plan`` cuts them, image rows by TMA through a
tensor map cached with the prepared weights); its plain version is fp32
convolutions of the rounded operands with the rounding at those points.
``composed_stem`` is the composition the kernel replaces, in the image's
type (XLA's at mp).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

from .. import _build, nn
from . import conv_plan
from .block_tc import sms
from .stem import split_tf32
from .tma_maps import Prepared16, padded, tensor_map

WIDTHS = ((8, 16), (16, 32))  # (C1, CY): aliked-t16, the other models
PER_SM = 3  # the bf16 form's persistent blocks an SM (csrc/aliked_wgmma.cuh)
_PREPARED = WeakIdKeyDictionary()


def conv_block(p: nn.Params, x: torch.Tensor) -> torch.Tensor:
    """The reference ConvBlock (aliked.py:351-383): conv3x3 + BN + SELU,
    twice, NCHW."""
    with nn.fp32_convs():
        x = nn.selu(nn.batch_norm(p["bn1"], nn.conv2d(p["conv1"], x)))
        return nn.selu(nn.batch_norm(p["bn2"], nn.conv2d(p["conv2"], x)))


def composed_stem(
    params: nn.Params, image: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """params {"block1": ConvBlock params, "conv1": {w (CY, C1, 1, 1)}};
    image (B, 3, H, W). Returns (y1 (B, H, W, CY), x1p (B, C1, H/2, W/2)),
    every op in the image's type (lightglue_tpu/models/aliked.py:409-411)."""
    x1 = conv_block(params["block1"], image)
    with nn.fp32_convs():
        y1 = nn.selu(nn.conv2d(params["conv1"], x1))
    return y1.permute(0, 2, 3, 1).contiguous(), nn.avg_pool(x1, 2)


def _folded_bf16(p: nn.Params):
    """A batch norm's folded scale and bias, rounded to bf16 (as fp32)."""
    return tuple(nn.round_bf16(v) for v in nn.fold_batch_norm(p))


def _stem_plain_mp(params: nn.Params, image: torch.Tensor):
    """B10's bf16 form in plain PyTorch: fp32 convolutions of bf16 operands,
    BN as round(round(round(sum) x s) + b) then SELU, conv1's output stored
    bf16, x1 fp32, the 1x1 on round(x1) rounded before its SELU, the pool
    (round(upper) + lower) / 2 then the column pair's mean."""
    r, conv = nn.round_bf16, torch.nn.functional.conv2d
    bp = params["block1"]
    bn = [_folded_bf16(bp[k]) for k in ("bn1", "bn2")]

    def bn_selu(acc, sb):
        s, b = (v[:, None, None] for v in sb)
        return nn.selu(r(r(r(acc) * s) + b))

    with nn.fp32_convs():
        a = r(bn_selu(conv(r(image.float()), r(bp["conv1"]["w"]), padding=1),
                      bn[0]))
        x1 = bn_selu(conv(a, r(bp["conv2"]["w"]), padding=1), bn[1])
        y1 = nn.selu(r(conv(r(x1), r(params["conv1"]["w"]))))
    p = (r(x1[:, :, 0::2]) + x1[:, :, 1::2]) * 0.5
    x1p = (p[..., 0::2] + p[..., 1::2]) * 0.5
    bf = torch.bfloat16
    return y1.permute(0, 2, 3, 1).contiguous().to(bf), x1p.to(bf)


def fused_aliked_stem_plain(
    params: nn.Params, image: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B10's plain version: ``composed_stem`` on an fp32 image, the bf16
    form's rounding on a bf16 one (outputs bf16)."""
    if image.dtype == torch.bfloat16:
        return _stem_plain_mp(params, image)
    return composed_stem(params, image)


def fused_aliked_stem(
    params: nn.Params, image: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B10 on CUDA tensors (its bf16 form for a bf16 image), the plain
    version on CPU tensors."""
    if image.device.type == "cpu":
        return fused_aliked_stem_plain(params, image)
    return fused_aliked_stem_kernel(params, image)


class Bf16Layout(NamedTuple):
    """Byte offsets of ``prepare_bf16``'s blob (``csrc/aliked_wgmma.cuh``'s
    ``Geo``): conv1, conv2, the 1x1, the BN vectors; its size."""
    w1: int
    w2: int
    wy: int
    bn: int
    size: int


def bf16_layout(c1: int) -> Bf16Layout:
    """The blob's layout at C1 ``c1`` (CY 2 C1): conv1 3 dx x 2 chunks x C1
    rows of 16 bytes, conv2 its k-steps (9 at C1 16, 6 at 8) likewise, the
    1x1 2 chunks x CY rows, then s1, b1, s2, b2 in 128 bytes."""
    steps = 9 if c1 == 16 else 6
    w2 = 3 * 2 * c1 * 16
    wy = w2 + steps * 2 * c1 * 16
    bn = wy + 2 * 2 * c1 * 16
    return Bf16Layout(0, w2, wy, bn, bn + 128)


def y1_channel(cy: int) -> torch.Tensor:
    """The output channel of each column n = 8 j + 2 t + e of the 1x1's
    product: (CY / 4) t + 2 j + e, so that lane t of an accumulator row
    holds CY / 4 consecutive channels of its pixel."""
    n = torch.arange(cy)
    return (cy // 4) * (n % 8 // 2) + 2 * (n // 8) + n % 2


def prepare_bf16(params: nn.Params) -> torch.Tensor:
    """The bf16 form's weights as ``csrc/aliked_wgmma.cuh`` copies them
    into shared memory, one bf16 blob laid out as ``bf16_layout(C1)``,
    every operand of a product K-major in 16-byte rows of 8 K values, the
    two 8-deep chunks of a k-step one plane apart:

    - conv1 [dx][chunk][co][8]: K is (ci, dy) as k = 3 ci + dy (9 values,
      zero-padded to 16), one k-step a tap column dx;
    - conv2 [step][chunk][co][8 ci]: at C1 16 step = tap (dy, dx), chunk
      the input channels 8 chunk ..; at C1 8 step 2 dy + s pairs taps (dy,
      2s) (chunk 0) and (dy, 2s + 1) (chunk 1; zero for s 1);
    - the 1x1 [chunk][n][8 ci]: row n holds output channel ``y1_channel``
      (n), its inputs zero past C1;
    - bn1's and bn2's folded scales and biases, s1, b1, s2, b2, rounded
      (bn1's scale is applied after conv1's sum is rounded, not folded)."""
    bp = params["block1"]
    c1 = bp["conv2"]["w"].shape[0]
    cy = params["conv1"]["w"].shape[0]
    w = bp["conv1"]["w"].float()  # [co][ci][dy][dx]
    w1 = w.new_zeros(3, c1, 16)
    w1[..., :9] = w.permute(3, 0, 1, 2).reshape(3, c1, 9)  # [dx][co][3 ci + dy]
    w1 = w1.reshape(3, c1, 2, 8).permute(0, 2, 1, 3)
    taps = bp["conv2"]["w"].float().permute(2, 3, 0, 1)  # [dy][dx][co][ci]
    if c1 == 16:
        w2 = taps.reshape(9, c1, 2, 8).permute(0, 2, 1, 3)
    else:  # dx padded to 4: [dy][s][chunk] = tap (dy, 2 s + chunk)
        w2 = torch.cat([taps, taps.new_zeros(3, 1, c1, c1)], 1).reshape(6, 2, c1, c1)
    wy = params["conv1"]["w"].float()[:, :, 0, 0]
    wy = torch.cat([wy, wy.new_zeros(cy, 16 - c1)], 1)[y1_channel(cy)]
    wy = wy.reshape(cy, 2, 8).permute(1, 0, 2)
    bn = torch.cat([*nn.fold_batch_norm(bp["bn1"]), *nn.fold_batch_norm(bp["bn2"])])
    blob = torch.cat([w1.reshape(-1), w2.reshape(-1), wy.reshape(-1), bn,
                      bn.new_zeros(64 - 4 * c1)])
    assert 2 * blob.numel() == bf16_layout(c1).size
    return blob.to(torch.bfloat16).contiguous()


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


def prepared(params: nn.Params, dtype: torch.dtype = torch.float32):
    """``prepare(params)`` (for the bf16 form ``Prepared16`` of
    ``prepare_bf16`` and its tensor maps), built once per parameter tree
    and type (keyed by its conv2 weight tensor, and rebuilt if any other
    tensor it reads is another object): an edit in place of a tensor is
    not seen, build a new tree."""
    bp = params["block1"]
    srcs = (bp["conv1"]["w"], *bp["bn1"].values(), *bp["bn2"].values(),
            params["conv1"]["w"])
    got = _PREPARED.get(bp["conv2"]["w"])
    if got is None or any(a is not b for a, b in zip(got[0], srcs)):
        got = _PREPARED[bp["conv2"]["w"]] = (srcs, {})
    if dtype not in got[1]:
        got[1][dtype] = (Prepared16(prepare_bf16(params), {})
                         if dtype == torch.bfloat16 else prepare(params))
    return got[1][dtype]


def fused_aliked_stem_kernel(
    params: nn.Params, image: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B10: one launch over CUDA tensors, H and W even; the bf16 form for a
    bf16 image (bf16 outputs; a width that is not a multiple of 8, or an
    image off a 16-byte boundary, goes through one zero-padded copy, since
    TMA reads rows of a multiple of 16 bytes)."""
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
    dt = image.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"image must be float32 or bfloat16, got {dt}")
    dev = _build.check_cuda(dtype=dt, image=image)
    if _build.check_cuda(**{name: p["w"].contiguous()
                            for name, (p, _) in convs.items()}) != dev:
        raise ValueError("the weights are on another device than the image")
    b, _, h, w = image.shape
    y1 = torch.empty(b, h, w, cy, device=dev, dtype=dt)
    x1p = torch.empty(b, c1, h // 2, w // 2, device=dev, dtype=dt)
    if dt == torch.bfloat16:
        prep = prepared(params, dt)
        image = padded(image)
        _build.launch("lg_aliked_stem_bf16", dev,
                      tensor_map(prep, "lg_aliked_stem_bf16_map", image),
                      prep.weights, y1, x1p, b, h, w, c1, cy,
                      conv_plan.plan(b, h, w, PER_SM * sms(dev.index)).grid)
    else:
        k1, w2, wyp = prepared(params, dt)
        _build.launch("lg_aliked_stem", dev, image, k1, w2, wyp, y1, x1p, b,
                      h, w, c1, cy)
    _build.count(_build.typed("fused_aliked_stem", dt))
    return y1, x1p
