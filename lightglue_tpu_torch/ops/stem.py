"""SuperPoint's stem, conv1a + ReLU, conv1b + ReLU, 2x2 max-pool: kernel B7
and its plain version.

Counterpart of lightglue_tpu/ops/stem.py::fused_stem_pallas
(``_stem_kernel``, stem.py:77-236) and of the XLA conv chain it replaces
(lightglue_tpu/models/superpoint.py:111-124). NCHW here: (B, 1, H, W) ->
(B, 64, H/2, W/2). On a CUDA tensor ``fused_stem`` launches ``csrc/stem.cu``
or raises; on a CPU tensor it runs ``fused_stem_plain``.

The 64 -> 64 convolutions of B7 and B8 (``csrc/conv_tc.cuh`` in fp32,
``csrc/conv_wgmma.cuh`` in bf16) read their weights as ``prepare_conv`` lays
them out, built once per weight tensor and type (``prepared_conv``).

``mp=True`` is the bf16 form (the TPU kernel at mp): the fp32 image in, a
bf16 map out, rounded where ``_stem_kernel`` rounds (lightglue_tpu/ops/
stem.py:99-158); ``fused_stem_plain(..., mp=True)`` is fp32 convolutions on
the rounded operands with the rounding at those points. On a CUDA tensor the
bf16 form's map is NHWC in memory (``torch.channels_last``: the same shape
and values), as block 2's bf16 form reads it.
"""

from __future__ import annotations

import torch
from torch.utils.weak import WeakIdKeyDictionary

from .. import _build, nn
from . import conv_plan
from .block_tc import sms

_LOW13 = -0x2000  # int32 0xffffe000: the bits a tensor core reads of a tf32
_PREPARED = WeakIdKeyDictionary()


def conv_relu_mp(p: nn.Params, x: torch.Tensor) -> torch.Tensor:
    """relu(round(conv3x3(x, round(w))) + b) in fp32 on fp32 x: a conv of
    the bf16 TPU kernels at mp, its fp32 sum rounded to bf16 before the
    fp32 bias (lightglue_tpu/ops/stem.py:122, :146; stem2.py:94, :117)."""
    r = nn.round_bf16
    with nn.fp32_convs():
        y = torch.nn.functional.conv2d(x, r(p["w"]), padding=1)
    return torch.relu(r(y) + p["b"].float()[:, None, None])


def fused_stem_plain(params: nn.Params, image: torch.Tensor,
                     mp: bool = False) -> torch.Tensor:
    """conv -> bias -> ReLU -> conv -> bias -> ReLU -> max-pool, cuDNN in
    fp32. params {"conv1a": {w (64, 1, 3, 3), b}, "conv1b": {w (64, 64, 3,
    3), b}}. ``mp``: the image and weights rounded to bf16, each sum
    rounded before its bias, conv1a's output and the pooled map bf16."""
    if mp:
        r = nn.round_bf16
        x = r(conv_relu_mp(params["conv1a"], r(image.float())))
        x = conv_relu_mp(params["conv1b"], x)
        return nn.max_pool(x, 2).to(torch.bfloat16)
    with nn.fp32_convs():
        x = torch.relu(nn.conv2d(params["conv1a"], image))
        x = torch.relu(nn.conv2d(params["conv1b"], x))
    return nn.max_pool(x, 2)


def split_tf32(x: torch.Tensor):
    """``csrc/tc.cuh::split_tf32`` as the tensor core reads it: big = x with
    its low 13 bits cleared, small = x - big (exact in fp32) plus half a
    tf32 unit, its low 13 bits cleared (x - big rounded to tf32)."""
    big = (x.view(torch.int32) & _LOW13).view(torch.float32)
    small = ((x - big).view(torch.int32) + 0x1000) & _LOW13
    return big, small.view(torch.float32)


def prepare_conv(w: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """OIHW (64, 64, 3, 3) -> conv_tc.cuh's weights (9, 64, 128): per tap
    (dy, dx) and output channel, the 64 input channels K-major, split into
    tf32 big and small parts, each 8-deep chunk ci 8k .. 8k + 7 as four
    float4s {big ci 8k + t, big 8k + t + 4, small 8k + t, small 8k + t + 4},
    t = 0 .. 3: lane t's B fragment of an mma k-step.

    ``dtype`` bf16: ``csrc/conv_wgmma.cuh``'s (9, 64, 64), no split: per
    tap (dy, dx) a 64 x 64 slab, output channel co a 128-byte row of its 64
    input channels (K-major), the 16-byte chunk c (channels 8c .. 8c + 7)
    at chunk c ^ (co % 8): the 128-byte swizzle that wgmma's descriptors
    read, so that the kernel copies the 73.7 KB into shared memory as they
    lie (no tensor map)."""
    if dtype == torch.bfloat16:
        wt = w.permute(2, 3, 0, 1).reshape(9, 64, 8, 8)  # [tap][co][c][ci % 8]
        at = torch.arange(8)[None, :] ^ (torch.arange(64) % 8)[:, None]
        out = torch.empty_like(wt)
        out[:, torch.arange(64)[:, None], at] = wt
        return out.reshape(9, 64, 64).to(torch.bfloat16).contiguous()
    wt = w.permute(2, 3, 0, 1).reshape(9, 64, 8, 2, 4).contiguous()
    big, small = split_tf32(wt)  # [tap][co][k][ci 8k + 4h + t]: (k, h, t)
    parts = torch.stack([big, small], 3)  # (9, 64, k, bs, h, t)
    return parts.permute(0, 1, 2, 5, 3, 4).reshape(9, 64, 128).contiguous()


def prepared_conv(w: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``prepare_conv(w, dtype)``, built once per weight tensor and type
    (keyed by the tensor, as ``models.lightglue.prepared_blocks``): an edit
    in place of ``w`` is not seen, build a new tree."""
    per = _PREPARED.setdefault(w, {})
    if dtype not in per:
        per[dtype] = prepare_conv(w, dtype)
    return per[dtype]


def check_even_map(x: torch.Tensor, channels: int, what: str) -> None:
    if x.dim() != 4 or x.shape[1] != channels:
        raise ValueError(f"{what} must be (B, {channels}, H, W), got "
                         f"{tuple(x.shape)}")
    if x.shape[0] < 1 or x.shape[2] < 2 or x.shape[3] < 2 \
            or x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(f"{what} needs B >= 1 and even H, W >= 2, got "
                         f"{tuple(x.shape)}")


def check_conv(p: nn.Params, cin: int, name: str) -> None:
    if tuple(p["w"].shape) != (64, cin, 3, 3) or tuple(p["b"].shape) != (64,):
        raise ValueError(f"{name}: w (64, {cin}, 3, 3) and b (64,) expected, "
                         f"got {tuple(p['w'].shape)} and {tuple(p['b'].shape)}")


def fused_stem(params: nn.Params, image: torch.Tensor,
               mp: bool = False) -> torch.Tensor:
    """B7 on CUDA tensors (its bf16 form when ``mp``: a bf16 map out, NHWC
    in memory), the plain version on CPU tensors. The image is fp32 in both
    forms."""
    if image.device.type == "cpu":
        return fused_stem_plain(params, image, mp)
    a, b = params["conv1a"], params["conv1b"]
    dev = _build.check_cuda(image=image, w1a=a["w"], b1a=a["b"],
                            w1b=b["w"], b1b=b["b"])
    check_even_map(image, 1, "image")
    check_conv(a, 1, "conv1a")
    check_conv(b, 64, "conv1b")
    dt = torch.bfloat16 if mp else torch.float32
    n, _, h, w = image.shape
    if mp:
        out = torch.empty(n, 64, h // 2, w // 2, device=dev, dtype=dt,
                          memory_format=torch.channels_last)
        _build.launch("lg_fused_stem_bf16", dev, image, a["w"], a["b"],
                      prepared_conv(b["w"], dt), b["b"], out, n, h, w,
                      conv_plan.plan(n, h, w, sms(dev.index)).grid)
    else:
        out = torch.empty(n, 64, h // 2, w // 2, device=dev, dtype=dt)
        _build.launch("lg_fused_stem", dev, image, a["w"], a["b"],
                      prepared_conv(b["w"], dt), b["b"], out, n, h, w)
    _build.count(_build.typed("fused_stem", dt))
    return out
