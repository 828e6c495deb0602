"""SuperPoint's stem, conv1a + ReLU, conv1b + ReLU, 2x2 max-pool: kernel B7
and its plain version.

Counterpart of lightglue_tpu/ops/stem.py::fused_stem_pallas
(``_stem_kernel``, stem.py:77-236) and of the XLA conv chain it replaces
(lightglue_tpu/models/superpoint.py:111-124). NCHW here: (B, 1, H, W) ->
(B, 64, H/2, W/2). On a CUDA tensor ``fused_stem`` launches ``csrc/stem.cu``
or raises; on a CPU tensor it runs ``fused_stem_plain``.

The 64 -> 64 convolutions of B7 and B8 (``csrc/conv_tc.cuh``) read their
weights as ``prepare_conv`` lays them out, built once per weight tensor
(``prepared_conv``).
"""

from __future__ import annotations

import torch
from torch.utils.weak import WeakIdKeyDictionary

from .. import _build, nn

_LOW13 = -0x2000  # int32 0xffffe000: the bits a tensor core reads of a tf32
_PREPARED = WeakIdKeyDictionary()


def fused_stem_plain(params: nn.Params, image: torch.Tensor) -> torch.Tensor:
    """conv -> bias -> ReLU -> conv -> bias -> ReLU -> max-pool, cuDNN in
    fp32. params {"conv1a": {w (64, 1, 3, 3), b}, "conv1b": {w (64, 64, 3,
    3), b}}."""
    with nn.fp32_convs():
        x = torch.relu(nn.conv2d(params["conv1a"], image))
        x = torch.relu(nn.conv2d(params["conv1b"], x))
    return nn.max_pool(x, 2)


def conv_weights(w: torch.Tensor) -> torch.Tensor:
    """OIHW (co, ci, 3, 3) -> [ci][tap][co], the layout of ALIKED's stem
    kernel (B10, ops/aliked_stem.py)."""
    return w.permute(1, 2, 3, 0).reshape(w.shape[1], 9, w.shape[0]).contiguous()


def split_tf32(x: torch.Tensor):
    """``csrc/tc.cuh::split_tf32`` as the tensor core reads it: big = x with
    its low 13 bits cleared, small = x - big (exact in fp32) plus half a
    tf32 unit, its low 13 bits cleared (x - big rounded to tf32)."""
    big = (x.view(torch.int32) & _LOW13).view(torch.float32)
    small = ((x - big).view(torch.int32) + 0x1000) & _LOW13
    return big, small.view(torch.float32)


def prepare_conv(w: torch.Tensor) -> torch.Tensor:
    """OIHW (64, 64, 3, 3) -> conv_tc.cuh's weights (9, 64, 128): per tap
    (dy, dx) and output channel, the 64 input channels K-major, split into
    tf32 big and small parts, each 8-deep chunk ci 8k .. 8k + 7 as four
    float4s {big ci 8k + t, big 8k + t + 4, small 8k + t, small 8k + t + 4},
    t = 0 .. 3: lane t's B fragment of an mma k-step."""
    wt = w.permute(2, 3, 0, 1).reshape(9, 64, 8, 2, 4).contiguous()
    big, small = split_tf32(wt)  # [tap][co][k][ci 8k + 4h + t]: (k, h, t)
    parts = torch.stack([big, small], 3)  # (9, 64, k, bs, h, t)
    return parts.permute(0, 1, 2, 5, 3, 4).reshape(9, 64, 128).contiguous()


def prepared_conv(w: torch.Tensor) -> torch.Tensor:
    """``prepare_conv(w)``, built once per weight tensor (keyed by the
    tensor, as ``models.lightglue.prepared_blocks``): an edit in place of
    ``w`` is not seen, build a new tree."""
    got = _PREPARED.get(w)
    if got is None:
        got = _PREPARED[w] = prepare_conv(w)
    return got


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


def fused_stem(params: nn.Params, image: torch.Tensor) -> torch.Tensor:
    """B7 on CUDA tensors, the plain version on CPU tensors."""
    if image.device.type == "cpu":
        return fused_stem_plain(params, image)
    a, b = params["conv1a"], params["conv1b"]
    dev = _build.check_cuda(image=image, w1a=a["w"], b1a=a["b"],
                            w1b=b["w"], b1b=b["b"])
    check_even_map(image, 1, "image")
    check_conv(a, 1, "conv1a")
    check_conv(b, 64, "conv1b")
    n, _, h, w = image.shape
    out = torch.empty(n, 64, h // 2, w // 2, device=dev)
    _build.launch("lg_fused_stem", dev, image, a["w"], a["b"],
                  prepared_conv(b["w"]), b["b"], out, n, h, w)
    _build.count("fused_stem")
    return out
