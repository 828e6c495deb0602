"""SuperPoint's stem, conv1a + ReLU, conv1b + ReLU, 2x2 max-pool: kernel B7
and its plain version.

Counterpart of lightglue_tpu/ops/stem.py::fused_stem_pallas
(``_stem_kernel``, stem.py:77-236) and of the XLA conv chain it replaces
(lightglue_tpu/models/superpoint.py:111-124). NCHW here: (B, 1, H, W) ->
(B, 64, H/2, W/2). On a CUDA tensor ``fused_stem`` launches ``csrc/stem.cu``
or raises; on a CPU tensor it runs ``fused_stem_plain``.
"""

from __future__ import annotations

import torch

from .. import _build, nn


def fused_stem_plain(params: nn.Params, image: torch.Tensor) -> torch.Tensor:
    """conv -> bias -> ReLU -> conv -> bias -> ReLU -> max-pool, cuDNN in
    fp32. params {"conv1a": {w (64, 1, 3, 3), b}, "conv1b": {w (64, 64, 3,
    3), b}}."""
    with nn.fp32_convs():
        x = torch.relu(nn.conv2d(params["conv1a"], image))
        x = torch.relu(nn.conv2d(params["conv1b"], x))
    return nn.max_pool(x, 2)


def conv_weights(w: torch.Tensor) -> torch.Tensor:
    """OIHW (64, ci, 3, 3) -> the kernels' [ci][tap][co] layout."""
    return w.permute(1, 2, 3, 0).reshape(w.shape[1], 9, w.shape[0]).contiguous()


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
                  conv_weights(b["w"]), b["b"], out, n, h, w)
    _build.count("fused_stem")
    return out
