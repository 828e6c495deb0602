"""ALIKED's score head after its 1x1 stage: kernels B12 (from s0) and B11
(from the branch partials), and their plain versions.

Counterpart of lightglue_tpu/ops/score_head.py::score_head_pallas_cplane
(``_score_head_kernel``, score_head.py:119-140) and
``score_head_pallas_lazy`` (``_score_lazy_kernel``, :161-229), and of the
composed tails they replace (lightglue_tpu/models/aliked.py:263-286,
449-467). The tail is SELU, conv3x3 8->4, SELU, conv3x3 4->4, SELU, conv3x3
4->1, sigmoid, every conv zero-padding its own input; s0 is the 8-channel
pre-activation of the head's 1x1 stage in channel planes (B, 8, H, W). The
lazy entry takes s0's four branch parts at their own resolutions and adds
the align-corners upsampling of the three coarse ones to the first.

On CUDA tensors ``score_head_cplane`` and ``score_head_lazy`` launch
``csrc/score_head.cu`` or raise; on CPU tensors they run the plain versions.
"""

from __future__ import annotations

import torch

from .. import _build, nn
from .sampling import upsample

TAIL = (("2", 8, 4), ("4", 4, 4), ("6", 4, 1))  # conv, in, out


def score_tail_plain(sh: nn.Params, s0: torch.Tensor) -> torch.Tensor:
    """sh: the score head's convs {"2", "4", "6"} (OIHW, no bias); s0 (B, 8,
    H, W). Returns the (B, H, W) score map."""
    with nn.fp32_convs():
        s = nn.selu(s0)
        s = nn.selu(nn.conv2d(sh["2"], s))
        s = nn.selu(nn.conv2d(sh["4"], s))
        s = nn.conv2d(sh["6"], s)
    return torch.sigmoid(s)[:, 0]


def upsampled_sum(s1: torch.Tensor, s2: torch.Tensor, s3: torch.Tensor,
                  s4: torch.Tensor) -> torch.Tensor:
    """s1 + up(s2) + up(s3) + up(s4), each part resampled to s1's size."""
    s0 = s1
    for sk in (s2, s3, s4):
        s0 = s0 + upsample(sk, s1.shape[-2:])
    return s0


def score_head_lazy_plain(sh, s1, s2, s3, s4) -> torch.Tensor:
    return score_tail_plain(sh, upsampled_sum(s1, s2, s3, s4))


def _tail_weights(sh: nn.Params) -> torch.Tensor:
    """The three convs' weights as [ci][tap][co], concatenated (468)."""
    parts = []
    for name, cin, cout in TAIL:
        p = sh[name]
        if tuple(p["w"].shape) != (cout, cin, 3, 3) or "b" in p:
            raise ValueError(f"score_head.{name}: weight {(cout, cin, 3, 3)} "
                             f"without bias expected, got {tuple(p['w'].shape)}")
        parts.append(p["w"].permute(1, 2, 3, 0).reshape(-1))
    return torch.cat(parts)


def _check_planes(name: str, x: torch.Tensor, b: int) -> None:
    if x.dim() != 4 or x.shape[0] != b or x.shape[1] != 8 or min(x.shape) < 1:
        raise ValueError(f"{name} must be ({b}, 8, h >= 1, w >= 1), got "
                         f"{tuple(x.shape)}")


def score_head_cplane(sh: nn.Params, s0: torch.Tensor) -> torch.Tensor:
    """B12 on CUDA tensors, the plain tail on CPU tensors."""
    if s0.device.type == "cpu":
        return score_tail_plain(sh, s0)
    return score_head_cplane_kernel(sh, s0)


def score_head_cplane_kernel(sh: nn.Params, s0: torch.Tensor) -> torch.Tensor:
    """B12: one launch over CUDA tensors."""
    w = _tail_weights(sh)
    dev = _build.check_cuda(s0=s0, w=w)
    _check_planes("s0", s0, s0.shape[0])
    b, _, h, wd = s0.shape
    out = torch.empty(b, h, wd, device=dev)
    _build.launch("lg_score_head", dev, s0, w, out, b, h, wd)
    _build.count("score_head_cplane")
    return out


def score_head_lazy(sh, s1, s2, s3, s4) -> torch.Tensor:
    """B11 on CUDA tensors, the plain upsampling and tail on CPU tensors.
    s1 (B, 8, H, W); s2, s3, s4 (B, 8, hk, wk), any sizes >= 1 (the
    kernel resamples each to H x W with align-corners weights)."""
    if s1.device.type == "cpu":
        return score_head_lazy_plain(sh, s1, s2, s3, s4)
    return score_head_lazy_kernel(sh, s1, s2, s3, s4)


def score_head_lazy_kernel(sh, s1, s2, s3, s4) -> torch.Tensor:
    """B11: one launch over CUDA tensors."""
    w = _tail_weights(sh)
    dev = _build.check_cuda(s1=s1, s2=s2, s3=s3, s4=s4, w=w)
    b, _, h, wd = s1.shape
    for name, x in (("s1", s1), ("s2", s2), ("s3", s3), ("s4", s4)):
        _check_planes(name, x, b)
    out = torch.empty(b, h, wd, device=dev)
    _build.launch("lg_score_head_lazy", dev, s1, s2, s3, s4, w, out, b, h, wd,
                  *s2.shape[2:], *s3.shape[2:], *s4.shape[2:])
    _build.count("score_head_lazy")
    return out
