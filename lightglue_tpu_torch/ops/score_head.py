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
The kernels take the 468 weights by value as a kernel parameter, from a host
copy that ``prepared`` makes once per parameter tree and ``mp``.

``mp=True`` is the bf16 form of both (the TPU kernels at mp,
lightglue_tpu/ops/score_head.py:82-83, 135-136, 224-225, 232-239): the
weights rounded to bf16, s0 rounded before its SELU and every stage's input
rounded as it is read; products, sums and the maps in and out fp32. The
plain versions take the same flag.
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.weak import WeakIdKeyDictionary

from .. import _build, nn
from .sampling import upsample

TAIL = (("2", 8, 4), ("4", 4, 4), ("6", 4, 1))  # conv, in, out
_PREPARED = WeakIdKeyDictionary()


def score_tail_plain(sh: nn.Params, s0: torch.Tensor,
                     mp: bool = False) -> torch.Tensor:
    """sh: the score head's convs {"2", "4", "6"} (OIHW, no bias); s0 (B, 8,
    H, W). Returns the (B, H, W) score map. ``mp``: fp32 convolutions of
    the bf16-rounded weights, s0 and each stage's input rounded to bf16."""
    if mp:
        r, conv = nn.round_bf16, torch.nn.functional.conv2d
        with nn.fp32_convs():
            s = r(nn.selu(r(s0.float())))
            s = r(nn.selu(conv(s, r(sh["2"]["w"]), padding=1)))
            s = r(nn.selu(conv(s, r(sh["4"]["w"]), padding=1)))
            s = conv(s, r(sh["6"]["w"]), padding=1)
        return torch.sigmoid(s)[:, 0]
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


def score_head_lazy_plain(sh, s1, s2, s3, s4, mp: bool = False) -> torch.Tensor:
    return score_tail_plain(sh, upsampled_sum(s1, s2, s3, s4), mp)


def _check_tail(sh: nn.Params) -> None:
    for name, cin, cout in TAIL:
        p = sh[name]
        if tuple(p["w"].shape) != (cout, cin, 3, 3) or "b" in p:
            raise ValueError(f"score_head.{name}: weight {(cout, cin, 3, 3)} "
                             f"without bias expected, got {tuple(p['w'].shape)}")


def prepare(sh: nn.Params, mp: bool = False) -> torch.Tensor:
    """The kernels' weight parameter (``Weights`` in csrc/score_head.cu):
    the three convs as [ci][tap][co], (8, 9, 4), (4, 9, 4), (4, 9, 1),
    concatenated, 468 fp32 values in host memory; rounded to bf16 (as fp32
    values) when ``mp``."""
    _check_tail(sh)
    w = torch.cat([sh[name]["w"].detach().float().permute(1, 2, 3, 0)
                   .reshape(-1) for name, _, _ in TAIL]).cpu()
    return (nn.round_bf16(w) if mp else w).contiguous()


def prepared(sh: nn.Params, mp: bool = False) -> torch.Tensor:
    """``prepare(sh, mp)``, built once per parameter tree and ``mp`` (keyed
    by conv "2"'s weight tensor, and rebuilt if "4" or "6" is another
    object): an edit in place of a tensor is not seen, build a new tree.
    The first call copies the weights to the host."""
    srcs = (sh["4"]["w"], sh["6"]["w"])
    got = _PREPARED.get(sh["2"]["w"])
    if got is None or any(a is not b for a, b in zip(got[0], srcs)):
        got = _PREPARED[sh["2"]["w"]] = (srcs, {})
    if mp not in got[1]:
        got[1][mp] = prepare(sh, mp)
    return got[1][mp]


def _check_weights(sh: nn.Params) -> dict:
    _check_tail(sh)
    return {f"w{name}": sh[name]["w"].contiguous() for name, _, _ in TAIL}


def _check_planes(name: str, x: torch.Tensor, b: int) -> None:
    if x.dim() != 4 or x.shape[0] != b or x.shape[1] != 8 or min(x.shape) < 1:
        raise ValueError(f"{name} must be ({b}, 8, h >= 1, w >= 1), got "
                         f"{tuple(x.shape)}")


def _typed(name: str, mp: bool) -> str:
    return _build.typed(name, torch.bfloat16 if mp else torch.float32)


def score_head_cplane(sh: nn.Params, s0: torch.Tensor,
                      mp: bool = False) -> torch.Tensor:
    """B12 on CUDA tensors (its bf16 form when ``mp``), the plain tail on
    CPU tensors."""
    if s0.device.type == "cpu":
        return score_tail_plain(sh, s0, mp)
    return score_head_cplane_kernel(sh, s0, mp)


def score_head_cplane_kernel(sh: nn.Params, s0: torch.Tensor,
                             mp: bool = False) -> torch.Tensor:
    """B12: one launch over CUDA tensors."""
    dev = _build.check_cuda(s0=s0, **_check_weights(sh))
    _check_planes("s0", s0, s0.shape[0])
    w = prepared(sh, mp)
    b, _, h, wd = s0.shape
    out = torch.empty(b, h, wd, device=dev)
    _build.launch(_typed("lg_score_head", mp), dev, s0, w, out, b, h, wd)
    _build.count(_typed("score_head_cplane", mp))
    return out


def score_head_lazy(sh, s1, s2, s3, s4, mp: bool = False) -> torch.Tensor:
    """B11 on CUDA tensors (its bf16 form when ``mp``), the plain
    upsampling and tail on CPU tensors. s1 (B, 8, H, W); s2, s3, s4 (B, 8,
    hk, wk), any sizes >= 1 (the kernel resamples each to H x W with
    align-corners weights)."""
    if s1.device.type == "cpu":
        return score_head_lazy_plain(sh, s1, s2, s3, s4, mp)
    return score_head_lazy_kernel(sh, s1, s2, s3, s4, mp)


def score_head_lazy_kernel(sh, s1, s2, s3, s4, mp: bool = False) -> torch.Tensor:
    """B11: one launch over CUDA tensors."""
    dev = _build.check_cuda(s1=s1, s2=s2, s3=s3, s4=s4, **_check_weights(sh))
    b, _, h, wd = s1.shape
    for name, x in (("s1", s1), ("s2", s2), ("s3", s3), ("s4", s4)):
        _check_planes(name, x, b)
    w = prepared(sh, mp)
    out = torch.empty(b, h, wd, device=dev)
    _build.launch(_typed("lg_score_head_lazy", mp), dev, s1, s2, s3, s4, w,
                  out, b, h, wd, *s2.shape[2:], *s3.shape[2:], *s4.shape[2:])
    _build.count(_typed("score_head_lazy", mp))
    return out


def blocks_per_sm(lazy: bool, device: torch.device) -> int:
    """Blocks of B11 (lazy) or B12 resident on one SM of ``device``, by the
    runtime's occupancy calculator at ALIKED's shared memory."""
    n = ctypes.c_int(0)
    _build.launch("lg_score_head_blocks", device, int(lazy), ctypes.byref(n))
    return n.value
