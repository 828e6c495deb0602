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
The fp32 kernels take the 468 weights by value as a kernel parameter, from a
host copy that ``prepared`` makes once per parameter tree.

``mp=True`` is the bf16 form of both (the TPU kernels at mp,
lightglue_tpu/ops/score_head.py:82-83, 135-136, 224-225, 232-239): the
weights rounded to bf16, s0 rounded before its SELU and every stage's input
rounded as it is read; products exact, sums and the maps in and out fp32.
On the card it is ``csrc/score_wgmma.cuh``: persistent blocks walking the
strips ``conv_plan`` cuts (``STRIP`` columns, ``PER_SM`` blocks an SM), conv
8->4 and 4->4 on ``wgmma`` (conv 4->1 on the CUDA cores), the weights one
bf16 blob (``prepare_bf16``) resident in
shared memory, s0's (or s1's) rows read by TMA through a tensor map cached
with the blob (``prepared(sh, True)`` is a ``tma_maps.Prepared16``); a
width that is not a multiple of 4, or planes off a 16-byte boundary, go
through one zero-padded copy (``tma_maps.padded``: a TMA row starts on a
16-byte boundary). The plain versions take the same flag.
"""

from __future__ import annotations

import ctypes
import torch
from torch.utils.weak import WeakIdKeyDictionary

from .. import _build, nn
from . import conv_plan
from .block_tc import sms
from .sampling import upsample
from .tma_maps import Prepared16, padded, tensor_map

TAIL = (("2", 8, 4), ("4", 4, 4), ("6", 4, 1))  # conv, in, out
STRIP = 122  # the bf16 form's strip (csrc/score_wgmma.cuh)
PER_SM = 3  # its persistent blocks an SM
# its blob: k-steps of one 16 x 8 B tile each (conv 8->4, 4->4, 4->1), 256
# bytes a k-step
K_STEPS = (8, 4, 4)
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


def prepare(sh: nn.Params) -> torch.Tensor:
    """The fp32 kernels' weight parameter (``Weights`` in
    csrc/score_head.cu): the three convs as [ci][tap][co], (8, 9, 4), (4,
    9, 4), (4, 9, 1), concatenated, 468 fp32 values in host memory."""
    _check_tail(sh)
    return torch.cat([sh[name]["w"].detach().float().permute(1, 2, 3, 0)
                      .reshape(-1) for name, _, _ in TAIL]).cpu().contiguous()


def prepare_bf16(sh: nn.Params) -> torch.Tensor:
    """The bf16 form's weights as ``csrc/score_wgmma.cuh`` copies them into
    shared memory: one bf16 blob of 16 k-steps, each a K-major B tile
    [chunk 2][n 8][8 k] (K 16 = two 8-deep chunks), on the weights' device.
    Column n = 4 rr + co is output channel co of the pair's row rr (conv
    4->1: n = rr); input row ri (0 .. 3: the pair's rows - 1 .. + 2) feeds
    row rr through tap dy = ri - rr, zero where that is not 0 .. 2:

    - conv 8->4, k-step 2 ri + dp: k = 8 chunk + ci, tap dx = 2 dp + chunk
      (dx 3 zero): s0's slot holds one pixel's 8 channels;
    - conv 4->4 (k-steps 8 ..) and conv 4->1 (12 ..), k-step ri: k = 8 chunk
      + 4 half + ci, tap dx = 2 chunk + half (dx 3 zero): a stage's slot p
      holds pixels p and p + 1, 4 channels each."""
    _check_tail(sh)
    w1, w2, w3 = (sh[name]["w"].detach().float() for name, _, _ in TAIL)
    blob = w1.new_zeros(sum(K_STEPS), 2, 8, 8)
    for ri in range(4):
        for rr in range(2):
            dy = ri - rr
            if not 0 <= dy <= 2:
                continue
            for dx in range(3):
                blob[2 * ri + dx // 2, dx % 2, 4 * rr:4 * rr + 4, :] = w1[:, :, dy, dx]
                half = 4 * (dx % 2)
                blob[8 + ri, dx // 2, 4 * rr:4 * rr + 4, half:half + 4] = w2[:, :, dy, dx]
                blob[12 + ri, dx // 2, rr, half:half + 4] = w3[0, :, dy, dx]
    return blob.reshape(-1).to(torch.bfloat16).contiguous()


def prepared(sh: nn.Params, mp: bool = False):
    """``prepare(sh)`` (the fp32 kernels' host array), or for ``mp`` the
    ``Prepared16`` of ``prepare_bf16(sh)`` and its tensor maps, built once
    per parameter tree and ``mp`` (keyed by conv "2"'s weight tensor, and
    rebuilt if "4" or "6" is another object): an edit in place of a tensor
    is not seen, build a new tree. The first fp32 call copies the weights
    to the host."""
    srcs = (sh["4"]["w"], sh["6"]["w"])
    got = _PREPARED.get(sh["2"]["w"])
    if got is None or any(a is not b for a, b in zip(got[0], srcs)):
        got = _PREPARED[sh["2"]["w"]] = (srcs, {})
    if mp not in got[1]:
        got[1][mp] = Prepared16(prepare_bf16(sh), {}) if mp else prepare(sh)
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


def grid(b: int, h: int, w: int, device: torch.device) -> int:
    """The bf16 form's persistent blocks: ``conv_plan.plan`` of the launch
    in strips of ``STRIP``, ``PER_SM`` blocks an SM."""
    return conv_plan.plan(b, h, w, PER_SM * sms(device.index), STRIP).grid


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
    b, _, h, wd = s0.shape
    out = torch.empty(b, h, wd, device=dev)
    if mp:
        prep, s = prepared(sh, True), padded(s0)  # s lives through the launch
        plane = tensor_map(prep, "lg_score_head_bf16_map", s)
        _build.launch("lg_score_head_bf16", dev, plane, prep.weights, out, b,
                      h, wd, grid(b, h, wd, dev))
    else:
        _build.launch("lg_score_head", dev, s0, prepared(sh), out, b, h, wd)
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
    out = torch.empty(b, h, wd, device=dev)
    sizes = (*s2.shape[2:], *s3.shape[2:], *s4.shape[2:])
    if mp:
        prep, s = prepared(sh, True), padded(s1)  # s lives through the launch
        plane = tensor_map(prep, "lg_score_head_bf16_map", s)
        _build.launch("lg_score_head_lazy_bf16", dev, plane, s2, s3, s4,
                      prep.weights, out, b, h, wd, *sizes, grid(b, h, wd, dev))
    else:
        _build.launch("lg_score_head_lazy", dev, s1, s2, s3, s4, prepared(sh),
                      out, b, h, wd, *sizes)
    _build.count(_typed("score_head_lazy", mp))
    return out


def blocks_per_sm(lazy: bool, device: torch.device) -> int:
    """Blocks of B11 (lazy) or B12 resident on one SM of ``device``, by the
    runtime's occupancy calculator at ALIKED's shared memory."""
    n = ctypes.c_int(0)
    _build.launch("lg_score_head_blocks", device, int(lazy), ctypes.byref(n))
    return n.value
