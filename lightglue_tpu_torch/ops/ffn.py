"""FFN with residual, x + FFN(cat[x, msg]): kernel B4 and its plain version.

Counterpart of lightglue_tpu/ops/ffn.py::fused_ffn_residual (``_ffn_kernel``,
ffn.py:40-115): FFN = lin1 -> LayerNorm (eps 1e-5) -> exact erf GELU ->
lin2, with the concat algebraic (cat[x, m] W1 = x W1[:D] + m W1[D:]).

On CUDA tensors B4 is two launches of the tile product that B5's and B6's
tails end with (ops/block_tc.py over csrc/blocks.cu): lin1 writes h = [x |
msg] W1 + b1 and its LayerNorm partials, lin2 merges them and adds
GELU(LN(h)) W2 + b2 to x. ``fused_ffn_residual_pair`` runs the two images
of a composed cross block through one pair of launches. The weights are
stored K-major once per parameter tree (``prepared``). On CPU tensors both
run ``fused_ffn_residual_plain``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

from .. import _build, nn
from . import block_tc
from .block_tc import DIMS

_PREPARED = WeakIdKeyDictionary()


def fused_ffn_residual_plain(
    x: torch.Tensor, msg: torch.Tensor, p: nn.Params
) -> torch.Tensor:
    """x, msg (B, N, D); p {"lin1": {w (2D, 2D), b}, "ln": {scale, bias},
    "lin2": {w (2D, D), b}} (models/lightglue.py::_ffn_init layout)."""
    d = x.shape[-1]
    w1 = p["lin1"]["w"]
    s = x @ w1[:d] + msg @ w1[d:] + p["lin1"]["b"]
    mean = s.mean(-1, keepdim=True)
    c = s - mean
    var = (c * c).mean(-1, keepdim=True)
    hn = c * torch.rsqrt(var + 1e-5) * p["ln"]["scale"] + p["ln"]["bias"]
    return x + (nn.gelu(hn) @ p["lin2"]["w"] + p["lin2"]["b"])


def _sources(p: nn.Params) -> Tuple[torch.Tensor, ...]:
    return (p["lin1"]["w"], p["lin1"]["b"], p["ln"]["scale"], p["ln"]["bias"],
            p["lin2"]["w"], p["lin2"]["b"])


def _where(t: torch.Tensor) -> tuple:
    return t.data_ptr(), tuple(t.shape), tuple(t.stride())


def prepared(p: nn.Params) -> dict:
    """``block_tc.ffn_weights(p)``, built once per parameter tree: keyed by
    the lin1 weight tensor (for a layer of stacked parameters, which
    ``nn.index_params`` hands out as a new view each call, by the stacked
    tensor and the view's offset), and rebuilt if any tensor it reads lies
    elsewhere. An edit in place of a tensor is not seen: build a new tree."""
    w1 = p["lin1"]["w"]
    base = w1 if w1._base is None else w1._base
    per_view = _PREPARED.setdefault(base, {})
    where = tuple(_where(t) for t in _sources(p))
    got = per_view.get(where[0])
    if got is None or got[0] != where:
        got = per_view[where[0]] = (where, block_tc.ffn_weights(p))
    return got[1]


def _launch(xs: Sequence[torch.Tensor], msgs: Sequence[torch.Tensor],
            p: nn.Params) -> List[torch.Tensor]:
    """B4's two launches over the rows of every segment (one or two images
    of one batch size) on CUDA tensors: the activations and the weights as
    given are checked before any preparation."""
    dev = _build.check_cuda(**{f"x{i}": x for i, x in enumerate(xs)},
                            **{f"msg{i}": m for i, m in enumerate(msgs)})
    d = xs[0].shape[-1]
    if d not in DIMS:
        raise ValueError(f"fused_ffn_residual takes D in {DIMS}, got {d}")
    for x, m in zip(xs, msgs):
        if m.shape != x.shape or x.shape[0] != xs[0].shape[0] \
                or x.shape[-1] != d or x.shape[1] < 1:
            raise ValueError(f"msg {tuple(m.shape)} and x {tuple(x.shape)} "
                             f"must be equal (B, N >= 1, {d})")
    if _build.check_cuda(**{f"w{i}": t for i, t in enumerate(_sources(p))}) \
            != dev:
        raise ValueError(f"the FFN weights are not on {dev}")
    w = prepared(p)
    block_tc.check_ffn_weights(w, d)
    out = block_tc.launch_ffn(dev, w, xs, msgs)
    _build.count("fused_ffn_residual")
    return out


def fused_ffn_residual(
    x: torch.Tensor, msg: torch.Tensor, p: nn.Params
) -> torch.Tensor:
    """B4 on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return fused_ffn_residual_plain(x, msg, p)
    return _launch([x], [msg], p)[0]


def fused_ffn_residual_pair(
    x0: torch.Tensor, m0: torch.Tensor, x1: torch.Tensor, m1: torch.Tensor,
    p: nn.Params,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x0 + FFN(cat[x0, m0]), x1 + FFN(cat[x1, m1])), x_s (B, n_s, D): on
    CUDA tensors one B4 call (one count) over the rows of both, on CPU
    tensors the plain version twice."""
    if x0.device.type == "cpu":
        return (fused_ffn_residual_plain(x0, m0, p),
                fused_ffn_residual_plain(x1, m1, p))
    return tuple(_launch([x0, x1], [m0, m1], p))
