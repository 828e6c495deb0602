"""The tensor-core launches of B5, B6 and B4 and their plain versions: the
projection and the out_proj + FFN tail (csrc/blocks.cu over the tile
product of csrc/gemm_tc.cuh); B4 (ops/ffn.py) is lin1 and lin2 alone.

    project       x W_in^T + b_in split into groups of heads, rotary on q, k
    tail_out_proj msg = merge_heads(ctx) Wo + bo
    tail_lin1     h = [x | msg] W1 + b1, and h's LayerNorm partials
    tail_lin2     out = x + GELU(LN(h)) W2 + b2, the partials merged first
    tail_chain    the three in order

Each takes a list of one or two segments (B5: the image; B6: both images,
one launch over the rows of both; lin1 one message per segment) and
returns one result per segment (``tail_out_proj`` and ``tail_lin1`` return
their rows stacked). On CUDA
tensors each launches its kernel or raises; on CPU tensors it runs its
plain version, the function of the same name with ``_plain``.
``ln_partials_plain`` and ``merge_stats_plain`` state the LayerNorm
statistics that lin1's epilogue writes and lin2's prologue merges: per row
and 16 columns (count, mean, M2 about that mean), merged in column order by
Chan's formula. Centred partials, not sums and sums of squares: a trained
layer's LN input can have |mean| >> std, where those cancel.

``tile_plan`` picks each launch's tile from its shape and the card's SMs
(``bf16_plan`` the bf16 form's tile and persistent grid);
the weights come K-major from the ops' ``prepare`` (``woT``, ``w1T``,
``w2T``: one row per output channel; B4's from ``ffn_weights``). The ops
check the weights once a call (``check_block_weights``, B4
``check_ffn_weights``) and run ``launch_project``, ``launch_tail`` and
``launch_ffn``, which check only the activations.

Each launch has a bf16 form (mp; the entry points' ``_bf16`` twins): the
type of the weights dict's matrices (``ffn_weights``, ``tail_weights``;
``wtype``) says which, and the activations must be of it (they are
checked, never converted). In the bf16 form the products are bf16 with
fp32 sums; biases, LayerNorm, GELU and h stay fp32; the projection's heads
(after rotary, its tables rounded to bf16), the message and the output are
rounded to bf16, and the hidden GELU(LN(h)) is rounded before lin2, where
the TPU kernels round. The plain versions take either type and round at
the same points.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import torch

from .. import _build, nn
from . import rotary
from .flash import HEAD_DIMS, aligned16

DIMS = (128, 256)  # the descriptor widths the block and FFN launches take
# Tiles (rows, channels) of csrc/gemm_tc.cuh (Tile0-3), largest first
TILES = ((64, 128), (64, 64), (32, 64), (32, 32))
# The bf16 form's tiles (rows, channels), of csrc/gemm_wgmma.cuh (Tile0-6);
# the consumer warpgroups that share each tile's k-steps (KS); the blocks
# an SM each tile's kernel holds: a persistent grid of at most that many
# blocks an SM walks them (bf16_plan)
TILES_BF16 = ((128, 256), (128, 128), (128, 64), (64, 128), (64, 64),
              (64, 128), (64, 64))
SPLIT_BF16 = (1, 1, 1, 1, 1, 2, 2)
BLOCKS_BF16 = (1, 1, 1, 2, 2, 1, 1)
# Each bf16 launch's tiles in the order bf16_plan tries them (H100,
# scripts/gemm_study.py, every tile at B 1, 4 and 16): the projection (its
# epilogue gathers the rotary tables) takes the 128-row tiles while they
# fill the card; out_proj and lin1 the 64-row tiles, two blocks an SM (one
# block's epilogue beside the other's products); lin2, whose k-steps each
# wait for the LayerNorm and GELU of the landed h, 128 x 256 (each hidden
# value formed once) while it fills the card, else the 64-row tiles whose
# two consumers split the k-steps.
ORDERS_BF16 = {"project": (0, 1, 2, 3, 4), "out_proj": (3, 4),
               "lin1": (3, 4), "lin2": (0, 5, 6)}
BF16_FILL = 0.9
LN_PART = 16  # columns of one LayerNorm partial (gemm_tc.cuh::PART)
LN_EPS = 1e-5


@functools.lru_cache(maxsize=1024)
def tile_plan(rows: int, cols: int, sms: int) -> int:
    """Index into TILES of the tile for a product of ``rows`` x ``cols``
    outputs on a card of ``sms`` SMs: the largest tile whose grid gives
    every SM a block (a larger tile reuses each weight tile over more rows
    and each row tile over more channels), else the smallest. Every tile's
    channels divide ``cols``."""
    for i, (bm, bn) in enumerate(TILES):
        if cols % bn:
            raise ValueError(f"{cols} channels are not a multiple of {bn}")
        if -(-rows // bm) * (cols // bn) >= sms:
            return i
    return len(TILES) - 1


@functools.lru_cache(maxsize=1024)
def bf16_plan(rows: int, cols: int, sms: int, launch: str
              ) -> Tuple[int, int]:
    """(index into TILES_BF16, blocks of the persistent grid) for the bf16
    ``launch`` (a key of ORDERS_BF16) of ``rows`` x ``cols`` outputs on a
    card of ``sms`` SMs: the first tile of the launch's order whose tiles
    give BF16_FILL of the blocks the SMs hold (BLOCKS_BF16 an SM) one each,
    else the last; a tile whose channels do not divide ``cols`` (256 at D
    128) is passed over. The grid is the tiles, at most the blocks the SMs
    hold."""
    order = ORDERS_BF16[launch]
    fits = [i for i in order if cols % TILES_BF16[i][1] == 0]
    if not fits:
        narrow = min(TILES_BF16[i][1] for i in order)
        raise ValueError(f"{cols} channels are not a multiple of {narrow}")
    count = lambda i: -(-rows // TILES_BF16[i][0]) * (  # noqa: E731
        cols // TILES_BF16[i][1])
    tile = next((i for i in fits
                 if count(i) >= BF16_FILL * BLOCKS_BF16[i] * sms), fits[-1])
    return tile, min(count(tile), BLOCKS_BF16[tile] * sms)


@functools.lru_cache(maxsize=None)
def sms(index: int) -> int:
    """SMs of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _tile(dev: torch.device, rows: int, cols: int, dtype: torch.dtype,
          launch: str) -> tuple:
    """The tile arguments of ``launch`` (a key of ORDERS_BF16): (tile,) for
    the fp32 form, (tile, grid) for the bf16 one."""
    if dtype == torch.bfloat16:
        return bf16_plan(rows, cols, sms(dev.index), launch)
    return (tile_plan(rows, cols, sms(dev.index)),)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(B, H, N, hd) -> (B, N, H * hd)."""
    b, h, n, hd = t.shape
    return t.transpose(1, 2).reshape(b, n, h * hd)


def _rows(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The rows of every segment (B, n_s, C), stacked: (R, C)."""
    return torch.cat([x.reshape(-1, x.shape[-1]) for x in xs])


def _segments(rows: torch.Tensor, xs: Sequence[torch.Tensor]
              ) -> List[torch.Tensor]:
    """Stacked rows (R, C) back into tensors shaped like ``xs``."""
    sizes = [x.shape[0] * x.shape[1] for x in xs]
    return [r.reshape(*x.shape[:2], -1)
            for r, x in zip(torch.split(rows, sizes), xs)]


def _segment_args(ts: Sequence[torch.Tensor], dim: int = 1) -> tuple:
    """(t0, t1 or None, n0, n1) of one or two segments, n_s their sizes
    along ``dim`` (the points: 1 of (B, n_s, ...), 2 of (B, H, n_s, hd))."""
    if len(ts) == 1:
        return ts[0], None, ts[0].shape[dim], 0
    return ts[0], ts[1], ts[0].shape[dim], ts[1].shape[dim]


# --- the projection --------------------------------------------------------


def project_plain(w: dict, xs: Sequence[torch.Tensor], groups: int,
                  enc: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """Per segment x (B, n, D): x w_in^T + b_in as (groups, B, H, n, hd),
    rotary (enc (2, B, 1, n, hd/2), one segment) on the first two groups;
    bf16 x: fp32 sums, the tables rounded to bf16, the heads rounded after
    rotary."""
    h = w["num_heads"]
    out = []
    for x in xs:
        b, n, d = x.shape
        y = (x.float() @ w["w_in"].float().t() + w["b_in"]).reshape(
            b, n, groups, h, d // h)
        y = y.permute(2, 0, 3, 1, 4)
        if enc is not None:
            tables = enc.to(x.dtype).float()
            y = torch.cat([rotary.apply_rotary(tables, y[:2]), y[2:]])
        out.append(y.to(x.dtype))
    return out


def project(w: dict, xs: Sequence[torch.Tensor], groups: int,
            enc: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """The projection launch (one over every segment's rows) on CUDA
    tensors, the plain version on CPU tensors."""
    if xs[0].device.type == "cpu":
        return project_plain(w, xs, groups, enc)
    return launch_project(check_block_weights(w, xs[0].shape[-1]), w, xs,
                          groups, enc)


def _activations(dev: torch.device, dtype: torch.dtype, **tensors) -> None:
    """Raise unless the tensors are contiguous ``dtype`` on ``dev``."""
    if _build.check_cuda(dtype=dtype, **tensors) != dev:
        raise ValueError(f"the activations are not on {dev}, the weights' "
                         "device")


def launch_project(dev: torch.device, w: dict, xs: Sequence[torch.Tensor],
                   groups: int, enc: Optional[torch.Tensor]
                   ) -> List[torch.Tensor]:
    """``project``'s launch on weights that check_block_weights returned
    ``dev`` for (the ops check them once a call)."""
    b, _, d = xs[0].shape
    h = w["num_heads"]
    hd = d // h
    dt = wtype(w)
    cos = sin = None
    if enc is not None:
        if len(xs) != 1:
            raise ValueError("rotary takes one segment")
        # fp32 tables; the bf16 form's epilogue rounds them to bf16 (the
        # TPU kernel's cosd, sind) and applies them in fp32
        cos = enc[0][:, 0].contiguous()
        sin = enc[1][:, 0].contiguous()
        if cos.shape != (b, xs[0].shape[1], hd // 2):
            raise ValueError(f"enc {tuple(enc.shape)} does not fit x "
                             f"{tuple(xs[0].shape)}")
        _activations(dev, torch.float32, cos=cos, sin=sin)
    _activations(dev, dt, **{f"x{i}": x for i, x in enumerate(xs)})
    if w["w_in"].shape[0] != groups * d:
        raise ValueError(f"w_in must have {groups * d} rows")
    outs = [torch.empty(groups, b, h, x.shape[1], hd, device=dev, dtype=dt)
            for x in xs]
    x0, x1, n0, n1 = _segment_args([aligned16(x) for x in xs])
    o0, o1, _, _ = _segment_args(outs)
    _build.launch(_build.typed("lg_project_heads", dt), dev, x0, x1, w["w_in"],
                  w["b_in"], cos, sin, o0, o1, b, n0, n1, groups, h, hd,
                  0 if cos is None else 2,
                  *_tile(dev, b * (n0 + n1), groups * d, dt, "project"))
    return outs


# --- the tail --------------------------------------------------------------


def tail_out_proj_plain(w: dict, ctxs: Sequence[torch.Tensor]
                        ) -> torch.Tensor:
    """msg (R, D) = merge_heads(ctx) Wo + bo over the rows of every
    segment's context (B, H, n_s, hd), in the context's type (bf16: fp32
    sums, rounded once)."""
    rows = _rows([merge_heads(c) for c in ctxs])
    return (rows.float() @ w["woT"].float().t() + w["bo"]).to(rows.dtype)


def tail_out_proj(w: dict, ctxs: Sequence[torch.Tensor]) -> torch.Tensor:
    if ctxs[0].device.type == "cpu":
        return tail_out_proj_plain(w, ctxs)
    b, h, _, hd = ctxs[0].shape
    return _out_proj(check_block_weights(w, h * hd), w, ctxs)


def _out_proj(dev, w, ctxs):
    b, h, _, hd = ctxs[0].shape
    d = h * hd
    dt = wtype(w)
    _activations(dev, dt, **{f"ctx{i}": c for i, c in enumerate(ctxs)})
    c0, c1, n0, n1 = _segment_args([aligned16(c) for c in ctxs], 2)
    msg = torch.empty(b * (n0 + n1), d, device=dev, dtype=dt)
    _build.launch(_build.typed("lg_tail_out_proj", dt), dev, c0, c1, w["woT"],
                  w["bo"], msg, b, n0, n1, h, hd,
                  *_tile(dev, msg.shape[0], d, dt, "out_proj"))
    return msg


def ln_partials_plain(h: torch.Tensor) -> torch.Tensor:
    """h (R, C) -> (R, C / 16, 2): each 16 columns' mean and M2 (the sum of
    squares about that mean)."""
    hp = h.reshape(h.shape[0], -1, LN_PART)
    mean = hp.mean(-1)
    return torch.stack([mean, ((hp - mean[..., None]) ** 2).sum(-1)], -1)


def merge_stats_plain(stats: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R, P, 2) partials -> each row's (mean, 1 / sqrt(var + 1e-5)):
    Chan's merge of (n, mean, M2) with the next partial (16, mb, m2b), in
    column order, as lin2's prologue does:
        delta = mb - mean;  mean += delta 16 / (n + 16);
        M2 += m2b + delta^2 n 16 / (n + 16);  n += 16."""
    mean, m2 = stats[:, 0, 0], stats[:, 0, 1]
    n = float(LN_PART)
    for p in range(1, stats.shape[1]):
        nn_ = n + LN_PART
        delta = stats[:, p, 0] - mean
        mean = mean + delta * (LN_PART / nn_)
        m2 = m2 + (stats[:, p, 1] + delta * delta * (n * LN_PART / nn_))
        n = nn_
    return mean, 1.0 / torch.sqrt(m2 / n + LN_EPS)


def tail_lin1_plain(w: dict, xs: Sequence[torch.Tensor],
                    msgs: Sequence[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h (R, 2D) = [x | msg] W1 + b1, ln_partials_plain(h)) over the rows
    of every segment x (B, n_s, D) and its message (x's rows of D); h
    fp32 in either type."""
    d = xs[0].shape[-1]
    w1T = w["w1T"].float()
    h = (_rows(xs).float() @ w1T[:, :d].t()
         + _rows(msgs).float() @ w1T[:, d:].t() + w["b1"])
    return h, ln_partials_plain(h)


def tail_lin1(w: dict, xs: Sequence[torch.Tensor],
              msgs: Sequence[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    if xs[0].device.type == "cpu":
        return tail_lin1_plain(w, xs, msgs)
    return _lin1(check_block_weights(w, xs[0].shape[-1]), w, xs, msgs)


def _lin1(dev, w, xs, msgs):
    b, _, d = xs[0].shape
    _activations(dev, wtype(w), **{f"x{i}": x for i, x in enumerate(xs)},
                 **{f"msg{i}": m for i, m in enumerate(msgs)})
    if len(msgs) != len(xs) or any(m.shape[-1] != d or m.numel() != x.numel()
                                   for m, x in zip(msgs, xs)):
        raise ValueError("lin1 takes one message of its x's rows a segment")
    x0, x1, n0, n1 = _segment_args([aligned16(x) for x in xs])
    m0, m1, _, _ = _segment_args([aligned16(m) for m in msgs])
    rows = b * (n0 + n1)
    h = torch.empty(rows, 2 * d, device=dev)
    stats = torch.empty(rows, 2 * d // LN_PART, 2, device=dev)
    _build.launch(_build.typed("lg_tail_lin1", wtype(w)), dev, x0, x1, m0, m1,
                  w["w1T"], w["b1"], h, stats, b, n0, n1, d,
                  *_tile(dev, rows, 2 * d, wtype(w), "lin1"))
    return h, stats


def tail_lin2_plain(w: dict, h: torch.Tensor, stats: torch.Tensor,
                    xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Per segment x + GELU(LN(h)) W2 + b2, the LayerNorm from the merged
    partials; bf16 x: the hidden rounded before W2, the sum in fp32,
    rounded once."""
    mean, rstd = merge_stats_plain(stats)
    hn = (h - mean[:, None]) * rstd[:, None] * w["gamma"] + w["beta"]
    rows = _rows(xs)
    hid = nn.gelu(hn).to(rows.dtype).float()
    out = rows.float() + (hid @ w["w2T"].float().t() + w["b2"])
    return _segments(out.to(rows.dtype), xs)


def tail_lin2(w: dict, h: torch.Tensor, stats: torch.Tensor,
              xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    if xs[0].device.type == "cpu":
        return tail_lin2_plain(w, h, stats, xs)
    return _lin2(check_block_weights(w, xs[0].shape[-1]), w, h, stats, xs)


def _lin2(dev, w, h, stats, xs):
    b, _, d = xs[0].shape
    _activations(dev, torch.float32, h=h, stats=stats)
    _activations(dev, wtype(w), **{f"x{i}": x for i, x in enumerate(xs)})
    x0, x1, n0, n1 = _segment_args([aligned16(x) for x in xs])
    rows = b * (n0 + n1)
    if h.shape != (rows, 2 * d) or stats.shape != (rows, 2 * d // LN_PART, 2):
        raise ValueError(f"h and stats do not fit {rows} rows of D {d}")
    outs = [torch.empty_like(x) for x in xs]
    o0, o1, _, _ = _segment_args(outs)
    _build.launch(_build.typed("lg_tail_lin2", wtype(w)), dev, aligned16(h),
                  stats, w["gamma"], w["beta"], w["w2T"], w["b2"], x0, x1, o0,
                  o1, b, n0, n1, d, *_tile(dev, rows, d, wtype(w), "lin2"))
    return outs


def tail_chain_plain(w: dict, ctxs: Sequence[torch.Tensor],
                     xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Per segment x + FFN(cat[x, merge_heads(ctx) Wo + bo]), as the three
    launches compute it."""
    return ffn_chain_plain(w, xs, _segments(tail_out_proj_plain(w, ctxs), xs))


def tail_chain(w: dict, ctxs: Sequence[torch.Tensor],
               xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The tail's three launches on CUDA tensors, the plain version on CPU
    tensors."""
    if xs[0].device.type == "cpu":
        return tail_chain_plain(w, ctxs, xs)
    return launch_tail(check_block_weights(w, xs[0].shape[-1]), w, ctxs, xs)


def launch_tail(dev: torch.device, w: dict, ctxs: Sequence[torch.Tensor],
                xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``tail_chain``'s launches on weights that check_block_weights
    returned ``dev`` for."""
    return launch_ffn(dev, w, xs, _segments(_out_proj(dev, w, ctxs), xs))


def ffn_chain_plain(w: dict, xs: Sequence[torch.Tensor],
                    msgs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Per segment x + FFN(cat[x, msg]) as B4's two launches compute it."""
    return tail_lin2_plain(w, *tail_lin1_plain(w, xs, msgs), xs)


def launch_ffn(dev: torch.device, w: dict, xs: Sequence[torch.Tensor],
               msgs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """lin1 and lin2 over the rows of every segment x and its message, on
    weights that check_ffn_weights (or check_block_weights) returned ``dev``
    for: B4, and the last two launches of B5's and B6's tail."""
    h, stats = _lin1(dev, w, xs, msgs)
    return _lin2(dev, w, h, stats, xs)


# --- weights ---------------------------------------------------------------


def _own(t: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A contiguous tensor of its own (so 16-byte aligned) in ``dtype``
    (bf16: rounded to nearest)."""
    return t.to(dtype).clone(memory_format=torch.contiguous_format)


WEIGHT_DTYPES = (torch.float32, torch.bfloat16)


def ffn_weights(ffn: nn.Params, dtype: torch.dtype = torch.float32) -> dict:
    """lin1's and lin2's weights, K-major (one row per output channel),
    from the FFN {"lin1", "ln", "lin2"} as stored (in, out), each a tensor
    of its own; the matrices in ``dtype`` (bf16: the mp form), biases and
    the LayerNorm's fp32; ``ffn`` itself is left as it is."""
    if dtype not in WEIGHT_DTYPES:
        raise TypeError(f"the block and FFN kernels take {WEIGHT_DTYPES}, "
                        f"got {dtype}")
    return {
        "w1T": _own(ffn["lin1"]["w"].t(), dtype), "b1": _own(ffn["lin1"]["b"]),
        "gamma": _own(ffn["ln"]["scale"]), "beta": _own(ffn["ln"]["bias"]),
        "w2T": _own(ffn["lin2"]["w"].t(), dtype), "b2": _own(ffn["lin2"]["b"]),
    }


def wtype(w: dict) -> torch.dtype:
    """The type of a weights dict's launches: its matrices' (float32, or
    bf16 for the mp form)."""
    return w["w1T"].dtype


def tail_weights(out_proj: nn.Params, ffn: nn.Params,
                 dtype: torch.dtype = torch.float32) -> dict:
    """The tail's weights: the output projection {w (D, D), b} K-major and
    ``ffn_weights(ffn)``, the matrices in ``dtype``."""
    return {"woT": _own(out_proj["w"].t(), dtype), "bo": _own(out_proj["b"]),
            **ffn_weights(ffn, dtype)}


def _check_weights(w: dict, d: int, want: dict) -> torch.device:
    """Raise unless each w[k] has shape want[k] and all lie on one CUDA
    device as contiguous tensors, the 2-d ones of ``wtype(w)`` (float32
    or bf16), the 1-d ones float32, the 2-d ones and the LayerNorm's
    16-byte aligned; return the device."""
    if d not in DIMS:
        raise ValueError(f"the block and FFN kernels take D in {DIMS}, got "
                         f"{d}")
    if wtype(w) not in WEIGHT_DTYPES:
        raise TypeError(f"the block and FFN kernels take {WEIGHT_DTYPES}, "
                        f"got {wtype(w)}")
    for k, shape in want.items():
        if tuple(w[k].shape) != shape:
            raise ValueError(f"{k} must be {shape}, got {tuple(w[k].shape)}")
    dev = _build.check_cuda(
        dtype=wtype(w), **{k: w[k] for k in want if len(want[k]) == 2})
    if _build.check_cuda(**{k: w[k] for k in want if len(want[k]) == 1}) \
            != dev:
        raise ValueError(f"the biases are not on {dev}")
    for k in want:
        if (len(want[k]) == 2 or k in ("gamma", "beta")) \
                and w[k].data_ptr() % 16:  # read 16 bytes at a time
            raise ValueError(f"{k} is not 16-byte aligned")
    return dev


def _ffn_shapes(d: int) -> dict:
    return dict(w1T=(2 * d, 2 * d), b1=(2 * d,), gamma=(2 * d,),
                beta=(2 * d,), w2T=(d, 2 * d), b2=(d,))


def check_ffn_weights(w: dict, d: int) -> torch.device:
    """``check_block_weights`` for lin1 and lin2 alone (B4)."""
    return _check_weights(w, d, _ffn_shapes(d))


def check_block_weights(w: dict, d: int) -> torch.device:
    """Raise unless the block weights fit width ``d`` (head_dim in
    HEAD_DIMS) and lie on one CUDA device as contiguous float32; return the
    device."""
    h = w["num_heads"]
    if d % h or d // h not in HEAD_DIMS:
        raise ValueError(f"the block kernels take head_dim in {HEAD_DIMS}, "
                         f"got D {d}, {h} heads")
    if w["w_in"].shape[1:] != (d,):
        raise ValueError(f"w_in does not fit D {d}")
    return _check_weights(w, d, dict(w_in=tuple(w["w_in"].shape),
                                     b_in=tuple(w["w_in"].shape[:1]),
                                     woT=(d, d), bo=(d,), **_ffn_shapes(d)))
