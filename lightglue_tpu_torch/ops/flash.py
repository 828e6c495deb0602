"""Masked scaled dot-product attention: kernels K1 and B1' and their plain
versions, at head_dim 64 or 128.

Counterpart of lightglue_tpu/ops/flash.py::flash_sdpa: the exact variant
(``_attn_kernel_4d``, flash.py:94-217) and, with ``shift`` set, the
constant-shift variant (``_attn_kernel_shift``, flash.py:63-91); and of
``flash_cross_pair`` (flash.py:220-240), the exact bidirectional shared-QK
cross attention as two passes of that kernel with the roles swapped, which
the JAX matcher runs at head_dim 128. On CUDA tensors ``flash_sdpa`` and
``flash_cross_pair`` launch ``csrc/flash_sdpa.cu`` (B1' both directions in
one launch) through ``launch_attention``, or raise; on CPU tensors they run
their plain versions, the same functions in plain PyTorch.

``launch_attention`` also picks the key split (``split_plan``): when the
query tiles of a call would leave SMs idle, each tile's keys are walked by
S blocks whose states a second launch merges in split order.
``split_partial_plain`` and ``merge_splits_plain`` state that merge in
plain PyTorch; only the tests use them.

Under ``mp`` (bf16 q, k, v) K1 and B1' have bf16 forms at head_dim 64 and
128 (``lg_flash_sdpa_bf16``, ``lg_flash_cross_pair_bf16``): the TPU kernels
fed bf16 operands, q scaled in bf16, fp32 scores, softmax and sums, the
weights rounded to bf16 before P V, the output bf16 (``flash_sdpa_plain``
states it for bf16 inputs; B1' is two such walks, as the TPU pair is two
calls of flash_sdpa).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from .. import _build

NEG_INF = -1e30  # additive bias of a masked key
HEAD_DIMS = (64, 128)  # head_dims of the attention kernels (K1, B1', B5),
# fp32 and bf16
LOG2E = 1.4426950408889634  # exp(x) == exp2(x * LOG2E)
SHIFT_CLAMP = 100.0  # largest exp2 argument of the constant-shift softmax
MAX_SPLITS = 8  # key splits of one query tile
# Work of an SM running two blocks of the walk against one alone: 1.18 at
# head_dim 128 and 1.19-1.24 at 64 (scripts/attn_split.py, H100 SXM: the
# tile time per SM at B 16 against B 4 or B 1 without splits)
PAIR_RATE = 1.2


def key_bias(valid: torch.Tensor) -> torch.Tensor:
    """(B, N) bool -> float32 additive bias: 0 valid, -1e30 masked."""
    return (valid.float() - 1.0) * -NEG_INF


def shift_weights(s: torch.Tensor, shift2: float) -> torch.Tensor:
    """Constant-shift softmax weights of log2-domain scores:
    exp2(min(s - shift2, SHIFT_CLAMP)). No row maximum: a masked score
    (-1e30 bias) gives exactly 0."""
    return torch.exp2(torch.clamp(s - shift2, max=SHIFT_CLAMP))


def bf16_value(x: float) -> float:
    """x rounded to bf16 (nearest even), as a Python float."""
    return float(torch.tensor(x, dtype=torch.bfloat16))


def wide(t: torch.Tensor) -> torch.Tensor:
    """A bf16 tensor as fp32, the type the kernels sum in; any other type
    as it is."""
    return t.float() if t.dtype == torch.bfloat16 else t


def scaled(t: torch.Tensor, scale: float) -> torch.Tensor:
    """t * scale as the TPU kernels scale q, in t's type, as fp32 values:
    for a bf16 t the scale and the product each rounded to bf16 (nearest
    even)."""
    if t.dtype == torch.bfloat16:
        return (t.float() * bf16_value(scale)).to(t.dtype).float()
    return t * scale


def flash_sdpa_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_valid: Optional[torch.Tensor] = None,
    shift: Optional[float] = None,
) -> torch.Tensor:
    """softmax((q / sqrt(d)) k^T + key bias) v with an fp32 softmax; rows
    of a batch entry whose keys are all masked come out as 0.
    q (B, H, Nq, d); k, v (B, H, Nk, d); k_valid (B, Nk) bool.
    ``shift`` (nats): the constant-shift form, scale * log2(e) folded into
    q and e = exp2(min(s - shift * log2(e), 100)) in place of
    exp(s - max_j s); an all-masked row is 0 because every e is. bf16
    inputs (_attn_kernel_4d and _attn_kernel_shift fed bf16): q scaled in
    bf16, fp32 scores, softmax and row sums, the weights rounded to bf16
    before P V, a bf16 output."""
    dt = q.dtype
    scale = q.shape[-1] ** -0.5 * (1.0 if shift is None else LOG2E)
    s = scaled(q, scale) @ wide(k).transpose(-1, -2)
    if k_valid is not None:
        s = s + key_bias(k_valid)[:, None, None, :]
    if shift is not None:
        e = shift_weights(s, shift * LOG2E)
    else:
        e = torch.exp(s - s.amax(-1, keepdim=True))
    o = (wide(e.to(dt)) @ wide(v)) / torch.clamp(
        e.sum(-1, keepdim=True), min=1e-30)
    if k_valid is not None and shift is None:
        o = torch.where(k_valid.any(-1)[:, None, None, None], o,
                        torch.zeros_like(o))
    return o.to(dt)


def flash_sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_valid: Optional[torch.Tensor] = None,
    shift: Optional[float] = None,
) -> torch.Tensor:
    """K1 on CUDA tensors (fp32, or its bf16 form for bf16 q, k, v), the
    plain version on CPU tensors."""
    if q.device.type == "cpu":
        return flash_sdpa_plain(q, k, v, k_valid, shift)
    bf16 = q.dtype == torch.bfloat16
    dev = _build.check_cuda(dtype=q.dtype, q=q, k=k, v=v)
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_sdpa kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {d}")
    if k.shape != (b, h, nk, d) or v.shape != k.shape or nk < 1:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    scale = d ** -0.5 * (1.0 if shift is None else LOG2E)
    if bf16:  # the TPU kernels scale q by the scale in q's dtype
        scale = bf16_value(scale)
    o = torch.empty_like(q)
    launch_attention(dev, [(q, k, v, mask_arg(k_valid, (b, nk), dev), o)],
                     scale, None if shift is None else shift * LOG2E)
    _build.count(_build.typed(
        "flash_sdpa_shift" if shift is not None else "flash_sdpa", q.dtype, d))
    return o


def flash_cross_pair_plain(
    qk0: torch.Tensor,
    qk1: torch.Tensor,
    v0: torch.Tensor,
    v1: torch.Tensor,
    valid0: Optional[torch.Tensor] = None,
    valid1: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """m0 = attention(qk0, qk1, v1, valid1), m1 = attention(qk1, qk0, v0,
    valid0), both exact (flash_sdpa_plain). qk0, v0 (B, H, M, d); qk1, v1
    (B, H, N, d); valid0 (B, M), valid1 (B, N) bool. Rows of masked queries
    are not zeroed: callers read valid rows only."""
    return (flash_sdpa_plain(qk0, qk1, v1, valid1),
            flash_sdpa_plain(qk1, qk0, v0, valid0))


def flash_cross_pair(
    qk0: torch.Tensor,
    qk1: torch.Tensor,
    v0: torch.Tensor,
    v1: torch.Tensor,
    valid0: Optional[torch.Tensor] = None,
    valid1: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1' on CUDA tensors (both directions in one launch; its bf16 form
    for bf16 inputs), the plain version on CPU tensors."""
    if qk0.device.type == "cpu":
        return flash_cross_pair_plain(qk0, qk1, v0, v1, valid0, valid1)
    dev = _build.check_cuda(dtype=qk0.dtype, qk0=qk0, qk1=qk1, v0=v0, v1=v1)
    b, h, m, d = qk0.shape
    n = qk1.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_cross_pair kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    if (qk1.shape != (b, h, n, d) or v0.shape != qk0.shape
            or v1.shape != qk1.shape or m < 1 or n < 1):
        raise ValueError(
            f"bad shapes qk0 {tuple(qk0.shape)} qk1 {tuple(qk1.shape)} "
            f"v0 {tuple(v0.shape)} v1 {tuple(v1.shape)}")
    valid0 = mask_arg(valid0, (b, m), dev)
    valid1 = mask_arg(valid1, (b, n), dev)
    scale = d ** -0.5
    if qk0.dtype == torch.bfloat16:  # each TPU call scales q in bf16
        scale = bf16_value(scale)
    m0 = torch.empty_like(qk0)
    m1 = torch.empty_like(qk1)
    launch_attention(dev, [(qk0, qk1, v1, valid1, m0),
                           (qk1, qk0, v0, valid0, m1)], scale, None)
    _build.count(_build.typed("flash_cross_pair", qk0.dtype))
    return m0, m1


# --- the launch and its key split ----------------------------------------


def split_ranges(nk: int, splits: int, key_tile: int) -> List[Tuple[int, int]]:
    """The keys [k0, k1) of each split of a walk over ``nk`` keys in tiles
    of ``key_tile``: split s takes the tiles [s T / S, (s + 1) T / S) of T
    (attn_tc.cuh::split_begin)."""
    tiles = -(-nk // key_tile)
    if not 1 <= splits <= tiles:
        raise ValueError(f"{splits} splits of {tiles} key tiles")
    bounds = [s * tiles // splits * key_tile for s in range(splits + 1)]
    return [(lo, min(hi, nk)) for lo, hi in zip(bounds, bounds[1:])]


@functools.lru_cache(maxsize=1024)
def split_plan(walks: Tuple[Tuple[int, int], ...], sms: int,
               per_sm: int) -> Tuple[int, ...]:
    """Key splits of one launch: ``walks`` holds (blocks, key tiles) per
    direction (one for K1, two for B1'); the card has ``sms`` SMs, each
    holding ``per_sm`` blocks of the walk at once.

    A block of k key tiles costs about k + 1 tile times (its queries and
    its first tile arrive before any overlap). With S splits the blocks
    are spread over the SMs, ceil(blocks / SMs) an SM; where that is more
    than one, two resident blocks share an SM and together run PAIR_RATE
    times as fast as one alone. The launch costs the blocks an SM takes
    times the longest block, over that rate. S, the same for every
    direction but at most its key tiles and MAX_SPLITS, minimises that
    cost; ties go to the smaller S, so a grid that fills the card takes
    S 1."""
    def cost(s):
        per = [min(s, t) for _, t in walks]
        per_sm_blocks = -(-sum(n * p for (n, _), p in zip(walks, per)) // sms)
        longest = max(-(-t // p) for (_, t), p in zip(walks, per)) + 1
        rate = PAIR_RATE if per_sm_blocks > 1 and per_sm > 1 else 1.0
        return per_sm_blocks * longest / rate

    top = min(MAX_SPLITS, max(t for _, t in walks))
    best = min(range(1, top + 1), key=lambda s: (cost(s), s))
    return tuple(min(best, t) for _, t in walks)


class WalkShape(NamedTuple):
    """The walk's own tile and occupancy on a card, and the card's SMs:
    64 query rows and 64 or 32 keys a block for the fp32 walk
    (csrc/attn_tc.cuh), 128 and 64 for the bf16 one (csrc/attn_wgmma.cuh)."""
    key_tile: int
    per_sm: int  # blocks an SM holds at once
    sms: int
    query_rows: int


@functools.lru_cache(maxsize=None)
def walk_shape(index: int, d: int, dtype: torch.dtype = torch.float32
               ) -> WalkShape:
    """The walk's shape in ``dtype`` (fp32, or its bf16 form) at head_dim
    ``d`` on CUDA device ``index``, as the kernel reports it."""
    key_tile, per_sm, rows = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    dev = torch.device("cuda", index)
    _build.launch(_build.typed("lg_attention_shape", dtype), dev, d,
                  ctypes.byref(key_tile), ctypes.byref(per_sm),
                  ctypes.byref(rows))
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return WalkShape(key_tile.value, per_sm.value, sms, rows.value)


def walk_grid(bh: int, nq: int, nk: int, shape: WalkShape
              ) -> Tuple[int, int]:
    """(blocks, key tiles) of one walk over ``bh`` (batch, head) pairs of
    ``nq`` queries and ``nk`` keys: a block takes ``shape.query_rows``
    queries, and walks the keys in tiles of ``shape.key_tile``."""
    return bh * -(-nq // shape.query_rows), -(-nk // shape.key_tile)


def planned_splits(walks) -> Tuple[int, ...]:
    """``split_plan`` for the walks of one launch (each (q, k, ...) on one
    CUDA device), from the card's own walk shape."""
    q = walks[0][0]
    shape = walk_shape(q.device.index, q.shape[-1], q.dtype)
    return split_plan(tuple(
        walk_grid(q.shape[0] * q.shape[1], w[0].shape[2], w[1].shape[2],
                  shape) for w in walks), shape.sms, shape.per_sm)


def mask_arg(valid: Optional[torch.Tensor], shape: Tuple[int, int],
             dev: torch.device) -> Optional[torch.Tensor]:
    """A key mask as the walk takes it (contiguous bool, True = valid), or
    None; raise unless it is bool of ``shape`` on ``dev``."""
    if valid is None:
        return None
    if (valid.dtype != torch.bool or valid.device != dev
            or tuple(valid.shape) != shape):
        raise ValueError(f"key mask must be bool {shape} on {dev}, got "
                         f"{valid.dtype} {tuple(valid.shape)} on "
                         f"{valid.device}")
    return valid.contiguous()


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it when its data is not 16-byte aligned (the walk
    and the tile product copy rows 16 bytes at a time, TMA whole tiles)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check_tma(name: str, t: torch.Tensor) -> None:
    """Raise unless TMA can read ``t`` as the bf16 kernels' tensor maps
    do: a contiguous bf16 tensor whose address and rows (its last
    dimension's bytes) are multiples of 16 bytes."""
    if t.dtype != torch.bfloat16 or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous bf16 for TMA")
    if t.data_ptr() % 16 or (t.shape[-1] * t.element_size()) % 16:
        raise ValueError(f"{name} is not 16-byte aligned (address "
                         f"{t.data_ptr():#x}, rows of {t.shape[-1]})")


def launch_attention(dev: torch.device, walks, scale: float,
                     shift2: Optional[float],
                     splits: Optional[Sequence[int]] = None) -> None:
    """Launch K1's walk (one walk) or B1' (two, the directions) on
    checked CUDA tensors. Each walk is (q, k, v, key mask or None, out),
    q and out (B, H, Nq, d), k and v (B, H, Nk, d); queries scaled by
    ``scale``; ``shift2`` (K1 only) selects the constant-shift form. The
    key splits follow ``split_plan`` (``splits``: a study's candidates);
    the scratch of a split walk is allocated here. bf16 walks launch the
    bf16 form; their scratch stays fp32."""
    b, h, _, d = walks[0][0].shape
    dt = walks[0][0].dtype
    key_tile = walk_shape(walks[0][0].device.index, d, dt).key_tile
    if splits is None:
        splits = planned_splits(walks)
    walks = [(aligned16(q), aligned16(k), aligned16(v), valid, o)
             for q, k, v, valid, o in walks]
    if dt == torch.bfloat16:
        for i, (q, k, v, _, o) in enumerate(walks):
            for name, t in (("q", q), ("k", k), ("v", v)):
                check_tma(f"{name}{i}", t)
    scratch = []
    for (q, k, *_), s in zip(walks, splits):
        split_ranges(k.shape[2], s, key_tile)  # raises unless 1 <= s <= T
        rows = b * h * q.shape[2]
        scratch += ([torch.empty(s, rows, d, device=dev),
                     torch.empty(s, rows, 2, device=dev)] if s > 1
                    else [None, None])
    if len(walks) == 1:
        q, k, v, valid, o = walks[0]
        _build.launch(_build.typed("lg_flash_sdpa", dt), dev, q, k, v,
                      valid, o, *scratch, b, h,
                      q.shape[2], k.shape[2], d, int(shift2 is not None),
                      splits[0], float(scale), float(shift2 or 0.0))
    else:
        (qk0, qk1, v1, valid1, m0), (_, _, v0, valid0, m1) = walks
        _build.launch(_build.typed("lg_flash_cross_pair", dt), dev, qk0, qk1, v0, v1, valid0,
                      valid1, m0, m1, *scratch, b, h, qk0.shape[2],
                      qk1.shape[2], d, *splits, float(scale))


def split_partial_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_valid: Optional[torch.Tensor] = None,
    shift: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The state one key split of the walk leaves, in plain PyTorch:
    (unnormalised output (B, H, Nq, d), row max, row sum (B, H, Nq)). The
    row max is -inf for a batch entry with no valid key in the split (exact)
    and 0 with a shift, where it is not used."""
    scale = q.shape[-1] ** -0.5 * (1.0 if shift is None else LOG2E)
    s = (q * scale) @ k.transpose(-1, -2)
    if k_valid is not None:
        s = s + key_bias(k_valid)[:, None, None, :]
    if shift is not None:
        e = shift_weights(s, shift * LOG2E)
        return e @ v, torch.zeros_like(s[..., 0]), e.sum(-1)
    m = s.amax(-1)
    e = torch.exp(s - m[..., None])
    if k_valid is not None:
        m = torch.where(k_valid.any(-1)[:, None, None], m,
                        torch.full_like(m, -math.inf))
    return e @ v, m, e.sum(-1)


def merge_splits_plain(states, shift: Optional[float] = None) -> torch.Tensor:
    """attn_tc.cuh::merge_splits in plain PyTorch: the split states
    (split_partial_plain's) summed in order with weights exp(m_s - max m)
    (exact; rows whose every m_s is -inf come out 0) or 1 (shift)."""
    if shift is not None:
        o = sum(st[0] for st in states)
        l = sum(st[2] for st in states)
        return o / torch.clamp(l, min=1e-30)[..., None]
    mx = torch.stack([st[1] for st in states]).amax(0)
    empty = mx == -math.inf
    mx = torch.where(empty, torch.zeros_like(mx), mx)
    o, l = 0.0, 0.0
    for st in states:
        w = torch.exp(st[1] - mx)
        o = o + w[..., None] * st[0]
        l = l + w * st[2]
    o = o / torch.clamp(l, min=1e-30)[..., None]
    return torch.where(empty[..., None], torch.zeros_like(o), o)
