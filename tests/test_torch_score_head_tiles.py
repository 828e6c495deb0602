"""ALIKED's score-head tail on register micro-tiles (B11 and B12,
csrc/score_head.cu) on the CPU, at small sizes, on seeded numpy inputs.

- The kernel's decomposition in plain PyTorch, block by block at the tile
  and micro-tiles read from score_head.cu: the SELU(s0) plane of one input
  channel at a time on the tile with its 3-pixel ring, 0 outside the image
  (B11: each branch's window of the ring staged, lerped along rows for
  every ring row, then along columns per pixel and added to s1, with the
  lerp rows and columns in double as ``lerp_of`` computes them); conv 8->4
  as each thread's R1 x 2 micro-tile summed over the channels in turn,
  every input row read at the micro-tile's own offsets; SELU into stage 1,
  the 4-channel convs from the staged stages likewise, the sigmoid. Against
  ``score_tail_plain`` / ``score_head_lazy_plain`` (1e-6 of max(1, max
  |reference|)) and the JAX package (1e-5): the Pallas kernels in
  interpret mode, the composed JAX path where a branch dimension is 1.
- The staged branch windows hold every row and column any pixel of a tile
  and its ring lerps from, at 768 x 1024, ragged sizes and branch
  dimensions of 1, within the capacity the launch computes.
- The grid and the micro-tiles: every output written once, every stage's
  staged array covered once, every read inside the staged arrays.
- Shared memory a block and blocks an SM; the prepared weight parameter's
  order, bit for bit against the convs; its once-per-tree cache.
"""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu import weights as jweights
from lightglue_tpu.configs import ALIKEDConfig as JALIKEDConfig
from lightglue_tpu.models import aliked as jal
from lightglue_tpu.ops.score_head import (
    score_head_pallas_cplane, score_head_pallas_lazy)
from lightglue_tpu_torch import configs, weights
from lightglue_tpu_torch.ops import score_head
from lightglue_tpu_torch.ops.sampling import upsample

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False

SRC = (Path(__file__).resolve().parents[1] / "lightglue_tpu_torch" / "csrc"
       / "score_head.cu").read_text()
SMEM_SM = 233472  # bytes of shared memory an H100 SM holds (228 KB)
ALPHA, SCALE = 1.6732632423543772848170429916717, 1.0507009873554804934193349852946
NT = int(re.search(r"constexpr int NT = (\d+);", SRC).group(1))
BLOCKS_SM = int(re.search(r"constexpr int kBlocksSM = (\d+);", SRC).group(1))
TILE = tuple(int(v) for v in re.search(
    r"using Tile = ScoreTile<(\d+), (\d+), (\d+), (\d+), (\d+)>;", SRC).groups())
TH, TW, R1, R2, R3 = TILE
PH, PW, H1, W1, H2, W2 = TH + 6, TW + 6, TH + 4, TW + 4, TH + 2, TW + 2
# B11's head of region B: lerp rows and columns (3 words each), 3 windows' places
TABLES = (9 * (PH + PW) + 18 + 3) & ~3
REGION_A = max(2 * PH * PW, 4 * H2 * W2)
STAGE1 = 4 * H1 * W1
_jax_init = jax.jit(jal.init_params, static_argnums=1)


def _tail_params(seed):
    """The score head's three convs at the init's scale, as (JAX tree, port
    tree)."""
    conf = JALIKEDConfig(model_name="aliked-n16")
    flat = {k: np.asarray(v) for k, v in jweights.flatten_tree(
        _jax_init(jax.random.key(seed), conf)).items()}
    jp = jweights.unflatten_tree(flat)
    tp = weights.aliked_from_jax_params(
        flat, configs.ALIKEDConfig(model_name="aliked-n16"))
    return jp["score_head"], tp["score_head"]


def _parts(seed, b, h, w):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, 8, max(1, h // f), max(1, w // f)))
            .astype(np.float32) for f in (1, 2, 8, 32)]


# --- lerp_of and the windows --------------------------------------------------------


def lerp_of(g, n, nk):
    """score_head.cu's lerp_of: (i0, i1, weight of i1), the coordinate in
    double, the weight rounded to fp32."""
    c = 0.0 if n == 1 else float(nk - 1) if g == n - 1 else g * ((nk - 1) / (n - 1))
    f = math.floor(c)
    return int(f), min(int(f) + 1, nk - 1), float(np.float32(c - f))


def window_extent(n, nk, tile):
    """score_head.cu's window_extent: the most branch rows (of nk) a tile of
    `tile` outputs with its 3-pixel ring lerps from."""
    most = 1
    for i in range(-(-n // tile)):
        a = lerp_of(min(max(i * tile - 3, 0), n - 1), n, nk)[0]
        e = lerp_of(min(max(i * tile + tile + 2, 0), n - 1), n, nk)[1]
        most = max(most, e - a + 1)
    return most


def _axis(start, count, n, nk):
    """The lerps of `count` ring positions from `start`, clamped into the
    image as the kernel clamps them; (lo, i0 - lo, i1 - lo, weights)."""
    ls = [lerp_of(min(max(start + j, 0), n - 1), n, nk) for j in range(count)]
    lo = ls[0][0]
    return (lo, torch.tensor([e[0] - lo for e in ls]),
            torch.tensor([e[1] - lo for e in ls]),
            torch.tensor([e[2] for e in ls], dtype=torch.float32), ls[-1][1] - lo + 1)


# --- the decomposition ----------------------------------------------------------


def selu_exp(x):
    """The kernel's SELU: the exp form on the negative side."""
    return torch.where(x > 0, SCALE * x,
                       SCALE * ALPHA * torch.exp(torch.clamp(x, max=0)) - SCALE * ALPHA)


def _micro_tiles(rows, cols, r):
    """A stage's micro-tiles (band, column pair), in thread order."""
    n = rows // r * (cols // 2)
    p = torch.arange(n)
    return p // (cols // 2), p % (cols // 2)


def conv_micro(x, w, band, mc, r, co):
    """Micro-tiles of R rows x 2 columns over the staged input x (CI, HI,
    WI): each reads input rows R band .. + R + 1, columns 2 mc .. + 3, and
    sums w[ci, tap, co] x input over the taps. Returns (N, R, 2, CO)."""
    rows = band[:, None] * r + torch.arange(r + 2)
    cols = 2 * mc[:, None] + torch.arange(4)
    assert int(rows.max()) < x.shape[1] and int(cols.max()) < x.shape[2]
    win = x[:, rows[:, :, None], cols[:, None, :]]  # (CI, N, R + 2, 4)
    acc = x.new_zeros(len(band), r, 2, co)
    for dy in range(3):
        for dx in range(3):
            acc += torch.einsum("cnrj,co->nrjo", win[:, :, dy:dy + r, dx:dx + 2],
                                w[:, dy * 3 + dx, :])
    return acc


def store_micro(acc, band, mc, r, shape, gy0, gx0, h, w, act):
    """The micro-tiles' outputs into a staged stage (CO, rows, cols), act()
    where the pixel (gy0 + row, gx0 + col) lies in the image, else 0; every
    entry written once."""
    out = acc.new_full(shape, float("nan"))
    seen = torch.zeros(shape[1:], dtype=torch.int64)
    for n in range(len(band)):
        ys = int(band[n]) * r + torch.arange(r)
        xs = 2 * int(mc[n]) + torch.arange(2)
        inside = (((gy0 + ys >= 0) & (gy0 + ys < h))[:, None]
                  & ((gx0 + xs >= 0) & (gx0 + xs < w))[None, :])
        out[:, ys[:, None], xs[None, :]] = torch.where(
            inside, act(acc[n].permute(2, 0, 1)), 0.0)
        seen[ys[:, None], xs[None, :]] += 1
    assert (seen == 1).all()
    return out


def plane_cplane(s0, b, ci, y0, x0):
    """SELU(s0) of channel ci on the tile's ring, 0 outside the image."""
    h, w = s0.shape[2:]
    ys, xs = torch.arange(y0 - 3, y0 - 3 + PH), torch.arange(x0 - 3, x0 - 3 + PW)
    inside = ((ys >= 0) & (ys < h))[:, None] & ((xs >= 0) & (xs < w))[None, :]
    v = s0[b, ci][ys.clamp(0, h - 1)[:, None], xs.clamp(0, w - 1)[None, :]]
    return torch.where(inside, selu_exp(v), 0.0)


def plane_lazy(parts, b, ci, y0, x0):
    """B11's staging of channel ci: each branch's window, its lerp along
    rows for every ring row, the column lerps of each pixel added to s1 in
    branch order, SELU; 0 outside the image."""
    s1 = parts[0]
    h, w = s1.shape[2:]
    ys, xs = torch.arange(y0 - 3, y0 - 3 + PH), torch.arange(x0 - 3, x0 - 3 + PW)
    inside = ((ys >= 0) & (ys < h))[:, None] & ((xs >= 0) & (xs < w))[None, :]
    v = s1[b, ci][ys.clamp(0, h - 1)[:, None], xs.clamp(0, w - 1)[None, :]]
    for sk in parts[1:]:
        hk, wk = sk.shape[2:]
        ylo, r0, r1, wy, nr = _axis(y0 - 3, PH, h, hk)
        xlo, c0, c1, wx, nc = _axis(x0 - 3, PW, w, wk)
        assert nr <= window_extent(h, hk, TH) and nc <= window_extent(w, wk, TW)
        win = sk[b, ci, ylo:ylo + nr, xlo:xlo + nc]
        assert win.shape == (nr, nc)
        a, c = win[r0], win[r1]
        rows = a + wy[:, None] * (c - a)  # (PH, nc)
        a, c = rows[:, c0], rows[:, c1]
        v = v + (a + wx[None, :] * (c - a))
    return torch.where(inside, selu_exp(v), 0.0)


def tail_decomposed(sh, x, lazy):
    """B11 (x the four parts) or B12 (x = s0) tile by tile; (B, H, W)."""
    wt = score_head.prepare(sh)
    w1 = wt[:288].reshape(8, 9, 4)
    w2 = wt[288:432].reshape(4, 9, 4)
    w3 = wt[432:].reshape(4, 9, 1)
    s = x[0] if lazy else x
    bsz, _, h, w = s.shape
    out = torch.full((bsz, h, w), float("nan"))
    b1, m1 = _micro_tiles(H1, W1, R1)
    b2, m2 = _micro_tiles(H2, W2, R2)
    b3, m3 = _micro_tiles(TH, TW, R3)
    assert len(b1) <= NT
    for b in range(bsz):
        for y0 in range(0, h, TH):
            for x0 in range(0, w, TW):
                acc = torch.zeros(len(b1), R1, 2, 4)
                for ci in range(8):  # conv 8->4 streams its input channels
                    p = (plane_lazy(x, b, ci, y0, x0) if lazy
                         else plane_cplane(x, b, ci, y0, x0))
                    acc += conv_micro(p[None], w1[ci:ci + 1], b1, m1, R1, 4)
                st1 = store_micro(acc, b1, m1, R1, (4, H1, W1), y0 - 2, x0 - 2,
                                  h, w, selu_exp)
                acc = conv_micro(st1, w2, b2, m2, R2, 4)
                st2 = store_micro(acc, b2, m2, R2, (4, H2, W2), y0 - 1, x0 - 1,
                                  h, w, selu_exp)
                acc = conv_micro(st2, w3, b3, m3, R3, 1)
                st3 = store_micro(acc, b3, m3, R3, (1, TH, TW), y0, x0,
                                  TH + y0, TW + x0, torch.sigmoid)
                hh, ww = min(TH, h - y0), min(TW, w - x0)
                out[b, y0:y0 + hh, x0:x0 + ww] = st3[0, :hh, :ww]
    return out


def _rel(got, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - ref).max()
                 / max(1.0, np.abs(ref).max()))


@jax.jit
def _jax_lazy_composed(jsh, nhwc):
    """The composed JAX score head (models/aliked.py::_dense_branches): the
    parts upsampled and summed, then the tapmat tail."""
    from lightglue_tpu import nn as jnn
    s0 = nhwc[0]
    for si, f in zip(nhwc[1:], (2, 8, 32)):
        s0 = s0 + jal._upsample(si, f)
    s = jal.selu(s0)
    for name in ("2", "4"):
        s = jal.selu(jnn.conv2d_tapmat(jsh[name], s))
    return jax.nn.sigmoid(jnn.conv2d_tapmat(jsh["6"], s))[..., 0]


@pytest.mark.parametrize("shape, jax_ref", [
    ((1, 24, 40), "pallas"), ((1, 40, 72), None), ((2, 64, 96), None),
    ((1, 50, 34), None)])
def test_cplane_decomposition_vs_plain_and_jax(shape, jax_ref):
    jsh, tsh = _tail_params(4)
    s0 = np.random.default_rng(5).standard_normal((shape[0], 8, *shape[1:])
                                                  ).astype(np.float32)
    got = tail_decomposed(tsh, torch.from_numpy(s0), lazy=False)
    ref = score_head.score_tail_plain(tsh, torch.from_numpy(s0))
    assert got.shape == ref.shape and _rel(got, ref) <= 1e-6
    if jax_ref:
        want = score_head_pallas_cplane(jsh, jnp.asarray(s0), mp=False,
                                        tile_rows=64, interpret=True)
        assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("shape, jax_ref", [
    ((1, 64, 96), "pallas"), ((2, 40, 72), None), ((1, 32, 96), "composed"),
    ((1, 96, 32), "composed")])
def test_lazy_decomposition_vs_plain_and_jax(shape, jax_ref):
    """Ragged tiles, a batch of 2; H or W = 32 leaves the coarsest branch
    one row or column, held against the composed JAX path (the JAX lazy
    kernel clamps it to a row that does not exist)."""
    jsh, tsh = _tail_params(6)
    parts = _parts(7, *shape)
    got = tail_decomposed(tsh, [torch.from_numpy(p) for p in parts], lazy=True)
    ref = score_head.score_head_lazy_plain(tsh, *map(torch.from_numpy, parts))
    assert got.shape == ref.shape and _rel(got, ref) <= 1e-6
    if jax_ref == "pallas":
        want = score_head_pallas_lazy(jsh, *map(jnp.asarray, parts), mp=False,
                                      interpret=True)
    elif jax_ref == "composed":
        want = _jax_lazy_composed(jsh, [jnp.asarray(p.transpose(0, 2, 3, 1))
                                        for p in parts])
    else:
        return
    assert _rel(got, want) <= 1e-5


# --- lerps and windows ---------------------------------------------------------


@pytest.mark.parametrize("n, nk", [(768, 384), (768, 96), (768, 24), (1024, 512),
                                   (1024, 128), (1024, 32), (40, 20), (61, 7),
                                   (32, 1), (1, 1)])
def test_lerp_of_is_upsample_bit_for_bit(n, nk):
    """The kernel's rows and weights are ops/sampling.py::upsample's."""
    pos = torch.linspace(0.0, nk - 1.0, n, dtype=torch.float64)
    i0 = pos.floor().long()
    i1, wt = (i0 + 1).clamp(max=nk - 1), (pos - i0).float()
    got = [lerp_of(g, n, nk) for g in range(n)]
    assert [e[0] for e in got] == i0.tolist() and [e[1] for e in got] == i1.tolist()
    assert torch.equal(torch.tensor([e[2] for e in got]), wt)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 1, nk, 3)).astype(np.float32))
    up = upsample(x, (n, 3))[0, 0]
    a, c = x[0, 0, i0], x[0, 0, i1]
    assert torch.allclose(up, a + wt[:, None] * (c - a), atol=1e-6, rtol=0)


@pytest.mark.parametrize("h, w", [(768, 1024), (40, 72), (61, 83), (32, 96),
                                  (96, 32), (32, 32), (7, 5), (1, 1)])
def test_windows_cover_every_lerp(h, w):
    """Every tile: the window from the first ring row's i0 to the last
    one's i1 holds every row any ring row lerps from, within the launch's
    capacity (window_extent); at 768 x 1024 B11's tables, windows and row
    lerps fit in stage 1's space, so it takes no more shared memory than
    B12."""
    need = TABLES
    for f in (2, 8, 32):
        hk, wk = max(1, h // f), max(1, w // f)
        cap_r, cap_c = window_extent(h, hk, TH), window_extent(w, wk, TW)
        for n, nk, tile, cap in ((h, hk, TH, cap_r), (w, wk, TW, cap_c)):
            for i in range(-(-n // tile)):
                ls = [lerp_of(min(max(i * tile - 3 + j, 0), n - 1), n, nk)
                      for j in range(tile + 6)]
                lo, hi = ls[0][0], ls[-1][1]
                assert all(lo <= e[0] <= e[1] <= hi for e in ls)
                assert 0 <= lo and hi < nk and hi - lo + 1 <= cap
        need += cap_r * cap_c + PH * cap_c
    if (h, w) == (768, 1024):
        assert need <= STAGE1


# --- the grid, the micro-tiles and shared memory -----------------------------------


@pytest.mark.parametrize("hw", [(768, 1024), (40, 72), (61, 83), (7, 5), (1, 1),
                                (96, 32)])
def test_every_output_written_once(hw):
    """The grid (cdiv(W, TW), cdiv(H, TH)) and conv 3's micro-tiles (R3 rows
    x 2 columns), masked to the image."""
    h, w = hw
    seen = np.zeros((h, w), np.int64)
    band, mc = _micro_tiles(TH, TW, R3)
    for y0 in range(0, -(-h // TH) * TH, TH):
        for x0 in range(0, -(-w // TW) * TW, TW):
            for n in range(len(band)):
                for r in range(R3):
                    gy = y0 + int(band[n]) * R3 + r
                    for j in range(2):
                        gx = x0 + 2 * int(mc[n]) + j
                        if gy < h and gx < w:
                            seen[gy, gx] += 1
    assert (seen == 1).all()


def test_micro_tiles_cover_each_stage_once_and_read_inside():
    """Each stage's micro-tiles cover its staged array once (store_micro
    checks it), read only inside their input and, for conv 8->4, fit one a
    thread; the staging groups cover the plane's columns and rows."""
    for rows, cols, r, (hi, wi) in ((H1, W1, R1, (PH, PW)), (H2, W2, R2, (H1, W1)),
                                    (TH, TW, R3, (H2, W2))):
        band, mc = _micro_tiles(rows, cols, r)
        assert rows % r == 0 and cols % 2 == 0
        assert int(band.max()) * r + r + 1 < hi and 2 * int(mc.max()) + 3 < wi
        store_micro(torch.zeros(len(band), r, 2, 1), band, mc, r,
                    (1, rows, cols), 0, 0, rows, cols, lambda v: v)
    assert H1 // R1 * (W1 // 2) <= NT
    groups = NT // PW
    assert groups >= 1 and -(-PH // groups) * groups >= PH
    # float2 reads and stores: every pitch and plane even
    assert PW % 2 == 0 and W1 % 2 == 0 and W2 % 2 == 0 and REGION_A % 4 == 0


def test_shared_memory_and_blocks_per_sm():
    """Region A (two SELU(s0) planes, then stage 2) and region B (stage 1,
    and before it B11's tables, windows and row lerps), no static shared
    memory, and the runtime's 1 KB a block: four blocks an SM, as
    __launch_bounds__ asks."""
    assert "__launch_bounds__(NT, kBlocksSM)" in SRC
    assert BLOCKS_SM >= 4
    assert "__shared__" not in SRC.split("score_head_kernel(", 1)[1].split("extern", 1)[0]
    per_block = (REGION_A + STAGE1) * 4 + 1024
    assert BLOCKS_SM * per_block <= SMEM_SM
    # the halo recompute of the three convs, against 1.20 for 32 x 32 tiles
    work = (H1 * W1 * 288 + H2 * W2 * 144 + TH * TW * 36) / (TH * TW * 468)
    assert work < 1.20


# --- prepared weights -------------------------------------------------------------


def test_prepare_order_bit_for_bit():
    _, tsh = _tail_params(2)
    wt = score_head.prepare(tsh)
    assert wt.shape == (468,) and wt.device.type == "cpu" and wt.is_contiguous()
    off = 0
    for name, cin, cout in score_head.TAIL:
        conv = tsh[name]["w"]  # (co, ci, 3, 3)
        for ci in range(cin):
            for tap in range(9):
                for co in range(cout):
                    got = wt[off + (ci * 9 + tap) * cout + co]
                    assert got.view(torch.int32) == conv[co, ci, tap // 3, tap % 3].view(
                        torch.int32)
        off += 9 * cin * cout
    assert off == 468


def test_prepared_is_built_once_per_tree():
    _, tsh = _tail_params(3)
    first = score_head.prepared(tsh)
    assert score_head.prepared(tsh) is first
    other = dict(tsh, **{"4": {"w": tsh["4"]["w"].clone()}})
    again = score_head.prepared(other)  # the same conv "2", another "4"
    assert again is not first and torch.equal(again, first)
    assert score_head.prepared(other) is again
    with pytest.raises(ValueError, match="without bias"):
        score_head.prepare(dict(tsh, **{"6": {"w": tsh["6"]["w"], "b": torch.zeros(1)}}))
