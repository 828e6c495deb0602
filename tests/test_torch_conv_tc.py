"""The implicit-GEMM 3x3 convolution behind B7 and B8 (csrc/conv_tc.cuh) on
the CPU, at small sizes, on seeded numpy inputs.

- The kernel's decomposition in plain PyTorch (per block: the input tile
  staged with a 1-pixel ring that is 0 outside the map, conv1a computed from
  the image tile and 0 outside the image, nine per-tap products in the
  kernel's group-major K order, bias + ReLU, the 2x2 pool over the m16
  tiles' 2 x 8 patches; B8 as two launches) against ``fused_stem_plain`` /
  ``fused_block2_plain`` (1e-6) and JAX's ``fused_stem_pallas`` /
  ``fused_block2_pallas`` in interpret mode (1e-5), both relative to
  max(1, max |reference|): the outputs reach about 5, where fp32 sums over
  K = 576 in another order are a few 1e-7 relative apart.
- tc.cuh's 3xTF32 split, emulated bit for bit on the prepared weights, at
  K = 576: within 1e-6 of float64 where one tf32 pass misses chip_smoke.py's
  CONV_TOL.
- The tile grid, read from conv_tc.cuh: every pooled (and full-resolution)
  output written exactly once, fragment reads inside the staged tile and
  on distinct banks.
- ``prepare_conv``'s layout and ``prepared_conv``'s cache.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lightglue_tpu import nn as jnn
from lightglue_tpu import weights as jweights
from lightglue_tpu.models import superpoint as jsp
from lightglue_tpu.ops.stem import fused_stem_pallas
from lightglue_tpu.ops.stem2 import fused_block2_pallas
from lightglue_tpu_torch import weights
from lightglue_tpu_torch.ops import stem, stem2

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False

GAIN = 3.0  # models.superpoint.init_params: the stand-in for trained weights
CONV_TOL = 1e-4  # chip_smoke.py's bound, relative to max(1, max |plain|)
HEADER = (Path(__file__).resolve().parents[1] / "lightglue_tpu_torch" / "csrc"
          / "conv_tc.cuh").read_text()
SMEM_MAX = 232448  # bytes of shared memory a block may take on an H100


def _tile(name):
    m = re.search(rf"using {name} = Tile<(\d+), (\d+), (\d+), (\d+)>;", HEADER)
    return tuple(int(v) for v in m.groups())


STEM_TILE, MAP_TILE = _tile("StemTile"), _tile("MapTile")


@pytest.fixture(scope="module")
def both_params():
    flat = jweights.flatten_tree(jsp.init_params(jax.random.key(0)))
    flat = {k: np.asarray(v) * (GAIN if k.endswith("/w") else 1.0)
            for k, v in flat.items()}
    return (jweights.unflatten_tree(flat),
            weights.superpoint_from_jax_params(flat))


# --- the decomposition --------------------------------------------------------


def _patch_order(th, tw):
    """Pixel index (row * tw + col) of m16 tile i's row r, in the kernel's
    order: tile i = 2 warp + mt is the 2 x 8 patch at rows 2 (i // (tw /
    8)) .., cols 8 (i % (tw / 8)) ..; rows 0-7 the upper pixel row."""
    mtw = tw // 8
    return torch.tensor([(2 * (i // mtw) + r // 8) * tw + 8 * (i % mtw) + r % 8
                         for i in range(th * tw // 16) for r in range(16)])


def _staged(x, y0, x0, th, tw):
    """x (C, H, W) at rows y0 - 1 .. y0 + th, cols x0 - 1 .. x0 + tw, 0
    outside the map."""
    return F.pad(x, (1, tw + 1, 1, th + 1))[:, y0:y0 + th + 2, x0:x0 + tw + 2]


def _conv1a_tile(p, img, y0, x0, th, tw):
    """conv1a + ReLU at the staged tile's positions from the image tile
    (rows y0 - 2 ..), 0 where the position lies outside the image."""
    _, h, w = img.shape
    it = F.pad(img, (2, tw + 2, 2, th + 2))[:, y0:y0 + th + 4, x0:x0 + tw + 4]
    a = torch.relu(F.conv2d(it[None], p["w"], p["b"]))[0]
    ys = torch.arange(y0 - 1, y0 + th + 1)[:, None]
    xs = torch.arange(x0 - 1, x0 + tw + 1)[None, :]
    return a * ((ys >= 0) & (ys < h) & (xs >= 0) & (xs < w))


def conv_tc_decomposed(p, x, pool, tile, conv1a=None):
    """One launch of conv_tc_kernel in plain PyTorch: x (B, 64, H, W), or
    with conv1a the (B, 1, H, W) image; p the 64 -> 64 conv."""
    th, tw, nq, _ = tile
    qc = 64 // nq
    n, _, h, w = x.shape
    wt = p["w"].permute(2, 3, 0, 1).reshape(9, 64, 64)  # [tap][co][ci]
    order = _patch_order(th, tw)
    out = x.new_zeros(n, 64, h + th, w + tw)  # cut to (h, w) at the end
    for b in range(n):
        for y0 in range(0, h, th):
            for x0 in range(0, w, tw):
                st = (_conv1a_tile(conv1a, x[b], y0, x0, th, tw)
                      if conv1a is not None else _staged(x[b], y0, x0, th, tw))
                acc = x.new_zeros(th * tw, 64)
                for q in range(nq):  # group-major: (group, tap, chunk)
                    for tap in range(9):
                        dy, dx = divmod(tap, 3)
                        a = st[q * qc:(q + 1) * qc, dy:dy + th, dx:dx + tw]
                        acc += (a.reshape(qc, -1).t()[order]
                                @ wt[tap, :, q * qc:(q + 1) * qc].t())
                acc = torch.relu(acc + p["b"])  # (m16 tiles x 16, 64)
                if pool:  # rows g and g + 8, then lanes g and g ^ 1
                    m = acc.reshape(-1, 2, 8, 64).amax(1)
                    m = m.reshape(-1, 4, 2, 64).amax(2)  # (tile, col, co)
                    tiles = m.reshape(th // 2, tw // 8, 4, 64)
                    out[b, :, y0 // 2:y0 // 2 + th // 2,
                        x0 // 2:x0 // 2 + tw // 2] = \
                        tiles.permute(3, 0, 1, 2).reshape(64, th // 2, tw // 2)
                else:
                    full = torch.empty_like(acc)
                    full[order] = acc
                    out[b, :, y0:y0 + th, x0:x0 + tw] = \
                        full.t().reshape(64, th, tw)
    return out[:, :, :h // 2, :w // 2] if pool else out[:, :, :h, :w]


def _rel(got, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - ref).max()
                 / max(1.0, np.abs(ref).max()))


SHAPES = [(2, 64, 256), (1, 80, 300), (1, 72, 136)]


@pytest.mark.parametrize("shape", SHAPES)
def test_stem_decomposition_vs_plain_and_pallas(both_params, shape):
    jp, tp = both_params
    b, h, w = shape
    img = np.random.default_rng(3).uniform(0, 1, (b, h, w, 1)).astype(np.float32)
    x = torch.from_numpy(img.transpose(0, 3, 1, 2).copy())
    got = conv_tc_decomposed(tp["conv1b"], x, True, STEM_TILE,
                             conv1a=tp["conv1a"])
    plain = stem.fused_stem_plain(tp, x)
    pallas = np.asarray(fused_stem_pallas(
        {"conv1a": jp["conv1a"], "conv1b": jp["conv1b"]}, jnp.asarray(img),
        mp=False, interpret=True)).transpose(0, 3, 1, 2)
    assert got.shape == plain.shape == pallas.shape == (b, 64, h // 2, w // 2)
    assert _rel(got, plain) <= 1e-6
    assert _rel(got, pallas) <= 1e-5


@pytest.mark.parametrize("shape", SHAPES)
def test_block2_decomposition_vs_plain_and_pallas(both_params, shape):
    """B8 as two launches (conv2a to a full-resolution map, conv2b with the
    pool) on the XLA stem's output, the channel-plane layout for Pallas."""
    jp, tp = both_params
    b, h, w = shape
    img = jnp.asarray(np.random.default_rng(7).uniform(
        0, 1, (b, h, w, 1)).astype(np.float32))
    xj = jax.nn.relu(jnn.conv2d(jp["conv1a"], img))
    xj = np.asarray(jnn.max_pool(jax.nn.relu(jnn.conv2d(jp["conv1b"], xj)), 2))
    x = torch.from_numpy(xj.transpose(0, 3, 1, 2).copy())
    a = conv_tc_decomposed(tp["conv2a"], x, False, MAP_TILE)
    assert _rel(a, stem2.conv3x3_relu_plain(tp["conv2a"], x)) <= 1e-6
    got = conv_tc_decomposed(tp["conv2b"], a, True, MAP_TILE)
    plain = stem2.fused_block2_plain(tp, x)
    cp = xj.transpose(0, 1, 3, 2)
    cp = np.pad(cp, ((0, 0), (0, 0), (0, 0), (0, -(-w // 256) * 128 - w // 2)))
    pallas = np.asarray(fused_block2_pallas(
        {"conv2a": jp["conv2a"], "conv2b": jp["conv2b"]}, jnp.asarray(cp),
        h2=h // 2, w2=w // 2, mp=False, interpret=True)).transpose(0, 3, 1, 2)
    assert got.shape == plain.shape == pallas.shape == (b, 64, h // 4, w // 4)
    assert _rel(got, plain) <= 1e-6
    assert _rel(got, pallas) <= 1e-5


# --- 3xTF32 at K = 576 ----------------------------------------------------------


def test_3xtf32_split_keeps_fp32_at_k576(both_params):
    """One 3x3 64 -> 64 conv as the kernel's GEMM: A (pixels, 576) relu'd
    activations of the stem's size, B the prepared conv2a weights (taps x
    channels); the split products summed exactly are within 1e-6 of
    float64, one tf32 pass is not within CONV_TOL."""
    _, tp = both_params
    rng = np.random.default_rng(11)
    a = torch.from_numpy(np.maximum(rng.standard_normal((512, 576)) * 2, 0)
                         .astype(np.float32))
    prep = stem.prepare_conv(tp["conv2a"]["w"])  # (9, 64, 128)
    parts = prep.reshape(9, 64, 8, 4, 2, 2).permute(4, 1, 0, 2, 5, 3)
    wb, ws = (pp.reshape(64, 576) for pp in parts)  # [co][tap, ci]
    w = tp["conv2a"]["w"].permute(0, 2, 3, 1).reshape(64, 576)
    exact = a.double() @ w.double().t()
    ab, as_ = stem.split_tf32(a)
    three = (as_.double() @ wb.double().t() + ab.double() @ ws.double().t()
             + ab.double() @ wb.double().t())
    rnd = lambda t: ((t.view(torch.int32) + 0x1000) & -0x2000).view(  # noqa
        torch.float32)
    one = rnd(a).double() @ rnd(w).double().t()
    scale = max(1.0, float(exact.abs().max()))
    assert float((three - exact).abs().max()) / scale <= 1e-6
    assert float((one - exact).abs().max()) / scale > CONV_TOL


# --- the tile grid ---------------------------------------------------------------


def _stage_positions(th, tw, pool):
    """(co, staged index) that each lane of each warp (one thread a pixel)
    writes in the epilogue, as conv_tc_kernel does."""
    mtw, rows = tw // 8, []
    for warp in range(th * tw // 32):
        for mt in range(2):
            i = 2 * warp + mt
            for lane in range(32):
                g, t = lane // 4, lane % 4
                for nt in range(8):
                    co = 8 * nt + 2 * t
                    if pool:
                        if g % 2 == 0:
                            idx = (i // mtw) * (tw // 2) + 4 * (i % mtw) + g // 2
                            rows += [(co, idx), (co + 1, idx)]
                    else:
                        p0 = 2 * (i // mtw) * tw + 8 * (i % mtw) + g
                        rows += [(co, p0), (co + 1, p0), (co, p0 + tw),
                                 (co + 1, p0 + tw)]
    return np.array(rows)


def _grid_counts(b, h, w, tile, pool):
    """Writes per output element of one launch: the staged tile's
    (r, c) -> (oy0 + r, ox0 + c) where in range, over the grid."""
    th, tw = tile[:2]
    ho, wo = (h // 2, w // 2) if pool else (h, w)
    rt, ct = (th // 2, tw // 2) if pool else (th, tw)
    counts = np.zeros((b, 64, ho, wo), np.int64)
    for bz in range(b):
        for by in range(-(-h // th)):
            for bx in range(-(-w // tw)):
                oy0, ox0 = by * th // (2 if pool else 1), bx * tw // (2 if pool else 1)
                counts[bz, :, oy0:oy0 + rt, ox0:ox0 + ct] += 1
    return counts


@pytest.mark.parametrize("which", ["stem", "map"])
@pytest.mark.parametrize("pool", [True, False])
def test_epilogue_stages_every_output_of_a_tile_once(which, pool):
    th, tw = (STEM_TILE if which == "stem" else MAP_TILE)[:2]
    pos = _stage_positions(th, tw, pool)
    n = th * tw // (4 if pool else 1)
    counts = np.zeros((64, n), np.int64)
    np.add.at(counts, (pos[:, 0], pos[:, 1]), 1)
    assert (counts == 1).all()


@pytest.mark.parametrize("h, w", [(768, 1024), (8, 8), (24, 40), (72, 136),
                                  (12, 52), (80, 300)])
def test_grid_covers_every_output_once(h, w):
    """B7 at the image size, B8's two launches at half of it."""
    assert (_grid_counts(1, h, w, STEM_TILE, True) == 1).all()
    for pool in (False, True):
        assert (_grid_counts(1, h // 2, w // 2, MAP_TILE, pool) == 1).all()


@pytest.mark.parametrize("tile", [STEM_TILE, MAP_TILE])
def test_fragment_reads_stay_in_the_tile_on_distinct_banks(tile):
    th, tw, nq, stages = tile
    rows, rs = th + 2, tw + 8
    cs = rows * rs
    while cs % 32 not in (8, 24):
        cs += 1
    ldw = 16 * (64 // nq // 8) + 16
    mtw = tw // 8
    for warp in range(th * tw // 32):
        for mt in range(2):
            i = 2 * warp + mt
            for dy in range(3):
                for dx in range(3):
                    r = 2 * (i // mtw) + dy + np.array([0, 1])
                    c = 8 * (i % mtw) + np.arange(8) + 3 + dx
                    assert r.min() >= 0 and r.max() < rows
                    assert c.min() >= 3 and c.max() < tw + 5 <= rs
            # a0: lanes (g, t) at channel t, pixel g: 32 distinct banks
            banks = {(t * cs + g + 8 * (i % mtw)) % 32
                     for g in range(8) for t in range(4)}
            assert len(banks) == 32
    # a lane's float4 of weights: each quarter warp on 32 distinct banks
    for quarter in range(4):
        banks = set()
        for lane in range(8 * quarter, 8 * quarter + 8):
            g, t = lane // 4, lane % 4
            banks |= {(g * ldw + 4 * t + k) % 32 for k in range(4)}
        assert len(banks) == 32
    weights_bytes = stages * 64 * ldw * 4
    image_bytes = ((th + 4) * (tw + 4) + 64 * 10) * 4
    assert 64 * cs * 4 + weights_bytes + image_bytes <= SMEM_MAX
    assert th * tw in (128, 256) and 64 * (th * tw + 4) <= 64 * cs


# --- prepared weights ------------------------------------------------------------


def test_prepare_conv_is_the_split_transpose(both_params):
    _, tp = both_params
    w = tp["conv2b"]["w"]
    prep = stem.prepare_conv(w)
    assert prep.shape == (9, 64, 128) and prep.is_contiguous()
    # [tap][co][k][t][big/small][ci 8k + t, 8k + t + 4]
    parts = prep.reshape(9, 64, 8, 4, 2, 2).permute(4, 0, 1, 2, 5, 3)
    big, small = (pp.reshape(9, 64, 64) for pp in parts)
    wt = w.permute(2, 3, 0, 1).reshape(9, 64, 64)  # [tap (dy, dx)][co][ci]
    bits = wt.view(torch.int32)
    assert torch.equal(big.view(torch.int32), bits & -0x2000)
    rest = wt - big  # exact in fp32
    assert torch.equal(small.view(torch.int32),
                       (rest.view(torch.int32) + 0x1000) & -0x2000)
    assert torch.equal(big + rest, wt)
    assert float((big.double() + small.double() - wt.double()).abs().max()) \
        <= float(wt.abs().max()) * 2.0 ** -21


def test_prepared_conv_is_built_once_per_tensor(both_params):
    _, tp = both_params
    w = tp["conv2a"]["w"].clone()
    first = stem.prepared_conv(w)
    assert stem.prepared_conv(w) is first
    assert torch.equal(stem.prepared_conv(w.clone()), first)
    assert stem.prepared_conv(w.clone()) is not first
