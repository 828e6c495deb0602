"""ALIKED's stem on the tensor cores (B10, csrc/aliked_stem.cu) on the CPU,
at small sizes, on seeded numpy inputs.

- The kernel's decomposition in plain PyTorch, block by block at the tile
  read from aliked_stem.cu: the image tile with its 2-pixel ring, conv1
  (bn1's scale folded into its weights, as ``prepare`` stores them) + SELU
  at the staged positions with their 1-pixel ring, 0 outside the image,
  split once into tf32 big and small parts; conv2 as nine per-tap products
  in the kernel's K order (row of taps, tap, 8-deep chunk); bn2 + SELU; the
  2x2 average over the m16 tiles' 2 x 8 patches (rows g and g + 8, then
  lanes g and g ^ 1); the 1x1 branch fed from the accumulators in C-fragment
  order through ``prepare``'s K-permuted weights; SELU. Against
  ``fused_aliked_stem_plain`` (1e-6) and JAX's ``fused_aliked_stem`` in
  interpret mode at aliked-n16, the composed JAX ops at aliked-t16 (1e-5),
  relative to max(1, max |reference|).
- tc.cuh's 3xTF32 split, emulated bit for bit on the prepared conv2 weights
  at K = 144: within 1e-6 of float64, where one tf32 pass is not within
  chip_smoke.py's CONV_TOL.
- ``prepare``'s layout and ``prepared``'s once-per-tree cache.
- The grid and the per-warp stores, read from aliked_stem.cu: every y1 and
  x1p output written by exactly one tile and lane, on ragged shapes.
- Fragment reads inside the staged tile and on distinct banks, conv1's
  writes and the y1 staging on distinct banks, two blocks an SM.
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
from lightglue_tpu.configs import ALIKEDConfig as JALIKEDConfig
from lightglue_tpu.models import aliked as jal
from lightglue_tpu.ops.aliked_stem import fused_aliked_stem as jstem
from lightglue_tpu_torch import configs, nn, weights
from lightglue_tpu_torch.ops import aliked_stem, stem

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False

CONV_TOL = 1e-4  # chip_smoke.py's bound, relative to max(1, max |plain|)
SRC = (Path(__file__).resolve().parents[1] / "lightglue_tpu_torch" / "csrc"
       / "aliked_stem.cu").read_text()
SMEM_SM = 233472  # bytes of shared memory an H100 SM holds (228 KB)
ALPHA, SCALE = 1.6732632423543772848170429916717, 1.0507009873554804934193349852946


def _tile(name):
    m = re.search(rf"using {name} = StemTile<(\d+), (\d+), (\d+), (\d+), (\d+), "
                  r"(\d+)>;", SRC)
    return tuple(int(v) for v in m.groups())


TILES = {"aliked-n16": _tile("TileN16"), "aliked-t16": _tile("TileT16")}
_jax_init = jax.jit(jal.init_params, static_argnums=1)


def _params(model_name, seed):
    """JAX init with random batch-norm statistics and the encoder's gain of
    2, as (JAX tree, port tree)."""
    conf = JALIKEDConfig(model_name=model_name)
    flat = {k: np.asarray(v) for k, v in jweights.flatten_tree(
        _jax_init(jax.random.key(seed), conf)).items()}
    rng = np.random.default_rng(seed)
    for k, v in flat.items():
        if "/bn" in k:
            flat[k] = {"scale": rng.uniform(0.5, 1.5, v.shape),
                       "bias": rng.normal(0, 0.1, v.shape),
                       "mean": rng.normal(0, 0.1, v.shape),
                       "var": rng.uniform(0.5, 1.5, v.shape)}[k.split("/")[-1]
                                                              ].astype(np.float32)
        elif k.endswith("/w") and (k.startswith("block1") or k.startswith("conv1")):
            flat[k] = v * np.float32(2.0)
    tp = weights.aliked_from_jax_params(
        flat, configs.ALIKEDConfig(model_name=model_name))
    jp = jweights.unflatten_tree(flat)
    return ({"block1": jp["block1"], "conv1": jp["conv1"]},
            {"block1": tp["block1"], "conv1": tp["conv1"]})


# --- the decomposition ----------------------------------------------------------


def selu_exp(x):
    """The kernel's SELU: the exp form on the negative side."""
    return torch.where(x > 0, SCALE * x,
                       SCALE * ALPHA * torch.exp(torch.clamp(x, max=0)) - SCALE * ALPHA)


def split_sum(x):
    """A staged value as the tensor core reads it: big + small (exact in
    fp32), which is x to 2^-21 of |x|."""
    big, small = stem.split_tf32(x.contiguous())
    return big + small


def stem_decomposed(p, img, tile):
    """B10 block by block in plain PyTorch: img (B, 3, H, W) -> (y1 (B, H,
    W, CY), x1p (B, C1, H/2, W/2))."""
    c1, cy, th, tw = tile[:4]
    k1, w2, wy = aliked_stem.prepare(p)
    w1 = k1[:27 * c1].reshape(3, 3, 3, c1).permute(3, 0, 1, 2)  # x s1, OIHW
    b1, s2, b2 = k1[27 * c1:28 * c1], k1[28 * c1:29 * c1], k1[29 * c1:30 * c1]
    kc = c1 // 8
    # conv2 [tap][ci][co] and the 1x1 [ci in C-fragment order][co] from the
    # prepared fragments: {big b0, big b1, small b0, small b1}
    f2 = w2.reshape(9, kc, kc, 8, 4, 4)  # tap, kc, nt, g, t, part
    bsum = f2[..., 0:2] + f2[..., 2:4]  # (tap, kc, nt, g, t, h): ci 8kc+4h+t
    w2t = bsum.permute(0, 1, 5, 4, 2, 3).reshape(9, c1, c1)  # tap, ci, co
    fy = wy.reshape(kc, cy // 8, 8, 4, 4)
    ysum = fy[..., 0:2] + fy[..., 2:4]  # (kk, n, g, t, e): ci 8kk + 2t + e
    wyt = ysum.permute(0, 4, 3, 1, 2).reshape(c1, cy)  # rows: kk, e, t
    b, _, h, w = img.shape
    ny, nx = -(-h // th), -(-w // tw)
    y1 = img.new_zeros(b, ny * th, nx * tw, cy)
    xp = img.new_zeros(b, c1, ny * th // 2, nx * tw // 2)
    # the C-fragment order of a chunk's channels: 2t (t = 0..3), then 2t + 1
    cfrag = torch.tensor([8 * kk + 2 * tt + e for kk in range(kc)
                          for e in range(2) for tt in range(4)])
    for bb in range(b):
        for iy in range(ny):
            for ix in range(nx):
                y0, x0 = iy * th, ix * tw
                it = F.pad(img[bb], (2, nx * tw + 2 - w, 2, ny * th + 2 - h))[
                    :, y0:y0 + th + 4, x0:x0 + tw + 4]
                a = selu_exp(F.conv2d(it[None], w1)[0] + b1[:, None, None])
                ys = torch.arange(y0 - 1, y0 + th + 1)[:, None]
                xs = torch.arange(x0 - 1, x0 + tw + 1)[None, :]
                a = split_sum(a * ((ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)))
                acc = img.new_zeros(th * tw, c1)
                for tap in range(9):  # row of taps, tap, chunk
                    dy, dx = divmod(tap, 3)
                    for q in range(kc):
                        blk = a[8 * q:8 * q + 8, dy:dy + th, dx:dx + tw]
                        acc += blk.reshape(8, -1).t() @ w2t[tap, 8 * q:8 * q + 8]
                x1 = selu_exp(acc * s2 + b2).reshape(th, tw, c1)
                # rows g and g + 8 (the pair of rows), then lanes g, g ^ 1
                v = x1.reshape(th // 2, 2, tw, c1).sum(1)
                pooled = v.reshape(th // 2, tw // 2, 2, c1).sum(2) * 0.25
                xp[bb, :, iy * th // 2:(iy + 1) * th // 2,
                   ix * tw // 2:(ix + 1) * tw // 2] = pooled.permute(2, 0, 1)
                xc = split_sum(x1.reshape(-1, c1)[:, cfrag])
                y1[bb, y0:y0 + th, x0:x0 + tw] = selu_exp(xc @ wyt).reshape(th, tw, cy)
    return y1[:, :h, :w], xp[:, :, :h // 2, :w // 2]


def _rel(got, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - ref).max()
                 / max(1.0, np.abs(ref).max()))


@jax.jit
def _jax_composed(block1, conv1, img):
    x1 = jal._conv_block(block1, img)
    return jal.selu(jnn.conv2d(conv1, x1)), jal._avg_pool(x1, 2)


@pytest.mark.parametrize("model_name, shape, jax_ref", [
    ("aliked-n16", (1, 32, 64), "pallas"), ("aliked-n16", (2, 18, 34), None),
    ("aliked-t16", (1, 40, 72), "composed"), ("aliked-t16", (1, 34, 96), None)])
def test_decomposition_vs_plain_and_jax(model_name, shape, jax_ref):
    """Against the plain version at every shape (ragged tiles, a batch of
    2), against JAX at one shape a width: the Pallas kernel (built for 16
    channels) at n16, the composed ops at t16."""
    jp, tp = _params(model_name, 0)
    b, h, w = shape
    img = np.random.default_rng(3).uniform(0, 1, (b, h, w, 3)).astype(np.float32)
    x = torch.from_numpy(img.transpose(0, 3, 1, 2).copy())
    y1, x1p = stem_decomposed(tp, x, TILES[model_name])
    py1, px1p = aliked_stem.fused_aliked_stem_plain(tp, x)
    assert y1.shape == py1.shape and x1p.shape == px1p.shape
    assert _rel(y1, py1) <= 1e-6 and _rel(x1p, px1p) <= 1e-6
    if jax_ref == "pallas":
        jy1, jx = jstem(jp, jnp.asarray(img), mp=False, interpret=True)
    elif jax_ref == "composed":
        jy1, jx = _jax_composed(jp["block1"], jp["conv1"], jnp.asarray(img))
    else:
        return
    assert _rel(y1, jy1) <= 1e-5
    assert _rel(x1p, np.asarray(jx).transpose(0, 3, 1, 2)) <= 1e-5


# --- 3xTF32 at K = 144 -----------------------------------------------------------


def test_3xtf32_split_keeps_fp32_at_k144():
    """conv2 as the kernel's GEMM: A (pixels, 144) SELU'd activations, B the
    prepared conv2 weights; the split products summed exactly are within
    1e-6 of float64, one tf32 pass is not within CONV_TOL."""
    _, tp = _params("aliked-n16", 1)
    rng = np.random.default_rng(11)
    a = selu_exp(torch.from_numpy(rng.standard_normal((512, 144)).astype(np.float32) * 2))
    _, w2, _ = aliked_stem.prepare(tp)
    f = w2.reshape(9, 2, 2, 8, 4, 4)  # tap, kc, nt, g, t, (bs, h)
    wb = f[..., 0:2].permute(2, 3, 0, 1, 5, 4).reshape(16, 144)  # co, (tap ci)
    ws = f[..., 2:4].permute(2, 3, 0, 1, 5, 4).reshape(16, 144)
    w = tp["block1"]["conv2"]["w"].permute(0, 2, 3, 1).reshape(16, 144)
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


# --- prepared weights -------------------------------------------------------------


@pytest.mark.parametrize("model_name", ["aliked-n16", "aliked-t16"])
def test_prepare_layout(model_name):
    _, tp = _params(model_name, 2)
    c1, cy = TILES[model_name][:2]
    kc = c1 // 8
    k1, w2, wy = aliked_stem.prepare(tp)
    assert k1.shape == (30 * c1,) and w2.shape == (9, kc, kc, 32, 4)
    assert wy.shape == (kc, cy // 8, 32, 4)
    s1, b1 = nn.fold_batch_norm(tp["block1"]["bn1"])
    s2, b2 = nn.fold_batch_norm(tp["block1"]["bn2"])
    w1 = tp["block1"]["conv1"]["w"].permute(1, 2, 3, 0).reshape(27, c1) * s1
    assert torch.equal(k1, torch.cat([w1.reshape(-1), b1, s2, b2]))
    wt = tp["block1"]["conv2"]["w"]  # (co, ci, 3, 3)
    wyt = tp["conv1"]["w"][:, :, 0, 0]  # (co, ci)
    for tap in (0, 4, 8):
        for k in range(kc):
            for nt in range(kc):
                for lane in (0, 5, 31):
                    g, t = divmod(lane, 4)
                    co = 8 * nt + g
                    want = [wt[co, 8 * k + t, tap // 3, tap % 3],
                            wt[co, 8 * k + t + 4, tap // 3, tap % 3]]
                    big, small = stem.split_tf32(torch.stack(want))
                    assert torch.equal(w2[tap, k, nt, lane],
                                       torch.cat([big, small]))
    for kk in range(kc):
        for n in range(cy // 8):
            for lane in (0, 6, 31):
                g, t = divmod(lane, 4)
                want = torch.stack([wyt[8 * n + g, 8 * kk + 2 * t],
                                    wyt[8 * n + g, 8 * kk + 2 * t + 1]])
                big, small = stem.split_tf32(want)
                assert torch.equal(wy[kk, n, lane], torch.cat([big, small]))


def test_prepared_is_built_once_per_tree():
    _, tp = _params("aliked-t16", 3)
    first = aliked_stem.prepared(tp)
    assert aliked_stem.prepared(tp) is first
    other = dict(tp, block1=dict(tp["block1"], bn2={
        k: v.clone() for k, v in tp["block1"]["bn2"].items()}))
    again = aliked_stem.prepared(other)  # same conv2 tensor, another bn2
    assert again is not first
    assert all(torch.equal(a, b) for a, b in zip(again, first))
    assert aliked_stem.prepared(other) is again


# --- the grid, the stores and the banks ----------------------------------------------


def _slot(c1, kc, t, col):
    """aliked_stem.cu's quad slot (read from the source below)."""
    return (2 * t + kc + col) & 7 if c1 == 16 else (t + (col >> 1)) & 3


def test_slot_formulas_are_the_kernels():
    assert "if constexpr (C1 == 16) return (2 * t + kc + col) & 7;" in SRC
    assert "else return (t + (col >> 1)) & 3;" in SRC


@pytest.mark.parametrize("model_name", ["aliked-n16", "aliked-t16"])
@pytest.mark.parametrize("hw", [(768, 1024), (40, 72), (2, 2), (18, 34),
                                (96, 32)])
def test_every_output_written_once(model_name, hw):
    """The grid (cdiv(W, TW), cdiv(H, TH)), each warp's MT m16 tiles of 2 x 8
    pixels (y1: two rows of 8 pixels an m16 tile) and its strip's pooled row
    (x1p), masked to the image."""
    c1, cy, th, tw, mt, _ = TILES[model_name]
    h, w = hw
    mtw = tw // 8
    warps = th // 2 * mtw // mt
    y1 = np.zeros((h, w), np.int64)
    xp = np.zeros((h // 2, w // 2), np.int64)
    for by in range(-(-h // th)):
        for bx in range(-(-w // tw)):
            y0, x0 = by * th, bx * tw
            for warp in range(warps):
                rp, cb0 = divmod(mt * warp, mtw)
                for m in range(mt):
                    for px in range(16):
                        gy, gx = y0 + 2 * rp + px // 8, x0 + 8 * (cb0 + m) + px % 8
                        if gy < h and gx < w:
                            y1[gy, gx] += 1
                oy, ox0 = (y0 + 2 * rp) // 2, (x0 + 8 * cb0) // 2
                for j in range(4 * mt):
                    if oy < h // 2 and ox0 + j < w // 2:
                        xp[oy, ox0 + j] += 1
    assert (y1 == 1).all() and (xp == 1).all()


@pytest.mark.parametrize("model_name", ["aliked-n16", "aliked-t16"])
def test_fragment_reads_in_the_tile_on_distinct_banks(model_name):
    c1, cy, th, tw, mt, vp = TILES[model_name]
    ar, ac, qp = th + 2, tw + 2, c1 // 2  # quads a pixel
    mtw = tw // 8
    for warp in range(th // 2 * mtw // mt):
        rp, cb0 = divmod(mt * warp, mtw)
        for m in range(mt):
            for dy in range(3):
                for dx in range(3):
                    rows = 2 * rp + dy + np.array([0, 1])
                    cols = 8 * (cb0 + m) + np.arange(8) + dx
                    assert rows.max() < ar and cols.max() < ac
                    for kc in range(c1 // 8):
                        # a quarter warp: lanes g in {2q, 2q + 1}, t 0..3
                        for q in range(4):
                            groups = set()
                            for g in (2 * q, 2 * q + 1):
                                col = 8 * (cb0 + m) + g + dx
                                pix = rows[0] * ac + col
                                for t in range(4):
                                    groups.add((pix * qp + _slot(c1, kc, t, col)) % 8)
                            assert len(groups) == 8
    # conv1's writes: 8 consecutive staged columns of one quad slot
    for kc in range(c1 // 8):
        for t in range(4):
            for c0 in range(ac - 8):
                groups = {((c0 + j) * qp + _slot(c1, kc, t, c0 + j)) % 8
                          for j in range(8)}
                assert len(groups) == 8
    # y1 staging: float2 stores of a half warp (g 0..3 or 4..7, t 0..3)
    ys = cy + 8
    for half in (0, 1):
        pairs = {((4 * half + g) * ys + 2 * t) % 32 // 2
                 for g in range(4) for t in range(4)}
        assert len(pairs) == 16
    # two blocks an SM
    warps = th // 2 * mtw // mt
    k_a = max(ar * ac * 2 * c1, warps * (16 * ys + c1 * (4 * mt + 4)))
    kc = c1 // 8
    floats = (k_a + 3 * (th + 4) * (tw + 4) + 9 * kc * kc * 128
              + kc * cy // 8 * 128 + 30 * c1)
    assert 2 * (floats * 4 + 1024) <= SMEM_SM
    assert ar % vp == 0 and ar // vp * ac <= 32 * warps  # conv1: one round
