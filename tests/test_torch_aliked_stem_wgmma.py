"""B10's bf16 form on Hopper (csrc/aliked_wgmma.cuh) on the CPU, at small
sizes, on seeded numpy inputs, at aliked-n16 (C1 16, CY 32) and aliked-t16
(C1 8, CY 16).

- The kernel's decomposition in plain PyTorch, block by block as
  ops/conv_plan.py cuts a launch (units of 128 output columns x a row pair,
  three blocks an SM): each conv1 row of a segment computed once into the
  staged ring (136 pixels from x0 - 1, 130 written, 0 outside the image),
  as three 64-pixel tiles of (pixels x 16) @ (16 x C1) products, one a tap
  column dx, K = (ci, dy) as 3 ci + dy zero-padded to 16, the fp32 sum
  rounded, x s1, + b1 in bf16 steps, SELU; conv2 per k-step in the
  kernel's order (a tap at C1 16; taps (dy, 0) + (dy, 1) and (dy, 2) + a
  zero partner at C1 8, chunk 1 the next pixel) on 64 pixels of the staged
  rows moved dx pixels; the pool from the two rows' accumulator sets and
  the column pair; the 1x1 on the rounded accumulators with its output
  channels permuted (``y1_channel``). Every output is written exactly once.
  The weights are read from ``prepare_bf16``'s blob as the kernel reads
  it. Held against ``_stem_plain_mp`` and against JAX's
  ``fused_aliked_stem(mp=True, interpret=True)`` with
  tests/test_torch_mp_extract.py's bf16 bounds (|got - want| <= 2e-2 max(1,
  |want|) and <= 2^-6 (|want| + rms(want's row)), elementwise: the sums are
  taken in another order, so a sum at a bf16 rounding boundary can round
  to the other neighbour), on images ragged against the strips, with as
  many blocks as units and with so few that a block walks several segments
  across strips and images.
- The plan fills the SMs (three blocks each) and covers every unit once.
- Every tap's and conv1 tile's descriptor reads inside the staged ring and
  the row's taps, past the written pixels only with zero weights; the TMA
  box starts on a 16-byte boundary; shared memory and registers fit three
  blocks an H100 SM.
- ``prepare_bf16``'s layout, ``prepared``'s cache (one per tree and type)
  and the tensor-map cache kept with it.
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu import configs as jconfigs
from lightglue_tpu import weights as jweights
from lightglue_tpu.models import aliked as jal
from lightglue_tpu.ops.aliked_stem import fused_aliked_stem as jstem
from lightglue_tpu_torch import _build, configs, nn, weights
from lightglue_tpu_torch.ops import aliked_stem, conv_plan, tma_maps

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False

BF = torch.bfloat16
REL = 2e-2  # tests/test_torch_mp_extract.py's bounds
SCALED = 2.0 ** -6
HEADER = (Path(__file__).resolve().parents[1] / "lightglue_tpu_torch" / "csrc"
          / "aliked_wgmma.cuh").read_text()
SMEM_SM = 228 * 1024  # shared memory of an H100 SM
SMEM_MAX = 232448  # bytes a block may take
NAMES = ["aliked-n16", "aliked-t16"]
SHAPES = [(1, 40, 72), (2, 34, 136)]  # ragged against the 128-column strips
SMS = [132, 3]  # a block a unit; a few blocks walking several segments
_jax_al_init = jax.jit(jal.init_params, static_argnums=1)


def _const(name):
    return int(re.search(rf"constexpr int [^;]*\b{name} = (\d+)", HEADER).group(1))


RP, READ_PX, IMW, TP = _const("RP"), 130, _const("IMW"), _const("TP")
TILES = (0, 64, 66)  # conv1's 64-pixel tiles of a staged row (tile1)


@functools.lru_cache(maxsize=None)
def _al_params(name):
    """ALIKED's JAX init (key 0) with random batch-norm statistics, the
    encoder and aggregation convs times 2 (tests/test_torch_mp_extract.py's
    stand-in for trained weights), as (JAX tree, port tree)."""
    flat = {k: np.asarray(v) for k, v in jweights.flatten_tree(_jax_al_init(
        jax.random.key(0), jconfigs.ALIKEDConfig(model_name=name))).items()}
    rng = np.random.default_rng(1)
    for k, v in flat.items():
        field = k.split("/")[-1]
        if "/bn" in k:
            flat[k] = {"scale": rng.uniform(0.5, 1.5, v.shape),
                       "bias": rng.normal(0, 0.1, v.shape),
                       "mean": rng.normal(0, 0.1, v.shape),
                       "var": rng.uniform(0.5, 1.5, v.shape)}[field].astype(np.float32)
        elif field == "w" and "offset_conv" not in k \
                and not k.startswith("desc_head"):
            flat[k] = v * (3.0 if k.startswith("score_head") else 2.0)
    tp = weights.aliked_from_jax_params(flat, configs.ALIKEDConfig(model_name=name))
    return (jweights.unflatten_tree(flat),
            {"block1": tp["block1"], "conv1": tp["conv1"]})


def _padded16(jp):
    """{"block1", "conv1"} of a JAX tree, channels zero-padded to C1 16 and
    CY 32 (identity batch norms on the padded channels): the Pallas kernel
    is built for 16 channels."""
    def pad(w, *to):
        return jnp.pad(w, [(0, t - n) for n, t in zip(w.shape, to)])
    bp = jp["block1"]
    c1 = bp["conv2"]["w"].shape[-1]
    bn = lambda p: {k: jnp.pad(v, (0, 16 - c1), constant_values=float(
        k in ("scale", "var"))) for k, v in p.items()}
    return {"block1": {"conv1": {"w": pad(bp["conv1"]["w"], 3, 3, 3, 16)},
                       "bn1": bn(bp["bn1"]),
                       "conv2": {"w": pad(bp["conv2"]["w"], 3, 3, 16, 16)},
                       "bn2": bn(bp["bn2"])},
            "conv1": {"w": pad(jp["conv1"]["w"], 1, 1, 16, 32)}}


def _strict(fn, *args, **static):
    f = jax.jit(functools.partial(fn, **static))
    return f.lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _close(got, want):
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape and np.isfinite(g).all()
    err = np.abs(g - w)
    rms = np.sqrt(np.mean(np.square(w), -1, keepdims=True))
    assert (err <= REL * np.maximum(1.0, np.abs(w))).all(), err.max()
    assert (err <= SCALED * (np.abs(w) + rms)).all()


def _r(x):
    return x.to(BF).float()


# --- the blob, as the kernel's descriptors read it ------------------------------


def _blob(tp):
    """prepare_bf16's blob as the products read it: conv1 [dx][co][k],
    conv2 [step][co][k] (k 16: the two 8-deep chunks), the 1x1 [n][k], and
    the BN vectors (s1, b1, s2, b2)."""
    c1 = tp["block1"]["conv2"]["w"].shape[0]
    cy, steps = 2 * c1, 9 if c1 == 16 else 6
    lay = aliked_stem.bf16_layout(c1)
    raw = aliked_stem.prepare_bf16(tp).float()

    def part(off, rows, n):  # [n][chunk][rows][8] -> [n][rows][16]
        v = raw[off // 2:off // 2 + n * 2 * rows * 8].reshape(n, 2, rows, 8)
        return v.permute(0, 2, 1, 3).reshape(n, rows, 16)

    return (part(lay.w1, c1, 3), part(lay.w2, c1, steps), part(lay.wy, cy, 1)[0],
            raw[lay.bn // 2:lay.bn // 2 + 4 * c1].reshape(4, c1))


def _bn_selu(acc, s, b):
    return nn.selu(_r(_r(_r(acc) * s) + b))


# --- the decomposition --------------------------------------------------------


def _taps(img, b, r, x0):
    """A conv1 row's taps (TP pixels from x0 - 2, 16 values): value 3 ci +
    dy of pixel c is the rounded image at (ci, r - 1 + dy, x0 - 2 + c), 0
    outside the image and past 8."""
    _, _, h, w = img.shape
    xs = x0 - 2 + torch.arange(TP)
    taps = torch.zeros(TP, 16)
    for ci in range(3):
        for dy in range(3):
            y = r - 1 + dy
            ok = (0 <= y < h) & (xs >= 0) & (xs < w)
            taps[:, 3 * ci + dy] = torch.where(
                ok, _r(img[b, ci, min(max(y, 0), h - 1)][xs.clamp(0, w - 1)]), 0.0)
    return taps


def _conv1_row(blob, img, b, r, x0):
    """Staged row r of conv1 (RP pixels from x0 - 1, C1 channels) as the
    producer computes it: three 64-pixel tiles, each the sum over dx of
    the taps moved dx pixels times the weights of tap column dx."""
    w1, _, _, bn = blob
    _, _, h, w = img.shape
    c1 = w1.shape[1]
    row = torch.zeros(RP, c1)
    if not 0 <= r < h:
        return row
    taps = _taps(img, b, r, x0)
    written = torch.zeros(RP, dtype=torch.bool)
    for s0 in TILES:
        acc = sum(taps[s0 + dx:s0 + dx + 64] @ w1[dx].T for dx in range(3))
        sp = s0 + torch.arange(64)
        x = x0 - 1 + sp
        v = torch.where(((x >= 0) & (x < w))[:, None], _r(_bn_selu(acc, bn[0], bn[1])),
                        torch.zeros(()))
        keep = sp >= 128 if s0 == 66 else torch.ones(64, dtype=torch.bool)
        row[sp[keep]] = v[keep]
        written[sp[keep]] = True
    assert written[:READ_PX].all() and not written[READ_PX:].any()
    return row


def _step(c1, st):
    """(dy, dx) of conv2's k-step st: a tap at C1 16; taps (dy, dx) and (dy,
    dx + 1) at C1 8."""
    return (st // 3, st % 3) if c1 == 16 else (st // 2, 2 * (st % 2))


def _pair(rows, w2):
    """A pair's accumulators acc[r][m] (64 pixels x C1): rows 2q + r,
    pixels 64 m .. of the strip, k-step by k-step, step (dy, dx) reading
    staged row r + dy from pixel 64 m + dx (at C1 8 its chunk 1 from the
    next pixel)."""
    c1 = w2.shape[1]
    acc = [[torch.zeros(64, c1) for _ in range(2)] for _ in range(2)]
    for st in range(w2.shape[0]):
        dy, dx = _step(c1, st)
        for r in range(2):
            for m in range(2):
                row, p0 = rows[r + dy], 64 * m + dx
                a = row[p0:p0 + 64] if c1 == 16 else torch.cat(
                    [row[p0:p0 + 64], row[p0 + 1:p0 + 65]], 1)
                acc[r][m] += a @ w2[st].T
    return acc


def emulate(tp, img, sms):
    """B10's bf16 form as the kernel computes it: (y1 (B, H, W, CY), x1p
    (B, C1, H/2, W/2)), fp32 holding bf16 values."""
    blob = _blob(tp)
    _, w2, wy, bn = blob
    c1 = w2.shape[1]
    cy = 2 * c1
    bsz, _, h, w = img.shape
    plan = conv_plan.plan(bsz, h, w, aliked_stem.PER_SM * sms)
    y1 = torch.full((bsz, h, w, cy), float("nan"))
    x1p = torch.full((bsz, c1, h // 2, w // 2), float("nan"))
    seen_y = torch.zeros(bsz, h, w, dtype=torch.int64)
    seen_p = torch.zeros(bsz, h // 2, w // 2, dtype=torch.int64)
    chan = aliked_stem.y1_channel(cy)
    for i in range(plan.grid):
        staged = [_conv1_row(blob, img, b, r, s * conv_plan.STRIP)
                  for b, s, r in conv_plan.staged_rows(plan, i)]
        for b, s, q, k0, _, _ in conv_plan.pair_rows(plan, i):
            x0 = s * conv_plan.STRIP
            acc = _pair(staged[k0:k0 + 4], w2)
            for m in range(2):
                x = [_bn_selu(acc[r][m], bn[2], bn[3]) for r in range(2)]
                v = (_r(x[0]) + x[1]) * 0.5  # the two accumulator sets
                pooled = (v[0::2] + v[1::2]) * 0.5  # lanes 4 apart
                ox = x0 // 2 + 32 * m + torch.arange(32)
                ok = ox < w // 2
                x1p[b, :, q, ox[ok]] = _r(pooled[ok]).T
                seen_p[b, q, ox[ok]] += 1
                xs = x0 + 64 * m + torch.arange(64)
                ok = xs < w
                for r in range(2):
                    a = torch.cat([_r(x[r]), torch.zeros(64, 16 - c1)], 1)
                    cols = nn.selu(_r(a @ wy.T))  # column n: channel chan[n]
                    out = torch.empty(64, cy)
                    out[:, chan] = cols
                    y1[b, 2 * q + r, xs[ok]] = _r(out[ok])
                    seen_y[b, 2 * q + r, xs[ok]] += 1
    assert torch.equal(seen_y, torch.ones_like(seen_y))
    assert torch.equal(seen_p, torch.ones_like(seen_p))
    return y1, x1p


@functools.lru_cache(maxsize=None)
def _case(name, shape):
    jp, tp = _al_params(name)
    b, h, w = shape
    img = np.random.default_rng(12).uniform(0, 1, (b, h, w, 3)).astype(np.float32)
    x = torch.from_numpy(np.ascontiguousarray(img.transpose(0, 3, 1, 2))).to(BF)
    c1 = tp["block1"]["conv2"]["w"].shape[0]
    jy1, jx = _strict(jstem, _padded16(jp), jnp.asarray(img).astype(jnp.bfloat16),
                      mp=True, interpret=True)
    return (x, np.asarray(jy1, np.float32)[..., :2 * c1],
            np.asarray(jx, np.float32)[..., :c1])


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", NAMES)
def test_decomposition_vs_plain_and_jax(name, shape, sms):
    _, tp = _al_params(name)
    x, jy1, jx = _case(name, shape)
    y1, x1p = emulate(tp, x, sms)
    py1, px1p = aliked_stem.fused_aliked_stem_plain(tp, x)
    _close(y1, py1.float())
    _close(x1p, px1p.float())
    _close(y1, jy1)
    _close(x1p.permute(0, 2, 3, 1), jx)


@pytest.mark.parametrize("name", NAMES)
def test_conv1_is_zero_outside_the_image(name):
    """The staged rows above and below the image and the pixels left and
    right of it are 0, not SELU(BN(0)) (which is not 0 for these batch
    norms)."""
    _, tp = _al_params(name)
    blob = _blob(tp)
    bn = blob[3]
    assert float(_bn_selu(torch.zeros(1, bn.shape[1]), bn[0], bn[1]).abs().max()) > 0
    img = torch.rand(1, 3, 8, 20, generator=torch.Generator().manual_seed(0)).to(BF)
    for r in (-1, 8):
        assert torch.equal(_conv1_row(blob, img, 0, r, 0), torch.zeros(RP, bn.shape[1]))
    row = _conv1_row(blob, img, 0, 3, 0)  # pixel 0 is x = -1; 21 .. are x >= 20
    assert torch.equal(row[0], torch.zeros(bn.shape[1]))
    assert torch.equal(row[21:], torch.zeros(RP - 21, bn.shape[1]))
    assert float(row[1:21].abs().sum()) > 0
    # a second strip: its pixel 0 is x = 127, inside a wide image
    wide = torch.rand(1, 3, 4, 200, generator=torch.Generator().manual_seed(1)).to(BF)
    row = _conv1_row(blob, wide, 0, 1, 128)
    assert float(row[0].abs().sum()) > 0 and torch.equal(row[73:], torch.zeros(RP - 73, bn.shape[1]))


# --- the plan -----------------------------------------------------------------


@pytest.mark.parametrize("b, h, w, sms", [
    (1, 768, 1024, 132), (2, 768, 1024, 132), (8, 768, 1024, 132),
    (1, 40, 72, 132), (2, 34, 136, 3), (3, 10, 300, 7)])
def test_plan_covers_every_unit_once_and_fills_the_sms(b, h, w, sms):
    """PER_SM (3) blocks an SM where there are units enough (at B 1, 768 x
    1024, 3072 units on 396 blocks), each a run within one unit of the
    others."""
    p = conv_plan.plan(b, h, w, aliked_stem.PER_SM * sms)
    assert p.grid == min(aliked_stem.PER_SM * sms, p.units)
    if h == 768:
        assert p.grid == _const("PER_SM") * sms == 3 * sms
    seen = np.zeros((b, p.strips, p.pairs), np.int64)
    runs = []
    for i in range(p.grid):
        n = 0
        for bb, s, q0, q1 in p.segments(i):
            seen[bb, s, q0:q1] += 1
            n += q1 - q0
        runs.append(n)
    assert (seen == 1).all()
    assert max(runs) - min(runs) <= 1 and min(runs) >= 1


# --- the staged rows, descriptors, resources -----------------------------------


def test_header_constants_match_the_port():
    assert _const("PER_SM") == aliked_stem.PER_SM
    assert "constexpr int STRIP = wconv::STRIP;" in HEADER
    assert conv_plan.STRIP == 128 and conv_plan.STAGED == RP
    assert "const uint32_t box[3] = {IMW, 1, 3};" in HEADER
    for c1 in (8, 16):
        assert aliked_stem.bf16_layout(c1).size == _geo(c1)["kWeights"]


@pytest.mark.parametrize("c1", [16, 8])
def test_tap_descriptors_read_inside_the_staged_ring(c1):
    """conv2's k-steps read staged rows r + dy of the pair's four (r, dy <
    2, 3), pixels 64 m + dx .. + 63 (at C1 8 chunk 1 one pixel further)
    inside the RP staged; a pixel past the 130 written only with zero
    weights (C1 8, the (dy, 2) steps' zero partner). conv1's tiles read
    taps pixels inside the TP laid out, and cover pixels 0 .. 129 once."""
    steps = 9 if c1 == 16 else 6
    _, tp = _al_params("aliked-n16" if c1 == 16 else "aliked-t16")
    w2 = _blob(tp)[1]
    taps = set()
    for st in range(steps):
        dy, dx = _step(c1, st)
        assert 0 <= dy < 3 and 0 <= dx < 3 and (c1 == 16 or dx + 1 <= 3)
        for m in range(2):
            first = 64 * m + dx
            last = first + 63 + (1 if c1 == 8 else 0)
            assert 0 <= first and last < RP
            if last >= READ_PX:  # only the zero partner reads past the rows
                assert c1 == 8 and dx == 2 and torch.equal(w2[st][:, 8:], torch.zeros(c1, 8))
            taps.add((dy, dx))
            if c1 == 8 and dx < 2:
                taps.add((dy, dx + 1))
    assert taps == {(dy, dx) for dy in range(3) for dx in range(3)}
    covered = []
    for s0 in TILES:
        assert s0 + 2 + 63 < TP
        covered += [p for p in range(s0, s0 + 64) if s0 < 66 or p >= 128]
    assert sorted(covered) == list(range(READ_PX))
    # the taps' image columns: pixel c reads box column c + 6 (x0 - 2 + c),
    # the box from x0 - 8 on a 16-byte boundary, IMW columns
    assert "4 * i + 12" in HEADER and "x0 - 8," in HEADER
    assert (TP - 1) + 6 < IMW and (IMW * 2) % 16 == 0
    for x0 in range(0, 4096, 128):
        assert ((x0 - 8) * 2) % 16 == 0
    # the descriptors: a row's from pixel 0 (LBO a plane, or at C1 8 one
    # pixel), moved 64 m + dx pixels in 16-byte units
    assert "desc_k(ring + ((k0 + i) % R) * G::kRow, C1 == 16 ? kPlane : 16)" in HEADER
    assert "drow[r + dy] + (64 * m + dx)" in HEADER
    assert "dtaps + (tile1(ti) + dx)" in HEADER


def _geo(c1):
    """csrc/aliked_wgmma.cuh's Geo<C1> byte offsets, computed as it does."""
    cy, steps, r = 2 * c1, 9 if c1 == 16 else 6, _const("R")
    k_weights = 3 * 2 * c1 * 16 + steps * 2 * c1 * 16 + 2 * cy * 16 + 128
    k_row = c1 // 8 * RP * 16
    o_img = k_weights + r * k_row + 2 * TP * 16
    o_stage = o_img + _const("IMG_SLOTS") * _const("kImgSlot")
    o_bar = o_stage + _const("NCONS") * c1 * 128
    return {"kWeights": k_weights, "kRow": k_row, "oImg": o_img, "oStage": o_stage,
            "bytes": 128 + o_bar + (2 * r + _const("IMG_SLOTS") + 1) * 8}


@pytest.mark.parametrize("c1", [16, 8])
def test_shared_memory_and_registers_fit_three_blocks_an_sm(c1):
    """The blob, R (8) staged rows, a row's taps, the image boxes, the
    consumer's x1p staging and the barriers: PER_SM blocks fit an SM's
    shared memory (each with the 1 KB the system keeps); every TMA
    destination on a 128-byte boundary; setmaxnreg's split within the 80
    registers a thread of 3 x 256 the launch gives."""
    g = _geo(c1)
    per_sm, ncons = _const("PER_SM"), _const("NCONS")
    assert per_sm * (g["bytes"] + 1024) <= SMEM_SM and g["bytes"] <= SMEM_MAX
    for k in ("kWeights", "kRow", "oImg", "oStage"):
        assert g[k] % 128 == 0, k
    assert _const("kImgSlot") % 128 == 0 and _const("kImgSlot") >= 3 * IMW * 2
    assert _const("IMG_SLOTS") >= _const("IMG_AHEAD") + 3 + 1
    m = re.search(r"kProdRegs = (\d+), kConsRegs = (\d+)", HEADER)
    threads = 128 * (ncons + 1)
    cap = 65536 // (threads * per_sm) // 8 * 8
    assert cap == 80 and 128 * int(m.group(1)) + 128 * ncons * int(m.group(2)) <= threads * cap


def test_pool_and_y1_lanes_cover_their_outputs_once():
    """The consumer's accumulator row 16 warp + g + 8 h is pixel 64 m + ..
    of the strip; the column pair is g and g ^ 1 (lanes 4 apart); lane g
    even stages channel 2t, g odd 2t + 1 at pooled column 32 m + 8 warp + 4
    h + g / 2: every (channel, pooled column) once, at distinct staging
    addresses. The 1x1's column 8 j + 2t + e is channel (CY / 4) t + 2 j +
    e: lane t holds CY / 4 consecutive channels of its pixel, in order."""
    for c1 in (8, 16):
        seen = {}
        for m in range(2):
            for warp in range(4):
                for g in range(8):
                    for t in range(4):
                        for h in range(2):
                            px = 64 * m + 16 * warp + g + 8 * h
                            partner = 64 * m + 16 * warp + (g ^ 1) + 8 * h
                            assert {px, partner} == {px & ~1, (px & ~1) + 1}
                            for jj in range(c1 // 8):
                                e = g & 1
                                c = 8 * jj + 2 * t + e
                                p = 32 * m + 8 * warp + 4 * h + (g >> 1)
                                assert p == px // 2
                                addr = c * 128 + (((p >> 3) ^ (c & 7)) << 4) + (p & 7) * 2
                                assert seen.setdefault((c, p), addr) == addr
        assert sorted(seen) == [(c, p) for c in range(c1) for p in range(64)]
        assert len(set(seen.values())) == len(seen)
        cy = 2 * c1
        chan = aliked_stem.y1_channel(cy)
        assert sorted(chan.tolist()) == list(range(cy))
        for t in range(4):
            cols = [8 * j + 2 * t + e for j in range(cy // 8) for e in range(2)]
            assert chan[cols].tolist() == list(range(cy // 4 * t, cy // 4 * (t + 1)))


# --- prepared weights -----------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_prepare_bf16_layout(name):
    """conv1 [dx][chunk][co][8] with K (ci, dy) = 3 ci + dy, zero past 8;
    conv2 a tap a step at C1 16, taps (dy, 2s), (dy, 2s + 1) at C1 8 (the
    partner of (dy, 2) zero); the 1x1's rows in y1_channel order, zero
    past C1; bn1's and bn2's folded scales and biases; all bf16."""
    _, tp = _al_params(name)
    bp = tp["block1"]
    c1 = bp["conv2"]["w"].shape[0]
    blob = aliked_stem.prepare_bf16(tp)
    assert blob.dtype == BF and blob.is_contiguous()
    assert 2 * blob.numel() == aliked_stem.bf16_layout(c1).size
    w1, w2, wy, bn = _blob(tp)
    wc1 = _r(bp["conv1"]["w"])  # [co][ci][dy][dx]
    for dx in range(3):
        for ci in range(3):
            for dy in range(3):
                assert torch.equal(w1[dx][:, 3 * ci + dy], wc1[:, ci, dy, dx])
    assert torch.equal(w1[:, :, 9:], torch.zeros(3, c1, 7))
    wc2 = _r(bp["conv2"]["w"])
    for st in range(w2.shape[0]):
        dy, dx = _step(c1, st)
        if c1 == 16:
            assert torch.equal(w2[st], wc2[:, :, dy, dx])
        else:
            assert torch.equal(w2[st][:, :8], wc2[:, :, dy, dx])
            want = wc2[:, :, dy, dx + 1] if dx + 1 < 3 else torch.zeros(c1, c1)
            assert torch.equal(w2[st][:, 8:], want)
    wc = _r(tp["conv1"]["w"][:, :, 0, 0])
    chan = aliked_stem.y1_channel(2 * c1)
    assert torch.equal(wy[:, :c1], wc[chan])
    assert torch.equal(wy[:, c1:], torch.zeros(2 * c1, 16 - c1))
    folded = [*nn.fold_batch_norm(bp["bn1"]), *nn.fold_batch_norm(bp["bn2"])]
    for got, want in zip(bn, folded):
        assert torch.equal(got, nn.round_bf16(want))


def test_prepared_is_built_once_per_tree_with_its_map_cache(monkeypatch):
    """``prepared`` keeps one Prepared16 a tree (its blob and its tensor
    maps) beside the fp32 form's weights; a new tree builds anew. A map is
    encoded once an (address, shape) and served again from the cache, at
    most MAPS kept, the oldest dropped first."""
    _, tp = _al_params("aliked-n16")
    tree = {"block1": dict(tp["block1"]), "conv1": tp["conv1"]}
    got = aliked_stem.prepared(tree, BF)
    assert isinstance(got, tma_maps.Prepared16)
    assert aliked_stem.prepared(tree, BF) is got
    assert aliked_stem.prepared(tree) is not got
    assert torch.equal(got.weights, aliked_stem.prepare_bf16(tree))
    other = {"block1": {**tree["block1"],
                        "conv2": {"w": tree["block1"]["conv2"]["w"].clone()}},
             "conv1": tree["conv1"]}
    assert aliked_stem.prepared(other, BF) is not got
    calls = []

    def encode(entry, device, buf, image, b, h, wp):
        assert entry == "lg_aliked_stem_bf16_map" and buf.numel() == 128
        calls.append((image.data_ptr(), b, h, wp))
        buf.fill_(len(calls))

    monkeypatch.setattr(_build, "launch", encode)
    image_map = functools.partial(tma_maps.tensor_map, got, "lg_aliked_stem_bf16_map")
    imgs = [torch.zeros(1, 3, 8, 16, dtype=BF) for _ in range(tma_maps.MAPS + 1)]
    first = image_map(imgs[0])
    assert image_map(imgs[0]) is first and len(calls) == 1
    assert image_map(imgs[0][:, :, :6]) is not first  # another shape
    for x in imgs[1:]:
        image_map(x)
    assert len(got.maps) == tma_maps.MAPS
    n = len(calls)
    image_map(imgs[-1])
    assert len(calls) == n  # kept
    image_map(imgs[0])
    assert len(calls) == n + 1  # dropped as the oldest, encoded again
