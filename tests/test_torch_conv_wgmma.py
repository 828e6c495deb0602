"""The bf16 3x3 convolution behind B7's and B8's bf16 forms
(csrc/conv_wgmma.cuh) on the CPU, at small sizes, on seeded numpy inputs.

- The kernel's decomposition in plain PyTorch, block by block as
  ops/conv_plan.py cuts a launch: conv1a as a (pixels x 16) @ (16 x 64)
  product of the rounded image's taps (K = 9 taps in the TPU kernel's
  order 3 dx + dy, zero-padded to 16) and the rounded weights, its fp32 sum
  rounded before the bias, ReLU, rounded, 0 outside the image, into each
  segment's staged rows (136 pixels, x0 - 1 ..); conv1b per tap in the
  kernel's k order (dy, dx, 16-channel step) on 128 pixels of the staged
  rows moved dx pixels; the pool over the two accumulator sets and the
  horizontal neighbours; B8 as two launches through an NHWC scratch. Every
  output is written exactly once. Held against ``fused_stem_plain(mp=True)``
  / ``fused_block2_plain`` and against JAX's ``fused_stem_pallas`` /
  ``fused_block2_pallas`` at mp in interpret mode, with
  tests/test_torch_mp_extract.py's bf16 bounds (|got - want| <= 2e-2 max(1,
  |want|) and <= 2^-6 (|want| + rms(want's row)), elementwise: the sums
  are taken in another order, so a sum at a bf16 rounding boundary can
  round to the other neighbour), on images ragged against the strips, with
  one block an SM and with so few SMs that a block walks several segments
  across strips and images.
- The plan: every unit once, the runs within one unit of each other, as
  many blocks as SMs; each staged row two pairs' arrivals.
- The staged rows and descriptors, read from conv_wgmma.cuh: every tap's B
  descriptor starts inside its staged row and its 128 pixels inside the
  pixels the producer writes; conv1a's 32-byte swizzled tiles; shared
  memory and registers fit an H100.
- ``prepare_conv``'s bf16 layout (the 128-byte swizzle: chunk c of output
  channel co's row at chunk c ^ (co % 8)) and ``prepared_conv``'s cache.
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu import weights as jweights
from lightglue_tpu.models import superpoint as jsp
from lightglue_tpu.ops.stem import fused_stem_pallas
from lightglue_tpu.ops.stem2 import fused_block2_pallas
from lightglue_tpu_torch import nn, weights
from lightglue_tpu_torch.ops import conv_plan, stem, stem2

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False

BF = torch.bfloat16
REL = 2e-2  # tests/test_torch_mp_extract.py's bounds
SCALED = 2.0 ** -6
HEADER = (Path(__file__).resolve().parents[1] / "lightglue_tpu_torch" / "csrc"
          / "conv_wgmma.cuh").read_text()
SMEM_MAX = 232448  # bytes of shared memory a block may take on an H100
SHAPES = [(2, 40, 72), (1, 24, 136)]  # ragged against the 128-column strips
SMS = [132, 3]  # one block a unit; a few blocks walking several segments


def _const(name):
    return int(re.search(rf"constexpr int [^;]*\b{name} = (\d+)", HEADER).group(1))


@functools.lru_cache(maxsize=None)
def _params():
    """The JAX package's SuperPoint init (key 0), conv weights times 3 (the
    stand-in for trained weights), as (JAX tree, port tree)."""
    flat = jweights.flatten_tree(jsp.init_params(jax.random.key(0)))
    flat = {k: np.asarray(v) * (3.0 if k.endswith("/w") else 1.0)
            for k, v in flat.items()}
    return (jweights.unflatten_tree(flat),
            weights.superpoint_from_jax_params(flat))


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


def _unswizzle(prep):
    """prepare_conv's bf16 (9, 64, 64) as the kernel's A descriptors read
    it: [tap][co][ci]."""
    co = torch.arange(64)[:, None]
    ci = torch.arange(64)[None, :]
    return prep.float()[:, co, 8 * ((ci // 8) ^ (co % 8)) + ci % 8]


# --- the decomposition --------------------------------------------------------


def _conv1a_row(p, img, b, r, x0):
    """The staged row r of conv1a (136 pixels from x0 - 1, 64 channels) as
    the producer computes it: (136 x 16) taps @ (16 x 64) weights."""
    _, _, h, w = img.shape
    rp = conv_plan.STAGED
    if not 0 <= r < h:
        return torch.zeros(rp, 64)
    xs = x0 - 1 + torch.arange(rp)
    taps = torch.zeros(rp, 16)
    wk = torch.zeros(64, 16)
    for k in range(9):  # tap k = 3 dx + dy (lightglue_tpu/ops/stem.py:100)
        dy, dx = k % 3, k // 3
        y, x = r - 1 + dy, xs + dx - 1
        ok = (0 <= y < h) & (x >= 0) & (x < w)
        taps[:, k] = torch.where(
            ok, _r(img[b, 0, min(max(y, 0), h - 1)][x.clamp(0, w - 1)]), 0.0)
        wk[:, k] = _r(p["w"][:, 0, dy, dx])
    s = taps @ wk.T  # fp32 sums of exact bf16 products
    v = _r(torch.relu(_r(s) + p["b"]))
    return torch.where(((xs >= 0) & (xs < w))[:, None], v, torch.zeros(()))


def _map_row(x, b, r, x0):
    """Staged row r of an NHWC map (B, H, W, 64): TMA's box from x0 - 1,
    zeros outside the map."""
    _, h, w, _ = x.shape
    rp = conv_plan.STAGED
    row = torch.zeros(rp, 64)
    if 0 <= r < h:
        xs = x0 - 1 + torch.arange(rp)
        ok = (xs >= 0) & (xs < w)
        row[ok] = x[b, r, xs[ok]].float()
    return row


def _pair(rows, wt):
    """A pair's two accumulator sets (128 pixels x 64 channels each): taps
    in the kernel's k order (dy, dx, 16-channel step), tap (dy, dx) reading
    staged row dy (dy + 1) moved dx pixels."""
    acc = [torch.zeros(128, 64), torch.zeros(128, 64)]
    for tap in range(9):
        dy, dx = tap // 3, tap % 3
        for kk in range(4):
            c = slice(16 * kk, 16 * kk + 16)
            for y in (0, 1):
                acc[y] += rows[y + dy][dx:dx + 128, c] @ wt[tap][:, c].T
    return acc


def _walk(p, plan, row_of, epilogue):
    """Every block of ``plan``: its staged rows (row_of(b, r, x0)), its
    pairs' products and epilogues, each staged row read by two pairs."""
    wt = _unswizzle(stem.prepare_conv(p["w"], BF))
    for i in range(plan.grid):
        staged = [row_of(b, r, s * conv_plan.STRIP)
                  for b, s, r in conv_plan.staged_rows(plan, i)]
        for b, s, q, k0, _, _ in conv_plan.pair_rows(plan, i):
            epilogue(b, s, q, _pair(staged[k0:k0 + 4], wt), p["b"])


def _pooled(acc, bias):
    """The register-local pool: columns 2p, 2p + 1 of both sets, then the
    rounding before the bias, ReLU, bf16 (max commutes with all three)."""
    m = torch.maximum(acc[0], acc[1]).reshape(64, 2, 64).amax(1)
    return _r(torch.relu(_r(m) + bias))


def emulate_stem(params, img, sms):
    """B7's bf16 form as the kernel computes it: (B, H/2, W/2, 64)."""
    bsz, _, h, w = img.shape
    plan = conv_plan.plan(bsz, h, w, sms)
    out = torch.full((bsz, h // 2, w // 2, 64), float("nan"))
    seen = torch.zeros(bsz, h // 2, w // 2, dtype=torch.int64)

    def epi(b, s, q, acc, bias):
        ox = s * conv_plan.STRIP // 2 + torch.arange(64)
        ok = ox < w // 2
        out[b, q, ox[ok]] = _pooled(acc, bias)[ok]
        seen[b, q, ox[ok]] += 1

    _walk(params["conv1b"], plan,
          lambda b, r, x0: _conv1a_row(params["conv1a"], img, b, r, x0), epi)
    assert torch.equal(seen, torch.ones_like(seen))
    return out


def emulate_conv3x3(p, x, pool, sms):
    """One launch of B8's bf16 form on an NHWC map (B, H, W, 64): the
    scratch (B, H, W, 64), or the pooled (B, 64, H/2, W/2)."""
    bsz, h, w, _ = x.shape
    plan = conv_plan.plan(bsz, h, w, sms)
    shape = (bsz, 64, h // 2, w // 2) if pool else (bsz, h, w, 64)
    out = torch.full(shape, float("nan"))
    seen = torch.zeros(shape[:-1] if not pool else (bsz, h // 2, w // 2),
                       dtype=torch.int64)

    def epi(b, s, q, acc, bias):
        x0 = s * conv_plan.STRIP
        if pool:
            ox = x0 // 2 + torch.arange(64)
            ok = ox < w // 2
            out[b, :, q, ox[ok]] = _pooled(acc, bias)[ok].T
            seen[b, q, ox[ok]] += 1
            return
        xs = x0 + torch.arange(128)
        ok = xs < w
        for y in (0, 1):
            out[b, 2 * q + y, xs[ok]] = _r(torch.relu(_r(acc[y]) + bias))[ok]
            seen[b, 2 * q + y, xs[ok]] += 1

    _walk(p, plan, lambda b, r, x0: _map_row(x, b, r, x0), epi)
    assert torch.equal(seen, torch.ones_like(seen))
    return out


def emulate_block2(params, x, sms):
    """B8's bf16 form: conv2a into the NHWC scratch, conv2b with the pool,
    from a (B, 64, H, W) map (read NHWC)."""
    a = emulate_conv3x3(params["conv2a"], x.permute(0, 2, 3, 1).float(),
                        False, sms)
    return emulate_conv3x3(params["conv2b"], a, True, sms)


@functools.lru_cache(maxsize=None)
def _stem_case(shape):
    jp, tp = _params()
    b, h, w = shape
    img = np.random.default_rng(11).uniform(0, 1, (b, h, w, 1)).astype(np.float32)
    x = torch.from_numpy(np.ascontiguousarray(img.transpose(0, 3, 1, 2)))
    want = _strict(fused_stem_pallas,
                   {"conv1a": jp["conv1a"], "conv1b": jp["conv1b"]},
                   jnp.asarray(img), mp=True, interpret=True,
                   out_layout="cplane")  # (B, H/2, 64, W/2)
    return x, want


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("shape", SHAPES)
def test_stem_decomposition_vs_plain_and_pallas(shape, sms):
    _, tp = _params()
    x, want = _stem_case(shape)
    p1 = {"conv1a": tp["conv1a"], "conv1b": tp["conv1b"]}
    got = emulate_stem(p1, x, sms)  # (B, H/2, W/2, 64)
    plain = stem.fused_stem_plain(p1, x, mp=True)
    _close(got.permute(0, 3, 1, 2), plain.float())
    _close(got.permute(0, 1, 3, 2), np.asarray(want, np.float32))


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("shape", SHAPES)
def test_block2_decomposition_vs_plain_and_pallas(shape, sms):
    jp, tp = _params()
    x7, want7 = _stem_case(shape)
    b, h, w = shape
    p2 = {"conv2a": tp["conv2a"], "conv2b": tp["conv2b"]}
    x = stem.fused_stem_plain({"conv1a": tp["conv1a"], "conv1b": tp["conv1b"]},
                              x7, mp=True)
    got = emulate_block2(p2, x, sms)
    _close(got, stem2.fused_block2_plain(p2, x).float())
    # conv2a alone: the NHWC scratch against B8's first launch's plain version
    a = emulate_conv3x3(p2["conv2a"], x.permute(0, 2, 3, 1).float(), False, sms)
    _close(a.permute(0, 3, 1, 2), stem2.conv3x3_relu_plain(p2["conv2a"], x).float())
    pad = jnp.pad(want7, ((0, 0), (0, 0), (0, 0),
                          (0, -(-(w // 2) // 128) * 128 - w // 2)))
    want = _strict(fused_block2_pallas,
                   {"conv2a": jp["conv2a"], "conv2b": jp["conv2b"]}, pad,
                   h2=h // 2, w2=w // 2, mp=True, interpret=True)
    _close(got.permute(0, 2, 3, 1), np.asarray(want, np.float32))


def test_conv1a_is_zero_outside_the_image():
    """The staged rows above and below the image and the pixels left and
    right of it are 0, not conv1a of zeros plus its bias (the bias alone
    would be relu(b1a), which is not 0 for these weights)."""
    _, tp = _params()
    p = tp["conv1a"]
    assert float(torch.relu(p["b"]).max()) > 0
    img = torch.rand(1, 1, 8, 20, generator=torch.Generator().manual_seed(0))
    for r in (-1, 8):
        assert torch.equal(_conv1a_row(p, img, 0, r, 0), torch.zeros(136, 64))
    row = _conv1a_row(p, img, 0, 3, 0)  # pixel 0 is x = -1; 21 .. are x >= 20
    assert torch.equal(row[0], torch.zeros(64)) and torch.equal(row[21:], torch.zeros(115, 64))
    assert float(row[1:21].abs().sum()) > 0


# --- the plan -----------------------------------------------------------------


@pytest.mark.parametrize("b, h, w, sms", [
    (1, 768, 1024, 132), (2, 768, 1024, 132), (8, 384, 512, 132),
    (1, 24, 136, 132), (2, 40, 72, 3), (3, 10, 300, 7), (1, 2, 2, 132)])
def test_plan_covers_every_unit_once_and_fills_the_sms(b, h, w, sms):
    p = conv_plan.plan(b, h, w, sms)
    assert p.strips == -(-w // conv_plan.STRIP) and p.pairs == h // 2
    assert p.grid == min(sms, p.units)
    seen = np.zeros((b, p.strips, p.pairs), np.int64)
    runs = []
    for i in range(p.grid):
        n = 0
        for bb, s, q0, q1 in p.segments(i):
            assert 0 <= q0 < q1 <= p.pairs
            seen[bb, s, q0:q1] += 1
            n += q1 - q0
        runs.append(n)
    assert (seen == 1).all()
    assert max(runs) - min(runs) <= 1 and min(runs) >= 1


@pytest.mark.parametrize("b, h, w, sms", [(2, 40, 72, 3), (3, 10, 300, 7),
                                          (1, 768, 1024, 132)])
def test_each_staged_row_gets_two_pairs_arrivals(b, h, w, sms):
    """The empty barrier of a staged row completes on two pairs' arrivals:
    each pair arrives on its four rows, a segment's first pair twice more
    on its first two, its last pair on its last two; and a pair's rows are
    its output rows' neighbours (2q - 1 .. 2q + 2)."""
    p = conv_plan.plan(b, h, w, sms)
    for i in range(p.grid):
        rows = list(conv_plan.staged_rows(p, i))
        arrivals = np.zeros(len(rows), np.int64)
        for bb, s, q, k0, first, last in conv_plan.pair_rows(p, i):
            assert rows[k0:k0 + 4] == [(bb, s, r) for r in range(2 * q - 1, 2 * q + 3)]
            arrivals[k0:k0 + 4] += 1
            arrivals[k0:k0 + 2] += first
            arrivals[k0 + 2:k0 + 4] += last
        assert (arrivals == 2).all()


# --- staged rows, descriptors, resources --------------------------------------


def test_header_constants_match_the_plan():
    assert _const("STRIP") == conv_plan.STRIP
    assert _const("RP") == conv_plan.STAGED


def test_tap_descriptors_start_inside_the_staged_row():
    """Staged rows and weight slabs start on 1024-byte boundaries (the
    128-byte swizzle's pattern); tap (dy, dx)'s B descriptor at step kk
    starts dx x 128 + 32 kk bytes into its row, on row dx of the pattern
    (wgmma swizzles by the address bits, so its base offset stays 0: with
    dx there every output is wrong on the card, scripts/conv_wgmma_study.py),
    and its 128 pixels dx .. dx + 127 lie inside the 130 the producer
    writes of the 136 staged; the image row the taps read (x0 - 4 ..)
    holds every pixel's taps."""
    rp, strip = _const("RP"), _const("STRIP")
    row, tap = rp * 128, 64 * 128
    weights_bytes = 9 * tap
    assert row % 1024 == 0 and tap % 1024 == 0 and weights_bytes % 1024 == 0
    written = conv_plan.READ  # pixels 0 .. 129: x0 - 1 .. x0 + 128
    assert written == strip + 2 <= rp
    for dx in range(3):
        for kk in range(4):
            start = dx * 128 + 32 * kk
            assert (start % 1024) >> 7 == dx  # the pattern row it starts on
            assert (start & 127) + 32 <= 128  # the step stays in its row
            last = start + (strip - 1) * 128 + 32
            assert last <= written * 128 <= row
    img_row = _const("IMG_ROW")
    assert rp - 1 + 2 + 2 < img_row and img_row % 4 == 0
    assert "wg::desc_sw128(r0 + 32 * kk, 16, 1024)" in HEADER


@pytest.mark.parametrize("src", ["kImage", "kMap"])
def test_shared_memory_and_registers_fit_an_h100(src):
    """The layout Geo<kSrc> computes: the weights, 8 staged rows, two
    consumers' staging (the stem's 4 KB: 32 pooled pixels), and for the
    stem conv1a's weight tile, one row's taps and the image ring; the
    32-byte swizzled tiles on 256-byte boundaries; setmaxnreg's split
    within the 168 registers a thread of 384 the block launches with."""
    rp, img_row = _const("RP"), _const("IMG_ROW")
    slots = _const("IMG_SLOTS")
    assert "static constexpr int R = 8;" in HEADER
    image = src == "kImage"
    stage = 32 * 128 if image else 64 * 128
    o_w1a = 9 * 64 * 128 + 8 * rp * 128 + 2 * stage
    o_col = o_w1a + (64 * 32 if image else 0)
    o_img = o_col + (rp * 32 if image else 0)
    o_bar = o_img + (slots * img_row * 4 if image else 0)
    assert o_w1a % 256 == 0 and o_col % 256 == 0 and o_img % 16 == 0
    assert 1024 + o_bar + (2 * 8 + 1) * 8 <= SMEM_MAX
    prod, cons = (72, 216) if image else (40, 232)
    assert 128 * prod + 256 * cons <= 384 * 168
    assert "kProdRegs = kSrc == kImage ? 72 : 40" in HEADER
    assert "kConsRegs = kSrc == kImage ? 216 : 232" in HEADER
    # the image ring: slots past the rows in flight and the three read
    assert slots > _const("IMG_AHEAD") + 3


def test_conv1a_tiles_are_the_32_byte_swizzle():
    """conv1a's operands (the weights, 64 x 16 taps, and a staged row's
    taps, 136 pixels x 16) as ``at16`` lays them: 32-byte rows, chunk k / 8
    at (k / 8) ^ ((r / 4) % 2), every element once inside the tile; the two
    products read pixels 0 .. 63 and 64 .. 135, the second from a 256-byte
    boundary."""
    def at16(r, k):
        return r * 32 + (((k >> 3) ^ ((r >> 2) & 1)) << 4) + (k & 7) * 2
    assert "return r * 32 + (((k >> 3) ^ ((r >> 2) & 1)) << 4) + (k & 7) * 2;" in HEADER
    rp = _const("RP")
    seen = sorted(at16(r, k) for r in range(rp) for k in range(16))
    assert seen == list(range(0, rp * 32, 2))
    assert (32 * 64) % 256 == 0 and 64 + 72 == rp
    assert "conv1a_part<64>(W1, Col, 0," in HEADER
    assert "conv1a_part<72>(W1, Col, 64," in HEADER


# --- prepared weights -----------------------------------------------------------


def test_prepare_conv_bf16_is_the_128_byte_swizzle():
    """Output channel co's row of tap (dy, dx) holds its 64 input channels
    K-major, the 16-byte chunk c (channels 8c .. 8c + 7) at chunk c ^ (co %
    8): the layout TMA's 128-byte swizzle writes and wgmma reads, so the
    kernel copies it into shared memory as it lies."""
    _, tp = _params()
    w = tp["conv1b"]["w"]
    prep = stem.prepare_conv(w, BF)
    assert prep.shape == (9, 64, 64) and prep.dtype == BF and prep.is_contiguous()
    wt = w.permute(2, 3, 0, 1).reshape(9, 64, 64).to(BF)  # [tap (dy, dx)][co][ci]
    chunks = prep.reshape(9, 64, 8, 8)
    for co in range(64):
        for c in range(8):
            assert torch.equal(chunks[:, co, c ^ (co % 8)], wt[:, co, 8 * c:8 * c + 8])
    assert torch.equal(_unswizzle(prep), wt.float())


def test_prepared_conv_bf16_is_built_once_per_tensor():
    _, tp = _params()
    w = tp["conv2b"]["w"].clone()
    first = stem.prepared_conv(w, BF)
    assert stem.prepared_conv(w, BF) is first
    assert stem.prepared_conv(w) is not first
    assert torch.equal(stem.prepared_conv(w.clone(), BF), first)
    assert stem.prepared_conv(w.clone(), BF) is not first


def test_bf16_maps_are_read_nhwc():
    """B8's bf16 form reads an NHWC map: B7's bf16 output as it is (no
    copy), any other layout or an unaligned start through one copy, the
    values unchanged."""
    x = torch.rand(2, 64, 6, 10).to(BF)
    y = stem2.nhwc(x)
    assert y.is_contiguous(memory_format=torch.channels_last) and torch.equal(x, y)
    assert stem2.nhwc(y) is y
    buf = torch.empty(y.numel() + 1, dtype=BF)
    z = buf[1:].view(2, 6, 10, 64).permute(0, 3, 1, 2)
    z.copy_(x)
    assert z.data_ptr() % 16 and stem2.nhwc(z).data_ptr() % 16 == 0
    assert torch.equal(stem2.nhwc(z), x)


def test_nn_round_is_the_kernels_rounding():
    """The decomposition's rounding (``_r``) is the plain versions'."""
    v = torch.randn(1000) * 10
    assert torch.equal(_r(v), nn.round_bf16(v))
