"""B9's design (csrc/nms.cu) emulated in plain PyTorch on the CPU, held
bitwise against ``simple_nms_plain`` and JAX's ``simple_nms_pallas`` in
interpret mode, on seeded numpy inputs.

The emulation follows the kernel block by block, at the tiles read from
nms.cu: each block's buffer (its output tile with a halo of r per sliding
max, -inf outside the image and past the buffer's width), the row and
column passes, the masks as 32-bit words with bit j of word k the column
32 k + j, the dilation W(m) > 0 as a window OR of words (2r + 1 rows, then
funnel shifts of up to r bits across word boundaries), and the suppressed
scores recomputed from the bits. Both plans of the template: the passes
that nms.cu builds (m with a halo of r, then two rounds with 2 r, bit
masks between them, read at any column offset as the kernel's
``load_bits`` does) and the fused one that scripts/extract_study.py builds
(a halo of 5 r, floats out). Max and compare only, so every case must agree to the
bit: radii 0-8, plateaus of tied scores, all-negative maps, widths that are
not multiples of 32, maps smaller than a tile.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lightglue_tpu.ops.nms import simple_nms_pallas
from lightglue_tpu_torch.ops import nms

SRC = (Path(__file__).resolve().parents[1] / "lightglue_tpu_torch" / "csrc"
       / "nms.cu").read_text()
NEG = float("-inf")
MASK32 = (1 << 32) - 1


def _tile(name):
    """(rows, columns) of a tile line of nms.cu, as functions of r."""
    m = re.search(rf"using {name} = Geo<R, (\d+), ([^,]+), \w+>;", SRC)
    rows, cols = m.group(1), m.group(2)
    return lambda r: (int(rows), int(eval(cols, {"R": r})))  # noqa: S307


FUSED, PASS = _tile("FusedTile"), _tile("PassTile")
SEG = int(re.search(r"constexpr int SEG = (\d+);", SRC).group(1))


# --- words ---------------------------------------------------------------------


def pack(bits):
    """(..., 32 n) bool -> (..., n) int64 words, bit j of word k column 32 k + j."""
    w = bits.reshape(*bits.shape[:-1], -1, 32).long()
    return (w << torch.arange(32)).sum(-1)


def unpack(words):
    return ((words[..., None] >> torch.arange(32)) & 1).bool().flatten(-2)


def funnel_r(lo, hi, s):
    """__funnelshift_r: the low 32 bits of (hi:lo) >> s, s in 0..31."""
    return ((lo | (hi << 32)) >> s) & MASK32


def funnel_l(lo, hi, s):
    """__funnelshift_l: the high 32 bits of (hi:lo) << s."""
    return (((lo | (hi << 32)) << s) >> 32) & MASK32


def dilate(m, r):
    """Nms.cu's Block::dilate: OR of 2r + 1 rows of words, then of each word
    with its neighbours' bits shifted in by 1..r."""
    bh = m.shape[-2]
    v = torch.zeros_like(m)
    for dy in range(-r, r + 1):
        lo, hi = max(0, -dy), min(bh, bh - dy)
        v[..., lo:hi, :] |= m[..., lo + dy:hi + dy, :]
    left = F.pad(v, (1, 0))[..., :-1]
    right = F.pad(v, (0, 1))[..., 1:]
    h = v.clone()
    for d in range(1, r + 1):
        h |= funnel_r(v, right, d) | funnel_l(left, v, d)
    return h


# --- one block -------------------------------------------------------------------


def window_max(x, r, dim):
    """Sliding (2r + 1) max along ``dim`` within the buffer, -inf beyond."""
    xp = F.pad(x.movedim(dim, -1), (r, r), value=NEG)
    return xp.unfold(-1, 2 * r + 1, 1).amax(-1).movedim(-1, dim)


def blocks(s, r, th, tw, halo):
    """The buffers of every block of the grid: (b, ny, nx, BH, BWP) scores
    (-inf outside the image and past BW) and the inside mask, with the
    buffer's geometry."""
    b, h, w = s.shape
    bh, bw = th + 2 * halo, tw + 2 * halo
    bwp = 32 * -(-bw // 32)
    ny, nx = -(-h // th), -(-w // tw)
    pad = (halo, (nx - 1) * tw + bwp - w - halo, halo, ny * th + halo - h)
    sp = F.pad(s, pad, value=NEG)
    inside = F.pad(torch.ones_like(s, dtype=torch.bool), pad)
    tiles = sp.unfold(1, bh, th).unfold(2, bwp, tw)  # (b, ny, nx, bh, bwp)
    ins = inside.unfold(1, bh, th).unfold(2, bwp, tw).clone()
    ins[..., bw:] = False
    return torch.where(ins, tiles, NEG), ins, (ny, nx, bh, bw, bwp)


def first(S, ins, r):
    return pack((S == window_max(window_max(S, r, -1), r, -2)) & ins)


def one_round(S, ins, m, r):
    sup = dilate(m, r) & pack(ins)
    supb = unpack(sup)
    ss = torch.where(supb, torch.zeros_like(S), S)
    wm = window_max(window_max(ss, r, -1), r, -2)
    return m | pack((ss == wm) & ins & ~supb)


def fused_emulated(s, r):
    th, tw = FUSED(r)
    S, ins, (ny, nx, *_) = blocks(s, r, th, tw, 5 * r)
    m = first(S, ins, r)
    for _ in range(2):
        m = one_round(S, ins, m, r)
    out = torch.where(unpack(m), S, torch.zeros_like(S))
    c = out[..., 5 * r:5 * r + th, 5 * r:5 * r + tw]  # (b, ny, nx, th, tw)
    full = c.permute(0, 1, 3, 2, 4).reshape(s.shape[0], ny * th, nx * tw)
    return full[:, :s.shape[1], :s.shape[2]]


def load_bits(g, gx0, n):
    """Nms.cu's load_bits for buffer words 0 .. n - 1: 32 bits of global
    mask rows ``g`` (..., WW) from column gx0 + 32 k on, 0 outside the row."""
    ww = g.shape[-1]
    gp = F.pad(g, (2, 2))  # words -2 .. ww + 1
    zero = torch.zeros_like(g[..., 0])
    out = []
    for k in range(n):
        k0, sh = (gx0 + 32 * k) // 32, (gx0 + 32 * k) % 32
        lo = gp[..., k0 + 2] if -2 <= k0 < ww + 2 else zero
        hi = gp[..., k0 + 3] if -2 <= k0 + 1 < ww + 2 else zero
        out.append(funnel_r(lo, hi, sh))
    return torch.stack(out, -1)


def passes_emulated(s, r):
    """Three launches: m (halo r) to global words, a round (halo 2 r) to a
    second mask, the last round (halo 2 r) to floats."""
    b, h, w = s.shape
    th, tw = PASS(r)
    ww = -(-w // 32)

    def to_global(m, halo, ny, nx):
        """The central words of every block, funnel-shifted from the buffer
        column halo + 32 q, into (b, h, ww)."""
        g = torch.zeros(b, ny * th, nx * tw // 32, dtype=torch.int64)
        bwords = m.shape[-1]
        for q in range(tw // 32):
            c = halo + 32 * q
            k, sh = c // 32, c % 32
            hi = m[..., k + 1] if k + 1 < bwords else torch.zeros_like(m[..., 0])
            word = funnel_r(m[..., k], hi, sh)[..., halo:halo + th]
            g[:, :, q::tw // 32] = word.permute(0, 1, 3, 2).reshape(
                b, ny * th, nx)
        return g[:, :h, :ww]

    def from_global(g, halo, ny, nx, bh, bwp):
        """Each block's buffer words, rows and columns from (tile - halo)."""
        gp = F.pad(g, (0, 0, halo, ny * th + halo - h))
        rows = gp.unfold(1, bh, th)  # (b, ny, ww, bh)
        rows = rows.permute(0, 1, 3, 2)  # (b, ny, bh, ww)
        out = [load_bits(rows, ix * tw - halo, bwp // 32) for ix in range(nx)]
        return torch.stack(out, 2)  # (b, ny, nx, bh, bwp / 32)

    S, ins, (ny, nx, bh, _, bwp) = blocks(s, r, th, tw, r)
    g = to_global(first(S, ins, r), r, ny, nx)
    for last in (False, True):
        S, ins, (ny, nx, bh, _, bwp) = blocks(s, r, th, tw, 2 * r)
        m = from_global(g, 2 * r, ny, nx, bh, bwp) & pack(ins)
        m = one_round(S, ins, m, r)
        if not last:
            g = to_global(m, 2 * r, ny, nx)
    out = torch.where(unpack(m), S, torch.zeros_like(S))
    c = out[..., 2 * r:2 * r + th, 2 * r:2 * r + tw]
    full = c.permute(0, 1, 3, 2, 4).reshape(b, ny * th, nx * tw)
    return full[:, :h, :w]


# --- cases -----------------------------------------------------------------------


def _edge_map():
    """chip_smoke.py's edge case: a plateau of tied scores, a unique peak,
    an all-negative image with a tied plateau; 83 columns."""
    rng = np.random.default_rng(2)
    s = rng.uniform(0, 1, (2, 61, 83)).astype(np.float32)
    s[0, 10:25, 20:50] = 0.75
    s[0, 40, 40] = 1.0
    s[1] = -s[1]
    s[1, 30:, :10] = -0.25
    return s


def _cases():
    rng = np.random.default_rng(0)
    quant = np.round(rng.uniform(0, 1, (1, 150, 200)) * 4) / 4  # many ties
    return {"edge 61x83": _edge_map(),
            "ties 150x200": quant.astype(np.float32),
            "random 70x130": rng.uniform(0, 1, (1, 70, 130)).astype(np.float32),
            "tiny 3x5": rng.standard_normal((1, 3, 5)).astype(np.float32)}


CASES = _cases()


def _same(a, b):
    return a.contiguous().view(torch.int32).equal(b.contiguous().view(torch.int32))


@pytest.mark.parametrize("r", range(9))
def test_both_plans_bitwise_vs_plain(r):
    for name, s in CASES.items():
        x = torch.from_numpy(s)
        want = nms.simple_nms_plain(x, r)
        assert _same(fused_emulated(x, r), want), f"fused {name} r {r}"
        assert _same(passes_emulated(x, r), want), f"passes {name} r {r}"


@pytest.mark.parametrize("r", range(9))
def test_plain_bitwise_vs_pallas_on_the_edge_map(r):
    s = CASES["edge 61x83"]
    want = np.asarray(simple_nms_pallas(jnp.asarray(s), r, tile_rows=64,
                                        interpret=True))
    got = nms.simple_nms_plain(torch.from_numpy(s), r).numpy()
    assert got.tobytes() == want.tobytes()


def test_dilation_is_the_window_or():
    """The word-packed dilation against max_pool2d of the 0/1 mask > 0, at
    every radius, on a sparse mask whose width is not a multiple of 32."""
    rng = np.random.default_rng(4)
    m = torch.from_numpy(rng.uniform(0, 1, (3, 40, 96)) < 0.03)
    for r in range(9):
        want = F.max_pool2d(m.float()[:, None], 2 * r + 1, 1, r)[:, 0] > 0
        assert torch.equal(unpack(dilate(pack(m), r)), want)


@pytest.mark.parametrize("r", range(9))
def test_grid_covers_every_output_once(r):
    """Every output pixel (fused) and every mask word (passes) written by
    exactly one block, at the smoke's and the extractors' shapes."""
    for h, w in ((61, 83), (768, 1024), (480, 640), (1, 1), (33, 65)):
        for th, tw in (FUSED(r), PASS(r)):
            counts = np.zeros((h, w), np.int64)
            for by in range(-(-h // th)):
                for bx in range(-(-w // tw)):
                    counts[by * th:by * th + th, bx * tw:bx * tw + tw] += 1
            assert (counts == 1).all()
        assert PASS(r)[1] % 32 == 0  # whole mask words a block


@pytest.mark.parametrize("r", range(9))
def test_buffers_fit_and_keep_the_exact_centre(r):
    """Each plan's buffer holds its halo (r per sliding max or dilation: 5 r
    fused, r then 2 r for the passes), two float buffers and two masks fit
    in an H100 block's shared memory, and a segment's window spans at most
    two mask words."""
    for (th, tw), halo in ((FUSED(r), 5 * r), (PASS(r), r), (PASS(r), 2 * r)):
        bh, bw = th + 2 * halo, tw + 2 * halo
        bww = -(-bw // 32)
        sp = 32 * bww + 1
        assert sp % 2 == 1  # odd: the row pass's 8 rows x 4 segments on 32 banks
        assert 2 * bh * sp * 4 + 2 * bh * bww * 4 <= 232448
        assert SEG + 2 * r <= 32
        banks = {(ry * sp + SEG * rs) % 32 for ry in range(8) for rs in range(4)}
        assert len(banks) == 32


def test_the_kernel_raises_off_the_card():
    with pytest.raises(ValueError, match="CUDA"):
        nms.simple_nms_kernel(torch.zeros(1, 8, 8), 4)


def test_the_committed_plan_is_the_passes():
    """nms.cu builds the passes; the fused plan is the study's variant."""
    assert "constexpr bool kFusedPlan = false;" in SRC
