"""B11's and B12's bf16 forms on Hopper (csrc/score_wgmma.cuh) on the CPU,
at small sizes, on seeded numpy inputs.

- The kernel's decomposition in plain PyTorch, block by block as
  ops/conv_plan.py cuts a launch (units of 122 output columns x a row
  pair, PER_SM blocks an SM): each s0 row of a segment staged once (128
  pixel slots from x0 - 3: the fp32 s0, or s1 plus the three branches'
  lerps rows first from row-lerped windows and the kernel's column tables,
  rounded, SELU, rounded, 0 outside the image); each conv per k-step in
  the kernel's pairing, two output rows x 4 channels in N: conv 8->4 taps
  (dy, 0) + (dy, 1) and (dy, 2) + a zero partner from s0's 8-channel
  slots, conv 4->4 one k-step an input row from the packed slots (pixel p,
  pixel p + 1) of stage 1; SELU, rounding and the masks into packed stage
  rows; conv 4->1 summed by the CUDA cores from the packed stage-2 rows;
  every output written exactly once. The
  weights are read from ``prepare_bf16``'s blob as the kernel reads it.
  Held against ``score_tail_plain`` / ``score_head_lazy_plain`` at mp and
  against JAX's ``score_head_pallas_cplane`` / ``score_head_pallas_lazy``
  (mp=True, interpret=True; where a branch is one row, the JAX dense path:
  its lazy kernel clamps to a row that does not exist) within
  tests/test_torch_mp_extract.py's bf16 bounds, on sizes ragged against
  the strips, odd heights, and with so few blocks that one walks several
  segments across strips and images.
- The consumer's steps (conv 8->4 of pair J, conv 4->4 of J - 2, conv 4->1
  of J - 3 on the CUDA cores; the study's conv 4->1 on wgmma, of J - 4)
  and the producer's ring: every staged row read from the slot that holds
  it, none overwritten before its last read, every s0 row released once.
- Every descriptor reads inside its staged row, and past the written
  pixels only with zero weights or for pixels no kept output reads; the
  TMA box starts on a 16-byte boundary and covers s0's row; shared memory
  and registers fit PER_SM blocks an H100 SM; the header's constants match
  the Python plan.
- ``prepare_bf16``'s layout, ``prepared``'s cache (one per tree and type)
  and the tensor-map cache kept with it; the study's variants apply to the
  header.
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu.ops.score_head import (score_head_pallas_cplane,
                                          score_head_pallas_lazy)
from lightglue_tpu_torch import _build, nn
from lightglue_tpu_torch.ops import conv_plan, score_head, tma_maps
from lightglue_tpu_torch.scripts import score_wgmma_study

torch.set_num_threads(1)

BF = torch.bfloat16
REL = 2e-2  # tests/test_torch_mp_extract.py's bounds
SCALED = 2.0 ** -6
HEADER = (Path(__file__).resolve().parents[1] / "lightglue_tpu_torch" / "csrc"
          / "score_wgmma.cuh").read_text()
SMEM_SM = 228 * 1024  # shared memory of an H100 SM
SMEM_MAX = 232448  # bytes a block may take


def _const(name):
    return int(re.search(rf"constexpr int [^;]*\b{name} = (\d+)", HEADER).group(1))


STRIP, BOX, RP = _const("STRIP"), _const("BOX"), _const("RP")
S0_PX = STRIP + 6  # s0 pixels of a strip row (x0 - 3 ..)
R0, R1, R2 = _const("R0"), _const("R1"), _const("R2")


PER_SM = _const("PER_SM")


# --- inputs ---------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _params(seed=3):
    """A score-head tail at three times an init-like scale (the tests' and
    the smoke's stand-in for trained weights): (JAX tree HWIO, port tree
    OIHW)."""
    rng = np.random.default_rng(seed)
    tp, jp = {}, {}
    for name, cin, cout in score_head.TAIL:
        w = (3.0 * rng.standard_normal((cout, cin, 3, 3)) / np.sqrt(9 * cin)
             ).astype(np.float32)
        tp[name] = {"w": torch.from_numpy(w)}
        jp[name] = {"w": jnp.asarray(w.transpose(2, 3, 1, 0))}
    return jp, tp


def _parts(seed, b, h, w):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, 8, max(1, h // f), max(1, w // f)))
            .astype(np.float32) for f in (1, 2, 8, 32)]


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
    assert (err <= SCALED * (np.abs(w) + rms)).all(), err.max()


def _r(x):
    return x.to(BF).float()


# --- the blob, as the kernel's descriptors read it ------------------------------


def _blob(sh):
    """prepare_bf16's blob as the products read it: [k-step][n][k 16]."""
    raw = score_head.prepare_bf16(sh).float().reshape(16, 2, 8, 8)
    return raw.permute(0, 2, 1, 3).reshape(16, 8, 16)


# --- the decomposition --------------------------------------------------------


def lerp_of(g, n, nk):
    """score_wgmma.cuh's lerp_of: (i0, i1, weight of i1) in float64."""
    c = 0.0 if n == 1 else float(nk - 1) if g == n - 1 else g * ((nk - 1) / (n - 1))
    i0 = int(np.floor(c))
    return i0, min(i0 + 1, nk - 1), np.float32(c - i0)


def windows_of(parts, x0, w):
    """B11's windows of a strip (score_wgmma.cuh's windows_of): each
    branch's first column xs and its offset in the window buffer."""
    xs, off = [], [0]
    for sk in parts[1:]:
        wk = sk.shape[-1]
        a = lerp_of(min(max(x0 - 3, 0), w - 1), w, wk)[0]
        e = lerp_of(min(max(x0 - 3 + S0_PX - 1, 0), w - 1), w, wk)[1]
        xs.append(a)
        off.append(off[-1] + e - a + 1)
    return xs, off


def s0_row(src, parts, b, r, x0):
    """Staged s0 row r of the strip at x0 (RP slots x 8 channels) as the
    producer writes it: pixel i (x0 - 3 + i, box column i + 1) is round,
    SELU, round of s0 (B11: s1 plus each branch's column lerp of its
    row-lerped window), 0 outside the image and past S0_PX."""
    _, _, h, w = src.shape
    row = torch.zeros(RP, 8)
    if not 0 <= r < h:
        return row
    xs_ = x0 - 3 + torch.arange(S0_PX)
    ok = (xs_ >= 0) & (xs_ < w)
    v = src[b, :, r][:, xs_.clamp(0, w - 1)].T.clone()  # (S0_PX, 8)
    if parts is not None:
        xs, off = windows_of(parts, x0, w)
        cols = off[3]
        win = torch.zeros(cols, 8)
        for k, sk in enumerate(parts[1:]):  # the row lerps of the windows
            hk, wk = sk.shape[-2:]
            i0, i1, wy = lerp_of(r, h, hk)
            c = torch.arange(xs[k], xs[k] + off[k + 1] - off[k])
            a, cc = sk[b, :, i0][:, c].T, sk[b, :, i1][:, c].T
            win[off[k]:off[k + 1]] = a + float(wy) * (cc - a)
        for k, sk in enumerate(parts[1:]):  # the column tables, then the sums
            wk = sk.shape[-1]
            tab = [lerp_of(min(max(int(x), 0), w - 1), w, wk) for x in xs_]
            j0 = torch.tensor([t[0] - xs[k] + off[k] for t in tab])
            j1 = torch.tensor([t[1] - xs[k] + off[k] for t in tab])
            assert 0 <= int(j0.min()) and int(j1.max()) < cols
            wx = torch.tensor([float(t[2]) for t in tab])[:, None]
            a, cc = win[j0], win[j1]
            v = v + (a + wx * (cc - a))
    row[:S0_PX] = torch.where(ok[:, None], _r(nn.selu(_r(v))), torch.zeros(()))
    return row


def _packed(v):
    """A stage row's packed slots from its values (128, 4): slot p holds
    pixels p and p + 1; the slots past them stay 0."""
    row = torch.zeros(RP, 8)
    row[:128, :4] = v
    row[:127, 4:] = v[1:]
    return row


def _stage(blob, rows, first, a_of, x_base, row0, h, w):
    """One stage of a pair: the sum of its k-steps over two 64-pixel
    tiles, (128 pixels, n 8), then SELU, rounding and the masks: the two
    rows' values (2, 128, 4) at x_base + p, rows row0, row0 + 1."""
    acc = torch.zeros(128, 8)
    for p0 in (0, 64):
        for step, a in a_of(rows, p0):
            acc[p0:p0 + 64] += a @ blob[first + step].T
    out = torch.zeros(2, 128, 4)
    x = x_base + torch.arange(128)
    for rr in range(2):
        ok = (0 <= row0 + rr < h) & (x >= 0) & (x < w)
        out[rr] = torch.where(ok[:, None], _r(nn.selu(acc[:, 4 * rr:4 * rr + 4])),
                              torch.zeros(()))
    return out, acc


def _a_s0(rows, p0):
    """conv 8->4's k-steps 2 ri + dp: input row ri from slot p0 + 2 dp, its
    chunk 1 the next slot (LBO 16 bytes)."""
    for ri in range(4):
        for dp in range(2):
            s = p0 + 2 * dp
            assert s + 64 < RP
            yield 2 * ri + dp, torch.cat([rows[ri][s:s + 64], rows[ri][s + 1:s + 65]], 1)


def _a_packed(rows, p0):
    """conv 4->4's and 4->1's k-step ri: input row ri's slots p0 .. and
    p0 + 2 .. (LBO 32 bytes)."""
    for ri in range(4):
        assert p0 + 2 + 64 <= RP
        yield ri, torch.cat([rows[ri][p0:p0 + 64], rows[ri][p0 + 2:p0 + 66]], 1)


def _conv3(blob, rows):
    """conv 4->1 of a pair on the CUDA cores, as the consumer's threads sum
    it: output pixel o (of STRIP) of row rr reads the packed stage-2 rows
    rr + dy, slot o (taps dx 0 and 1) and the first half of slot o + 2 (tap
    2), with the weights w3[dy][dx][ci] of conv 4->1's k-step dy, column 0.
    Returns the (2, STRIP) sums."""
    w3 = torch.stack([torch.stack([blob[12 + dy][0, 8 * (dx // 2) + 4 * (dx % 2):][:4]
                                   for dx in range(3)]) for dy in range(3)])
    sums = torch.zeros(2, STRIP)
    o = torch.arange(STRIP)
    for rr in range(2):
        for dy in range(3):
            slot, far = rows[rr + dy][o], rows[rr + dy][o + 2]
            vals = torch.stack([slot[:, :4], slot[:, 4:], far[:, :4]], 1)  # (o, dx, ci)
            sums[rr] += (vals * w3[dy]).sum((1, 2))
    return sums


def emulate(sh, src, parts=None, sms=132):
    """B11 (parts = [s1, s2, s3, s4], src = s1) or B12 (src = s0) as the
    kernel computes it: the (B, H, W) score map."""
    blob = _blob(sh)
    bsz, _, h, w = src.shape
    plan = conv_plan.plan(bsz, h, w, score_head.PER_SM * sms, score_head.STRIP)
    out = torch.full((bsz, h, w), float("nan"))
    seen = torch.zeros(bsz, h, w, dtype=torch.int64)
    for i in range(plan.grid):
        staged = [s0_row(src, parts, b, r, s * STRIP)
                  for b, s, r in conv_plan.staged_rows(plan, i, halo=3)]
        k = 0
        for b, s, q0, q1 in plan.segments(i):
            x0, n = s * STRIP, q1 - q0
            s0 = staged[k:k + 2 * n + 6]
            k += 2 * n + 6
            st1 = []  # stage 1, rows 2 q0 - 2 + m
            for j in range(n + 2):
                v, _ = _stage(blob, s0[2 * j:2 * j + 4], 0, _a_s0, x0 - 2,
                              2 * q0 - 2 + 2 * j, h, w)
                st1 += [_packed(v[0]), _packed(v[1])]
            st2 = []  # stage 2, rows 2 q0 - 1 + m
            for p in range(n + 1):
                v, _ = _stage(blob, st1[2 * p:2 * p + 4], 8, _a_packed, x0 - 1,
                              2 * q0 - 1 + 2 * p, h, w)
                st2 += [_packed(v[0]), _packed(v[1])]
            for o in range(n):
                sums = _conv3(blob, st2[2 * o:2 * o + 4])
                for rr in range(2):
                    row = 2 * q0 + 2 * o + rr
                    xs = x0 + torch.arange(STRIP)
                    keep = xs < w
                    if row < h:
                        out[b, row, xs[keep]] = torch.sigmoid(sums[rr])[keep]
                        seen[b, row, xs[keep]] += 1
        assert k == len(staged)
    assert torch.equal(seen, torch.ones_like(seen))
    return out


# --- against the plain versions and the Pallas kernels -----------------------------

CPLANE = [(2, 40, 72), (1, 33, 130), (2, 18, 250)]
LAZY = [(2, 64, 96), (1, 32, 130)]  # the second: s4 is one row
SMS = [132, 1]  # a block a unit; three blocks walking several segments


@functools.lru_cache(maxsize=None)
def _jax_cplane(shape):
    jsh, _ = _params()
    s0 = np.random.default_rng(7).standard_normal((shape[0], 8, *shape[1:])
                                                  ).astype(np.float32)
    return s0, np.asarray(_strict(score_head_pallas_cplane, jsh, jnp.asarray(s0),
                                  mp=True, tile_rows=64, interpret=True))


@functools.lru_cache(maxsize=None)
def _jax_lazy(shape):
    jsh, tsh = _params()
    parts = _parts(5, *shape)
    if shape[1] // 32 > 1:
        want = _strict(score_head_pallas_lazy, jsh, *map(jnp.asarray, parts),
                       mp=True, interpret=True)
    else:  # the JAX dense path on the same upsampled sum
        s0 = score_head.upsampled_sum(*map(torch.from_numpy, parts)).numpy()
        want = _strict(score_head_pallas_cplane, jsh, jnp.asarray(s0), mp=True,
                       tile_rows=64, interpret=True)
    return parts, np.asarray(want)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("shape", CPLANE)
def test_cplane_decomposition_vs_plain_and_jax(shape, sms):
    _, tsh = _params()
    s0, want = _jax_cplane(shape)
    got = emulate(tsh, torch.from_numpy(s0), sms=sms)
    _close(got, score_head.score_tail_plain(tsh, torch.from_numpy(s0), mp=True))
    _close(got, want)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("shape", LAZY)
def test_lazy_decomposition_vs_plain_and_jax(shape, sms):
    _, tsh = _params()
    parts, want = _jax_lazy(shape)
    tparts = [torch.from_numpy(p) for p in parts]
    if shape[1] == 32:
        assert tparts[3].shape[2] == 1  # a branch of one row
    got = emulate(tsh, tparts[0], tparts, sms=sms)
    _close(got, score_head.score_head_lazy_plain(tsh, *tparts, mp=True))
    _close(got, want)


def test_stages_are_zero_outside_the_image():
    """Staged s0 rows above and below the image, and pixels left and right
    of it, are 0; so are stage-1 values there, not SELU of a sum (which is
    not 0 for these weights)."""
    _, tsh = _params()
    s0 = torch.randn(1, 8, 6, 20, generator=torch.Generator().manual_seed(0))
    for r in (-3, -1, 6, 8):
        assert torch.equal(s0_row(s0, None, 0, r, 0), torch.zeros(RP, 8))
    row = s0_row(s0, None, 0, 2, 0)  # pixels 0 .. 2 are x < 0; 23 .. x >= 20
    assert torch.equal(row[:3], torch.zeros(3, 8))
    assert torch.equal(row[23:], torch.zeros(RP - 23, 8))
    assert float(row[3:23].abs().sum()) > 0
    # stage 1's pair of rows -1 and 0 (s0 rows -2 .. 1), pixel p at x p - 2
    rows = [s0_row(s0, None, 0, r, 0) for r in (-2, -1, 0, 1)]
    v, acc = _stage(_blob(tsh), rows, 0, _a_s0, -2, -1, 6, 20)
    assert torch.equal(v[0], torch.zeros(128, 4))  # row -1
    assert float(nn.selu(acc[:2, 4:]).abs().sum()) > 0  # x -2, -1: SELU(sum) is not 0
    assert torch.equal(v[1, :2], torch.zeros(2, 4)) and torch.equal(v[1, 22:], torch.zeros(106, 4))
    assert float(v[1, 2:22].abs().sum()) > 0


# --- the plan and the steps ----------------------------------------------------------


@pytest.mark.parametrize("b, h, w, sms", [
    (1, 768, 1024, 132), (2, 768, 1024, 132), (8, 768, 1024, 132),
    (1, 33, 130, 132), (2, 41, 250, 1), (3, 5, 300, 7), (1, 1, 1, 132)])
def test_plan_covers_every_unit_once(b, h, w, sms):
    """Units of 122 columns x a row pair (an odd H's last pair one row),
    PER_SM blocks an SM where there are units enough, each block's run
    within one unit of the others."""
    p = conv_plan.plan(b, h, w, score_head.PER_SM * sms, score_head.STRIP)
    assert p.strips == -(-w // STRIP) and p.pairs == -(-h // 2)
    assert p.grid == min(score_head.PER_SM * sms, p.units)
    seen = np.zeros((b, p.strips, p.pairs), np.int64)
    runs = []
    for i in range(p.grid):
        n = 0
        for bb, s, q0, q1 in p.segments(i):
            seen[bb, s, q0:q1] += 1
            n += q1 - q0
        runs.append(n)
    assert (seen == 1).all() and max(runs) - min(runs) <= 1 and min(runs) >= 1


@pytest.mark.parametrize("tc", [True, False])
@pytest.mark.parametrize("n_pairs", [[1], [3], [1, 2], [5, 1, 4]])
def test_steps_read_the_rows_their_slots_hold(n_pairs, tc):
    """The consumer's steps over segments of these many pairs (conv 4->1
    on the CUDA cores reading the stage-2 ring after the step's barrier,
    or on wgmma: the study's form), against the three rings in the
    kernel's order. Every slot read holds the row wanted, staged by an
    earlier step's epilogue (s0: by the producer, whose writes wait for the
    row R0 back to be released); no epilogue overwrites a row that the
    step's own products or a later read still need; every s0 row is
    released exactly once, after its last read."""
    o2, o3 = 2, 4 if tc else 3
    if tc:
        assert "+constexpr int O2 = 2, O3 = 4;" in (
            score_wgmma_study.PATCHES / "conv3_wgmma.patch").read_text()
    else:
        assert "constexpr int O2 = 2, O3 = 3;" in HEADER
    s0_slot, s1_slot, s2_slot = {}, {}, {}
    released, produced = set(), 0
    kseg = 0
    for seg, n in enumerate(n_pairs):
        steps = n + o3

        def reads(J):  # (ring, slot, row) the products of step J read
            out = []
            if J <= n + 1:
                out += [(s0_slot, (kseg + 2 * J + ri) % R0, kseg + 2 * J + ri) for ri in range(4)]
            if o2 <= J <= n + o2:
                out += [(s1_slot, (2 * (J - o2) + ri) % R1, (seg, 2 * (J - o2) + ri))
                        for ri in range(4)]
            if tc and o3 <= J < n + o3:
                out += [(s2_slot, (2 * (J - o3) + ri) % R2, (seg, 2 * (J - o3) + ri))
                        for ri in range(4)]
            return out

        def issue(J):
            nonlocal produced
            if J <= n + 1:  # the producer stages up to the rows waited for
                while produced < kseg + 2 * J + 4:
                    assert produced < R0 or produced - R0 in released
                    s0_slot[produced % R0] = produced
                    produced += 1
            for ring, slot, want in reads(J):
                assert ring.get(slot) == want

        for J in range(steps):
            issue(J)
            busy = reads(J)
            if J <= n + 1:
                rel = [kseg + 2 * J, kseg + 2 * J + 1]
                if J == n + 1:
                    rel += [kseg + 2 * J + 2, kseg + 2 * J + 3]
                for r in rel:
                    assert r not in released
                    released.add(r)
            written = []
            if J <= n + 1:
                written += [(s1_slot, (2 * J + rr) % R1, (seg, 2 * J + rr)) for rr in range(2)]
            if o2 <= J <= n + o2:
                written += [(s2_slot, (2 * (J - o2) + rr) % R2, (seg, 2 * (J - o2) + rr))
                            for rr in range(2)]
            for ring, slot, row in written:
                assert all(ring is not r or slot != s for r, s, _ in busy)
                ring[slot] = row
            if not tc and o3 <= J < n + o3:
                # after the barrier the CUDA cores read stage 2; the next
                # step's epilogue may write before a slow thread has read
                late = [((2 * (J - o3) + ri) % R2, (seg, 2 * (J - o3) + ri)) for ri in range(4)]
                for slot, want in late:
                    assert s2_slot.get(slot) == want
                if J + 1 < steps and o2 <= J + 1 <= n + o2:
                    for rr in range(2):
                        assert (2 * (J + 1 - o2) + rr) % R2 not in [s for s, _ in late]
        kseg += 2 * n + 6
    assert released == set(range(kseg))


# --- descriptors, the box, resources -------------------------------------------


def test_descriptors_read_inside_the_rows_and_past_them_only_with_zeros():
    """conv 8->4 reads s0 slots up to p0 + 2 + 64 (past the 128 written
    only with zero weights or for stage-1 pixels no kept output reads); the
    packed stages read slots up to p0 + 65, whose pixels past the 128
    written feed only tap 3 (zero weights) or pixels of stage 2 and of the
    output past the kept ones."""
    _, tsh = _params()
    blob = _blob(tsh)
    for step in range(8):  # tap dx 3 (dp 1, chunk 1) has zero weights
        if step % 2:
            assert torch.equal(blob[step][:, 8:], torch.zeros(8, 8))
    for step in range(8, 16):  # chunk 1's second pixel: tap 3
        assert torch.equal(blob[step][:, 12:], torch.zeros(8, 4))
    # conv 8->4: stage-1 pixel p of a tile (0 .. 127) reads s0 slots p ..
    # p + 3, tap 3 with zero weights; s0 written 0 .. S0_PX - 1; the kept
    # stage-1 pixels (stage 2's reads) 0 .. STRIP + 3
    for p in range(128):
        assert p + 3 < RP
        if p < STRIP + 4:
            assert p + 2 < S0_PX
    # the packed stages: pixel p reads slots p and p + 2, pixels p .. p + 3
    # (tap 3 zero); stages written at pixels 0 .. 127. Kept pixels: stage 2
    # 0 .. STRIP + 1 (x0 - 1 .. x0 + STRIP), the output 0 .. STRIP - 1
    for kept in (STRIP + 2, STRIP):
        for p in range(128):
            assert p + 2 < RP
            if p < kept:
                assert p + 2 <= 127
    # the descriptors: a row's from slot 0 (LBO one slot, or two packed),
    # moved to the tile's first pixel (and conv 8->4's second k-step of a
    # row two slots on)
    assert "desc_k(s0r + ((k1 + s / 2) % R0) * kRow, 16) +" in HEADER
    assert "64 * ti + 2 * (s % 2);" in HEADER
    assert "desc_k(s1r + ((2 * (J - O2) + j) % R1) * kRow, 32) + 64 * ti," in HEADER


def test_tma_box_and_header_constants():
    """The box starts at (x0 - 3) & ~3 (16-byte aligned fp32) and covers
    s0's pixels x0 - 3 .. at columns (x0 - 3) & 3 ..; the header's strip
    and blocks an SM are the Python plan's."""
    assert STRIP == score_head.STRIP and PER_SM == score_head.PER_SM
    assert S0_PX == STRIP + 6 == 128 and "constexpr int S0_PX = STRIP + 6;" in HEADER
    assert "const uint32_t box[3] = {BOX, 1, 8};" in HEADER
    assert "(x0 - 3) & ~3," in HEADER and "+ ((x0 - 3) & 3);" in HEADER
    assert BOX * 4 % 16 == 0
    for s in range(64):
        x0 = s * STRIP
        start = (x0 - 3) & ~3
        assert start * 4 % 16 == 0 and start + ((x0 - 3) & 3) == x0 - 3
        assert ((x0 - 3) & 3) + S0_PX <= BOX
    assert _const("kStep") * sum(score_head.K_STEPS) == 2 * score_head.prepare_bf16(
        _params()[1]).numel() == 4096


def _smem(lazy, cols):
    """score_wgmma.cuh's smem_bytes, from its constants."""
    k_img, k_row = 8 * BOX * 4, RP * 16
    o_bar = 4096 + _const("IMG_SLOTS") * k_img + (R0 + R1 + R2) * k_row
    bars = 2 * R0 + _const("IMG_SLOTS") + 1
    o_lazy = o_bar + -(-bars * 8 // 128) * 128
    tables = -(-3 * S0_PX * 8 // 128) * 128
    return 128 + o_lazy + (tables + 2 * cols * 32 if lazy else 0)


def test_shared_memory_and_registers_fit_the_blocks_an_sm():
    """PER_SM blocks (B12's, B11's) fit an SM's shared memory (each with
    the 1 KB the system keeps), B11's with ALIKED's widest windows at 768 x
    1024 (branches at 1/2, 1/8, 1/32); the setmaxnreg split within the
    registers a thread of PER_SM x THREADS launches with."""
    parts = [np.zeros((1, 1, 768 // f, 1024 // f)) for f in (1, 2, 8, 32)]
    cols = max(windows_of(parts, x0, 1024)[1][3] for x0 in range(0, 1024, STRIP))
    assert 80 <= cols <= 100
    threads = _const("THREADS")
    assert threads == 256  # a producer and a consumer warpgroup
    for lazy in (False, True):
        assert PER_SM * (_smem(lazy, cols) + 1024) <= SMEM_SM
        assert _smem(lazy, cols) <= SMEM_MAX
    cap = 65536 // (threads * PER_SM) // 8 * 8
    prod, cons = _const("kRegsP"), _const("kRegsC")
    assert 128 * prod + 128 * cons <= threads * cap
    assert prod % 8 == 0 and cons % 8 == 0  # setmaxnreg's unit
    # the form the decomposition holds: two stages on wgmma, 8 k-steps of
    # conv 8->4 a pair (N filled with both rows), conv 4->1 on the CUDA
    # cores
    assert "float acc[2][TILES][4];" in HEADER
    assert "for (int s = 0; s < 8; ++s)" in HEADER and "w3[ri - r2][dx][ci]" in HEADER


# --- prepared weights -----------------------------------------------------------


def test_prepare_bf16_layout():
    """k-step (ri, dp) of conv 8->4 and ri of conv 4->4 and 4->1: column n
    = 4 rr + co (conv 4->1: n = rr) holds tap (ri - rr, dx) of the rounded
    weights, zero where ri - rr is not a tap or dx is 3."""
    _, tsh = _params()
    blob = _blob(tsh)
    assert score_head.prepare_bf16(tsh).dtype == BF
    w1, w2, w3 = (_r(tsh[name]["w"]) for name in ("2", "4", "6"))
    for ri in range(4):
        for rr in range(2):
            dy = ri - rr
            for dx in range(4):
                dp, chunk, half = dx // 2, dx % 2, dx % 2
                got1 = blob[2 * ri + dp][4 * rr:4 * rr + 4, 8 * chunk:8 * chunk + 8]
                got2 = blob[8 + ri][4 * rr:4 * rr + 4, 8 * (dx // 2) + 4 * half:][:, :4]
                got3 = blob[12 + ri][rr, 8 * (dx // 2) + 4 * half:][:4]
                if 0 <= dy <= 2 and dx < 3:
                    assert torch.equal(got1, w1[:, :, dy, dx])
                    assert torch.equal(got2, w2[:, :, dy, dx])
                    assert torch.equal(got3, w3[0, :, dy, dx])
                else:
                    assert not got1.any() and not got2.any() and not got3.any()
    for step in range(12, 16):  # conv 4->1: columns 2 .. 7 unused
        assert not blob[step][2:].any()


def test_prepared_is_built_once_per_tree_with_its_map_cache(monkeypatch):
    """``prepared(sh, True)`` keeps one Prepared16 a tree (its blob and its
    tensor maps) beside the fp32 form's host array; a new tree builds anew.
    A map is encoded once an (address, shape), at most MAPS kept, the
    oldest dropped first."""
    _, tsh = _params()
    tree = dict(tsh)
    got = score_head.prepared(tree, True)
    assert isinstance(got, tma_maps.Prepared16)
    assert score_head.prepared(tree, True) is got
    assert score_head.prepared(tree) is not got
    assert torch.equal(got.weights, score_head.prepare_bf16(tree))
    other = {**tree, "4": {"w": tree["4"]["w"].clone()}}
    assert score_head.prepared(other, True) is not got
    calls = []

    def encode(entry, device, buf, s, b, h, wp):
        assert entry == "lg_score_head_bf16_map" and buf.numel() == 128
        calls.append((s.data_ptr(), b, h, wp))
        buf.fill_(len(calls))

    monkeypatch.setattr(_build, "launch", encode)
    plane_map = functools.partial(tma_maps.tensor_map, got, "lg_score_head_bf16_map")
    planes = [torch.zeros(1, 8, 4, 8) for _ in range(tma_maps.MAPS + 1)]
    first = plane_map(planes[0])
    assert plane_map(planes[0]) is first and len(calls) == 1
    assert plane_map(planes[0][:, :, :2]) is not first  # another shape
    for x in planes[1:]:
        plane_map(x)
    assert len(got.maps) == tma_maps.MAPS
    n = len(calls)
    plane_map(planes[-1])
    assert len(calls) == n
    plane_map(planes[0])
    assert len(calls) == n + 1


def test_tma_planes_pads_only_what_tma_cannot_read():
    """fp32 planes of a width that is a multiple of 4 on a 16-byte boundary
    go as they lie; another width, or an offset start, through one
    zero-padded copy (``tma_maps.padded``, B10's too: bf16 to a multiple
    of 8)."""
    s = torch.randn(1, 8, 3, 8)
    assert tma_maps.padded(s) is s
    odd = torch.randn(1, 8, 3, 7)
    pad = tma_maps.padded(odd)
    assert pad.shape[-1] == 8 and torch.equal(pad[..., :7], odd) and not pad[..., 7].any()
    buf = torch.randn(1 * 8 * 3 * 8 + 1)
    off = buf[1:].view(1, 8, 3, 8)
    got = tma_maps.padded(off)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, off)
    img = torch.randn(1, 3, 4, 10).to(BF)
    assert tma_maps.padded(img).shape[-1] == 16
    assert tma_maps.padded(img[..., :8].contiguous()).shape[-1] == 8


@pytest.mark.parametrize("name", list(score_wgmma_study.VARIANTS))
def test_study_variants_apply_to_the_header(name):
    """Each variant of scripts/score_wgmma_study.py applies to the header
    as committed: every (old, new) text found, every hunk of a diff found
    once."""
    csrc = Path(score_head.__file__).resolve().parents[1] / "csrc"
    files = {"score_wgmma.cuh": HEADER,
             "score_common.cuh": (csrc / "score_common.cuh").read_text()}
    for patch in score_wgmma_study.VARIANTS[name][0]:
        if isinstance(patch, Path):
            text = score_wgmma_study.apply_diff(files["score_wgmma.cuh"], patch.read_text())
            assert text != files["score_wgmma.cuh"]
            files["score_wgmma.cuh"] = text
            continue
        file, old, new = patch if len(patch) == 3 else ("score_wgmma.cuh", *patch)
        assert old in files[file]
        files[file] = files[file].replace(old, new)
