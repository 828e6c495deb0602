"""The work plan of the persistent bf16 kernels that walk strips down an
image (``csrc/conv_wgmma.cuh``: B7's and B8's bf16 forms;
``csrc/aliked_wgmma.cuh``: B10's; ``csrc/score_wgmma.cuh``: B11's and
B12's), as the kernels compute it from the launch's shape and grid.

A launch on B images of H x W is cut into units: (image, strip of 128
output columns (the score head's 122), row pair), in that order; an odd H's
last pair holds one row (the convolutions take H even). Persistent blocks,
one or a few an SM, each walk one contiguous run of units, ``first(i)`` to
``first(i + 1)``: the runs differ by at most one unit. A run is one or more
segments, each a run of row pairs down one strip of one image. A segment of
n pairs stages 2 n + 2 halo input rows (its pairs' rows and ``halo`` rows
above and below: 1 for a 3x3 conv, 3 for the score head's three), so each
input row of a segment is staged once and only the side columns of a strip
repeat in the next one.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Tuple

STRIP = 128  # output columns of a strip: the N of the kernel's products
STAGED = 136  # pixels of a staged row: x0 - 1 .. x0 + 134 (130 are read)
READ = STRIP + 2  # pixels a strip's products read: x0 - 1 .. x0 + 128


class Plan(NamedTuple):
    strips: int
    pairs: int  # row pairs of a strip (H / 2)
    units: int  # images x strips x pairs
    grid: int  # persistent blocks

    def first(self, i: int) -> int:
        """The first unit of block i (``Plan::first`` in the kernel)."""
        return self.units * i // self.grid

    def segments(self, i: int) -> Iterator[Tuple[int, int, int, int]]:
        """Block i's segments: (image, strip, first pair, end pair)."""
        u, end = self.first(i), self.first(i + 1)
        while u < end:
            col, q0 = divmod(u, self.pairs)
            q1 = min(self.pairs, q0 + end - u)
            yield col // self.strips, col % self.strips, q0, q1
            u += q1 - q0


def plan(b: int, h: int, w: int, sms: int, strip: int = STRIP) -> Plan:
    """The plan of a launch on b images of h x w on a card of ``sms`` SMs
    (or block slots: the SMs times the blocks an SM), strips of ``strip``
    columns: one block a slot, or one a unit where there are fewer
    units."""
    strips, pairs = -(-w // strip), -(-h // 2)
    units = b * strips * pairs
    return Plan(strips, pairs, units, max(1, min(sms, units)))


def staged_rows(p: Plan, i: int, halo: int = 1) -> Iterator[Tuple[int, int, int]]:
    """The input rows block i stages, in order: (image, strip, row), rows
    2 q0 - halo .. 2 q1 + halo - 1 of each segment, those outside 0 .. h - 1
    where a segment touches the image's edge (all zeros)."""
    for b, s, q0, q1 in p.segments(i):
        for r in range(2 * q0 - halo, 2 * q1 + halo):
            yield b, s, r


def pair_rows(p: Plan, i: int) -> Iterator[Tuple[int, int, int, int, bool, bool]]:
    """Block i's pairs, in order: (image, strip, pair q, k0, first, last),
    k0 the index in ``staged_rows`` of the first of the pair's four rows
    (2 q - 1 .. 2 q + 2), first / last whether it is its segment's first /
    last pair (it then reads two rows no other pair reads)."""
    u0, end = p.first(i), p.first(i + 1)
    col0 = u0 // p.pairs
    for j in range(end - u0):
        col, q = divmod(u0 + j, p.pairs)
        yield (col // p.strips, col % p.strips, q, 2 * j + 2 * (col - col0),
               q == 0 or j == 0, q == p.pairs - 1 or j == end - u0 - 1)
