"""What the bf16 kernels on wgmma (csrc/attn_wgmma.cuh, csrc/gemm_wgmma.cuh)
depend on in Python, on the CPU: the walk's grid and key split at the
query rows and key tile its shape entry reports (128 and 64 for the bf16
walk, 64 and 64 or 32 for the fp32 one), the tile product's bf16 tiles
(``block_tc.TILES_BF16``) under ``bf16_plan``, and the check that refuses an
input TMA cannot read (``flash.check_tma``).
"""

import pytest
import torch

from lightglue_tpu_torch.ops import block_tc, flash

SHAPES = [flash.WalkShape(64, 1, 132, 128), flash.WalkShape(64, 2, 132, 64),
          flash.WalkShape(32, 2, 132, 64)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"q{s.query_rows}k"
                         f"{s.key_tile}")
@pytest.mark.parametrize("nq,nk", [(1, 1), (5, 1), (127, 63), (128, 64),
                                   (129, 65), (1000, 333), (4096, 4096)])
def test_walk_grid_and_splits_cover_every_query_and_key_once(shape, nq, nk):
    """walk_grid's blocks hold every query row once, and each split count
    that split_plan may pick takes every key once, in whole key tiles."""
    blocks, tiles = flash.walk_grid(3, nq, nk, shape)
    assert blocks % 3 == 0
    per = blocks // 3
    assert (per - 1) * shape.query_rows < nq <= per * shape.query_rows
    assert (tiles - 1) * shape.key_tile < nk <= tiles * shape.key_tile
    for s in range(1, min(flash.MAX_SPLITS, tiles) + 1):
        seen = torch.zeros(nk, dtype=torch.int32)
        for lo, hi in flash.split_ranges(nk, s, shape.key_tile):
            assert lo % shape.key_tile == 0 and lo < hi
            seen[lo:hi] += 1
        assert bool((seen == 1).all())
    (s,) = flash.split_plan(((blocks, tiles),), shape.sms, shape.per_sm)
    assert 1 <= s <= min(flash.MAX_SPLITS, tiles)


@pytest.mark.parametrize("b,h,n", [(1, 4, 1024), (1, 2, 1024), (4, 4, 1024),
                                   (16, 4, 1024), (4, 4, 4096)])
def test_split_plan_fills_the_card_with_128_query_rows(b, h, n):
    """At 128 query rows a block and one block an SM (the bf16 walk), a
    launch whose query tiles leave SMs idle splits its keys as far as one
    round of blocks allows (one more split would need a second round, or
    the splits run out); a grid that fills the card does not split."""
    shape = SHAPES[0]
    blocks, tiles = flash.walk_grid(b * h, n, n, shape)
    (s,) = flash.split_plan(((blocks, tiles),), shape.sms, shape.per_sm)
    if blocks >= shape.sms:
        assert s == 1
    else:
        assert blocks * s <= shape.sms
        assert (blocks * (s + 1) > shape.sms
                or s == min(flash.MAX_SPLITS, tiles))


def _count(rows, cols, tile):
    return -(-rows // tile[0]) * (cols // tile[1])


LAUNCHES = sorted(block_tc.ORDERS_BF16)


@pytest.mark.parametrize("rows,cols", [(1024, 768), (1024, 256),
                                       (1024, 512), (16384, 768),
                                       (16384, 256), (28672, 512),
                                       (4000, 768), (77, 256)])
def test_bf16_tile_plan_covers_every_output_once(rows, cols):
    """For every launch, the bf16 tile product's persistent grid of
    ``grid`` blocks walks cdiv(rows, BM) x cols / BN tiles, block i taking
    tiles i, i + grid, ...: every output in exactly one tile, no block
    without a tile, at most BLOCKS_BF16 blocks an SM, and the tile one of
    the launch's."""
    for launch in LAUNCHES:
        tile, grid = block_tc.bf16_plan(rows, cols, 132, launch)
        assert tile in block_tc.ORDERS_BF16[launch]
        bm, bn = block_tc.TILES_BF16[tile]
        assert cols % bn == 0
        tiles = _count(rows, cols, (bm, bn))
        assert 1 <= grid <= min(tiles, block_tc.BLOCKS_BF16[tile] * 132)
        seen = torch.zeros(rows, cols, dtype=torch.int32)
        for blk in range(grid):
            for t in range(blk, tiles, grid):  # column tiles adjacent
                m0, n0 = (t // (cols // bn)) * bm, (t % (cols // bn)) * bn
                seen[m0:m0 + bm, n0:n0 + bn] += 1
        assert bool((seen == 1).all())


@pytest.mark.parametrize("cols", [256, 512, 768])
def test_bf16_tile_plan_fills_the_card_or_takes_the_most_tiles(cols):
    """For every launch the plan takes the first tile of its order whose
    tiles fill BF16_FILL of the blocks 132 SMs hold, else its last tile,
    the one with the most tiles. At B 1 (1024 rows) that is a 64-row tile
    for every launch (more SMs at work than any 128-row tile gives), and
    lin2 splits the k-steps of a tile between two consumers; at B 16
    (16384 rows) the projection and lin2 take a 128-row tile."""
    tiles = block_tc.TILES_BF16
    for launch, order in block_tc.ORDERS_BF16.items():
        fits = [i for i in order if cols % tiles[i][1] == 0]
        for rows in (1024, 4096, 16384):
            tile, _ = block_tc.bf16_plan(rows, cols, 132, launch)
            full = [_count(rows, cols, tiles[i]) >= block_tc.BF16_FILL
                    * block_tc.BLOCKS_BF16[i] * 132 for i in fits]
            assert tile == (fits[full.index(True)] if any(full)
                            else fits[-1])
            assert _count(rows, cols, tiles[fits[-1]]) == max(
                _count(rows, cols, tiles[i]) for i in fits)
        small, _ = block_tc.bf16_plan(1024, cols, 132, launch)
        assert tiles[small][0] == 64
        assert _count(1024, cols, tiles[small]) >= max(
            _count(1024, cols, t) for t in tiles if t[0] == 128)
        if launch == "lin2":
            assert block_tc.SPLIT_BF16[small] == 2
        if launch in ("project", "lin2"):
            big, _ = block_tc.bf16_plan(16384, cols, 132, launch)
            assert tiles[big][0] == 128
    # the fp32 plan keeps its own tiles
    assert block_tc.TILES[block_tc.tile_plan(16384, cols, 132)] in \
        block_tc.TILES


@pytest.mark.parametrize("cols", [128, 256, 384])
def test_bf16_tile_plan_passes_over_tiles_wider_than_d128(cols):
    """At D 128 (the aliked preset) the projection has 384 channels and
    out_proj 128: the 256-wide tile is passed over, never raised on."""
    for launch in LAUNCHES:
        for rows in (1024, 16384):
            tile, _ = block_tc.bf16_plan(rows, cols, 132, launch)
            assert cols % block_tc.TILES_BF16[tile][1] == 0
        with pytest.raises(ValueError):
            block_tc.bf16_plan(1024, 96, 132, launch)


def test_check_tma_takes_aligned_bf16_rows():
    buf = torch.zeros(4096, dtype=torch.bfloat16)
    flash.check_tma("t", buf[:2048].view(2, 16, 64))
    flash.check_tma("t", buf[8:8 + 2048].view(2, 8, 128))  # 16 bytes in


@pytest.mark.parametrize("case", ["odd_address", "narrow_rows", "fp32",
                                  "strided"])
def test_check_tma_refuses_what_tma_cannot_read(case):
    """An address or a row that is no multiple of 16 bytes, another type,
    or a view with gaps: each raises before a launch."""
    buf = torch.zeros(4096, dtype=torch.bfloat16)
    t = {"odd_address": buf[1:1 + 2048].view(2, 16, 64),
         "narrow_rows": buf[:2044].view(2, 146, 7),
         "fp32": torch.zeros(2, 16, 64),
         "strided": buf[:4096].view(64, 64)[:, :32]}[case]
    with pytest.raises(ValueError):
        flash.check_tma("t", t)
