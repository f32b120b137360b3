"""The static schedules of the bf16 dual 1×1 and 3×3 conv kernels, chosen in
Python (`_dual_plan` in daclip_torch/ops/pointwise.py, `_conv_plan` in
daclip_torch/ops/conv3x3.py) as pure functions of the shapes, at the shapes
the port's paths call: the UNet's res_conv sites at B = 1 and 16 in both
forms, its 3×3 convs at B = 1 and 16, and the kernels' tile edges (chip_smoke
DUAL_SHAPES and CONV_SHAPES). Each CTA's share is enumerated here as the
kernels compute it from blockIdx (csrc/pointwise.cu `dual_tma_kernel`,
csrc/conv3x3.cu `conv_tma_kernel`): every output tile once, every K slice of
it once and in order, clusters of 1, 2, 4 or 8 CTAs with a slice or more
each, and shared memory within the 227 KB a CTA may hold, on the H100's
132 SMs."""
import importlib

import pytest

from daclip_torch.ops import _build
from daclip_torch.ops import pointwise as pw

# the module: `daclip_torch.ops.conv3x3` names the function
cv = importlib.import_module("daclip_torch.ops.conv3x3")

SMS = 132
# (R, Kx, Ks, O): the res_conv sites at 256² and B = 1 (up3, up2, up1, up0 and
# the final block), then the bf16 tile edges
DUAL_SERVE = [(1024, 512, 256, 512), (4096, 256, 128, 256), (16384, 128, 64, 128),
              (65536, 64, 64, 64)]
DUAL_EDGES = [(3001, 96, 40, 72), (1000, 36, 20, 50), (4161, 64, 40, 200),
              (2048, 512, 512, 96), (65, 24, 16, 33), (257, 640, 520, 40),
              (16461, 200, 72, 264), (300, 4100, 4100, 40)]
# the dual form (x, skip), the single form (the concat), and the training
# batch's single form (16× the rows)
DUAL = sorted(set(
    DUAL_SERVE + DUAL_EDGES + [(R, cx + cs, 0, O) for R, cx, cs, O in DUAL_SERVE + DUAL_EDGES]
    + [(16 * R, cx + cs, 0, O) for R, cx, cs, O in DUAL_SERVE]))
# (B, H, W, C, O): the 15 conv shapes of the UNet at 256², three at B = 16,
# the ragged case and the tile edges
CONV = ([(1, s, s, C, O) for s, C, O in [
    (256, 64, 64), (256, 128, 64), (256, 64, 3), (128, 64, 64), (128, 192, 128),
    (128, 128, 128), (128, 256, 128), (64, 128, 128), (64, 384, 256), (64, 256, 256),
    (64, 512, 256), (32, 256, 256), (32, 256, 512), (32, 512, 512), (32, 768, 512)]]
    + [(16, 256, 256, 64, 64), (16, 256, 256, 128, 64), (16, 32, 32, 768, 512),
       (2, 37, 45, 6, 72), (4, 67, 65, 96, 200), (2, 37, 33, 160, 200), (1, 31, 33, 520, 200),
       (2, 9, 65, 40, 72)])


def _split(total, splits, z):
    """The K slices [s0, s1) of split z (the kernels' integer division)."""
    return z * total // splits, (z + 1) * total // splits


def _shares(grid, splits, row_tiles, total):
    """{(tile, column): [slices, in the order the CTAs that take it sum them]}."""
    gx, gy, gz = grid
    got = {}
    for by in range(gy):
        for bz in range(gz):
            for bx in range(gx):
                tiles = [bx] if splits > 1 else range(bx, row_tiles, gx)
                s0, s1 = _split(total, splits, bz) if splits > 1 else (0, total)
                assert s1 > s0, f"CTA ({bx}, {by}, {bz}) has no K slice"
                for t in tiles:
                    got.setdefault((t, by), []).extend(range(s0, s1))
    return got


@pytest.mark.parametrize("R, Kx, Ks, O", DUAL)
def test_dual_plan_covers_every_tile_and_slice_once(R, Kx, Ks, O):
    plan = pw._dual_plan(R, Kx, Ks, O, SMS)
    t = pw.DUAL_TILES[plan.cfg]
    total = -(-Kx // 64) + -(-Ks // 64)
    row_tiles, cols = -(-R // t.rows), -(-O // (64 * t.panels))
    assert plan.splits in (1, 2, 4, 8) and plan.grid[2] == plan.splits
    assert plan.grid[1] == cols <= 65535
    if plan.splits > 1:  # a cluster a tile, every tile in one grid
        assert plan.grid[0] == row_tiles
        assert plan.splits <= total
    else:  # persistent: no more CTAs than the card holds at once
        assert 1 <= plan.grid[0] <= row_tiles
        res = total if t.resident else 0
        per_sm = pw._ctas_per_sm(plan.cfg, pw._dual_smem(plan.cfg, plan.stages, res),
                                 Kx % 8 != 0 or Ks % 8 != 0 or O % 8 != 0)
        assert plan.grid[0] * cols <= max(per_sm * SMS, cols)
    shares = _shares(plan.grid, plan.splits, row_tiles, total)
    assert sorted(shares) == [(r, c) for r in range(row_tiles) for c in range(cols)]
    assert all(s == list(range(total)) for s in shares.values())


@pytest.mark.parametrize("R, Kx, Ks, O", DUAL)
def test_dual_plan_fits_the_ring_and_shared_memory(R, Kx, Ks, O):
    plan = pw._dual_plan(R, Kx, Ks, O, SMS)
    t = pw.DUAL_TILES[plan.cfg]
    total = -(-Kx // 64) + -(-Ks // 64)
    res = -(-total // plan.splits) if t.resident else 0  # the largest split's slices
    assert res <= 16  # the resident weights of a small CTA: K ≤ 1024 a split
    assert pw._min_stages(plan.cfg) <= plan.stages <= 8
    assert plan.smem == pw._dual_smem(plan.cfg, plan.stages, res) <= _build.SMEM_PER_CTA
    # a split's f32 partial tile reuses the ring
    assert t.rows * (64 * t.panels + 4) * 4 <= plan.stages * (
        t.rows // 64 * 8192 + (0 if t.resident else t.panels * 8192))


def test_dual_plan_splits_only_within_one_cta_an_sm():
    # up3 and up2 (128 and 256 tiles) walk their slices unsplit, every ring
    # four stages deep; up0 (1024 tiles) streams persistent CTAs; the wide
    # training rows take the 256 × 128 tiles; 64 deep tiles split in two, the
    # 19 slices of (257, 1160 → 40), past 16 resident, in eight, and the two
    # 256 × 128 tiles of 130 slices (K = 8200) in eight
    up3, up2 = pw._dual_plan(1024, 768, 0, 512, SMS), pw._dual_plan(4096, 384, 0, 256, SMS)
    assert (up3.splits, up3.stages) == (1, 4) and (up2.splits, up2.stages) == (1, 4)
    assert pw._dual_plan(300, 4100, 4100, 40, SMS)[:3] == (1, 4, 8)
    assert pw._dual_plan(65536, 128, 0, 64, SMS).splits == 1
    assert pw._dual_plan(16384, 768, 0, 512, SMS).cfg == 1
    assert pw._dual_plan(2048, 512, 512, 96, SMS).splits == 2
    assert pw._dual_plan(257, 640, 520, 40, SMS).splits == 8
    for R, Kx, Ks, O in DUAL:
        plan = pw._dual_plan(R, Kx, Ks, O, SMS)
        t = pw.DUAL_TILES[plan.cfg]
        total = -(-Kx // 64) + -(-Ks // 64)
        if plan.splits > 1 and -(-total // (plan.splits // 2)) <= 16:  # not for residency
            assert plan.grid[0] * plan.grid[1] * plan.splits <= SMS


@pytest.mark.parametrize("B, H, W, C, O", CONV)
def test_conv_plan_covers_every_tile_and_slice_once(B, H, W, C, O):
    plan = cv._conv_plan(B, H, W, C, O, SMS)
    pixels = cv.CONV_TILES[plan.cfg].pixels
    tc = plan.tile_cols
    assert tc in cv.TILE_COLS and pixels % tc == 0 and tc % 16 == 0  # a warp's run in one row
    tr = pixels // tc
    tiles = B * -(-H // tr) * -(-W // tc)
    slices, otiles = -(-C // 32), -(-O // 64)
    assert plan.splits in (1, 2, 4, 8) and plan.grid[2] == plan.splits
    assert plan.grid[1] == otiles <= 65535
    if plan.splits > 1:
        assert plan.grid[0] == tiles
        assert plan.splits == 2 and tiles * otiles * 2 <= SMS  # a cluster of two, one wave
        assert slices >= 2 * plan.splits  # two slices or more a split
    else:
        assert 1 <= plan.grid[0] <= tiles and plan.grid[0] * otiles <= max(SMS, otiles)
    shares = _shares(plan.grid, plan.splits, tiles, slices)
    assert sorted(shares) == [(i, o) for i in range(tiles) for o in range(otiles)]
    assert all(s == list(range(slices)) for s in shares.values())
    # every pixel of the image is in exactly one tile
    covered = set()
    for i in range(tiles):
        tw, rest = i % -(-W // tc), i // -(-W // tc)
        th, b = rest % -(-H // tr), rest // -(-H // tr)
        for m in range(pixels):
            h, w = th * tr + m // tc, tw * tc + m % tc
            if h < H and w < W:
                assert (b, h, w) not in covered
                covered.add((b, h, w))
    assert len(covered) == B * H * W


@pytest.mark.parametrize("B, H, W, C, O", CONV)
def test_conv_plan_fits_shared_memory_and_its_strip(B, H, W, C, O):
    plan = cv._conv_plan(B, H, W, C, O, SMS)
    pixels = cv.CONV_TILES[plan.cfg].pixels
    tc = plan.tile_cols
    assert 2 <= plan.stages <= 8
    assert plan.smem == cv._conv_smem(plan.cfg, plan.stages) <= _build.SMEM_PER_CTA
    # the halo strip's TMA box: (32 channels, tc + 2, rows + 2, 1), each at most 256
    assert tc + 2 <= 256 and pixels // tc + 2 <= 256
    # the ring's stage holds the strip of any tile layout
    stage = (cv._conv_smem(plan.cfg, plan.stages) - 128 - 1024) // plan.stages
    assert (pixels // tc + 2) * (tc + 2) * 64 <= stage - 9 * 32 * 64 * 2
    # a split's f32 partial tile reuses the ring
    assert pixels * (64 + 4) * 4 <= plan.stages * stage


@pytest.mark.parametrize("B, H, W, C, O", CONV)
def test_conv_tile_columns_waste_the_fewest_pixels(B, H, W, C, O):
    plan = cv._conv_plan(B, H, W, C, O, SMS)
    pixels = cv.CONV_TILES[plan.cfg].pixels

    def padded(tc):
        return -(-W // tc) * tc * (-(-H // (pixels // tc)) * (pixels // tc))
    assert all(padded(plan.tile_cols) <= padded(tc) for tc in cv.TILE_COLS)
    # the UNet's square sites take whole rows of 64, or of 32 at W = 32
    if B == 1 and H == W:
        assert plan.tile_cols == min(W, 64)
