"""The static schedules of the bf16 linear-attention kernels, chosen in
Python (daclip_torch/ops/linear_attention.py) as pure functions of the
shapes, at the shapes the port's paths call: serving's six sites, the
training step's (B = 16), shard_tiles' chunk, the Wild-IR sites at B = 1 and
16, and the edges (ragged n with C = 96, C = 512). Each covers every row once,
in 64-row tiles that never straddle a batch element, on about two CTAs a
streaming multiprocessor of the H100 (132 of them)."""
import math

import pytest
import torch

from daclip_torch.ops import linear_attention as la

SERVE = [(1, 65536, 64), (1, 16384, 64), (1, 16384, 128), (1, 4096, 128), (1, 4096, 256)]
SHAPES = sorted(set(
    SERVE + [(16, n, C) for _, n, C in SERVE] + [(4, 147456, 64)]
    + [(B, n, C) for B in (1, 16) for n, C in ((16384, 64), (4096, 64), (4096, 128),
                                                (1024, 128), (1024, 256))]
    + [(2, 3001, 96), (2, 1024, 512)]))
CTAS = 2 * 132


@pytest.mark.parametrize("B, n, C", SHAPES)
def test_rows_per_part_covers_each_batch_element_in_whole_tiles(B, n, C):
    rows = la._rows_per_part(B, n)
    parts = math.ceil(n / rows)
    assert rows % 64 == 0
    # parts × rows covers n, and no part is empty
    assert (parts - 1) * rows < n <= parts * rows
    # the grid (parts, B) is about the target, and never past it by more
    # than a part a batch element
    assert B * parts <= max(CTAS, B) + B
    # the forward's stats grid: three CTAs an SM where its kernels fit three
    # (C ≤ 64, or qkv in), else two; the scratch the wrappers allocate
    # matches it
    for width in (C, 3 * la.HID):
        per_sm = 3 if width <= 64 or width == 3 * la.HID else 2
        fwd_rows = la._rows_per_part(B, n, per_sm * 132)
        assert fwd_rows % 64 == 0
        assert B * math.ceil(n / fwd_rows) <= max(per_sm * 132, B) + B
        assert la._scratch(torch.empty(B, 1, width), B, n)[0] == fwd_rows


@pytest.mark.parametrize("B, n, C", SHAPES + [(B, n, 3 * la.HID) for B, n, _ in SERVE])
def test_apply_tiles_cover_every_tile_once_in_consecutive_runs(B, n, C):
    tiles = la._tiles_per_cta(B, n, C)
    total = B * math.ceil(n / 64)
    grid = math.ceil(total / tiles)
    # three CTAs an SM where the kernel fits three (C ≤ 64, or qkv in), else two
    per_sm = 3 if C <= 64 or C == 3 * la.HID else 2
    assert la._forward_ctas(C) == per_sm * 132
    assert tiles >= 1 and grid <= per_sm * 132
    runs = [range(i * tiles, min(total, (i + 1) * tiles)) for i in range(grid)]
    covered = [f for r in runs for f in r]
    assert covered == list(range(total))  # each (batch element, tile) once, in order
    assert all(len(r) > 0 for r in runs)
    # a run is fewer than two of the fewest a CTA could take
    assert tiles < 2 * max(1, total // (per_sm * 132)) + 1


@pytest.mark.parametrize("B, n, C", SHAPES)
@pytest.mark.parametrize("which", ["dw_qkv", "dw_out"])
def test_wgrad_split_covers_every_row_once(B, n, C, which):
    R = B * n
    K1, K2 = (C, 3 * la.HID) if which == "dw_qkv" else (la.HID, C)
    per, splits = la._wgrad_split(R, K1, K2)
    assert per % 64 == 0  # whole 64-row TMA boxes: no box reads the next split's rows
    assert (splits - 1) * per < R <= splits * per
    # 64 × 384 output tiles at one CTA an SM for dW_qkv at C ≤ 64, else
    # 64 × 128 at two
    wide = K1 <= 64 and K2 > 128
    out_tiles = math.ceil(K1 / 64) * math.ceil(K2 / (384 if wide else 128))
    assert splits * out_tiles <= max(CTAS // 2 if wide else CTAS, out_tiles)
