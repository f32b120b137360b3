"""3×3, stride-1, SAME (zero-pad 1) convolution without bias, channels-last.

`conv3x3` is the port of the Pallas TPU kernel `conv3x3_pallas`
(daclip_tpu/ops/conv3x3.py:64, body `_kernel` :43): x (B, H, W, C) NHWC, w
(3, 3, C, O) HWIO rounded to x's dtype, y (B, H, W, O) in x's dtype, the nine
shifted (pixels, C)·(C, O) products summed in f32 and rounded once. On a
CUDA tensor it launches the hand-written implicit-GEMM kernel of
`daclip_torch/csrc/conv3x3.cu` (bf16: wgmma tensor-core products fed by TMA
from a producer warp, on the schedule `_conv_plan` picks; f32: scalar FMA)
or raises; on a CPU tensor it runs the
plain version `conv3x3_reference`. Forward only, as in JAX (no `custom_vjp`
there).

No model wiring calls it, as no JAX path calls its counterpart: the UNet's
convolutions stay `torch.nn.Conv2d`. A `Conv2d` weight (O, C, 3, 3) goes to
the kernel's layout through `conv3x3_weight`.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from daclip_torch.ops import _build
from daclip_torch.ops._build import SMS

# output channels of one CTA tile, bf16 (wgmma) and f32 kernels alike: the grid's
# y extent, at most 65535, is O / TILE_OUT tiles
TILE_OUT = 64
SLICE = 32                     # input channels of a K slice
TILE_COLS = (64, 32, 16)       # the pixel tiles' row lengths the bf16 kernel takes
_STRIP_PIXEL = 2 * SLICE       # bytes of a strip pixel
_WEIGHT_BYTES = 9 * SLICE * TILE_OUT * 2  # a slice's nine weight blocks
_BAR_BYTES = 128


class _Tiles(NamedTuple):
    """A tile shape of the bf16 kernel (csrc/conv3x3.cu `tc::Large`,
    `tc::Small`): pixels a tile and ring stages. Each holds one CTA an SM
    (its shared memory)."""
    pixels: int
    stages: int


CONV_TILES = (_Tiles(256, 3), _Tiles(128, 4))


class ConvPlan(NamedTuple):
    """The bf16 kernel's schedule: tile shape `cfg` (an index of CONV_TILES),
    tile columns (its rows: pixels / columns), ring depth, CTAs of a cluster
    that split each tile's channel slices (1: none, the CTAs persistent), the
    grid (pixel tiles walked, output tiles, splits) and the dynamic shared
    memory of a CTA."""
    cfg: int
    tile_cols: int
    stages: int
    splits: int
    grid: tuple
    smem: int


def _conv_smem(cfg: int, stages: int) -> int:
    """Dynamic shared memory of tile shape cfg (csrc/conv3x3.cu `Cfg::smem`):
    each stage a halo strip as large as the largest of the three tile
    layouts' and the nine weight blocks, the barriers, 1 KB to align."""
    tm = CONV_TILES[cfg].pixels
    strip = max((tm // tc + 2) * (tc + 2) for tc in TILE_COLS) * _STRIP_PIXEL
    stage = -(-strip // 1024) * 1024 + _WEIGHT_BYTES
    return stages * stage + _BAR_BYTES + 1024


def _tile_cols(H: int, W: int, pixels: int) -> int:
    """The row length of a tile of `pixels` that wastes the fewest pixels past
    the image's edges (the longer row on a tie)."""
    def padded(tc):
        tr = pixels // tc
        return -(-W // tc) * tc * (-(-H // tr) * tr)
    return min(TILE_COLS, key=lambda tc: (padded(tc), -tc))


@functools.lru_cache(maxsize=None)
def _conv_plan(B: int, H: int, W: int, C: int, O: int, sms: int = SMS) -> ConvPlan:
    """The bf16 kernel's schedule for x (B, H, W, C) and O outputs on `sms`
    SMs (one CTA an SM). Tiles of 256 or 128 pixels, each in the row length
    that wastes the fewest pixels; each tile's channel slices walked by one
    CTA, or, where the clusters fit one wave, split over a cluster of two
    (two slices or more each: more splits ran slower on the H100). Of
    these, the one of least estimated
    time: the waves of CTAs times the slices a CTA walks, a 256-pixel
    tile's slice costing 1.5× a 128-pixel one's (1.16-1.71× where the
    sweep timed both at one shape; with 1.5 the rule picks the faster of the
    two at every bf16 shape chip_smoke times, PERF.md); on a tie, no
    split, then the larger tiles. Without a split the CTAs are persistent, one wave walking
    the tiles."""
    slices = -(-C // SLICE)
    otiles = -(-O // TILE_OUT)
    options = []
    for cfg, t in enumerate(CONV_TILES):
        tc = _tile_cols(H, W, t.pixels)
        n = B * -(-H // (t.pixels // tc)) * -(-W // tc)
        # a split only where its clusters fit one wave (persistent CTAs
        # overlap a tile's epilogue with the next one's loads; clusters do not)
        for splits in (1, 2) if slices >= 4 and 2 * n * otiles <= sms else (1,):
            waves = -(-n * otiles * splits // sms)
            cost = waves * slices / splits * (3 if t.pixels == 256 else 2)
            options.append((cost, splits, cfg, tc, n))
    _, splits, cfg, tc, n = min(options)
    stages = CONV_TILES[cfg].stages
    grid_x = n if splits > 1 else min(n, max(1, sms // otiles))
    return ConvPlan(cfg, tc, stages, splits, (grid_x, otiles, splits), _conv_smem(cfg, stages))


def conv3x3_reference(x, w):
    """The nine shifted products on a zero-padded x, plain PyTorch: w rounded
    to x's dtype, the sum in f32, one rounding to x's dtype."""
    B, H, W, _ = x.shape
    wf = w.to(x.dtype).float()
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    y = torch.zeros((B, H, W, w.shape[-1]), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            y += xp[:, dy:dy + H, dx:dx + W] @ wf[dy, dx]
    return y.to(x.dtype)


def conv3x3_weight(w_oihw):
    """A `Conv2d` weight (O, C, 3, 3) in the kernel's (3, 3, C, O) layout."""
    return w_oihw.permute(2, 3, 1, 0).contiguous()


def _check(x, w):
    if x.dim() != 4:
        raise ValueError(f"conv3x3 takes x as (B, H, W, C), got {tuple(x.shape)}")
    for name, t in (("x", x), ("w", w)):
        if t.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"conv3x3 takes bfloat16 or float32, got {name} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"conv3x3: {name} must be contiguous")
    B, H, W, C = x.shape
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, C) or w.shape[3] < 1:
        raise ValueError(f"conv3x3: w has shape {tuple(w.shape)}, expected (3, 3, {C}, O)")
    if w.device != x.device:
        raise ValueError(f"conv3x3: w is on {w.device}, x on {x.device}")
    O = w.shape[3]
    if min(B, H, W, C) < 1 or B * H * W >= 2 ** 31 or C >= 2 ** 31 or O > TILE_OUT * 65535:
        raise ValueError(f"conv3x3 kernel takes B, H, W, C >= 1, fewer than 2^31 pixels, "
                         f"C < 2^31 and O <= {TILE_OUT * 65535}; got x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")


def conv3x3(x, w):
    """y (B, H, W, O): the 3×3 SAME convolution of x (B, H, W, C) with w
    (3, 3, C, O), w cast to x's dtype, f32 accumulation, one rounding to x's
    dtype. A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises. Forward only: with grad enabled and an operand that
    requires grad it raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv3x3 runs on cuda or cpu, got {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError("conv3x3 is forward-only: it has no backward (as "
                           "conv3x3_pallas has none); call it under torch.no_grad()")
    _check(x, w)
    if x.device.type == "cpu":
        return conv3x3_reference(x, w)
    w = w.to(x.dtype)
    B, H, W, C = x.shape
    O = w.shape[3]
    bf16 = x.dtype == torch.bfloat16
    plan = (_conv_plan(B, H, W, C, O, _build.sms(x.device)) if bf16
            else ConvPlan(0, 0, 0, 0, (0,), 0))
    y = torch.empty((B, H, W, O), dtype=x.dtype, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        _build.check(lib.daclip_conv3x3(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), B, H, W, C, O, int(bf16), plan.cfg,
            plan.tile_cols, plan.stages, plan.splits, plan.grid[0],
            torch.cuda.current_stream().cuda_stream), "daclip_conv3x3")
    conv3x3.launches += 1
    return y


conv3x3.launches = 0
