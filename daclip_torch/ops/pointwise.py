"""1×1 convolution over a logical concat(x, skip) without the concat: the
ResBlock's `res_conv` on the ConditionalUNet's pointwise wiring.

`dual_conv1x1` is the port of the Pallas TPU kernel of the same name
(daclip_tpu/ops/pointwise.py:121; `_dual_kernel` :37, `_single_kernel` :46):
y = x·w[:Cx] + skip·w[Cx:], or y = x·w without a skip, over the rows of
channels-last activations. On a CUDA tensor it launches the hand-written
kernel of `daclip_torch/csrc/pointwise.cu` (bf16: `wgmma` tensor cores fed by
TMA from a producer warp, on the schedule `_dual_plan` picks; f32: scalar
FMA) or raises; on a CPU tensor it runs the plain version
`dual_conv1x1_reference`. It is differentiable through
`_DualConv1x1Fn`, whose backward is the three matmuls of JAX's `_dc_bwd`
(:132-145), left to `torch.matmul` as JAX leaves them to XLA.

Layout: x (rows, Cx) and skip (rows, Cs) are the free (B·H·W, C) views of
channels_last NCHW activations; w is (Cx + Cs, O), the conv weight
(O, Cx + Cs, 1, 1) transposed, in x's dtype.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from daclip_torch.ops import _build
from daclip_torch.ops._build import SMEM_PER_SM, SMS

_SLICE = 64                # K slice depth, a 128-byte row of bf16
_BLOCK = 64 * _SLICE * 2   # one 64-row × 64-k (or 64-k × 64-output) bf16 box: 8 KB
_BAR_BYTES = 128           # the ring's barriers (at most eight stages)
_RES_SLICES = 16           # the most K slices a CTA of the small tiles holds resident


class _Tiles(NamedTuple):
    """A tile shape of the bf16 kernel (csrc/pointwise.cu `tc::Small`,
    `tc::Large`): rows, panels of 64 outputs, weights resident or streamed,
    and the CTAs an SM its registers allow (its launch bound) with one
    producer warp and with the element path's four (Small)."""
    rows: int
    panels: int
    resident: bool
    per_sm: int
    per_sm_elem: int


DUAL_TILES = (_Tiles(64, 1, True, 4, 2), _Tiles(256, 2, False, 1, 1))


class DualPlan(NamedTuple):
    """The bf16 kernel's schedule: tile shape `cfg` (an index of DUAL_TILES),
    ring depth, CTAs of a cluster that split each tile's K slices (1: none,
    the CTAs persistent), the grid (row tiles walked, column blocks, splits)
    and the dynamic shared memory of a CTA."""
    cfg: int
    stages: int
    splits: int
    grid: tuple
    smem: int


def _dual_smem(cfg: int, stages: int, res_slices: int) -> int:
    """Dynamic shared memory of tile shape cfg: the ring, the resident weights
    and the output tiles TMA stores from (resident shapes), the barriers and
    1 KB to align (csrc/pointwise.cu `Cfg::smem`)."""
    t = DUAL_TILES[cfg]
    stage = t.rows // 64 * _BLOCK + (0 if t.resident else t.panels * _BLOCK)
    res = (res_slices + t.rows // 64) * t.panels * _BLOCK if t.resident else 0
    return stages * stage + res + _BAR_BYTES + 1024


def _min_stages(cfg: int) -> int:
    """The fewest stages of tile shape cfg: two, and enough for a tile's f32
    partial sum over the ring (`Cfg::MIN_STAGES`)."""
    t = DUAL_TILES[cfg]
    stage = t.rows // 64 * _BLOCK + (0 if t.resident else t.panels * _BLOCK)
    return max(2, -(-t.rows * (64 * t.panels + 4) * 4 // stage))


def _ctas_per_sm(cfg: int, smem: int, elem: bool) -> int:
    t = DUAL_TILES[cfg]
    return max(1, min(t.per_sm_elem if elem else t.per_sm, SMEM_PER_SM // (smem + 1024)))


@functools.lru_cache(maxsize=None)
def _dual_plan(R: int, Kx: int, Ks: int, O: int, sms: int = SMS) -> DualPlan:
    """The bf16 kernel's schedule for x (R, Kx), skip (R, Ks) and O outputs on
    `sms` SMs. Tiles: 256 rows × 128 outputs with streamed weights (Large)
    where O ≥ 256 and such tiles give every SM one, or where the K slices
    are too many to keep resident in eight splits; else 64 × 64 with the
    column block's weights resident (Small). Small splits each tile's K
    slices over a cluster of 2, 4 or 8 CTAs where a CTA could not hold them
    all resident; either shape splits further while every split keeps two
    slices or more and the clusters' CTAs stay within one an SM (past that,
    splits ran slower than the chain they cut, on the H100). Without a split
    the CTAs are persistent: one wave walks the row tiles. A ring of four
    stages: at the serving rows three to eight ran within 1.3% of each
    other, at the training rows four beat three by 3-8% (PERF.md)."""
    nx, ns = -(-Kx // _SLICE), -(-Ks // _SLICE)
    total = nx + ns
    elem = Kx % 8 != 0 or Ks % 8 != 0 or O % 8 != 0
    wide = -(-R // 256) * -(-O // 128)
    least = 1  # the fewest splits that keep a CTA's slices resident
    while least < 8 and -(-total // least) > _RES_SLICES:
        least *= 2
    large = (not elem and O >= 256 and wide >= sms) or -(-total // least) > _RES_SLICES
    cfg = 1 if large else 0
    t = DUAL_TILES[cfg]
    row_tiles, cols = -(-R // t.rows), -(-O // (64 * t.panels))
    tiles = row_tiles * cols
    splits = 1 if large else least
    while splits < 8 and total >= 4 * splits and tiles * 2 * splits <= sms:
        splits *= 2
    stages = 4
    smem = _dual_smem(cfg, stages, 0 if large else -(-total // splits))
    per_sm = _ctas_per_sm(cfg, smem, elem)
    grid_x = row_tiles if splits > 1 else min(row_tiles, max(1, per_sm * sms // cols))
    return DualPlan(cfg, stages, splits, (grid_x, cols, splits), smem)


def dual_conv1x1_reference(x, skip, w):
    """x·w[:Cx] (+ skip·w[Cx:]) in f32, rounded once to x's dtype, plain
    PyTorch."""
    cx = x.shape[-1]
    y = x.float() @ w[:cx].float()
    if skip is not None:
        y = y + skip.float() @ w[cx:].float()
    return y.to(x.dtype)


def _check(x, skip, w):
    if x.dim() != 2:
        raise ValueError(f"dual_conv1x1 takes x as (rows, Cx), got {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"dual_conv1x1 takes bfloat16 or float32, got {x.dtype}")
    R, cx = x.shape
    cs = 0 if skip is None else skip.shape[-1]
    if skip is not None and (skip.dim() != 2 or skip.shape[0] != R or cs < 1):
        raise ValueError(f"dual_conv1x1: skip {tuple(skip.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if w.dim() != 2 or w.shape[0] != cx + cs or w.shape[1] < 1:
        raise ValueError(f"dual_conv1x1: w has shape {tuple(w.shape)}, expected "
                         f"({cx + cs}, O)")
    if R < 1 or cx < 1 or R >= 2 ** 31 or w.shape[1] > 64 * 65535:
        raise ValueError(f"dual_conv1x1 kernel takes 1 <= rows < 2^31, Cx >= 1, "
                         f"O <= {64 * 65535}; got x {tuple(x.shape)}, w {tuple(w.shape)}")
    for t in (x, skip, w):
        if t is None:
            continue
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError("dual_conv1x1: every operand must share x's device and dtype")
        if not t.is_contiguous():
            raise ValueError("dual_conv1x1: operands must be contiguous")


def _forward(x, skip, w):
    if x.device.type == "cpu":
        return dual_conv1x1_reference(x, skip, w)
    _check(x, skip, w)
    R, cx = x.shape
    cs = 0 if skip is None else skip.shape[1]
    O = w.shape[1]
    bf16 = x.dtype == torch.bfloat16
    plan = _dual_plan(R, cx, cs, O, _build.sms(x.device)) if bf16 else DualPlan(0, 0, 0, (0,), 0)
    y = torch.empty((R, O), dtype=x.dtype, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        _build.check(lib.daclip_dual_conv1x1(
            x.data_ptr(), None if skip is None else skip.data_ptr(), w.data_ptr(),
            y.data_ptr(), R, cx, cs, O, int(bf16), plan.cfg, plan.stages, plan.splits,
            plan.grid[0], torch.cuda.current_stream().cuda_stream), "daclip_dual_conv1x1")
    dual_conv1x1.launches += 1
    return y


class _DualConv1x1Fn(torch.autograd.Function):
    """dual_conv1x1 with JAX's matmul VJP (`_dc_bwd`): dx = g·w[:Cx]ᵀ,
    dskip = g·w[Cx:]ᵀ, dw = [xᵀ·g; skipᵀ·g], each in its operand's dtype."""

    @staticmethod
    def forward(ctx, x, skip, w):
        ctx.save_for_backward(x, skip, w)
        return _forward(x, skip, w)

    @staticmethod
    def backward(ctx, g):
        x, skip, w = ctx.saved_tensors
        need_x, need_s, need_w = ctx.needs_input_grad
        cx = x.shape[-1]
        dx = torch.matmul(g, w[:cx].t()).to(x.dtype) if need_x else None
        ds = torch.matmul(g, w[cx:].t()).to(skip.dtype) if need_s else None
        dw = None
        if need_w:
            dw = torch.matmul(x.t(), g)
            if skip is not None:
                dw = torch.cat([dw, torch.matmul(skip.t(), g)])
            dw = dw.to(w.dtype)
        return dx, ds, dw


def dual_conv1x1(x, skip, w):
    """y (rows, O) = x·w[:Cx] + skip·w[Cx:]; skip may be None (y = x·w).

    f32 accumulation, one rounding to x's dtype. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises. Differentiable:
    when grad is on and an operand requires it, the call goes through
    `_DualConv1x1Fn`."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dual_conv1x1 runs on cuda or cpu, got {x.device}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, skip, w)):
        return _DualConv1x1Fn.apply(x, skip, w)
    return _forward(x, skip, w)


dual_conv1x1.launches = 0
