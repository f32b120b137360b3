"""1×1 convolution over a logical concat(x, skip) without the concat: the
ResBlock's `res_conv` on the ConditionalUNet's pointwise wiring.

`dual_conv1x1` is the port of the Pallas TPU kernel of the same name
(daclip_tpu/ops/pointwise.py:121; `_dual_kernel` :37, `_single_kernel` :46):
y = x·w[:Cx] + skip·w[Cx:], or y = x·w without a skip, over the rows of
channels-last activations. On a CUDA tensor it launches the hand-written
kernel of `daclip_torch/csrc/pointwise.cu` or raises; on a CPU tensor it runs
the plain version `dual_conv1x1_reference`. It is differentiable through
`_DualConv1x1Fn`, whose backward is the three matmuls of JAX's `_dc_bwd`
(:132-145), left to `torch.matmul` as JAX leaves them to XLA.

Layout: x (rows, Cx) and skip (rows, Cs) are the free (B·H·W, C) views of
channels_last NCHW activations; w is (Cx + Cs, O), the conv weight
(O, Cx + Cs, 1, 1) transposed, in x's dtype.
"""
from __future__ import annotations

import torch

from daclip_torch.ops import _build


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
    O = w.shape[1]
    y = torch.empty((R, O), dtype=x.dtype, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        _build.check(lib.daclip_dual_conv1x1(
            x.data_ptr(), None if skip is None else skip.data_ptr(), w.data_ptr(),
            y.data_ptr(), R, cx, 0 if skip is None else skip.shape[1], O,
            int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream),
            "daclip_dual_conv1x1")
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
