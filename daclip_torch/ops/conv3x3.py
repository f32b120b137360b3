"""3×3, stride-1, SAME (zero-pad 1) convolution without bias, channels-last.

`conv3x3` is the port of the Pallas TPU kernel `conv3x3_pallas`
(daclip_tpu/ops/conv3x3.py:64, body `_kernel` :43): x (B, H, W, C) NHWC, w
(3, 3, C, O) HWIO rounded to x's dtype, y (B, H, W, O) in x's dtype, the nine
shifted (pixels, C)·(C, O) products summed in f32 and rounded once. On a
CUDA tensor it launches the hand-written implicit-GEMM kernel of
`daclip_torch/csrc/conv3x3.cu` (bf16: wgmma tensor-core products fed by a
cp.async ring; f32: scalar FMA) or raises; on a CPU tensor it runs the
plain version `conv3x3_reference`. Forward only, as in JAX (no `custom_vjp`
there).

No model wiring calls it, as no JAX path calls its counterpart: the UNet's
convolutions stay `torch.nn.Conv2d`. A `Conv2d` weight (O, C, 3, 3) goes to
the kernel's layout through `conv3x3_weight`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from daclip_torch.ops import _build

# output channels of one CTA tile, bf16 (wgmma) and f32 kernels alike: the grid's
# y extent, at most 65535, is O / TILE_OUT tiles
TILE_OUT = 64


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
    y = torch.empty((B, H, W, O), dtype=x.dtype, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        _build.check(lib.daclip_conv3x3(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), B, H, W, C, O,
            int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream),
            "daclip_conv3x3")
    conv3x3.launches += 1
    return y


conv3x3.launches = 0
