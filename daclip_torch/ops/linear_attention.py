"""Residual(PreNorm(LinearAttention)) of the ConditionalUNet: the CUDA kernel
wrapper and its plain PyTorch version.

`attn_wrap` is the port of the Pallas TPU kernel `attn_wrap_v5`
(daclip_tpu/ops/linear_attention.py:491). On a CUDA tensor it launches the
hand-written kernel in `daclip_torch/csrc/linear_attention.cu` (three
launches: stats, combine, apply) or raises; on a CPU tensor it runs
`attn_wrap_reference`, the plain composition the reference computes
(`_attn_wrap_composition_reference`, :1070).

Layout: x is (B, n, C), pixels flattened, channels last — the free view of a
channels_last NCHW activation.
"""
from __future__ import annotations

import math

import torch

from daclip_torch.ops import _build

HEADS = 4
DIM_HEAD = 32
HID = HEADS * DIM_HEAD
_TILE = 64          # rows per tile in the kernel
_TARGET_CTAS = 264  # two waves of stats CTAs on 132 SMs


def _channel_ln(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Bias-free LayerNorm over the last axis, f32 statistics, biased var."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * g.float()).to(x.dtype)


def linear_attention_reference(qkv: torch.Tensor, heads: int = HEADS,
                               dim_head: int = DIM_HEAD) -> torch.Tensor:
    """Channel linear attention core, (B, n, 3·hid) → (B, n, hid):
    softmax(q over each head's channels) · [softmax(k over n)ᵀ·v]·scale/n
    (module_util.py:157-185), rounded where the reference rounds."""
    B, n, _ = qkv.shape
    hid = heads * dim_head
    dtype = qkv.dtype
    q, k, v = qkv[..., :hid], qkv[..., hid:2 * hid], qkv[..., 2 * hid:]
    q_soft = torch.softmax(q.reshape(B, n, heads, dim_head).float(), dim=-1)
    q_soft = q_soft.reshape(B, n, hid).to(dtype)
    k_max = k.amax(dim=1, keepdim=True).float()
    k_exp = torch.exp(k.float() - k_max).to(dtype)
    k_sum = k_exp.sum(dim=1, dtype=torch.float32)
    ctx = torch.einsum("bnx,bny->bxy", k_exp, v).float()
    d_ids = torch.arange(hid, device=qkv.device) // dim_head
    mask = (d_ids[:, None] == d_ids[None, :]).float()
    w = (ctx * mask * ((dim_head ** -0.5) / (k_sum[..., None] * n))).to(dtype)
    return torch.einsum("bnx,bxy->bny", q_soft, w)


def attn_wrap_reference(x, g_pre, w_qkv, w_out, b_out, g_out):
    """x + ChannelLN(LinearAttention(ChannelLN(x)·g_pre))·g_out, plain PyTorch."""
    xn = _channel_ln(x, g_pre)
    qkv = torch.einsum("bnc,cd->bnd", xn, w_qkv)
    attn = linear_attention_reference(qkv)
    y = torch.einsum("bnh,hc->bnc", attn, w_out) + b_out
    return x + _channel_ln(y, g_out)


def _rows_per_part(B: int, n: int) -> int:
    """Rows each stats CTA walks: a multiple of the tile, sized so B·parts
    is about two waves."""
    parts = max(1, _TARGET_CTAS // B)
    return _TILE * max(1, math.ceil(math.ceil(n / parts) / _TILE))


def _check(x, g_pre, w_qkv, w_out, b_out, g_out):
    if x.dim() != 3:
        raise ValueError(f"attn_wrap takes x as (B, n, C), got {tuple(x.shape)}")
    B, n, C = x.shape
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"attn_wrap takes bfloat16 or float32, got {x.dtype}")
    if C % 32 or not 32 <= C <= 512 or n < 1 or not 1 <= B <= 65535:
        raise ValueError(f"attn_wrap kernel takes C a multiple of 32 up to 512, "
                         f"n >= 1, 1 <= B <= 65535; got (B, n, C) = {(B, n, C)}")
    want = {"g_pre": (C,), "w_qkv": (C, 3 * HID), "w_out": (HID, C),
            "b_out": (C,), "g_out": (C,)}
    for name, t in zip(want, (g_pre, w_qkv, w_out, b_out, g_out)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"attn_wrap: {name} has shape {tuple(t.shape)}, "
                             f"expected {want[name]}")
    for t in (x, g_pre, w_qkv, w_out, b_out, g_out):
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError("attn_wrap: every operand must share x's device and dtype")
        if not t.is_contiguous():
            raise ValueError("attn_wrap: operands must be contiguous")


def attn_wrap(x, g_pre, w_qkv, w_out, b_out, g_out):
    """Residual(PreNorm(LinearAttention)) on raw x (B, n, C).

    g_pre/g_out/b_out are (C,), w_qkv (C, 384) with columns [q | k | v],
    w_out (128, C), all in x's dtype. A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel or raises."""
    if x.device.type == "cpu":
        return attn_wrap_reference(x, g_pre, w_qkv, w_out, b_out, g_out)
    if x.device.type != "cuda":
        raise ValueError(f"attn_wrap runs on cuda or cpu, got {x.device}")
    _check(x, g_pre, w_qkv, w_out, b_out, g_out)
    lib = _build.library()
    B, n, C = x.shape
    rows = _rows_per_part(B, n)
    parts = math.ceil(n / rows)
    f32 = dict(dtype=torch.float32, device=x.device)
    part_m = torch.empty((B, parts, HID), **f32)
    part_s = torch.empty((B, parts, HID), **f32)
    part_ctx = torch.empty((B, parts, HEADS, DIM_HEAD, DIM_HEAD), **f32)
    w_attn = torch.empty((B, HEADS, DIM_HEAD, DIM_HEAD), **f32)
    out = torch.empty_like(x)
    bf16 = int(x.dtype == torch.bfloat16)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.daclip_wrap_stats(
            x.data_ptr(), g_pre.data_ptr(), w_qkv.data_ptr(), part_m.data_ptr(),
            part_s.data_ptr(), part_ctx.data_ptr(), B, n, C, rows, bf16, stream),
            "daclip_wrap_stats")
        _build.check(lib.daclip_wrap_combine(
            part_m.data_ptr(), part_s.data_ptr(), part_ctx.data_ptr(),
            w_attn.data_ptr(), B, parts, n, bf16, stream), "daclip_wrap_combine")
        _build.check(lib.daclip_wrap_apply(
            x.data_ptr(), g_pre.data_ptr(), w_qkv.data_ptr(), w_attn.data_ptr(),
            w_out.data_ptr(), b_out.data_ptr(), g_out.data_ptr(), out.data_ptr(),
            B, n, C, bf16, stream), "daclip_wrap_apply")
    attn_wrap.launches += 1
    return out


attn_wrap.launches = 0
