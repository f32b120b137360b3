"""Residual(PreNorm(LinearAttention)) of the ConditionalUNet: the CUDA kernel
wrappers, their plain PyTorch versions and the autograd Functions over them.

`attn_wrap` is the port of the Pallas TPU kernel `attn_wrap_v5`
(daclip_tpu/ops/linear_attention.py:491), `attn_wrap_bwd` of its VJP
`attn_wrap_v5_bwd_pallas` (:885). On a CUDA tensor each launches its
hand-written kernel (`daclip_torch/csrc/linear_attention.cu`: stats, combine,
apply; `csrc/linear_attention_bwd.cu`: pass 1, mid, pass 2, two weight-grad
launches) or raises; on a CPU tensor each runs its plain version:
`attn_wrap_reference`, the composition the reference computes
(`_attn_wrap_composition_reference`, :1070), and `attn_wrap_bwd_reference`,
the hand-derived VJP `_wrap_v5_bwd_manual` (:616-687). `attn_wrap` is
differentiable on both devices through `_AttnWrapFn`, whose forward on the
card also keeps the combined (ctx, s, m) that the backward kernel needs. The
bf16 kernels run on Hopper's wgmma with their row tiles and weights brought
by TMA (`csrc/linattn_tiles.cuh`); their static schedules are chosen here:
`_rows_per_part` (stats, pass 1, pass 2: one CTA a run of rows of one batch
element), `_tiles_per_cta` (apply: one CTA a run of the B·⌈n/64⌉ tiles) and
`_wgrad_split` (the weight gradients: one f32 partial a run of rows).
They take every C from 1 to 512: a bf16 width that is not a multiple of 8
is laid out at the next one (`_row_width`, `_pad_operands`: x, dO and the
weights with zeros past C, so that every row is a whole number of the 16
bytes TMA steps in), the kernels' LayerNorms told the true width, and the
results cut back to C.

The UNet's other wirings of the same math (`ConditionalUNet(linear_attention=
"v4" | "v3")`) and the attention core have their own entry points, each a
port of one more TPU kernel and each launching the same stats / combine /
apply kernels of `csrc/linear_attention.cu` in another template:
- `linear_attention_fused(xn, …)` ← `linear_attention_fused_v4` (:310): on a
  normalised xn, no prenorm and no residual; plain version
  `fused_composition_reference` (`_fused_composition_reference`, :1032);
- `attn_wrap_fused(x, g_pre, …, prenorm_residual)` ←
  `linear_attention_fused_pallas` (:199), as `attn_wrap_fused` (:1080) calls
  it; with prenorm_residual the function of `attn_wrap`, else that of
  `linear_attention_fused`;
- `linear_attention(qkv)` ← `linear_attention_pallas` (:91): the core alone,
  qkv (B, n, 384) → (B, n, 128), forward only.
The first two are differentiable through `_RecomputeFn`: their backward
recomputes the plain composition from the saved inputs and takes its VJP, as
JAX's `_fused_bwd` (:1060) and `_wrap_bwd` (:1098) do; nothing of the forward
is kept.

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
_TARGET_CTAS = 264  # two CTAs on each of the H100's 132 SMs


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


def fused_composition_reference(xn, w_qkv, w_out, b_out, g_out):
    """ChannelLN(LinearAttention(xn)·w_out + b_out)·g_out on a normalised xn,
    plain PyTorch (`_fused_composition_reference`)."""
    qkv = torch.einsum("bnc,cd->bnd", xn, w_qkv)
    attn = linear_attention_reference(qkv)
    y = torch.einsum("bnh,hc->bnc", attn, w_out) + b_out
    return _channel_ln(y, g_out)


def attn_wrap_reference(x, g_pre, w_qkv, w_out, b_out, g_out):
    """x + ChannelLN(LinearAttention(ChannelLN(x)·g_pre))·g_out, plain PyTorch."""
    return x + fused_composition_reference(_channel_ln(x, g_pre), w_qkv, w_out, b_out, g_out)


def _ln_parts(t):
    """(normalised rows, 1/std) of t over its last axis, in f32."""
    tf = t.float()
    tc = tf - tf.mean(-1, keepdim=True)
    r = torch.rsqrt(tc.square().mean(-1, keepdim=True) + 1e-5)
    return tc * r, r


def _ln_bwd(dn, norm, r):
    """VJP of the normalisation given dn = upstream ∘ gain."""
    return r * (dn - dn.mean(-1, keepdim=True) - norm * (dn * norm).mean(-1, keepdim=True))


def _head_mask(device):
    d = torch.arange(HID, device=device) // DIM_HEAD
    return (d[:, None] == d[None, :]).float()


def attn_wrap_bwd_reference(x, g_pre, w_qkv, w_out, b_out, g_out, dout):
    """VJP of `attn_wrap_reference` at dout, plain PyTorch: the hand-derived
    backward `_wrap_v5_bwd_manual`, every product in x's dtype with f32
    statistics, rounded where it rounds. The softmax max-shifts are
    constants (both softmaxes are shift-invariant). Returns (dx, dg_pre,
    dw_qkv, dw_out, db_out, dg_out), each in its input's dtype."""
    dt = x.dtype
    B, n, C = x.shape
    nx, r_x = _ln_parts(x)
    xn = (nx * g_pre.float()).to(dt)
    qkv = torch.einsum("bnc,cd->bnd", xn, w_qkv)
    q, k, v = qkv[..., :HID], qkv[..., HID:2 * HID], qkv[..., 2 * HID:]
    q_soft = torch.softmax(q.reshape(B, n, HEADS, DIM_HEAD).float(), dim=-1)
    q_soft = q_soft.reshape(B, n, HID).to(dt)
    k_max = k.amax(dim=1, keepdim=True).float()
    e = torch.exp(k.float() - k_max).to(dt)
    s = e.sum(dim=1, dtype=torch.float32)
    ctx = torch.einsum("bnx,bny->bxy", e, v).float()
    mask = _head_mask(x.device)
    rowscale = (DIM_HEAD ** -0.5) / (s[..., None] * n)
    w = (ctx * mask * rowscale).to(dt)
    attn = torch.einsum("bnx,bxy->bny", q_soft, w)
    y = (torch.einsum("bnh,hc->bnc", attn, w_out) + b_out).float()
    ny, r_y = _ln_parts(y)

    gf = dout.float()
    dg_out = torch.einsum("bnc,bnc->c", gf, ny)
    dy = _ln_bwd(gf * g_out.float(), ny, r_y)
    db_out = dy.sum(dim=(0, 1))
    dy_b = dy.to(dt)
    dattn = torch.einsum("bnc,hc->bnh", dy_b, w_out)
    dw_out = torch.einsum("bnh,bnc->hc", attn, dy_b)
    dq_soft = torch.einsum("bny,bxy->bnx", dattn, w).float()
    dw = torch.einsum("bnx,bny->bxy", q_soft, dattn).float()
    qs = q_soft.float().reshape(B, n, HEADS, DIM_HEAD)
    dqs = dq_soft.reshape(B, n, HEADS, DIM_HEAD)
    dq = (qs * (dqs - (dqs * qs).sum(-1, keepdim=True))).reshape(B, n, HID)
    dctx = dw * mask * rowscale
    ds = -(dctx * ctx).sum(-1) / s
    dctx_b = dctx.to(dt)
    de = torch.einsum("bny,bxy->bnx", v, dctx_b).float() + ds[:, None, :]
    dk = e.float() * de
    dv = torch.einsum("bnx,bxy->bny", e, dctx_b).float()
    dqkv = torch.cat([dq.to(dt), dk.to(dt), dv.to(dt)], dim=-1)
    dxn = torch.einsum("bnd,cd->bnc", dqkv, w_qkv).float()
    dw_qkv = torch.einsum("bnc,bnd->cd", xn, dqkv)
    dg_pre = torch.einsum("bnc,bnc->c", dxn, nx)
    dx = gf + _ln_bwd(dxn * g_pre.float(), nx, r_x)
    return (dx.to(dt), dg_pre.to(g_pre.dtype), dw_qkv.to(w_qkv.dtype),
            dw_out.to(w_out.dtype), db_out.to(b_out.dtype), dg_out.to(g_out.dtype))


def _rows_per_part(B: int, n: int, ctas: int = _TARGET_CTAS) -> int:
    """Rows each stats, pass 1 and pass 2 CTA walks (grid (⌈n/rows⌉, B)): a
    multiple of the tile, sized so that B·parts is about `ctas`."""
    parts = max(1, ctas // B)
    return _TILE * max(1, math.ceil(math.ceil(n / parts) / _TILE))


def _forward_ctas(C: int) -> int:
    """CTAs of a bf16 stats or apply launch: three an SM where both kernels
    fit three (C ≤ 64, or qkv in: C = 384), else two."""
    return _TARGET_CTAS * 3 // 2 if C <= 64 or C == 3 * HID else _TARGET_CTAS


def _tiles_per_cta(B: int, n: int, C: int) -> int:
    """Consecutive tiles of the B·⌈n/64⌉ (batch element, tile) pairs each
    bf16 apply CTA walks, so that about `_forward_ctas(C)` CTAs cover them."""
    return max(1, math.ceil(B * math.ceil(n / _TILE) / _forward_ctas(C)))


def _wgrad_split(R: int, K1: int, K2: int):
    """(rows per split, splits) of a weight-gradient launch over R rows: a
    multiple of the tile, so that splits × its output tiles is about one CTA
    an SM for its 64 × 384 tiles (dW_qkv at C ≤ 64: one CTA fills an SM's
    shared memory), else two for its 64 × 128 ones."""
    wide = K1 <= 64 and K2 > 128
    tiles = math.ceil(K1 / 64) * math.ceil(K2 / (384 if wide else 128))
    ctas = _TARGET_CTAS // 2 if wide else _TARGET_CTAS
    splits = max(1, min(math.ceil(R / 256), max(1, ctas // tiles)))
    per = _TILE * math.ceil(math.ceil(R / splits) / _TILE)
    return per, math.ceil(R / per)


def _check(x, g_pre, w_qkv, w_out, b_out, g_out, name="attn_wrap"):
    """Raise on what the kernels do not take; g_pre None where it is unread."""
    if x.dim() != 3:
        raise ValueError(f"{name} takes x as (B, n, C), got {tuple(x.shape)}")
    B, n, C = x.shape
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name} takes bfloat16 or float32, got {x.dtype}")
    if not 1 <= C <= 512 or n < 1 or not 1 <= B <= 65535:
        raise ValueError(f"{name} kernel takes 1 <= C <= 512, n >= 1, 1 <= B <= 65535; "
                         f"got (B, n, C) = {(B, n, C)}")
    want = {"g_pre": (C,), "w_qkv": (C, 3 * HID), "w_out": (HID, C),
            "b_out": (C,), "g_out": (C,)}
    operands = dict(zip(want, (g_pre, w_qkv, w_out, b_out, g_out)))
    for key, t in operands.items():
        if t is not None and tuple(t.shape) != want[key]:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {want[key]}")
    for t in (x, *operands.values()):
        if t is None:
            continue
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{name}: every operand must share x's device and dtype")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def _row_width(x) -> int:
    """The width of the rows the kernels read: C, or in bf16 the next
    multiple of 8 (a TMA row's bytes are a multiple of 16)."""
    C = x.shape[-1]
    return C if x.dtype != torch.bfloat16 else -(-C // 8) * 8


def _pad_operands(width, x, g_pre, w_qkv, w_out, b_out, g_out, dout=None):
    """The operands laid out at `width` ≥ C channels with zeros past C: x (and
    dout) and the vectors along their last axis, w_qkv's rows, w_out's
    columns; g_pre and dout may be None. The kernels' LayerNorms take the
    true C; every zero they read past it adds nothing to a product."""
    extra = width - x.shape[-1]
    pad = (lambda t, *lead: None if t is None else
           torch.nn.functional.pad(t, (*lead, 0, extra)))
    return (pad(x), pad(g_pre), pad(w_qkv, 0, 0), pad(w_out), pad(b_out), pad(g_out),
            pad(dout))


def _scratch(x, B, n):
    """(rows per stats CTA, [part_m, part_s, part_ctx, w_attn]): the forward
    kernel's f32 scratch for B batch elements of n rows on x's device."""
    rows = _rows_per_part(B, n, _forward_ctas(x.shape[-1]))
    parts = math.ceil(n / rows)
    f32 = dict(dtype=torch.float32, device=x.device)
    return rows, [torch.empty((B, parts, HID), **f32), torch.empty((B, parts, HID), **f32),
                  torch.empty((B, parts, HEADS, DIM_HEAD, DIM_HEAD), **f32),
                  torch.empty((B, HEADS, DIM_HEAD, DIM_HEAD), **f32)]


def _ptrs(*tensors):
    return [None if t is None else t.data_ptr() for t in tensors]


def _forward_kernel(x, g_pre, w_qkv, w_out, b_out, g_out, keep_stats: bool, wrapper=None):
    """The forward kernel's three launches, counted on `wrapper` (default
    `attn_wrap`). With keep_stats also the combined statistics the backward
    needs: (w_attn, ctx, s, m), each f32."""
    wrapper = wrapper or attn_wrap
    _check(x, g_pre, w_qkv, w_out, b_out, g_out, name=wrapper.__name__)
    lib = _build.library()
    B, n, cn = x.shape
    C = _row_width(x)
    if C != cn:
        x, g_pre, w_qkv, w_out, b_out, g_out, _ = _pad_operands(C, x, g_pre, w_qkv, w_out,
                                                                b_out, g_out)
    rows, (part_m, part_s, part_ctx, w_attn) = _scratch(x, B, n)
    parts = part_m.shape[1]
    f32 = dict(dtype=torch.float32, device=x.device)
    stats = None
    if keep_stats:
        stats = (w_attn, torch.empty((B, HEADS, DIM_HEAD, DIM_HEAD), **f32),
                 torch.empty((B, HID), **f32), torch.empty((B, HID), **f32))
    ctx_p, s_p, m_p = (None, None, None) if stats is None else (
        stats[1].data_ptr(), stats[2].data_ptr(), stats[3].data_ptr())
    out = torch.empty_like(x)
    bf16 = int(x.dtype == torch.bfloat16)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.daclip_wrap_stats(
            x.data_ptr(), g_pre.data_ptr(), w_qkv.data_ptr(), part_m.data_ptr(),
            part_s.data_ptr(), part_ctx.data_ptr(), B, n, C, cn, rows, bf16, stream),
            "daclip_wrap_stats")
        _build.check(lib.daclip_wrap_combine(
            part_m.data_ptr(), part_s.data_ptr(), part_ctx.data_ptr(),
            w_attn.data_ptr(), ctx_p, s_p, m_p, B, parts, n, bf16, stream),
            "daclip_wrap_combine")
        _build.check(lib.daclip_wrap_apply(
            x.data_ptr(), g_pre.data_ptr(), w_qkv.data_ptr(), w_attn.data_ptr(),
            w_out.data_ptr(), b_out.data_ptr(), g_out.data_ptr(), out.data_ptr(),
            B, n, C, cn, _tiles_per_cta(B, n, C), bf16, stream), "daclip_wrap_apply")
    wrapper.launches += 1
    return (out if C == cn else out[..., :cn].contiguous()), stats


def _wgrad(lib, a, b, stream):
    """Σ over all rows of aᵀ·b for (B, n, K1) and (B, n, K2) spills, in f32:
    one partial per split of the rows, summed here."""
    K1, K2 = a.shape[-1], b.shape[-1]
    R = a.numel() // K1
    per, splits = _wgrad_split(R, K1, K2)
    part = torch.empty((splits, K1, K2), dtype=torch.float32, device=a.device)
    _build.check(lib.daclip_wrap_wgrad(
        a.data_ptr(), b.data_ptr(), part.data_ptr(), R, K1, K2, per, splits,
        int(a.dtype == torch.bfloat16), stream), "daclip_wrap_wgrad")
    return part.sum(0)


def attn_wrap_bwd(x, g_pre, w_qkv, w_out, b_out, g_out, dout, stats=None):
    """VJP of `attn_wrap` at dout: (dx, dg_pre, dw_qkv, dw_out, db_out,
    dg_out), each in its input's dtype. A CPU tensor takes the plain version;
    a CUDA tensor launches the backward kernel or raises, and needs the
    forward's `stats` (w_attn, ctx, s, m) from `_forward_kernel`."""
    if x.device.type == "cpu":
        return attn_wrap_bwd_reference(x, g_pre, w_qkv, w_out, b_out, g_out, dout)
    if x.device.type != "cuda":
        raise ValueError(f"attn_wrap_bwd runs on cuda or cpu, got {x.device}")
    _check(x, g_pre, w_qkv, w_out, b_out, g_out)
    if dout.shape != x.shape or dout.dtype != x.dtype or dout.device != x.device:
        raise ValueError("attn_wrap_bwd: dout must match x in shape, dtype and device")
    if stats is None:
        raise ValueError("attn_wrap_bwd on the card needs the forward's statistics")
    dout = dout.contiguous()
    w_attn, ctx, s, m = stats
    lib = _build.library()
    B, n, cn = x.shape
    C = _row_width(x)
    if C != cn:
        x, g_pre, w_qkv, w_out, b_out, g_out, dout = _pad_operands(C, x, g_pre, w_qkv, w_out,
                                                                   b_out, g_out, dout)
    rows = _rows_per_part(B, n)
    parts = math.ceil(n / rows)
    f32 = dict(dtype=torch.float32, device=x.device)
    dy = torch.empty_like(x)
    attn = torch.empty((B, n, HID), dtype=x.dtype, device=x.device)
    part_dw = torch.empty((B, parts, HEADS, DIM_HEAD, DIM_HEAD), **f32)
    part_dgout = torch.empty((B, parts, C), **f32)
    part_dbout = torch.empty((B, parts, C), **f32)
    dctx = torch.empty((B, HEADS, DIM_HEAD, DIM_HEAD), **f32)
    ds = torch.empty((B, HID), **f32)
    dx = torch.empty_like(x)
    xn = torch.empty_like(x)
    dqkv = torch.empty((B, n, 3 * HID), dtype=x.dtype, device=x.device)
    part_dgpre = torch.empty((B, parts, C), **f32)
    bf16 = int(x.dtype == torch.bfloat16)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.daclip_wrap_bwd1(
            x.data_ptr(), dout.data_ptr(), g_pre.data_ptr(), w_qkv.data_ptr(),
            w_attn.data_ptr(), w_out.data_ptr(), b_out.data_ptr(), g_out.data_ptr(),
            dy.data_ptr(), attn.data_ptr(), part_dw.data_ptr(), part_dgout.data_ptr(),
            part_dbout.data_ptr(), B, n, C, cn, rows, bf16, stream), "daclip_wrap_bwd1")
        _build.check(lib.daclip_wrap_bwd_mid(
            part_dw.data_ptr(), ctx.data_ptr(), s.data_ptr(), dctx.data_ptr(),
            ds.data_ptr(), B, parts, n, bf16, stream), "daclip_wrap_bwd_mid")
        _build.check(lib.daclip_wrap_bwd2(
            x.data_ptr(), dout.data_ptr(), g_pre.data_ptr(), w_qkv.data_ptr(),
            w_attn.data_ptr(), w_out.data_ptr(), dctx.data_ptr(), ds.data_ptr(),
            m.data_ptr(), dy.data_ptr(), dx.data_ptr(), xn.data_ptr(), dqkv.data_ptr(),
            part_dgpre.data_ptr(), B, n, C, cn, rows, bf16, stream), "daclip_wrap_bwd2")
        dw_qkv = _wgrad(lib, xn, dqkv, stream)
        dw_out = _wgrad(lib, attn, dy, stream)
    attn_wrap_bwd.launches += 1
    dt = x.dtype
    if C != cn:  # the gradients of the true width
        dx = dx[..., :cn].contiguous()
        dw_qkv, dw_out = dw_qkv[:cn], dw_out[:, :cn]
        part_dgpre, part_dbout, part_dgout = (p[..., :cn] for p in
                                              (part_dgpre, part_dbout, part_dgout))
    return (dx, part_dgpre.sum((0, 1)).to(dt), dw_qkv.to(dt), dw_out.to(dt),
            part_dbout.sum((0, 1)).to(dt), part_dgout.sum((0, 1)).to(dt))


class _AttnWrapFn(torch.autograd.Function):
    """attn_wrap with its VJP: kernels on the card, plain versions on the CPU."""

    @staticmethod
    def forward(ctx, x, g_pre, w_qkv, w_out, b_out, g_out):
        if x.device.type == "cpu":
            out, stats = attn_wrap_reference(x, g_pre, w_qkv, w_out, b_out, g_out), ()
        else:
            out, stats = _forward_kernel(x, g_pre, w_qkv, w_out, b_out, g_out, True)
        ctx.save_for_backward(x, g_pre, w_qkv, w_out, b_out, g_out, *stats)
        return out

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors
        return attn_wrap_bwd(*saved[:6], dout, stats=saved[6:] or None)


def attn_wrap(x, g_pre, w_qkv, w_out, b_out, g_out):
    """Residual(PreNorm(LinearAttention)) on raw x (B, n, C).

    g_pre/g_out/b_out are (C,), w_qkv (C, 384) with columns [q | k | v],
    w_out (128, C), all in x's dtype. A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel or raises. Differentiable: when grad is
    on and an operand requires it, the call goes through `_AttnWrapFn`."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attn_wrap runs on cuda or cpu, got {x.device}")
    args = (x, g_pre, w_qkv, w_out, b_out, g_out)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _AttnWrapFn.apply(*args)
    if x.device.type == "cpu":
        return attn_wrap_reference(*args)
    return _forward_kernel(*args, keep_stats=False)[0]


def _dispatch(name, kernel, plain, args):
    """The plain version on a CPU tensor, the kernel on a CUDA tensor; through
    `_RecomputeFn` when grad is on and an operand requires it."""
    if args[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, got {args[0].device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _RecomputeFn.apply(kernel, plain, *args)
    return plain(*args) if args[0].device.type == "cpu" else kernel(*args)


class _RecomputeFn(torch.autograd.Function):
    """A forward kernel (its plain version on the CPU) whose backward
    recomputes the plain composition from the saved inputs and takes its
    VJP: nothing of the forward is kept."""

    @staticmethod
    def forward(ctx, kernel, plain, *args):
        ctx.plain = plain
        ctx.save_for_backward(*args)
        return plain(*args) if args[0].device.type == "cpu" else kernel(*args)

    @staticmethod
    def backward(ctx, dout):
        args = [a.detach().requires_grad_(need)
                for a, need in zip(ctx.saved_tensors, ctx.needs_input_grad[2:])]
        with torch.enable_grad():
            out = ctx.plain(*args)
        grads = iter(torch.autograd.grad(out, [a for a in args if a.requires_grad], dout))
        return (None, None, *(next(grads) if a.requires_grad else None for a in args))


def _fused_v4_kernel(xn, w_qkv, w_out, b_out, g_out, wrapper=None):
    """The v4 kernel's three launches, counted on `wrapper` (default
    `linear_attention_fused`)."""
    wrapper = wrapper or linear_attention_fused
    _check(xn, None, w_qkv, w_out, b_out, g_out, name=wrapper.__name__)
    B, n, cn = xn.shape
    C = _row_width(xn)
    if C != cn:
        xn, _, w_qkv, w_out, b_out, g_out, _ = _pad_operands(C, xn, None, w_qkv, w_out, b_out,
                                                             g_out)
    rows, scratch = _scratch(xn, B, n)
    out = torch.empty_like(xn)
    lib = _build.library()
    with torch.cuda.device(xn.device):
        _build.check(lib.daclip_linattn_fused_v4(
            *_ptrs(xn, w_qkv, w_out, b_out, g_out, *scratch, out), B, n, C, cn, rows,
            _tiles_per_cta(B, n, C), int(xn.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream),
            "daclip_linattn_fused_v4")
    wrapper.launches += 1
    return out if C == cn else out[..., :cn].contiguous()


def linear_attention_fused(xn, w_qkv, w_out, b_out, g_out):
    """ChannelLN(LinearAttention(xn)·w_out + b_out)·g_out on a pre-normalised
    xn (B, n, C): the UNet's v4 wiring, without prenorm and residual.

    w_qkv (C, 384) with columns [q | k | v], w_out (128, C), b_out and g_out
    (C,), all in xn's dtype. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises. Differentiable through
    `_RecomputeFn`."""
    return _dispatch("linear_attention_fused", _fused_v4_kernel, fused_composition_reference,
                     (xn, w_qkv, w_out, b_out, g_out))


def _wrap_fused_kernel(*args):
    return _forward_kernel(*args, keep_stats=False, wrapper=attn_wrap_fused)[0]


def _fused_no_prenorm_kernel(*args):
    return _fused_v4_kernel(*args, wrapper=attn_wrap_fused)


def attn_wrap_fused(x, g_pre, w_qkv, w_out, b_out, g_out, prenorm_residual=True):
    """The UNet's v3 wiring of LinearAttention, in one entry point.

    With prenorm_residual, x is raw and the result is the whole
    Residual(PreNorm(LinearAttention)), the function of `attn_wrap`; without,
    x is a normalised xn, g_pre is not read and the result is that of
    `linear_attention_fused`. Operands as for `attn_wrap`. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel or raises: the
    launches of `attn_wrap`'s forward or of `linear_attention_fused`, which
    compute the same function, counted here. Differentiable through
    `_RecomputeFn` (the VJP of the plain composition, not the v5 backward
    kernel)."""
    if prenorm_residual:
        return _dispatch("attn_wrap_fused", _wrap_fused_kernel, attn_wrap_reference,
                         (x, g_pre, w_qkv, w_out, b_out, g_out))
    return _dispatch("attn_wrap_fused", _fused_no_prenorm_kernel, fused_composition_reference,
                     (x, w_qkv, w_out, b_out, g_out))


def linear_attention(qkv):
    """The linear-attention core alone: qkv (B, n, 384) with columns
    [q | k | v] → (B, n, 128), before to_out. A CPU tensor takes the plain
    version `linear_attention_reference`; a CUDA tensor launches the kernel or
    raises. Forward only, as the TPU kernel."""
    if qkv.device.type == "cpu":
        return linear_attention_reference(qkv)
    if qkv.device.type != "cuda":
        raise ValueError(f"linear_attention runs on cuda or cpu, got {qkv.device}")
    if qkv.dim() != 3 or qkv.shape[-1] != 3 * HID:
        raise ValueError(f"linear_attention takes qkv as (B, n, {3 * HID}), "
                         f"got {tuple(qkv.shape)}")
    B, n, _ = qkv.shape
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"linear_attention takes bfloat16 or float32, got {qkv.dtype}")
    if n < 1 or not 1 <= B <= 65535 or not qkv.is_contiguous():
        raise ValueError(f"linear_attention kernel takes a contiguous qkv with n >= 1 and "
                         f"1 <= B <= 65535; got {tuple(qkv.shape)}")
    rows, scratch = _scratch(qkv, B, n)
    out = torch.empty((B, n, HID), dtype=qkv.dtype, device=qkv.device)
    lib = _build.library()
    with torch.cuda.device(qkv.device):
        _build.check(lib.daclip_linattn_core(
            *_ptrs(qkv, *scratch, out), B, n, rows, _tiles_per_cta(B, n, 3 * HID),
            int(qkv.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream),
            "daclip_linattn_core")
    linear_attention.launches += 1
    return out


attn_wrap.launches = 0
attn_wrap_bwd.launches = 0
linear_attention_fused.launches = 0
attn_wrap_fused.launches = 0
linear_attention.launches = 0
