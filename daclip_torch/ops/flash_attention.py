"""Non-causal self-attention of the UNet's SpatialTransformer: the CUDA kernel
wrappers, their plain PyTorch versions and the autograd Function over them.

`flash_self_attention` is the port of the Pallas TPU kernel
`flash_self_attention_pallas` (daclip_tpu/ops/flash_attention.py:68),
`flash_self_attention_bwd` of its backward `flash_self_attention_bwd_pallas`
(:199). On a CUDA tensor each launches its hand-written kernel
(`daclip_torch/csrc/flash_attention.cu`, FlashAttention-2 style;
`csrc/flash_attention_bwd.cu`: dsum, dq, dk/dv, on mma.sync tensor cores in
bf16) or raises; on a CPU tensor
each runs its plain version: `attention_reference`, the composition of
`_reference` (:91-101), and `attention_bwd_reference`, the FA2 backward
arithmetic of `_bwd_kernel` (:104-154). `flash_self_attention` is
differentiable on both devices through `_FlashFn`, which keeps the output
(for dsum = rowsum(dO∘O)) and, on the card, each query's log-sum-exp.

Layout: q, k, v and the output are packed (B, N, heads·dim_head).
"""
from __future__ import annotations

import torch

from daclip_torch.ops import _build


def attention_reference(q, k, v, heads: int, dim_head: int):
    """Per-head softmax(q·kᵀ/√D)·v on the packed layout; k/v may have another
    length than q. Logits and softmax in f32, probabilities cast back."""
    B, N, HD = q.shape
    qh = q.reshape(B, N, heads, dim_head)
    kh = k.reshape(B, -1, heads, dim_head)
    vh = v.reshape(B, -1, heads, dim_head)
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh).float()
    attn = torch.softmax(logits * (dim_head ** -0.5), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", attn.to(q.dtype), vh)
    return out.reshape(B, N, HD)


def attention_bwd_reference(q, k, v, out, dout, heads: int, dim_head: int):
    """(dq, dk, dv) of `attention_reference` at dout, plain PyTorch, with the
    TPU backward's arithmetic: dsum = rowsum(dO∘O) per head, P rebuilt in
    f32, dS = P∘(dO·Vᵀ − dsum)·D^-½ rounded to q's dtype, dQ = dS·K, and in
    f32 dK = dSᵀ·Q, dV = round(P)ᵀ·dO, each cast once."""
    B, N, HD = q.shape
    dt = q.dtype
    scale = dim_head ** -0.5
    qh, kh, vh, oh, gh = (t.reshape(B, -1, heads, dim_head) for t in (q, k, v, out, dout))
    dsum = torch.einsum("bqhd,bqhd->bhq", gh.float(), oh.float())
    logits = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float()) * scale
    prob = torch.softmax(logits, dim=-1)
    dp = torch.einsum("bqhd,bkhd->bhqk", gh.float(), vh.float())
    ds = (prob * (dp - dsum[..., None]) * scale).to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kh.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qh.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", prob.to(dt).float(), gh.float())
    return tuple(t.reshape(B, -1, HD).to(dt) for t in (dq, dk, dv))


def _check(q, k, v, heads, dim_head):
    if q.dim() != 3:
        raise ValueError(f"flash_self_attention takes (B, N, H·D), got {tuple(q.shape)}")
    B, N, HD = q.shape
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_self_attention takes bfloat16 or float32, got {q.dtype}")
    if dim_head not in (32, 64):
        raise ValueError(f"flash_self_attention kernel takes dim_head 32 or 64, "
                         f"got {dim_head}")
    if HD != heads * dim_head or not 1 <= heads <= 65535 or not 1 <= B <= 65535 or N < 1:
        raise ValueError(f"flash_self_attention: shape {tuple(q.shape)} does not "
                         f"match heads={heads}, dim_head={dim_head}")
    for t in (k, v):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError("flash_self_attention: q, k, v must share shape, "
                             "dtype and device")
    for t in (q, k, v):
        if not t.is_contiguous():
            raise ValueError("flash_self_attention: q, k, v must be contiguous")


def _forward_kernel(q, k, v, heads: int, dim_head: int, keep_lse: bool):
    """The forward kernel; with keep_lse also each query's log-sum-exp
    (B, heads, N) f32 for the backward."""
    _check(q, k, v, heads, dim_head)
    lib = _build.library()
    B, N, _ = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((B, heads, N), dtype=torch.float32, device=q.device)
           if keep_lse else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.daclip_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, N, heads, dim_head,
            dim_head ** -0.5, int(q.dtype == torch.bfloat16), stream), "daclip_flash_fwd")
    flash_self_attention.launches += 1
    return out, lse


def flash_self_attention_bwd(q, k, v, out, dout, heads: int, dim_head: int, lse=None):
    """(dq, dk, dv) of `flash_self_attention` at dout, given its output. A CPU
    tensor takes the plain version; a CUDA tensor launches the backward
    kernel or raises, and needs the forward's log-sum-exp `lse`."""
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, out, dout, heads, dim_head)
    if q.device.type != "cuda":
        raise ValueError(f"flash_self_attention_bwd runs on cuda or cpu, got {q.device}")
    _check(q, k, v, heads, dim_head)
    for t in (out, dout):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError("flash_self_attention_bwd: out and dout must match q")
    if lse is None:
        raise ValueError("flash_self_attention_bwd on the card needs the forward's lse")
    out, dout = out.contiguous(), dout.contiguous()
    if q.dtype == torch.bfloat16:  # the tensor-core kernels copy 16-byte chunks
        q, k, v, dout = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v, dout))
    lib = _build.library()
    B, N, _ = q.shape
    dsum = torch.empty((B, heads, N), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.daclip_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, N, heads, dim_head, dim_head ** -0.5, int(q.dtype == torch.bfloat16),
            stream), "daclip_flash_bwd")
    flash_self_attention_bwd.launches += 1
    return dq, dk, dv


class _FlashFn(torch.autograd.Function):
    """flash_self_attention with its VJP: kernels on the card, plain versions
    on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, heads, dim_head):
        if q.device.type == "cpu":
            out, lse = attention_reference(q, k, v, heads, dim_head), None
        else:
            out, lse = _forward_kernel(q, k, v, heads, dim_head, True)
        ctx.heads, ctx.dim_head = heads, dim_head
        ctx.save_for_backward(q, k, v, out, *(() if lse is None else (lse,)))
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, *lse = ctx.saved_tensors
        grads = flash_self_attention_bwd(q, k, v, out, dout, ctx.heads, ctx.dim_head,
                                         lse=lse[0] if lse else None)
        return (*grads, None, None)


def flash_self_attention(q, k, v, heads: int, dim_head: int):
    """Self-attention q/k/v (B, N, heads·dim_head) → (B, N, heads·dim_head).
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises. Differentiable: when grad is on and q, k or v requires it, the
    call goes through `_FlashFn`."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_self_attention runs on cuda or cpu, got {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashFn.apply(q, k, v, heads, dim_head)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, heads, dim_head)
    return _forward_kernel(q, k, v, heads, dim_head, False)[0]


flash_self_attention.launches = 0
flash_self_attention_bwd.launches = 0
