"""Non-causal self-attention of the UNet's SpatialTransformer: the CUDA kernel
wrapper and its plain PyTorch version.

`flash_self_attention` is the port of the Pallas TPU kernel
`flash_self_attention_pallas` (daclip_tpu/ops/flash_attention.py:68). On a
CUDA tensor it launches the hand-written FlashAttention-2 style kernel in
`daclip_torch/csrc/flash_attention.cu` or raises; on a CPU tensor it runs
`attention_reference`, the plain composition of `_reference` (:91-101).

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


def flash_self_attention(q, k, v, heads: int, dim_head: int):
    """Self-attention q/k/v (B, N, heads·dim_head) → (B, N, heads·dim_head).
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, heads, dim_head)
    if q.device.type != "cuda":
        raise ValueError(f"flash_self_attention runs on cuda or cpu, got {q.device}")
    _check(q, k, v, heads, dim_head)
    lib = _build.library()
    B, N, _ = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.daclip_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, N, heads,
            dim_head, dim_head ** -0.5, int(q.dtype == torch.bfloat16), stream),
            "daclip_flash_fwd")
    flash_self_attention.launches += 1
    return out


flash_self_attention.launches = 0
