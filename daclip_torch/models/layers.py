"""Shared building blocks for the port's models.

Conventions (those of `daclip_tpu/models/layers.py`): parameters live in
float32, activations in the compute dtype of their input (bf16 on the card),
normalisation statistics and attention softmax in float32. Parameter names
are the reference's, so its state dicts load strictly.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Linear):
    """nn.Linear computing in the input's dtype with f32 master weights."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in the input's dtype with f32 master weights."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), b, self.stride, self.padding,
                        self.dilation, self.groups)


class LayerNorm(nn.LayerNorm):
    """Affine LayerNorm over the last axis with f32 statistics
    (open_clip LayerNormFp32)."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """GroupNorm over NCHW with f32 statistics."""

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                            self.eps).to(x.dtype)


def quick_gelu(x):
    """x·σ(1.702x), the OpenAI CLIP activation."""
    return x * torch.sigmoid(1.702 * x)


class MultiheadAttention(nn.Module):
    """Packed-QKV softmax attention with torch nn.MultiheadAttention's
    parameter names, on (B, N, D) tokens: plain matmuls and an f32 softmax."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = Linear(width, width)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x, mask=None):
        B, N, D = x.shape
        H = self.heads
        hd = D // H
        qkv = F.linear(x, self.in_proj_weight.to(x.dtype), self.in_proj_bias.to(x.dtype))
        q, k, v = (t.reshape(B, N, H, hd) for t in qkv.chunk(3, dim=-1))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (hd ** -0.5)
        if mask is not None:
            logits = logits + mask.float()
        attn = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, N, D)
        return self.out_proj(out)


class MLP(nn.Module):
    """c_fc → GELU (exact, or quick_gelu where the config says) → c_proj."""

    def __init__(self, width: int, mlp_width: int, quick: bool = False):
        super().__init__()
        self.c_fc = Linear(width, mlp_width)
        self.c_proj = Linear(mlp_width, width)
        self.quick = quick

    def forward(self, x):
        h = self.c_fc(x)
        h = quick_gelu(h) if self.quick else F.gelu(h, approximate="none")
        return self.c_proj(h)
