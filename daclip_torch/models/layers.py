"""Shared building blocks for the port's models.

Conventions (those of `daclip_tpu/models/layers.py`): parameters live in
float32, activations in the compute dtype of their input (bf16 on the card),
normalisation statistics and attention softmax in float32. Parameter names
are the reference's, so its state dicts load strictly.

Under tensor parallelism (`daclip_torch.parallel.apply_tensor_parallel`)
the attention's and MLP's split parameters are DTensors and the module's
`tp_group` is set: the forward computes on this rank's part
(`local_tensor`) and sums the partial outputs over the group (Megatron's f
and g, `copy_to_model` / `reduce_from_model`). With no group both are the
identity and the forward is the single-card one.
"""
from __future__ import annotations

import sys

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """The part of `t` this rank holds: a DTensor's local tensor (an FSDP
    shard, a tensor-parallel part), else `t`. A DTensor exists only once
    torch.distributed.tensor is imported, so the check does not import it."""
    dtensor = sys.modules.get("torch.distributed.tensor")
    return t.to_local() if dtensor is not None and isinstance(t, dtensor.DTensor) else t


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the input's gradient over the
    group (Megatron's f, before a column-parallel layer)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over the group forward; identity backward (Megatron's g, after a
    row-parallel layer)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToModel.apply(x, group)


def row_parallel(linear: nn.Linear, x: torch.Tensor, group) -> torch.Tensor:
    """`linear(x)`; with a group, x holds this rank's input columns and
    `linear.weight` the matching part: the partial products are summed over
    the group, then the (whole) bias is added."""
    if group is None:
        return linear(x)
    y = _ReduceFromModel.apply(F.linear(x, local_tensor(linear.weight).to(x.dtype)), group)
    return y + linear.bias.to(x.dtype)


class Linear(nn.Linear):
    """nn.Linear computing in the input's dtype with f32 master weights."""

    def forward(self, x):
        b = None if self.bias is None else local_tensor(self.bias).to(x.dtype)
        return F.linear(x, local_tensor(self.weight).to(x.dtype), b)


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
    parameter names, on (B, N, D) tokens: plain matmuls and an f32 softmax.
    With `tp_group` the packed rows hold q, k and v of this rank's heads and
    `out_proj.weight` their input columns."""

    tp_group = None

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = Linear(width, width)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x, mask=None):
        B, N, D = x.shape
        hd = D // self.heads
        w = local_tensor(self.in_proj_weight)
        H = w.shape[0] // (3 * hd)  # this rank's heads
        qkv = F.linear(copy_to_model(x, self.tp_group), w.to(x.dtype),
                       local_tensor(self.in_proj_bias).to(x.dtype))
        q, k, v = (t.reshape(B, N, H, hd) for t in qkv.chunk(3, dim=-1))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (hd ** -0.5)
        if mask is not None:
            logits = logits + mask.float()
        attn = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, N, H * hd)
        return row_parallel(self.out_proj, out, self.tp_group)


class MLP(nn.Module):
    """c_fc → GELU (exact, or quick_gelu where the config says) → c_proj.
    With `tp_group`, c_fc holds this rank's hidden units and c_proj their
    input columns."""

    tp_group = None

    def __init__(self, width: int, mlp_width: int, quick: bool = False):
        super().__init__()
        self.c_fc = Linear(width, mlp_width)
        self.c_proj = Linear(mlp_width, width)
        self.quick = quick

    def forward(self, x):
        h = self.c_fc(copy_to_model(x, self.tp_group))
        h = quick_gelu(h) if self.quick else F.gelu(h, approximate="none")
        return row_parallel(self.c_proj, h, self.tp_group)
