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

import math
import sys

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


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


def run_block(block, remat: bool, *args):
    """`block(*args)`, its activations recomputed in the backward pass when
    `remat` is on and a gradient is being taken (--grad-checkpointing)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(block, *args, use_reentrant=False)
    return block(*args)


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
    """torch nn.MultiheadAttention's parameters and semantics on (B, N, D)
    tokens: plain matmuls and an f32 softmax. Q, K and V are packed in
    `in_proj_weight` unless `kdim` / `vdim` differ from the width, where
    torch keeps `q_proj_weight`, `k_proj_weight`, `v_proj_weight` (the CoCa
    attentional pooler, JAX `layers.py:141`). `forward(x, mask)` is
    self-attention; `forward(x, mask, kv=y)` attends from x to y, or to
    `kv=project_kv(y)`. With
    `tp_group` (self-attention, packed) the packed rows hold q, k and v of
    this rank's heads and `out_proj.weight` their input columns."""

    tp_group = None

    def __init__(self, width: int, heads: int, kdim: int = None, vdim: int = None):
        super().__init__()
        self.heads = heads
        kdim, vdim = kdim or width, vdim or width
        self.packed = kdim == width and vdim == width
        if self.packed:
            self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
            nn.init.xavier_uniform_(self.in_proj_weight)
        else:
            self.q_proj_weight = nn.Parameter(torch.empty(width, width))
            self.k_proj_weight = nn.Parameter(torch.empty(width, kdim))
            self.v_proj_weight = nn.Parameter(torch.empty(width, vdim))
            for w in (self.q_proj_weight, self.k_proj_weight, self.v_proj_weight):
                nn.init.xavier_uniform_(w)
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = Linear(width, width)

    def _attend(self, q, k, v, mask):
        """Softmax attention of (B, Nq, H, hd) q over (B, Nk, H, hd) k, v."""
        hd = q.shape[-1]
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (hd ** -0.5)
        if mask is not None:
            logits = logits + mask.float()
        attn = torch.softmax(logits, dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", attn, v).flatten(2)

    def forward(self, x, mask=None, kv=None):
        B, N, D = x.shape
        hd = D // self.heads
        if kv is not None:
            return self._cross(x, kv, mask, hd)
        w = local_tensor(self.in_proj_weight)
        H = w.shape[0] // (3 * hd)  # this rank's heads
        qkv = F.linear(copy_to_model(x, self.tp_group), w.to(x.dtype),
                       local_tensor(self.in_proj_bias).to(x.dtype))
        q, k, v = (t.reshape(B, N, H, hd) for t in qkv.chunk(3, dim=-1))
        return row_parallel(self.out_proj, self._attend(q, k, v, mask), self.tp_group)

    def _weights(self):
        if self.packed:
            return self.in_proj_weight.chunk(3)
        return self.q_proj_weight, self.k_proj_weight, self.v_proj_weight

    def project_kv(self, kv):
        """The (B, Nk, H, hd) keys and values of `kv`, which `forward` also
        takes in their place (a decoder's image tokens, projected once)."""
        _, wk, wv = self._weights()
        _, bk, bv = self.in_proj_bias.to(kv.dtype).chunk(3)
        hd = wk.shape[0] // self.heads
        return tuple(F.linear(kv, w.to(kv.dtype), b).reshape(kv.shape[0], kv.shape[1], -1, hd)
                     for w, b in ((wk, bk), (wv, bv)))

    def _cross(self, x, kv, mask, hd):
        if self.tp_group is not None:
            raise NotImplementedError("cross-attention is not split over a model axis")
        B, N, D = x.shape
        wq = self._weights()[0]
        q = F.linear(x, wq.to(x.dtype), self.in_proj_bias.to(x.dtype).chunk(3)[0])
        k, v = kv if isinstance(kv, tuple) else self.project_kv(kv)
        return self.out_proj(self._attend(q.reshape(B, N, -1, hd), k, v, mask).reshape(B, N, D))


class ScaledCosineAttention(nn.Module):
    """open_clip's custom `Attention` (transformer.py:87-160) under its
    state-dict names (`in_proj_weight`, `in_proj_bias`, `logit_scale`,
    `head_scale`, `out_proj`), on (B, N, D) tokens as daclip_tpu's
    `ScaledCosineAttention` (models/layers.py:82): optional scaled-cosine
    logits (L2-normalised q and k, a learned per-head temperature clamped at
    `logit_scale_max`) and optional per-head output scaling; logits and
    softmax in float32. No shipped config uses it."""

    def __init__(self, width: int, heads: int, scaled_cosine: bool = True,
                 scale_heads: bool = False, logit_scale_max: float = math.log(1 / 0.01)):
        super().__init__()
        self.heads, self.logit_scale_max = heads, logit_scale_max
        self.head_dim = width // heads
        self.in_proj_weight = nn.Parameter(torch.randn(3 * width, width) * self.head_dim ** -0.5)
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.logit_scale = (nn.Parameter(torch.full((heads, 1, 1), math.log(10.0)))
                            if scaled_cosine else None)
        self.head_scale = nn.Parameter(torch.ones(heads, 1, 1)) if scale_heads else None
        self.out_proj = Linear(width, width)

    def forward(self, x, mask=None):
        B, N, D = x.shape
        qkv = F.linear(x, self.in_proj_weight.to(x.dtype), self.in_proj_bias.to(x.dtype))
        q, k, v = (t.reshape(B, N, self.heads, self.head_dim).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        if self.logit_scale is not None:
            logits = (F.normalize(q.float(), dim=-1) @ F.normalize(k.float(), dim=-1).mT
                      * torch.clamp(self.logit_scale, max=self.logit_scale_max).exp())
        else:
            logits = (q @ k.mT).float() * self.head_dim ** -0.5
        if mask is not None:
            logits = logits + mask.float()
        out = logits.softmax(dim=-1).to(x.dtype) @ v
        if self.head_scale is not None:
            out = out * self.head_scale.to(out.dtype)
        return self.out_proj(out.transpose(1, 2).reshape(B, N, D))


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
