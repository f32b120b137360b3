"""ConditionalUNet — the IR-SDE noise network, in PyTorch.

Counterpart of `daclip_tpu/models/unet.py` (reference DenoisingUNet_arch.py:
21-174, the wild-ir variant with `scale=0.5`, module_util.py and
attention.py). It ports the math the reference computes, in the reference's
composition and with its state-dict key names, so `universal-ir.pth`-style
checkpoints load with `load_state_dict(strict=True)`.

Input and output are NCHW. On the card the activations run in
`torch.channels_last`, so the (B, H·W, C) view that the linear-attention
kernel and the SpatialTransformer take is free. Parameters are float32, the
compute dtype is `dtype` (bf16 on the card) with f32 normalisation
statistics; the output is float32.

The two attention sites go through the port's kernel wrappers:
`ops.linear_attention.attn_wrap` for every Residual(PreNorm(LinearAttention))
and `ops.flash_attention.flash_self_attention` for the SpatialTransformer's
self-attention; both are differentiable (kernel backwards on the card). The
single-token image-context cross-attention reduces exactly to `to_out(v)`
(softmax over one key is 1), so its `to_q`/`to_k` get no gradient.

The JAX UNet's other kernel wirings are arguments here (their environment
variables set `pipeline.RestorerConfig`'s defaults, `daclip_torch/flags.py`):
`linear_attention="v4"` runs the prenorm in PyTorch, then
`linear_attention_fused`, then the residual (`DACLIP_TPU_V5_WRAP=0`);
`"v3"` runs `attn_wrap_fused` (`V3_WRAP=1`); `pointwise=True` runs each
ResBlock's res_conv with out channels ≤ `pointwise_max_out` through the
`dual_conv1x1` kernel (`POINTWISE=1`, `POINTWISE_MAXO`). The parameters and
their names are the same in every wiring, so one checkpoint loads into all.

`remat=True` recomputes each ResBlock's and AttnWrap's activations in the
backward pass (`torch.utils.checkpoint`, as the JAX UNet's `nn.remat`).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from daclip_torch.models.layers import Conv2d, GroupNorm, LayerNorm, Linear
from daclip_torch.ops.flash_attention import attention_reference, flash_self_attention
from daclip_torch.ops.linear_attention import (_channel_ln, attn_wrap, attn_wrap_fused,
                                               linear_attention_fused)
from daclip_torch.ops.pointwise import dual_conv1x1

LINEAR_ATTENTION = ("v5", "v4", "v3")


def _tokens(x):
    """NCHW → (B, H·W, C); free when x is channels_last."""
    B, C, H, W = x.shape
    return x.permute(0, 2, 3, 1).reshape(B, H * W, C)


def _from_tokens(t, H: int, W: int):
    """(B, H·W, C) → NCHW view with channels_last strides."""
    B, _, C = t.shape
    return t.reshape(B, H, W, C).permute(0, 3, 1, 2)


def _kernel_layout(module: nn.Module, params, dtype: torch.dtype, layout):
    """`layout()`: copies of `params` in a kernel's layout and `dtype`. When
    grad is on and a parameter requires it, they are made under autograd on
    every call, so the gradients flow back to the f32 parameters. Otherwise
    (serving) they are made once per set of parameter values and kept on
    `module`: a load, an in-place update or a move of the parameters makes
    them anew."""
    if torch.is_grad_enabled() and any(p.requires_grad for p in params):
        return layout()
    key = (dtype,) + tuple((p.data_ptr(), p._version, p.device, p.dtype) for p in params)
    if module._layout[0] != key:
        with torch.no_grad():
            module._layout = (key, layout())
    return module._layout[1]


class SinusoidalPosEmb(nn.Module):
    """module_util.py:36-48."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t):
        half = self.dim // 2
        emb = math.log(10000.0) / (half - 1)
        freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * -emb)
        ang = t.float()[:, None] * freqs[None, :]
        return torch.cat([ang.sin(), ang.cos()], dim=-1)


class ChannelLayerNorm(nn.Module):
    """Bias-free LayerNorm over channels, biased variance, eps 1e-5
    (module_util.py:77-86); `g` keeps the reference's (1, C, 1, 1) shape."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(1, dim, 1, 1))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(1, keepdim=True)
        var = (xf - mean).square().mean(1, keepdim=True)
        return ((xf - mean) * torch.rsqrt(var + self.eps) * self.g).to(x.dtype)


class Block(nn.Module):
    """conv3x3 (no bias) → optional (scale+1)·x+shift → SiLU (module_util.py:115-129)."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.proj = Conv2d(dim, dim_out, 3, padding=1, bias=False)

    def forward(self, x, scale_shift=None):
        x = self.proj(x)
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1) + shift
        return F.silu(x)


class ResBlock(nn.Module):
    """Time-conditioned double conv with a residual (module_util.py:132-153).
    With `pointwise` the 1×1 res_conv runs through the `dual_conv1x1` kernel
    (JAX's `Conv1x1Pair` under DACLIP_TPU_POINTWISE=1, unet.py:222-247)."""

    def __init__(self, dim: int, dim_out: int, time_emb_dim: int, pointwise: bool = False):
        super().__init__()
        self.mlp = nn.Sequential(nn.SiLU(), Linear(time_emb_dim, dim_out * 2))
        self.block1 = Block(dim, dim_out)
        self.block2 = Block(dim_out, dim_out)
        self.res_conv = (Conv2d(dim, dim_out, 1, bias=False) if dim != dim_out
                         else nn.Identity())
        self.pointwise = pointwise and dim != dim_out
        self._layout = (None, None)  # (key, weight) of _kernel_layout

    def _res(self, x):
        if not self.pointwise:
            return self.res_conv(x)
        B, C, H, W = x.shape
        w = self.res_conv.weight
        wt = _kernel_layout(self, (w,), x.dtype,
                            lambda: w.reshape(w.shape[0], C).t().to(x.dtype).contiguous())
        y = dual_conv1x1(_tokens(x).reshape(B * H * W, C).contiguous(), None, wt)
        return _from_tokens(y.reshape(B, H * W, -1), H, W)

    def forward(self, x, time_emb):
        h = self.mlp(time_emb)[:, :, None, None]
        h = self.block1(x, h.chunk(2, dim=1))
        h = self.block2(h)
        return h + self._res(x)


class LinearAttention(nn.Module):
    """Channel linear attention, 4 heads × 32 (module_util.py:157-185). Its
    forward runs inside `AttnWrap`, which hands the whole
    Residual(PreNorm(·)) to the `attn_wrap` kernel."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        hidden = heads * dim_head
        self.to_qkv = Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Sequential(Conv2d(hidden, dim, 1), ChannelLayerNorm(dim))


class CrossAttention(nn.Module):
    """attention.py:152-193 on (B, N, C) tokens."""

    def __init__(self, query_dim: int, context_dim: Optional[int], heads: int,
                 dim_head: int):
        super().__init__()
        inner = heads * dim_head
        context_dim = query_dim if context_dim is None else context_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(context_dim, inner, bias=False)
        self.to_v = Linear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(Linear(inner, query_dim), nn.Dropout(0.0))

    def forward(self, x, context=None):
        B, N, _ = x.shape
        if context is not None and context.shape[1] == 1:
            # softmax over a single key is 1: out = to_out(v), exactly
            v = self.to_v(context.to(x.dtype))
            return self.to_out(v.expand(B, N, v.shape[-1]))
        ctx = x if context is None else context.to(x.dtype)
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        if context is None:
            out = flash_self_attention(q, k, v, self.heads, self.dim_head)
        else:
            out = attention_reference(q, k, v, self.heads, self.dim_head)
        return self.to_out(out)


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = Linear(dim_in, dim_out * 2)

    def forward(self, x):
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate, approximate="none")


class FeedForward(nn.Module):
    """GEGLU(dim → 4·dim) → Linear(4·dim → dim) (attention.py:37-64)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, dim * mult), nn.Dropout(0.0),
                                 Linear(dim * mult, dim))

    def forward(self, x):
        return self.net(x)


class BasicTransformerBlock(nn.Module):
    """Self-attention, cross-attention and GEGLU FF, each pre-LN residual
    (attention.py:196-215)."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim=None):
        super().__init__()
        self.attn1 = CrossAttention(dim, None, heads, dim_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.norm3 = LayerNorm(dim)

    def forward(self, x, context=None):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context=context) + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    """GroupNorm(32, eps 1e-6) → 1×1 in → transformer block(s) → 1×1 out,
    inner residual (attention.py:218-261)."""

    def __init__(self, in_channels: int, heads: int, dim_head: int, depth: int = 1,
                 context_dim=None):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm(32, in_channels, eps=1e-6)
        self.proj_in = Conv2d(in_channels, inner, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, dim_head, context_dim)
             for _ in range(depth)])
        self.proj_out = Conv2d(inner, in_channels, 1)

    def forward(self, x, context=None):
        H, W = x.shape[2:]
        h = _tokens(self.proj_in(self.norm(x)))
        for block in self.transformer_blocks:
            h = block(h, context=context)
        return self.proj_out(_from_tokens(h, H, W)) + x


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.fn = fn
        self.norm = ChannelLayerNorm(dim)


class AttnWrap(nn.Module):
    """Residual(PreNorm(dim, attn)) (module_util.py:27-33, 89-97). With
    LinearAttention the wrap takes the route of `linear_attention`
    (daclip_tpu/models/unet.py:296-316, 455): "v5" one `attn_wrap` call on
    the raw x; "v4" the prenorm here, `linear_attention_fused`, then + x;
    "v3" one `attn_wrap_fused` call."""

    def __init__(self, dim: int, use_spatial: bool, heads: int, context_dim=None,
                 linear_attention: str = "v5"):
        super().__init__()
        fn = (SpatialTransformer(dim, heads, 32, context_dim=context_dim)
              if use_spatial else LinearAttention(dim))
        self.fn = PreNorm(dim, fn)
        self.linear_attention = linear_attention
        self._layout = (None, None)  # (key, weights) of _kernel_layout

    def _kernel_weights(self, dtype: torch.dtype):
        """g_pre, w_qkv (C, 384), w_out (128, C), b_out, g_out in the kernels'
        layout and `dtype` (`_kernel_layout`), for every route."""
        attn = self.fn.fn
        out_conv, out_norm = attn.to_out[0], attn.to_out[1]
        params = (self.fn.norm.g, attn.to_qkv.weight, out_conv.weight, out_conv.bias,
                  out_norm.g)

        def layout():
            g_pre, w_qkv, w_out, b_out, g_out = params
            C = g_pre.numel()
            weights = (g_pre.reshape(C), w_qkv.reshape(-1, C).t(),
                       w_out.reshape(C, -1).t(), b_out, g_out.reshape(C))
            return tuple(w.to(dtype).contiguous() for w in weights)

        return _kernel_layout(self, params, dtype, layout)

    def forward(self, x, context=None):
        attn = self.fn.fn
        if isinstance(attn, SpatialTransformer):
            return attn(self.fn.norm(x), context=context) + x
        H, W = x.shape[2:]
        t = _tokens(x).contiguous()
        weights = self._kernel_weights(x.dtype)
        if self.linear_attention == "v4":
            g_pre, *rest = weights
            y = linear_attention_fused(_channel_ln(t, g_pre), *rest) + t
        elif self.linear_attention == "v3":
            y = attn_wrap_fused(t, *weights)
        else:
            y = attn_wrap(t, *weights)
        return _from_tokens(y, H, W)


class Upsample(nn.Sequential):
    """nearest 2× → conv3x3 with bias (module_util.py:100-104)."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__(nn.Upsample(scale_factor=2, mode="nearest"),
                         Conv2d(dim, dim_out, 3, padding=1))


def Downsample(dim: int, dim_out: int):
    """conv4x4 stride 2 pad 1 with bias (module_util.py:107-108)."""
    return Conv2d(dim, dim_out, 4, 2, 1)


class ConditionalUNet(nn.Module):
    """forward(xt, cond, time, text_context, image_context) predicts the noise;
    the input is cat(xt − cond, cond) on channels (DenoisingUNet_arch.py:21-174).

    `spatial_attn_min_level`: levels i ≥ this use a SpatialTransformer instead
    of LinearAttention when the image context is on (daclip-sde: 3;
    wild-ir: depth−1). `scale=0.5` is wild-ir's internal down/upsample.
    `linear_attention` ("v5", "v4" or "v3") picks the LinearAttention sites'
    kernel route; `pointwise` runs the res_convs with at most
    `pointwise_max_out` out channels (None: every one) through the dual 1×1
    kernel."""

    def __init__(self, in_nc: int = 3, out_nc: int = 3, nf: int = 64,
                 ch_mult: Sequence[int] = (1, 2, 4, 8), context_dim: Optional[int] = 512,
                 use_degra_context: bool = True, use_image_context: bool = False,
                 scale: float = 1.0, spatial_attn_min_level: int = 3,
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 linear_attention: str = "v5", pointwise: bool = False,
                 pointwise_max_out: Optional[int] = None):
        super().__init__()
        if linear_attention not in LINEAR_ATTENTION:
            raise ValueError(f"linear_attention must be one of {LINEAR_ATTENTION}, "
                             f"got {linear_attention!r}")
        def res(dim, out):
            pw = pointwise and (pointwise_max_out is None or out <= pointwise_max_out)
            return ResBlock(dim, out, time_dim, pointwise=pw)
        self.depth = depth = len(ch_mult)
        self.scale = scale
        self.dtype = dtype
        self.remat = remat
        self.use_degra_context = use_degra_context
        self.use_image_context = use_image_context
        cdim = -1 if context_dim is None else context_dim
        self.cdim = cdim
        time_dim = nf * 4

        self.init_conv = Conv2d(in_nc * 2, nf, 7, padding=3, bias=False)
        self.time_mlp = nn.Sequential(SinusoidalPosEmb(nf), Linear(nf, time_dim),
                                      nn.GELU(), Linear(time_dim, time_dim))
        if cdim > 0 and use_degra_context:
            self.prompt = nn.Parameter(torch.rand(1, time_dim))
            self.text_mlp = nn.Sequential(Linear(cdim, time_dim), nn.SiLU(),
                                          Linear(time_dim, time_dim))
            self.prompt_mlp = Linear(time_dim, time_dim)
        if scale == 0.5:
            self.downsample = Downsample(nf, nf)
            self.upsample = Upsample(nf, nf)

        ch = [1] + list(ch_mult)
        self.downs = nn.ModuleList()
        self.ups = nn.ModuleList()
        for i in range(depth):
            dim_in, dim_out = nf * ch[i], nf * ch[i + 1]
            spatial = use_image_context and cdim > 0 and i >= spatial_attn_min_level
            self.downs.append(nn.ModuleList([
                res(dim_in, dim_in),
                res(dim_in, dim_in),
                AttnWrap(dim_in, spatial, dim_in // 32, cdim, linear_attention),
                Downsample(dim_in, dim_out) if i != depth - 1
                else Conv2d(dim_in, dim_out, 3, padding=1, bias=False),
            ]))
            # the reference inserts at 0: ups[j] is level depth-1-j
            self.ups.insert(0, nn.ModuleList([
                res(dim_out + dim_in, dim_out),
                res(dim_out + dim_in, dim_out),
                AttnWrap(dim_out, spatial, dim_out // 32, cdim, linear_attention),
                Upsample(dim_out, dim_in) if i != 0
                else Conv2d(dim_out, dim_in, 3, padding=1, bias=False),
            ]))
        mid = nf * ch[-1]
        self.mid_block1 = res(mid, mid)
        self.mid_attn = AttnWrap(mid, use_image_context and cdim > 0, mid // 32, cdim,
                                 linear_attention)
        self.mid_block2 = res(mid, mid)
        self.final_res_block = res(nf * 2, nf)
        self.final_conv = Conv2d(nf, out_nc, 3, padding=1)

    def _call(self, block, *args, **kwargs):
        """block(*args, **kwargs), its activations recomputed in the backward
        pass when remat is on."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False, **kwargs)
        return block(*args, **kwargs)

    def forward(self, xt, cond, time, text_context=None, image_context=None):
        dt = self.dtype
        call = self._call
        if not torch.is_tensor(time) or time.dim() == 0:
            time = torch.full((xt.shape[0],), float(time), dtype=torch.float32,
                              device=xt.device)
        x = torch.cat([xt - cond, cond], dim=1).to(dt)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)

        # reflect-pad H, W to a multiple of 2^depth (:111-116)
        H, W = x.shape[2:]
        s = 2 ** self.depth
        pad_h, pad_w = (s - H % s) % s, (s - W % s) % s
        if pad_h or pad_w:
            x = F.pad(x, (0, pad_w, 0, pad_h), mode="reflect")

        x = self.init_conv(x)
        x_skip = x
        if self.scale == 0.5:
            x = self.downsample(x)

        t = self.time_mlp[0](time).to(dt)
        t = self.time_mlp[3](F.gelu(self.time_mlp[1](t), approximate="none"))
        if self.cdim > 0 and self.use_degra_context and text_context is not None:
            pe = self.text_mlp(text_context.to(dt))
            pe = torch.softmax(pe.float(), dim=1).to(dt) * self.prompt.to(dt)
            t = t + self.prompt_mlp(pe)

        ctx = None
        if self.use_image_context and self.cdim > 0 and image_context is not None:
            ctx = image_context[:, None, :]  # (B, 1, cdim) (:139-140)

        hs = []
        for block1, block2, attn, down in self.downs:
            x = call(block1, x, t)
            hs.append(x)
            x = call(block2, x, t)
            x = call(attn, x, context=ctx)
            hs.append(x)
            x = down(x)

        x = call(self.mid_block1, x, t)
        x = call(self.mid_attn, x, context=ctx)
        x = call(self.mid_block2, x, t)

        for block1, block2, attn, up in self.ups:
            x = call(block1, torch.cat([x, hs.pop()], dim=1), t)
            x = call(block2, torch.cat([x, hs.pop()], dim=1), t)
            x = call(attn, x, context=ctx)
            x = up(x)

        if self.scale == 0.5:
            x = self.upsample(x)
        x = call(self.final_res_block, torch.cat([x, x_skip], dim=1), t)
        x = self.final_conv(x)
        return x[:, :, :H, :W].float().contiguous()
