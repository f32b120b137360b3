"""EVA / EVA-02 image towers under open_clip's timm adapter.

Counterpart of `daclip_tpu/models/eva.py:58-269` (timm's eva.py model
definitions). The vendored EVA configs ask for `timm_pool: "token"` with
`timm_proj: null`: the adapter's first branch (timm_model.py:58-67), where
the trunk is made with `num_classes=embed_dim` and its classifier on the
class token IS the projection. So: patch embedding → class token + absolute
positions → blocks → LayerNorm → class token → `trunk.head` Linear.

  * eva_giant_patch14_224 (EVA-01 g/14): pre-norm blocks, BEiT-style fused
    qkv (a learned q and v bias, a constant zero k bias), GELU (erf) MLP;
  * eva02_{base,large}_patch{16,14}_clip_*: separate q/k/v projections (k
    without bias), 2-D axial rotary embedding of the patch tokens (the
    class token unrotated), a LayerNorm over the concatenated heads before
    the output projection and a SwiGLU MLP with a LayerNorm before its
    down-projection (the EVA-CLIP extras);
  * eva02_enormous_patch14_clip_224: post-norm blocks (the residual adds
    the LayerNorm of the sublayer's output), fused qkv, GELU MLP.

Parameter names are timm's (`trunk.patch_embed.proj`, `trunk.cls_token`,
`trunk.pos_embed`, `trunk.blocks.{i}.attn.{qkv,q_bias,v_bias}` or
`.attn.{q,k,v}_proj`, `.attn.norm`, `.mlp.fc1_g`, `.mlp.fc1_x`, `.mlp.norm`,
`trunk.norm`, `trunk.head`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from daclip_torch.models.convnext import _no_controller
from daclip_torch.models.layers import Conv2d, LayerNorm, Linear, run_block

# timm's model definitions of the vendored EVA configs; hidden sizes are
# timm's int(width · mlp_ratio): 6144, 2048, 2730 (truncated), 15360
EVA_VARIANTS = {
    "eva_giant_patch14_224": dict(
        patch=14, width=1408, depth=40, heads=16, hidden=6144,
        swiglu=False, clip_extras=False, rope=False, post_norm=False,
        fused_qkv=True, ref_feat=None),
    "eva02_base_patch16_clip_224": dict(
        patch=16, width=768, depth=12, heads=12, hidden=2048,
        swiglu=True, clip_extras=True, rope=True, post_norm=False,
        fused_qkv=False, ref_feat=(16, 16)),
    "eva02_large_patch14_clip_224": dict(
        patch=14, width=1024, depth=24, heads=16, hidden=2730,
        swiglu=True, clip_extras=True, rope=True, post_norm=False,
        fused_qkv=False, ref_feat=(16, 16)),
    "eva02_large_patch14_clip_336": dict(
        patch=14, width=1024, depth=24, heads=16, hidden=2730,
        swiglu=True, clip_extras=True, rope=True, post_norm=False,
        fused_qkv=False, ref_feat=(16, 16)),
    "eva02_enormous_patch14_clip_224": dict(
        patch=14, width=1792, depth=64, heads=16, hidden=15360,
        swiglu=False, clip_extras=False, rope=False, post_norm=True,
        fused_qkv=True, ref_feat=None),
}


def rope_tables(grid_hw: Tuple[int, int], head_dim: int,
                ref_feat: Optional[Tuple[int, int]] = None,
                temperature: float = 10000.0):
    """2-D axial rotary sin and cos tables, (N_patches, head_dim) each
    (timm RotaryEmbeddingCat, in_pixels=False): per axis head_dim//4
    bands 1/T^(i/nb) over the integer coordinates (rescaled to `ref_feat`
    when given), the two axes concatenated and each value repeated ×2 for
    the interleaved (even, odd) pairs."""
    nb = head_dim // 4
    bands = 1.0 / (temperature ** (np.arange(nb, dtype=np.float64) / nb))
    ts = []
    for i, s in enumerate(grid_hw):
        t = np.arange(s, dtype=np.float64)
        if ref_feat is not None:
            t = t / s * ref_feat[i]
        ts.append(t)
    gh, gw = np.meshgrid(ts[0], ts[1], indexing="ij")
    pos = (np.stack([gh, gw], axis=-1)[..., None] * bands).reshape(-1, 2 * nb)
    sin = np.repeat(np.sin(pos), 2, axis=-1).astype(np.float32)
    cos = np.repeat(np.cos(pos), 2, axis=-1).astype(np.float32)
    return sin, cos


def apply_rope(x, sin, cos):
    """x·cos + rot(x)·sin over interleaved pairs; x (B, N, H, hd), sin and
    cos (N, hd) (timm apply_rot_embed_cat)."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    rot = torch.stack([-x2, x1], dim=-1).reshape(x.shape)
    return x * cos[None, :, None].to(x.dtype) + rot * sin[None, :, None].to(x.dtype)


class EvaAttention(nn.Module):
    """Fused qkv with q and v biases (k's is zero), or q/k/v projections
    (k without bias); rope on the patch tokens; with `inner_norm` a
    LayerNorm over the concatenated heads before `proj`."""

    def __init__(self, dim: int, heads: int, fused_qkv: bool, inner_norm: bool):
        super().__init__()
        self.heads, self.fused = heads, fused_qkv
        if fused_qkv:
            self.qkv = Linear(dim, 3 * dim, bias=False)
            self.q_bias = nn.Parameter(torch.zeros(dim))
            self.v_bias = nn.Parameter(torch.zeros(dim))
        else:
            self.q_proj = Linear(dim, dim)
            self.k_proj = Linear(dim, dim, bias=False)
            self.v_proj = Linear(dim, dim)
        self.norm = LayerNorm(dim, eps=1e-6) if inner_norm else nn.Identity()
        self.proj = Linear(dim, dim)

    def forward(self, x, rope=None):
        B, N, D = x.shape
        H = self.heads
        hd = D // H
        if self.fused:
            q, k, v = self.qkv(x).chunk(3, dim=-1)
            q = q + self.q_bias.to(x.dtype)
            v = v + self.v_bias.to(x.dtype)
        else:
            q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        q, k, v = (t.reshape(B, N, H, hd) for t in (q, k, v))
        if rope is not None:
            sin, cos = rope
            q = torch.cat([q[:, :1], apply_rope(q[:, 1:], sin, cos)], dim=1)
            k = torch.cat([k[:, :1], apply_rope(k[:, 1:], sin, cos)], dim=1)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (hd ** -0.5)
        a = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, N, D)
        return self.proj(self.norm(out))


class EvaMlp(nn.Module):
    """SwiGLU (`fc1_g`, `fc1_x`: silu(g)·x) or GELU (`fc1`); with
    `sub_norm` a LayerNorm before `fc2` (timm SwiGLU / Mlp)."""

    def __init__(self, dim: int, hidden: int, swiglu: bool, sub_norm: bool):
        super().__init__()
        self.swiglu = swiglu
        if swiglu:
            self.fc1_g = Linear(dim, hidden)
            self.fc1_x = Linear(dim, hidden)
        else:
            self.fc1 = Linear(dim, hidden)
        self.norm = LayerNorm(hidden, eps=1e-6) if sub_norm else nn.Identity()
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        if self.swiglu:
            h = F.silu(self.fc1_g(x)) * self.fc1_x(x)
        else:
            h = F.gelu(self.fc1(x), approximate="none")
        return self.fc2(self.norm(h))


class EvaBlock(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        D = cfg["width"]
        self.post_norm = cfg["post_norm"]
        self.norm1 = LayerNorm(D, eps=1e-6)
        self.attn = EvaAttention(D, cfg["heads"], cfg["fused_qkv"], cfg["clip_extras"])
        self.norm2 = LayerNorm(D, eps=1e-6)
        self.mlp = EvaMlp(D, cfg["hidden"], cfg["swiglu"], cfg["clip_extras"])

    def forward(self, x, rope=None):
        if self.post_norm:  # EvaBlockPostNorm: the norm of the sublayer's output
            x = x + self.norm1(self.attn(x, rope))
            return x + self.norm2(self.mlp(x))
        x = x + self.attn(self.norm1(x), rope)
        return x + self.mlp(self.norm2(x))


class _PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = Conv2d(3, dim, patch, stride=patch)


class Eva(nn.Module):
    """The trunk with its classifier kept: the class token's projection."""

    def __init__(self, cfg: dict, embed_dim: int, image_size: int, remat: bool = False):
        super().__init__()
        self.cfg, self.remat = cfg, remat
        D, p = cfg["width"], cfg["patch"]
        self.patch_embed = _PatchEmbed(p, D)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_embed = nn.Parameter(0.02 * torch.randn(1, (image_size // p) ** 2 + 1, D))
        self.blocks = nn.ModuleList([EvaBlock(cfg) for _ in range(cfg["depth"])])
        self.norm = LayerNorm(D, eps=1e-6)
        self.head = Linear(D, embed_dim)

    def forward(self, x):
        x = self.patch_embed.proj(x)
        gh, gw = x.shape[2:]
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1), x], dim=1)
        x = x + self.pos_embed.to(x.dtype)
        rope = None
        if self.cfg["rope"]:
            ref = self.cfg["ref_feat"]
            sin, cos = rope_tables((gh, gw), self.cfg["width"] // self.cfg["heads"],
                                   tuple(ref) if ref else None)
            rope = (torch.from_numpy(sin).to(x.device), torch.from_numpy(cos).to(x.device))
        for block in self.blocks:
            x = run_block(block, self.remat, x, rope)
        return self.head(self.norm(x)[:, 0])


class EvaTower(nn.Module):
    """open_clip's TimmModel in its first branch: `trunk` only, its output
    the CLIP image embedding."""

    def __init__(self, model_name: str, embed_dim: int, image_size: int = 224,
                 remat: bool = False):
        super().__init__()
        self.trunk = Eva(EVA_VARIANTS[model_name], embed_dim, image_size, remat)

    def forward(self, x, control=None, output_hiddens: bool = False,
                dtype: torch.dtype = torch.float32, train: bool = False, generator=None):
        _no_controller("EVA", control, output_hiddens)
        return self.trunk(x.to(dtype))
