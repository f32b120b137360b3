"""The two plain-timm ViT towers among the vendored configs, under open_clip's
timm adapter (`timm_pool: ""`, `timm_proj: "linear"`: the trunk with its
classifier reset and the network's default pooling, then a bias-free Linear
to embed_dim).

Counterpart of `daclip_tpu/models/timm_vit.py:67-225`:
  * vit_medium_patch16_gap_256 — width 512, depth 12, 8 heads, patch 16 at
    256 px, no class token, global average pooling, qkv without bias,
    LayerScale (init 1e-6), the final norm before the pool;
  * vit_relpos_medium_patch16_cls_224 — the same widths at 224 px, a class
    token pooled, no absolute position embedding; each block's attention
    adds a relative-position bias from a small MLP over signed-log relative
    coordinates (timm RelPosMlp, mode 'cr': 2 → ReLU(256) → heads),
    gathered to (N, N) by the relative-index table and zero-padded over the
    class token.

Parameter names are timm's (`trunk.patch_embed.proj`, `trunk.cls_token`,
`trunk.pos_embed`, `trunk.blocks.{i}.attn.qkv`, `.ls1.gamma`,
`.attn.rel_pos.mlp.fc1`, `trunk.norm`) and the adapter's `head.proj`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from daclip_torch.models.convnext import AdapterHead, GeluMlp, _no_controller
from daclip_torch.models.layers import Conv2d, LayerNorm, Linear, run_block

TIMM_VIT_VARIANTS = {
    "vit_medium_patch16_gap_256": dict(
        patch=16, width=512, depth=12, heads=8, mlp_ratio=4.0,
        qkv_bias=False, class_token=False, pool="avg", ls_init=1e-6,
        relpos=False),
    "vit_relpos_medium_patch16_cls_224": dict(
        patch=16, width=512, depth=12, heads=8, mlp_ratio=4.0,
        qkv_bias=False, class_token=True, pool="token", ls_init=1e-6,
        relpos=True, rel_pos_dim=256),
}


def relpos_index(grid: int) -> np.ndarray:
    """Relative-position index (the Swin/BEiT construction): flat (N·N,)
    indices into the (2g−1)² relative-coordinate table."""
    coords = np.stack(np.meshgrid(np.arange(grid), np.arange(grid),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0).astype(np.int32)
    rel += grid - 1
    return (rel[..., 0] * (2 * grid - 1) + rel[..., 1]).reshape(-1)


def relpos_log_coords(grid: int) -> np.ndarray:
    """Signed-log relative coordinates, ((2g−1)², 2) float32 (timm
    gen_relative_log_coords, mode 'cr': sign(c)·log(1 + |c|))."""
    r = np.arange(-(grid - 1), grid, dtype=np.float32)
    ch, cw = np.meshgrid(r, r, indexing="ij")
    table = np.stack([ch, cw], axis=-1).reshape(-1, 2)
    return np.sign(table) * np.log1p(np.abs(table))


class LayerScale(nn.Module):
    """timm LayerScale: x·gamma."""

    def __init__(self, dim: int, init: float):
        super().__init__()
        self.gamma = nn.Parameter(init * torch.ones(dim))

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


class RelPosMlp(nn.Module):
    """timm RelPosMlp, mode 'cr': the (heads, N, N) bias of a g×g grid,
    zero-padded over `prefix` leading tokens, in float32."""

    def __init__(self, heads: int, hidden: int):
        super().__init__()
        self.heads = heads
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(2, hidden)
        self.mlp.fc2 = nn.Linear(hidden, heads)

    def forward(self, coords, index, prefix: int) -> torch.Tensor:
        """`coords` and `index` a grid's `relpos_log_coords` and
        `relpos_index` on the device."""
        tab = self.mlp.fc2(F.relu(self.mlp.fc1(coords)))
        n = int(len(index) ** 0.5)
        bias = tab[index].reshape(n, n, self.heads).permute(2, 0, 1)
        return F.pad(bias, (prefix, 0, prefix, 0))


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, qkv_bias: bool, rel_pos_hidden: Optional[int]):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = Linear(dim, dim)
        self.rel_pos = RelPosMlp(heads, rel_pos_hidden) if rel_pos_hidden else None

    def forward(self, x, rel, prefix: int):
        B, N, D = x.shape
        H = self.heads
        hd = D // H
        q, k, v = (t.reshape(B, N, H, hd) for t in self.qkv(x).chunk(3, dim=-1))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (hd ** -0.5)
        if self.rel_pos is not None:
            logits = logits + self.rel_pos(*rel, prefix)[None]
        a = torch.softmax(logits, dim=-1).to(x.dtype)
        return self.proj(torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, N, D))


class Block(nn.Module):
    """Pre-norm timm Block / RelPosBlock."""

    def __init__(self, dim: int, heads: int, hidden: int, qkv_bias: bool,
                 ls_init: Optional[float], rel_pos_hidden: Optional[int]):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads, qkv_bias, rel_pos_hidden)
        self.ls1 = LayerScale(dim, ls_init) if ls_init is not None else nn.Identity()
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = GeluMlp(dim, hidden)
        self.ls2 = LayerScale(dim, ls_init) if ls_init is not None else nn.Identity()

    def forward(self, x, rel, prefix: int):
        x = x + self.ls1(self.attn(self.norm1(x), rel, prefix))
        return x + self.ls2(self.mlp(self.norm2(x)))


class _PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = Conv2d(3, dim, patch, stride=patch)


class TimmViT(nn.Module):
    """The trunk, classifier reset: tokens after the final norm."""

    def __init__(self, cfg: dict, image_size: int, remat: bool = False):
        super().__init__()
        D, p = cfg["width"], cfg["patch"]
        self.remat, self.relpos = remat, cfg["relpos"]
        self.prefix = int(cfg["class_token"])
        self.patch_embed = _PatchEmbed(p, D)
        if cfg["class_token"]:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        if not self.relpos:
            n = (image_size // p) ** 2 + self.prefix
            self.pos_embed = nn.Parameter(0.02 * torch.randn(1, n, D))
        rel_hidden = (cfg.get("rel_pos_dim") or 128) if cfg["relpos"] else None
        self.blocks = nn.ModuleList(
            [Block(D, cfg["heads"], int(D * cfg["mlp_ratio"]), cfg["qkv_bias"],
                   cfg["ls_init"], rel_hidden) for _ in range(cfg["depth"])])
        self.norm = LayerNorm(D, eps=1e-6)

    def forward(self, x):
        x = self.patch_embed.proj(x)
        grid = x.shape[2]
        rel = None
        if self.relpos:
            if grid != x.shape[3]:
                raise ValueError("the relpos tower assumes a square grid")
            rel = (torch.from_numpy(relpos_log_coords(grid)).to(x.device),
                   torch.from_numpy(relpos_index(grid)).long().to(x.device))
        x = x.flatten(2).transpose(1, 2)
        if self.prefix:
            x = torch.cat([self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1), x], dim=1)
        if not self.relpos:
            x = x + self.pos_embed.to(x.dtype)
        for block in self.blocks:
            x = run_block(block, self.remat, x, rel, self.prefix)
        return self.norm(x)


class TimmViTTower(nn.Module):
    """Trunk (classifier reset, default pooling) + the adapter's bias-free
    `head.proj` (timm_model.py:82-99)."""

    def __init__(self, model_name: str, embed_dim: int, image_size: int = 224,
                 pool: str = "", remat: bool = False):
        super().__init__()
        self.cfg = TIMM_VIT_VARIANTS[model_name]
        self.model_name = model_name
        # a non-empty pool is the reset_classifier(global_pool=pool) override
        self.pool = pool or self.cfg["pool"]
        self.trunk = TimmViT(self.cfg, image_size, remat)
        self.head = AdapterHead(self.cfg["width"], embed_dim, "linear")

    def forward(self, x, control=None, output_hiddens: bool = False,
                dtype: torch.dtype = torch.float32, train: bool = False, generator=None):
        _no_controller("timm ViT", control, output_hiddens)
        x = self.trunk(x.to(dtype))
        if self.pool == "token":
            x = x[:, 0]
        else:
            x = x[:, self.trunk.prefix:].mean(dim=1)
        return self.head(x)
