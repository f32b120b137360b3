"""The Swin-Transformer image tower of swin_base_patch4_window7_224.json,
under open_clip's timm adapter (`timm_pool: ""`, `timm_proj: "linear"`).

Counterpart of `daclip_tpu/models/swin.py:46-205` (Swin-v1, Liu et al.
2021, as timm and Microsoft define it): a 4×4/4 patch embedding + LayerNorm,
four stages of windowed-attention blocks (depths 2/2/18/2, heads
4/8/16/32, window 7, MLP ratio 4, qkv bias, a learned relative-position
bias table per block), every second block shifting the windows by w//2
with the boundary-region mask, PatchMerging (2×2 concat → LN(4C) →
Linear(4C → 2C, no bias)) between stages, a final LayerNorm and the token
mean. LayerNorm eps is torch's 1e-5.

Parameter names are timm ≥ 0.9's: PatchMerging sits at the start of stage
i as `trunk.layers.{i}.downsample`. A state dict in the classic layout
(Microsoft / timm < 0.9: the merge at the end of stage i − 1), which
daclip_tpu's `convert_swin_visual` also reads, is renamed on load.
"""
from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from daclip_torch.models.convnext import AdapterHead, GeluMlp, _no_controller
from daclip_torch.models.layers import Conv2d, LayerNorm, Linear, run_block

SWIN_VARIANTS = {
    "swin_base_patch4_window7_224": dict(
        patch=4, embed=128, depths=(2, 2, 18, 2), heads=(4, 8, 16, 32),
        window=7, mlp_ratio=4.0),
}


def _rel_index(w: int) -> np.ndarray:
    """Relative-position index of one w×w window: flat (w²·w²,) indices
    into the (2w−1)² bias table (the Swin construction)."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel += w - 1
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).reshape(-1)


def _shift_mask(grid: int, w: int, shift: int) -> np.ndarray:
    """Additive (nW, w², w²) mask of shifted windows: 0 within one
    pre-shift region, −100 across regions (the timm / Microsoft constant)."""
    img = np.zeros((grid, grid), dtype=np.int32)
    cnt = 0
    bounds = (slice(0, -w), slice(-w, -shift), slice(-shift, None))
    for hs in bounds:
        for ws in bounds:
            img[hs, ws] = cnt
            cnt += 1
    wins = img.reshape(grid // w, w, grid // w, w).transpose(0, 2, 1, 3).reshape(-1, w * w)
    return np.where(wins[:, :, None] != wins[:, None, :], -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    """w×w windowed multi-head attention with a learned relative-position
    bias."""

    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads, self.window = heads, window
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            0.02 * torch.randn((2 * window - 1) ** 2, heads))

    def forward(self, x, idx, mask=None):
        """x (B·nW, w², C); `idx` the window's `_rel_index` on x's device."""
        nB, N, C = x.shape
        H = self.heads
        hd = C // H
        q, k, v = (t.reshape(nB, N, H, hd) for t in self.qkv(x).chunk(3, dim=-1))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (hd ** -0.5)
        bias = self.relative_position_bias_table[idx].reshape(N, N, H).permute(2, 0, 1)
        logits = logits + bias[None]
        if mask is not None:
            nW = mask.shape[0]
            logits = (logits.reshape(nB // nW, nW, H, N, N)
                      + mask[None, :, None]).reshape(nB, H, N, N)
        a = torch.softmax(logits, dim=-1).to(x.dtype)
        return self.proj(torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(nB, N, C))


class SwinBlock(nn.Module):
    """One block on a (B, G, G, C) map: LN, window attention (shifted by
    w//2 in a `shifted` block when the grid is wider than a window),
    residual; LN, MLP, residual."""

    def __init__(self, dim: int, heads: int, window: int, shifted: bool, mlp_ratio: float):
        super().__init__()
        self.window, self.shifted = window, shifted
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = LayerNorm(dim)
        self.mlp = GeluMlp(dim, int(dim * mlp_ratio))

    def forward(self, x, idx, mask):
        """`mask` the stage's `_shift_mask` on x's device (None where the
        grid is one window)."""
        B, G, _, C = x.shape
        w = self.window
        s = w // 2 if self.shifted and G > w else 0
        y = self.norm1(x)
        if s:
            y = torch.roll(y, (-s, -s), dims=(1, 2))
        wins = y.reshape(B, G // w, w, G // w, w, C).permute(0, 1, 3, 2, 4, 5)
        wins = self.attn(wins.reshape(-1, w * w, C), idx, mask if s else None)
        y = wins.reshape(B, G // w, G // w, w, w, C).permute(0, 1, 3, 2, 4, 5).reshape(B, G, G, C)
        if s:
            y = torch.roll(y, (s, s), dims=(1, 2))
        x = x + y
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """2×2 concat in timm's order [(h0,w0), (h1,w0), (h0,w1), (h1,w1)] →
    LN(4C) → Linear(4C → 2C, no bias)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        B, G, _, C = x.shape
        x = x.reshape(B, G // 2, 2, G // 2, 2, C).permute(0, 1, 3, 4, 2, 5)
        return self.reduction(self.norm(x.reshape(B, G // 2, G // 2, 4 * C)))


class SwinStage(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, window: int, mlp_ratio: float,
                 merge: bool):
        super().__init__()
        self.downsample = PatchMerging(dim // 2) if merge else nn.Identity()
        self.blocks = nn.ModuleList(
            [SwinBlock(dim, heads, window, j % 2 == 1, mlp_ratio) for j in range(depth)])


class _PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = Conv2d(3, dim, patch, stride=patch)
        self.norm = LayerNorm(dim)


class Swin(nn.Module):
    """The trunk, classifier reset: the normalised token mean."""

    def __init__(self, cfg: dict, image_size: int, remat: bool = False):
        super().__init__()
        self.cfg, self.image_size, self.remat = cfg, image_size, remat
        self.patch_embed = _PatchEmbed(cfg["patch"], cfg["embed"])
        layers = []
        for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["heads"])):
            layers.append(SwinStage(cfg["embed"] * 2 ** i, depth, heads, cfg["window"],
                                    cfg["mlp_ratio"], i > 0))
        self.layers = nn.ModuleList(layers)
        self.norm = LayerNorm(cfg["embed"] * 2 ** (len(layers) - 1))
        self._register_load_state_dict_pre_hook(self._classic_layout)

    def _classic_layout(self, state_dict, prefix, *args):
        """Rename a classic state dict's `layers.{i}.downsample` (the merge
        at the end of stage i) to timm ≥ 0.9's `layers.{i+1}.downsample`."""
        if f"{prefix}layers.0.downsample.norm.weight" not in state_dict:
            return
        pat = re.compile(re.escape(prefix) + r"layers\.(\d+)\.downsample\.(.*)$")
        moved = {}
        for k in [k for k in state_dict if pat.match(k)]:
            m = pat.match(k)
            moved[f"{prefix}layers.{int(m.group(1)) + 1}.downsample.{m.group(2)}"] = \
                state_dict.pop(k)
        state_dict.update(moved)

    def forward(self, x):
        p, w = self.cfg["patch"], self.cfg["window"]
        need = p * 2 ** (len(self.cfg["depths"]) - 1)
        H, W = x.shape[2:]
        if H % need or W % need or (H // need) % w or (W // need) % w:
            raise ValueError(
                f"swin geometry: input {H}x{W} must be a multiple of "
                f"patch*2^merges*window = {need * w} (grid halves "
                f"{len(self.cfg['depths']) - 1}x and each stage partitions into {w}x{w} "
                f"windows); the tower is defined at {self.image_size}px")
        x = self.patch_embed.norm(self.patch_embed.proj(x).permute(0, 2, 3, 1))
        idx = torch.from_numpy(_rel_index(w)).long().to(x.device)
        for stage in self.layers:
            x = stage.downsample(x)
            G = x.shape[1]
            mask = torch.from_numpy(_shift_mask(G, w, w // 2)).to(x.device) if G > w else None
            for block in stage.blocks:
                x = run_block(block, self.remat, x, idx, mask)
        B, G, _, C = x.shape
        return self.norm(x).reshape(B, G * G, C).mean(dim=1)


class SwinTower(nn.Module):
    """Trunk (classifier reset, average pool) + the adapter head."""

    def __init__(self, model_name: str, embed_dim: int, image_size: int = 224,
                 proj: str = "linear", remat: bool = False):
        super().__init__()
        cfg = SWIN_VARIANTS[model_name]
        self.trunk = Swin(cfg, image_size, remat)
        self.head = AdapterHead(cfg["embed"] * 2 ** (len(cfg["depths"]) - 1), embed_dim, proj)

    def forward(self, x, control=None, output_hiddens: bool = False,
                dtype: torch.dtype = torch.float32, train: bool = False, generator=None):
        _no_controller("Swin", control, output_hiddens)
        return self.head(self.trunk(x.to(dtype)))
