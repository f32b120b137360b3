"""Transformer stacks for the CLIP towers and the DA-CLIP controller.

Counterpart of `daclip_tpu/models/transformer.py` (open_clip/transformer.py).
The JAX package scans stacked (L, …) block parameters; here the blocks are an
`nn.ModuleList` named `resblocks`, as in the reference state dict.

`remat=True` recomputes each residual block's activations in the backward
pass (`torch.utils.checkpoint`, as the JAX towers' `nn.remat`;
`--grad-checkpointing`).

Control injection keeps the reference's `control.pop()` semantics exactly
(transformer.py:359-368): the main tower's block i adds the controller's
hidden from block L-1-i after the block. Do not "fix" the order — the
released DA-CLIP weights depend on it.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from daclip_torch.models.layers import MLP, LayerNorm, Linear, MultiheadAttention


class ResidualAttentionBlock(nn.Module):
    """Pre-LN block (open_clip/transformer.py:189-244)."""

    def __init__(self, width: int, heads: int, mlp_ratio: float = 4.0,
                 quick_gelu: bool = False):
        super().__init__()
        self.ln_1 = LayerNorm(width)
        self.attn = MultiheadAttention(width, heads)
        self.ln_2 = LayerNorm(width)
        self.mlp = MLP(width, int(width * mlp_ratio), quick=quick_gelu)

    def forward(self, x, mask=None):
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    """L residual blocks (open_clip/transformer.py:328-369).

    `control`: the controller's hiddens in controller block order; block i
    adds control[L-1-i] after itself."""

    def __init__(self, width: int, layers: int, heads: int, mlp_ratio: float = 4.0,
                 quick_gelu: bool = False, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.resblocks = nn.ModuleList(
            [ResidualAttentionBlock(width, heads, mlp_ratio, quick_gelu)
             for _ in range(layers)])

    def run_block(self, block, x, mask=None):
        """One block, recomputed in the backward pass when remat is on."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, x, mask, use_reentrant=False)
        return block(x, mask)

    def forward(self, x, mask=None, control: Optional[List[torch.Tensor]] = None):
        control = None if control is None else list(control)
        for block in self.resblocks:
            x = self.run_block(block, x, mask)
            if control is not None:
                x = x + control.pop().to(x.dtype)
        return x


def causal_mask(n: int, device=None) -> torch.Tensor:
    """Additive (n, n) float32 causal mask, -inf above the diagonal
    (open_clip/transformer.py:631-637)."""
    return torch.full((n, n), float("-inf"), device=device).triu(1)


class ControlTransformer(nn.Module):
    """The DA-CLIP controller's stack: the copied Transformer plus one
    zero-initialised Linear per block producing that block's hidden
    (open_clip/transformer.py:288-325)."""

    def __init__(self, transformer: Transformer, width: int):
        super().__init__()
        self.transformer = transformer
        self.zero_modules = nn.ModuleList(
            [Linear(width, width) for _ in transformer.resblocks])
        for m in self.zero_modules:
            nn.init.zeros_(m.weight)
            nn.init.zeros_(m.bias)

    def forward(self, x, mask=None):
        hiddens = []
        for block, zero in zip(self.transformer.resblocks, self.zero_modules):
            x = self.transformer.run_block(block, x, mask)
            hiddens.append(zero(x))
        return x, hiddens


class VisionTransformer(nn.Module):
    """CLIP ViT (open_clip/transformer.py:372-555) on NCHW images that are
    already normalised. `controller=True` wraps the stack in a
    ControlTransformer (daclip_model.py:22-23).

    `patch_dropout` > 0 (PatchDropout, arXiv 2212.00794; transformer.py:
    47-84): a forward with `train` keeps the CLS token and
    max(1, int(n·(1 − p))) of the n patch tokens after the positional add,
    the top-k of standard normal noise drawn by `patch_dropout_noise`."""

    def __init__(self, image_size: int = 224, patch_size: int = 32, width: int = 768,
                 layers: int = 12, heads: int = 12, mlp_ratio: float = 4.0,
                 output_dim: int = 512, quick_gelu: bool = False,
                 controller: bool = False, global_average_pool: bool = False,
                 patch_dropout: float = 0.0, remat: bool = False):
        super().__init__()
        self.patch_size = patch_size
        self.global_average_pool = global_average_pool
        self.patch_dropout = patch_dropout
        grid = image_size // patch_size
        scale = width ** -0.5
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(scale * torch.randn(width))
        self.positional_embedding = nn.Parameter(scale * torch.randn(grid * grid + 1, width))
        self.ln_pre = LayerNorm(width)
        transformer = Transformer(width, layers, heads, mlp_ratio, quick_gelu, remat)
        self.transformer = ControlTransformer(transformer, width) if controller else transformer
        self.ln_post = LayerNorm(width)
        self.proj = nn.Parameter(scale * torch.randn(width, output_dim))

    def patch_dropout_noise(self, shape, device, generator=None) -> torch.Tensor:
        """The (B, n) standard normal noise whose top-k picks the kept
        patches, from `generator` (the default stream when None)."""
        return torch.randn(shape, generator=generator, device=device)

    def forward(self, x, control=None, output_hiddens: bool = False,
                dtype: torch.dtype = torch.float32, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """x (B, 3, H, W) → pooled (B, output_dim); with `output_hiddens`
        (controller only) also the per-block hiddens. `train` turns patch
        dropout on, its noise drawn from `generator`."""
        B = x.shape[0]
        h = F.conv2d(x.to(dtype), self.conv1.weight.to(dtype), stride=self.patch_size)
        h = h.reshape(B, h.shape[1], -1).transpose(1, 2)
        cls = self.class_embedding.to(dtype).expand(B, 1, -1)
        h = torch.cat([cls, h], dim=1) + self.positional_embedding.to(dtype)
        if self.patch_dropout > 0.0 and train:
            rest = h[:, 1:]
            n_keep = max(1, int(rest.shape[1] * (1.0 - self.patch_dropout)))
            noise = self.patch_dropout_noise((B, rest.shape[1]), h.device, generator)
            keep = noise.topk(n_keep, dim=1).indices
            rest = torch.gather(rest, 1, keep[..., None].expand(-1, -1, rest.shape[2]))
            h = torch.cat([h[:, :1], rest], dim=1)
        h = self.ln_pre(h)
        hiddens = None
        if isinstance(self.transformer, ControlTransformer):
            h, hiddens = self.transformer(h)
        else:
            h = self.transformer(h, control=control)
        pooled = h.mean(dim=1) if self.global_average_pool else h[:, 0]
        pooled = self.ln_post(pooled) @ self.proj.to(dtype)
        if output_hiddens:
            return pooled, hiddens
        return pooled
