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

from daclip_torch.models.layers import MLP, LayerNorm, Linear, MultiheadAttention, run_block


class LayerScale(nn.Module):
    """Per-channel scale of a residual branch, `gamma` initialised to
    `init` (open_clip transformer.py:36-44)."""

    def __init__(self, width: int, init: float):
        super().__init__()
        self.gamma = nn.Parameter(init * torch.ones(width))

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN block (open_clip/transformer.py:189-244); `ls_init_value`
    adds LayerScale to both branches (`ls_1`, `ls_2`). With `cross` the
    attention reads its keys and values from a second input through
    `ln_1_kv` (the CoCa decoder's cross-attention block), or takes them
    already projected (`MultiheadAttention.project_kv`)."""

    def __init__(self, width: int, heads: int, mlp_ratio: float = 4.0,
                 quick_gelu: bool = False, ls_init_value: Optional[float] = None,
                 cross: bool = False):
        super().__init__()
        self.ln_1 = LayerNorm(width)
        self.attn = MultiheadAttention(width, heads)
        if cross:
            self.ln_1_kv = LayerNorm(width)
        self.ln_2 = LayerNorm(width)
        self.mlp = MLP(width, int(width * mlp_ratio), quick=quick_gelu)
        if ls_init_value is not None:
            self.ls_1 = LayerScale(width, ls_init_value)
            self.ls_2 = LayerScale(width, ls_init_value)
        else:
            self.ls_1 = self.ls_2 = nn.Identity()

    def forward(self, x, mask=None, kv=None):
        if kv is None:
            x = x + self.ls_1(self.attn(self.ln_1(x), mask))
        else:
            kv = kv if isinstance(kv, tuple) else self.ln_1_kv(kv)
            x = x + self.ls_1(self.attn(self.ln_1(x), mask, kv=kv))
        return x + self.ls_2(self.mlp(self.ln_2(x)))


class Transformer(nn.Module):
    """L residual blocks (open_clip/transformer.py:328-369).

    `control`: the controller's hiddens in controller block order; block i
    adds control[L-1-i] after itself. `output_hiddens` also returns each
    block's output before that addition (transformer.py:365-366)."""

    def __init__(self, width: int, layers: int, heads: int, mlp_ratio: float = 4.0,
                 quick_gelu: bool = False, remat: bool = False,
                 ls_init_value: Optional[float] = None):
        super().__init__()
        self.remat = remat
        self.resblocks = nn.ModuleList(
            [ResidualAttentionBlock(width, heads, mlp_ratio, quick_gelu, ls_init_value)
             for _ in range(layers)])

    def run_block(self, block, x, mask=None):
        """One block, recomputed in the backward pass when remat is on."""
        return run_block(block, self.remat, x, mask)

    def forward(self, x, mask=None, control: Optional[List[torch.Tensor]] = None,
                output_hiddens: bool = False):
        control = None if control is None else list(control)
        hiddens = []
        for block in self.resblocks:
            x = self.run_block(block, x, mask)
            if output_hiddens:
                hiddens.append(x)
            if control is not None:
                x = x + control.pop().to(x.dtype)
        return (x, hiddens) if output_hiddens else x


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


class AttentionalPooler(nn.Module):
    """`n_queries` learned queries attending over the encoder's tokens
    (open_clip/transformer.py:163-186; JAX `transformer.py:126-146`): the
    CoCa image tower's pooling, from `context_dim`-wide tokens to
    `d_model`."""

    def __init__(self, d_model: int, context_dim: int, heads: int = 8, n_queries: int = 256):
        super().__init__()
        self.query = nn.Parameter(torch.randn(n_queries, d_model))
        self.attn = MultiheadAttention(d_model, heads, kdim=context_dim, vdim=context_dim)
        self.ln_q = LayerNorm(d_model)
        self.ln_k = LayerNorm(context_dim)

    def forward(self, x):
        k = self.ln_k(x)
        q = self.ln_q(self.query.to(x.dtype)).expand(x.shape[0], -1, -1)
        return self.attn(q, kv=k)


class VisionTransformer(nn.Module):
    """CLIP ViT (open_clip/transformer.py:372-555) on NCHW images that are
    already normalised. `controller=True` wraps the stack in a
    ControlTransformer (daclip_model.py:22-23); `ls_init_value` gives every
    block LayerScale (ViT-M-16-alt).

    `patch_dropout` > 0 (PatchDropout, arXiv 2212.00794; transformer.py:
    47-84): a forward with `train` keeps the CLS token and
    max(1, int(n·(1 − p))) of the n patch tokens after the positional add,
    the top-k of standard normal noise drawn by `patch_dropout_noise`.

    `attentional_pool` (CoCa; transformer.py:434-437, 540-543) pools the
    tokens to `n_queries` through an AttentionalPooler, ln_post runs over
    all of them and the first is the contrastive latent; `output_tokens`
    returns (pooled, tokens)."""

    def __init__(self, image_size: int = 224, patch_size: int = 32, width: int = 768,
                 layers: int = 12, heads: int = 12, mlp_ratio: float = 4.0,
                 output_dim: int = 512, quick_gelu: bool = False,
                 controller: bool = False, global_average_pool: bool = False,
                 patch_dropout: float = 0.0, remat: bool = False,
                 ls_init_value: Optional[float] = None, attentional_pool: bool = False,
                 n_queries: int = 256, attn_pooler_heads: int = 8,
                 output_tokens: bool = False):
        super().__init__()
        self.patch_size = patch_size
        self.global_average_pool = global_average_pool
        self.patch_dropout = patch_dropout
        self.output_tokens = output_tokens
        grid = image_size // patch_size
        scale = width ** -0.5
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(scale * torch.randn(width))
        self.positional_embedding = nn.Parameter(scale * torch.randn(grid * grid + 1, width))
        self.ln_pre = LayerNorm(width)
        transformer = Transformer(width, layers, heads, mlp_ratio, quick_gelu, remat,
                                  ls_init_value)
        self.transformer = ControlTransformer(transformer, width) if controller else transformer
        if attentional_pool:
            self.attn_pool = AttentionalPooler(output_dim, width, attn_pooler_heads, n_queries)
            self.ln_post = LayerNorm(output_dim)
            self.proj = nn.Parameter(scale * torch.randn(output_dim, output_dim))
        else:
            self.attn_pool = None
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
        also the per-block hiddens (a controller's zero-module outputs, else
        each block's output), with `output_tokens`
        the tokens. `train` turns patch dropout on, its noise drawn from
        `generator`."""
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
        elif output_hiddens:
            h, hiddens = self.transformer(h, control=control, output_hiddens=True)
        else:
            h = self.transformer(h, control=control)
        if self.attn_pool is not None:
            h = self.ln_post(self.attn_pool(h))
            pooled, tokens = h[:, 0], h[:, 1:]
        else:
            if self.global_average_pool:
                pooled, tokens = h.mean(dim=1), h
            else:
                pooled, tokens = h[:, 0], h[:, 1:]
            pooled = self.ln_post(pooled)
        pooled = pooled @ self.proj.to(dtype)
        if self.output_tokens:
            return pooled, tokens
        if output_hiddens:
            return pooled, hiddens
        return pooled


def cls_mask(text, pad_id: int) -> torch.Tensor:
    """(B, 1, L+1, L+1) additive mask: 0 everywhere but the CLS row, where
    the padding keys (shifted right by one) are -inf."""
    B, L = text.shape
    keys_open = torch.cat([torch.ones(B, 1, dtype=torch.bool, device=text.device),
                           text != pad_id], dim=1)[:, :L + 1]
    full = torch.zeros(B, L + 1, L + 1, device=text.device)
    full[:, -1, :] = torch.where(keys_open, 0.0, float("-inf"))
    return full[:, None]


def encode_tokens(m: nn.Module, text, dtype: torch.dtype, cls_pad_id: Optional[int] = None):
    """The text stack of a module that holds open_clip's text parameters
    (`token_embedding`, `positional_embedding`, `transformer`, `ln_final`,
    `text_projection`; `cls_emb` for CoCa): (pooled @ text_projection,
    tokens). With `cls_pad_id` the CLS embedding is appended and pooled
    (CoCa, its padding id masked for the CLS query); else the EOT token."""
    text = text.long()
    B, L = text.shape
    x = F.embedding(text, m.token_embedding.weight).to(dtype)
    if cls_pad_id is not None:
        x = torch.cat([x, m.cls_emb.to(dtype).expand(B, 1, -1)], dim=1)
        mask = causal_mask(L + 1, x.device)[None, None] + cls_mask(text, cls_pad_id)
    else:
        mask = causal_mask(L, x.device)
    x = m.transformer(x + m.positional_embedding[:x.shape[1]].to(dtype), mask=mask)
    if cls_pad_id is not None:
        pooled, tokens = m.ln_final(x[:, -1]), x[:, :-1]
    else:
        x = m.ln_final(x)
        pooled, tokens = x[torch.arange(B, device=x.device), text.argmax(dim=-1)], x
    return pooled @ m.text_projection.to(dtype), tokens


class TextTransformer(nn.Module):
    """The CLIP text tower as a module of its own (open_clip/transformer.py:
    558-683; JAX `transformer.py:322-401`): the `text.` subtree of
    CustomTextCLIP and CoCa.

    `embed_cls` (CoCa) appends a learned CLS embedding (num_pos =
    context_length + 1); only the CLS query masks the padding keys
    (build_cls_mask, transformer.py:641-648, its quirks kept: key column 0
    open, the `text != pad` row shifted right by one), the CLS position is
    pooled, and ln_final runs on it alone while the returned tokens stay
    un-normalised. Otherwise ln_final runs on every token and the EOT
    token (the highest id) is pooled."""

    def __init__(self, context_length: int = 77, vocab_size: int = 49408, width: int = 512,
                 heads: int = 8, layers: int = 12, mlp_ratio: float = 4.0,
                 output_dim: int = 512, quick_gelu: bool = False, embed_cls: bool = False,
                 pad_id: int = 0, output_tokens: bool = False, remat: bool = False):
        super().__init__()
        self.embed_cls, self.pad_id, self.output_tokens = embed_cls, pad_id, output_tokens
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(
            0.01 * torch.randn(context_length + int(embed_cls), width))
        if embed_cls:
            self.cls_emb = nn.Parameter(0.01 * torch.randn(width))
        self.transformer = Transformer(width, layers, heads, mlp_ratio, quick_gelu, remat)
        self.ln_final = LayerNorm(width)
        self.text_projection = nn.Parameter(width ** -0.5 * torch.randn(width, output_dim))

    def forward(self, text, embed_cls: Optional[bool] = None,
                dtype: torch.dtype = torch.float32):
        use_cls = self.embed_cls if embed_cls is None else embed_cls
        pooled, tokens = encode_tokens(self, text, dtype, self.pad_id if use_cls else None)
        if self.output_tokens:
            return pooled, tokens
        return pooled
