"""ModifiedResNet image tower, the OpenAI CLIP ResNet (RN50 family).

Counterpart of `daclip_tpu/models/resnet.py:22-146` (reference open_clip/
modified_resnet.py:10-181): a 3-conv stem and an average pool,
anti-aliased strided Bottlenecks (an average pool before the stride-1
convolution), and an AttentionPool2d head instead of average pooling. The
parameter names are open_clip's (`conv1`, `bn1`, `layer1.0.downsample.0`,
`attnpool.q_proj`, …), so a reference state dict loads strictly.

BatchNorm runs in inference mode, as daclip_tpu's does: its running
statistics are parameters there, so they are parameters here too (with the
reference's names, so the state dict is the same) and a step that does not
lock them moves them as daclip_tpu's does.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from daclip_torch.models.layers import Conv2d, Linear


class FrozenBatchNorm2d(nn.Module):
    """y = (x − mean)·weight/√(var + eps) + bias over NCHW, the affine
    terms computed in float32 and cast to x's dtype."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.running_mean = nn.Parameter(torch.zeros(channels))
        self.running_var = nn.Parameter(torch.ones(channels))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + self.eps)
        w = self.weight * inv
        b = self.bias - self.running_mean * w
        return x * w.to(x.dtype)[:, None, None] + b.to(x.dtype)[:, None, None]


def _avgpool(x, k: int):
    return F.avg_pool2d(x, k) if k > 1 else x


class Bottleneck(nn.Module):
    """modified_resnet.py:10-56."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        out = planes * self.expansion
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = Conv2d(planes, out, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(out)
        self.downsample = None
        if stride > 1 or inplanes != out:
            self.downsample = nn.Sequential()
            self.downsample.add_module("0", Conv2d(inplanes, out, 1, bias=False))
            self.downsample.add_module("1", FrozenBatchNorm2d(out))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(_avgpool(out, self.stride)))
        identity = x
        if self.downsample is not None:
            identity = self.downsample(_avgpool(x, self.stride))
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """modified_resnet.py:59-95: the mean token prepended, learned
    positions added, and the mean token's query attending over all."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int, output_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(
            torch.randn(spacial_dim ** 2 + 1, embed_dim) / embed_dim ** 0.5)
        self.k_proj = Linear(embed_dim, embed_dim)
        self.q_proj = Linear(embed_dim, embed_dim)
        self.v_proj = Linear(embed_dim, embed_dim)
        self.c_proj = Linear(embed_dim, output_dim)

    def forward(self, x):
        B, C = x.shape[:2]
        tokens = x.flatten(2).transpose(1, 2)                       # (B, n, C)
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding.to(x.dtype)
        H = self.num_heads
        hd = C // H
        q = self.q_proj(tokens[:, :1]).reshape(B, 1, H, hd)
        k = self.k_proj(tokens).reshape(B, -1, H, hd)
        v = self.v_proj(tokens).reshape(B, -1, H, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (hd ** -0.5)
        attn = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, C)
        return self.c_proj(out)


class ModifiedResNet(nn.Module):
    """modified_resnet.py:97-181 on NCHW images."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), output_dim: int = 1024,
                 heads: int = 32, image_size: int = 224, width: int = 64):
        super().__init__()
        self.conv1 = Conv2d(3, width // 2, 3, stride=2, padding=1, bias=False)
        self.bn1 = FrozenBatchNorm2d(width // 2)
        self.conv2 = Conv2d(width // 2, width // 2, 3, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm2d(width // 2)
        self.conv3 = Conv2d(width // 2, width, 3, padding=1, bias=False)
        self.bn3 = FrozenBatchNorm2d(width)
        inplanes = width
        for i, (mult, stride) in enumerate(((1, 1), (2, 2), (4, 2), (8, 2))):
            blocks = []
            for b in range(layers[i]):
                blocks.append(Bottleneck(inplanes, width * mult, stride if b == 0 else 1))
                inplanes = width * mult * Bottleneck.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.attnpool = AttentionPool2d(image_size // 32, width * 32, heads, output_dim)

    def forward(self, x, control=None, output_hiddens: bool = False,
                dtype: torch.dtype = torch.float32, train: bool = False, generator=None):
        if control is not None or output_hiddens:
            raise NotImplementedError(
                "ModifiedResNet does not support the DA-CLIP controller "
                "(control/output_hiddens); use a ViT vision tower")
        x = x.to(dtype)
        for i in (1, 2, 3):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        x = F.avg_pool2d(x, 2)
        for i in (1, 2, 3, 4):
            x = getattr(self, f"layer{i}")(x)
        return self.attnpool(x)
