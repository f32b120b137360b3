"""ConvNeXt image towers under open_clip's timm adapter, and the timm tower
factory.

Counterpart of `daclip_tpu/models/convnext.py:40-211` (the timm convnext
backbones the reference wraps, open_clip/timm_model.py:28-149). The vendored
convnext_* configs ask for `timm_pool: ""` and `timm_proj: linear|mlp`: the
trunk keeps timm's default head pooling (global average, then the head
LayerNorm) with the classifier removed, and the adapter projects to
embed_dim. Parameter names are timm's under the adapter (`trunk.stem.0`,
`trunk.stages.{s}.blocks.{b}.conv_dw`, `.mlp.fc1`, `.gamma`,
`trunk.head.norm`, `head.proj` or `head.mlp.fc{1,2}`), so a reference
state dict loads strictly.

Block (ConvNeXt, Liu et al. 2022, as timm): depthwise 7×7 → LayerNorm →
Linear 4·dim → GELU (erf) → Linear dim → layer-scale gamma → residual.
Stem: 4×4/4 conv + LayerNorm; stage transitions: LayerNorm + 2×2/2 conv.

`timm_drop` and `timm_drop_path` are not applied: daclip_tpu applies them
only when its caller passes a dropout or drop-path rng, and its trainer
never does.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from daclip_torch.models.layers import Conv2d, LayerNorm, Linear, run_block

# timm variant table: depths and dims of each convnext_* the configs name
VARIANTS = {
    "convnext_tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "convnext_small": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "convnext_base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
    "convnext_large": ((3, 3, 27, 3), (192, 384, 768, 1536)),
    "convnext_xlarge": ((3, 3, 27, 3), (256, 512, 1024, 2048)),
    "convnext_xxlarge": ((3, 4, 30, 3), (384, 768, 1536, 3072)),
}


class LayerNorm2d(LayerNorm):
    """LayerNorm over the channels of an NCHW map (timm LayerNorm2d)."""

    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class GeluMlp(nn.Module):
    """fc1 → GELU (erf) → fc2 (timm Mlp)."""

    def __init__(self, dim: int, hidden: int, out: Optional[int] = None, bias2: bool = True):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, out or dim, bias=bias2)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, ls_init: float = 1e-6):
        super().__init__()
        self.conv_dw = Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm(dim, eps=1e-6)
        self.mlp = GeluMlp(dim, 4 * dim)
        self.gamma = nn.Parameter(ls_init * torch.ones(dim))

    def forward(self, x):
        y = self.conv_dw(x).permute(0, 2, 3, 1)
        y = self.mlp(self.norm(y)) * self.gamma.to(x.dtype)
        return x + y.permute(0, 3, 1, 2)


class ConvNeXtStage(nn.Module):
    def __init__(self, in_dim: int, dim: int, depth: int, downsample: bool):
        super().__init__()
        self.downsample = nn.Identity()
        if downsample:
            self.downsample = nn.Sequential(LayerNorm2d(in_dim, eps=1e-6),
                                            Conv2d(in_dim, dim, 2, stride=2))
        self.blocks = nn.Sequential(*[ConvNeXtBlock(dim) for _ in range(depth)])


class _Head(nn.Module):
    """timm's NormMlpClassifierHead with the classifier reset: the norm."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(dim, eps=1e-6)


class ConvNeXt(nn.Module):
    """The trunk and timm's default head pooling (average, then LayerNorm)."""

    def __init__(self, depths: Sequence[int], dims: Sequence[int], remat: bool = False):
        super().__init__()
        self.remat = remat
        self.stem = nn.Sequential(Conv2d(3, dims[0], 4, stride=4), LayerNorm2d(dims[0], eps=1e-6))
        self.stages = nn.Sequential(*[ConvNeXtStage(dims[max(i - 1, 0)], dims[i], depths[i], i > 0)
                                      for i in range(len(depths))])
        self.head = _Head(dims[-1])

    def forward(self, x):
        x = self.stem(x)
        for stage in self.stages:
            x = stage.downsample(x)
            for block in stage.blocks:
                x = run_block(block, self.remat, x)
        return self.head.norm(x.mean(dim=(2, 3)))


class AdapterHead(nn.Module):
    """open_clip TimmModel's head (timm_model.py:85-105): `proj` (linear,
    no bias) or `mlp` (fc1 with bias → GELU → fc2 without), or nothing."""

    def __init__(self, in_dim: int, embed_dim: int, proj: str = "linear"):
        super().__init__()
        if proj == "linear":
            self.proj = Linear(in_dim, embed_dim, bias=False)
        elif proj == "mlp":
            self.mlp = GeluMlp(in_dim, 2 * embed_dim, embed_dim, bias2=False)
        elif proj:
            raise ValueError(f"unknown projection type {proj!r}")
        self.kind = proj

    def forward(self, x):
        if self.kind == "linear":
            return self.proj(x)
        if self.kind == "mlp":
            return self.mlp(x)
        return x


def _no_controller(name: str, control, output_hiddens: bool) -> None:
    if control is not None or output_hiddens:
        raise NotImplementedError(
            f"{name} towers have no transformer hiddens; the DA-CLIP controller "
            "requires the open_clip ViT vision tower")


class ConvNeXtTower(nn.Module):
    """The TimmModel-shaped tower: `trunk` → `head` to embed_dim."""

    def __init__(self, model_name: str, embed_dim: int, proj: str = "linear",
                 remat: bool = False):
        super().__init__()
        depths, dims = VARIANTS[model_name]
        self.trunk = ConvNeXt(depths, dims, remat)
        self.head = AdapterHead(dims[-1], embed_dim, proj)

    def forward(self, x, control=None, output_hiddens: bool = False,
                dtype: torch.dtype = torch.float32, train: bool = False, generator=None):
        _no_controller("ConvNeXt", control, output_hiddens)
        return self.head(self.trunk(x.to(dtype)))


def build_timm_tower(model_name: str, embed_dim: int, pool: str = "",
                     proj: Optional[str] = "linear", drop: float = 0.0,
                     drop_path: Optional[float] = None, image_size: int = 224,
                     remat: bool = False) -> nn.Module:
    """The tower of a config's `vision_cfg.timm_model_name`: convnext_*
    (this module), eva*/eva02_* (models/eva.py), swin_base_patch4_window7_224
    (models/swin.py), vit_medium_patch16_gap_256 and
    vit_relpos_medium_patch16_cls_224 (models/timm_vit.py); the pool and
    projection each family takes are daclip_tpu's (`convnext.py:148-211`),
    and so are the refusals."""
    if model_name in VARIANTS:
        if pool not in ("", "avg"):
            raise ValueError(
                f"pool={pool!r} not supported for native convnext towers "
                "(timm default avg pooling only; abs_attn/rot_attn are "
                "torch-only timm layers)")
        return ConvNeXtTower(model_name, embed_dim, proj or "", remat)
    from daclip_torch.models.eva import EVA_VARIANTS, EvaTower
    if model_name in EVA_VARIANTS:
        if pool != "token" or proj:
            raise ValueError(
                f"EVA towers implement timm_pool='token'/timm_proj=null as "
                f"the vendored configs request (got pool={pool!r}, "
                f"proj={proj!r})")
        return EvaTower(model_name, embed_dim, image_size, remat)
    from daclip_torch.models.swin import SWIN_VARIANTS, SwinTower
    if model_name in SWIN_VARIANTS:
        if pool not in ("", "avg"):
            raise ValueError(
                f"pool={pool!r} not supported for the native swin tower "
                "(network-default avg pooling only)")
        return SwinTower(model_name, embed_dim, image_size, proj or "", remat)
    from daclip_torch.models.timm_vit import TIMM_VIT_VARIANTS, TimmViTTower
    if model_name in TIMM_VIT_VARIANTS:
        if pool not in ("", "avg", "token"):
            raise ValueError(f"pool={pool!r} not supported for native timm-vit towers")
        if pool == "token" and not TIMM_VIT_VARIANTS[model_name]["class_token"]:
            raise ValueError(f"pool='token' requires a class token; {model_name} has none")
        if proj not in (None, "", "linear"):
            raise ValueError(
                f"proj={proj!r} not supported for native timm-vit towers "
                "(the vendored configs use proj='linear')")
        return TimmViTTower(model_name, embed_dim, image_size, pool, remat)
    raise ImportError(
        f"timm tower {model_name!r} requested: the natively implemented "
        "families are convnext_* (models/convnext.py), eva*/eva02_* "
        "(models/eva.py), swin_base_patch4_window7_224 (models/swin.py) and "
        "vit_{medium_patch16_gap_256,relpos_medium_patch16_cls_224} "
        "(models/timm_vit.py) — every family the vendored model configs "
        "name. Other timm backbones are torch-only; use a ViT config "
        "(models/clip.py registry) or contribute a backbone.")
