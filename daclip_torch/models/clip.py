"""CLIP and DaCLIP in PyTorch, the fork's degradation-level predictor, and
the model-config registry.

Counterpart of `daclip_tpu/models/clip.py` (open_clip model.py:187-264,
daclip_model.py:17-76; the predictor da-clip/src/open_clip/daclip_model.py:
17-169). Plain ViT image towers and the inlined CLIP text tower, under the
reference's parameter names (`transformer`, `token_embedding`,
`positional_embedding`, `ln_final`, `text_projection`), so a released
`daclip_ViT-B-32.pt` loads with `load_state_dict(strict=True)`.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import math
import pathlib
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from daclip_torch.models.layers import LayerNorm
from daclip_torch.models.transformer import Transformer, VisionTransformer, causal_mask


@dataclasses.dataclass(frozen=True)
class VisionCfg:
    image_size: int = 224
    patch_size: int = 32
    width: int = 768
    layers: Any = 12            # int → ViT depth; tuple → ModifiedResNet stages
    head_width: int = 64
    mlp_ratio: float = 4.0
    global_average_pool: bool = False
    attentional_pool: bool = False
    n_queries: int = 256
    attn_pooler_heads: int = 8
    output_tokens: bool = False
    patch_dropout: float = 0.0
    ls_init_value: Optional[float] = None
    timm_model_name: Optional[str] = None
    timm_model_pretrained: bool = False
    timm_pool: str = "avg"
    timm_proj: str = "linear"
    timm_drop: float = 0.0
    timm_drop_path: Optional[float] = None

    @property
    def is_resnet(self) -> bool:
        return isinstance(self.layers, (tuple, list))

    @property
    def heads(self) -> int:
        if self.is_resnet:
            return self.width * 32 // self.head_width
        return self.width // self.head_width


@dataclasses.dataclass(frozen=True)
class TextCfg:
    context_length: int = 77
    vocab_size: int = 49408
    width: int = 512
    heads: int = 8
    layers: int = 12
    mlp_ratio: float = 4.0
    embed_cls: bool = False
    pad_id: int = 0
    output_tokens: bool = False
    hf_model_name: Optional[str] = None
    hf_tokenizer_name: Optional[str] = None
    proj: str = "linear"
    pooler_type: str = "mean_pooler"


@dataclasses.dataclass(frozen=True)
class CLIPCfg:
    embed_dim: int = 512
    vision: VisionCfg = dataclasses.field(default_factory=VisionCfg)
    text: TextCfg = dataclasses.field(default_factory=TextCfg)
    quick_gelu: bool = False
    custom_text: bool = False

    @staticmethod
    def from_dict(d: Dict) -> "CLIPCfg":
        v = {k: v for k, v in d.get("vision_cfg", {}).items()
             if k in {f.name for f in dataclasses.fields(VisionCfg)}}
        t = {k: v for k, v in d.get("text_cfg", {}).items()
             if k in {f.name for f in dataclasses.fields(TextCfg)}}
        return CLIPCfg(embed_dim=d["embed_dim"], vision=VisionCfg(**v),
                       text=TextCfg(**t), quick_gelu=bool(d.get("quick_gelu", False)),
                       custom_text=bool(d.get("custom_text", False)))


# -- model config registry: the JAX package's literals (they take precedence),
# then the vendored open_clip JSONs, read by path ------------------------------
_TEXT_B = {"context_length": 77, "vocab_size": 49408, "width": 512, "heads": 8,
           "layers": 12}
_MODEL_CONFIGS: Dict[str, Dict] = {
    "ViT-B-32": {"embed_dim": 512,
                 "vision_cfg": {"image_size": 224, "layers": 12, "width": 768,
                                "patch_size": 32},
                 "text_cfg": dict(_TEXT_B)},
    "ViT-B-16": {"embed_dim": 512,
                 "vision_cfg": {"image_size": 224, "layers": 12, "width": 768,
                                "patch_size": 16},
                 "text_cfg": dict(_TEXT_B)},
    "ViT-L-14": {"embed_dim": 768,
                 "vision_cfg": {"image_size": 224, "layers": 24, "width": 1024,
                                "patch_size": 14},
                 "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 768,
                              "heads": 12, "layers": 12}},
    "RN50": {"embed_dim": 1024,
             "vision_cfg": {"image_size": 224, "layers": [3, 4, 6, 3], "width": 64},
             "text_cfg": dict(_TEXT_B)},
    "RN101": {"embed_dim": 512,
              "vision_cfg": {"image_size": 224, "layers": [3, 4, 23, 3], "width": 64},
              "text_cfg": dict(_TEXT_B)},
    "coca_ViT-B-32": {
        "embed_dim": 512,
        "vision_cfg": {"image_size": 224, "layers": 12, "width": 768, "patch_size": 32,
                       "attentional_pool": True, "attn_pooler_heads": 8,
                       "output_tokens": True},
        "text_cfg": {"context_length": 76, "vocab_size": 49408, "width": 512,
                     "heads": 8, "layers": 12, "embed_cls": True, "output_tokens": True},
        "multimodal_cfg": {"context_length": 76, "vocab_size": 49408, "width": 512,
                           "heads": 8, "layers": 12, "attn_pooler_heads": 8}},
    "coca_ViT-L-14": {
        "embed_dim": 768,
        "vision_cfg": {"image_size": 224, "layers": 24, "width": 1024, "patch_size": 14,
                       "attentional_pool": True, "attn_pooler_heads": 8,
                       "output_tokens": True},
        "text_cfg": {"context_length": 76, "vocab_size": 49408, "width": 768,
                     "heads": 12, "layers": 12, "embed_cls": True, "output_tokens": True},
        "multimodal_cfg": {"context_length": 76, "vocab_size": 49408, "width": 768,
                           "heads": 12, "layers": 12, "attn_pooler_heads": 12}},
    # tiny config for tests (not part of reference parity)
    "test-tiny": {"embed_dim": 32,
                  "vision_cfg": {"image_size": 32, "layers": 2, "width": 64,
                                 "patch_size": 16, "head_width": 32},
                  "text_cfg": {"context_length": 16, "vocab_size": 49408, "width": 32,
                               "heads": 2, "layers": 2}},
    "coca_test-tiny": {
        "embed_dim": 32,
        "vision_cfg": {"image_size": 32, "layers": 2, "width": 64, "patch_size": 16,
                       "head_width": 32, "attentional_pool": True,
                       "attn_pooler_heads": 4, "n_queries": 9, "output_tokens": True},
        "text_cfg": {"context_length": 15, "vocab_size": 49408, "width": 32,
                     "heads": 2, "layers": 2, "embed_cls": True, "output_tokens": True},
        "multimodal_cfg": {"context_length": 15, "vocab_size": 49408, "width": 32,
                           "heads": 2, "layers": 2}},
}
for _name in ["ViT-B-32", "ViT-B-16", "ViT-L-14", "test-tiny"]:
    _MODEL_CONFIGS[f"daclip_{_name}"] = _MODEL_CONFIGS[_name]

# the reference's open_clip/model_configs/*.json, vendored in the repo
ASSET_CONFIG_DIR = (pathlib.Path(__file__).resolve().parents[2]
                    / "daclip_tpu" / "assets" / "model_configs")


def _asset_configs() -> Dict[str, Dict]:
    if not ASSET_CONFIG_DIR.is_dir():
        return {}
    return {f.stem: json.loads(f.read_text())
            for f in sorted(ASSET_CONFIG_DIR.glob("*.json"))}


def list_models():
    return sorted(set(_MODEL_CONFIGS) | set(_asset_configs()))


def get_model_config(name: str) -> Dict:
    name = name.replace("/", "-")
    if name in _MODEL_CONFIGS:
        return copy.deepcopy(_MODEL_CONFIGS[name])
    assets = _asset_configs()
    if name not in assets:
        raise KeyError(f"unknown model {name!r}; available: {list_models()}")
    return assets[name]


def _check_vit(cfg: CLIPCfg) -> None:
    v = cfg.vision
    if v.is_resnet or v.timm_model_name or v.attentional_pool:
        raise NotImplementedError(
            "daclip_torch builds plain ViT towers only; ResNet, timm and CoCa "
            "towers are not ported yet")
    if cfg.text.embed_cls:
        raise NotImplementedError("CoCa's CLS text tower (embed_cls) is not ported yet")


def _normalize(x, normalize: bool):
    """x / ‖x‖ with the norm in float32, cast back to x's dtype."""
    if not normalize:
        return x
    return x / torch.linalg.vector_norm(x.float(), dim=-1, keepdim=True).to(x.dtype)


class CLIP(nn.Module):
    """Dual-tower CLIP with the reference's (model.py:187-264) parameter
    names; activations in `dtype`, parameters in float32; `remat`
    checkpoints every residual block of both towers."""

    def __init__(self, cfg: CLIPCfg, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        _check_vit(cfg)
        v, t = cfg.vision, cfg.text
        self.cfg = cfg
        self.dtype = dtype
        self.visual = VisionTransformer(
            image_size=v.image_size, patch_size=v.patch_size, width=v.width,
            layers=v.layers, heads=v.heads, mlp_ratio=v.mlp_ratio,
            output_dim=cfg.embed_dim, quick_gelu=cfg.quick_gelu,
            global_average_pool=v.global_average_pool, patch_dropout=v.patch_dropout,
            remat=remat)
        self.transformer = Transformer(t.width, t.layers, t.heads, t.mlp_ratio,
                                       cfg.quick_gelu, remat)
        self.token_embedding = nn.Embedding(t.vocab_size, t.width)
        self.positional_embedding = nn.Parameter(0.01 * torch.randn(t.context_length, t.width))
        self.ln_final = LayerNorm(t.width)
        self.text_projection = nn.Parameter(t.width ** -0.5 * torch.randn(t.width, cfg.embed_dim))
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def encode_image(self, image, normalize: bool = False, control=None, train: bool = False,
                     generator: Optional[torch.Generator] = None):
        """`train` turns the tower's patch dropout on (where the config has
        one), its noise drawn from `generator`."""
        return _normalize(self.visual(image, control=control, dtype=self.dtype, train=train,
                                      generator=generator), normalize)

    def encode_text(self, text, normalize: bool = False):
        """text (B, L) token ids → (B, embed_dim): causal stack, ln_final on
        every token, pooled at the EOT token (the highest id)."""
        text = text.long()
        L = text.shape[1]
        x = F.embedding(text, self.token_embedding.weight).to(self.dtype)
        x = x + self.positional_embedding[:L].to(self.dtype)
        x = self.ln_final(self.transformer(x, mask=causal_mask(L, x.device)))
        pooled = x[torch.arange(x.shape[0], device=x.device), text.argmax(dim=-1)]
        return _normalize(pooled @ self.text_projection.to(self.dtype), normalize)

    def forward(self, image=None, text=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        return {
            "image_features": (self.encode_image(image, normalize=True, train=train,
                                                 generator=generator)
                               if image is not None else None),
            "text_features": (self.encode_text(text, normalize=True)
                              if text is not None else None),
            "logit_scale": self.logit_scale.exp(),
        }


class MultiTypeDegradationPredictor(nn.Module):
    """The fork's degradation-level head (da-clip/src/open_clip/
    daclip_model.py:17-81), in float32: cosine similarity of the degradation
    feature to the 28 = 4 types × 7 bins level-prompt features, softmax at
    temperature 0.07, a Linear(7→14)-ReLU-Linear(14→7)-Tanh delta per type,
    and the expectation over the bin centers adjusted by 1 / (1 + delta)."""

    def __init__(self, num_bins: int = 7, num_types: int = 4, temperature: float = 0.07):
        super().__init__()
        self.num_bins, self.num_types, self.temperature = num_bins, num_types, temperature
        self.regressors = nn.ModuleList(
            [nn.Sequential(nn.Linear(num_bins, 2 * num_bins), nn.ReLU(),
                           nn.Linear(2 * num_bins, num_bins), nn.Tanh())
             for _ in range(num_types)])

    def forward(self, image_degra_features, all_d_type_tokens_features,
                bin_center_features):
        """(B, D) degradation features; (28, D) or (B, 28, D) prompt
        features; (4, 7) or (B, 4, 7) bin centers → (B, 4)."""
        B = image_degra_features.shape[0]
        nt, nb = self.num_types, self.num_bins
        f = image_degra_features.float()
        tokf = all_d_type_tokens_features.float()
        f = f / (torch.linalg.vector_norm(f, dim=-1, keepdim=True) + 1e-8)
        tokf = tokf / (torch.linalg.vector_norm(tokf, dim=-1, keepdim=True) + 1e-8)
        if tokf.ndim == 2:
            sim = torch.einsum("bd,kd->bk", f, tokf)
        else:
            sim = torch.einsum("bd,bkd->bk", f, tokf)
        probs = torch.softmax(sim / self.temperature, dim=-1).reshape(B, nt, nb)
        sim_t = sim.reshape(B, nt, nb)
        delta = torch.stack([reg(sim_t[:, i]) for i, reg in enumerate(self.regressors)],
                            dim=1)
        centers = torch.as_tensor(bin_center_features, dtype=torch.float32,
                                  device=f.device)
        adjusted = centers.expand(B, nt, nb) / (1.0 + delta)
        return (probs * adjusted).sum(dim=-1)


class DaCLIP(nn.Module):
    """Frozen CLIP plus the controller vision tower (daclip_model.py:17-76),
    and with `use_predictor` the fork's level predictor (da-clip/src/
    open_clip/daclip_model.py:83-169). `visual` is the same module as
    `clip.visual`, as in the reference; `remat` as CLIP's."""

    def __init__(self, cfg: CLIPCfg, dtype: torch.dtype = torch.float32,
                 use_predictor: bool = False, remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.clip = CLIP(cfg, dtype=dtype, remat=remat)
        self.visual = self.clip.visual
        v = cfg.vision
        self.visual_control = VisionTransformer(
            image_size=v.image_size, patch_size=v.patch_size, width=v.width,
            layers=v.layers, heads=v.heads, mlp_ratio=v.mlp_ratio,
            output_dim=cfg.embed_dim, quick_gelu=cfg.quick_gelu, controller=True,
            global_average_pool=v.global_average_pool, patch_dropout=v.patch_dropout,
            remat=remat)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))
        self.predictor = MultiTypeDegradationPredictor() if use_predictor else None

    def encode_image(self, image, control: bool = False, normalize: bool = False,
                     train: bool = False, generator: Optional[torch.Generator] = None):
        """image (B, 3, H, W), CLIP-normalised. With `control`, returns
        (image_features, degra_features): the controller runs first and its
        per-block hiddens enter the frozen tower in reversed block order.
        `train` turns patch dropout on in both towers, each drawing its own
        subset from `generator` (daclip_model.py:17-38)."""
        if control:
            degra, hiddens = self.visual_control(image, output_hiddens=True, dtype=self.dtype,
                                                 train=train, generator=generator)
            feats = self.clip.encode_image(image, normalize, control=hiddens, train=train,
                                           generator=generator)
            return feats, _normalize(degra, normalize)
        return self.clip.encode_image(image, normalize, train=train, generator=generator)

    def encode_text(self, text, normalize: bool = False):
        return self.clip.encode_text(text, normalize)

    def forward(self, image=None, text=None, gt_images=None, deg_type=None, gt_val=None,
                bin_center_bank=None, all_d_type_tokens=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """The training forward's outputs, without a loss
        (daclip_tpu/models/clip.py:424-467). `text` is caption‖degradation
        tokens, split in half along the token axis. With the predictor,
        `all_d_type_tokens` (28, L) or a constant (B, 28, L) bank is encoded
        once and `bin_center_bank` is (4, 7). `train` turns patch dropout on
        for the images and the GT images, drawn from `generator` in that
        order (controller, frozen tower, GT)."""
        out = {"logit_scale": self.logit_scale.exp()}
        if image is not None:
            out["image_features"], out["image_degra_features"] = self.encode_image(
                image, control=True, normalize=True, train=train, generator=generator)
        if text is not None:
            caption, degradation = text.chunk(2, dim=-1)
            out["text_features"] = self.encode_text(caption, normalize=True)
            out["text_degra_features"] = self.encode_text(degradation, normalize=True)
        if gt_images is not None:
            out["gt_image_features"] = self.encode_image(gt_images, normalize=True, train=train,
                                                         generator=generator)
        if self.predictor is not None and all_d_type_tokens is not None:
            toks = all_d_type_tokens
            if toks.ndim == 3:  # a constant (B, 28, L) bank: encode it once
                toks = toks[0]
            tok_f = self.encode_text(toks, normalize=True)
            out["all_d_type_tokens_features"] = tok_f
            out["bin_center_features"] = bin_center_bank
            out["pred"] = self.predictor(out["image_degra_features"], tok_f,
                                         bin_center_bank)
            out["deg_type"] = deg_type
            out["gt_val"] = gt_val
        return out
