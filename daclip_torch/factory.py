"""Model factory: the open_clip-style construction API, in PyTorch.

Counterpart of `daclip_tpu/factory.py:56-228` (reference universal-image-
restoration/open_clip/factory.py:109-404), for the ViT CLIP and DaCLIP
configs (`models/clip.get_model_config`: the vendored open_clip JSONs and
the `test-tiny` config), every image tower they name included:
  * `create_model(name, pretrained=…)` builds `CLIP` (its text tower as
    CustomTextCLIP's `text.` module for a `custom_text` config or
    `force_custom_text`, factory.py:183-194), `DaCLIP` when the name holds
    "daclip" (factory.py:191-192), or `CoCa` when it holds "coca"
    (factory.py:186-190), from a seed; every half
    precision flavour runs in bfloat16; the `force_*` overrides edit the
    config first (factory.py:160-170);
  * `pretrained` is a local file or directory: a full DaCLIP `.pt` (the
    predictor kept only with `use_predictor`), a plain CLIP `.pt` copied
    into the controller as `initial_controller` does (factory.py:236-239),
    a JAX `.npz` params tree or orbax train dir (`cli/train_daclip`'s, a
    DaCLIP's or a plain CLIP's), or the port's DA-CLIP train dir; or a
    registry tag (`openai`, `laion2b_s34b_b79k`, …), downloaded into the
    cache by `models/pretrained.py` and loaded as a local file;
  * `create_model_and_transforms` adds the train and val image transforms
    (factory.py:312-360), normalised by the tag's mean and std where it has
    them and the caller gives none.

Refused as daclip_tpu refuses: an HF text tower in a config (compose
`models/hf_text.HFTextTower` instead), a timm backbone no vendored config
names, a pool or projection its family does not take.
"""
from __future__ import annotations

import random
from functools import partial
from pathlib import Path
from typing import Optional

import torch

from daclip_torch.models.clip import CLIP, CLIPCfg, DaCLIP, get_model_config
from daclip_torch.models.pretrained import download_pretrained, get_pretrained_cfg
from daclip_torch.transforms import image_transform

PRECISIONS = {"fp32": torch.float32, "amp": torch.bfloat16, "amp_bf16": torch.bfloat16,
              "amp_bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
              "pure_bf16": torch.bfloat16, "fp16": torch.bfloat16,
              "pure_fp16": torch.bfloat16}

def initial_controller(model: DaCLIP) -> None:
    """Copy the CLIP image tower into the controller, its zero modules left
    at zero, and the CLIP's logit_scale into DaCLIP's (daclip_model.py:
    26-34), in place."""
    ctrl = dict(model.visual_control.named_parameters())
    with torch.no_grad():
        for name, p in model.clip.visual.named_parameters():
            if name.startswith("transformer."):
                name = "transformer." + name
            ctrl[name].copy_(p)
        for zero in model.visual_control.transformer.zero_modules.parameters():
            zero.zero_()
        model.logit_scale.copy_(model.clip.logit_scale)


def _load_state_dict(path: str, cfg: CLIPCfg, custom_text: bool = False):
    """A reference-named CLIP or DaCLIP state dict from a local file, an
    orbax train dir of daclip_tpu's or the port's DA-CLIP train dir; a ViT's
    position embedding resized to the config's grid (`patch_size` is None
    for the other towers, JAX factory.py:599)."""
    from daclip_torch.convert import clip_state_dict_from_jax, daclip_state_dict_from_jax
    from daclip_torch.utils import native_checkpoint as nc

    if nc.is_native_checkpoint(path):
        params = nc.load_jax_params(path)
        return (daclip_state_dict_from_jax(params) if "clip" in params
                else clip_state_dict_from_jax(params, custom_text=custom_text))
    v = cfg.vision
    vit = not (v.is_resnet or v.timm_model_name)
    return nc.load_daclip_any(path, v.image_size, v.patch_size if vit else None)


def _resolve(model_name: str, pretrained: str, cache_dir: Optional[str]) -> str:
    """A local path as it is; a registry tag downloaded into the cache."""
    path = str(pretrained)
    if Path(path).exists():
        return path
    url_cfg = get_pretrained_cfg(model_name, path)
    if not url_cfg:
        raise FileNotFoundError(f"pretrained {path!r} is neither a local file nor a "
                                f"known tag for {model_name!r}")
    return download_pretrained(url_cfg, cache_dir=cache_dir)


def _create_coca(model_name: str, pretrained: Optional[str], dtype, cache_dir, seed: int,
                 remat: bool):
    """CoCa from its config (JAX factory.py:634-657): the force_* overrides
    do not apply, and `pretrained` is a reference CoCa state dict."""
    from daclip_torch.convert import load_torch_state_dict
    from daclip_torch.models.coca import CoCa, CoCaCfg

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = CoCa(CoCaCfg.from_dict(get_model_config(model_name)), dtype=dtype, remat=remat)
    if pretrained:
        model.load_state_dict(load_torch_state_dict(_resolve(model_name, pretrained, cache_dir)),
                              strict=True)
    return model


def tag_cfg(model_name: str, pretrained: Optional[str]) -> dict:
    """The registry entry of a `pretrained` tag ({} for a local path or
    none): its url, hf_hub, mean and std."""
    if not pretrained or Path(str(pretrained)).exists():
        return {}
    return get_pretrained_cfg(model_name.replace("/", "-"), pretrained)


def create_model(model_name: str, pretrained: Optional[str] = None, precision: str = "fp32",
                 use_predictor: Optional[bool] = None, cache_dir: Optional[str] = None,
                 seed: int = 0, force_quick_gelu: bool = False,
                 force_custom_text: bool = False,
                 force_patch_dropout: Optional[float] = None,
                 force_image_size: Optional[int] = None, remat: bool = False):
    """The model, its weights drawn from `seed` (torch's generator, forked
    so the caller's stream is untouched), then `pretrained` loaded (a tag's
    file downloaded into `cache_dir` first, `~/.cache/clip` by default); on
    the CPU, parameters float32, activations in the precision's dtype."""
    model_name = model_name.replace("/", "-")
    is_daclip = "daclip" in model_name
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; supported: {sorted(PRECISIONS)}")
    dtype = PRECISIONS[precision]
    if "coca" in model_name:
        return _create_coca(model_name, pretrained, dtype, cache_dir, seed, remat)
    model_dict = get_model_config(model_name)
    if force_quick_gelu:
        model_dict["quick_gelu"] = True
    if force_patch_dropout is not None:
        model_dict.setdefault("vision_cfg", {})["patch_dropout"] = force_patch_dropout
    if force_image_size is not None:
        model_dict.setdefault("vision_cfg", {})["image_size"] = force_image_size
    cfg = CLIPCfg.from_dict(model_dict)
    custom_text = (cfg.custom_text or force_custom_text
                   or bool(cfg.text.hf_model_name)) and not is_daclip
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = (DaCLIP(cfg, dtype=dtype, use_predictor=bool(use_predictor), remat=remat)
                 if is_daclip else CLIP(cfg, dtype=dtype, remat=remat, custom_text=custom_text))
    if not pretrained:
        return model

    sd = _load_state_dict(_resolve(model_name, pretrained, cache_dir), cfg, custom_text)
    if is_daclip and any(k.startswith("visual_control.") for k in sd):
        if not use_predictor:
            sd = {k: v for k, v in sd.items() if not k.startswith("predictor.")}
        missing, unexpected = model.load_state_dict(sd, strict=False)
        # a checkpoint without the predictor keeps the seeded one
        if unexpected or any(not k.startswith("predictor.") for k in missing):
            raise RuntimeError(f"{pretrained}: missing {missing}, unexpected {unexpected}")
    elif is_daclip:
        model.clip.load_state_dict(sd, strict=True)
        initial_controller(model)
    else:
        if any(k.startswith("clip.") for k in sd):  # a DaCLIP's frozen CLIP
            sd = {k[len("clip."):]: v for k, v in sd.items() if k.startswith("clip.")}
        model.load_state_dict(sd, strict=True)
    return model


def create_model_and_transforms(model_name: str, pretrained: Optional[str] = None,
                                precision: str = "fp32", use_predictor: Optional[bool] = None,
                                cache_dir: Optional[str] = None, image_mean=None,
                                image_std=None, seed: int = 0, force_quick_gelu: bool = False,
                                force_custom_text: bool = False,
                                force_patch_dropout: Optional[float] = None,
                                force_image_size: Optional[int] = None, remat: bool = False,
                                rng: Optional[random.Random] = None):
    """(model, preprocess_train, preprocess_val); the train transform draws
    from `rng` (the `random` module's stream when None). The transforms
    normalise by `image_mean` / `image_std`, else by the tag's, else by
    OpenAI's."""
    model = create_model(model_name, pretrained, precision, use_predictor, cache_dir,
                         seed=seed, force_quick_gelu=force_quick_gelu,
                         force_custom_text=force_custom_text,
                         force_patch_dropout=force_patch_dropout,
                         force_image_size=force_image_size, remat=remat)
    size = model.cfg.vision.image_size
    tag = tag_cfg(model_name, pretrained)
    mean, std = image_mean or tag.get("mean"), image_std or tag.get("std")
    return (model, image_transform(size, is_train=True, mean=mean, std=std, rng=rng),
            image_transform(size, is_train=False, mean=mean, std=std))


def create_model_from_pretrained(model_name: str, pretrained: str, precision: str = "fp32",
                                 use_predictor: Optional[bool] = None,
                                 cache_dir: Optional[str] = None, image_mean=None,
                                 image_std=None, seed: int = 0):
    """(model, preprocess_val): `create_model_and_transforms` without the
    train transform (JAX factory.py:229-242; reference factory.py:363-404)."""
    model, _, pp_val = create_model_and_transforms(
        model_name, pretrained, precision, use_predictor, cache_dir, image_mean, image_std,
        seed=seed)
    return model, pp_val


def get_tokenizer(model_name: str = ""):
    """The byte-BPE tokenizer at the model's context length (JAX
    factory.py:245-256). A CoCa text tower takes context_length + 1 tokens:
    one is traded for the appended CLS (coca_model.py:143, `text[:, :-1]`)."""
    from daclip_torch.tokenizer import tokenize

    if not model_name:
        return tokenize
    cfg = CLIPCfg.from_dict(get_model_config(model_name))
    return partial(tokenize, context_length=cfg.text.context_length
                   + (1 if "coca" in model_name else 0))


def create_loss(args):
    """The loss of a run's flags (JAX factory.py:258-282; reference
    factory.py:272-309): distillation, CoCa's (a weighted contrastive term
    and the caption cross-entropy), the fork's DA-CLIP loss under `--da`,
    the original DA-CLIP loss for a daclip model, else the contrastive
    loss."""
    import importlib

    # losses/__init__ re-exports the clip_loss function under the module's name
    L = importlib.import_module("daclip_torch.losses.clip_loss")

    if getattr(args, "distill", False):
        return L.distill_clip_loss
    if "coca" in str(getattr(args, "model", "")).lower():
        return partial(L.coca_loss,
                       caption_loss_weight=getattr(args, "coca_caption_loss_weight", 2.0),
                       clip_loss_weight=getattr(args, "coca_contrastive_loss_weight", 1.0))
    if getattr(args, "da", False):
        return L.daclip_loss_fork
    if "daclip" in str(getattr(args, "model", "")).lower():
        return L.daclip_loss_uir
    return lambda out, output_dict=True: (
        {"contrastive_loss": L.clip_loss(out["image_features"], out["text_features"],
                                         out["logit_scale"])}
        if output_dict else
        L.clip_loss(out["image_features"], out["text_features"], out["logit_scale"]))
