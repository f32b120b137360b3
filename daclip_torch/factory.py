"""Model factory: the open_clip-style construction API, in PyTorch.

Counterpart of `daclip_tpu/factory.py:56-228` (reference universal-image-
restoration/open_clip/factory.py:109-404), for the ViT CLIP and DaCLIP
configs (`models/clip.get_model_config`: the vendored open_clip JSONs and
the `test-tiny` config):
  * `create_model(name, pretrained=…)` builds `CLIP`, or `DaCLIP` when the
    name holds "daclip" (factory.py:191-192), from a seed; every half
    precision flavour runs in bfloat16; the `force_*` overrides edit the
    config first (factory.py:160-170);
  * `pretrained` is a local file or directory: a full DaCLIP `.pt` (the
    predictor kept only with `use_predictor`), a plain CLIP `.pt` copied
    into the controller as `initial_controller` does (factory.py:236-239),
    a JAX `.npz` params tree, or the port's DA-CLIP train dir; or a
    registry tag (`openai`, `laion2b_s34b_b79k`, …), downloaded into the
    cache by `models/pretrained.py` and loaded as a local file;
  * `create_model_and_transforms` adds the train and val image transforms
    (factory.py:312-360), normalised by the tag's mean and std where it has
    them and the caller gives none.

Not ported yet, refused with an error that names ROADMAP queue 1 item 6:
CoCa, and the ResNet, ConvNeXt, EVA, Swin, timm and HF-text towers (and
ViT layer scale).
"""
from __future__ import annotations

import random
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
_ITEM6 = "not ported yet (ROADMAP queue 1 item 6)"


def _refuse_unported(model_name: str, cfg: CLIPCfg) -> None:
    v = cfg.vision
    what = None
    if "coca" in model_name or v.attentional_pool or cfg.text.embed_cls:
        what = "CoCa"
    elif v.is_resnet:
        what = "the ModifiedResNet image tower"
    elif v.timm_model_name:
        what = f"the timm image tower {v.timm_model_name!r} (convnext, eva, swin, timm ViT)"
    elif cfg.text.hf_model_name:
        what = f"the HF text tower {cfg.text.hf_model_name!r}"
    elif v.ls_init_value is not None:
        what = "ViT layer scale (ls_init_value)"
    if what:
        raise NotImplementedError(f"{model_name}: {what} is {_ITEM6}")


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


def _load_state_dict(path: str, cfg: CLIPCfg):
    """A reference-named CLIP or DaCLIP state dict from a local file or the
    port's DA-CLIP train dir."""
    from daclip_torch.convert import clip_state_dict_from_jax, daclip_state_dict_from_jax
    from daclip_torch.utils import native_checkpoint as nc

    if nc.checkpoint_kind(path) == "npz":
        params = nc.load_params_npz(path)
        return (daclip_state_dict_from_jax(params) if "clip" in params
                else clip_state_dict_from_jax(params))
    return nc.load_daclip_any(path, cfg.vision.image_size, cfg.vision.patch_size)


def tag_cfg(model_name: str, pretrained: Optional[str]) -> dict:
    """The registry entry of a `pretrained` tag ({} for a local path or
    none): its url, hf_hub, mean and std."""
    if not pretrained or Path(str(pretrained)).exists():
        return {}
    return get_pretrained_cfg(model_name.replace("/", "-"), pretrained)


def create_model(model_name: str, pretrained: Optional[str] = None, precision: str = "fp32",
                 use_predictor: Optional[bool] = None, cache_dir: Optional[str] = None,
                 seed: int = 0, force_quick_gelu: bool = False,
                 force_patch_dropout: Optional[float] = None,
                 force_image_size: Optional[int] = None, remat: bool = False):
    """The model, its weights drawn from `seed` (torch's generator, forked
    so the caller's stream is untouched), then `pretrained` loaded (a tag's
    file downloaded into `cache_dir` first, `~/.cache/clip` by default); on
    the CPU, parameters float32, activations in the precision's dtype. There
    is no `force_custom_text`: without an HF text tower daclip_tpu's
    CustomTextCLIP computes what CLIP does, and the port's CLIP inlines its
    text tower either way."""
    model_name = model_name.replace("/", "-")
    is_daclip = "daclip" in model_name
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; supported: {sorted(PRECISIONS)}")
    model_dict = get_model_config(model_name)
    if force_quick_gelu:
        model_dict["quick_gelu"] = True
    if force_patch_dropout is not None:
        model_dict.setdefault("vision_cfg", {})["patch_dropout"] = force_patch_dropout
    if force_image_size is not None:
        model_dict.setdefault("vision_cfg", {})["image_size"] = force_image_size
    cfg = CLIPCfg.from_dict(model_dict)
    _refuse_unported(model_name, cfg)
    dtype = PRECISIONS[precision]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = (DaCLIP(cfg, dtype=dtype, use_predictor=bool(use_predictor), remat=remat)
                 if is_daclip else CLIP(cfg, dtype=dtype, remat=remat))
    if not pretrained:
        return model

    path = str(pretrained)
    if not Path(path).exists():
        url_cfg = get_pretrained_cfg(model_name, path)
        if not url_cfg:
            raise FileNotFoundError(f"pretrained {path!r} is neither a local file nor a "
                                    f"known tag for {model_name!r}")
        path = download_pretrained(url_cfg, cache_dir=cache_dir)
    sd = _load_state_dict(path, cfg)
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
                                force_patch_dropout: Optional[float] = None,
                                force_image_size: Optional[int] = None, remat: bool = False,
                                rng: Optional[random.Random] = None):
    """(model, preprocess_train, preprocess_val); the train transform draws
    from `rng` (the `random` module's stream when None). The transforms
    normalise by `image_mean` / `image_std`, else by the tag's, else by
    OpenAI's."""
    model = create_model(model_name, pretrained, precision, use_predictor, cache_dir,
                         seed=seed, force_quick_gelu=force_quick_gelu,
                         force_patch_dropout=force_patch_dropout,
                         force_image_size=force_image_size, remat=remat)
    size = model.cfg.vision.image_size
    tag = tag_cfg(model_name, pretrained)
    mean, std = image_mean or tag.get("mean"), image_std or tag.get("std")
    return (model, image_transform(size, is_train=True, mean=mean, std=std, rng=rng),
            image_transform(size, is_train=False, mean=mean, std=std))
