"""LiT-style tower locking (https://arxiv.org/abs/2111.07991) as 0/1 masks
over the trainable parameters' updates.

Counterpart of `daclip_tpu/train/locking.py:25-168` (reference open_clip/
transformer.py:444-476 VisionTransformer.lock, :600-618 TextTransformer.lock,
wired by training/main.py:261-269). A mask maps each trainable parameter's
name to 1.0 (trains) or 0.0 (locked). As in daclip_tpu, the mask multiplies
the optimizer's update after AdamW, so a locked parameter keeps its value
(weight decay included) while its gradient still counts in the global norm
and its Adam moments still move; `apply_update_mask` does this through each
parameter group's learning rate (`train/clip_train.make_optimizer` groups the
parameters by mask value).

Names are the port's: a ViT tower's `conv1.weight`, `class_embedding`,
`positional_embedding`, `ln_pre.*`, `transformer.resblocks.{i}.*`,
`ln_post.*`, `proj`; a timm tower's `trunk.*` and `head.*`; the text
tower's `transformer.resblocks.{i}.*`, `token_embedding.weight`,
`positional_embedding`, `ln_final.*`, `text_projection`, inlined at the top
of `CLIP` as in the reference or under CustomTextCLIP's `text.`.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch

# the plain CLIP's text tower, inlined at the model's top level
TEXT_PARAMS = ("transformer", "token_embedding", "positional_embedding", "ln_final",
               "text_projection")


def _layer(name: str) -> Optional[int]:
    parts = name.split(".")
    if parts[:2] == ["transformer", "resblocks"]:
        return int(parts[2])
    return None


def _n_layers(names: Iterable[str]) -> int:
    return 1 + max(i for i in map(_layer, names) if i is not None)


def _is_norm(name: str) -> bool:
    return any(p.startswith(("ln_", "norm")) for p in name.split("."))


# open_clip TimmModel's adapter head (timm_model.py:85-105): a timm tower's
# parameters outside `trunk`, which its lock leaves trainable
ADAPTER_HEAD = "head."


def vision_lock_mask(names: Iterable[str], unlocked_groups: int = 0) -> Dict[str, float]:
    """Mask over an image tower's parameter names. For the open_clip ViT,
    the reference's groups (transformer.py:448-462), unlocked from the END:
    [stem: conv1, class_embedding, positional_embedding, ln_pre],
    resblocks[0] … [L-2] one group each, [resblocks[L-1], ln_post], proj
    (and CoCa's attn_pool); `unlocked_groups=g` unlocks the last g.

    The other towers as daclip_tpu's mask (`locking.py:40-80`) and the
    reference lock them: ModifiedResNet locks everything
    (modified_resnet.py:154-159), a timm tower its `trunk` only, its
    adapter head (`head.proj`, `head.mlp.*`) training (timm_model.py:
    107-117; EVA's projection is in the trunk, so it locks whole); both
    refuse `unlocked_groups` > 0."""
    names = list(names)
    if not any(_layer(n) is not None for n in names):
        if unlocked_groups:
            raise ValueError(
                "lock_image_unlocked_groups > 0 is only supported for the "
                "open_clip ViT tower (reference parity: ModifiedResNet "
                "asserts 0, modified_resnet.py:155; TimmModel requires "
                "timm-master group_matcher, timm_model.py:118-125)")
        return {n: float(n.startswith(ADAPTER_HEAD)) for n in names}
    n_layers = _n_layers(names)
    n_groups = 1 + (n_layers - 1) + 1 + 1
    first_unlocked = n_groups - min(int(unlocked_groups), n_groups)
    proj_open = first_unlocked <= n_groups - 1
    last_open = first_unlocked <= n_groups - 2
    stem_open = first_unlocked == 0
    n_open_mid = max(0, (n_layers - 1) - max(first_unlocked - 1, 0))
    unlocked_layers = n_open_mid + (1 if last_open else 0)

    def value(name):
        top = name.split(".")[0]
        if top in ("conv1", "class_embedding", "positional_embedding", "ln_pre"):
            return stem_open
        if top == "ln_post":
            return last_open
        if top in ("proj", "attn_pool"):
            return proj_open
        layer = _layer(name)
        if layer is not None:
            return layer >= n_layers - unlocked_layers
        return False

    return {n: float(value(n)) for n in names}


def text_lock_mask(names: Iterable[str], unlocked_layers: int = 0,
                   freeze_layer_norm: bool = True) -> Dict[str, float]:
    """Mask over the text tower's parameter names. By default the whole
    tower locks, as the reference's CLIP.lock_text_tower does (model.py:
    219-225); `unlocked_layers=k` opens the last k blocks with ln_final and
    text_projection, and `freeze_layer_norm=False` keeps every LayerNorm
    trainable (the documented open_clip semantics, hf_model.py:157-186)."""
    names = list(names)
    n_layers = _n_layers(names)
    k = min(int(unlocked_layers), n_layers)

    def value(name):
        if not freeze_layer_norm and _is_norm(name):
            return True
        layer = _layer(name)
        if layer is not None:
            return layer >= n_layers - k
        if name.split(".")[0] in ("ln_final", "text_projection"):
            return k > 0
        return False

    return {n: float(value(n)) for n in names}


def build_update_mask(names: Iterable[str], lock_image: bool = False,
                      lock_image_unlocked_groups: int = 0, lock_text: bool = False,
                      lock_text_unlocked_layers: int = 0,
                      lock_text_freeze_layer_norm: bool = True) -> Optional[Dict[str, float]]:
    """The mask over every trainable parameter name (`visual.*` is the image
    tower, `TEXT_PARAMS` or `text.*` the text tower, anything else trains);
    None when nothing is locked (main.py:261-269)."""
    if not lock_image and not lock_text:
        return None
    names = list(names)
    mask = {n: 1.0 for n in names}
    visual = [n[len("visual."):] for n in names if n.startswith("visual.")]
    if lock_image and visual:
        for n, v in vision_lock_mask(visual, lock_image_unlocked_groups).items():
            mask[f"visual.{n}"] = v
    text = [n for n in names if n.split(".")[0] in TEXT_PARAMS]
    if lock_text and text:
        mask.update(text_lock_mask(text, lock_text_unlocked_layers,
                                   lock_text_freeze_layer_norm))
    custom = [n[len("text."):] for n in names if n.startswith("text.")]
    if lock_text and custom:
        for n, v in text_lock_mask(custom, lock_text_unlocked_layers,
                                   lock_text_freeze_layer_norm).items():
            mask[f"text.{n}"] = v
    return mask


def apply_update_mask(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Sets each parameter group's learning rate to `lr` times the group's
    mask value: AdamW's update of a parameter is lr·(Adam step + wd·p), so a
    0 mask leaves the parameter as it was, as daclip_tpu's masked update
    does."""
    for group in optimizer.param_groups:
        group["lr"] = lr * group.get("update_mask", 1.0)
