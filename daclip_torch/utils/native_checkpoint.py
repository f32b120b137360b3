"""The JAX package's flat `.npz` params format, read into reference-named
state dicts.

Counterpart of `daclip_tpu/utils/native_checkpoint.py` (`checkpoint_kind`
:45, `save_params_npz` :128, `load_params_npz` :144,
`infer_unet_arch_from_params` :161, `load_unet_any` :188, `load_daclip_any`
:204). An `.npz` holds a flax params tree flattened with '/'-joined keys;
`save_params_npz` is the bridge from a JAX train dir. The trees are the JAX
modules' own: the UNet's as `unet_state_dict_from_jax` reads it, DaCLIP's
with its transformer blocks stacked (L, …) along the first axis as
`daclip_state_dict_from_jax` reads them. The port's own restoration train
dir (the `<step>.pt` files of `utils/checkpoint.py`) loads as a UNet, and
its DA-CLIP train dir (the `epoch_<n>.pt` files) as a DA-CLIP, as the JAX
package loads its orbax train dirs. Orbax train dirs are refused:
`orbax.checkpoint` imports jax.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from daclip_torch.convert import (daclip_state_dict_from_jax, infer_unet_arch,
                                  load_torch_state_dict, resize_pos_embed,
                                  unet_state_dict_from_jax)
from daclip_torch.utils import checkpoint as train_checkpoint

_ORBAX = ("orbax train dirs are not ported (orbax.checkpoint imports jax); "
          "write the params with daclip_tpu's save_params_npz and pass the .npz")


def _has_orbax_step_dirs(path: str) -> bool:
    if not os.path.isdir(path):
        return False
    return any(e.isdigit() and os.path.isdir(os.path.join(path, e))
               for e in os.listdir(path))


def checkpoint_kind(path: str) -> str:
    """'orbax' (a train dir with numeric step subdirs), 'orbax_step' (one
    step dir), 'train_dir' (the port's `<step>.pt` files), 'clip_train_dir'
    (its `epoch_<n>.pt` files), 'npz', or 'torch'."""
    if _has_orbax_step_dirs(path):
        return "orbax"
    if os.path.isdir(path):
        if os.path.basename(os.path.normpath(path)).isdigit():
            return "orbax_step"
        if train_checkpoint.steps(path):
            return "train_dir"
        if train_checkpoint.steps(path, train_checkpoint.EPOCH):
            return "clip_train_dir"
        raise FileNotFoundError(
            f"{path!r} is a directory but contains no orbax step checkpoints")
    if str(path).endswith(".npz"):
        return "npz"
    return "torch"


def save_params_npz(path: str, params: Any) -> str:
    """Flatten a params tree (nested dicts of arrays) to one .npz with
    '/'-joined keys."""
    flat = {}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(f"{prefix}/{k}" if prefix else str(k), v)
        else:
            flat[prefix] = np.asarray(node)

    rec("", params)
    np.savez(path, **flat)
    return path


def load_params_npz(path: str) -> Dict:
    out: Dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return out


def infer_unet_arch_from_params(p: Dict) -> Dict:
    """ConditionalUNet constructor arguments read off its flax params tree."""
    ic = np.asarray(p["init_conv"]["kernel"])          # (7, 7, 2·in_nc, nf)
    nf, in_nc = int(ic.shape[-1]), int(ic.shape[2]) // 2
    depth = len([k for k in p if k.startswith("down") and k.endswith("_block1")])
    ch_mult = [int(np.asarray(p[f"down{i}_downsample"]["kernel"]).shape[-1]) // nf
               for i in range(depth)]
    use_degra = "prompt" in p
    context_dim = (int(np.asarray(p["text_mlp_1"]["kernel"]).shape[0])
                   if use_degra else None)
    spatial_levels = [i for i in range(depth) if "proj_in" in p[f"down{i}_attn"]["fn"]]
    use_image = bool(spatial_levels) or "proj_in" in p["mid_attn"]["fn"]
    if use_image and context_dim is None:
        src = p[f"down{spatial_levels[0]}_attn"] if spatial_levels else p["mid_attn"]
        context_dim = int(np.asarray(
            src["fn"]["block0"]["attn2"]["to_k"]["kernel"]).shape[0])
    return {
        "in_nc": in_nc,
        "out_nc": int(np.asarray(p["final_conv"]["kernel"]).shape[-1]),
        "nf": nf, "ch_mult": tuple(ch_mult), "context_dim": context_dim,
        "use_degra_context": use_degra, "use_image_context": use_image,
        "scale": 0.5 if "pre_down" in p else 1.0,
        "spatial_attn_min_level": spatial_levels[0] if spatial_levels else 3,
    }


def _refuse_orbax(path: str) -> str:
    kind = checkpoint_kind(path)
    if kind in ("orbax", "orbax_step"):
        raise NotImplementedError(f"{path!r}: {_ORBAX}")
    return kind


def load_unet_any(path: str, step: Optional[int] = None,
                  use_ema: bool = True) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """(reference-named UNet state dict, constructor arguments) from a torch
    .pth, a flat .npz, or the port's train dir (`step`, default the latest;
    the EMA parameters unless `use_ema=False`)."""
    kind = _refuse_orbax(path)
    if kind == "npz":
        params = load_params_npz(path)
        arch = infer_unet_arch_from_params(params)
        return unet_state_dict_from_jax(params, depth=len(arch["ch_mult"])), arch
    if kind == "train_dir":
        sd = train_checkpoint.load_params(path, step=step, use_ema=use_ema)
    else:
        sd = load_torch_state_dict(path)
    return sd, infer_unet_arch(sd)


def load_daclip_any(path: str, image_size: Optional[int] = None,
                    patch_size: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Reference-named DaCLIP state dict from a torch .pt, a flat .npz, or
    the port's DA-CLIP train dir (its latest epoch). A torch checkpoint's
    ViT position embeddings are resized to the (image_size // patch_size)²
    grid, as `convert_daclip` does; an .npz is already in the JAX package's
    layout and is taken as it is."""
    kind = _refuse_orbax(path)
    if kind == "train_dir":
        raise NotImplementedError(f"{path!r} is a restoration train dir (UNet weights), "
                                  "not DA-CLIP weights")
    if kind == "npz":
        return daclip_state_dict_from_jax(load_params_npz(path))
    if kind == "clip_train_dir":
        sd = train_checkpoint.load_clip_state_dict(path)
    else:
        sd = load_torch_state_dict(path)
    if image_size is not None and patch_size is not None:
        for key in ("clip.visual.positional_embedding", "visual.positional_embedding",
                    "visual_control.positional_embedding"):
            if key in sd:
                sd[key] = resize_pos_embed(sd[key], image_size, patch_size)
    return sd
