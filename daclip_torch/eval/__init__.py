"""Evaluation entry points of the port, and what they share.

Counterpart of `daclip_tpu/eval/__init__.py` (`parse_checkpoint_spec`).
`load_daclip` and `DaclipEncoders` are the model loading and the batched
encoders that each of daclip_tpu's eval modules and `tools/encode_folder`
builds for itself: a DaCLIP from `load_daclip_any` (torch .pt, flat .npz
or the port's DA-CLIP train dir) on a device, in bf16 as daclip_tpu's
`DaCLIP(cfg, dtype=jnp.bfloat16)` unless told otherwise.
"""
from __future__ import annotations

import os
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def parse_checkpoint_spec(spec: str):
    """Parse a --checkpoint value: "name=path", or a bare path (which may
    itself contain '=' — e.g. epoch=5.pt — so an existing file always wins).
    Returns (name, path)."""
    if "=" in spec and not os.path.exists(spec):
        name, _, path = spec.partition("=")
    else:
        name, path = "", spec
    return name or os.path.splitext(os.path.basename(path))[0], path


def load_daclip(checkpoint: str, model_name: str = "daclip_ViT-B-32", device=None,
                dtype: torch.dtype = torch.bfloat16):
    """(DaCLIP on `device` (default cuda) in `dtype`, its CLIPCfg, the
    predictor's state dict: its `predictor.*` entries without the prefix,
    empty when the checkpoint has none). The DaCLIP itself is built without
    the predictor, as daclip_tpu's evaluate_daclip drops it."""
    from daclip_torch.models.clip import CLIPCfg, DaCLIP, get_model_config
    from daclip_torch.pipeline import resolve_device
    from daclip_torch.utils.native_checkpoint import load_daclip_any

    dev = resolve_device(device)
    cfg = CLIPCfg.from_dict(get_model_config(model_name))
    v = cfg.vision
    sd = load_daclip_any(checkpoint, v.image_size, None if v.is_resnet else v.patch_size)
    predictor = {k[len("predictor."):]: t for k, t in sd.items() if k.startswith("predictor.")}
    model = DaCLIP(cfg, dtype=dtype)
    model.load_state_dict({k: t for k, t in sd.items() if not k.startswith("predictor.")},
                          strict=True)
    return model.to(dev).eval(), cfg, predictor


class DaclipEncoders:
    """numpy in, float32 numpy out, on the model's device: `text(tokens)`
    → (N, D) normalised text features; `image(views, control)` → with
    control (image, degradation) features, normalised, else the image
    features alone. `views` are `clip_transform`'s (B, H, W, 3) NHWC."""

    def __init__(self, model: torch.nn.Module):
        self.model = model
        self.device = next(model.parameters()).device

    @torch.no_grad()
    def text(self, tokens: np.ndarray) -> np.ndarray:
        t = torch.from_numpy(np.asarray(tokens)).to(self.device)
        return self.model.encode_text(t, normalize=True).float().cpu().numpy()

    @torch.no_grad()
    def image(self, views: np.ndarray, control: bool = True):
        x = torch.from_numpy(np.ascontiguousarray(views, dtype=np.float32))
        x = x.permute(0, 3, 1, 2).contiguous().to(self.device)
        out = self.model.encode_image(x, control=control, normalize=True)
        if control:
            return tuple(f.float().cpu().numpy() for f in out)
        return out.float().cpu().numpy()


def read_views(paths, res: int) -> np.ndarray:
    """(B, res, res, 3) CLIP views of image files, as daclip_tpu's eval
    modules make them: `read_img` (BGR in [0, 1]) → RGB → `clip_transform`."""
    from daclip_torch.data.util import read_img
    from daclip_torch.transforms import clip_transform

    return np.stack([clip_transform(read_img(None, p)[:, :, ::-1], res) for p in paths])


def class_dirs(dataset_path: str) -> Tuple[list, Dict[str, str], list]:
    """(classes: the sorted sub-directories, class → base class (its leading
    letters and dashes), the sorted base classes)."""
    classes = sorted(c for c in os.listdir(dataset_path)
                     if os.path.isdir(os.path.join(dataset_path, c)))
    base_class_map = {c: re.match(r"[a-zA-Z-]+", c).group() for c in classes}
    return classes, base_class_map, sorted(set(base_class_map.values()))


def class_files(dataset_path: str, cname: str, max_per_class: Optional[int] = None):
    """(directory, its sorted file names): `<class>/LQ` when it exists, else
    `<class>`."""
    cdir = os.path.join(dataset_path, cname, "LQ")
    if not os.path.isdir(cdir):
        cdir = os.path.join(dataset_path, cname)
    return cdir, sorted(os.listdir(cdir))[:max_per_class]
