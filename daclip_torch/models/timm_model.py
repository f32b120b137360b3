"""The timm image-tower adapter under the reference's name (open_clip/
timm_model.py:28-149; daclip_tpu `models/timm_model.py:20`).

timm is on neither machine; every timm family the vendored configs name is
written here instead — convnext_* (models/convnext.py), eva*/eva02_*
(models/eva.py), swin_base_patch4_window7_224 (models/swin.py) and
vit_{medium_patch16_gap_256,relpos_medium_patch16_cls_224}
(models/timm_vit.py) — under timm's parameter names inside the adapter's
`trunk` / `head`. `CLIP` dispatches through `convnext.build_timm_tower`.
"""
from __future__ import annotations

from daclip_torch.models.convnext import build_timm_tower


def TimmModel(model_name: str, embed_dim: int = 512, image_size: int = 224,
              pool: str = "", proj: str = "linear", drop: float = 0.0,
              drop_path=None, **_ignored):
    """The reference's signature (timm_model.py:33-46): the tower of a
    written family, ImportError for any other timm backbone."""
    return build_timm_tower(model_name, embed_dim, pool=pool, proj=proj, drop=drop,
                            drop_path=drop_path, image_size=image_size)
