"""Zero-shot classification utilities.

Counterpart of `daclip_tpu/eval/zero_shot.py` (open_clip/
zero_shot_classifier.py:21-69 and training/zero_shot.py:12-15). The ImageNet
class names and the 80 OpenAI templates are read by path from the JAX
package's `assets/zero_shot_metadata.json`.
"""
from __future__ import annotations

import json
import pathlib
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from daclip_torch.pipeline import resolve_device

_ASSET = (pathlib.Path(__file__).resolve().parents[2] / "daclip_tpu" / "assets"
          / "zero_shot_metadata.json")


def load_imagenet_metadata():
    """(ImageNet class names, OpenAI templates)."""
    d = json.loads(_ASSET.read_text())
    return d["imagenet_classnames"], d["openai_imagenet_templates"]


@torch.no_grad()
def build_zero_shot_classifier(encode_text: Callable, tokenizer: Callable,
                               classnames: Sequence[str], templates: Sequence[str],
                               num_classes_per_batch: Optional[int] = 10,
                               device=None) -> torch.Tensor:
    """(D, num_classes) classifier: for each class the mean of its
    templates' normalised text features, normalised again. `encode_text`
    maps (N, L) token ids on `device` (default cuda) to normalised (N, D)
    features; the classes are encoded `num_classes_per_batch` at a time."""
    device = resolve_device(device)
    weights = []
    bs = num_classes_per_batch or len(classnames)
    for i in range(0, len(classnames), bs):
        chunk = classnames[i: i + bs]
        texts = [t.replace("{}", c) if "{}" in t else t.format(c)
                 for c in chunk for t in templates]
        emb = encode_text(torch.from_numpy(tokenizer(texts)).to(device))
        emb = emb.reshape(len(chunk), len(templates), -1).mean(dim=1)
        weights.append(emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True))
    return torch.cat(weights).T


def accuracy(logits: np.ndarray, target: np.ndarray, topk=(1,)) -> List[float]:
    """Top-k accuracies (training/zero_shot.py:12-15)."""
    order = np.argsort(-logits, axis=-1)
    return [float(np.mean([t in order[i, :k] for i, t in enumerate(target)]))
            for k in topk]
