"""CLIP retrieval metrics (training/train.py:364-381).

Counterpart of `daclip_tpu/eval/retrieval.py:get_clip_metrics`, in numpy:
recall@{1,5,10}, mean and median rank of the matched pair, image→text and
text→image.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def get_clip_metrics(image_features: np.ndarray, text_features: np.ndarray,
                     logit_scale: float) -> Dict[str, float]:
    metrics = {}
    logits_per_image = logit_scale * image_features @ text_features.T
    logits_per_text = logits_per_image.T
    ground_truth = np.arange(logits_per_image.shape[0])
    for name, logit in (("image_to_text", logits_per_image),
                        ("text_to_image", logits_per_text)):
        ranking = np.argsort(-logit, axis=1)
        preds = np.where(ranking == ground_truth[:, None])[1]
        metrics[f"{name}_mean_rank"] = float(preds.mean() + 1)
        metrics[f"{name}_median_rank"] = float(np.floor(np.median(preds)) + 1)
        for k in (1, 5, 10):
            metrics[f"{name}_R@{k}"] = float(np.mean(preds < k))
    return metrics
