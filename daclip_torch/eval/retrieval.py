"""CLIP validation: retrieval metrics and the val losses
(training/train.py:248-381).

Counterpart of `daclip_tpu/eval/retrieval.py`: `get_clip_metrics` in numpy
(recall@{1,5,10}, mean and median rank of the matched pair, image→text and
text→image) and `evaluate`, which runs a CsvDataset-style dataset through
the model in order, in batches, and gives the mean of each val loss beside
the recall over all its samples.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


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


@torch.no_grad()
def evaluate(model: torch.nn.Module, dataset, batch_size: int = 64, banks=None,
             variant: str = "fork", device=None) -> Dict[str, float]:
    """Val losses (`val_<loss>`, the mean over batches) and retrieval
    metrics over `dataset` (train.py:248-363), on `device` (default CUDA;
    the model is moved there). The fork variant passes the banks; the
    DaCLIP variants encode `gt_images` (the LQ images when a sample has
    none); `variant="clip"` gives the contrastive loss of a plain CLIP."""
    from daclip_torch.data.loader import to_device
    from daclip_torch.losses import clip_loss, daclip_loss_fork, daclip_loss_uir
    from daclip_torch.pipeline import resolve_device

    dev = resolve_device(device)
    model.to(dev)
    all_img, all_txt, losses = [], [], []
    n = len(dataset)
    for i in range(0, n, batch_size):
        samples = [dataset[j] for j in range(i, min(i + batch_size, n))]
        batch = to_device({k: np.stack([s[k] for s in samples]) for k in samples[0]}, dev)
        if variant == "clip":
            out = model(image=batch["images"], text=batch["texts"])
            loss_d = {"contrastive_loss": clip_loss(out["image_features"],
                                                    out["text_features"], out["logit_scale"])}
        else:
            kwargs = {}
            if variant == "fork" and banks is not None:
                kwargs = dict(deg_type=batch["deg_type"], gt_val=batch["gt_val"],
                              bin_center_bank=torch.as_tensor(np.asarray(banks[0]),
                                                              device=dev),
                              all_d_type_tokens=torch.as_tensor(np.asarray(banks[1]),
                                                                device=dev).long())
            out = model(image=batch["images"], text=batch["texts"],
                        gt_images=batch.get("gt_images", batch["images"]), **kwargs)
            loss_d = daclip_loss_fork(out) if variant == "fork" else daclip_loss_uir(out)
        losses.append({k: float(v) for k, v in loss_d.items()})
        all_img.append(out["image_features"].float().cpu().numpy())
        all_txt.append(out["text_features"].float().cpu().numpy())
        scale = float(out["logit_scale"])
    metrics = get_clip_metrics(np.concatenate(all_img), np.concatenate(all_txt), scale)
    for k in losses[0]:
        metrics[f"val_{k}"] = float(np.mean([l[k] for l in losses]))
    metrics["num_samples"] = sum(a.shape[0] for a in all_img)
    return metrics
