"""Maximum-likelihood matching loss for IR-SDE training.

Counterpart of `daclip_tpu/losses/matching.py` (reference config/daclip-sde/
models/modules/loss.py:9-29, MatchingLoss): per-sample mean of
|predict − target| (or its square), optionally weighted, then the batch mean.
"""
from __future__ import annotations

import torch


def matching_loss(predict, target, loss_type: str = "l1", weights=None):
    if loss_type == "l1":
        per = (predict - target).abs()
    elif loss_type == "l2":
        per = (predict - target).square()
    else:
        raise ValueError(f"invalid loss type {loss_type!r}")
    per = per.reshape(per.shape[0], -1).mean(dim=-1)
    if weights is not None:
        per = per * weights.reshape(-1)
    return per.mean()
