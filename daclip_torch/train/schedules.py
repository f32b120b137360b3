"""Learning-rate schedules of the restoration trainer, as plain functions of
the optimizer step.

Counterpart of `daclip_tpu/train/schedules.py:16-52, 91-100`:
  * TrueCosineAnnealingLR (torch CosineAnnealingLR, denoising_model.py:107-114)
  * MultiStepLR_Restart (config/daclip-sde/models/lr_scheduler.py:8-44)
  * the UIR linear warm-up that overrides either (base_model.py:52-64).
Values are computed in float32, as the JAX schedules compute them.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np


def cosine_annealing(base_lr: float, t_max: int, eta_min: float = 0.0):
    """η(t) = η_min + (η0 − η_min)(1 + cos(π·min(t, T)/T))/2."""
    def schedule(step: int) -> float:
        t = np.float32(min(step, t_max))
        return float(np.float32(eta_min) + np.float32(base_lr - eta_min) * np.float32(0.5)
                     * (np.float32(1) + np.cos(np.float32(math.pi) * t / np.float32(t_max))))
    return schedule


def multistep_restart(base_lr: float, milestones: Sequence[int], gamma: float = 0.5,
                      restarts: Optional[Sequence[int]] = None,
                      restart_weights: Optional[Sequence[float]] = None):
    """lr = base·gamma^(milestones passed in the current restart segment); at a
    restart step the lr resets to base·weight and milestone counting
    restarts."""
    restarts = sorted(restarts or [])
    restart_weights = list(restart_weights or [1.0] * len(restarts))
    if len(restarts) != len(restart_weights):
        raise ValueError("restarts and restart_weights differ in length")
    milestones = sorted(milestones)

    def schedule(step: int) -> float:
        seg = sum(step >= r for r in restarts)
        seg_start = restarts[seg - 1] if seg else 0
        weight = np.float32(restart_weights[seg - 1] if seg else 1.0)
        passed = sum(seg_start < m <= step for m in milestones)
        return float(np.float32(base_lr) * weight * np.float32(gamma) ** np.float32(passed))
    return schedule


def warmup_override(schedule, warmup_iter: int, base_lr: float):
    """Linear ramp base·(t+1)/warmup_iter for the first warmup_iter steps,
    then `schedule`."""
    if warmup_iter <= 0:
        return schedule

    def wrapped(step: int) -> float:
        if step < warmup_iter:
            return float(np.float32(base_lr) * (np.float32(step) + 1) / np.float32(warmup_iter))
        return schedule(step)
    return wrapped
