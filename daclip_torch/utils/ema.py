"""Exponential moving average of the UNet parameters with ema_pytorch's
semantics, as the reference trains it (config/daclip-sde/models/
denoising_model.py:118: EMA(model, beta=0.995, update_every=10)).

Counterpart of `daclip_tpu/utils/ema.py`. ema_pytorch's constants:
update_after_step 100, inv_gamma 1, power 2/3;
decay(step) = min(beta, 1 − (1 + eff/inv_gamma)^−power) with
eff = max(step − update_after_step − 1, 0), and decay 0 (a copy) while
eff ≤ 0. The counter counts every `update` call; the average moves only on
calls whose count is a multiple of `update_every`. Shadow parameters are
float32 and keyed by the module's parameter names, so they form a
reference-named state dict.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch


class EMA:
    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 beta: float = 0.995, update_every: int = 10,
                 update_after_step: int = 100, inv_gamma: float = 1.0,
                 power: float = 2.0 / 3.0):
        self.params: Dict[str, torch.Tensor] = {
            k: p.detach().float().clone() for k, p in named_params}
        self.step = 0
        self.beta, self.update_every = beta, update_every
        self.update_after_step, self.inv_gamma, self.power = (
            update_after_step, inv_gamma, power)

    def decay(self, step: int) -> float:
        """The decay of update call number `step`, in float32 arithmetic."""
        f = np.float32
        eff = max(f(step) - f(self.update_after_step) - f(1), f(0))
        if eff <= 0:
            return 0.0
        d = f(1) - (f(1) + eff / f(self.inv_gamma)) ** f(-self.power)
        return float(min(d, f(self.beta)))

    @torch.no_grad()
    def update(self, named_params: Iterable[Tuple[str, torch.Tensor]]) -> None:
        self.step += 1
        if self.step % self.update_every:
            return
        d = self.decay(self.step)
        for k, p in named_params:
            e = self.params[k]
            e.copy_(e * d + p.float() * (1.0 - d))

    def load_state_dict(self, state) -> None:
        for k, v in state["params"].items():
            self.params[k].copy_(v)
        self.step = int(state["step"])
