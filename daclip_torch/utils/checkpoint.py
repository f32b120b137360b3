"""Training checkpoints of the restoration trainer, in torch format.

Counterpart of `daclip_tpu/utils/checkpoint.py` (orbax there): one file
`<dir>/<step>.pt` per save, written to a temporary name and renamed, holding
{params, opt_state, params_ema, ema_step, step}. `params` and `params_ema`
are reference-named UNet state dicts; `params_ema` is the key the reference
checkpoint loader unwraps (`convert.load_torch_state_dict`), so a checkpoint
file loads its EMA weights by default, strictly, into `DACLIPRestorer`.
"""
from __future__ import annotations

import os
import re
from typing import Optional

import torch

_NAME = re.compile(r"^(\d+)\.pt$")


def checkpoint_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"{int(step)}.pt")


def save_checkpoint(directory: str, unet: torch.nn.Module, state) -> str:
    """Save the UNet's parameters and the TrainState (optimizer, EMA, step)
    as `<directory>/<state.step>.pt`; returns the path."""
    os.makedirs(directory, exist_ok=True)
    path = checkpoint_path(directory, state.step)
    tmp = f"{path}.tmp-{os.getpid()}"
    cpu = lambda sd: {k: v.detach().cpu() for k, v in sd.items()}
    torch.save({"params": cpu(unet.state_dict()),
                "opt_state": state.optimizer.state_dict(),
                "params_ema": cpu(state.ema.params),
                "ema_step": state.ema.step,
                "step": state.step}, tmp)
    os.replace(tmp, path)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for m in map(_NAME.match, os.listdir(directory)) if m]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, unet: torch.nn.Module, state,
                       step: Optional[int] = None):
    """Load `<directory>/<step>.pt` (the latest when step is None) into the
    UNet and the TrainState, in place; returns the state."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    device = next(unet.parameters()).device
    ckpt = torch.load(checkpoint_path(directory, step), map_location=device,
                      weights_only=False)
    unet.load_state_dict(ckpt["params"], strict=True)
    state.optimizer.load_state_dict(ckpt["opt_state"])
    state.ema.load_state_dict({"params": ckpt["params_ema"], "step": ckpt["ema_step"]})
    state.step = int(ckpt["step"])
    return state
