"""Training checkpoints of the restoration and DA-CLIP trainers, in torch
format.

Counterpart of `daclip_tpu/utils/checkpoint.py` (orbax there).

Restoration: one file
`<dir>/<step>.pt` per save, written to a temporary name and renamed, holding
{params, opt_state, params_ema, ema_step, step}. `params` and `params_ema`
are reference-named UNet state dicts; `params_ema` is the key the reference
checkpoint loader unwraps (`convert.load_torch_state_dict`), so a checkpoint
file loads its EMA weights by default, strictly, into `DACLIPRestorer`; a
train dir loads through `load_params` (`DACLIPRestorer.load` takes one).
With `max_to_keep`, older step files are removed after each save, as the
JAX CLI keeps its last five.

DA-CLIP / CLIP (`cli/train_daclip.py`): one file `<dir>/epoch_<n>.pt` per
save, as the reference names them (training/main.py:426-459), holding
{epoch, name, step, state_dict, optimizer}: `state_dict` is the whole
model's under the reference's names (a DaCLIP's frozen CLIP included), so
`DaCLIP.load_state_dict(strict=True)` takes it and `convert.
load_torch_state_dict` unwraps it; `optimizer` is the trainable parameters'
AdamW state. The `best/` and `latest/` slots are such directories of one
file each.
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import torch

EPOCH = "epoch_"   # the DA-CLIP trainer's file prefix: epoch_<n>.pt


def checkpoint_path(directory: str, n: int, prefix: str = "") -> str:
    """`<directory>/<prefix><n>.pt`: a step's file, or an epoch's with
    `prefix=EPOCH`."""
    return os.path.join(directory, f"{prefix}{int(n)}.pt")


def steps(directory: str, prefix: str = "") -> List[int]:
    """The numbers of the `<prefix><n>.pt` files under `directory`, sorted."""
    if not os.path.isdir(directory):
        return []
    name = re.compile(rf"^{re.escape(prefix)}(\d+)\.pt$")
    return sorted(int(m.group(1)) for m in map(name.match, os.listdir(directory)) if m)


def latest_step(directory: str, prefix: str = "") -> Optional[int]:
    found = steps(directory, prefix)
    return found[-1] if found else None


def _save(directory: str, n: int, payload: dict, max_to_keep: Optional[int],
          prefix: str = "") -> str:
    """Write `payload` to a temporary name and rename it to
    `<directory>/<prefix><n>.pt`, then keep only the newest `max_to_keep`
    such files (all when None); returns the path."""
    os.makedirs(directory, exist_ok=True)
    path = checkpoint_path(directory, n, prefix)
    tmp = f"{path}.tmp-{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    if max_to_keep is not None:
        for old in steps(directory, prefix)[:-max_to_keep]:
            os.remove(checkpoint_path(directory, old, prefix))
    return path


def _file(path: str, n: Optional[int], prefix: str = "") -> str:
    """`path` itself when it is a file, else its `<prefix><n>.pt` (the
    latest when n is None)."""
    if os.path.isfile(path):
        return path
    n = latest_step(path, prefix) if n is None else n
    if n is None:
        raise FileNotFoundError(f"no {prefix}<n>.pt checkpoints under {path}")
    return checkpoint_path(path, n, prefix)


def _cpu(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in sd.items()}


def save_checkpoint(directory: str, unet: torch.nn.Module, state,
                    max_to_keep: Optional[int] = None) -> str:
    """Save the UNet's parameters and the TrainState (optimizer, EMA, step)
    as `<directory>/<state.step>.pt`, then keep only the newest
    `max_to_keep` step files (all when None); returns the path."""
    return _save(directory, state.step,
                 {"params": _cpu(unet.state_dict()),
                  "opt_state": state.optimizer.state_dict(),
                  "params_ema": _cpu(state.ema.params),
                  "ema_step": state.ema.step,
                  "step": state.step}, max_to_keep)


def load_params(directory: str, step: Optional[int] = None,
                use_ema: bool = True) -> Dict[str, torch.Tensor]:
    """The UNet state dict of `<directory>/<step>.pt` (the latest when step
    is None) as float32 CPU tensors: the EMA parameters, or the raw ones
    with `use_ema=False`."""
    ckpt = torch.load(_file(directory, step), map_location="cpu", weights_only=False)
    return {k: v.detach().to(torch.float32)
            for k, v in ckpt["params_ema" if use_ema else "params"].items()}


def restore_checkpoint(directory: str, unet: torch.nn.Module, state,
                       step: Optional[int] = None):
    """Load `<directory>/<step>.pt` (the latest when step is None) into the
    UNet and the TrainState, in place; returns the state."""
    device = next(unet.parameters()).device
    ckpt = torch.load(_file(directory, step), map_location=device, weights_only=False)
    unet.load_state_dict(ckpt["params"], strict=True)
    state.optimizer.load_state_dict(ckpt["opt_state"])
    state.ema.load_state_dict({"params": ckpt["params_ema"], "step": ckpt["ema_step"]})
    state.step = int(ckpt["step"])
    return state


def save_clip_checkpoint(directory: str, model: torch.nn.Module, state, epoch: int,
                         name: Optional[str] = None, max_to_keep: Optional[int] = None) -> str:
    """Save the model's state dict and the ClipTrainState (optimizer, step)
    as `<directory>/epoch_<epoch>.pt`, then keep only the newest
    `max_to_keep` epoch files (all when None); returns the path."""
    return _save(directory, epoch,
                 {"epoch": int(epoch), "name": name, "step": state.step,
                  "state_dict": _cpu(model.state_dict()),
                  "optimizer": state.optimizer.state_dict()}, max_to_keep, EPOCH)


def load_clip_state_dict(path: str, epoch: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The model state dict of an `epoch_<n>.pt` file, or of a train dir's
    `epoch` (the latest when None), as float32 CPU tensors."""
    ckpt = torch.load(_file(path, epoch, EPOCH), map_location="cpu", weights_only=False)
    return {k: v.detach().to(torch.float32) for k, v in ckpt["state_dict"].items()}


def restore_clip_checkpoint(path: str, model: torch.nn.Module, state,
                            epoch: Optional[int] = None) -> int:
    """Load an `epoch_<n>.pt` file, or a train dir's `epoch` (the latest
    when None), into the model and the ClipTrainState, in place; returns
    the checkpoint's epoch."""
    device = next(model.parameters()).device
    ckpt = torch.load(_file(path, epoch, EPOCH), map_location=device, weights_only=False)
    model.load_state_dict(ckpt["state_dict"], strict=True)
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    return int(ckpt["epoch"])
