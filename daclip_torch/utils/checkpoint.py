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

Both trainers also resume daclip_tpu's orbax train dirs (its
`utils/checkpoint.py`'s step dirs `<dir>/<n>/`, `<n>` the step or, for
DA-CLIP, the epoch), whose state `utils/native_checkpoint.py` reads into the
same payload as a `.pt` file's (`load_restoration_train_state`,
`load_daclip_train_state`): `resume_point` picks the newest of either kind
under a dir, the `.pt` on a tie, and both kinds reach the model, the
optimizer and the EMA through `_restore_payload`'s calls.

Under a mesh (`daclip_torch.parallel`) the files are the same: rank 0
gathers the whole tensors (torch.distributed.checkpoint's full state dicts;
the other ranks take part only where a tensor is sharded) and writes, the
others waiting at a barrier; every rank loads a file and keeps its part. A
run saved under one mesh resumes under another, or on one card.
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import torch

from daclip_torch import parallel
from daclip_torch.utils import orbax_reader

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


def resume_point(directory: str, prefix: str = "") -> Optional[Tuple[str, int]]:
    """The newest checkpoint under `directory`: ("pt", n) for the port's
    `<prefix><n>.pt`, ("orbax", n) for daclip_tpu's step dir `<n>/`; the
    `.pt` on a tie; None when it holds neither."""
    pt, orbax = latest_step(directory, prefix), orbax_reader.latest_step(directory)
    if pt is None and orbax is None:
        return None
    return ("pt", pt) if orbax is None or (pt is not None and pt >= orbax) else ("orbax", orbax)


def _orbax_step_dir(path: str) -> bool:
    """One of daclip_tpu's step dirs itself (`<dir>/<n>/`)."""
    name = os.path.basename(os.path.normpath(path))
    return name.isdigit() and os.path.isfile(os.path.join(path, "_CHECKPOINT_METADATA"))


def pick_checkpoint(path: str, n: Optional[int] = None,
                    prefix: str = "") -> Tuple[str, Optional[int]]:
    """(kind, number) of the checkpoint `path` and `n` name: "pt" for a `.pt`
    file, "orbax" for a step dir of daclip_tpu's (number None for either),
    or under a dir `n`'s file or step dir (the newest, `resume_point`, when n
    is None); FileNotFoundError when there is none."""
    if os.path.isfile(path):
        return "pt", None
    if _orbax_step_dir(path):
        return "orbax", None
    if n is not None:
        return ("pt" if os.path.isfile(checkpoint_path(path, n, prefix)) else "orbax"), n
    found = resume_point(path, prefix)
    if found is None:
        raise FileNotFoundError(f"no {prefix}<n>.pt checkpoints and no orbax step dirs under "
                                f"{path}")
    return found


def _restore_payload(model: torch.nn.Module, optimizer, params: Dict[str, torch.Tensor],
                     opt_state: Optional[dict], strict: bool = True) -> None:
    """A payload's model state and optimizer state (None: none) into `model`
    and `optimizer`, each rank keeping its part under a mesh: one path for
    the port's files and daclip_tpu's train dirs."""
    parallel.load_model_state(model, params, strict=strict)
    if opt_state is not None:
        parallel.load_optimizer_state(model, optimizer, opt_state)


def _save(directory: str, n: int, payload: dict, max_to_keep: Optional[int],
          prefix: str = "") -> str:
    """On rank 0, write `payload` to a temporary name and rename it to
    `<directory>/<prefix><n>.pt`, then keep only the newest `max_to_keep`
    such files (all when None); every rank returns the path once it is
    written."""
    path = checkpoint_path(directory, n, prefix)
    if parallel.rank() == 0:
        os.makedirs(directory, exist_ok=True)
        tmp = f"{path}.tmp-{os.getpid()}"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        if max_to_keep is not None:
            for old in steps(directory, prefix)[:-max_to_keep]:
                os.remove(checkpoint_path(directory, old, prefix))
    parallel.barrier()
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


def save_checkpoint(directory: str, unet: torch.nn.Module, state,
                    max_to_keep: Optional[int] = None) -> str:
    """Save the UNet's parameters and the TrainState (optimizer, EMA, step)
    as `<directory>/<state.step>.pt`, then keep only the newest
    `max_to_keep` step files (all when None); returns the path. `unet` may
    be wrapped by `parallel.parallelize` (every rank calls this then)."""
    unet = parallel.unwrap(unet)
    return _save(directory, state.step,
                 {"params": parallel.model_state(unet),
                  "opt_state": parallel.optimizer_state(unet, state.optimizer),
                  "params_ema": parallel.full_tensors(state.ema.params),
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
                       step: Optional[int] = None, cfg=None):
    """Load into the UNet and the TrainState, in place, each rank keeping its
    part under a mesh: `<directory>/<step>.pt`, or daclip_tpu's step dir
    `<directory>/<step>/` (its optimizer checked against `cfg`, the
    restoration options' `RestorationTrainConfig`), the newest of either
    when step is None (`resume_point`); a `.pt` file or a step dir may be
    given as `directory`. Returns the state."""
    kind, step = pick_checkpoint(directory, step)
    module = parallel.unwrap(unet)
    if kind == "orbax":
        from daclip_torch.utils import native_checkpoint

        ckpt = native_checkpoint.load_restoration_train_state(
            directory, step, cfg=cfg, unet=module, optimizer=state.optimizer)
    else:
        ckpt = torch.load(_file(directory, step), map_location="cpu", weights_only=False)
    _restore_payload(module, state.optimizer, ckpt["params"], ckpt["opt_state"])
    parallel.load_tensors(state.ema.params, ckpt["params_ema"])
    state.ema.step = int(ckpt["ema_step"])
    state.step = int(ckpt["step"])
    return state


def save_clip_checkpoint(directory: str, model: torch.nn.Module, state, epoch: int,
                         name: Optional[str] = None, max_to_keep: Optional[int] = None) -> str:
    """Save the model's state dict and the ClipTrainState (optimizer, step)
    as `<directory>/epoch_<epoch>.pt`, then keep only the newest
    `max_to_keep` epoch files (all when None); returns the path. `model`
    may be wrapped by `parallel.parallelize` (every rank calls this then)."""
    model = parallel.unwrap(model)
    return _save(directory, epoch,
                 {"epoch": int(epoch), "name": name, "step": state.step,
                  "state_dict": parallel.model_state(model),
                  "optimizer": parallel.optimizer_state(model, state.optimizer)},
                 max_to_keep, EPOCH)


def load_clip_state_dict(path: str, epoch: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The model state dict of an `epoch_<n>.pt` file, or of a train dir's
    `epoch` (the latest when None), as float32 CPU tensors."""
    ckpt = torch.load(_file(path, epoch, EPOCH), map_location="cpu", weights_only=False)
    return {k: v.detach().to(torch.float32) for k, v in ckpt["state_dict"].items()}


def restore_clip_checkpoint(path: str, model: torch.nn.Module, state,
                            epoch: Optional[int] = None, cfg=None, log=None) -> int:
    """Load into the model and the ClipTrainState, in place, each rank
    keeping its part under a mesh: an `epoch_<n>.pt` file, a train dir's
    `epoch_<epoch>.pt`, or daclip_tpu's step dir `<path>/<epoch>/` (or one
    given as `path`; its optimizer checked against `cfg`, the
    `ClipTrainConfig`; a dir without optimizer state restores the model
    alone, logged on `log`), the newest of either when epoch is None
    (`resume_point`). Returns the checkpoint's epoch."""
    kind, epoch = pick_checkpoint(path, epoch, EPOCH)
    model_ = parallel.unwrap(model)
    if kind == "orbax":
        from daclip_torch.utils import native_checkpoint

        ckpt = native_checkpoint.load_daclip_train_state(
            path, model_, epoch, cfg=cfg, optimizer=state.optimizer, log=log)
    else:
        ckpt = torch.load(_file(path, epoch, EPOCH), map_location="cpu", weights_only=False)
    _restore_payload(model_, state.optimizer, ckpt["state_dict"], ckpt["optimizer"],
                     strict=set(ckpt["state_dict"]) >= set(model_.state_dict()))
    if ckpt["optimizer"] is not None:
        state.step = int(ckpt["step"])
    return int(ckpt["epoch"])
