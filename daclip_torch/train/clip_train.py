"""DA-CLIP / CLIP training, in PyTorch.

Counterpart of `daclip_tpu/train/clip_train.py:34-370` (reference da-clip/
src/training/main.py:219-459, train.py:64-245):
  * `partition_daclip_params`: DaCLIP's `clip.*` is frozen (lock_clip,
    daclip_model.py:36-38), with `requires_grad_(False)` and no optimizer
    state; the controller, DaCLIP's own `logit_scale` and the predictor
    train. The backward still runs through the frozen tower's activations,
    as the controller's hiddens enter its blocks.
  * AdamW as optax computes it (`train/restoration.py`'s), after a clip by
    the global norm of every trainable gradient, weight decay on the
    parameters with ndim ≥ 2 (main.py:304-319) as daclip_tpu counts it:
    its transformer blocks, zero modules and the predictor's four
    regressors are stacked along a leading axis, so their biases and
    LayerNorm gains have ndim 2 and decay too (upstream open_clip leaves
    every bias and gain undecayed; this follows daclip_tpu); a LiT update mask
    (`train/locking.py`) zeroes the locked parameters' updates, weight
    decay included, after AdamW.
  * `make_train_step`: the fork (FCRC + regression), uir, plain clip and
    distillation variants; `logit_scale` clamped to [0, ln 100] after each
    update (train.py:187-189).
  * `ClipTrainConfig.patch_dropout` (--force-patch-dropout): every forward
    runs with `train=True`, its patch noise drawn from a generator seeded
    from the optimizer step (`dropout_generator`); daclip_tpu folds the step
    into PRNGKey(0) instead, so the subsets differ between the packages;
  * `make_accum_train_step`: the reference's cached-feature two-pass
    accumulation (train.py:124-162), the JAX package's
    `make_accum_train_step`, with its quirks kept: the gradient is not
    divided by `accum_freq`, `logit_scale` gets `accum_freq`× its full-batch
    gradient, and the GT features come from the first pass.
  * Several ranks (`daclip_torch.parallel`): the steps take the model as
    `parallel.parallelize` wrapped it (DDP, FSDP, tensor parallel). Each
    rank's per-sample outputs are gathered over the data-parallel group and
    every rank computes the global batch's loss (`losses.gather_features`),
    so the averaged gradient is daclip_tpu's over its mesh; the clip norm is
    the whole gradient's, and the metrics are the group's means.

The entry points put the model on `device`, which defaults to CUDA and
raises without a GPU unless the caller passes `device="cpu"`. Batches are
dicts of tensors on that device: images / gt_images (B, 3, H, W) float,
texts (B, 2·L) caption‖degradation token ids with the DaCLIP variants (B, L)
otherwise, deg_type / gt_val (B, 4).
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from daclip_torch import parallel
from daclip_torch.losses import (clip_loss, daclip_loss_fork, daclip_loss_uir,
                                 distill_clip_loss, gather_features)
from daclip_torch.losses.clip_loss import PER_SAMPLE_KEYS
from daclip_torch.models.clip import DaCLIP
from daclip_torch.train import schedules as sched
from daclip_torch.train.locking import apply_update_mask
from daclip_torch.train.restoration import _check_device, _on_device, clip_by_global_norm

_BATCH_KEYS = ("images", "texts", "gt_images", "deg_type", "gt_val")
LOGIT_SCALE_MAX = math.log(100.0)
# modules daclip_tpu stacks along a leading axis (nn.scan blocks: the open_clip
# transformers, CoCa's decoder, the EVA and timm ViT trunks; the predictor's
# regressors): their parameters have one more dimension there
_STACKED = re.compile(r"(^|\.)(resblocks|zero_modules|regressors|cross_attn|trunk\.blocks)"
                      r"\.\d+\.")


@dataclasses.dataclass
class ClipTrainConfig:
    """training/params.py's defaults for ViT-B-32 (params.py:5-11, 26-459)."""
    lr: float = 5e-4
    beta1: float = 0.9
    beta2: float = 0.98
    eps: float = 1e-6
    wd: float = 0.2
    warmup: int = 10000
    total_steps: int = 100000
    lr_scheduler: str = "cosine"       # cosine | const | const-cooldown
    lr_cooldown_end: float = 0.0
    lr_cooldown_power: float = 1.0
    cooldown_steps: Optional[int] = None
    skip_scheduler: bool = False
    grad_clip_norm: Optional[float] = None
    accum_freq: int = 1
    variant: str = "fork"              # fork | uir | clip
    distill: bool = False
    patch_dropout: bool = False        # --force-patch-dropout is set


@dataclasses.dataclass
class ClipTrainState:
    """The optimizer over the trainable parameters (by name) and the
    optimizer step."""
    optimizer: torch.optim.Optimizer
    params: List[Tuple[str, torch.nn.Parameter]]
    step: int = 0


def partition_daclip_params(model: torch.nn.Module):
    """(trainable, frozen) lists of (name, parameter). For a DaCLIP, `clip.*`
    is frozen and set `requires_grad_(False)`; any other model trains
    whole."""
    named = list(model.named_parameters())
    if not isinstance(model, DaCLIP):
        return named, []
    frozen = [(n, p) for n, p in named if n.startswith("clip.")]
    for _, p in frozen:
        p.requires_grad_(False)
    return [(n, p) for n, p in named if not n.startswith("clip.")], frozen


def make_schedule(cfg: ClipTrainConfig) -> Callable[[int], float]:
    if cfg.skip_scheduler:  # main.py:330: no scheduler
        return lambda step: cfg.lr
    if cfg.lr_scheduler == "cosine":
        return sched.clip_cosine_lr(cfg.lr, cfg.warmup, cfg.total_steps)
    if cfg.lr_scheduler == "const":
        return sched.clip_const_lr(cfg.lr, cfg.warmup)
    if cfg.lr_scheduler in ("const-cooldown", "const_cooldown"):
        return sched.clip_const_lr_cooldown(
            cfg.lr, cfg.warmup, cfg.total_steps, cfg.cooldown_steps or cfg.total_steps // 10,
            cooldown_power=cfg.lr_cooldown_power, cooldown_end_lr=cfg.lr_cooldown_end)
    raise ValueError(f"Unknown scheduler {cfg.lr_scheduler!r}; options: cosine, const, "
                     "const-cooldown (main.py:320-330)")


def decays(name: str, p: torch.Tensor) -> bool:
    """Weight decay on ndim ≥ 2 of daclip_tpu's parameter: the stacking axis
    of its stacked modules counted."""
    ndim = 1 if name.endswith("cls_token") else p.ndim  # timm's (1, 1, D) is (D,) there
    return ndim + (1 if _STACKED.search(name) else 0) >= 2


def make_optimizer(named: Sequence[Tuple[str, torch.nn.Parameter]], cfg: ClipTrainConfig,
                   update_mask: Optional[Dict[str, float]] = None) -> torch.optim.AdamW:
    """AdamW with one parameter group per (weight decay, mask value)
    (`decays`), split where FSDP shards sit beside whole tensors
    (`parallel.make_optimizer`); the group's `update_mask` scales its
    learning rate (`locking.apply_update_mask`). The lr is set per step."""
    groups: Dict[Tuple[bool, float], list] = {}
    for name, p in named:
        mask = 1.0 if update_mask is None else float(update_mask[name])
        groups.setdefault((decays(name, p), mask), []).append(p)
    return parallel.make_optimizer(
        torch.optim.AdamW,
        [{"params": ps, "weight_decay": cfg.wd if decay else 0.0, "update_mask": mask}
         for (decay, mask), ps in groups.items()],
        lr=make_schedule(cfg)(0), betas=(cfg.beta1, cfg.beta2), eps=cfg.eps)


def init_state(model: torch.nn.Module, cfg: ClipTrainConfig,
               update_mask: Optional[Dict[str, float]] = None, device=None) -> ClipTrainState:
    """Moves the model to `device` (default CUDA), freezes DaCLIP's CLIP and
    makes the optimizer of the trainable parameters."""
    _on_device(model, device)
    trainable, _ = partition_daclip_params(model)
    return ClipTrainState(make_optimizer(trainable, cfg, update_mask), trainable)


def _bank_tensors(banks, dev):
    if banks is None:
        return None
    return (torch.as_tensor(np.asarray(banks[0]), dtype=torch.float32, device=dev),
            torch.as_tensor(np.asarray(banks[1]), device=dev).long())


def dropout_generator(cfg: ClipTrainConfig, device, step: int,
                      micro: int = 0) -> Optional[torch.Generator]:
    """The patch-dropout noise's generator of optimizer step `step` and
    micro-batch `micro` (None without patch dropout): seeded from both, so
    both passes of an accumulation step draw the same subsets."""
    if not cfg.patch_dropout:
        return None
    g = torch.Generator(device=device)
    g.manual_seed(step * max(cfg.accum_freq, 1) + micro)
    return g


def _forward(model, cfg, banks, batch, include_gt: bool = True, generator=None):
    kw = dict(train=cfg.patch_dropout, generator=generator)
    if cfg.variant == "fork" and banks is not None:
        return model(image=batch["images"], text=batch["texts"],
                     gt_images=batch.get("gt_images") if include_gt else None,
                     deg_type=batch["deg_type"], gt_val=batch["gt_val"],
                     bin_center_bank=banks[0], all_d_type_tokens=banks[1], **kw)
    return model(image=batch["images"], text=batch["texts"], **kw)


def _losses(cfg, banks, out, teacher_out=None) -> Dict[str, torch.Tensor]:
    if cfg.variant == "fork" and banks is not None:
        return daclip_loss_fork(out)
    if cfg.variant == "uir":
        return daclip_loss_uir(out)
    if teacher_out is not None:
        return distill_clip_loss(out["image_features"], out["text_features"],
                                 out["logit_scale"], teacher_out["image_features"],
                                 teacher_out["text_features"], teacher_out["logit_scale"])
    return {"contrastive_loss": clip_loss(out["image_features"], out["text_features"],
                                          out["logit_scale"])}


def _total(losses: Dict[str, torch.Tensor]) -> torch.Tensor:
    return sum(v.float() for v in losses.values())


def _global(out, group):
    """A forward's outputs over the data-parallel group (themselves
    without one)."""
    return out if group is None or out is None else gather_features(out, group)


def _apply(model, state: ClipTrainState, cfg: ClipTrainConfig, schedule) -> torch.Tensor:
    """One optimizer update from the parameters' gradients, as optax's
    chain(clip_by_global_norm, adamw(schedule)) then the update mask; then
    the logit_scale clamp. A parameter the loss did not reach gets a zero
    gradient (optax still decays it). Returns the unclipped global norm
    (of the whole gradient, FSDP shards and TP parts summed)."""
    parallel.finish_grads(model)
    for _, p in state.params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    norm = parallel.grad_norm([p.grad for _, p in state.params])
    if cfg.grad_clip_norm:
        clip_by_global_norm([parallel.local_tensor(p.grad) for _, p in state.params],
                            cfg.grad_clip_norm, norm)
    apply_update_mask(state.optimizer, schedule(state.step))
    state.optimizer.step()
    state.step += 1
    with torch.no_grad():
        parallel.unwrap(model).logit_scale.clamp_(0.0, LOGIT_SCALE_MAX)
    return norm


def _metrics(model, losses, total, norm) -> Dict[str, torch.Tensor]:
    """The step's metrics, the data-parallel group's means under a mesh."""
    metrics = {k: v.detach().float() for k, v in losses.items()}
    metrics["total_loss"] = total.detach()
    metrics["grad_norm"] = norm.detach()
    metrics["logit_scale"] = parallel.unwrap(model).logit_scale.detach().exp()
    group = parallel.data_group(model)
    return metrics if group is None else parallel.all_reduce_mean(metrics, group)


def make_train_step(model: torch.nn.Module, cfg: ClipTrainConfig, banks=None,
                    distill_model: Optional[torch.nn.Module] = None, device=None):
    """Moves the model (and the teacher) to `device` (default CUDA) and
    returns train_step(state, batch) -> (state, metrics). `model` may be
    wrapped by `parallel.parallelize`; the batch is then this rank's rows.

    `banks` = (bin_center_bank (4, 7), all_d_type_tokens (28, L)) arrays
    (the fork variant). `distill_model`: the frozen teacher of the clip
    variant (main.py:219-243). metrics: each loss term, `total_loss`,
    `grad_norm` (unclipped) and `logit_scale` (exp of the clamped value), as
    0-dim tensors on the device."""
    dev = _on_device(model, device)
    if distill_model is not None:
        distill_model.to(dev).requires_grad_(False)
    banks = _bank_tensors(banks, dev)
    schedule = make_schedule(cfg)
    group = parallel.data_group(model)

    def train_step(state: ClipTrainState, batch):
        for key in _BATCH_KEYS:
            _check_device(f"batch[{key!r}]", batch.get(key), dev)
        for _, p in state.params:
            p.grad = None
        out = _forward(model, cfg, banks, batch,
                       generator=dropout_generator(cfg, dev, state.step))
        teacher_out = None
        if cfg.distill and distill_model is not None and cfg.variant == "clip":
            with torch.no_grad():
                teacher_out = distill_model(image=batch["images"], text=batch["texts"])
        losses = _losses(cfg, banks, _global(out, group), _global(teacher_out, group))
        total = _total(losses)
        total.backward()
        norm = _apply(model, state, cfg, schedule)
        return state, _metrics(model, losses, total, norm)

    return train_step


def _per_rank(tensors: Dict[str, torch.Tensor], group) -> List[Dict[str, torch.Tensor]]:
    """Every rank's per-sample `tensors` in rank order, gathered with their
    gradient over `group` (this rank's alone without one)."""
    if group is None:
        return [tensors]
    n = torch.distributed.get_world_size(group)
    gathered = gather_features(tensors, group)
    return [{k: v.chunk(n)[r] for k, v in gathered.items()} for r in range(n)]


def _splice(flat: torch.Tensor, live: Optional[torch.Tensor], j: int, B: int) -> torch.Tensor:
    """The cache `flat` with micro-batch j's rows replaced by `live`."""
    if live is None:  # GT features: the cache's in pass 2
        return flat
    return torch.cat([flat[:j * B], live.to(flat.dtype), flat[(j + 1) * B:]])


def make_accum_train_step(model: torch.nn.Module, cfg: ClipTrainConfig, banks=None,
                          device=None):
    """The reference's gradient accumulation over `cfg.accum_freq`
    micro-batches with global negatives (train.py:124-162):

      pass 1: a no-grad forward of every micro-batch, caching its
              per-sample features;
      pass 2: per micro-batch j, a forward with grad whose live features
              replace block j of the cache, so each micro-batch's loss is
              the loss of the whole accum_freq·B batch, and its backward.

    The summed gradient is the whole batch's for every parameter but
    `logit_scale`, which is live in each pass-2 loss and gets accum_freq×
    its gradient; it is not divided by accum_freq; GT images are encoded
    only in pass 1. One optimizer update per call.

    Under a mesh the first pass's cache is gathered over the data-parallel
    group, each pass-2 micro-batch's live features are gathered with their
    gradient and spliced into every rank's block, and pass 2's backward
    runs under `parallel.no_sync` but for the last micro-batch.

    Returns train_step(state, batches) -> (state, metrics), `batches` a list
    of accum_freq batch dicts; `train_step.loss_and_grads(batches, step)`
    leaves the accumulated gradients in the parameters and returns (total,
    losses) summed over the micro-batches. Distillation is refused, as in the
    reference (train.py:109-121)."""
    if cfg.accum_freq <= 1:
        raise ValueError("make_accum_train_step needs accum_freq > 1; use make_train_step "
                         "otherwise")
    if cfg.distill:
        raise ValueError("distillation + grad accumulation is unsupported, as in the "
                         "reference (train.py:109-121 only distills at accum_freq 1)")
    dev = _on_device(model, device)
    banks = _bank_tensors(banks, dev)
    schedule = make_schedule(cfg)
    params = [p for _, p in partition_daclip_params(parallel.unwrap(model))[0]]
    group = parallel.data_group(model)

    def loss_and_grads(batches, step: int = 0):
        for mb in batches:
            for key in _BATCH_KEYS:
                _check_device(f"batch[{key!r}]", mb.get(key), dev)
        B = batches[0]["images"].shape[0]
        with torch.no_grad():  # pass 1 (train.py:125-135)
            outs = [_forward(model, cfg, banks, mb,
                             generator=dropout_generator(cfg, dev, step, j))
                    for j, mb in enumerate(batches)]
            # the per-sample outputs; the banks' features are the same for
            # every micro-batch and stay live
            cache = {k: torch.cat([o[k] for o in outs])
                     for k in PER_SAMPLE_KEYS if outs[0].get(k) is not None}
            blocks = _per_rank(cache, group)
        del outs
        for p in params:
            p.grad = None
        total, losses = 0.0, {}
        for j, mb in enumerate(batches):  # pass 2 (train.py:148-162)
            with parallel.no_sync(model, enabled=j + 1 < len(batches)):
                out = _forward(model, cfg, banks, mb, include_gt=False,
                               generator=dropout_generator(cfg, dev, step, j))
                lives = _per_rank({k: out[k] for k in cache if out.get(k) is not None}, group)
                spliced = dict(out)
                for k in cache:
                    spliced[k] = torch.cat([_splice(b[k], live.get(k), j, B)
                                            for b, live in zip(blocks, lives)])
                lj = _losses(cfg, banks, spliced)
                tj = _total(lj)
                tj.backward()
            total = total + tj.detach()
            for k, v in lj.items():
                losses[k] = losses.get(k, 0.0) + v.detach().float()
        return total, losses

    def train_step(state: ClipTrainState, batches):
        A = len(batches)
        total, losses = loss_and_grads(batches, state.step)
        norm = _apply(model, state, cfg, schedule)
        return state, _metrics(model, {k: v / A for k, v in losses.items()}, total / A, norm)

    train_step.loss_and_grads = loss_and_grads
    return train_step
