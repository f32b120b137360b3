"""Universal-image-restoration training of the ConditionalUNet, in PyTorch.

Counterpart of `daclip_tpu/train/restoration.py` (reference config/daclip-sde/
models/denoising_model.py:25-201). One step:

  * `IRSDE.generate_random_states`: one t per sample and x_t, from a
    `torch.Generator`,
  * the UNet forward and the maximum-likelihood matching loss (`loss_fn`),
  * the backward pass (kernel backwards on the card),
  * AdamW / Adam / Lion as optax computes them, with an optional global-norm
    clip, the learning rate of the schedule at the step before the update,
  * the EMA of the parameters.

The optimizers follow optax, not torch's defaults (`make_optimizer`). The
entry points (`init_state`, `make_train_step`, `make_sampler`) put the UNet
on `device`, which defaults to CUDA and raises without a GPU unless the
caller passes `device="cpu"`; the step runs eagerly there, and metrics stay
on the device until the caller reads them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from daclip_torch.losses.matching import matching_loss
from daclip_torch.pipeline import resolve_device
from daclip_torch.sde.irsde import IRSDE
from daclip_torch.train import schedules as sched
from daclip_torch.utils.ema import EMA


@dataclasses.dataclass
class RestorationTrainConfig:
    """Mirrors options/train.yml `train:` keys (options.py / train.yml:62-86)."""
    optimizer: str = "AdamW"
    lr_G: float = 2e-4
    lr_scheme: str = "TrueCosineAnnealingLR"
    beta1: float = 0.9
    beta2: float = 0.99
    niter: int = 700_000
    warmup_iter: int = -1
    lr_steps: tuple = (200_000, 400_000, 600_000)
    lr_gamma: float = 0.5
    restarts: tuple = ()
    restart_weights: tuple = ()
    eta_min: float = 1e-6
    weight_decay_G: float = 0.0
    is_weighted: bool = False
    loss_type: str = "l1"
    weight: float = 1.0
    ema_beta: float = 0.995
    ema_update_every: int = 10
    grad_clip: Optional[float] = None


def make_schedule(cfg: RestorationTrainConfig) -> Callable[[int], float]:
    if cfg.lr_scheme == "TrueCosineAnnealingLR":
        s = sched.cosine_annealing(cfg.lr_G, cfg.niter, cfg.eta_min)
    elif cfg.lr_scheme == "MultiStepLR":
        s = sched.multistep_restart(cfg.lr_G, cfg.lr_steps, cfg.lr_gamma, cfg.restarts,
                                    cfg.restart_weights)
    else:
        raise ValueError(f"unknown lr_scheme {cfg.lr_scheme!r}")
    return sched.warmup_override(s, cfg.warmup_iter, cfg.lr_G)


class Lion(torch.optim.Optimizer):
    """optax.lion: c = b1·m + (1−b1)·g;  p −= lr·(sign(c) + wd·p);
    m = b2·m + (1−b2)·g."""

    def __init__(self, params, lr: float = 1e-4, betas=(0.9, 0.99), weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, wd = group["lr"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["exp_avg"] = torch.zeros_like(p)
                m = state["exp_avg"]
                update = torch.sign((1.0 - b1) * p.grad + b1 * m)
                if wd:
                    update = update + wd * p
                p.add_(-lr * update)
                m.copy_((1.0 - b2) * p.grad + b2 * m)


def make_optimizer(params, cfg: RestorationTrainConfig) -> torch.optim.Optimizer:
    """AdamW (also for "Adam": optax's adam is adamw with no decay; eps 1e-8,
    eps_root 0; torch's decoupled decay, applied before the Adam step, is
    optax's) or Lion. The lr is set per step by the train step."""
    name = cfg.optimizer.lower()
    lr = make_schedule(cfg)(0)
    betas = (cfg.beta1, cfg.beta2)
    if name in ("adam", "adamw"):
        return torch.optim.AdamW(params, lr=lr, betas=betas, eps=1e-8,
                                 weight_decay=cfg.weight_decay_G)
    if name == "lion":
        return Lion(params, lr=lr, betas=betas, weight_decay=cfg.weight_decay_G)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def global_norm(grads) -> torch.Tensor:
    """optax.global_norm: √(Σ g²) over every tensor, in f32."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, norm: torch.Tensor) -> None:
    """optax.clip_by_global_norm, in place: g ← g/‖g‖·max_norm when
    ‖g‖ ≥ max_norm, else g unchanged (torch's clip_grad_norm_ divides by
    ‖g‖ + 1e-6 instead)."""
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


@dataclasses.dataclass
class TrainState:
    """The trainer's state beside the UNet's own parameters."""
    optimizer: torch.optim.Optimizer
    ema: EMA
    step: int = 0


def trainable(unet: torch.nn.Module):
    return [(k, p) for k, p in unet.named_parameters() if p.requires_grad]


def _on_device(unet: torch.nn.Module, device) -> torch.device:
    """Moves `unet` to `resolve_device(device)` and returns that device."""
    dev = resolve_device(device)
    unet.to(dev)
    return dev


def _check_device(name: str, t: Optional[torch.Tensor], dev: torch.device) -> None:
    if t is not None and (t.device.type != dev.type or
                          (dev.index is not None and t.device.index != dev.index)):
        raise ValueError(f"{name} is on {t.device}, the UNet on {dev}")


def init_state(unet: torch.nn.Module, cfg: RestorationTrainConfig, device=None) -> TrainState:
    """Moves the UNet to `device` (default CUDA), then makes the optimizer
    and the EMA of its trainable parameters there."""
    _on_device(unet, device)
    named = trainable(unet)
    return TrainState(optimizer=make_optimizer([p for _, p in named], cfg),
                      ema=EMA(named, beta=cfg.ema_beta, update_every=cfg.ema_update_every))


def loss_fn(unet, sde: IRSDE, cfg: RestorationTrainConfig, xt, lq, gt, timesteps,
            text_context=None, image_context=None):
    """The matching loss of one (t, x_t) draw: L1/L2 of the reverse-SDE mean
    step from the predicted noise against the optimal posterior step
    (denoising_model.py:129-150)."""
    noise = unet(xt, lq, timesteps.reshape(-1).float(), text_context, image_context)
    score = sde.get_score_from_noise(noise, timesteps)
    xt_1_exp = sde.reverse_sde_step_mean(xt, score, lq, timesteps)
    xt_1_opt = sde.reverse_optimum_step(xt, gt, lq, timesteps)
    return cfg.weight * matching_loss(xt_1_exp, xt_1_opt, cfg.loss_type)


def apply_gradients(state: TrainState, module: torch.nn.Module, cfg: RestorationTrainConfig,
                    schedule: Callable[[int], float]):
    """One optimizer update from the gradients in `module`'s parameters, as
    optax's chain(clip_by_global_norm, adamw/lion(schedule)) applies it, then
    the EMA. Returns (global norm of the unclipped gradients, lr used)."""
    named = trainable(module)
    grads = [p.grad for _, p in named if p.grad is not None]
    norm = global_norm(grads)
    if cfg.grad_clip:
        clip_by_global_norm(grads, cfg.grad_clip, norm)
    lr = schedule(state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    state.ema.update(named)
    state.step += 1
    return norm, lr


def make_train_step(unet: torch.nn.Module, sde: IRSDE, cfg: RestorationTrainConfig,
                    device=None):
    """Moves the UNet to `device` (default CUDA) and returns
    train_step(state, batch, generator) -> (state, metrics).

    batch: 'LQ', 'GT' (B, 3, H, W) f32 in [0, 1] on that device, and
    optional 'text_context' / 'image_context' (B, D) f32; a tensor elsewhere
    raises. metrics: 'loss', 'grad_norm' (of the unclipped gradients) and
    'lr' (the schedule at the step before the update), as 0-dim tensors or a
    float."""
    dev = _on_device(unet, device)
    schedule = make_schedule(cfg)

    def train_step(state: TrainState, batch, generator: Optional[torch.Generator] = None):
        for key in ("LQ", "GT", "text_context", "image_context"):
            _check_device(f"batch[{key!r}]", batch.get(key), dev)
        lq, gt = batch["LQ"], batch["GT"]
        timesteps, xt = sde.generate_random_states(gt, lq, generator)
        unet.zero_grad(set_to_none=True)
        loss = loss_fn(unet, sde, cfg, xt, lq, gt, timesteps, batch.get("text_context"),
                       batch.get("image_context"))
        loss.backward()
        norm, lr = apply_gradients(state, unet, cfg, schedule)
        return state, {"loss": loss.detach(), "grad_norm": norm.detach(), "lr": lr}

    return train_step


def make_sampler(unet: torch.nn.Module, sde: IRSDE, mode: str = "posterior", device=None):
    """Moves the UNet to `device` (default CUDA) and returns the
    full-resolution restore (lq, generator, contexts) -> output, as
    DenoisingModel.test does (denoising_model.py:152-162); inputs on
    another device raise."""
    dev = _on_device(unet, device)

    @torch.no_grad()
    def sample(lq, generator: Optional[torch.Generator] = None, text_context=None,
               image_context=None):
        ctx = dict(text_context=text_context, image_context=image_context)
        for key, t in dict(lq=lq, **ctx).items():
            _check_device(key, t, dev)
        x_T = sde.noise_state(lq, generator)
        if mode == "sde":
            return sde.reverse_sde(unet, x_T, lq, generator, **ctx)
        if mode == "ode":
            return sde.reverse_ode(unet, x_T, lq, **ctx)
        return sde.reverse_posterior(unet, x_T, lq, generator, **ctx)

    return sample
