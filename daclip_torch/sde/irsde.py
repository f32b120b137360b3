"""IR-SDE: mean-reverting SDE for image restoration, in PyTorch.

Counterpart of `daclip_tpu/sde/irsde.py` (reference `sde_utils.py:80-377`).
The schedule tables are built once on the host in float64 (`make_schedule`)
and looked up per step; the reverse samplers are plain Python loops over t.
Per-step noise comes from an explicit `torch.Generator`, or from an explicit
`noises` bank (the deterministic hook the golden-fixture replay uses).

Every step function takes t as a Python int (the samplers' path, a float32
scalar per table entry) or as an int64 tensor broadcastable against the
state, typically (B, 1, 1, 1) (the training path, one t per sample), which
gathers from float32 copies of the tables on t's device — as the JAX
package's `jnp.take` reads them.

Tensors are NCHW; the UNet behind `noise_fn` takes NCHW as well.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


class Schedule(NamedTuple):
    """Precomputed IR-SDE schedule tables, each of length T+1 (t runs 1..T)."""

    thetas: np.ndarray
    sigmas: np.ndarray
    thetas_cumsum: np.ndarray
    sigma_bars: np.ndarray
    dt: float
    max_sigma: float
    post_term1: np.ndarray
    post_term2: np.ndarray
    post_std: np.ndarray
    exp_theta_cumsum_dt: np.ndarray
    weights: np.ndarray


def make_schedule(max_sigma: float, T: int, schedule: str = "cosine",
                  eps: float = 0.005) -> Schedule:
    """θ/σ tables in float64, cast as `daclip_tpu.sde.irsde.make_schedule`
    casts them (the posterior tables and θ to float32, σ/θ̄/σ̄ stay f64)."""
    if schedule == "constant":
        thetas = np.ones(T + 1, dtype=np.float64)
    elif schedule == "linear":
        scale = 1000.0 / (T + 1)
        thetas = np.linspace(scale * 0.0001, scale * 0.02, T + 1, dtype=np.float64)
    elif schedule == "cosine":
        s = 0.008
        timesteps = T + 2
        x = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64)
        alphas_cumprod = np.cos(((x / timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
        alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
        thetas = (1 - alphas_cumprod[1:-1]).astype(np.float64)
    else:
        raise ValueError(f"unknown schedule {schedule!r}")

    sigmas = np.sqrt(max_sigma ** 2 * 2 * thetas)
    thetas_cumsum = np.cumsum(thetas) - thetas[0]
    dt = float(-1.0 / thetas_cumsum[-1] * math.log(eps))
    sigma_bars = np.sqrt(max_sigma ** 2 * (1 - np.exp(-2 * thetas_cumsum * dt)))

    # A=e^{-θ_t dt}, B=e^{-θ̄_t dt}, C=e^{-θ̄_{t-1} dt} (C is rounded to f32
    # exactly as the JAX tables round it)
    A = np.exp(-thetas * dt)
    B = np.exp(-thetas_cumsum * dt)
    C = np.concatenate([[1.0], B[:-1]]).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        denom = 1 - B ** 2
        post_term1 = np.where(denom > 0, A * (1 - C ** 2) / denom, 0.0)
        post_term2 = np.where(denom > 0, C * (1 - A ** 2) / denom, 0.0)
        var = np.where(denom > 0, (1 - A ** 2) * (1 - C ** 2) / denom, 0.0)
    post_std = np.exp(0.5 * np.log(np.clip(var, 1e-20 * dt, None))) * max_sigma

    return Schedule(
        thetas=thetas.astype(np.float32),
        sigmas=sigmas,
        thetas_cumsum=thetas_cumsum,
        sigma_bars=sigma_bars,
        dt=dt,
        max_sigma=float(max_sigma),
        post_term1=post_term1.astype(np.float32),
        post_term2=post_term2.astype(np.float32),
        post_std=post_std.astype(np.float32),
        exp_theta_cumsum_dt=np.exp(thetas_cumsum * dt).astype(np.float32),
        weights=np.exp(-thetas_cumsum * dt).astype(np.float32),
    )


# noise_fn(x, mu, t_float_batch, **ctx) -> predicted noise, same shape as x
NoiseFn = Callable[..., torch.Tensor]


class IRSDE:
    """IR-SDE sampler. `max_sigma >= 1` is a 0-255-scale sigma and is divided
    by 255 (sde_utils.py:86). The state stays float32 throughout."""

    def __init__(self, max_sigma: float, T: int = 100, sample_T: int = -1,
                 schedule: str = "cosine", eps: float = 0.005):
        self.T = int(T)
        self.max_sigma = max_sigma / 255.0 if max_sigma >= 1 else float(max_sigma)
        self.sample_T = self.T if sample_T < 0 else int(sample_T)
        self.sample_scale = self.T / self.sample_T
        self.schedule_name = schedule
        self.eps = eps
        self.np_schedule = make_schedule(self.max_sigma, self.sample_T, schedule, eps)
        self.dt = self.np_schedule.dt
        self._dt32 = float(np.float32(self.dt))
        # per-step scalars as f32 Python floats: the JAX sampler reads each
        # table entry as a float32 value and multiplies in float32
        self._s = {k: [float(np.float32(x)) for x in v]
                   for k, v in self.np_schedule._asdict().items()
                   if isinstance(v, np.ndarray)}
        self._tables = {}  # device → {name: f32 tensor}

    def _at(self, name: str, t):
        """Table entry at t: a float for an int t, a float32 tensor of t's
        shape, on t's device, for a tensor t."""
        if not torch.is_tensor(t):
            return self._s[name][t]
        if t.dtype != torch.int64:
            raise TypeError(f"IRSDE takes t as an int or an int64 tensor, got {t.dtype}")
        tables = self._tables.get(t.device)
        if tables is None:
            tables = {k: torch.tensor(v, dtype=torch.float32, device=t.device)
                      for k, v in self._s.items()}
            self._tables[t.device] = tables
        return tables[name][t]

    # -- forward-process quantities ---------------------------------------------
    def mu_bar(self, mu, x0, t):
        return mu + (x0 - mu) * self._at("weights", t)

    def get_real_noise(self, xt, x0, mu, t):
        """(x_t - μ̄_t(x_0)) / σ̄_t (sde_utils.py:239-240)."""
        return (xt - self.mu_bar(mu, x0, t)) / self._at("sigma_bars", t)

    def get_score_from_noise(self, noise, t):
        return -noise / self._at("sigma_bars", t)

    def get_init_state_from_noise(self, xt, noise, mu, t):
        """x̂_0 = (x_t - μ - σ̄_t ε̂) e^{θ̄_t dt} + μ (sde_utils.py:245-247)."""
        return ((xt - mu - self._at("sigma_bars", t) * noise)
                * self._at("exp_theta_cumsum_dt", t) + mu)

    # -- single-step updates --------------------------------------------------
    def reverse_sde_step_mean(self, x, score, mu, t):
        return x - (self._at("thetas", t) * (mu - x)
                    - self._at("sigmas", t) ** 2 * score) * self._dt32

    def reverse_ode_step(self, x, score, mu, t):
        return x - (self._at("thetas", t) * (mu - x)
                    - 0.5 * self._at("sigmas", t) ** 2 * score) * self._dt32

    def reverse_optimum_step(self, xt, x0, mu, t):
        """Optimal posterior mean of x_{t-1} given (x_t, x_0) (sde_utils.py:205-213)."""
        return (self._at("post_term1", t) * (xt - mu)
                + self._at("post_term2", t) * (x0 - mu) + mu)

    def reverse_optimum_std(self, t):
        return self._at("post_std", t)

    def reverse_posterior_step(self, xt, noise, mu, t, z):
        x0 = self.get_init_state_from_noise(xt, noise, mu, t)
        return self.reverse_optimum_step(xt, x0, mu, t) + self.reverse_optimum_std(t) * z

    # -- training-state sampling ----------------------------------------------
    def generate_random_states(self, x0, mu, generator: Optional[torch.Generator] = None,
                               timesteps=None, T_start: int = 1, T_end: int = -1):
        """Sample (t, x_t) pairs for training (sde_utils.py:356-372): t
        uniform in [T_start, sample_T] (or [T_start, T_end]) per sample as an
        int64 (B, 1, 1, 1) tensor, x_t = ε·σ̄_t + μ̄_t(x0) in float32, with t
        and ε drawn from `generator`."""
        if timesteps is None:
            hi = self.sample_T + 1 if T_end <= 1 else T_end + 1
            timesteps = torch.randint(T_start, hi, (x0.shape[0],) + (1,) * (x0.dim() - 1),
                                      generator=generator, device=x0.device)
        state_mean = self.mu_bar(mu, x0, timesteps)
        noises = torch.randn(state_mean.shape, generator=generator, dtype=torch.float32,
                             device=x0.device)
        return timesteps, (noises * self._at("sigma_bars", timesteps) + state_mean).float()

    def forward(self, x0, mu, generator: Optional[torch.Generator] = None, T: int = -1):
        """Forward simulation of the SDE from x0 over t = 1..T, Euler-Maruyama
        (diagnostics; sde_utils.py:38-39, 50-56)."""
        T = self.T if T < 0 else T
        sqrt_dt = math.sqrt(self.dt)
        x = x0
        for t in range(1, T + 1):
            drift = self._at("thetas", t) * (mu - x) * self._dt32
            x = x + drift + self._at("sigmas", t) * sqrt_dt * self._randn(x, generator)
        return x

    # -- initial state -------------------------------------------------------
    def noise_state(self, tensor: torch.Tensor,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Test-time init: x_T = LQ + σ_max ε (sde_utils.py:374-376)."""
        eps = torch.randn(tensor.shape, generator=generator, dtype=tensor.dtype,
                          device=tensor.device)
        return tensor + eps * self.max_sigma

    # -- full reverse samplers ---------------------------------------------------
    def _steps(self, T: Optional[int]):
        T = self.sample_T if T is None or T < 0 else T
        return range(T, 0, -1)

    def _tb(self, x, t: int):
        return torch.full((x.shape[0],), t * self.sample_scale,
                          dtype=torch.float32, device=x.device)

    def _randn(self, x, generator):
        return torch.randn(x.shape, generator=generator, dtype=x.dtype,
                           device=x.device)

    def reverse_sde(self, noise_fn: NoiseFn, xt, mu,
                    generator: Optional[torch.Generator] = None, T: int = -1,
                    **ctx):
        """Euler-Maruyama reverse SDE (sde_utils.py:261-277)."""
        sqrt_dt = math.sqrt(self.dt)
        x = xt
        for t in self._steps(T):
            score = self.get_score_from_noise(noise_fn(x, mu, self._tb(x, t), **ctx), t)
            z = self._randn(x, generator)
            x = (self.reverse_sde_step_mean(x, score, mu, t)
                 - self._at("sigmas", t) * sqrt_dt * z)
        return x

    def reverse_ode(self, noise_fn: NoiseFn, xt, mu, T: int = -1, **ctx):
        """Probability-flow ODE (sde_utils.py:279-295)."""
        x = xt
        for t in self._steps(T):
            score = self.get_score_from_noise(noise_fn(x, mu, self._tb(x, t), **ctx), t)
            x = self.reverse_ode_step(x, score, mu, t)
        return x

    def reverse_posterior(self, noise_fn: NoiseFn, xt, mu,
                          generator: Optional[torch.Generator] = None,
                          T: int = -1, noises: Optional[torch.Tensor] = None,
                          **ctx):
        """Default sampler: posterior-mean steps (sde_utils.py:297-313).

        `noises`: optional explicit per-step gaussian bank of shape
        (T, *x.shape), indexed noises[t-1] for step t."""
        x = xt
        for t in self._steps(T):
            noise = noise_fn(x, mu, self._tb(x, t), **ctx)
            if noises is not None:
                z = noises[t - 1].to(device=x.device, dtype=x.dtype)
            else:
                z = self._randn(x, generator)
            x = self.reverse_posterior_step(x, noise, mu, t, z)
        return x

    def optimal_reverse(self, xt, x0, mu, T: int = -1):
        """Oracle posterior rollout given the true x0 (sde_utils.py:342-348)."""
        x = xt
        for t in self._steps(T):
            x = self.reverse_optimum_step(x, x0, mu, t)
        return x
