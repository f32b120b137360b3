"""Degradation synthesis of the restoration data layer: the noise section.

Counterpart of `daclip_tpu/data/degradations.py:48-58` (`_np_rng`) and
`:294-364` (Gaussian and Poisson noise, reference data/deg_util.py:585-733),
which `GTDataset` needs. Host-side numpy only.

The rest of that module (blur kernels, resizes, JPEG re-encoding and
`random_degrade`, which the MDGT mode draws from) waits: the JAX package
does those with cv2 (ROADMAP queue 1 item 3).
"""
from __future__ import annotations

import random

import numpy as np

from daclip_torch.data.util import bgr2gray


def _np_rng(rng) -> "np.random.RandomState":
    """Numpy generator derived from the caller's python Random, so a seeded
    dataset rng also fixes the numpy draws; with rng=None the global
    np.random is used, as the reference does."""
    if rng is None or rng is random:
        return np.random
    return np.random.RandomState(rng.randrange(2 ** 31))


def _finish(out, clip: bool, rounds: bool) -> np.ndarray:
    if clip and rounds:
        out = np.clip((out * 255.0).round(), 0, 255) / 255.0
    elif clip:
        out = np.clip(out, 0, 1)
    elif rounds:
        out = (out * 255.0).round() / 255.0
    return out.astype(np.float32)


def generate_gaussian_noise(img, sigma=10, gray_noise=False, rng=None):
    nr = _np_rng(rng)
    if gray_noise:
        noise = nr.randn(*img.shape[:2]).astype(np.float32) * sigma / 255.0
        noise = noise[..., None].repeat(3, axis=2) if img.ndim == 3 else noise
    else:
        noise = nr.randn(*img.shape).astype(np.float32) * sigma / 255.0
    return noise


def add_gaussian_noise(img, sigma=10, clip=True, rounds=False, gray_noise=False,
                       rng=None):
    """deg_util.py:585-605; img float in [0, 1]."""
    return _finish(img + generate_gaussian_noise(img, sigma, gray_noise, rng), clip, rounds)


def random_add_gaussian_noise(img, sigma_range=(0, 1.0), gray_prob=0, clip=True,
                              rounds=False, rng=None):
    rng = rng or random
    sigma = rng.uniform(*sigma_range)
    gray = rng.random() < gray_prob
    return add_gaussian_noise(img, sigma, clip, rounds, gray, rng)


def generate_poisson_noise(img, scale=1.0, gray_noise=False, rng=None):
    """deg_util.py:707-733 (basicsr's algorithm)."""
    if gray_noise and img.ndim == 3:
        base = bgr2gray((img * 255).astype(np.uint8)) / 255.0
    else:
        base = img
    base = np.clip((base * 255.0).round(), 0, 255) / 255.0
    vals = len(np.unique(base))
    vals = 2 ** np.ceil(np.log2(vals))
    out = np.float32(_np_rng(rng).poisson(base * vals) / float(vals))
    noise = out - base
    if gray_noise and img.ndim == 3:
        noise = noise[..., None].repeat(3, axis=2)
    return noise * scale


def add_poisson_noise(img, scale=1.0, clip=True, rounds=False, gray_noise=False,
                      rng=None):
    return _finish(img + generate_poisson_noise(img, scale, gray_noise, rng), clip, rounds)


def random_add_poisson_noise(img, scale_range=(0, 1.0), gray_prob=0, clip=True,
                             rounds=False, rng=None):
    rng = rng or random
    scale = rng.uniform(*scale_range)
    gray = rng.random() < gray_prob
    return add_poisson_noise(img, scale, clip, rounds, gray, rng)
