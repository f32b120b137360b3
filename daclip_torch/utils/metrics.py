"""Restored-image rounding, and MATLAB-compatible PSNR/SSIM (+ Y-channel
variants), as the reference evaluates its outputs.

Counterpart of `daclip_tpu/utils/metrics.py` (img_utils.py:136-234; used by
config/daclip-sde/test.py:146-232). The metrics take [0, 255] HWC numpy
arrays in any channel order; the *_y variants take BGR, as the reference
does. SSIM's window is cv2.getGaussianKernel(11, 1.5)'s outer product, and
its 2-D correlation runs over the valid region only (the reference filters
the whole image with cv2.filter2D, then crops 5 pixels a side), here as two
1-D passes in float64 with numpy.
"""
from __future__ import annotations

import math

import numpy as np

from daclip_torch.data.util import bgr2ycbcr


def array2img(arr: np.ndarray, min_max=(0.0, 1.0)) -> np.ndarray:
    """NHWC/HWC RGB float → [0,255] uint8 BGR HWC with tensor2img's rounding."""
    x = np.asarray(arr, np.float32)
    x = np.clip(x, *min_max)
    x = (x - min_max[0]) / (min_max[1] - min_max[0])
    if x.ndim == 4:
        x = x[0]
    if x.ndim == 3 and x.shape[2] == 3:
        x = x[:, :, ::-1]  # RGB → BGR (cv2 convention, like the reference)
    return (x * 255.0).round().astype(np.uint8)


def calculate_psnr(img1: np.ndarray, img2: np.ndarray) -> float:
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float("inf")
    return 20 * math.log10(255.0 / math.sqrt(mse))


def _gaussian_kernel(n: int = 11, sigma: float = 1.5) -> np.ndarray:
    """cv2.getGaussianKernel(n, sigma) as float64."""
    x = np.arange(n) - (n - 1) * 0.5
    t = np.exp(-0.5 / (sigma * sigma) * x * x)
    return t * (1.0 / t.sum())


def _filter_valid(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Correlation of an (H, W[, C]) image with the window outer(k, k) over
    the positions where the window lies inside the image."""
    win = np.lib.stride_tricks.sliding_window_view
    rows = np.moveaxis(win(img, len(k), axis=0), -1, 0)          # (k, H', W, ...)
    img = np.tensordot(k, rows, axes=1)
    cols = np.moveaxis(win(img, len(k), axis=1), -1, 0)
    return np.tensordot(k, cols, axes=1)


def _ssim_single(img1: np.ndarray, img2: np.ndarray) -> float:
    C1 = (0.01 * 255) ** 2
    C2 = (0.03 * 255) ** 2
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    k = _gaussian_kernel()
    mu1 = _filter_valid(img1, k)
    mu2 = _filter_valid(img2, k)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = _filter_valid(img1 ** 2, k) - mu1_sq
    sigma2_sq = _filter_valid(img2 ** 2, k) - mu2_sq
    sigma12 = _filter_valid(img1 * img2, k) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return float(ssim_map.mean())


def calculate_ssim(img1: np.ndarray, img2: np.ndarray) -> float:
    """MATLAB-equivalent SSIM (img_utils.py:185-234); the reference averages
    the full-image SSIM three times for colour inputs, which is that SSIM."""
    if img1.shape != img2.shape:
        raise ValueError("Input images must have the same dimensions.")
    if img1.ndim == 2:
        return _ssim_single(img1, img2)
    if img1.ndim == 3 and img1.shape[2] == 3:
        return _ssim_single(img1, img2)
    if img1.ndim == 3 and img1.shape[2] == 1:
        return _ssim_single(img1[:, :, 0], img2[:, :, 0])
    raise ValueError("Wrong input image dimensions.")


def _y(img_bgr: np.ndarray) -> np.ndarray:
    return bgr2ycbcr(img_bgr.astype(np.float64) / 255.0, only_y=True) * 255.0


def psnr_y(img1_bgr: np.ndarray, img2_bgr: np.ndarray) -> float:
    """PSNR on the Y channel of [0,255] BGR inputs (test.py:183-198)."""
    return calculate_psnr(_y(img1_bgr), _y(img2_bgr))


def ssim_y(img1_bgr: np.ndarray, img2_bgr: np.ndarray) -> float:
    return calculate_ssim(_y(img1_bgr), _y(img2_bgr))
