"""Degradation synthesis of the restoration data layer (reference
data/deg_util.py, a Real-ESRGAN-style second-order pipeline).

Counterpart of `daclip_tpu/data/degradations.py`, with its function names,
signatures, parameter ranges, probabilities and order of random draws:
  kernels   — the PSF bank (`psf_kernel`), bivariate Gaussian / generalized
              Gaussian / plateau kernels, defocus, box, motion line, the 2-D
              sinc and `random_mixed_kernels`, the 10-type mixture
  noise     — Gaussian and Poisson noise
  JPEG, inpainting masks, `degrade` (the four-type parametric degradation of
  `tools/generate_lq`), `match_dim`, `usm_sharp`, the Wiener filter, the
  resizes, `random_blur`, `random_noise` and `random_degrade` (the MDGT
  dataset's three-order pipeline).

Host-side numpy. cv2 (`filter2D`, `resize`, the JPEG codec, `line`,
`GaussianBlur`, `addWeighted`) and scipy (`special.j1`) are imported inside
the calls that need them, never at import; without cv2 those calls raise
`data.util._cv2`'s ImportError. They are not rewritten in numpy, so their
bytes are cv2's own. Each function draws from the caller's
`random.Random` (`rng=None`: the `random` module), and its numpy draws from a
`RandomState` seeded by that Random (`_np_rng`), so a seeded dataset gives
the JAX package's samples byte for byte. `degrade("noisy")` draws from the
global `np.random`, as the JAX package's does.

`psf.pkl` and `inpainting_masks/` are read by path from `daclip_tpu/assets/`.
`ucdpsf.pkl`, the under-display-camera PSF bank, is absent there as it is
upstream, so `under_display_filter` returns its input with a one-time
warning, as the JAX package's does.
"""
from __future__ import annotations

import math
import os
import pathlib
import pickle
import random
import warnings
from typing import Optional, Sequence

import numpy as np

from daclip_torch.data.util import _cv2, bgr2gray

_ASSETS = pathlib.Path(__file__).resolve().parents[2] / "daclip_tpu" / "assets"

# -- kernel bank -------------------------------------------------------------------

_psf_bank = None


def _psf_dictionary():
    global _psf_bank
    if _psf_bank is None:
        with open(_ASSETS / "psf.pkl", "rb") as f:
            _psf_bank = pickle.load(f, encoding="latin1")
    return _psf_bank


def psf_kernel(rng: Optional[random.Random] = None):
    """A real camera-shake PSF from the vendored bank (deg_util.py:448-455)."""
    return (rng or random).choice(_psf_dictionary())


def _np_rng(rng) -> "np.random.RandomState":
    """Numpy generator derived from the caller's python Random, so a seeded
    dataset rng also fixes the numpy draws; with rng=None the global
    np.random is used, as the reference does."""
    if rng is None or rng is random:
        return np.random
    return np.random.RandomState(rng.randrange(2 ** 31))


def mesh_grid(kernel_size: int):
    ax = np.arange(-kernel_size // 2 + 1.0, kernel_size // 2 + 1.0)
    xx, yy = np.meshgrid(ax, ax)
    xy = np.hstack((xx.reshape(kernel_size * kernel_size, 1),
                    yy.reshape(kernel_size * kernel_size, 1))).reshape(
                        kernel_size, kernel_size, 2)
    return xy, xx, yy


def sigma_matrix2(sig_x: float, sig_y: float, theta: float) -> np.ndarray:
    d = np.array([[sig_x ** 2, 0], [0, sig_y ** 2]])
    u = np.array([[np.cos(theta), -np.sin(theta)],
                  [np.sin(theta), np.cos(theta)]])
    return u @ d @ u.T


def pdf2(sigma_matrix: np.ndarray, grid: np.ndarray) -> np.ndarray:
    inverse_sigma = np.linalg.inv(sigma_matrix)
    return np.exp(-0.5 * np.sum(grid @ inverse_sigma * grid, axis=2))


def _sigma(sig_x, sig_y, theta, isotropic):
    if isotropic:
        return np.array([[sig_x ** 2, 0], [0, sig_x ** 2]])
    return sigma_matrix2(sig_x, sig_y, theta)


def _quadratic_form(kernel_size, sig_x, sig_y, theta, grid, isotropic):
    """xᵀ Σ⁻¹ x over the kernel's grid."""
    if grid is None:
        grid, _, _ = mesh_grid(kernel_size)
    inverse_sigma = np.linalg.inv(_sigma(sig_x, sig_y, theta, isotropic))
    return np.sum(grid @ inverse_sigma * grid, axis=2)


def bivariate_Gaussian(kernel_size, sig_x, sig_y, theta, grid=None, isotropic=True):
    if grid is None:
        grid, _, _ = mesh_grid(kernel_size)
    kernel = pdf2(_sigma(sig_x, sig_y, theta, isotropic), grid)
    return kernel / np.sum(kernel)


def bivariate_generalized_Gaussian(kernel_size, sig_x, sig_y, theta, beta, grid=None,
                                   isotropic=True):
    kernel = np.exp(-0.5 * np.power(
        _quadratic_form(kernel_size, sig_x, sig_y, theta, grid, isotropic), beta))
    return kernel / np.sum(kernel)


def bivariate_plateau(kernel_size, sig_x, sig_y, theta, beta, grid=None, isotropic=True):
    kernel = np.reciprocal(np.power(
        _quadratic_form(kernel_size, sig_x, sig_y, theta, grid, isotropic), beta) + 1)
    return kernel / np.sum(kernel)


def _rand_sig_theta(sigma_x_range, sigma_y_range, rotation_range, isotropic, rng):
    sigma_x = rng.uniform(*sigma_x_range)
    if isotropic:
        return sigma_x, sigma_x, 0.0
    return sigma_x, rng.uniform(*sigma_y_range), rng.uniform(*rotation_range)


def _rand_beta(beta_range, rng):
    """β drawn either side of 1 (deg_util.py:222-274)."""
    if rng.random() < 0.5:
        return rng.uniform(beta_range[0], 1)
    return rng.uniform(1, beta_range[1])


def _with_noise(kernel, noise_range, rng):
    """Multiplicative kernel noise (deg_util.py:178-221), renormalised."""
    if noise_range is not None:
        kernel = kernel * _np_rng(rng).uniform(noise_range[0], noise_range[1],
                                              size=kernel.shape)
    return kernel / np.sum(kernel)


def random_bivariate_Gaussian(kernel_size, sigma_x_range, sigma_y_range, rotation_range,
                              noise_range=None, isotropic=True, rng=None):
    rng = rng or random
    sx, sy, th = _rand_sig_theta(sigma_x_range, sigma_y_range, rotation_range, isotropic, rng)
    kernel = bivariate_Gaussian(kernel_size, sx, sy, th, isotropic=isotropic)
    return _with_noise(kernel, noise_range, rng)


def random_bivariate_generalized_Gaussian(kernel_size, sigma_x_range, sigma_y_range,
                                          rotation_range, beta_range, noise_range=None,
                                          isotropic=True, rng=None):
    rng = rng or random
    sx, sy, th = _rand_sig_theta(sigma_x_range, sigma_y_range, rotation_range, isotropic, rng)
    beta = _rand_beta(beta_range, rng)
    kernel = bivariate_generalized_Gaussian(kernel_size, sx, sy, th, beta, isotropic=isotropic)
    return _with_noise(kernel, noise_range, rng)


def random_bivariate_plateau(kernel_size, sigma_x_range, sigma_y_range, rotation_range,
                             beta_range, noise_range=None, isotropic=True, rng=None):
    rng = rng or random
    sx, sy, th = _rand_sig_theta(sigma_x_range, sigma_y_range, rotation_range, isotropic, rng)
    beta = _rand_beta(beta_range, rng)
    kernel = bivariate_plateau(kernel_size, sx, sy, th, beta, isotropic=isotropic)
    return _with_noise(kernel, noise_range, rng)


def defocus_kernel(kernel_size: int, rng=None) -> np.ndarray:
    """Disk kernel (deg_util.py:333-355)."""
    rng = rng or random
    r = rng.uniform(1.0, kernel_size / 2.0)
    _, xx, yy = mesh_grid(kernel_size)
    kernel = ((xx ** 2 + yy ** 2) <= r ** 2).astype(np.float64)
    return kernel / np.sum(kernel)


def box_kernel(kernel_size: int) -> np.ndarray:
    kernel = np.ones((kernel_size, kernel_size), np.float64)
    return kernel / kernel.sum()


def line_kernel(kernel_size: int, angle: float) -> np.ndarray:
    """Motion-line kernel through the center at `angle` degrees, drawn by
    `cv2.line` (the JAX package's stand-in for the reference's
    angle-quantised rasteriser, deg_util.py:364-447)."""
    cv2 = _cv2("line_kernel")
    k = np.zeros((kernel_size, kernel_size), np.float32)
    c = kernel_size // 2
    rad = math.radians(angle)
    dx, dy = math.cos(rad), math.sin(rad)
    half = (kernel_size - 1) / 2
    p1 = (int(round(c - dx * half)), int(round(c - dy * half)))
    p2 = (int(round(c + dx * half)), int(round(c + dy * half)))
    cv2.line(k, p1, p2, 1.0, thickness=1)
    s = k.sum()
    if s == 0:
        k[c, c] = 1.0
        s = 1.0
    return (k / s).astype(np.float64)


def random_line_kernel(kernel_size: int, rng=None) -> np.ndarray:
    rng = rng or random
    return line_kernel(kernel_size, rng.uniform(0, 180))


def circular_lowpass_kernel(cutoff: float, kernel_size: int, pad_to: int = 0):
    """2-D sinc filter (deg_util.py:535-563); kernel_size must be odd."""
    from scipy.special import j1

    if kernel_size % 2 != 1:
        raise ValueError(f"kernel_size must be odd, got {kernel_size}")
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.sqrt(
            (np.arange(kernel_size)[None, :] - (kernel_size - 1) / 2) ** 2
            + (np.arange(kernel_size)[:, None] - (kernel_size - 1) / 2) ** 2)
        kernel = cutoff * j1(cutoff * r) / (2 * np.pi * r)
    kernel[(kernel_size - 1) // 2, (kernel_size - 1) // 2] = cutoff ** 2 / (4 * np.pi)
    kernel = kernel / np.sum(kernel)
    if pad_to > kernel_size:
        pad = (pad_to - kernel_size) // 2
        kernel = np.pad(kernel, ((pad, pad), (pad, pad)))
    return kernel


def _adjust(kernel: np.ndarray, kernel_size: int) -> np.ndarray:
    """A bank kernel padded or center-cropped to kernel_size, renormalised
    (a box when it sums to 0)."""
    k = np.asarray(kernel, np.float64)
    h, w = k.shape
    if h < kernel_size:
        pt = (kernel_size - h) // 2
        k = np.pad(k, ((pt, kernel_size - h - pt), (0, 0)))
    if k.shape[1] < kernel_size:
        pl = (kernel_size - k.shape[1]) // 2
        k = np.pad(k, ((0, 0), (pl, kernel_size - k.shape[1] - pl)))
    h, w = k.shape
    if h > kernel_size:
        t = (h - kernel_size) // 2
        k = k[t: t + kernel_size, :]
    if k.shape[1] > kernel_size:
        left = (k.shape[1] - kernel_size) // 2
        k = k[:, left: left + kernel_size]
    s = k.sum()
    return k / s if s else box_kernel(kernel_size)


def random_mixed_kernels(kernel_list: Sequence[str], kernel_prob: Sequence[float],
                         kernel_size: int = 21, sigma_x_range=(0.6, 5), sigma_y_range=(0.6, 5),
                         rotation_range=(-math.pi, math.pi), betag_range=(0.5, 8),
                         betap_range=(0.5, 8), noise_range=None, rng=None) -> np.ndarray:
    """Kernel-zoo dispatcher (deg_util.py:457-533)."""
    rng = rng or random
    kernel_type = rng.choices(list(kernel_list), weights=list(kernel_prob))[0]
    sig = (kernel_size, sigma_x_range, sigma_y_range, rotation_range)
    if kernel_type in ("iso", "aniso"):
        return random_bivariate_Gaussian(*sig, noise_range, kernel_type == "iso", rng)
    if kernel_type in ("generalized_iso", "generalized_aniso"):
        return random_bivariate_generalized_Gaussian(
            *sig, betag_range, noise_range, kernel_type == "generalized_iso", rng)
    if kernel_type in ("plateau_iso", "plateau_aniso"):
        return random_bivariate_plateau(*sig, betap_range, None,
                                        kernel_type == "plateau_iso", rng)
    if kernel_type == "defocus":
        return defocus_kernel(kernel_size, rng)
    if kernel_type == "box":
        return box_kernel(kernel_size)
    if kernel_type == "line":
        return random_line_kernel(kernel_size, rng)
    if kernel_type == "psf":
        return _adjust(psf_kernel(rng), kernel_size)
    raise ValueError(f"unknown kernel type {kernel_type!r}")


# -- noise -------------------------------------------------------------------------

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


# -- JPEG --------------------------------------------------------------------------

def add_jpg_compression(img, quality=90):
    """deg_util.py:880-897: img float [0, 1] HWC through cv2's JPEG codec."""
    cv2 = _cv2("add_jpg_compression")
    img = np.clip(img, 0, 1)
    encode_param = [int(cv2.IMWRITE_JPEG_QUALITY), int(quality)]
    _, encimg = cv2.imencode(".jpg", (img * 255.0).astype(np.uint8), encode_param)
    return np.float32(cv2.imdecode(encimg, 1)) / 255.0


def random_add_jpg_compression(img, quality_range=(90, 100), rng=None):
    rng = rng or random
    return add_jpg_compression(img, rng.uniform(*quality_range))


# -- inpainting mask ---------------------------------------------------------------

def add_random_mask(img, size=None, mask_root: Optional[str] = None, mask_id: int = -1,
                    n: int = 100, rng=None):
    """deg_util.py:921-936: mask·img + (1 − mask), a mask of the vendored
    bank (`mask_id`, or drawn from the first `n`) resized with INTER_AREA to
    the image, or to `size` and then randomly cropped to the image."""
    cv2 = _cv2("add_random_mask")
    rng = rng or random
    if mask_root is None:
        mask_root = str(_ASSETS / "inpainting_masks")
    if mask_id < 0:
        mask_id = rng.randrange(n)
    mask = cv2.imread(os.path.join(mask_root, f"{mask_id:06d}.png")) / 255.0
    if size is None:
        mask = cv2.resize(mask, (img.shape[1], img.shape[0]), interpolation=cv2.INTER_AREA)
    else:
        mask = cv2.resize(mask, (size[1], size[0]), interpolation=cv2.INTER_AREA)
        rnd_h = rng.randint(0, max(0, size[0] - img.shape[0]))
        rnd_w = rng.randint(0, max(0, size[1] - img.shape[1]))
        mask = mask[rnd_h: rnd_h + img.shape[0], rnd_w: rnd_w + img.shape[1]]
    return mask * img + (1.0 - mask)


# -- single-parameter degradation (the generate_lq grids) ---------------------------

def degrade(img, deg_type: str, param: float = 15, rng=None):
    """deg_util.py:938-966: the four-type parametric degradation of the
    offline LQ generator. "noisy" draws from the global np.random."""
    rng = rng or random
    if deg_type == "noisy":
        return add_gaussian_noise(img, sigma=param)
    if deg_type == "blur":
        # the reference's level is the Gaussian's sigma on a fixed 21 × 21
        # grid (deg_util.py:199-211)
        kernel = bivariate_Gaussian(21, float(param), float(param), 0.0, isotropic=True)
        return _cv2("degrade('blur')").filter2D(img, -1, kernel)
    if deg_type == "jpeg":
        return add_jpg_compression(img, param)
    if deg_type == "resize":
        h, w, _ = img.shape
        hs, ws = int(h / param), int(w / param)
        out = random_resize(img, hs, ws, rng=rng)
        out = random_resize(out, 512, 512, rng=rng)
        return np.clip((out * 255.0).round(), 0, 255) / 255.0
    raise ValueError(f"unknown degradation {deg_type!r}")


# -- dimension matching (deg_util.py:1032-1115) -------------------------------------

def pad_edges(data, dim):
    dh = max(dim[0] - data.shape[0], 0)
    dw = max(dim[1] - data.shape[1], 0)
    pads = ((dh // 2, dh - dh // 2), (dw // 2, dw - dw // 2))
    if data.ndim == 3:
        pads = pads + ((0, 0),)
    return np.pad(data, pads, mode="reflect")


def center_crop(data, dim):
    t = max((data.shape[0] - dim[0]) // 2, 0)
    left = max((data.shape[1] - dim[1]) // 2, 0)
    return data[t: t + dim[0], left: left + dim[1]]


def random_crop_np(data, dim, rng=None):
    rng = rng or random
    t = rng.randint(0, max(data.shape[0] - dim[0], 0))
    left = rng.randint(0, max(data.shape[1] - dim[1], 0))
    return data[t: t + dim[0], left: left + dim[1]]


def match_dim(data, dim, crop_mode: str = "random", rng=None):
    """Crop or reflect-pad to (H, W) without resampling (deg_util.py:1032-1053)."""
    if data.shape[0] < dim[0] or data.shape[1] < dim[1]:
        data = pad_edges(data, dim[:2])
    if data.shape[0] > dim[0] or data.shape[1] > dim[1]:
        data = (random_crop_np(data, dim, rng) if crop_mode == "random"
                else center_crop(data, dim[:2]))
    return data


# -- filters -----------------------------------------------------------------------

def usm_sharp(img, weight=0.5, radius=50, threshold=10):
    """Unsharp masking (deg_util.py:972-1001)."""
    cv2 = _cv2("usm_sharp")
    radius = img.shape[0] // 10 if img.shape[0] < 500 else radius
    if radius % 2 == 0:
        radius += 1
    blur = cv2.GaussianBlur(img, (radius, radius), 0)
    residual = img - blur
    mask = (np.abs(residual) * 255 > threshold).astype("float32")
    soft_mask = cv2.GaussianBlur(mask, (radius, radius), 0)
    sharp = np.clip(img + weight * residual, 0, 1)
    return soft_mask * sharp + (1 - soft_mask) * img


def wiener_filter(channel, kernel, K=0.006, pad_s=20):
    """FFT Wiener deconvolution of one channel (deg_util.py:1003-1017)."""
    ch = np.pad(channel, pad_s, mode="edge")
    kpad = np.zeros_like(ch)
    kh, kw = kernel.shape
    kpad[:kh, :kw] = kernel
    kpad = np.roll(kpad, (-(kh // 2), -(kw // 2)), axis=(0, 1))
    Kf = np.fft.fft2(kpad)
    H = np.conj(Kf) / (np.abs(Kf) ** 2 + K)
    out = np.real(np.fft.ifft2(np.fft.fft2(ch) * H))
    return out[pad_s:-pad_s, pad_s:-pad_s]


def wiener_filter_multi_channel(img, kernel, K=0.006, pad_s=20):
    chans = [wiener_filter(img[:, :, c], kernel, K, pad_s) for c in range(img.shape[2])]
    return np.clip(np.stack(chans, axis=2), 0, 1).astype(np.float32)


_warned_ucd = False


def under_display_filter(img):
    """Under-display-camera PSF blur (deg_util.py:1129-1142); without
    `ucdpsf.pkl` (absent upstream too) it returns `img`, warning once."""
    global _warned_ucd
    path = _ASSETS / "ucdpsf.pkl"
    if not path.exists():
        if not _warned_ucd:
            warnings.warn("ucdpsf.pkl missing (also missing upstream); "
                          "under_display_filter is a no-op")
            _warned_ucd = True
        return img
    with open(path, "rb") as f:
        bank = pickle.load(f, encoding="latin1")
    kernel = random.choice(bank)
    return _cv2("under_display_filter").filter2D(img, -1, np.asarray(kernel) / np.sum(kernel))


# -- resize family ------------------------------------------------------------------

def doule_resize(img, s=1.1):
    """Up by `s` and back, bicubic (the reference's name kept)."""
    cv2 = _cv2("doule_resize")
    h, w, _ = img.shape
    resized = cv2.resize(img, (int(w * s), int(h * s)), interpolation=cv2.INTER_CUBIC)
    return cv2.resize(resized, (w, h), interpolation=cv2.INTER_CUBIC)


def random_resize(img, hs=None, ws=None, rng=None):
    """Resize to (hs, ws), or by a factor in [1/1.4, 2] when either is None,
    with area, bicubic or bilinear interpolation drawn from `rng`."""
    cv2 = _cv2("random_resize")
    rng = rng or random
    if hs is None or ws is None:
        h, w, _ = img.shape
        s = rng.uniform(0.5, 1.4)
        hs, ws = int(h / s), int(w / s)
    interpolation = rng.choice([cv2.INTER_AREA, cv2.INTER_CUBIC, cv2.INTER_LINEAR])
    out = cv2.resize(img, (int(ws), int(hs)), interpolation=interpolation)
    if out.ndim == 2:
        out = out[:, :, None]
    return out


def predefined_mixed_kernel(kernel_size=21, blur_range=(0.2, 2.2), rng=None):
    """deg_util.py:1160-1166: the production 10-type kernel mixture."""
    return random_mixed_kernels(
        ["iso", "aniso", "generalized_iso", "generalized_aniso", "plateau_iso",
         "plateau_aniso", "defocus", "box", "line", "psf"],
        [0.35, 0.2, 0.1, 0.03, 0.1, 0.03, 0.1, 0.03, 0.03, 0.03],
        kernel_size=kernel_size, sigma_x_range=tuple(blur_range),
        sigma_y_range=tuple(blur_range), betag_range=(0.5, 2),
        betap_range=(1, 1.5), noise_range=(0.9, 1.1), rng=rng)


def predefined_sinc_kernel(kernel_size=21, rng=None):
    rng = rng or random
    if kernel_size < 13:
        omega_c = rng.uniform(np.pi / 3, np.pi)
    else:
        omega_c = rng.uniform(np.pi / 5, np.pi)
    return circular_lowpass_kernel(omega_c, kernel_size, pad_to=0)


def random_blur(img, max_radius=10, sinc_prob=0.1, deblur_prob=0.1, blur_range=(0.2, 2.2),
                deg_list=None, rng=None):
    """deg_util.py:1175-1197: a sinc or mixed kernel of odd size 5 to
    2·max_radius − 1, then, rarely, a Wiener deblur and a blend."""
    cv2 = _cv2("random_blur")
    rng = rng or random
    kernel_range = [2 * v + 1 for v in range(2, max_radius)]
    kernel_size = rng.choice(kernel_range)
    sinc_flag = rng.random() < sinc_prob
    kernel = (predefined_sinc_kernel(kernel_size, rng) if sinc_flag
              else predefined_mixed_kernel(kernel_size, blur_range, rng))
    img = cv2.filter2D(img, -1, kernel)
    ori_img = img
    if deg_list is not None:
        deg_list.add("blur")
    if not sinc_flag and rng.random() < deblur_prob and kernel_size < 8:
        img = wiener_filter_multi_channel(img, kernel).astype(ori_img.dtype)
        if rng.random() < 0.1:
            p = rng.uniform(0.1, 0.5)
            img = cv2.addWeighted(ori_img, p, img, 1 - p, 0)
    return img


def random_noise(img, gauss_prob=0.6, rng=None):
    """deg_util.py:1199-1210: Gaussian and/or Poisson noise, then 8-bit
    quantisation (float64 out)."""
    rng = rng or random
    if rng.random() < gauss_prob:
        img = random_add_gaussian_noise(img, sigma_range=(1, 5), gray_prob=0.4, rng=rng)
    if rng.random() < 1 - gauss_prob:
        img = random_add_poisson_noise(img, scale_range=(0.01, 0.5), gray_prob=0.4, rng=rng)
    img = np.clip((img * 255.0).round(), 0, 255).astype(np.uint8)
    return img / 255.0


def random_degrade(img, blur_prob=0.8, resize_prob=0.8, noise_prob=0.4, jpeg_prob=0.4,
                   deg_list=None, rng=None):
    """The three-order random degradation pipeline (deg_util.py:1215-1273):
    three stage permutations from one numpy generator, the resize flag, then
    each stage's draws in order; the output has the input's (H, W)."""
    rng = rng or random
    if deg_list is None:
        deg_list = set()
    h, w, _ = img.shape
    img = np.asarray(img, np.float32)

    nr = _np_rng(rng)
    first = nr.permutation(["blur", "resize", "noise", "jpeg"])
    second = nr.permutation(["blur", "noise"])
    third = nr.permutation(["blur", "resize", "jpeg"])
    resize_flag = rng.random() < resize_prob

    for deg_type in first:
        if deg_type == "blur":
            if rng.random() < blur_prob:
                img = random_blur(img, 10, 0.1, 0.1, (0.2, 2.2), deg_list, rng)
            elif rng.random() < 0.2:
                img = under_display_filter(img)
        elif deg_type == "resize" and resize_flag:
            deg_list.add("resize")
            img = random_resize(img, rng=rng)
        elif deg_type == "noise" and rng.random() < noise_prob:
            deg_list.add("noise")
            img = random_noise(img.astype("float32"), rng=rng)
        elif deg_type == "jpeg" and rng.random() < jpeg_prob:
            deg_list.add("jpeg")
            img = random_add_jpg_compression(img, (60, 95), rng)

    for deg_type in second:
        if deg_type == "blur":
            if rng.random() < blur_prob * 0.5:
                img = random_blur(img, 5, 0.1, 0.1, (0.2, 1.5), deg_list, rng)
            elif rng.random() < 0.2:
                img = under_display_filter(img)
        elif deg_type == "noise" and rng.random() < noise_prob * 0.5:
            deg_list.add("noise")
            img = random_noise(img.astype("float32"), rng=rng)

    for deg_type in third:
        if deg_type == "blur" and rng.random() < blur_prob:
            img = random_blur(img, 10, 0.8, 0.1, (0.2, 1.0), deg_list, rng)
        elif deg_type == "resize" and resize_flag:
            deg_list.add("resize")
            img = random_resize(img, hs=h, ws=w, rng=rng)
        elif deg_type == "jpeg" and rng.random() < jpeg_prob:
            deg_list.add("jpeg")
            img = random_add_jpg_compression(img, (80, 100), rng)

    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    return np.clip((img * 255.0).round(), 0, 255) / 255.0
