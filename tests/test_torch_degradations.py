"""daclip_torch's degradation synthesis against daclip_tpu's on the CPU, byte
for byte on one machine (both call the same cv2): every kernel builder
(hypothesis-drawn sizes, sigmas, betas, angles and seeds), `degrade` at two
levels of each type, the random blur, noise and resize, `random_degrade`
over 64 seeds on three shapes with its `deg_list`, the filters, JPEG,
`match_dim` and the inpainting masks."""
import builtins
import math
import random
import sys
import warnings

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from daclip_torch.data import degradations as tdeg
from daclip_tpu.data import degradations as jdeg

torch.set_num_threads(1)
HYP = settings(max_examples=60, deadline=None, derandomize=True, database=None)

SIZES = st.integers(3, 10).map(lambda v: 2 * v + 1)  # odd, 7 to 21
SIGMAS = st.floats(0.2, 5.0)
BETAS = st.floats(0.5, 8.0)
ANGLES = st.floats(-math.pi, math.pi)
SEEDS = st.integers(0, 2 ** 31 - 1)


def _same(a, b):
    """Equal dtype, shape and bytes (0 ULP)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _img(seed, h, w, c=3):
    return np.random.RandomState(seed).rand(h, w, c).astype(np.float32)


@HYP
@given(SIZES, SIGMAS, SIGMAS, ANGLES, BETAS, st.booleans())
def test_bivariate_kernels_equal_jax(k, sx, sy, theta, beta, isotropic):
    _same(tdeg.mesh_grid(k)[0], jdeg.mesh_grid(k)[0])
    _same(tdeg.sigma_matrix2(sx, sy, theta), jdeg.sigma_matrix2(sx, sy, theta))
    args = (k, sx, sy, theta)
    _same(tdeg.bivariate_Gaussian(*args, isotropic=isotropic),
          jdeg.bivariate_Gaussian(*args, isotropic=isotropic))
    _same(tdeg.bivariate_generalized_Gaussian(*args, beta, isotropic=isotropic),
          jdeg.bivariate_generalized_Gaussian(*args, beta, isotropic=isotropic))
    _same(tdeg.bivariate_plateau(*args, beta, isotropic=isotropic),
          jdeg.bivariate_plateau(*args, beta, isotropic=isotropic))


@HYP
@given(SIZES, SEEDS, st.booleans(), st.booleans())
def test_random_kernels_equal_jax(k, seed, isotropic, noisy):
    noise = (0.9, 1.1) if noisy else None
    for name, extra in (("random_bivariate_Gaussian", ()),
                        ("random_bivariate_generalized_Gaussian", ((0.5, 8),)),
                        ("random_bivariate_plateau", ((0.5, 8),))):
        t, j = random.Random(seed), random.Random(seed)
        args = (k, (0.6, 5), (0.6, 5), (-math.pi, math.pi), *extra, noise, isotropic)
        _same(getattr(tdeg, name)(*args, rng=t), getattr(jdeg, name)(*args, rng=j))
        assert t.random() == j.random()
    t, j = random.Random(seed), random.Random(seed)
    _same(tdeg.defocus_kernel(k, t), jdeg.defocus_kernel(k, j))
    _same(tdeg.random_line_kernel(k, t), jdeg.random_line_kernel(k, j))
    _same(tdeg.predefined_sinc_kernel(k, t), jdeg.predefined_sinc_kernel(k, j))
    _same(tdeg.predefined_mixed_kernel(k, (0.2, 2.2), t),
          jdeg.predefined_mixed_kernel(k, (0.2, 2.2), j))
    assert t.random() == j.random()


@HYP
@given(SIZES, st.floats(0.0, 180.0), st.floats(0.3, math.pi), st.integers(0, 10))
def test_line_box_and_sinc_kernels_equal_jax(k, angle, cutoff, extra):
    _same(tdeg.line_kernel(k, angle), jdeg.line_kernel(k, angle))
    _same(tdeg.box_kernel(k), jdeg.box_kernel(k))
    pad = k + 2 * extra
    _same(tdeg.circular_lowpass_kernel(cutoff, k, pad), jdeg.circular_lowpass_kernel(cutoff, k,
                                                                                   pad))


@pytest.mark.parametrize("kind", ["iso", "aniso", "generalized_iso", "generalized_aniso",
                                  "plateau_iso", "plateau_aniso", "defocus", "box", "line",
                                  "psf"])
@pytest.mark.parametrize("k", [7, 13, 21])
def test_each_mixed_kernel_type_and_the_psf_bank_equal_jax(kind, k):
    for seed in range(6):
        t, j = random.Random(seed), random.Random(seed)
        _same(tdeg.random_mixed_kernels([kind], [1.0], k, noise_range=(0.9, 1.1), rng=t),
              jdeg.random_mixed_kernels([kind], [1.0], k, noise_range=(0.9, 1.1), rng=j))
        assert t.random() == j.random()
    if kind == "psf":  # every bank kernel, padded and cropped
        bank = tdeg._psf_dictionary()
        assert len(bank) == len(jdeg._psf_dictionary())
        for kernel in bank.values():
            _same(tdeg._adjust(kernel, k), jdeg._adjust(kernel, k))


def test_unknown_kernel_and_even_sinc_raise():
    with pytest.raises(ValueError, match="unknown kernel"):
        tdeg.random_mixed_kernels(["nope"], [1.0], 7, rng=random.Random(0))
    with pytest.raises(ValueError, match="odd"):
        tdeg.circular_lowpass_kernel(1.0, 8)
    with pytest.raises(ValueError, match="unknown degradation"):
        tdeg.degrade(_img(0, 8, 8), "rain")


@pytest.mark.parametrize("deg_type,levels", [("noisy", (5, 35)), ("blur", (0.5, 3.2)),
                                             ("jpeg", (10, 70)), ("resize", (0.7, 3.5))])
def test_degrade_equals_jax(deg_type, levels):
    img = _img(1, 61, 77).astype(np.float64)
    for level in levels:
        np.random.seed(11)  # "noisy" draws from the global np.random in both
        j = jdeg.degrade(img, deg_type, level, random.Random(3))
        np.random.seed(11)
        t = tdeg.degrade(img, deg_type, level, random.Random(3))
        _same(t, j)


@pytest.mark.parametrize("shape", [(64, 64), (57, 83), (33, 20)])
def test_random_blur_noise_and_resize_equal_jax(shape):
    img = _img(2, *shape)
    for seed in range(12):
        t, j = random.Random(seed), random.Random(seed)
        tl, jl = set(), set()
        _same(tdeg.random_blur(img, 10, 0.3, 0.5, (0.2, 2.2), tl, t),
              jdeg.random_blur(img, 10, 0.3, 0.5, (0.2, 2.2), jl, j))
        assert tl == jl
        _same(tdeg.random_noise(img, rng=t), jdeg.random_noise(img, rng=j))
        _same(tdeg.random_resize(img, rng=t), jdeg.random_resize(img, rng=j))
        _same(tdeg.random_resize(img, 40, 24, rng=t), jdeg.random_resize(img, 40, 24, rng=j))
        assert t.random() == j.random()


@pytest.mark.parametrize("shape", [(64, 64), (49, 71), (96, 33)])
def test_random_degrade_equals_jax_over_64_seeds(shape):
    img = _img(3, *shape)
    seen = set()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # under_display_filter's missing ucdpsf.pkl
        for seed in range(64):
            t, j = random.Random(seed), random.Random(seed)
            tl, jl = set(), set()
            got = tdeg.random_degrade(img, deg_list=tl, rng=t)
            _same(got, jdeg.random_degrade(img, deg_list=jl, rng=j))
            assert tl == jl and t.random() == j.random()
            assert got.shape == img.shape
            seen |= tl
    assert seen == {"blur", "resize", "noise", "jpeg"}


def test_filters_jpeg_and_resizes_equal_jax():
    img = _img(5, 50, 62)
    kernel = jdeg.bivariate_Gaussian(7, 1.3, 1.3, 0.0)
    _same(tdeg.wiener_filter(img[:, :, 0], kernel), jdeg.wiener_filter(img[:, :, 0], kernel))
    _same(tdeg.wiener_filter_multi_channel(img, kernel),
          jdeg.wiener_filter_multi_channel(img, kernel))
    _same(tdeg.usm_sharp(img), jdeg.usm_sharp(img))
    _same(tdeg.doule_resize(img, 1.3), jdeg.doule_resize(img, 1.3))
    for q in (30, 75.5, 95):
        _same(tdeg.add_jpg_compression(img, q), jdeg.add_jpg_compression(img, q))
    t, j = random.Random(7), random.Random(7)
    _same(tdeg.random_add_jpg_compression(img, (60, 95), t),
          jdeg.random_add_jpg_compression(img, (60, 95), j))
    assert t.random() == j.random()
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        assert tdeg.under_display_filter(img) is img


@pytest.mark.parametrize("shape,dim", [((40, 30, 3), (64, 48)), ((90, 70, 3), (64, 48)),
                                       ((50, 90, 3), (64, 48)), ((64, 48), (64, 48)),
                                       ((33, 100), (48, 40))])
@pytest.mark.parametrize("mode", ["random", "center"])
def test_match_dim_pads_and_crops_as_jax(shape, dim, mode):
    data = (np.random.RandomState(6).rand(*shape) * 255).astype(np.uint8)
    t, j = random.Random(8), random.Random(8)
    got = tdeg.match_dim(data, dim, mode, t)
    _same(got, jdeg.match_dim(data, dim, mode, j))
    assert got.shape[:2] == dim and t.random() == j.random()
    _same(tdeg.pad_edges(data, dim), jdeg.pad_edges(data, dim))
    _same(tdeg.center_crop(data, dim), jdeg.center_crop(data, dim))


@pytest.mark.parametrize("size", [None, (120, 140)])
def test_add_random_mask_equals_jax(size):
    img = _img(9, 72, 96)
    for seed in range(4):
        t, j = random.Random(seed), random.Random(seed)
        _same(tdeg.add_random_mask(img, size, rng=t), jdeg.add_random_mask(img, size, rng=j))
        _same(tdeg.add_random_mask(img, size, mask_id=seed * 7, rng=t),
              jdeg.add_random_mask(img, size, mask_id=seed * 7, rng=j))
        assert t.random() == j.random()


def test_without_cv2_the_cv2_steps_raise_and_name_it(monkeypatch):
    real_import = builtins.__import__

    def no_cv2(name, *a, **kw):
        if name == "cv2":
            raise ImportError("No module named 'cv2'")
        return real_import(name, *a, **kw)

    monkeypatch.delitem(sys.modules, "cv2")
    monkeypatch.setattr(builtins, "__import__", no_cv2)
    img = _img(10, 32, 32)
    with pytest.raises(ImportError, match="random_blur needs cv2"):
        tdeg.random_degrade(img, blur_prob=1.0, rng=random.Random(0))
    with pytest.raises(ImportError, match="add_jpg_compression needs cv2"):
        tdeg.degrade(img, "jpeg", 50)
    # the numpy steps still run
    assert tdeg.random_noise(img, rng=random.Random(0)).shape == img.shape
