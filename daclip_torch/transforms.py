"""The CLIP view of an LQ image, in numpy, without PIL or cv2.

Counterpart of `daclip_tpu/transforms.py:clip_transform` (predict.py:94-106;
open_clip/transform.py:124-133): [0,1] float RGB → uint8 → resize the shorter
side to `resolution` with PIL's antialiased bicubic filter → center crop →
normalise with the OpenAI mean/std.

`_resample_bicubic` is PIL's two-pass 8-bit resampler (Pillow
`libImaging/Resample.c`): bicubic a = −0.5, support scaled by the
downscaling factor, coefficients normalised per output pixel and quantised
to 22-bit fixed point, the horizontal pass first, the intermediate rounded
and clipped to uint8. It gives PIL's bytes.
"""
from __future__ import annotations

import numpy as np

OPENAI_DATASET_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_DATASET_STD = (0.26862954, 0.26130258, 0.27577711)

_PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _coeffs(in_size: int, out_size: int):
    """PIL's fixed-point filter weights of each output pixel (precompute_coeffs
    + normalize_coeffs_8bpc), as a dense (out_size, in_size) int64 matrix."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    mat = np.zeros((out_size, in_size), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = _bicubic((np.arange(xmax) + xmin - center + 0.5) * (1.0 / filterscale))
        total = w.sum()
        if total != 0.0:
            w = w / total
        # C's (int) cast truncates toward zero
        fixed = np.trunc(np.where(w < 0, -0.5, 0.5) + w * (1 << _PRECISION_BITS))
        mat[xx, xmin:xmin + xmax] = fixed.astype(np.int64)
    return mat


def _apply(mat: np.ndarray, img: np.ndarray, axis: int) -> np.ndarray:
    """One 8-bit pass along `axis` (0 rows, 1 columns) of a uint8 HWC image."""
    src = np.moveaxis(img.astype(np.float64), axis, 0)         # (in, other, C)
    # integer products and sums stay far below 2^53: float64 is exact here
    acc = np.tensordot(mat.astype(np.float64), src, axes=([1], [0])).astype(np.int64)
    acc += 1 << (_PRECISION_BITS - 1)
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def _resample_bicubic(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """PIL `Image.resize((out_w, out_h), Image.BICUBIC)` of a uint8 HWC image."""
    h, w = img.shape[:2]
    if out_w != w:
        img = _apply(_coeffs(w, out_w), img, axis=1)
    if out_h != h:
        img = _apply(_coeffs(h, out_h), img, axis=0)
    return img


def _to_uint8(arr: np.ndarray) -> np.ndarray:
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = np.repeat(arr, 3, axis=2)
    return arr


def _resize_shorter(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    if w <= h:
        nw, nh = size, max(1, int(round(size * h / w)))
    else:
        nw, nh = max(1, int(round(size * w / h))), size
    return _resample_bicubic(img, nw, nh)


def _center_crop(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    if w < size or h < size:  # torchvision pads a smaller image with zeros
        canvas = np.zeros((max(h, size), max(w, size), img.shape[2]), img.dtype)
        top, left = (canvas.shape[0] - h) // 2, (canvas.shape[1] - w) // 2
        canvas[top:top + h, left:left + w] = img
        img = canvas
        h, w = img.shape[:2]
    left = int(round((w - size) / 2.0))
    top = int(round((h - size) / 2.0))
    return img[top:top + size, left:left + size]


def clip_transform(np_image: np.ndarray, resolution: int = 224,
                   mean=OPENAI_DATASET_MEAN, std=OPENAI_DATASET_STD) -> np.ndarray:
    """[0,1] float RGB HWC → normalised (resolution, resolution, 3) float32."""
    img = _center_crop(_resize_shorter(_to_uint8(np_image), resolution), resolution)
    arr = img.astype(np.float32) / 255.0
    return (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
