"""CLIP's image transforms, in numpy, without PIL or cv2.

Counterpart of `daclip_tpu/transforms.py`'s PIL path:
  * `clip_transform` (predict.py:94-106; open_clip/transform.py:124-133):
    [0,1] float RGB → uint8 → resize the shorter side to `resolution` with
    PIL's antialiased bicubic filter → center crop → normalise with the
    OpenAI mean/std;
  * `image_transform(is_train=True)` (open_clip/transform.py:105-114):
    torchvision's RandomResizedCrop, scale (0.9, 1.0), drawn from a
    `random.Random`, resized as PIL's `resize(box=…)` → normalise.

`_resample_bicubic` is PIL's two-pass 8-bit resampler (Pillow
`libImaging/Resample.c`): bicubic a = −0.5, support scaled by the
downscaling factor, coefficients normalised per output pixel and quantised
to 22-bit fixed point, the horizontal pass first, the intermediate rounded
and clipped to uint8. With a box, the filter's centres span the box's
extent while its taps reach any pixel of the image, as PIL's do (so the
result is not crop-then-resize). It gives PIL's bytes.

A `DecodedImage` (the CSV dataset's decode, `data/util.imread_decoded`)
keeps the mode PIL would open the file in. The train transform converts it
to RGB first, as daclip_tpu's does; `clip_transform` resizes it in that mode
and drops to RGB after, as PIL's `Image.resize` and `convert("RGB")` do: a
palette ("P") or bilevel ("1") image by nearest neighbour
(`_resample_nearest`), an "RGBA" or "LA" one bicubic on its premultiplied
colours ("RGBa", "La", `_resize_premultiplied`), the rest bicubic.
"""
from __future__ import annotations

import math
import random
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np

OPENAI_DATASET_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_DATASET_STD = (0.26862954, 0.26130258, 0.27577711)

_PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _coeffs(in_size: int, out_size: int, in0: float = 0.0, in1: Optional[float] = None):
    """PIL's fixed-point filter weights of each output pixel (precompute_coeffs
    over the input span [in0, in1) + normalize_coeffs_8bpc), as a dense
    (out_size, in_size) int64 matrix."""
    in1 = in_size if in1 is None else in1
    scale = (in1 - in0) / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    mat = np.zeros((out_size, in_size), np.int64)
    for xx in range(out_size):
        center = in0 + (xx + 0.5) * scale
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
    """One 8-bit pass along `axis` (0 rows, 1 columns) of a uint8 HWC image.
    Each output pixel sums only its filter's taps, a band of at most K
    inputs from its first nonzero weight, in integers (exact)."""
    src = np.moveaxis(img, axis, 0).astype(np.int64)            # (in, other, C)
    nz = mat != 0
    first = nz.argmax(axis=1)
    K = int((mat.shape[1] - nz[:, ::-1].argmax(axis=1) - first).max())
    idx = first[:, None] + np.arange(K)
    w = np.take_along_axis(mat, np.minimum(idx, mat.shape[1] - 1), axis=1)
    w[idx >= mat.shape[1]] = 0
    idx = np.minimum(idx, mat.shape[1] - 1)
    acc = np.full((mat.shape[0],) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    for k in range(K):
        acc += w[:, k, None, None] * src[idx[:, k]]
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def _resample_bicubic(img: np.ndarray, out_w: int, out_h: int,
                      box: Optional[Tuple[float, float, float, float]] = None) -> np.ndarray:
    """PIL `Image.resize((out_w, out_h), Image.BICUBIC, box=box)` of a uint8
    HWC image; `box` (left, upper, right, lower) defaults to the image. A
    pass runs when PIL's `ImagingResample` runs it: the output size differs,
    or the box starts past 0 or ends elsewhere than the output size."""
    h, w = img.shape[:2]
    x0, y0, x1, y1 = (0, 0, w, h) if box is None else box
    if out_w != w or x0 or x1 != out_w:
        img = _apply(_coeffs(w, out_w, x0, x1), img, axis=1)
    if out_h != h or y0 or y1 != out_h:
        img = _apply(_coeffs(h, out_h, y0, y1), img, axis=0)
    return img


class DecodedImage(NamedTuple):
    """An 8-bit image with the mode PIL opens its file in: `rgb` uint8
    (H, W, 3) as `convert("RGB")` gives it, `alpha` (H, W) uint8 for "RGBA"
    and "LA" (None otherwise), `mode`."""
    rgb: np.ndarray
    alpha: Optional[np.ndarray]
    mode: str

    def crop(self, top: int, left: int, h: int, w: int) -> "DecodedImage":
        alpha = None if self.alpha is None else self.alpha[top:top + h, left:left + w]
        return DecodedImage(self.rgb[top:top + h, left:left + w], alpha, self.mode)


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Source index of each output pixel of PIL's NEAREST resize along one
    axis (Geometry.c `ImagingScaleAffine`): the sample point starts at half
    a step and is advanced by adding the step, in float64, then truncated."""
    step = in_size / out_size
    xo, out = step * 0.5, np.empty(out_size, np.int64)
    for x in range(out_size):
        out[x] = int(xo)
        xo += step
    return out


def _resample_nearest(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """PIL `Image.resize((out_w, out_h), Image.NEAREST)` of an HWC image."""
    h, w = img.shape[:2]
    return img[_nearest_index(h, out_h)][:, _nearest_index(w, out_w)]


def _muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """PIL's MULDIV255: a·b / 255 rounded, in integers."""
    t = a.astype(np.uint32) * b.astype(np.uint32) + 128
    return (((t >> 8) + t) >> 8).astype(np.uint8)


def _resize_premultiplied(img: DecodedImage, out_w: int, out_h: int) -> np.ndarray:
    """RGB of PIL's resize of an "RGBA" or "LA" image: convert to "RGBa" /
    "La" (colour × alpha / 255), bicubic on colour and alpha, convert back
    (colour × 255 // alpha, clipped; an alpha of 0 or 255 keeps the
    colour))."""
    colour = img.rgb if img.mode == "RGBA" else img.rgb[:, :, :1]
    alpha = img.alpha[:, :, None]
    out = _resample_bicubic(np.concatenate([_muldiv255(colour, alpha), alpha], axis=2),
                            out_w, out_h).astype(np.uint32)
    c, a = out[:, :, :-1], out[:, :, -1:]
    un = np.minimum(255 * c // np.maximum(a, 1), 255)
    c = np.where((a == 0) | (a == 255), c, un).astype(np.uint8)
    return np.ascontiguousarray(np.broadcast_to(c, c.shape[:2] + (3,)))


def _resize_decoded(img: DecodedImage, out_w: int, out_h: int) -> np.ndarray:
    """uint8 RGB of PIL's `resize((out_w, out_h), BICUBIC)` in the image's
    own mode, then `convert("RGB")`."""
    h, w = img.rgb.shape[:2]
    if (out_w, out_h) == (w, h):
        return img.rgb
    if img.mode in ("P", "1"):
        return _resample_nearest(img.rgb, out_w, out_h)
    if img.mode in ("RGBA", "LA"):
        return _resize_premultiplied(img, out_w, out_h)
    return _resample_bicubic(img.rgb, out_w, out_h)


def _to_uint8(arr: np.ndarray) -> np.ndarray:
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = np.repeat(arr, 3, axis=2)
    return arr


def _resize_shorter(img: DecodedImage, size: int) -> np.ndarray:
    """uint8 RGB of the image resized in its own mode so that its shorter
    side is `size`."""
    h, w = img.rgb.shape[:2]
    if w <= h:
        nw, nh = size, max(1, int(round(size * h / w)))
    else:
        nw, nh = max(1, int(round(size * w / h))), size
    return _resize_decoded(img, nw, nh)


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


def _normalize(img: np.ndarray, mean, std) -> np.ndarray:
    arr = img.astype(np.float32) / 255.0
    return (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def clip_transform(np_image: np.ndarray, resolution: int = 224,
                   mean=OPENAI_DATASET_MEAN, std=OPENAI_DATASET_STD) -> np.ndarray:
    """[0,1] float or uint8 RGB HWC, or a `DecodedImage` → normalised
    (resolution, resolution, 3) float32."""
    if not isinstance(np_image, DecodedImage):
        np_image = DecodedImage(_to_uint8(np_image), None, "RGB")
    img = _center_crop(_resize_shorter(np_image, resolution), resolution)
    return _normalize(img, mean, std)


def _random_resized_crop(img: np.ndarray, size: int, scale=(0.9, 1.0), ratio=(3 / 4, 4 / 3),
                         rng: Optional[random.Random] = None) -> np.ndarray:
    """torchvision's RandomResizedCrop on a uint8 HWC image: 10 draws of an
    area share and a log aspect, then the center fallback; the box resized
    to size × size as PIL's `resize(box=…)`."""
    rng = rng or random
    h, w = img.shape[:2]
    area = w * h
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            left = rng.randint(0, w - cw)
            top = rng.randint(0, h - ch)
            return _resample_bicubic(img, size, size, (left, top, left + cw, top + ch))
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    left, top = (w - cw) // 2, (h - ch) // 2
    return _resample_bicubic(img, size, size, (left, top, left + cw, top + ch))


def image_transform(image_size=224, is_train: bool = False,
                    mean: Optional[Sequence[float]] = None,
                    std: Optional[Sequence[float]] = None,
                    rng: Optional[random.Random] = None):
    """fn(image) → normalised (size, size, 3) float32 HWC, for a uint8 RGB
    or [0,1] float RGB HWC image or a `DecodedImage`: the train transform (random resized crop,
    its draws from `rng`, the `random` module's stream when None, as
    daclip_tpu's) or the val transform (`clip_transform`)."""
    mean = tuple(mean or OPENAI_DATASET_MEAN)
    std = tuple(std or OPENAI_DATASET_STD)
    if isinstance(image_size, (tuple, list)):
        image_size = image_size[0]

    def train_fn(img):
        img = img.rgb if isinstance(img, DecodedImage) else _to_uint8(img)
        return _normalize(_random_resized_crop(img, image_size, rng=rng), mean, std)

    def val_fn(img):
        return clip_transform(img, image_size, mean, std)

    return train_fn if is_train else val_fn
