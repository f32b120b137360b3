"""Image IO, augmentation and colour utilities of the restoration data
layer, in numpy.

Counterpart of `daclip_tpu/data/util.py` (reference
universal-image-restoration/data/util.py):
  read_img          — util.py:89-115: float32 HWC BGR in [0, 1], gray with a
                      channel axis, alpha dropped
  imread_decoded    — the CSV dataset's decode: uint8 RGB as PIL's
                      convert("RGB") gives it, with the alpha and the mode
                      PIL opens the file in
  read_imgs_cropped — util.py:118-156: one random crop shared by same-sized
                      images, decoded in full and then cropped
  augment           — util.py:98-116: random hflip + rot90 family
  channel_convert   — util.py:166-178
  rgb2ycbcr / bgr2ycbcr — ITU-R BT.601, MATLAB-compatible
  imresize_np       — util.py:231-299: MATLAB bicubic with antialiasing

PNG is decoded and encoded by `data/png.py`, which needs neither cv2 nor
PIL. Any other format goes through cv2 (through PIL for `imread_decoded`),
imported only when such a file is read; without cv2 that raises an ImportError that says how to get the data
in (PNG, or an LMDB packed where cv2 exists: `tools/create_lmdb.py`). The
JAX package's native decoder (`DACLIP_TPU_NATIVE_IO`, `data/native_io.py`)
is not carried over.
"""
from __future__ import annotations

import io
import os
import pickle
import random
from typing import List, Optional, Sequence

import numpy as np

from daclip_torch.data import png
from daclip_torch.transforms import DecodedImage

IMG_EXTENSIONS = (".jpg", ".JPG", ".jpeg", ".JPEG", ".png", ".PNG", ".ppm",
                  ".PPM", ".bmp", ".BMP", ".tif", ".webp")


def is_image_file(fname: str) -> bool:
    return fname.endswith(IMG_EXTENSIONS)


def get_paths_from_images(path: str) -> List[str]:
    if not os.path.isdir(path):
        raise FileNotFoundError(f"{path} is not a valid directory")
    images = []
    for dirpath, _, fnames in sorted(os.walk(path)):
        for fname in sorted(fnames):
            if is_image_file(fname):
                images.append(os.path.join(dirpath, fname))
    if not images:
        raise FileNotFoundError(f"{path} has no valid image file")
    return images


def get_image_paths(data_type: Optional[str], dataroot: Optional[str]):
    """'img' → sorted file list; 'lmdb' → (keys, sizes) from
    meta_info.pkl (util.py:42-54)."""
    if dataroot is None:
        return None
    if data_type in (None, "img"):
        return sorted(get_paths_from_images(dataroot))
    if data_type == "lmdb":
        # meta_info.pkl is written by tools/create_lmdb.py next to the data
        with open(os.path.join(dataroot, "meta_info.pkl"), "rb") as f:
            meta = pickle.load(f)
        paths, sizes = meta["keys"], meta["resolution"]
        if len(sizes) == 1:
            sizes = sizes * len(paths)
        return paths, sizes
    raise NotImplementedError(f"data_type {data_type!r} not supported (img or lmdb)")


def open_lmdb(dataroot: str):
    """Read-only environment over the pure-Python LMDB reader
    (LQGT_dataset.py:58-74)."""
    from daclip_torch.data.lmdb import LmdbReader

    return LmdbReader(dataroot)


def _read_img_lmdb(env, key: str, size) -> np.ndarray:
    """Raw uint8 HWC bytes keyed by name; `size` is (C, H, W)."""
    buf = env.get(key)
    if buf is None:
        raise KeyError(f"key {key!r} not found in lmdb")
    C, H, W = size
    return np.frombuffer(buf, dtype=np.uint8).reshape(H, W, C)


_PNG_HINT = ("; daclip_torch decodes and encodes PNG itself: convert the images to PNG, or "
             "pack them into an LMDB with daclip_torch.tools.create_lmdb on a host that has cv2")


def _cv2(what: str, hint: str = ""):
    """cv2, imported here; without it an ImportError that names `what`."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{what} needs cv2 (opencv-python), which is not installed"
                          + hint) from e
    return cv2


def imread(path: str) -> np.ndarray:
    """The image as `cv2.imread(path, cv2.IMREAD_UNCHANGED)` gives it (uint8,
    uint16 for a 16-bit file): PNG by `data/png.py`, anything else by cv2."""
    with open(path, "rb") as f:
        data = f.read()
    if png.is_png(data):
        return png.decode(data, path)
    cv2 = _cv2(f"reading {path!r} (not a PNG file)", _PNG_HINT)
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    if img is None:
        raise ValueError(f"cv2 cannot decode {path!r}")
    return img


def imread_color(path: str) -> np.ndarray:
    """uint8 BGR (H, W, 3), as `cv2.imread(path)` gives it: gray is
    replicated, alpha dropped and a 16-bit sample cut to its high byte."""
    img = imread(path)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


# PIL modes whose resize `transforms.clip_transform` reproduces; a file PIL
# opens in another mode (CMYK, I, F, ...) is converted to RGB first
_DECODED_MODES = ("1", "L", "P", "RGB", "LA", "RGBA")


def imread_decoded(path: str) -> DecodedImage:
    """The image as PIL opens it (`transforms.DecodedImage`): its RGB as
    `convert("RGB")` gives it (alpha dropped without compositing, gray
    replicated, a palette expanded), its alpha for "RGBA" and "LA", and its
    mode.
    PNG by `data/png.py`, 16-bit samples as PIL reads them: 16-bit gray
    ("I;16") clipped to 255, any other 16-bit layout cut to its high byte;
    any other format by PIL, imported here."""
    with open(path, "rb") as f:
        data = f.read()
    if png.is_png(data):
        img, mode = png.decode_with_mode(data, path)
        if img.dtype == np.uint16:
            img = (np.minimum(img, 255) if mode == "I;16" else img >> 8).astype(np.uint8)
        mode = mode if mode in _DECODED_MODES else "RGB"
        if img.ndim == 2:
            return DecodedImage(np.repeat(img[:, :, None], 3, axis=2), None, mode)
        alpha = img[:, :, 3] if mode in ("RGBA", "LA") else None
        return DecodedImage(np.ascontiguousarray(img[:, :, 2::-1]), alpha, mode)  # BGR(A) → RGB
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        mode = im.mode if im.mode in _DECODED_MODES else "RGB"
        alpha = np.asarray(im.getchannel("A")) if mode in ("RGBA", "LA") else None
        return DecodedImage(np.asarray(im.convert("RGB")), alpha, mode)


def read_img(env, path: str, size=None) -> np.ndarray:
    """File (or LMDB record when `env` is given) → float32 HWC BGR, the
    samples over 255 (so [0, 1] for 8-bit files and up to 257 for 16-bit
    ones, as daclip_tpu's cv2 read gives them); gray gets a channel axis,
    alpha is dropped (util.py:68-85)."""
    img = imread(path) if env is None else _read_img_lmdb(env, path, size)
    img = img.astype(np.float32) / 255.0
    if img.ndim == 2:
        img = np.expand_dims(img, axis=2)
    if img.shape[2] > 3:
        img = img[:, :, :3]
    return img


def read_imgs_cropped(paths, size: int, rng) -> list:
    """Read same-sized images and crop all of them to one random
    (size, size) window. Draws exactly one `randint` pair per call, from the
    first image's (H, W), as the JAX package does on each of its decode
    paths, so the RNG stream and the windows equal its own. Returns
    (imgs, (rnd_h, rnd_w))."""
    imgs = [read_img(None, p) for p in paths]
    H, W = imgs[0].shape[:2]
    rnd_h = rng.randint(0, max(0, H - size))
    rnd_w = rng.randint(0, max(0, W - size))
    return ([im[rnd_h:rnd_h + size, rnd_w:rnd_w + size, :] for im in imgs],
            (rnd_h, rnd_w))


def save_img(img: np.ndarray, img_path: str):
    """uint8 gray, BGR or BGRA → file: PNG by `data/png.py`, any other
    extension by cv2."""
    if img_path.lower().endswith(".png"):
        png.write(img_path, img)
        return
    if not _cv2(f"writing {img_path!r} (not a .png path)", _PNG_HINT).imwrite(img_path, img):
        raise OSError(f"cv2 could not write {img_path!r}")


def augment(img_list: Sequence[np.ndarray], hflip: bool = True, rot: bool = True,
            mode=None, rng: Optional[random.Random] = None):
    """Random horizontal flip / vertical flip / transpose (util.py:98-116)."""
    rng = rng or random
    hflip = hflip and rng.random() < 0.5
    vflip = rot and rng.random() < 0.5
    rot90 = rot and rng.random() < 0.5

    def _aug(img):
        if hflip:
            img = img[:, ::-1, :]
        if vflip:
            img = img[::-1, :, :]
        if rot90:
            img = img.transpose(1, 0, 2)
        return np.ascontiguousarray(img)

    return [_aug(img) for img in img_list]


def _fma32(a, b, c):
    """float32 a·b + c rounded once: the product of two float32 is exact in
    float64."""
    return (a.astype(np.float64) * np.float64(b) + c.astype(np.float64)).astype(np.float32)


def bgr2gray(img: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)` on HWC uint8 or float32:
    uint8 by cv2's 15-bit fixed point, float32 as its vector path computes
    fma(R, 0.299, fma(B, 0.114, G·0.587))."""
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    if img.dtype == np.uint8:
        y = (b.astype(np.int32) * 3735 + g.astype(np.int32) * 19235
             + r.astype(np.int32) * 9798 + (1 << 14)) >> 15
        return y.astype(np.uint8)
    if img.dtype != np.float32:
        raise ValueError(f"bgr2gray takes uint8 or float32, got {img.dtype}")
    return _fma32(r, np.float32(0.299), _fma32(b, np.float32(0.114), g * np.float32(0.587)))


def channel_convert(in_c: int, tar_type: str, img_list):
    if in_c == 3 and tar_type == "gray":
        return [np.expand_dims(bgr2gray(img), 2) for img in img_list]
    if in_c == 3 and tar_type == "y":
        return [np.expand_dims(bgr2ycbcr(img, only_y=True), 2) for img in img_list]
    if in_c == 1 and tar_type == "RGB":
        # cv2's GRAY2BGR: the channel repeated
        return [np.repeat(img.reshape(img.shape[0], img.shape[1], 1), 3, axis=2)
                for img in img_list]
    return img_list


_Y = np.asarray([65.481, 128.553, 24.966])
_YCBCR = np.asarray([[65.481, -37.797, 112.0],
                     [128.553, -74.203, -93.786],
                     [24.966, 112.0, -18.214]])


def _ycbcr(img: np.ndarray, only_y: bool, order) -> np.ndarray:
    in_type = img.dtype
    x = img.astype(np.float64)
    if in_type != np.uint8:
        x = x * 255.0
    if only_y:
        out = x @ _Y[order] / 255.0 + 16.0
    else:
        out = x @ _YCBCR[order] / 255.0 + [16, 128, 128]
    if in_type == np.uint8:
        out = out.round()
    else:
        out = out / 255.0
    return out.astype(in_type)


def rgb2ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    """RGB → Y (only_y) or YCbCr (util.py:160-187). uint8 in gives rounded
    uint8 out; floats are taken in [0, 1]."""
    return _ycbcr(img, only_y, [0, 1, 2])


def bgr2ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    """BGR → Y (only_y) or YCbCr (util.py:189-211), for cv2's channel order."""
    return _ycbcr(img, only_y, [2, 1, 0])


def modcrop(img_in: np.ndarray, scale: int) -> np.ndarray:
    img = np.copy(img_in)
    if img.ndim == 2:
        h, w = img.shape
        img = img[: h - h % scale, : w - w % scale]
    elif img.ndim == 3:
        h, w, _ = img.shape
        img = img[: h - h % scale, : w - w % scale, :]
    else:
        raise ValueError(f"wrong img ndim: {img.ndim}")
    return img


# -- MATLAB imresize (bicubic, antialiased) ---------------------------------------

def _cubic(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    ax2, ax3 = ax ** 2, ax ** 3
    return ((1.5 * ax3 - 2.5 * ax2 + 1) * (ax <= 1)
            + (-0.5 * ax3 + 2.5 * ax2 - 4 * ax + 2) * ((ax > 1) & (ax <= 2)))


def _resize_weights(in_len: int, out_len: int, scale: float, antialias=True):
    kernel_width = 4.0
    if scale < 1 and antialias:
        kernel_width = kernel_width / scale
    x = np.arange(1, out_len + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = int(np.ceil(kernel_width)) + 2
    idx = left[:, None] + np.arange(p)[None, :] - 1          # 0-based candidate index
    dist = u[:, None] - (idx + 1)
    if scale < 1 and antialias:
        w = scale * _cubic(dist * scale)
    else:
        w = _cubic(dist)
    w = w / np.sum(w, axis=1, keepdims=True)
    # MATLAB's symmetric boundary fold: 0-based index -1 → 0, -2 → 1,
    # in_len → in_len-1, …
    aux = np.concatenate([np.arange(in_len), np.arange(in_len - 1, -1, -1)])
    idx = aux[np.mod(idx.astype(np.int64), 2 * in_len)]
    keep = ~np.all(w == 0, axis=0)                           # all-zero columns
    return w[:, keep], idx[:, keep]


def imresize_np(img: np.ndarray, scale: float, antialiasing: bool = True) -> np.ndarray:
    """MATLAB-style bicubic resize of HWC (or HW) imagery, with symmetric
    border folding (util.py:344-399 of the reference)."""
    squeeze = False
    if img.ndim == 2:
        img = img[:, :, None]
        squeeze = True
    in_h, in_w, _ = img.shape
    out_h = int(np.ceil(in_h * scale))
    out_w = int(np.ceil(in_w * scale))
    x = img.astype(np.float64)

    w_h, idx_h = _resize_weights(in_h, out_h, scale, antialiasing)
    x = np.einsum("ok,okwc->owc", w_h, x[idx_h], optimize=True)
    w_w, idx_w = _resize_weights(in_w, out_w, scale, antialiasing)
    x = np.einsum("ok,hokc->hoc", w_w, x[:, idx_w], optimize=True)

    out = x.astype(img.dtype if img.dtype != np.uint8 else np.float64)
    if squeeze:
        out = out[:, :, 0]
    return out
