"""Colour conversions of the restoration metrics.

Counterpart of `daclip_tpu/data/util.py:193-231` (`rgb2ycbcr`,
`bgr2ycbcr`): ITU-R BT.601, MATLAB-compatible, on HWC numpy images. uint8
in gives rounded uint8 out; floats are taken in [0, 1].
"""
from __future__ import annotations

import numpy as np

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
    """RGB → Y (only_y) or YCbCr (util.py:160-187)."""
    return _ycbcr(img, only_y, [0, 1, 2])


def bgr2ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    """BGR → Y (only_y) or YCbCr (util.py:189-211), for cv2's channel order."""
    return _ycbcr(img, only_y, [2, 1, 0])
