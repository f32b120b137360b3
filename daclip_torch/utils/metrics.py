"""Restored-image rounding, as the reference writes its outputs.

Counterpart of `daclip_tpu/utils/metrics.py:array2img` (img_utils.py:136-163
tensor2img). PSNR/SSIM are not ported yet."""
from __future__ import annotations

import numpy as np


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
