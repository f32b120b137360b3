"""The degradation types, level prompts and bin-center banks of DA-CLIP's
level predictor.

Counterpart of `daclip_tpu/data/csv_dataset.py:26-75` (da-clip/src/training/
data.py:55-156). Bin centers are integers, as the reference builds the bank
with torch.long (data.py:88), truncating blur/resize centers like 0.75 → 0;
`exact_bins=True` keeps the float centers. The 28 level prompts and the bank
are constants, built once.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, Tuple

import numpy as np

from daclip_torch.tokenizer import tokenize as default_tokenize

DEGRADATION_TYPES = ["blur", "noisy", "resize", "jpeg"]
DEG_TYPE_TO_ID = {"blur": 0, "noisy": 1, "resize": 2, "jpeg": 3}

LEVEL_DESCRIPTIONS = {
    "blur": ["almost sharp", "slightly blurry", "mildly blurry",
             "moderately blurry", "noticeably blurry", "heavily blurred",
             "extremely blurry"],
    "resize": ["nearly original size", "slightly downscaled", "noticeably resized",
               "significantly downscaled", "severely downscaled", "extremely small",
               "barely visible size"],
    "noisy": ["almost noise-free", "slightly noisy", "mildly noisy",
              "moderately noisy", "noticeably noisy", "heavily noisy",
              "extremely noisy"],
    "jpeg": ["high quality jpeg", "slightly compressed jpeg",
             "noticeably compressed jpeg", "moderately compressed jpeg",
             "heavily compressed jpeg", "very low quality jpeg",
             "extremely compressed jpeg"],
}


def level_grid(d_type: str) -> np.ndarray:
    """Level edges (data.py:71-78): blur/resize 0.5..4.0 step 0.5, noisy
    5..40 step 5, jpeg 10..80 step 10."""
    if d_type in ("blur", "resize"):
        return np.arange(0.5, 4.1, 0.5)
    if d_type == "noisy":
        return np.arange(5, 41, 5)
    if d_type == "jpeg":
        return np.arange(10, 81, 10)
    raise ValueError(d_type)


def build_banks(tokenizer: Callable = default_tokenize, exact_bins: bool = False
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(bin_center_bank (4, 7) float32, all_d_type_tokens (28, 77) int32)."""
    centers_all, tokens_all = [], []
    for d_type in DEGRADATION_TYPES:
        levels = level_grid(d_type)
        centers = [(s + e) / 2 for s, e in zip(levels[:-1], levels[1:])]
        if not exact_bins:
            centers = [int(c) for c in centers]  # torch.long truncation
        centers_all.append(np.asarray(centers, np.float32))
        for p in LEVEL_DESCRIPTIONS[d_type][: len(centers)]:
            tokens_all.append(tokenizer([p])[0])
    return np.stack(centers_all), np.stack(tokens_all).astype(np.int32)


def parse_degradations(degradation: str) -> Dict[str, float]:
    """"noisy with parameter 25.0, blur with parameter 1.5" → {type: value}
    (data.py:55)."""
    matches = re.findall(r"(\w+)\s+with parameter\s+([\d.]+)", degradation)
    return {d_type: float(val) for d_type, val in matches}
