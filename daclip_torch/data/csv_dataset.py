"""DA-CLIP's CSV dataset, with the degradation types, level prompts and
bin-center banks of the fork's level predictor.

Counterpart of `daclip_tpu/data/csv_dataset.py` (da-clip/src/training/
data.py:29-156, 588-635). Bin centers are integers, as the reference builds
the bank with torch.long (data.py:88), truncating blur/resize centers like
0.75 → 0; `exact_bins=True` keeps the float centers. The 28 level prompts
and the bank are constants, built once (`banks()`), not copied into every
sample.

A sample is a dict of numpy arrays: `images` and `gt_images` (H, W, 3)
float32 from the transform, `texts` (L,) token ids, or (2·L,) caption‖
degradation with `da`, `deg_type` and `gt_val` (4,) float32. The GT image's
path is the LQ path with `LQ` replaced by `GT`. Images are decoded as PIL
opens them (`data/util.imread_decoded`): the train transform converts them
to RGB first, the val transform resizes them in their own mode, as
daclip_tpu's transforms do with the PIL image. With `crop`, the
LQ image is cropped by `_random_crop` from the dataset's own
`random.Random(seed)` before the transform draws for the LQ image and then,
anew, for the GT image.
"""
from __future__ import annotations

import csv
import random
import re
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from daclip_torch.data.util import imread_decoded
from daclip_torch.tokenizer import tokenize as default_tokenize
from daclip_torch.transforms import DecodedImage

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


def _random_crop(img: DecodedImage, low_size: int = 64, rng=None) -> DecodedImage:
    """data.py:29-34 on a decoded image. The reference names PIL's (width,
    height) size (h, w) and crops the box (rnd_h, rnd_w, rnd_h + size,
    rnd_w + size); kept, so the draws and the box are the JAX package's."""
    rng = rng or random
    h, w = img.rgb.shape[1], img.rgb.shape[0]
    size = rng.randint(low_size, min(h, w))
    rnd_h = rng.randint(0, max(0, h - size))
    rnd_w = rng.randint(0, max(0, w - size))
    return img.crop(rnd_w, rnd_h, size, size)


def _tokens(tokenize, caption: str, degradation: Optional[str] = None) -> np.ndarray:
    """(L,) ids of the caption, or (2·L,) caption‖degradation."""
    if degradation is None:
        return tokenize([caption])[0].astype(np.int32)
    return np.concatenate([tokenize([caption])[0], tokenize([degradation])[0]]).astype(np.int32)


class CsvDataset:
    """Rows of `img_key` (the LQ image's path) and `caption_key`
    ("<caption>| <degradation>") of a CSV/TSV file."""

    def __init__(self, input_filename: str, transforms: Callable, img_key: str = "filepath",
                 caption_key: str = "title", sep: str = "\t",
                 tokenizer: Callable = default_tokenize, da: bool = False, crop: bool = False,
                 exact_bins: bool = False, seed: Optional[int] = None):
        self.transforms = transforms
        self.tokenize = tokenizer
        self.da = da
        self.crop = crop
        self.rng = random.Random(seed)
        self.images: List[str] = []
        self.captions: List[str] = []
        with open(input_filename, newline="") as f:
            for row in csv.DictReader(f, delimiter=sep):
                self.images.append(row[img_key])
                self.captions.append(row[caption_key])
        self.degradations = [parse_degradations(c.split("| ")[1]) for c in self.captions]
        self.bin_center_bank, self.all_d_type_tokens = build_banks(tokenizer, exact_bins)

    def banks(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.bin_center_bank, self.all_d_type_tokens

    def __len__(self):
        return len(self.captions)

    def __getitem__(self, idx: int) -> Dict:
        path = str(self.images[idx])
        image = imread_decoded(path)
        gt_image = imread_decoded(path.replace("LQ", "GT"))
        deg_type = np.zeros(4, np.float32)
        gt_val = np.zeros(4, np.float32)
        for k, v in self.degradations[idx].items():
            deg_type[DEG_TYPE_TO_ID[k]] = 1
            gt_val[DEG_TYPE_TO_ID[k]] = v
        text = str(self.captions[idx])
        tok = _tokens(self.tokenize, *text.split("| ")) if self.da else _tokens(self.tokenize,
                                                                                  text)
        if self.da and self.crop and self.rng.random() > 0.2:
            image = _random_crop(image, rng=self.rng)
        return {"images": self.transforms(image).astype(np.float32), "texts": tok,
                "gt_images": self.transforms(gt_image).astype(np.float32),
                "deg_type": deg_type, "gt_val": gt_val}


class SyntheticDataset:
    """A black image and one caption (training/data.py:588-635): the
    pipeline without data. `image_size` is (width, height)."""

    def __init__(self, transforms: Optional[Callable] = None, image_size=(224, 224),
                 caption: str = "Dummy caption", dataset_size: int = 100,
                 tokenizer: Callable = default_tokenize, da: bool = False):
        self.image = np.zeros((image_size[1], image_size[0], 3), np.uint8)
        self.transforms = transforms
        self.caption = caption
        self.dataset_size = dataset_size
        self.tokenize = tokenizer
        self.da = da
        self.bin_center_bank, self.all_d_type_tokens = build_banks(tokenizer)

    def banks(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.bin_center_bank, self.all_d_type_tokens

    def __len__(self):
        return self.dataset_size

    def __getitem__(self, idx: int) -> Dict:
        img = (self.transforms(self.image) if self.transforms
               else np.zeros((224, 224, 3), np.float32))
        tok = _tokens(self.tokenize, self.caption, "noisy with parameter 25" if self.da else None)
        return {"images": img.astype(np.float32), "texts": tok,
                "gt_images": img.astype(np.float32),
                "deg_type": np.array([0, 1, 0, 0], np.float32),
                "gt_val": np.array([0, 25, 0, 0], np.float32)}
