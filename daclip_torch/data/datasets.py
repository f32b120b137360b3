"""Restoration datasets (host-side numpy).

Counterpart of `daclip_tpu/data/datasets.py` (reference
universal-image-restoration/data/):

  MDDataset   — MD_dataset.py:27-120: train picks the degradation type
                round-robin by index and a random item of it; random crop,
                flip/rot, BGR→RGB and the CLIP view of each sample
  MDGTDataset — MDGT_dataset.py:15-81: GT-only folders degraded on the fly
                by `degradations.random_degrade` (wild-ir's training set)
  LQGTDataset — LQGT_dataset.py:14-151: paired folders or LMDBs, 20%
                grayscale at train; `clip_view` for frozen-context caching
  CachedContextDataset — precomputed frozen DA-CLIP contexts
  LQDataset / GTDataset — unpaired single-folder variants (GT with
                Gaussian noise from `degradations.py`)

Samples are dicts of numpy arrays as the JAX package makes them: HWC RGB
float32 in [0, 1] for 'GT'/'LQ', and the normalised (224, 224, 3) float32
CLIP view for 'LQ_clip' (HWC; `loader.to_device` makes NCHW tensors). Each
dataset draws from one `random.Random(opt["seed"])`, in the JAX package's
order, so a seed gives the same samples in both.

The thread-pool loader shares a dataset's Random between its threads, so a
seed gives the JAX package's batches at `n_workers: 0`.
"""
from __future__ import annotations

import os
import random
from typing import Dict, List

import numpy as np

from daclip_torch.data import degradations, util
from daclip_torch.transforms import clip_transform


def _finalize(img_GT, img_LQ, clip_res: int = 224) -> Dict:
    """BGR→RGB and the CLIP view: the shared tail of every `__getitem__`."""
    if img_GT is not None and img_GT.shape[2] == 3:
        img_GT = img_GT[:, :, ::-1].copy()
    if img_LQ is not None and img_LQ.shape[2] == 3:
        img_LQ = img_LQ[:, :, ::-1].copy()
    out = {}
    if img_GT is not None:
        out["GT"] = img_GT.astype(np.float32)
    if img_LQ is not None:
        out["LQ"] = img_LQ.astype(np.float32)
        out["LQ_clip"] = clip_transform(img_LQ, clip_res)
    return out


class MDDataset:
    """Multi-degradation paired folders `<dataroot>/<deg_type>/{GT,LQ}`."""

    def __init__(self, opt: Dict):
        self.opt = opt
        self.size = opt.get("patch_size")
        self.deg_types = list(opt["distortion"])
        self.phase = opt.get("phase", "train")
        self.distortion = {}
        for deg_type in self.deg_types:
            gt = util.get_image_paths(opt.get("data_type"),
                                      os.path.join(opt["dataroot"], deg_type, "GT"))
            lq = util.get_image_paths(opt.get("data_type"),
                                      os.path.join(opt["dataroot"], deg_type, "LQ"))
            if len(gt) != len(lq):
                raise ValueError(f"{deg_type}: {len(gt)} GT images but {len(lq)} LQ")
            self.distortion[deg_type] = (gt, lq)
        self.data_lens = [len(self.distortion[t][0]) for t in self.deg_types]
        self.rng = random.Random(opt.get("seed"))

    def __len__(self):
        return int(np.sum(self.data_lens))

    def __getitem__(self, index: int) -> Dict:
        type_id = int(index % len(self.deg_types))
        if self.phase == "train":
            deg_type = self.deg_types[type_id]
            index = self.rng.randrange(self.data_lens[type_id])
        else:
            while index // len(self.deg_types) >= self.data_lens[type_id]:
                index += 1
                type_id = int(index % len(self.deg_types))
            deg_type = self.deg_types[type_id]
            index = index // len(self.deg_types)

        GT_path = self.distortion[deg_type][0][index]
        LQ_path = self.distortion[deg_type][1][index]
        if self.phase == "train":
            (img_GT, img_LQ), _ = util.read_imgs_cropped([GT_path, LQ_path], self.size,
                                                         self.rng)
            img_LQ, img_GT = util.augment([img_LQ, img_GT], self.opt.get("use_flip", True),
                                          self.opt.get("use_rot", True), rng=self.rng)
        else:
            img_GT = util.read_img(None, GT_path)
            img_LQ = util.read_img(None, LQ_path)
        if self.opt.get("color"):
            img_GT = util.channel_convert(img_GT.shape[2], self.opt["color"], [img_GT])[0]
            img_LQ = util.channel_convert(img_LQ.shape[2], self.opt["color"], [img_LQ])[0]

        out = _finalize(img_GT, img_LQ, self.opt.get("clip_size", 224))
        out.update({"type": deg_type, "GT_path": GT_path, "LQ_path": LQ_path})
        return out


class MDGTDataset:
    """GT-only folders with on-the-fly degradation synthesis, wild-ir's
    training set (MDGT_dataset.py:15-81): at train, a random crop at decode
    time, the colour convert, flip/rot, 10% grayscale (converted back to the
    dataset's colour), then `degradations.random_degrade`; at val/test,
    `random_degrade` over the full image.

    With `lq_cache: N` (opt-in, the JAX package's addition, not the
    reference's) the dataset keeps a pool of N synthesized (GT, LQ) pairs:
    each fetch synthesizes anew with probability `lq_cache_refresh` (default
    1/4) and otherwise serves a random cached pair under a fresh flip/rot
    draw; a full pool replaces a random entry. It bounds the loader's
    synthesis cost at N·2·patch²·3·4 bytes (≈1.5 MB a pair at 256²)."""

    def __init__(self, opt: Dict):
        self.opt = opt
        self.GT_size = opt.get("patch_size")
        self.phase = opt.get("phase", "train")
        self.GT_paths = util.get_image_paths(opt.get("data_type"), opt["dataroot_GT"])
        self.rng = random.Random(opt.get("seed"))
        self.lq_cache_size = int(opt.get("lq_cache", 0) or 0)
        self.lq_cache_refresh = float(opt.get("lq_cache_refresh", 0.25))
        self._lq_cache: List = []

    def __len__(self):
        return len(self.GT_paths)

    def _synthesize(self, index: int):
        GT_path = self.GT_paths[index]
        # the colour convert commutes with the crop, so it follows the read
        (img_GT,), _ = util.read_imgs_cropped([GT_path], self.GT_size, self.rng)
        if self.opt.get("color"):
            img_GT = util.channel_convert(img_GT.shape[2], self.opt["color"], [img_GT])[0]
        img_GT = util.augment([img_GT], self.opt.get("use_flip", True),
                              self.opt.get("use_rot", True), rng=self.rng)[0]
        if self.rng.random() < 0.1:  # MDGT_dataset.py:62-64
            img_GT = util.channel_convert(img_GT.shape[2], "gray", [img_GT])[0]
            img_GT = util.channel_convert(img_GT.shape[2], self.opt.get("color", "RGB"),
                                          [img_GT])[0]
        img_LQ = degradations.random_degrade(img_GT, rng=self.rng)
        return img_GT, img_LQ, GT_path

    def __getitem__(self, index: int) -> Dict:
        clip_size = self.opt.get("clip_size", 224)
        if self.phase != "train":
            img_GT = util.read_img(None, self.GT_paths[index])
            if self.opt.get("color"):
                img_GT = util.channel_convert(img_GT.shape[2], self.opt["color"], [img_GT])[0]
            img_LQ = degradations.random_degrade(img_GT, rng=self.rng)
            out = _finalize(img_GT, img_LQ, clip_size)
            out["GT_path"] = self.GT_paths[index]
            return out

        cache = self._lq_cache
        if (self.lq_cache_size > 0 and len(cache) >= self.lq_cache_size
                and self.rng.random() >= self.lq_cache_refresh):
            img_GT, img_LQ, GT_path = cache[self.rng.randrange(len(cache))]
            img_GT, img_LQ = util.augment([img_GT, img_LQ], self.opt.get("use_flip", True),
                                          self.opt.get("use_rot", True), rng=self.rng)
        else:
            img_GT, img_LQ, GT_path = self._synthesize(index)
            if self.lq_cache_size > 0:
                entry = (img_GT, img_LQ, GT_path)
                if len(cache) >= self.lq_cache_size:
                    cache[self.rng.randrange(len(cache))] = entry
                else:
                    cache.append(entry)
        out = _finalize(img_GT, img_LQ, clip_size)
        out["GT_path"] = GT_path
        return out


class LQGTDataset:
    """Paired LQ/GT folders or LMDBs (test sets and paired training)."""

    def __init__(self, opt: Dict):
        self.opt = opt
        self.phase = opt.get("phase", "test")
        self.is_lmdb = opt.get("data_type") == "lmdb"
        self.GT_env = self.LR_env = None  # opened at the first read (LQGT_dataset.py:58-74)
        if self.is_lmdb:
            self.GT_paths, self.GT_sizes = util.get_image_paths("lmdb", opt["dataroot_GT"])
            self.LR_paths, self.LR_sizes = util.get_image_paths("lmdb", opt["dataroot_LQ"])
        else:
            self.GT_paths = util.get_image_paths(opt.get("data_type"), opt["dataroot_GT"])
            self.LR_paths = util.get_image_paths(opt.get("data_type"), opt["dataroot_LQ"])
        self.rng = random.Random(opt.get("seed"))

    def __len__(self):
        return len(self.GT_paths)

    def _resolution(self, sizes, index):
        s = sizes[index]
        return [int(x) for x in s.split("_")] if isinstance(s, str) else s

    def __getitem__(self, index: int) -> Dict:
        if self.is_lmdb and self.GT_env is None:
            self.GT_env = util.open_lmdb(self.opt["dataroot_GT"])
            self.LR_env = util.open_lmdb(self.opt["dataroot_LQ"])
        scale = self.opt.get("scale") or 1
        GT_size = self.opt.get("patch_size")
        GT_path = self.GT_paths[index]
        LR_path = self.LR_paths[index]
        if self.is_lmdb:
            img_GT = util.read_img(self.GT_env, GT_path, self._resolution(self.GT_sizes, index))
            img_LR = util.read_img(self.LR_env, LR_path, self._resolution(self.LR_sizes, index))
        else:
            img_GT = util.read_img(None, GT_path)
            img_LR = util.read_img(None, LR_path)

        if self.phase == "train":
            H, W, _ = img_LR.shape
            LR_size = GT_size // scale
            rnd_h = self.rng.randint(0, max(0, H - LR_size))
            rnd_w = self.rng.randint(0, max(0, W - LR_size))
            img_LR = img_LR[rnd_h: rnd_h + LR_size, rnd_w: rnd_w + LR_size, :]
            gh, gw = int(rnd_h * scale), int(rnd_w * scale)
            img_GT = img_GT[gh: gh + GT_size, gw: gw + GT_size, :]
            img_LR, img_GT = util.augment([img_LR, img_GT], self.opt.get("use_flip", True),
                                          self.opt.get("use_rot", True), rng=self.rng)
            if self.rng.random() < 0.2:  # LQGT_dataset.py:129-131
                img_GT = util.channel_convert(img_GT.shape[2], "gray", [img_GT])[0]
                img_LR = util.channel_convert(img_LR.shape[2], "gray", [img_LR])[0]
                # three channels, so batches collate and the UNet takes them
                img_GT = np.repeat(img_GT, 3, axis=2)
                img_LR = np.repeat(img_LR, 3, axis=2)
        if self.opt.get("color"):
            img_LR = util.channel_convert(img_LR.shape[2], self.opt["color"], [img_LR])[0]
            img_GT = util.channel_convert(img_GT.shape[2], self.opt["color"], [img_GT])[0]

        out = _finalize(img_GT, img_LR, self.opt.get("clip_size", 224))
        out.update({"LQ_path": LR_path, "GT_path": GT_path})
        return out

    def clip_view(self, index: int) -> np.ndarray:
        """The (224, 224, 3) CLIP view of the whole LQ image, without crop or
        augmentation, for frozen-context caching (`CachedContextDataset`).
        Unlike the reference (LQGT_dataset.py:143 takes the view of the
        augmented crop), the cached context sees the whole image; it is
        opt-in through `cache_clip_contexts`."""
        if self.is_lmdb and self.LR_env is None:
            self.LR_env = util.open_lmdb(self.opt["dataroot_LQ"])
        img_LR = util.read_img(
            self.LR_env if self.is_lmdb else None, self.LR_paths[index],
            self._resolution(self.LR_sizes, index) if self.is_lmdb else None)
        if img_LR.shape[2] == 3:
            img_LR = img_LR[:, :, ::-1].copy()     # BGR→RGB as in _finalize
        return clip_transform(img_LR, self.opt.get("clip_size", 224))


class CachedContextDataset:
    """A paired train dataset with PRECOMPUTED frozen DA-CLIP contexts.

    With `path.daclip` frozen, a sample's contexts depend only on its LQ
    image, so they are computed once (`cli.train_restoration.
    _precompute_contexts`). Samples gain 'image_context'/'text_context'
    (D,) float32 and drop 'LQ_clip', which takes the DA-CLIP forward out of
    the step. Enabled by `datasets.train.cache_clip_contexts: true`."""

    def __init__(self, ds, image_ctx: np.ndarray, text_ctx: np.ndarray):
        if not len(ds) == len(image_ctx) == len(text_ctx):
            raise ValueError(f"{len(ds)} samples, {len(image_ctx)} image contexts, "
                             f"{len(text_ctx)} text contexts")
        self.ds = ds
        self.image_ctx = image_ctx
        self.text_ctx = text_ctx

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, index: int) -> Dict:
        s = self.ds[index]
        s.pop("LQ_clip", None)
        s["image_context"] = self.image_ctx[index]
        s["text_context"] = self.text_ctx[index]
        return s


class LQDataset:
    """Unpaired LQ images (inference without GT; LQ_dataset.py)."""

    def __init__(self, opt: Dict):
        self.opt = opt
        self.LR_paths = util.get_image_paths(opt.get("data_type"), opt["dataroot_LQ"])

    def __len__(self):
        return len(self.LR_paths)

    def __getitem__(self, index: int) -> Dict:
        LR_path = self.LR_paths[index]
        img_LR = util.read_img(None, LR_path)
        if self.opt.get("color"):
            img_LR = util.channel_convert(img_LR.shape[2], self.opt["color"], [img_LR])[0]
        out = _finalize(None, img_LR, self.opt.get("clip_size", 224))
        out["LQ_path"] = LR_path
        return out


class GTDataset:
    """GT-only with Gaussian noise of `sigma` (GT_dataset.py)."""

    def __init__(self, opt: Dict):
        self.opt = opt
        self.phase = opt.get("phase", "train")
        self.GT_size = opt.get("patch_size")
        self.GT_paths = util.get_image_paths(opt.get("data_type"), opt["dataroot_GT"])
        self.rng = random.Random(opt.get("seed"))

    def __len__(self):
        return len(self.GT_paths)

    def __getitem__(self, index: int) -> Dict:
        GT_path = self.GT_paths[index]
        img_GT = util.read_img(None, GT_path)
        if self.phase == "train" and self.GT_size:
            H, W, _ = img_GT.shape
            rnd_h = self.rng.randint(0, max(0, H - self.GT_size))
            rnd_w = self.rng.randint(0, max(0, W - self.GT_size))
            img_GT = img_GT[rnd_h: rnd_h + self.GT_size, rnd_w: rnd_w + self.GT_size, :]
            img_GT = util.augment([img_GT], self.opt.get("use_flip", True),
                                  self.opt.get("use_rot", True), rng=self.rng)[0]
        sigma = self.opt.get("sigma", 25)
        img_LQ = degradations.add_gaussian_noise(img_GT, sigma, rng=self.rng)
        out = _finalize(img_GT, img_LQ, self.opt.get("clip_size", 224))
        out["GT_path"] = GT_path
        return out


_REGISTRY = {"MD": MDDataset, "MDGT": MDGTDataset, "LQGT": LQGTDataset,
             "LQ": LQDataset, "GT": GTDataset}


def create_dataset(dataset_opt: Dict):
    mode = dataset_opt["mode"]
    if mode not in _REGISTRY:
        raise NotImplementedError(f"Dataset mode {mode!r} is not recognized.")
    return _REGISTRY[mode](dataset_opt)
