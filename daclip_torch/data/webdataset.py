"""A webdataset-style tar-shard reader for CLIP training.

Counterpart of `daclip_tpu/data/webdataset.py:26-229` (reference
da-clip/src/training/data.py:273-551: ResampledShards2, detshuffle2,
tarfile_to_samples, node splitting), on the stdlib's `tarfile`:
  * brace-expanded shard lists ("shards-{000..009}.tar", "{a,b}"), and
    "::"-separated sources with per-source upsampling weights;
  * the shard order shuffled by `random.Random(seed + epoch)` (detshuffle2),
    or drawn with replacement (`resampled`, weighted by the sources);
  * shards strided over the hosts: rank and world size from
    `torch.distributed` when it is initialised, else 0 and 1;
  * a shuffle buffer drawn from `random.Random(seed * 1000003 + epoch)`;
  * same-stem files grouped into one sample ({png/jpg, txt, json, ...}).
Both packages draw from Python's `random` in the same order, so the shard
order, the sample order and the batches equal daclip_tpu's. Images decode
with PIL, imported in the call, to uint8 RGB arrays (the port's transforms
take arrays where daclip_tpu's take the PIL image).
"""
from __future__ import annotations

import io
import json
import os
import random
import re
import tarfile
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

_IMAGE_EXTS = ("jpg", "jpeg", "png", "webp", "bmp")
_TEXT_EXTS = ("txt", "caption", "text")


def brace_expand(pattern: str) -> List[str]:
    """Expand one {000..123} or {a,b,c} group (webdataset shard syntax)."""
    m = re.search(r"\{(\d+)\.\.(\d+)\}", pattern)
    if m:
        lo, hi = m.group(1), m.group(2)
        width = len(lo)
        return [pattern[:m.start()] + str(i).zfill(width) + pattern[m.end():]
                for i in range(int(lo), int(hi) + 1)]
    m = re.search(r"\{([^{}]*,[^{}]*)\}", pattern)
    if m:
        return [pattern[:m.start()] + part + pattern[m.end():]
                for part in m.group(1).split(",")]
    return [pattern]


def expand_urls(urls) -> List[str]:
    if isinstance(urls, str):
        urls = urls.split("::")
    out: List[str] = []
    for u in urls:
        out.extend(brace_expand(u))
    return out


def _decode(name: str, data: bytes):
    ext = name.split(".")[-1].lower()
    if ext in _IMAGE_EXTS:
        from PIL import Image

        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    if ext in _TEXT_EXTS:
        return data.decode("utf-8")
    if ext == "json":
        return json.loads(data)
    if ext == "npy":
        return np.load(io.BytesIO(data))
    return data


def host_rank_and_count():
    """(rank, world size) of `torch.distributed` when it is initialised, else
    (0, 1): the shard striding daclip_tpu takes from jax.process_index/count."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank(), torch.distributed.get_world_size()
    return 0, 1


class WebDataset:
    """Iterable over dict samples from tar shards: each sample's keys are its
    files' extensions (sample['png'], sample['txt']) and '__key__'. The order
    is fixed by (seed, epoch).

    `weights`: per-source upsampling factors for the '::'-separated sources
    of `urls` (--train-data-upsampling-factors); they weigh the shard draws
    of `resampled`. `host_id` / `num_hosts` default to
    `host_rank_and_count()`."""

    def __init__(self, urls, shuffle_buffer: int = 0, seed: int = 0,
                 host_id: Optional[int] = None, num_hosts: Optional[int] = None,
                 resampled: bool = False, samples_per_epoch: Optional[int] = None,
                 weights=None):
        if isinstance(urls, str) and "::" in urls:
            sources = urls.split("::")
        else:
            sources = [urls] if isinstance(urls, str) else list(urls)
        if weights is not None and len(weights) != len(sources):
            raise ValueError(f"{len(weights)} upsampling factors for {len(sources)} sources")
        self.shards, self.shard_weights = [], []
        for si, src in enumerate(sources):
            expanded = expand_urls(src)
            self.shards.extend(expanded)
            w = 1.0 if weights is None else float(weights[si])
            self.shard_weights.extend([w] * len(expanded))
        rank, world = host_rank_and_count()
        self.host_id = rank if host_id is None else host_id
        self.num_hosts = world if num_hosts is None else num_hosts
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed
        self.epoch = 0
        self.resampled = resampled
        self.samples_per_epoch = samples_per_epoch

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _shard_list(self) -> List[str]:
        rng = random.Random(self.seed + self.epoch)  # detshuffle2
        shards = list(self.shards)
        if self.resampled:
            if any(w != 1.0 for w in self.shard_weights):
                shards = rng.choices(shards, weights=self.shard_weights, k=len(shards))
            else:
                shards = [rng.choice(shards) for _ in range(len(shards))]
        else:
            rng.shuffle(shards)
        return shards[self.host_id::self.num_hosts]

    def _iter_shard(self, path: str) -> Iterator[Dict]:
        current_key, sample = None, {}
        with tarfile.open(path) as tf:
            for member in tf:
                if not member.isfile():
                    continue
                base = os.path.basename(member.name)
                if "." not in base:
                    continue
                key, ext = base.split(".", 1)
                if key != current_key:
                    if sample:
                        yield sample
                    current_key, sample = key, {"__key__": key}
                sample[ext] = _decode(base, tf.extractfile(member).read())
        if sample:
            yield sample

    def __iter__(self) -> Iterator[Dict]:
        rng = random.Random(self.seed * 1000003 + self.epoch)
        buf: List[Dict] = []
        count = 0
        limit = self.samples_per_epoch or float("inf")
        for shard in self._shard_list():
            for sample in self._iter_shard(shard):
                if count >= limit:
                    break
                if self.shuffle_buffer > 1:
                    buf.append(sample)
                    if len(buf) >= self.shuffle_buffer:
                        idx = rng.randrange(len(buf))
                        buf[idx], buf[-1] = buf[-1], buf[idx]
                        yield buf.pop()
                        count += 1
                else:
                    yield sample
                    count += 1
            if count >= limit:
                break
        rng.shuffle(buf)
        for s in buf:
            if count >= limit:
                break
            yield s
            count += 1


class ClipWebLoader:
    """CLIP-training batches over a `WebDataset` (reference get_wds_dataset,
    training/data.py:331-426): each sample's image and caption through the
    train transform and the tokenizer, collated into {'images' (B, H, W, 3)
    float32, 'texts' (B, L) int32} numpy batches; a partial last batch is
    dropped. `len()` is `num_samples // batch_size`, which is why
    --train-num-samples is required for webdataset sources (data.py:344-352).
    A pass that ends short refills from the next shuffle epoch."""

    def __init__(self, wds: WebDataset, transform, tokenizer, batch_size: int,
                 num_samples: int):
        if num_samples <= 0:
            raise ValueError("webdataset sources need --train-num-samples (the shard list "
                             "carries no size metadata; training/data.py:344-352)")
        self.wds = wds
        self.transform = transform
        self.tokenize = tokenizer
        self.batch_size = batch_size
        self.num_batches = num_samples // batch_size

    def set_epoch(self, epoch: int):
        self.wds.set_epoch(epoch)

    def __len__(self):
        return self.num_batches

    def __iter__(self):
        imgs, caps, emitted = [], [], 0
        while emitted < self.num_batches:
            usable_any = False
            for sample in self.wds:
                img = next((v for k, v in sample.items()
                            if k.split(".")[-1].lower() in _IMAGE_EXTS), None)
                cap = next((v for k, v in sample.items()
                            if k.split(".")[-1].lower() in _TEXT_EXTS), None)
                if img is None or cap is None:
                    continue
                usable_any = True
                imgs.append(self.transform(img))
                caps.append(cap)
                if len(imgs) == self.batch_size:
                    yield {"images": np.stack(imgs).astype(np.float32),
                           "texts": np.asarray(self.tokenize(caps), np.int32)}
                    imgs, caps = [], []
                    emitted += 1
                    if emitted >= self.num_batches:
                        return
            # gate on usable pairs, not decoded samples, so that a pass with
            # none cannot spin forever; each refill advances the shuffle epoch
            if not usable_any:
                raise RuntimeError(
                    "webdataset produced no usable image+text samples from shards "
                    f"{self.wds.shards[:3]}… (check extensions: images "
                    f"{sorted(_IMAGE_EXTS)}, text {sorted(_TEXT_EXTS)})")
            self.wds.set_epoch(self.wds.epoch + 1)
