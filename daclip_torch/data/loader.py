"""Sampling, batching and host-to-device copies of the restoration data.

Counterpart of `daclip_tpu/data/loader.py:26-151` (reference
data/__init__.py:8-33, data_sampler.py:31-62):
  * IterSampler — the same per-epoch `np.random.default_rng(epoch)`
    permutation of dataset × ratio, strided across hosts,
  * DataLoader — samples fetched by a thread pool, two batches ahead, and
    collated in numpy,
  * to_device — a collated batch's HWC arrays as NCHW tensors on the device
    (pinned host memory and asynchronous copies on CUDA), in place of the
    JAX package's `device_prefetch`.

The loader keeps threads rather than torch's worker processes: a dataset
holds one `random.Random`, which all samples draw from in the order the
JAX package draws, so a seed gives the same batches in both packages.
"""
from __future__ import annotations

import collections
import concurrent.futures
from typing import Dict, Iterator, Optional

import numpy as np
import torch


class IterSampler:
    """DistIterSampler (data_sampler.py:31-62) with numpy's RNG: a
    permutation of total = ceil(len·ratio / num_hosts)·num_hosts indices mod
    len, strided by host id, reshuffled each epoch through `set_epoch`."""

    def __init__(self, dataset_len: int, host_id: int = 0, num_hosts: int = 1,
                 ratio: int = 100):
        self.dataset_len = dataset_len
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.num_samples = int(np.ceil(dataset_len * ratio / num_hosts))
        self.total_size = self.num_samples * num_hosts
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return self.num_samples

    def __iter__(self) -> Iterator[int]:
        g = np.random.default_rng(self.epoch)
        indices = g.permutation(self.total_size) % self.dataset_len
        return iter(indices[self.host_id:self.total_size:self.num_hosts].tolist())


def _collate(samples) -> Dict[str, np.ndarray]:
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(vals[0], (int, float, np.integer, np.floating)):
            out[key] = np.asarray(vals)
        else:
            out[key] = vals  # strings and paths stay lists
    return out


class DataLoader:
    """Iterates batches of collated numpy dicts; `batch_size` is the host's
    batch."""

    def __init__(self, dataset, batch_size: int, sampler: Optional[IterSampler] = None,
                 shuffle: bool = False, num_workers: int = 0, drop_last: bool = True,
                 seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.seed = seed
        self._epoch = 0

    def __len__(self):
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _indices(self):
        if self.sampler is not None:
            return list(iter(self.sampler))
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        return idx.tolist()

    def set_epoch(self, epoch: int):
        self._epoch = epoch
        if self.sampler is not None:
            self.sampler.set_epoch(epoch)

    def __iter__(self):
        indices = self._indices()
        batches = [indices[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(len(self))]
        if self.num_workers <= 0:
            for b in batches:
                yield _collate([self.dataset[i] for i in b])
            return
        # one future a SAMPLE over a shared pool, two batches ahead, so all
        # num_workers threads decode at once (a task a batch would serialise
        # the samples inside it)
        with concurrent.futures.ThreadPoolExecutor(self.num_workers) as ex:
            pending = collections.deque()
            it = iter(batches)
            submit = lambda b: pending.append([ex.submit(self.dataset.__getitem__, i)
                                               for i in b])
            for b in (next(it, None), next(it, None)):
                if b is not None:
                    submit(b)
            try:
                while pending:
                    futs = pending.popleft()
                    b = next(it, None)
                    if b is not None:
                        submit(b)
                    yield _collate([f.result() for f in futs])
            finally:  # a consumer that stops early waits only for running samples
                for futs in pending:
                    for f in futs:
                        f.cancel()


def to_device(batch: Dict, device, keys=None) -> Dict:
    """The batch's numpy arrays as tensors on `device`: 4-D HWC image
    arrays become NCHW, others keep their shape; non-array entries (paths,
    type names) are left out. On CUDA the copies come from pinned host
    memory and do not block the host. `keys` limits which entries go."""
    device = torch.device(device)
    pin = device.type == "cuda"
    out = {}
    for k, v in batch.items():
        if not isinstance(v, np.ndarray) or (keys is not None and k not in keys):
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        if t.dim() == 4:
            t = t.permute(0, 3, 1, 2).contiguous()
        if pin:
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=pin)
    return out
