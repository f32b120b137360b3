"""Host-side data pipeline of the port (numpy; PNG without cv2 or PIL).

Counterpart of `daclip_tpu/data/__init__.py`. The registry of dataset
modes (reference universal-image-restoration/data/__init__.py:36-62):
  mode 'MD'   — multi-degradation paired folders <root>/<type>/{GT,LQ}
  mode 'MDGT' — GT-only folders with on-the-fly random degradation (not
                ported yet: raises NotImplementedError)
  mode 'LQGT' — paired LQ/GT folders or LMDBs
  mode 'LQ'   — unpaired LQ
  mode 'GT'   — GT with Gaussian noise
`csv_dataset` holds DA-CLIP's caption banks.
"""
from daclip_torch.data.datasets import (GTDataset, LQDataset, LQGTDataset, MDDataset,
                                        MDGTDataset, create_dataset)
from daclip_torch.data.loader import DataLoader, IterSampler, to_device


def create_dataloader(dataset, dataset_opt, opt=None, sampler=None):
    """data/__init__.py:8-33: train → the host's batch, drop_last, shuffled
    unless a sampler is given; val/test → batch 1, in order."""
    phase = dataset_opt.get("phase", "test")
    if phase == "train":
        num_hosts = (opt or {}).get("num_hosts", 1)
        batch_size = dataset_opt.get("batch_size", 1)
        if num_hosts > 1:
            if batch_size % num_hosts:
                raise ValueError(f"batch_size {batch_size} is not a multiple of "
                                 f"{num_hosts} hosts")
            batch_size //= num_hosts
        return DataLoader(dataset, batch_size=batch_size, sampler=sampler,
                          shuffle=sampler is None,
                          num_workers=dataset_opt.get("n_workers", 0), drop_last=True,
                          seed=dataset_opt.get("seed", 0) or 0)
    return DataLoader(dataset, batch_size=1, shuffle=False, drop_last=False)


__all__ = ["MDDataset", "MDGTDataset", "LQGTDataset", "LQDataset", "GTDataset",
           "create_dataset", "create_dataloader", "DataLoader", "IterSampler", "to_device"]
