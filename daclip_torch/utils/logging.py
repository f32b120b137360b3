"""Training metrics to `results.jsonl`, and to TensorBoard where a writer
imports; a logger and a throughput meter.

Counterpart of `daclip_tpu/utils/logging.py` (`setup_logger` :20,
`MetricWriter` :71-110, `ThroughputMeter` :120; reference
training/main.py:374-398, train.py:213-221, :351-353). `MetricWriter` writes
one JSON row per `write`,
`{"step": n, "<prefix><key>": value, ...}`, appended and flushed. TensorBoard
event files go to `<log_dir>/tb` when `use_tensorboard` and tensorboardX or
`torch.utils.tensorboard` imports; otherwise the rows go to the jsonl file
only. wandb is not ported (`cli/train_daclip.py` refuses `--report-to
wandb`).
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional


def setup_logger(name: str, log_dir: Optional[str] = None,
                 level=logging.INFO) -> logging.Logger:
    """The logger `name` at `level`, given a console handler and, with
    `log_dir`, a `<log_dir>/<name>.log` file the first time it is set up
    (logger.py:4-26's format)."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if not logger.handlers:
        fmt = logging.Formatter("%(asctime)s.%(msecs)03d - %(levelname)s: %(message)s",
                                datefmt="%y-%m-%d %H:%M:%S")
        handlers = [logging.StreamHandler()]
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            handlers.append(logging.FileHandler(os.path.join(log_dir, f"{name}.log")))
        for h in handlers:
            h.setFormatter(fmt)
            logger.addHandler(h)
    return logger


def _tb_writer(log_dir: str):
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return None
    return SummaryWriter(log_dir)


def _is_scalar(v) -> bool:
    try:
        float(v)
        return True
    except (TypeError, ValueError):
        return False


class MetricWriter:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl = open(os.path.join(log_dir, "results.jsonl"), "a")
        self.tb = _tb_writer(os.path.join(log_dir, "tb")) if use_tensorboard else None

    def write(self, step: int, metrics: Dict[str, float], prefix: str = ""):
        row = {"step": int(step)}
        row.update({f"{prefix}{k}": float(v) for k, v in metrics.items() if _is_scalar(v)})
        self.jsonl.write(json.dumps(row) + "\n")
        self.jsonl.flush()
        if self.tb is not None:
            for k, v in row.items():
                if k != "step":
                    self.tb.add_scalar(k, v, step)

    def close(self):
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()


class ThroughputMeter:
    """samples/s and samples/s a device since the last `reset`
    (training/train.py:213-221)."""

    def __init__(self, num_devices: int = 1):
        self.num_devices = num_devices
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._n = 0

    def update(self, batch_size: int):
        self._n += batch_size

    def rates(self) -> Dict[str, float]:
        sps = self._n / max(time.perf_counter() - self._t0, 1e-9)
        return {"samples_per_second": sps,
                "samples_per_second_per_device": sps / self.num_devices}
