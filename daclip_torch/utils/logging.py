"""Training metrics to `results.jsonl`, and to TensorBoard where a writer
imports.

Counterpart of `daclip_tpu/utils/logging.py:71-110` (reference
training/main.py:374-398, train.py:351-353): one JSON row per `write`,
`{"step": n, "<prefix><key>": value, ...}`, appended and flushed. TensorBoard
event files go to `<log_dir>/tb` when `use_tensorboard` and tensorboardX or
`torch.utils.tensorboard` imports; otherwise the rows go to the jsonl file
only. wandb is not ported (`cli/train_daclip.py` refuses `--report-to
wandb`).
"""
from __future__ import annotations

import json
import os
from typing import Dict


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
