"""LPIPS(alex) perceptual metric in PyTorch — weights-optional.

Counterpart of `daclip_tpu/utils/lpips.py`. The reference evaluates LPIPS
with the `lpips` pip package (test.py:82,164), whose AlexNet and linear-head
weights are downloaded at install time. Neither is vendored, so:

  * `LPIPS` implements the exact computation: the lpips scaling layer,
    AlexNet's five convs (11×11 stride 4 pad 2, 5×5 pad 2, then three 3×3
    pad 1) each with ReLU and a tap, max-pool 3/2 after convs 1 and 2,
    channel unit-normalisation (eps 1e-10), the non-negative 1×1 heads, the
    spatial mean, and the sum over the five taps;
  * its weights are daclip_tpu's `.npz` (conv{i}_w HWIO, conv{i}_b,
    lin{i}_w (1, 1, C, 1)), transposed to torch's layout on load, so one
    weights file serves both packages;
  * without weights the eval CLIs skip LPIPS.

daclip_tpu's `convert_lpips_torch`, which writes that `.npz` from the
`lpips` package, is not ported: it needs `lpips` and torchvision's AlexNet
weights, which neither machine has. Run it where they are.

Input convention matches lpips: RGB HWC (or BHWC) float in [-1, 1].
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# AlexNet conv stack config: (out_ch, kernel, stride, pad) with ReLU after each;
# maxpool(3,2) after convs 1 and 2 (AlexNet's pool after conv 5 feeds no tap,
# so it is left out: on a small image it would have no output)
_ALEX = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1),
         (256, 3, 1, 1)]
_POOL_AFTER = {0, 1}
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def _oihw(w) -> torch.Tensor:
    """An HWIO kernel as torch's OIHW."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(w, np.float32).transpose(3, 2, 0, 1)))


class LPIPS(nn.Module):
    """LPIPS(alex) on `device` (default cuda; it never falls back)."""

    def __init__(self, weights: Dict[str, np.ndarray], device=None):
        """weights keys: conv{i}_w (HWIO), conv{i}_b, lin{i}_w (1,1,C,1)."""
        from daclip_torch.pipeline import resolve_device

        super().__init__()
        for i in range(len(_ALEX)):
            self.register_buffer(f"conv{i}_w", _oihw(weights[f"conv{i}_w"]))
            self.register_buffer(f"conv{i}_b", torch.from_numpy(
                np.asarray(weights[f"conv{i}_b"], np.float32)))
            self.register_buffer(f"lin{i}_w", _oihw(weights[f"lin{i}_w"]))
        self.register_buffer("shift", torch.from_numpy(_SHIFT).reshape(1, 3, 1, 1))
        self.register_buffer("scale", torch.from_numpy(_SCALE).reshape(1, 3, 1, 1))
        self.to(resolve_device(device))

    @classmethod
    def from_npz(cls, path: str, device=None) -> "LPIPS":
        with np.load(path) as z:
            return cls(dict(z), device=device)

    def features(self, x: torch.Tensor):
        """The five ReLU taps of (B, 3, H, W) input in [-1, 1]."""
        h = (x - self.shift) / self.scale
        feats = []
        for i, (_, _, s, p) in enumerate(_ALEX):
            h = F.relu(F.conv2d(h, getattr(self, f"conv{i}_w"), getattr(self, f"conv{i}_b"),
                                stride=s, padding=p))
            feats.append(h)
            if i in _POOL_AFTER:
                h = F.max_pool2d(h, 3, 2)
        return feats

    def distance(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """(B,) distances of two (B, 3, H, W) batches in [-1, 1]."""
        total = 0.0
        for i, (xa, xb) in enumerate(zip(self.features(a), self.features(b))):
            na = xa / (torch.linalg.vector_norm(xa, dim=1, keepdim=True) + 1e-10)
            nb = xb / (torch.linalg.vector_norm(xb, dim=1, keepdim=True) + 1e-10)
            d = F.conv2d((na - nb) ** 2, getattr(self, f"lin{i}_w"))
            total = total + d.mean(dim=(1, 2, 3))
        return total

    @torch.no_grad()
    def forward(self, img_a: np.ndarray, img_b: np.ndarray) -> np.ndarray:
        """img_*: HWC or BHWC RGB in [-1,1] (numpy) → (B,) float32 numpy."""
        dev = self.shift.device

        def nchw(img):
            t = torch.as_tensor(np.asarray(img, np.float32))
            if t.ndim == 3:
                t = t[None]
            return t.permute(0, 3, 1, 2).contiguous().to(dev)

        return self.distance(nchw(img_a), nchw(img_b)).cpu().numpy()
