"""Cog-compatible Predictor — reference predict.py:33-91, on the port.

The same setup()/predict() surface as `daclip_tpu/serve/predictor.py`; the
work is done by `daclip_torch.pipeline.DACLIPRestorer`. Images are read and
written by `data/util.py`: PNG and baseline JPEG by the port's native
decoder (`data/native_io.py`, built in `setup`), other formats through cv2
where it is installed.
"""
from __future__ import annotations

import os
import tempfile
from typing import Optional

import numpy as np


class Predictor:
    def setup(self,
              unet_path: str = "pretrained/universal-ir.pth",
              daclip_path: str = "pretrained/daclip_ViT-B-32.pt",
              sampling_mode: str = "posterior",
              sample_T: int = -1,
              device=None):
        """predict.py:34-56: build model + DA-CLIP + IR-SDE once, on `device`
        (None means CUDA). Each path is anything `DACLIPRestorer.load`
        takes: a reference torch checkpoint, daclip_tpu's orbax train dir or
        .npz, or the port's train dir. The image decoder is built here, not
        in the first request."""
        from daclip_torch.data import native_io
        from daclip_torch.pipeline import DACLIPRestorer, RestorerConfig

        native_io.load()

        self.restorer = DACLIPRestorer.load(
            unet_path, daclip_path,
            RestorerConfig(sampling_mode=sampling_mode, sample_T=sample_T),
            device=device)

    def predict(self, image: str, seed: Optional[int] = None,
                out_path: Optional[str] = None) -> str:
        """predict.py:58-91: path in → restored image path out (PNG by
        default)."""
        from daclip_torch.data.util import imread_color, save_img

        rgb = imread_color(str(image))[:, :, ::-1].astype(np.float32) / 255.0
        out_bgr = self.restorer.restore(rgb, seed=seed or 0)
        if out_path is None:
            out_path = os.path.join(tempfile.gettempdir(), "out.png")
        save_img(out_bgr, out_path)
        return out_path
