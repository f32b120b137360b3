"""Offline LQ generator (reference universal-image-restoration/generate_LQ.py
:19-141): per-level degraded folders <save>/<mode>/<type><p>/{GT,LQ} and a
degraded_prompts.json of "<type> with parameter <p>" strings.

Counterpart of `daclip_tpu/tools/generate_lq.py`, with its flags and level
grids: blur and resize 0.1-3.9 in steps of 0.1, noisy 1-39, each without
the multiples of 10 of its raw range (generate_LQ.py:27-28); jpeg 10-80 in
steps of 10. Images
are read and written with cv2, imported in the call; the crop and the
degradation draw from `random.Random(seed)`, "noisy" from the global
np.random, as the JAX package's do. No torch: it runs on any host.

  python -m daclip_torch.tools.generate_lq --source imgs/ --save out/ \\
      --deg-type noisy --mode train --epochs 1
"""
from __future__ import annotations

import argparse
import json
import os
import random

import numpy as np

from daclip_torch.data.degradations import degrade, match_dim
from daclip_torch.data.util import IMG_EXTENSIONS, _cv2

DEFAULT_PARAMS = {
    "noisy": [1, 40, 1],
    "resize": [1, 40, 1],
    "blur": [1, 40, 1],
    "jpeg": [10, 80, 10],
}


def generate_LQ(source_dirs, deg_type="blur", param=None, save_path="./dataset/",
                epochs=1, mode="train", crop=(512, 512), seed=None):
    cv2 = _cv2("generate_lq")
    rng = random.Random(seed)
    param = param or DEFAULT_PARAMS[deg_type]
    filepaths = [os.path.join(s, f) for s in source_dirs
                 for f in sorted(os.listdir(s)) if f.endswith(IMG_EXTENSIONS)]
    for p_raw in range(param[0], param[1] + 1, param[2]):
        if deg_type != "jpeg" and p_raw % 10 == 0:
            continue  # generate_LQ.py:27-28
        p = p_raw / 10.0 if deg_type in ("blur", "resize") else p_raw
        level_dir = f"{save_path}/{mode}/{deg_type}{p}"
        savedir_GT, savedir_LQ = f"{level_dir}/GT", f"{level_dir}/LQ"
        os.makedirs(savedir_GT, exist_ok=True)
        os.makedirs(savedir_LQ, exist_ok=True)
        degraded_prompts = {}
        for epoch in range(epochs):
            for filename in filepaths:
                image = cv2.imread(filename)
                image_GT = match_dim(image, crop, "random", rng)
                image_LQ = (degrade(image_GT / 255.0, deg_type, p, rng) * 255).astype(np.uint8)
                epoch_filename = f"{epoch}_{os.path.basename(filename)}"
                degraded_prompts["./" + epoch_filename] = f"{deg_type} with parameter {p}"
                cv2.imwrite(os.path.join(savedir_GT, epoch_filename), image_GT)
                cv2.imwrite(os.path.join(savedir_LQ, epoch_filename), image_LQ)
        with open(os.path.join(level_dir, "degraded_prompts.json"), "w") as f:
            json.dump(degraded_prompts, f, indent=4)
        print(f"{deg_type}{p}: {len(degraded_prompts)} images")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", nargs="+", required=True)
    ap.add_argument("--save", required=True)
    ap.add_argument("--deg-type", default="blur", choices=["blur", "noisy", "resize", "jpeg"])
    ap.add_argument("--mode", default="train")
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--crop", type=int, default=512)
    ap.add_argument("--seed", type=int, default=None)
    args = ap.parse_args(argv)
    generate_LQ(args.source, args.deg_type, None, args.save, args.epochs, args.mode,
                (args.crop, args.crop), args.seed)


if __name__ == "__main__":
    main()
