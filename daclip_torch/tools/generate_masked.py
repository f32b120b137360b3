"""Masked-image generator (reference scripts/generate_masked_face.py): a
folder of images under random inpainting masks, mask·img + (1 − mask)
(deg_util.py:921-936), as an "uncompleted" degradation set <save>/{GT,LQ}.

Counterpart of `daclip_tpu/tools/generate_masked.py`, with its flags and
draws (`random.Random(seed)`; the masks of `daclip_tpu/assets/
inpainting_masks/`, read by path). Images are read and written with cv2,
imported in the call. No torch: it runs on any host.

  python -m daclip_torch.tools.generate_masked --source faces/ --save out/ [--n 100]
"""
from __future__ import annotations

import argparse
import os
import random

import numpy as np

from daclip_torch.data.degradations import add_random_mask
from daclip_torch.data.util import IMG_EXTENSIONS, _cv2


def generate_masked(source: str, save: str, n_masks: int = 100, seed: int = 0):
    cv2 = _cv2("generate_masked")
    rng = random.Random(seed)
    gt_dir = os.path.join(save, "GT")
    lq_dir = os.path.join(save, "LQ")
    os.makedirs(gt_dir, exist_ok=True)
    os.makedirs(lq_dir, exist_ok=True)
    count = 0
    for fname in sorted(os.listdir(source)):
        if not fname.endswith(IMG_EXTENSIONS):
            continue
        img = cv2.imread(os.path.join(source, fname))
        if img is None:
            continue
        masked = add_random_mask(img.astype(np.float32) / 255.0,
                                 mask_id=rng.randrange(n_masks), rng=rng)
        cv2.imwrite(os.path.join(gt_dir, fname), img)
        cv2.imwrite(os.path.join(lq_dir, fname),
                    (np.clip(masked, 0, 1) * 255).round().astype(np.uint8))
        count += 1
    print(f"masked {count} images -> {save}")
    return count


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", required=True)
    ap.add_argument("--save", required=True)
    ap.add_argument("--n", type=int, default=100, help="mask bank size")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    generate_masked(args.source, args.save, args.n, args.seed)


if __name__ == "__main__":
    main()
