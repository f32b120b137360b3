"""Host timings of the port's restoration data path, on whatever machine runs
it (no GPU needed): PNG decode ms per row filter on one 288 × 320 image,
the other pieces of an MD training sample (crop + flip/rot, the CLIP view),
and the DataLoader's samples/s over chip_smoke.py's seeded MD tree (2 × 8
pairs, half Up- and half Paeth-filtered) at B=16, patch 256, for each
worker count given.

Usage: python scripts/torch_loader_timing.py [--workers 0 8] [--batches 2]
Prints one JSON line.
"""
import argparse
import json
import pathlib
import random
import sys
import tempfile
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (its data helpers; it runs nothing on import)
from daclip_torch.data import util  # noqa: E402
from daclip_torch.transforms import clip_transform  # noqa: E402


def median_ms(fn, repeats):
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workers", type=int, nargs="+", default=[0, 8])
    p.add_argument("--batches", type=int, default=2)
    args = p.parse_args(argv)

    out = {"png_decode_ms_288x320": chip_smoke.png_decode_ms()}
    rng = np.random.RandomState(1)
    img = rng.rand(*chip_smoke.CLI_MD_SHAPE, 3).astype(np.float32)
    r = random.Random(0)

    def crop_aug():
        h, w = r.randint(0, img.shape[0] - 256), r.randint(0, img.shape[1] - 256)
        util.augment([img[h:h + 256, w:w + 256], img[h:h + 256, w:w + 256]], rng=r)

    out["crop_augment_pair_ms"] = median_ms(crop_aug, 20)
    out["clip_view_256_ms"] = median_ms(lambda: clip_transform(img[:256, :256], 224), 5)
    with tempfile.TemporaryDirectory() as d:
        root = pathlib.Path(d)
        chip_smoke.write_md_tree(root, ["noisy", "rainy"], 8, chip_smoke.CLI_MD_SHAPE, seed=21)
        opt = dict(mode="MD", phase="train", dataroot=str(root), distortion=["noisy", "rainy"],
                   batch_size=16, patch_size=256, data_type="img", color="RGB", seed=0)
        out["loader_samples_per_s"] = {
            f"workers_{w}": chip_smoke.loader_samples_per_s(opt, w, args.batches)
            for w in args.workers}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
