"""Pack an image folder into a BasicSR-style LMDB for training IO.

Counterpart of `daclip_tpu/tools/create_lmdb.py`, reading through the port's
`data/util.imread`: PNG needs neither cv2 nor PIL; other formats (JPEG)
need cv2. A folder of JPEGs is packed on a host with cv2, and the LMDB then
trains where there is none. Values are raw uint8 HWC (BGR) bytes, keys are
the images' base names, and the shapes go to meta_info.pkl as 'C_H_W'
strings, the layout `data/util._read_img_lmdb` reads.

Usage: python -m daclip_torch.tools.create_lmdb --input <img_dir> --output <env_dir>
"""
from __future__ import annotations

import argparse
import os
import pickle


def create_lmdb(input_dir: str, output_dir: str, verbose: bool = True):
    from daclip_torch.data.lmdb import LmdbWriter
    from daclip_torch.data.util import get_paths_from_images, imread

    paths = sorted(get_paths_from_images(input_dir))
    # keys are base names without extension (the reference's meta_info
    # convention); where the recursive walk gives two equal names
    # (a/0001.png, b/0001.png), relative paths, so that none overwrites another
    base_keys = [os.path.splitext(os.path.basename(p))[0] for p in paths]
    if len(set(base_keys)) != len(base_keys):
        base_keys = [os.path.splitext(os.path.relpath(p, input_dir))[0].replace(os.sep, "/")
                     for p in paths]
    keys, sizes = [], []
    os.makedirs(output_dir, exist_ok=True)
    with LmdbWriter(output_dir) as w:
        for i, (p, key) in enumerate(zip(paths, base_keys)):
            img = imread(p)
            if img.ndim == 2:
                img = img[:, :, None]
            H, W, C = img.shape
            w.put(key, img.tobytes())
            keys.append(key)
            sizes.append(f"{C}_{H}_{W}")
            if verbose and (i + 1) % 500 == 0:
                print(f"  packed {i + 1}/{len(paths)}")
    with open(os.path.join(output_dir, "meta_info.pkl"), "wb") as f:
        pickle.dump({"name": os.path.basename(output_dir.rstrip("/")),
                     "keys": keys, "resolution": sizes}, f)
    if verbose:
        print(f"wrote {len(keys)} images -> {output_dir}")
    return keys, sizes


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--input", required=True, help="image folder")
    ap.add_argument("--output", required=True, help="lmdb env dir to create")
    args = ap.parse_args(argv)
    create_lmdb(args.input, args.output)


if __name__ == "__main__":
    main()
