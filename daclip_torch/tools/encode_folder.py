"""Encode a folder of images with a DA-CLIP checkpoint into the .npy
embedding-dump layout consumed by tools/visualize.py.

Counterpart of `daclip_tpu/tools/encode_folder.py`, the front half of every
reference visualization script (da-clip/src/visualize_same_image_diff_level.py:
34-74, visualize/visualize_diff_param.py, visualize_cosine_similarity.py):
load a checkpoint, preprocess + encode each image in a folder with
`encode_image(control=True, normalize=True)` in bf16 on `--device`
(default cuda; it never falls back), and collect the features; the back
half is `tools/visualize.py` over the dump this writes.

Layouts:
  * flat folder: every image file directly in --input; label = filename stem
    (the reference's same-image-different-level folders, one file per level).
  * nested: --input/<label>/*.png — label = subfolder name (one level deep),
    like the generate_lq.py class trees (<label>/LQ/*.png when LQ exists).

Writes to --out: all_embeddings.npy (the --features choice), labels.npy,
filenames.npy, plus both raw dumps (degra_embeddings.npy,
image_embeddings.npy). Checkpoints may be torch .pt, daclip_tpu's orbax
train dir (`cli/train_daclip`'s) or flat .npz, or the port's DA-CLIP train
dir (`utils/native_checkpoint.py`).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from daclip_torch.eval import DaclipEncoders, load_daclip, read_views

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def _collect(root: str):
    """(path, label, filename) triples: flat folder or one-deep class tree."""
    entries = sorted(os.listdir(root))
    files = [e for e in entries if e.lower().endswith(IMG_EXTS)]
    if files:
        return [(os.path.join(root, f), os.path.splitext(f)[0], f)
                for f in files]
    out = []
    for sub in entries:
        subdir = os.path.join(root, sub)
        # generate_lq.py trees keep images under <class>/LQ
        if os.path.isdir(os.path.join(subdir, "LQ")):
            subdir = os.path.join(subdir, "LQ")
        if not os.path.isdir(subdir):
            continue
        for f in sorted(os.listdir(subdir)):
            if f.lower().endswith(IMG_EXTS):
                out.append((os.path.join(subdir, f), sub, f))
    return out


def encode_folder(checkpoint: str, input_dir: str, out_dir: str,
                  model_name: str = "daclip_ViT-B-32", batch_size: int = 32,
                  features: str = "degra", device=None,
                  dtype: torch.dtype = torch.bfloat16):
    model, cfg, _ = load_daclip(checkpoint, model_name, device, dtype)
    enc = DaclipEncoders(model)

    items = _collect(input_dir)
    if not items:
        raise SystemExit(f"no images found under {input_dir}")
    res = int(cfg.vision.image_size)
    img_feats, deg_feats = [], []
    for i in range(0, len(items), batch_size):
        chunk = items[i: i + batch_size]
        imf, degf = enc.image(read_views([p for p, _, _ in chunk], res))
        img_feats.append(imf)
        deg_feats.append(degf)
    img_feats = np.concatenate(img_feats, 0)
    deg_feats = np.concatenate(deg_feats, 0)
    labels = np.asarray([lab for _, lab, _ in items])
    fnames = np.asarray([f for _, _, f in items])

    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "degra_embeddings.npy"), deg_feats)
    np.save(os.path.join(out_dir, "image_embeddings.npy"), img_feats)
    chosen = deg_feats if features == "degra" else img_feats
    np.save(os.path.join(out_dir, "all_embeddings.npy"), chosen)
    np.save(os.path.join(out_dir, "labels.npy"), labels)
    np.save(os.path.join(out_dir, "filenames.npy"), fnames)
    return len(items)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True,
                    help="image folder (flat, or one-deep <label>/ tree)")
    ap.add_argument("--checkpoint", required=True,
                    help="torch .pt, flat .npz, or the port's DA-CLIP train dir")
    ap.add_argument("--model", default="daclip_ViT-B-32")
    ap.add_argument("--out", default="embeddings")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--features", default="degra", choices=["degra", "image"],
                    help="which tower output all_embeddings.npy holds")
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    args = ap.parse_args(argv)
    n = encode_folder(args.checkpoint, args.input, args.out, args.model,
                      args.batch_size, args.features, args.device)
    print(f"encoded {n} images -> {args.out}")
    return n


if __name__ == "__main__":
    main()
