"""Single-image / folder restoration CLI on the port — predict.py parity.

Usage:
  python -m daclip_torch.cli.predict -i image.png -o out/ \
      --unet pretrained/universal-ir.pth --daclip pretrained/daclip_ViT-B-32.pt

The flags are those of `daclip_tpu.cli.predict`, plus `--device` (default
CUDA). `--unet` and `--daclip` take reference torch checkpoints or the JAX
package's flat .npz params; `--checkpoint` takes the port's train dir
(`cli/train_restoration.py`'s `training_state`, EMA parameters unless
`--no-ema`, the latest step unless `--step`). PNG is read and written by
the port's own codec (`data/png.py`); other formats need cv2.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description="DA-CLIP universal image restoration")
    p.add_argument("-i", "--input", required=True, help="image file or folder")
    p.add_argument("-o", "--output", default="results", help="output folder")
    p.add_argument("--unet", default=None, help="UNet weights: torch .pth or .npz")
    p.add_argument("--checkpoint", default=None,
                   help="the port's train dir (cli/train_restoration.py's "
                        "training_state); orbax dirs are refused")
    p.add_argument("--daclip", default=None,
                   help="DA-CLIP weights: torch .pt or .npz; omit for "
                        "context-free UNets")
    p.add_argument("--no-ema", action="store_true",
                   help="raw (non-EMA) params from a train dir")
    p.add_argument("--step", type=int, default=None,
                   help="step of a train dir (default: latest)")
    p.add_argument("--model-name", default="daclip_ViT-B-32")
    p.add_argument("--sampling-mode", default="posterior",
                   choices=["posterior", "sde", "ode"])
    p.add_argument("--T", type=int, default=100)
    p.add_argument("--sample-T", type=int, default=-1)
    p.add_argument("--max-sigma", type=float, default=50)
    p.add_argument("--tile-size", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--wild-ir", action="store_true",
                   help="wild-ir variant (ViT-L-14 contexts, scale 0.5 UNet)")
    p.add_argument("--classify", action="store_true",
                   help="also print zero-shot degradation classification")
    p.add_argument("--device", default=None, help="torch device (default cuda)")
    args = p.parse_args(argv)

    unet = args.checkpoint or args.unet
    if not unet:
        p.error("--unet or --checkpoint is required")
    from daclip_torch.utils.checkpoint import steps
    if args.checkpoint and not steps(args.checkpoint):
        p.error(f"--checkpoint {args.checkpoint!r} holds no <step>.pt files of "
                "daclip_torch's trainer (orbax train dirs are not ported)")

    from daclip_torch.data.util import imread_color, is_image_file, save_img
    from daclip_torch.pipeline import DACLIPRestorer, RestorerConfig

    cfg = RestorerConfig(model_name=args.model_name, sampling_mode=args.sampling_mode,
                         T=args.T, sample_T=args.sample_T, max_sigma=args.max_sigma,
                         tile_size=args.tile_size)
    if args.wild_ir:
        cfg = RestorerConfig(model_name="daclip_ViT-L-14", context_dim=768,
                             scale=0.5, spatial_attn_min_level=3,
                             sampling_mode=args.sampling_mode, T=args.T,
                             sample_T=args.sample_T, max_sigma=args.max_sigma,
                             tile_size=args.tile_size)
    restorer = DACLIPRestorer.load(unet, args.daclip, cfg, use_ema=not args.no_ema,
                                   step=args.step, device=args.device)

    paths = ([os.path.join(args.input, f) for f in sorted(os.listdir(args.input))]
             if os.path.isdir(args.input) else [args.input])
    os.makedirs(args.output, exist_ok=True)
    for path in paths:
        if not is_image_file(path):
            continue
        rgb = imread_color(path)[:, :, ::-1].astype(np.float32) / 255.0
        if args.classify:
            name, probs = restorer.classify_degradation(rgb)
            top = ", ".join(f"{k}={v:.2f}" for k, v in list(probs.items())[:3])
            print(f"{os.path.basename(path)}: degradation={name} ({top})")
        t0 = time.perf_counter()
        out_bgr = restorer.restore(rgb, seed=args.seed)
        dt = time.perf_counter() - t0
        out_path = os.path.join(args.output, os.path.basename(path))
        save_img(out_bgr, out_path)
        print(f"{path} -> {out_path} ({dt:.2f}s)")


if __name__ == "__main__":
    main()
