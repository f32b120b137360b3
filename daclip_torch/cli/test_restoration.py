"""Restoration eval CLI on the port (reference config/daclip-sde/test.py:24-234).

Counterpart of `daclip_tpu/cli/test_restoration.py`: reads a test YAML
(options/test.yml's keys), runs the full sampler over each dataset and
reports PSNR / SSIM / PSNR_Y / SSIM_Y, LPIPS when `--lpips-weights` gives
daclip_tpu's LPIPS(alex) `.npz` (`utils/lpips.py`, on the same device), and
the average time an image.
`--unet` / `--checkpoint` take a reference torch .pth, a flat .npz, or a
train dir (`cli/train_restoration.py`'s `training_state`): the JAX
package's orbax dir or the port's (EMA parameters unless `--no-ema`);
`--save-images` writes PNG without cv2.

Usage:
  python -m daclip_torch.cli.test_restoration -opt configs/daclip-sde/test.yml \
      [--unet ... --daclip ...]
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np


def restorer_config(opt):
    """`RestorerConfig` from the options' `sde:` and `network_G.setting`."""
    from daclip_torch.pipeline import RestorerConfig

    sde_opt = opt["sde"] or {}
    net_opt = (opt["network_G"] or {}).get("setting", {}) or {}
    cdim = net_opt.get("context_dim", 512) or 512
    return RestorerConfig(
        model_name=(opt["path"] or {}).get("daclip_model")
        or ("daclip_ViT-L-14" if cdim == 768 else "daclip_ViT-B-32"),
        scale=float(net_opt.get("scale", 1.0) or 1.0),
        nf=net_opt.get("nf", 64),
        ch_mult=tuple(net_opt.get("ch_mult", (1, 2, 4, 8))),
        context_dim=net_opt.get("context_dim", 512),
        use_degra_context=bool(net_opt.get("use_degra_context", True)),
        use_image_context=bool(net_opt.get("use_image_context", True)),
        max_sigma=sde_opt.get("max_sigma", 50), T=sde_opt.get("T", 100),
        schedule=sde_opt.get("schedule", "cosine"),
        eps=sde_opt.get("eps", 0.005),
        sampling_mode=sde_opt.get("sampling_mode", "posterior"))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-opt", required=True, help="path to test yml")
    p.add_argument("--unet", default=None,
                   help="UNet weights: torch .pth, .npz, or a train dir")
    p.add_argument("--checkpoint", default=None,
                   help="a train dir (cli/train_restoration.py's training_state): "
                        "daclip_tpu's orbax dir or the port's, EMA params by default")
    p.add_argument("--daclip", default=None,
                   help="DA-CLIP weights: torch .pt, orbax train dir or .npz")
    p.add_argument("--no-ema", action="store_true",
                   help="raw (non-EMA) params from a train dir")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step of a train dir (default: latest)")
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--save-images", action="store_true",
                   help="write each restored image as PNG under results/")
    p.add_argument("--lpips-weights", default=None,
                   help="LPIPS(alex) weights .npz (daclip_tpu's layout; optional)")
    p.add_argument("--device", default=None, help="torch device (default cuda)")
    args = p.parse_args(argv)

    from daclip_torch import config as cfg_mod
    from daclip_torch.data import create_dataset, native_io
    from daclip_torch.data.util import save_img
    from daclip_torch.pipeline import DACLIPRestorer, resolve_device
    from daclip_torch.utils import metrics
    from daclip_torch.utils.lpips import LPIPS

    device = resolve_device(args.device)
    opt = cfg_mod.parse(args.opt, is_train=False)
    native_io.load()  # the image decoder is built at start-up, not for the first image
    unet_path = args.checkpoint or args.unet or opt["path"]["pretrain_model_G"]
    daclip_path = args.daclip or opt["path"]["daclip"]
    restorer = DACLIPRestorer.load(unet_path, daclip_path, restorer_config(opt),
                                   use_ema=not args.no_ema, step=args.step, device=device)
    lpips_fn = LPIPS.from_npz(args.lpips_weights, device=device) if args.lpips_weights else None

    summary = {}
    for name, dataset_opt in (opt["datasets"] or {}).items():
        ds = create_dataset(dataset_opt)
        results = {"psnr": [], "ssim": [], "psnr_y": [], "ssim_y": [], "lpips": [],
                   "time": []}
        out_dir = os.path.join(opt["path"]["results_root"] or "results", name)
        os.makedirs(out_dir, exist_ok=True)
        n = len(ds) if args.max_images is None else min(len(ds), args.max_images)
        for i in range(n):
            sample = ds[i]
            lq, gt = sample["LQ"], sample["GT"]
            t0 = time.perf_counter()
            out_bgr = restorer.restore(lq, seed=i)
            dt = time.perf_counter() - t0
            gt_bgr = metrics.array2img(gt)
            results["time"].append(dt)
            results["psnr"].append(metrics.calculate_psnr(out_bgr, gt_bgr))
            results["ssim"].append(metrics.calculate_ssim(out_bgr.astype(np.float64),
                                                          gt_bgr.astype(np.float64)))
            results["psnr_y"].append(metrics.psnr_y(out_bgr, gt_bgr))
            results["ssim_y"].append(metrics.ssim_y(out_bgr, gt_bgr))
            if lpips_fn is not None:
                results["lpips"].append(float(lpips_fn(
                    out_bgr[:, :, ::-1] / 127.5 - 1.0,
                    gt_bgr[:, :, ::-1] / 127.5 - 1.0)[0]))
            if args.save_images:
                base = os.path.splitext(os.path.basename(sample.get("LQ_path", str(i))))[0]
                save_img(out_bgr, os.path.join(out_dir, base + ".png"))
            print(f"[{i+1}/{n}] psnr={results['psnr'][-1]:.2f} "
                  f"ssim={results['ssim'][-1]:.4f} t={dt:.2f}s")
        msg = (f"{name}: PSNR {np.mean(results['psnr']):.4f} "
               f"SSIM {np.mean(results['ssim']):.4f} "
               f"PSNR_Y {np.mean(results['psnr_y']):.4f} "
               f"SSIM_Y {np.mean(results['ssim_y']):.4f} ")
        if results["lpips"]:
            msg += f"LPIPS {np.mean(results['lpips']):.4f} "
        print(msg + f"avg time {np.mean(results['time']):.3f}s")
        summary[name] = results
    return summary


if __name__ == "__main__":
    main()
