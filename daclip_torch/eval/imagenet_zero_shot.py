"""ImageNet zero-shot evaluation CLI — training/zero_shot.py:18-84 parity.

Counterpart of `daclip_tpu/eval/imagenet_zero_shot.py`. Expects an
ImageNet-style directory tree (<root>/<class_dir>/*.jpg) with class dirs in
sorted order mapping to the 1000 vendored classnames (any other number of
dirs: the dir names are the class names). The classifier is the mean of the
80 OpenAI templates' text features per class; top-1/top-5 from the plain
image features (no control). The model runs in bf16 on `--device` (default
cuda; it never falls back).

  python -m daclip_torch.eval.imagenet_zero_shot --dataset val/ \
      --checkpoint pretrained/daclip_ViT-B-32.pt
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from daclip_torch.eval import DaclipEncoders, read_views
from daclip_torch.eval.zero_shot import (accuracy, build_zero_shot_classifier,
                                         load_imagenet_metadata)
from daclip_torch.tokenizer import tokenize


def evaluate_with_encoders(encode_image, encode_text, dataset: str,
                           image_size: int, batch_size: int = 64,
                           max_per_class=None, classnames=None, device=None):
    """Zero-shot top-1/top-5 with already-built encoders — the in-training
    path (--imagenet-val + --zeroshot-frequency, training/train.py:380 →
    zero_shot.py:63-84). `encode_text` maps (N, L) token ids on `device`
    (default cuda) to normalised (N, D) features; `encode_image` maps
    `clip_transform`'s (B, H, W, 3) views (numpy) to normalised (B, D)
    features (numpy or a tensor)."""
    meta_names, templates = load_imagenet_metadata()
    dirs = sorted(d for d in os.listdir(dataset)
                  if os.path.isdir(os.path.join(dataset, d)))
    names = classnames or (meta_names if len(dirs) == 1000 else dirs)
    classifier = build_zero_shot_classifier(encode_text, tokenize, names,
                                            templates, device=device)   # (D, C)
    classifier = classifier.float().cpu().numpy()

    res = int(image_size)
    logits_all, targets = [], []
    for ci, d in enumerate(dirs):
        files = sorted(os.listdir(os.path.join(dataset, d)))[:max_per_class]
        for i in range(0, len(files), batch_size):
            chunk = files[i: i + batch_size]
            feats = encode_image(read_views([os.path.join(dataset, d, f) for f in chunk],
                                            res))
            if torch.is_tensor(feats):
                feats = feats.float().cpu().numpy()
            logits_all.append(100.0 * np.asarray(feats, np.float32) @ classifier)
            targets.extend([ci] * len(chunk))
    logits = np.concatenate(logits_all)
    top1, top5 = accuracy(logits, np.asarray(targets), topk=(1, 5))
    print(f"imagenet zero-shot: top1 {top1:.4f} top5 {top5:.4f} "
          f"({len(targets)} images, {len(dirs)} classes)")
    return {"imagenet-zeroshot-val-top1": top1,
            "imagenet-zeroshot-val-top5": top5}


def evaluate(checkpoint: str, dataset: str, model_name: str = "daclip_ViT-B-32",
             batch_size: int = 64, max_per_class=None, classnames=None, device=None):
    """Checkpoint-based CLI entry (a torch checkpoint). A state dict with
    `clip.` keys is a DaCLIP (`load_daclip_any`, the predictor dropped); any
    other is a plain CLIP, loaded into a new DaCLIP's `clip` (daclip_tpu's
    :73-81). The image features come without control."""
    from daclip_torch.convert import load_torch_state_dict
    from daclip_torch.models.clip import CLIPCfg, DaCLIP, get_model_config
    from daclip_torch.pipeline import resolve_device
    from daclip_torch.utils.native_checkpoint import load_daclip_any

    dev = resolve_device(device)
    cfg = CLIPCfg.from_dict(get_model_config(model_name))
    model = DaCLIP(cfg, dtype=torch.bfloat16)
    sd = load_torch_state_dict(checkpoint)
    if any(k.startswith("clip.") for k in sd):
        v = cfg.vision
        sd = load_daclip_any(checkpoint, v.image_size, None if v.is_resnet else v.patch_size)
        model.load_state_dict({k: t for k, t in sd.items() if not k.startswith("predictor.")},
                              strict=True)
    else:
        model.clip.load_state_dict(sd, strict=True)
    enc = DaclipEncoders(model.to(dev).eval())
    return evaluate_with_encoders(lambda views: enc.image(views, control=False),
                                  lambda toks: model.encode_text(toks, normalize=True),
                                  dataset, cfg.vision.image_size, batch_size, max_per_class,
                                  classnames, dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--model", default="daclip_ViT-B-32")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--max-per-class", type=int, default=None)
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    args = ap.parse_args(argv)
    return evaluate(args.checkpoint, args.dataset, args.model, args.batch_size,
                    args.max_per_class, device=args.device)


if __name__ == "__main__":
    main()
