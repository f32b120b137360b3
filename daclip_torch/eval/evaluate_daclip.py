"""Zero-shot degradation classification eval — da-clip/src/evaluate_daclip.py
parity (:32-218): classify LQ images into fine classes (directory names under the
dataset root, e.g. blur05, noisy25, ...) and base classes (the alpha prefix),
from the controller's degradation features.

Counterpart of `daclip_tpu/eval/evaluate_daclip.py`, with the same flags,
file names, CSV columns and confusion-matrix header. The DaCLIP runs in
bf16 on `--device` (default cuda; it never falls back); the text banks are
encoded once, each batch of images with `encode_image(control=True,
normalize=True)`, and the logits are 100 · degra @ textᵀ in float32 numpy.

Usage:
  python -m daclip_torch.eval.evaluate_daclip --dataset path/to/test \
      --checkpoint pretrained/daclip_ViT-B-32.pt [--model daclip_ViT-B-32]
Outputs per-class accuracy, base-class accuracy, and a confusion-matrix CSV.
"""
from __future__ import annotations

import argparse
import os
from collections import defaultdict
from functools import partial

import numpy as np

from daclip_torch.eval import (DaclipEncoders, class_dirs, class_files, load_daclip,
                               parse_checkpoint_spec, read_views)
from daclip_torch.eval.plots import (plot_accuracy_comparison, plot_accuracy_table,
                                     plot_confusion_matrix)
from daclip_torch.tokenizer import tokenize as _tokenize


def evaluate_checkpoint(checkpoint_path: str, dataset_path: str,
                        model_name: str = "daclip_ViT-B-32",
                        batch_size: int = 32, out_dir: str = "eval_results",
                        max_per_class: int = None,
                        display_name: str = None, device=None):
    classes, base_class_map, base_classes = class_dirs(dataset_path)
    model, cfg, _ = load_daclip(checkpoint_path, model_name, device)
    tokenize = partial(_tokenize, context_length=cfg.text.context_length)
    enc = DaclipEncoders(model)
    tf_full = enc.text(tokenize(classes))
    tf_base = enc.text(tokenize(base_classes))

    res = int(cfg.vision.image_size)
    gt, pred, pred_base_ok = [], [], []
    per_class = defaultdict(lambda: [0, 0])
    for ci, cname in enumerate(classes):
        cdir, files = class_files(dataset_path, cname, max_per_class)
        for i in range(0, len(files), batch_size):
            chunk = files[i: i + batch_size]
            _, degra = enc.image(read_views([os.path.join(cdir, f) for f in chunk], res))
            p = (100.0 * degra @ tf_full.T).argmax(-1)
            pb = (100.0 * degra @ tf_base.T).argmax(-1)
            for k in range(len(chunk)):
                gt.append(ci)
                pred.append(int(p[k]))
                per_class[cname][1] += 1
                per_class[cname][0] += int(p[k] == ci)
                pred_base_ok.append(
                    base_classes[int(pb[k])] == base_class_map[cname])

    acc = float(np.mean(np.asarray(gt) == np.asarray(pred))) if gt else 0.0
    base_acc = float(np.mean(pred_base_ok)) if pred_base_ok else 0.0
    os.makedirs(out_dir, exist_ok=True)
    # per-checkpoint file names, the name= label first: runs that compare
    # checkpoints share out_dir
    ckpt_name = display_name or os.path.splitext(
        os.path.basename(os.path.normpath(checkpoint_path)))[0]
    with open(os.path.join(out_dir,
                           f"per_class_accuracy_{ckpt_name}.csv"), "w") as f:
        f.write("class,correct,total,accuracy\n")
        for c, (ok, tot) in sorted(per_class.items()):
            f.write(f"{c},{ok},{tot},{ok / max(tot, 1):.4f}\n")
    # confusion matrix: CSV + PNG (evaluate_daclip.py:150-159)
    cm = np.zeros((len(classes), len(classes)), np.int64)
    for g, p in zip(gt, pred):
        cm[g, p] += 1
    np.savetxt(os.path.join(out_dir, f"confusion_matrix_{ckpt_name}.csv"),
               cm, fmt="%d", delimiter=",", header=",".join(classes))
    plot_confusion_matrix(
        cm, classes, f"Confusion Matrix: {ckpt_name}",
        os.path.join(out_dir, f"confusion_matrix_{ckpt_name}.png"))
    # % accuracy per fine/base class, ordered like `classes`/`base_classes`
    # (the reference's evaluate_checkpoint return, :162-164)
    full_class_acc = [100.0 * per_class[c][0] / max(per_class[c][1], 1)
                      for c in classes]
    base_tot, base_ok_n = defaultdict(int), defaultdict(int)
    for g, ok in zip(gt, pred_base_ok):
        b = base_class_map[classes[g]]
        base_tot[b] += 1
        base_ok_n[b] += int(ok)
    base_class_acc = [100.0 * base_ok_n[b] / max(base_tot[b], 1)
                      for b in base_classes]
    print(f"fine-class accuracy: {acc:.4f} ({len(classes)} classes)")
    print(f"base-class accuracy: {base_acc:.4f} ({len(base_classes)} classes)")
    return {"accuracy": acc, "base_accuracy": base_acc,
            "per_class": dict(per_class), "classes": classes,
            "base_classes": base_classes, "full_class_acc": full_class_acc,
            "base_class_acc": base_class_acc}


def compare_checkpoints(results: dict, out_dir: str):
    """Cross-checkpoint comparison artifacts (evaluate_daclip.py:166-218):
    base-class accuracy table + full/base per-class line plots.
    `results`: {display_name: evaluate_checkpoint(...) return}. Returns
    whether each of the three PNGs was written."""
    first = next(iter(results.values()))
    base = {n: r["base_class_acc"] for n, r in results.items()}
    full = {n: r["full_class_acc"] for n, r in results.items()}
    return [
        plot_accuracy_table(base, first["base_classes"], "Base Class Accuracy Table",
                            os.path.join(out_dir, "base_class_accuracy_table.png")),
        plot_accuracy_comparison(
            base, first["base_classes"], "Base Class Accuracy Comparison Across Checkpoints",
            os.path.join(out_dir, "compare_base_class_accuracy.png"), xlabel="Base Class"),
        plot_accuracy_comparison(
            full, first["classes"], "Full Class Accuracy Comparison Across Checkpoints",
            os.path.join(out_dir, "compare_full_class_accuracy.png"),
            xlabel="Full Class (with strength)")]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", required=True)
    p.add_argument("--checkpoint", required=True, action="append",
                   help="checkpoint path, or 'name=path'; repeat for a "
                        "cross-checkpoint comparison (the reference's "
                        "checkpoints dict, evaluate_daclip.py:167-171)")
    p.add_argument("--model", default="daclip_ViT-B-32")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--out-dir", default="eval_results")
    p.add_argument("--max-per-class", type=int, default=None)
    p.add_argument("--device", default=None, help="torch device (default cuda)")
    args = p.parse_args(argv)
    results = {}
    for spec in args.checkpoint:
        name, path = parse_checkpoint_spec(spec)
        print(f"Evaluating {name}")
        results[name] = evaluate_checkpoint(path, args.dataset, args.model,
                                            args.batch_size, args.out_dir,
                                            args.max_per_class,
                                            display_name=name, device=args.device)
    if len(results) > 1:
        compare_checkpoints(results, args.out_dir)
    return results


if __name__ == "__main__":
    main()
