"""numCLIP (fork) evaluation: degradation classification + level regression —
da-clip/src/evaluate_numclip.py parity (:29-352).

Counterpart of `daclip_tpu/eval/evaluate_numclip.py`, with the same flags
and output files. Per degradation-type/level directory tree (<root>/<class>/LQ,
class names like blur05, noisy25 — the generate_LQ.py layout), this:
  * classifies each image into fine/base classes from degra features,
  * runs the MultiTypeDegradationPredictor regression head over the 28
    level prompts' features → (blur, noisy, resize, jpeg) level predictions
    (zeros when the checkpoint has no predictor),
  * dumps per-class + all embeddings (.npy), predictions CSV, confusion CSV
    (no header) and PNG, and regression-values CSV (same columns as the
    reference: pred_val_{type}, gt_val, type).
The DaCLIP runs in bf16 on `--device` (default cuda; it never falls back),
the predictor in float32 on the same device.
"""
from __future__ import annotations

import argparse
import os
import re
from functools import partial

import numpy as np
import torch

from daclip_torch.data.csv_dataset import DEG_TYPE_TO_ID, build_banks
from daclip_torch.eval import (DaclipEncoders, class_dirs, class_files, load_daclip,
                               parse_checkpoint_spec, read_views)
from daclip_torch.eval.plots import plot_confusion_matrix
from daclip_torch.tokenizer import tokenize as _tokenize


def _gt_value_from_class(cname: str):
    m = re.match(r"([a-zA-Z-]+?)(\d+(?:\.\d+)?)$", cname)
    if not m:
        return None, None
    base, val = m.group(1), float(m.group(2))
    # directory names encode levels like blur05 -> 0.5 (generate_LQ grids)
    if base in ("blur", "resize") and val >= 5:
        val = val / 10.0
    return base, val


def _predictor(state: dict, device):
    """The fork's level head on `device` from its state dict, or None."""
    from daclip_torch.models.clip import MultiTypeDegradationPredictor

    if not state:
        return None
    head = MultiTypeDegradationPredictor()
    head.load_state_dict(state, strict=True)
    return head.to(device).eval()


def evaluate_checkpoint(checkpoint_path: str, dataset_path: str,
                        model_name: str = "daclip_ViT-B-32",
                        batch_size: int = 32, out_dir: str = "numclip_results",
                        max_per_class=None, display_name: str = None, device=None):
    classes, base_class_map, base_classes = class_dirs(dataset_path)
    model, cfg, pred_state = load_daclip(checkpoint_path, model_name, device)
    tokenize = partial(_tokenize, context_length=cfg.text.context_length)
    enc = DaclipEncoders(model)

    bin_bank, tok_bank = build_banks(tokenize)
    tok_features = torch.from_numpy(enc.text(tok_bank)).to(enc.device)
    bins = torch.from_numpy(bin_bank).to(enc.device)
    head = _predictor(pred_state, enc.device)
    has_predictor = head is not None

    tf_full = enc.text(tokenize(classes))
    tf_base = enc.text(tokenize(base_classes))

    os.makedirs(out_dir, exist_ok=True)
    emb_dir = os.path.join(out_dir, "embeddings")
    os.makedirs(emb_dir, exist_ok=True)
    res = int(cfg.vision.image_size)

    gt_ids, pred_ids, base_ok = [], [], []
    all_feats, all_labels, all_preds, all_gts, all_types = [], [], [], [], []
    pred_logs = []
    for ci, cname in enumerate(classes):
        cdir, files = class_files(dataset_path, cname, max_per_class)
        class_feats = []
        gt_base, gt_level = _gt_value_from_class(cname)
        for i in range(0, len(files), batch_size):
            chunk = files[i: i + batch_size]
            _, degra = enc.image(read_views([os.path.join(cdir, f) for f in chunk], res))
            class_feats.append(degra)
            p_full = (degra @ tf_full.T).argmax(-1)
            p_base = (degra @ tf_base.T).argmax(-1)
            if has_predictor:
                with torch.no_grad():
                    preds = head(torch.from_numpy(degra).to(enc.device), tok_features,
                                 bins).float().cpu().numpy()
            else:
                preds = np.zeros((len(chunk), 4), np.float32)
            for k, fname in enumerate(chunk):
                gt_ids.append(ci)
                pred_ids.append(int(p_full[k]))
                base_ok.append(base_classes[int(p_base[k])] == base_class_map[cname])
                pred_logs.append((fname, cname, classes[int(p_full[k])]))
                all_preds.append(preds[k])
                all_gts.append(gt_level if gt_level is not None else np.nan)
                all_types.append(gt_base or base_class_map[cname])
                all_labels.append(cname)
        if class_feats:
            feats = np.concatenate(class_feats, 0)
            all_feats.append(feats)
            np.save(os.path.join(emb_dir, f"{cname}_embeddings.npy"), feats)

    if all_feats:
        np.save(os.path.join(emb_dir, "all_embeddings.npy"),
                np.concatenate(all_feats, 0))
        np.save(os.path.join(emb_dir, "labels.npy"), np.asarray(all_labels))

    ckpt_name = display_name or os.path.splitext(
        os.path.basename(os.path.normpath(checkpoint_path)))[0]
    with open(os.path.join(out_dir, f"predictions_{ckpt_name}.csv"), "w") as f:
        f.write("filename,ground_truth,prediction\n")
        for row in pred_logs:
            f.write(",".join(row) + "\n")
    all_preds = np.asarray(all_preds) if all_preds else np.zeros((0, 4))
    with open(os.path.join(out_dir, f"regression_values_{ckpt_name}.csv"), "w") as f:
        f.write("pred_val_blur,pred_val_noisy,pred_val_resize,pred_val_jpeg,"
                "gt_val,type\n")
        for p, g, t in zip(all_preds, all_gts, all_types):
            f.write(f"{p[0]:.4f},{p[1]:.4f},{p[2]:.4f},{p[3]:.4f},{g},{t}\n")
    cm = np.zeros((len(classes), len(classes)), np.int64)
    for g, p in zip(gt_ids, pred_ids):
        cm[g, p] += 1
    np.savetxt(os.path.join(out_dir, f"confusion_matrix_{ckpt_name}.csv"), cm,
               fmt="%d", delimiter=",")
    plot_confusion_matrix(  # evaluate_numclip.py:327-335
        cm, classes, f"Confusion Matrix: {ckpt_name}",
        os.path.join(out_dir, f"confusion_matrix_{ckpt_name}.png"))

    acc = float(np.mean(np.asarray(gt_ids) == np.asarray(pred_ids))) if gt_ids else 0
    bacc = float(np.mean(base_ok)) if base_ok else 0
    # regression MAE per type on valid gts
    mae = {}
    for t, tid in DEG_TYPE_TO_ID.items():
        sel = [i for i, (ty, g) in enumerate(zip(all_types, all_gts))
               if ty.startswith(t[:4]) and np.isfinite(g)]
        if sel and has_predictor:
            mae[t] = float(np.mean(np.abs(all_preds[sel, tid]
                                          - np.asarray(all_gts)[sel])))
    # per-class % accuracies ordered like classes/base_classes (the reference
    # return, evaluate_numclip.py:353-356) for the cross-checkpoint plots
    gt_a, pr_a = np.asarray(gt_ids), np.asarray(pred_ids)
    full_class_acc = [
        100.0 * float(np.mean(pr_a[gt_a == i] == i)) if np.any(gt_a == i)
        else 0.0 for i in range(len(classes))]
    base_class_acc = []
    for b in base_classes:
        sel = [i for i, g in enumerate(gt_ids)
               if base_class_map[classes[g]] == b]
        base_class_acc.append(
            100.0 * float(np.mean([base_ok[i] for i in sel])) if sel else 0.0)
    print(f"fine acc {acc:.4f} | base acc {bacc:.4f} | regression MAE {mae}")
    return {"accuracy": acc, "base_accuracy": bacc, "regression_mae": mae,
            "classes": classes, "base_classes": base_classes,
            "full_class_acc": full_class_acc, "base_class_acc": base_class_acc}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", required=True)
    p.add_argument("--checkpoint", required=True, action="append",
                   help="checkpoint path or 'name=path'; repeat to compare "
                        "checkpoints (evaluate_numclip.py:359-407)")
    p.add_argument("--model", default="daclip_ViT-B-32")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--out-dir", default="numclip_results")
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
        from daclip_torch.eval.evaluate_daclip import compare_checkpoints
        compare_checkpoints(results, args.out_dir)
    return results


if __name__ == "__main__":
    main()
