"""Caption CSVs for DA-CLIP training — universal-image-restoration/
generate_captions.py (:55-93) and merge_training_csv.py.

Counterpart of `daclip_tpu/tools/generate_captions.py`: for each
degradation-type folder (<root>/<type>/{GT,LQ}), caption every GT image and
write `<root>/<type>/daclip_<mode>.csv` rows (filepath = the LQ path, title =
"{caption}| {degradation}", the degradation from `degraded_prompts.json`
when it names the file, else the type); `merge` concatenates them. The
captioner is pluggable:
  --captioner constant  "an image" (the default; the degradation text is exact)
  --captioner filename  the cleaned-up file name
  --captioner blip      transformers' BLIP from a local directory (--blip-path),
                        on --device (default cuda)
PIL and transformers are imported in the calls.

  python -m daclip_torch.tools.generate_captions captions --dataroot data/train
  python -m daclip_torch.tools.generate_captions merge --root data/train \\
      --output data/train.csv
"""
from __future__ import annotations

import argparse
import json
import os


def make_captioner(kind: str, blip_path: str = None, device=None):
    """fn(PIL image, path) → caption. `device` (default cuda) is where BLIP
    runs; the other captioners use no model."""
    if kind == "constant":
        return lambda img, path: "an image"
    if kind == "filename":
        def cap(img, path):
            stem = os.path.splitext(os.path.basename(path))[0]
            return stem.split("_", 1)[-1].replace("-", " ").replace("_", " ")
        return cap
    if kind == "blip":
        import torch
        from transformers import BlipForConditionalGeneration, BlipProcessor

        from daclip_torch.pipeline import resolve_device

        dev = resolve_device(device)
        proc = BlipProcessor.from_pretrained(blip_path, local_files_only=True)
        model = BlipForConditionalGeneration.from_pretrained(
            blip_path, local_files_only=True).to(dev).eval()

        @torch.no_grad()
        def cap(img, path):
            inputs = proc(img, return_tensors="pt").to(dev)
            out = model.generate(**inputs, max_new_tokens=30)
            return proc.decode(out[0], skip_special_tokens=True)
        return cap
    raise ValueError(kind)


def generate_captions(dataroot: str, captioner, mode: str = "train", deg_types=None):
    from PIL import Image

    deg_types = deg_types or sorted(
        d for d in os.listdir(dataroot) if os.path.isdir(os.path.join(dataroot, d)))
    for deg_type in deg_types:
        base = os.path.join(dataroot, deg_type)
        gt_dir, lq_dir = os.path.join(base, "GT"), os.path.join(base, "LQ")
        prompts_path = os.path.join(base, "degraded_prompts.json")
        if not (os.path.isdir(gt_dir) and os.path.isdir(lq_dir)):
            continue
        prompts = {}
        if os.path.exists(prompts_path):
            with open(prompts_path) as f:
                prompts = json.load(f)
        rows = []
        for fname in sorted(os.listdir(gt_dir)):
            gt_path = os.path.join(gt_dir, fname)
            lq_path = os.path.join(lq_dir, fname)
            if not os.path.exists(lq_path):
                continue
            image = Image.open(gt_path).convert("RGB")
            caption = captioner(image, gt_path)
            degradation = prompts.get("./" + fname, deg_type)
            rows.append((lq_path, f"{caption}| {degradation}"))
        out_csv = os.path.join(base, f"daclip_{mode}.csv")
        with open(out_csv, "w") as f:
            f.write("filepath\ttitle\n")
            for fp, title in rows:
                f.write(f"{fp}\t{title}\n")
        print(f"{deg_type}: {len(rows)} rows -> {out_csv}")


def merge_training_csv(root_dir: str, output_csv: str, csv_name: str, sep: str = "\t"):
    """Concatenate the per-type `csv_name` files under `root_dir`; returns the
    number of rows."""
    import csv

    rows = []
    for deg in sorted(os.listdir(root_dir)):
        path = os.path.join(root_dir, deg, csv_name)
        if not os.path.exists(path):
            continue
        with open(path, newline="") as f:
            for row in csv.DictReader(f, delimiter=sep):
                rows.append((row["filepath"], row["title"]))
    with open(output_csv, "w") as f:
        f.write("filepath\ttitle\n")
        for fp, title in rows:
            f.write(f"{fp}\t{title}\n")
    print(f"merged {len(rows)} rows -> {output_csv}")
    return len(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("captions")
    g.add_argument("--dataroot", required=True)
    g.add_argument("--mode", default="train")
    g.add_argument("--captioner", default="constant", choices=["constant", "filename", "blip"])
    g.add_argument("--blip-path", default=None)
    g.add_argument("--device", default=None, help="BLIP's torch device (default cuda)")
    m = sub.add_parser("merge")
    m.add_argument("--root", required=True)
    m.add_argument("--output", required=True)
    m.add_argument("--csv-name", default="daclip_train.csv")
    args = ap.parse_args(argv)
    if args.cmd == "captions":
        generate_captions(args.dataroot,
                          make_captioner(args.captioner, args.blip_path, args.device),
                          args.mode)
    else:
        merge_training_csv(args.root, args.output, args.csv_name)


if __name__ == "__main__":
    main()
