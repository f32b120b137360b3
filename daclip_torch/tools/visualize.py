"""Embedding visualization suite — ports of the reference's analysis scripts
(da-clip/src/visualize_diff_type_TSNE.py, visualize_all.py,
visualize_emb_sequence.py, visualize/visualize_UMAP.py,
visualize/visualize_diff_param.py via --param-json, cosine heatmaps), all
operating on the .npy embedding dumps written by eval/evaluate_numclip.py;
plus the model-free LQ/GT residual grid (visualize_img_residual.py) via
--residual-root.

The port's copy of `daclip_tpu/tools/visualize.py`: host code, torch-free
(numpy, with sklearn, scipy and matplotlib imported inside the calls that
need them); UMAP falls back to t-SNE when the umap package is absent. The
residual grid reads images with the port's `data/util.read_img`.

  python -m daclip_torch.tools.visualize --embeddings numclip_results/embeddings \
      --out viz/ [--method tsne|umap] [--heatmap] [--monotonicity]
"""
from __future__ import annotations

import argparse
import os
import re
from collections import defaultdict

import numpy as np


def load_embeddings(emb_dir: str):
    feats = np.load(os.path.join(emb_dir, "all_embeddings.npy"))
    labels = np.load(os.path.join(emb_dir, "labels.npy"))
    return feats, np.asarray([str(l) for l in labels])


def _split_label(label: str):
    m = re.match(r"([a-zA-Z-]+?)(\d+(?:\.\d+)?)$", label)
    if m:
        return m.group(1), float(m.group(2))
    return label, None


def plot_projection(feats, labels, out_path: str, method: str = "tsne",
                    seed: int = 0):
    """2-D projection colored by base type, shaded by level (TSNE/UMAP plots)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if method == "umap":
        try:
            import umap
            proj = umap.UMAP(random_state=seed).fit_transform(feats)
        except ImportError:
            method = "tsne"
    if method == "tsne":
        from sklearn.manifold import TSNE
        proj = TSNE(n_components=2, random_state=seed,
                    perplexity=min(30, max(2, len(feats) // 4))).fit_transform(feats)

    bases = sorted({_split_label(l)[0] for l in labels})
    cmap = dict(zip(bases, plt.cm.tab10.colors))
    fig, ax = plt.subplots(figsize=(8, 7))
    for base in bases:
        idx = [i for i, l in enumerate(labels) if _split_label(l)[0] == base]
        levels = np.asarray([(_split_label(labels[i])[1] or 0) for i in idx])
        lo, hi = levels.min(), max(levels.max(), levels.min() + 1e-6)
        alpha = 0.3 + 0.7 * (levels - lo) / (hi - lo)
        ax.scatter(proj[idx, 0], proj[idx, 1], s=10,
                   color=cmap[base], alpha=alpha, label=base)
    ax.legend(markerscale=2, fontsize=8)
    ax.set_title(f"degradation embeddings ({method})")
    fig.savefig(out_path, dpi=200, bbox_inches="tight")
    plt.close(fig)
    return out_path


def param_colored_projection(feats, filenames, prompts, out_path: str,
                             method: str = "tsne", seed: int = 0):
    """2-D projection colored by each image's continuous degradation parameter
    (visualize/visualize_diff_param.py:30-46 behaviour): the parameter is
    parsed from the image's degraded_prompts.json entry
    ('«type» with parameter «p»', tools/generate_lq.py format) and drives a
    viridis colormap.  Join is by basename, so the './'-prefixed json keys the
    generators write match encode_folder's filenames.npy."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    by_base = {os.path.basename(str(k)): str(v) for k, v in prompts.items()}
    params, keep = [], []
    for i, fname in enumerate(filenames):
        prompt = by_base.get(os.path.basename(str(fname)))
        m = re.search(r"(\d+(?:\.\d+)?)\.?\s*$", prompt) if prompt else None
        if m:
            params.append(float(m.group(1)))
            keep.append(i)
    if not keep:
        raise ValueError("no filenames matched the prompts json")
    if len(keep) < len(filenames):
        print(f"param_colored_projection: matched {len(keep)}/{len(filenames)} "
              "filenames against the prompts json (unmatched basenames or "
              "prompts without a trailing parameter are dropped)")
    feats = np.asarray(feats)[keep]

    if method == "umap":
        try:
            import umap
            proj = umap.UMAP(random_state=seed).fit_transform(feats)
        except ImportError:
            method = "tsne"
    if method == "tsne":
        from sklearn.manifold import TSNE
        proj = TSNE(n_components=2, random_state=seed,
                    perplexity=min(30, max(2, len(feats) // 4))).fit_transform(feats)

    fig, ax = plt.subplots(figsize=(8, 6))
    sc = ax.scatter(proj[:, 0], proj[:, 1], c=np.asarray(params),
                    cmap="viridis", alpha=0.7, s=12)
    fig.colorbar(sc, label="degradation parameter")
    ax.set_title(f"parameter-colored embeddings ({method})")
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out_path


def cosine_heatmap(feats, labels, out_path: str):
    """Per-class mean-embedding cosine-similarity heatmap."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    classes = sorted(set(labels))
    means = []
    for c in classes:
        f = feats[labels == c].mean(axis=0)
        means.append(f / (np.linalg.norm(f) + 1e-8))
    sim = np.stack(means) @ np.stack(means).T
    fig, ax = plt.subplots(figsize=(10, 9))
    im = ax.imshow(sim, cmap="viridis")
    ax.set_xticks(range(len(classes)))
    ax.set_xticklabels(classes, rotation=90, fontsize=6)
    ax.set_yticks(range(len(classes)))
    ax.set_yticklabels(classes, fontsize=6)
    fig.colorbar(im)
    fig.savefig(out_path, dpi=200, bbox_inches="tight")
    plt.close(fig)
    return sim, classes


def embedding_monotonicity(feats, labels):
    """Spearman correlation of level vs distance-from-lowest-level, per base type
    (visualize_emb_sequence.py behaviour)."""
    from scipy.stats import spearmanr

    per_base = defaultdict(list)
    for i, l in enumerate(labels):
        base, level = _split_label(l)
        if level is not None:
            per_base[base].append((level, feats[i]))
    out = {}
    for base, items in per_base.items():
        items.sort(key=lambda t: t[0])
        levels = sorted({lv for lv, _ in items})
        if len(levels) < 3:
            continue
        means = {lv: np.mean([f for l2, f in items if l2 == lv], axis=0)
                 for lv in levels}
        ref = means[levels[0]] / np.linalg.norm(means[levels[0]])
        dists = [1 - float(means[lv] @ ref / np.linalg.norm(means[lv]))
                 for lv in levels]
        rho, p = spearmanr(levels, dists)
        out[base] = {"spearman_rho": float(rho), "p_value": float(p),
                     "levels": levels, "distances": dists}
    return out


def residual_grid(root_dir: str, degra_prefix: str, levels, image_name: str,
                  out_path: str):
    """LQ / GT / |LQ-GT| residual / Δresidual grid across degradation levels
    (da-clip/src/visualize_img_residual.py:14-64 behaviour): one column per
    level folder `<root>/<prefix><level>/{GT,LQ}/<image>`, Δresidual heatmap
    normalized at the 99th percentile."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from daclip_torch.data.util import read_img

    n = len(levels)
    fig, axes = plt.subplots(4, n, figsize=(3 * n, 12), squeeze=False)
    prev_residual = None
    for i, level in enumerate(levels):
        folder = f"{degra_prefix}{level}"
        gt = read_img(None, os.path.join(root_dir, folder, "GT", image_name))[..., ::-1]
        lq = read_img(None, os.path.join(root_dir, folder, "LQ", image_name))[..., ::-1]
        residual = np.abs(lq - gt)
        axes[0, i].imshow(lq)
        axes[0, i].set_title(f"{degra_prefix}{level}")
        axes[1, i].imshow(gt)
        axes[1, i].set_title("GT")
        axes[2, i].imshow(np.clip(residual, 0, 1))
        axes[2, i].set_title("Residual")
        if prev_residual is not None:
            delta_gray = np.abs(residual - prev_residual).mean(axis=-1)
            vmax = max(float(np.percentile(delta_gray, 99)), 1e-8)
            axes[3, i].imshow(delta_gray, cmap="inferno", vmin=0, vmax=vmax)
            axes[3, i].set_title("ΔResidual Heatmap")
        else:
            axes[3, i].set_title("ΔResidual")
        for r in range(4):
            axes[r, i].axis("off")
        prev_residual = residual
    fig.tight_layout()
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out_path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--embeddings")
    ap.add_argument("--out", default="viz")
    ap.add_argument("--method", default="tsne", choices=["tsne", "umap"])
    ap.add_argument("--heatmap", action="store_true")
    ap.add_argument("--monotonicity", action="store_true")
    ap.add_argument("--param-json", help="degraded_prompts.json from "
                    "tools/generate_lq.py — adds a parameter-colored "
                    "projection (visualize_diff_param.py); needs "
                    "filenames.npy next to the embeddings")
    ap.add_argument("--residual-root", help="levels folder tree "
                    "<root>/<prefix><level>/{GT,LQ}/<image> for the residual "
                    "grid (visualize_img_residual.py)")
    ap.add_argument("--residual-prefix", default="blur")
    ap.add_argument("--residual-levels", default="0.5,1.0,1.5,2.0,2.5,3.0")
    ap.add_argument("--residual-image", default=None,
                    help="image filename; default = first file in the first "
                    "level's GT folder")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.residual_root:
        levels = [lv.strip() for lv in args.residual_levels.split(",") if lv.strip()]
        image_name = args.residual_image
        if image_name is None:
            first_gt = os.path.join(args.residual_root,
                                    f"{args.residual_prefix}{levels[0]}", "GT")
            image_name = sorted(os.listdir(first_gt))[0]
        out = residual_grid(args.residual_root, args.residual_prefix, levels,
                            image_name, os.path.join(args.out, "residual_grid.png"))
        print(f"residual grid -> {out}")
        if not args.embeddings:
            return
    if not args.embeddings:
        ap.error("--embeddings is required unless --residual-root is given")
    feats, labels = load_embeddings(args.embeddings)
    plot_projection(feats, labels, os.path.join(args.out, f"{args.method}.png"),
                    args.method)
    if args.param_json:
        import json
        with open(args.param_json) as f:
            prompts = json.load(f)
        filenames = np.load(os.path.join(args.embeddings, "filenames.npy"))
        out = param_colored_projection(
            feats, filenames, prompts,
            os.path.join(args.out, f"param_{args.method}.png"), args.method)
        print(f"parameter-colored projection -> {out}")
    if args.heatmap:
        cosine_heatmap(feats, labels, os.path.join(args.out, "cosine_heatmap.png"))
    if args.monotonicity:
        import json
        res = embedding_monotonicity(feats, labels)
        with open(os.path.join(args.out, "monotonicity.json"), "w") as f:
            json.dump(res, f, indent=2)
        print(json.dumps({k: v["spearman_rho"] for k, v in res.items()},
                         indent=2))


if __name__ == "__main__":
    main()
