"""Eval plot artifacts — matplotlib figures matching the reference's outputs
(da-clip/src/evaluate_numclip.py:327-407, evaluate_daclip.py:150-218):
confusion-matrix PNG per checkpoint, base-class accuracy table PNG, and
cross-checkpoint full/base-class accuracy comparison plots.

The port's copy of `daclip_tpu/eval/plots.py`. Headless-safe: the Agg
backend is selected before pyplot is imported, inside the call. Without
matplotlib each function logs a warning and returns False, as daclip_tpu's
do: the plots are optional artifacts beside the CSVs."""
from __future__ import annotations

import logging
from typing import Dict, List, Sequence

import numpy as np

log = logging.getLogger(__name__)


def _plt():
    try:
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt
        return plt
    except ImportError:
        log.warning("matplotlib unavailable; skipping plot artifact")
        return None


def plot_confusion_matrix(cm: np.ndarray, classes: Sequence[str], title: str,
                          out_png: str) -> bool:
    """Blues-colormapped confusion matrix with per-cell counts
    (ConfusionMatrixDisplay parity, evaluate_numclip.py:327-335)."""
    plt = _plt()
    if plt is None:
        return False
    cm = np.asarray(cm)
    fig, ax = plt.subplots(figsize=(12, 10))
    im = ax.imshow(cm, cmap="Blues")
    ax.set_xticks(range(len(classes)), classes, rotation=90)
    ax.set_yticks(range(len(classes)), classes)
    ax.set_xlabel("Predicted label")
    ax.set_ylabel("True label")
    thresh = cm.max() / 2.0 if cm.size else 0.0
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            ax.text(j, i, f"{cm[i, j]:d}", ha="center", va="center",
                    fontsize=7,
                    color="white" if cm[i, j] > thresh else "black")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_png, dpi=300)
    plt.close(fig)
    return True


def plot_accuracy_table(results: Dict[str, List[float]],
                        row_labels: Sequence[str], title: str,
                        out_png: str) -> bool:
    """Accuracy table figure (plt.table, evaluate_numclip.py:382-391):
    one column per checkpoint/run name, one row per class."""
    plt = _plt()
    if plt is None:
        return False
    names = list(results)
    cell_text = [[f"{results[n][r]:.2f}" for n in names]
                 for r in range(len(row_labels))]
    fig = plt.figure(figsize=(8, 2 + 0.5 * len(row_labels)))
    plt.axis("off")
    table = plt.table(cellText=cell_text, rowLabels=list(row_labels),
                      colLabels=names, cellLoc="center", loc="center")
    table.scale(1, 1.5)
    plt.title(title)
    fig.savefig(out_png, bbox_inches="tight")
    plt.close(fig)
    return True


def plot_accuracy_comparison(results: Dict[str, List[float]],
                             classes: Sequence[str], title: str,
                             out_png: str, xlabel: str = "Class",
                             ylabel: str = "Accuracy (%)") -> bool:
    """Cross-checkpoint per-class accuracy line plot
    (evaluate_numclip.py:396-407)."""
    plt = _plt()
    if plt is None:
        return False
    fig = plt.figure(figsize=(max(10, 0.35 * len(classes)), 6))
    for name, accs in results.items():
        plt.plot(list(classes), list(accs), marker="o", label=name)
    plt.xticks(rotation=90)
    plt.title(title)
    plt.xlabel(xlabel)
    plt.ylabel(ylabel)
    plt.ylim(0, 100)
    plt.legend(title="Checkpoint")
    plt.grid(True)
    plt.tight_layout()
    fig.savefig(out_png)
    plt.close(fig)
    return True
