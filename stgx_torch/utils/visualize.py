"""Offline visualization of training artifacts (matplotlib) — the port of
``stgx/utils/visualize.py``.

Parity with the reference implementation's plotting utility
(``utils/visualize.py``): confusion-matrix heatmap, stacked
segmentation-mask timelines (ground truth vs prediction per demo trial), and
train/validation accuracy-loss curves — all reading the CSV artifacts the
port's CLI (:mod:`stgx_torch.cli`) writes, which are the JAX CLI's.
matplotlib is imported inside the plotting functions, so that importing
this module (and :mod:`stgx_torch.utils`) works where it is missing.

CLI: ``python -m stgx_torch.utils.visualize <out_dir>`` renders PNGs next to
the CSVs (on the host; no device).
"""

from __future__ import annotations

import csv
import os
import sys

import numpy as np

__all__ = ["plot_confusion", "plot_segmentation", "plot_curves", "render_all"]


def _read_csv(path, skip_header=True):
    with open(path) as f:
        rows = list(csv.reader(f))
    if skip_header and rows and not _is_numeric(rows[0]):
        rows = rows[1:]
    return np.asarray([[float(v) for v in r] for r in rows if r])


def _is_numeric(row):
    try:
        [float(v) for v in row]
        return True
    except ValueError:
        return False


def plot_confusion(csv_path, out_path=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cm = _read_csv(csv_path, skip_header=False)
    fig, ax = plt.subplots(figsize=(6, 5))
    denom = cm.sum(axis=0, keepdims=True)
    im = ax.imshow(cm / np.maximum(denom, 1), cmap="viridis")
    ax.set_xlabel("actual class")
    ax.set_ylabel("predicted class")
    fig.colorbar(im)
    out = out_path or csv_path.replace(".csv", ".png")
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out


def plot_segmentation(csv_path, out_path=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = _read_csv(csv_path)  # rows: (label, top1)
    labels, preds = data[:, 0], data[:, 1]
    fig, axes = plt.subplots(2, 1, figsize=(10, 2.2), sharex=True)
    vmax = max(labels.max(), preds.max(), 1)
    for ax, series, title in [
        (axes[0], labels, "ground truth"),
        (axes[1], preds, "prediction"),
    ]:
        ax.imshow(
            series[None], aspect="auto", cmap="tab20", vmin=0, vmax=vmax,
            interpolation="nearest",
        )
        ax.set_yticks([])
        ax.set_ylabel(title, rotation=0, ha="right", va="center")
    axes[1].set_xlabel("frame")
    out = out_path or csv_path.replace(".csv", ".png")
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out


def plot_curves(csv_path, out_path=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = _read_csv(csv_path)
    # columns: the CLI's train-validation curve (epoch, train/val losses,
    # train/val top-k, durations); val top-k sit at columns 7/8
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 3.5))
    ax1.plot(data[:, 0], data[:, 1], label="train CE")
    ax1.plot(data[:, 0], data[:, 3], label="val CE")
    ax1.set_xlabel("epoch")
    ax1.set_ylabel("loss")
    ax1.legend()
    ax2.plot(data[:, 0], data[:, 7], label="top-1")
    ax2.plot(data[:, 0], data[:, 8], label="top-5")
    ax2.set_xlabel("epoch")
    ax2.set_ylabel("val accuracy")
    ax2.set_ylim(0, 1)
    ax2.legend()
    out = out_path or csv_path.replace(".csv", ".png")
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out


def render_all(out_dir: str) -> list[str]:
    """Render every recognized artifact CSV in a results directory."""
    rendered = []
    for f in sorted(os.listdir(out_dir)):
        path = os.path.join(out_dir, f)
        try:
            if f.startswith("confusion-matrix") and f.endswith(".csv"):
                rendered.append(plot_confusion(path))
            elif f.startswith("segmentation-") and f.endswith(".csv"):
                rendered.append(plot_segmentation(path))
            elif f == "train-validation-curve.csv":
                rendered.append(plot_curves(path))
        except Exception as e:
            print(f"skipping {f}: {e}")
    return rendered


if __name__ == "__main__":
    for p in render_all(sys.argv[1]):
        print(p)
