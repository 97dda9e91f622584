"""Directory dataset of unequal-length skeleton trials — the port of
``stgx/data/dataset.py`` (``SkeletonDirDataset``, ``class_distribution``,
``load_actions``).

On disk: sorted per-trial ``{name}.npy`` of ``(C, L, V, M)`` and framewise
``{name}.csv`` int labels, plus an ``actions.txt`` whose first line is the
background class. Trials come out in the canonical ``(L, V, C)`` float32
layout, first body only. Files load with plain ``np.load``.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["SkeletonDirDataset", "class_distribution", "load_actions"]


def load_actions(path: str) -> list[str]:
    """Action names, one per line; the line count is ``num_classes``."""
    with open(path) as f:
        return f.read().rstrip("\n").split("\n")


def _to_lvc(x_clv: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(x_clv, (1, 2, 0)), dtype=np.float32)


class SkeletonDirDataset:
    """Directory dataset of unequal-length trials."""

    def __init__(self, data_dir: str, label_dir: str):
        self.data_dir = data_dir
        self.label_dir = label_dir
        self.names = [
            f[: -len(".npy")]
            for f in sorted(os.listdir(data_dir))
            if f.endswith(".npy")
        ]

    def __len__(self):
        return len(self.names)

    def __getitem__(self, index: int):
        name = self.names[index]
        data = np.load(os.path.join(self.data_dir, f"{name}.npy"))
        labels = np.loadtxt(
            os.path.join(self.label_dir, f"{name}.csv"), delimiter=",",
            dtype=np.float64,
        ).astype(np.int64)
        return _to_lvc(data.astype(np.float32)[:, :, :, 0]), labels

    def lengths(self) -> list[int]:
        """Trial lengths without loading features (reads label CSVs)."""
        out = []
        for name in self.names:
            with open(os.path.join(self.label_dir, f"{name}.csv")) as f:
                out.append(sum(1 for _ in f))
        return out


def class_distribution(dataset, num_classes: int) -> np.ndarray:
    """Framewise class histogram over the whole dataset, the input to CE
    class weighting."""
    dist = np.zeros(num_classes, dtype=np.float64)
    for i in range(len(dataset)):
        _, labels = dataset[i]
        dist += np.bincount(labels, minlength=num_classes)[:num_classes]
    return dist.astype(np.float32)
