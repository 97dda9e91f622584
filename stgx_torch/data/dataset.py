"""Skeleton datasets — the port of ``stgx/data/dataset.py``
(``SkeletonFileDataset``, ``SkeletonDirDataset``, ``class_distribution``,
``load_actions``).

* **File dataset**: one ``(N, C, L, V, M)`` ``.npy`` opened with numpy's
  ``mmap_mode="r"`` (out of core) and a pickled ``(names, labels)`` pair
  whose class ids shift **+1**, so that class 0 is the background, then
  broadcast over the trial's frames.
* **Directory dataset**: sorted per-trial ``{name}.npy`` of ``(C, L, V, M)``
  and framewise ``{name}.csv`` int labels.

Beside them an ``actions.txt`` whose first line is the background class.
Trials come out in the canonical ``(L, V, C)`` float32 layout, first body
only. The directory dataset reads its ``.npy`` files through the native
loader (:func:`stgx_torch.native.load_npy_f32`), as the JAX dataset does.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from stgx_torch.native import load_npy_f32

__all__ = ["SkeletonFileDataset", "SkeletonDirDataset", "class_distribution",
           "load_actions"]


def load_actions(path: str) -> list[str]:
    """Action names, one per line; the line count is ``num_classes``."""
    with open(path) as f:
        return f.read().rstrip("\n").split("\n")


def _to_lvc(x_clv: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(x_clv, (1, 2, 0)), dtype=np.float32)


class SkeletonFileDataset:
    """Single-file dataset of equal-length captures."""

    def __init__(self, data_file: str, label_file: str):
        self.data = np.load(data_file, mmap_mode="r")[:, :, :, :, 0]
        with open(label_file, "rb") as f:
            self.labels = pickle.load(f)[1]

    def __len__(self):
        return self.data.shape[0]

    def __getitem__(self, index: int):
        data = _to_lvc(np.array(self.data[index]))
        # +1: the classes shift up, 0 is the background
        label = np.full(data.shape[0], self.labels[index] + 1, dtype=np.int64)
        return data, label


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
        data = load_npy_f32(os.path.join(self.data_dir, f"{name}.npy"))
        labels = np.loadtxt(
            os.path.join(self.label_dir, f"{name}.csv"), delimiter=",",
            dtype=np.float64,
        ).astype(np.int64)
        return _to_lvc(data[:, :, :, 0]), labels

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
