"""Data layer of the port: the directory dataset of per-trial files and the
synthetic dataset generator (its own copies of ``stgx/data``'s)."""

from stgx_torch.data.dataset import (
    SkeletonDirDataset,
    class_distribution,
    load_actions,
)

__all__ = ["SkeletonDirDataset", "class_distribution", "load_actions"]
