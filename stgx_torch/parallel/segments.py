"""Length bucketing with a frame mask — the port of
``stgx/parallel/segments.py::pad_to_bucket``. The window helpers
(``sliding_windows``, ``segment_overlapping``, ``fold_segments``) come with
the window models."""

from __future__ import annotations

import math

import numpy as np

__all__ = ["pad_to_bucket"]


def pad_to_bucket(x: np.ndarray, labels: np.ndarray, bucket: int):
    """Pad a single trial ``(L, V, C)`` to the next multiple of ``bucket``.

    Returns ``(x_padded, labels_padded, mask)``: zero frames, label 0 and a
    float32 mask of ones over the trial's own frames. Trials of one bucket
    share one shape, so they stack.
    """
    l = x.shape[0]
    target = max(bucket, int(math.ceil(l / bucket)) * bucket)
    pad = target - l
    xp = np.pad(x, ((0, pad), (0, 0), (0, 0)))
    yp = np.pad(labels, (0, pad))
    mask = np.zeros(target, dtype=np.float32)
    mask[:l] = 1.0
    return xp, yp, mask
