"""Length bucketing with a frame mask and per-frame windows — the port of
``stgx/parallel/segments.py::pad_to_bucket`` and ``sliding_windows``. The
overlapped-segment helpers (``segment_overlapping``, ``fold_segments``)
come with the models that use them."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["pad_to_bucket", "sliding_windows"]


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


def sliding_windows(x: torch.Tensor, window: int) -> torch.Tensor:
    """``(N, L, V, C)`` → ``(N, L, W, V, C)``: frame t's window covers input
    frames ``[t − W + 1, t]``, with zeros before the start (the empty
    buffer). On x's device; the result is contiguous."""
    xp = F.pad(x, (0, 0, 0, 0, window - 1, 0))
    return xp.unfold(1, window, 1).permute(0, 1, 4, 2, 3).contiguous()
