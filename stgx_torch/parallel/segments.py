"""Sequence segmentation — the port of ``stgx/parallel/segments.py``.

* :func:`pad_to_bucket`: length bucketing with a frame mask;
* :func:`sliding_windows`: per-frame receptive-field windows for the window
  classifiers (one window per frame, zeros before the start);
* :func:`segment_overlapping`, :func:`segment_padding`,
  :func:`fold_segments`: a long trial cut into chunks that overlap by Γ
  frames, stacked on the batch axis, and the per-frame predictions folded
  back (every chunk but the first loses its first ``overlap`` frames, then
  the chunks add up where they overlap).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["pad_to_bucket", "sliding_windows", "segment_overlapping", "segment_padding",
           "fold_segments"]


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


def segment_overlapping(x: torch.Tensor, segment: int, overlap: int) -> torch.Tensor:
    """``(1, L, V, C)`` → ``(num_segments, segment, V, C)`` chunks advancing
    by ``segment − overlap`` frames; L must already be padded so that the
    chunks tile it (:func:`segment_padding`)."""
    step = segment - overlap
    num = (x.shape[1] - segment) // step + 1
    return x[0].unfold(0, segment, step)[:num].permute(0, 3, 1, 2).contiguous()


def segment_padding(L: int, segment: int, overlap: int) -> int:
    """The frames to add at the end so that L splits into ``segment``-sized
    chunks advancing by ``segment − overlap``."""
    step = segment - overlap
    if L <= segment:
        return segment - L
    rem = (L - segment) % step
    return 0 if rem == 0 else step - rem


def fold_segments(preds: torch.Tensor, L: int, overlap: int) -> torch.Tensor:
    """``(num_segments, S, C)`` per-frame predictions → ``(1, L, C)``: each
    chunk but the first loses its first ``overlap`` frames, then the chunks
    are added where they overlap."""
    num, s, c = preds.shape
    step = s - overlap
    keep = torch.ones((num, s, 1), dtype=preds.dtype, device=preds.device)
    keep[1:, :overlap] = 0.0
    idx = (torch.arange(num, device=preds.device)[:, None] * step
           + torch.arange(s, device=preds.device)[None, :]).reshape(-1)
    out = torch.zeros((s + step * (num - 1), c), dtype=preds.dtype, device=preds.device)
    out.index_add_(0, idx, (preds * keep).reshape(-1, c))
    return out[None, :L]
