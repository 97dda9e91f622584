"""Normalization with the reference family's statistics semantics.

The port of ``stgx/ops/norms.py``. Two norms exist in the model family:

* ``LayerNorm([C, 1, V])``: each ``(n, l)`` sample is normalized over its
  joint and channel dims jointly with the **unbiased** variance
  (correction 1); affine parameters are per ``(v, c)``.
* ``BatchNorm`` without running stats: **batch statistics are recomputed at
  eval time too** (the "BN adaptation" trick), with the **biased**
  variance. The input norm treats every ``(v, c)`` pair as a channel (stats
  over N, L); a layer's norm treats c as the channel (stats over N, L, V).

Both take an optional boolean frame mask ``(N, L)`` so padded frames do not
enter the statistics. Statistics are taken in fp32 under bf16 compute.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["layer_norm", "batch_norm", "LayerNorm", "BatchNorm"]


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """Per-(n, l) normalization over the (V, C) dims, unbiased variance.

    Args:
        x: ``(N, L, V, C)``.
        weight, bias: ``(V, C)``.
    """
    dt = x.dtype
    x = x.float()
    n = x.shape[-1] * x.shape[-2]
    mean = x.mean(dim=(-2, -1), keepdim=True)
    centered = x - mean
    var = (centered * centered).sum(dim=(-2, -1), keepdim=True) / (n - 1)
    x = centered / torch.sqrt(var + eps)
    return (weight * x + bias).to(dt)


def batch_norm(x, weight, bias, axes, eps: float = 1e-5, mask=None):
    """Batch-stat normalization (biased variance, no running stats).

    Args:
        x: ``(N, L, V, C)``.
        axes: ``(0, 1)`` for per-(v, c) channels (input norm) or
            ``(0, 1, 2)`` for per-c channels (layer norm).
        weight, bias: broadcastable over the kept dims.
        mask: optional ``(N, L)`` bool; masked-out frames leave the stats.
    """
    dt = x.dtype
    x = x.float()
    axes = tuple(axes)
    if mask is None:
        mean = x.mean(dim=axes, keepdim=True)
        var = (x * x).mean(dim=axes, keepdim=True) - mean * mean
    else:
        m = mask[:, :, None, None].to(x.dtype)
        count = m.sum(dim=axes, keepdim=True) * (x.shape[2] if 2 in axes else 1)
        mean = (x * m).sum(dim=axes, keepdim=True) / count
        var = (x * x * m).sum(dim=axes, keepdim=True) / count - mean * mean
    x = (x - mean) / torch.sqrt(var + eps)
    return (weight * x + bias).to(dt)


class LayerNorm(nn.Module):
    """Affine LayerNorm over the trailing (V, C) dims of ``(N, L, V, C)``."""

    def __init__(self, num_joints: int, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(num_joints, features))
        self.bias = nn.Parameter(torch.zeros(num_joints, features))

    def forward(self, x, mask=None):
        return layer_norm(x, self.scale, self.bias, self.eps)


class BatchNorm(nn.Module):
    """Batch-stat norm; ``per_joint=True`` gives the (v, c)-channel input norm."""

    def __init__(self, features: int, num_joints: int = 0,
                 per_joint: bool = False, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.axes = (0, 1) if per_joint else (0, 1, 2)
        shape = (num_joints, features) if per_joint else (features,)
        self.scale = nn.Parameter(torch.ones(shape))
        self.bias = nn.Parameter(torch.zeros(shape))

    def forward(self, x, mask=None):
        return batch_norm(x, self.scale, self.bias, self.axes, self.eps, mask)
