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
enter the statistics. Statistics are taken in fp32 under bf16 compute (in fp64 for fp64 input).

Under a mesh (a step run in :func:`stgx_torch.parallel.mesh.use_shards`
with its batch in several parts) the BatchNorm statistics are those of the
whole batch, as GSPMD computes them for the JAX package: the masked sums of
x and x² and the counts of every part are added over the ranks that hold
the parts, the sums by a differentiable all-reduce. Each part's count is
its own (masked frames and joints), never assumed equal: the frame blocks
of a window under ``seq`` differ in length after a stride (13/12 of a
25-frame block). LayerNorm is per frame and needs nothing there.

Under tensor parallelism (:mod:`stgx_torch.parallel.tp`) a norm sees one
block of the channels. BatchNorm's statistics are per channel and stay on
their rank. LayerNorm's ``(V, C)`` moments span every block: its mean and
its centred sum of squares are each summed over the ``model`` group (the
module's ``channels``), in the same two passes in fp32.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from stgx_torch.parallel.mesh import Split, current_shards, sum_parts

__all__ = ["layer_norm", "batch_norm", "LayerNorm", "BatchNorm"]


def layer_norm(x, weight, bias, eps: float = 1e-5, channels: Split | None = None):
    """Per-(n, l) normalization over the (V, C) dims, unbiased variance.

    Args:
        x: ``(N, L, V, C)``.
        weight, bias: ``(V, C)``.
        channels: the ``model`` split when ``x`` holds one block of the
            channels (tensor parallelism): the moments are summed over its
            group.
    """
    dt = x.dtype
    x = x.to(torch.promote_types(dt, torch.float32))
    if channels is None or channels.size == 1:
        n = x.shape[-1] * x.shape[-2]
        mean = x.mean(dim=(-2, -1), keepdim=True)
        centered = x - mean
        var = (centered * centered).sum(dim=(-2, -1), keepdim=True) / (n - 1)
    else:
        n = x.shape[-1] * channels.size * x.shape[-2]
        mean = sum_parts(x.sum(dim=(-2, -1), keepdim=True), channels.group) / n
        centered = x - mean
        var = sum_parts((centered * centered).sum(dim=(-2, -1), keepdim=True),
                        channels.group) / (n - 1)
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
    x = x.to(torch.promote_types(dt, torch.float32))
    axes = tuple(axes)
    shards = current_shards()
    if shards is not None:
        mean, var = _sharded_stats(x, axes, mask, shards)
    elif mask is None:
        mean = x.mean(dim=axes, keepdim=True)
        var = (x * x).mean(dim=axes, keepdim=True) - mean * mean
    else:
        m = mask[:, :, None, None].to(x.dtype)
        count = m.sum(dim=axes, keepdim=True) * (x.shape[2] if 2 in axes else 1)
        mean = (x * m).sum(dim=axes, keepdim=True) / count
        var = (x * x * m).sum(dim=axes, keepdim=True) / count - mean * mean
    x = (x - mean) / torch.sqrt(var + eps)
    return (weight * x + bias).to(dt)


def _sharded_stats(x, axes, mask, shards):
    """Mean and biased variance over ``axes`` of the whole batch, from this
    rank's part ``x`` (the axes include 0 and 1, the split ones)."""
    m = torch.ones(x.shape[:2], dtype=x.dtype, device=x.device) if mask is None else mask
    m = m[:, :, None, None].to(x.dtype)
    per_count = x.shape[2] if 2 in axes else 1
    count = m.sum(dim=axes, keepdim=True) * per_count
    sums = torch.cat([(x * m).sum(dim=axes, keepdim=True),
                      (x * x * m).sum(dim=axes, keepdim=True)])
    sums = sum_parts(sums, shards.group)
    total = count.detach().clone()
    dist.all_reduce(total, group=shards.group)
    mean = sums[:1] / total
    return mean, sums[1:] / total - mean * mean


class LayerNorm(nn.Module):
    """Affine LayerNorm over the trailing (V, C) dims of ``(N, L, V, C)``;
    ``channels`` is the ``model`` split under tensor parallelism."""

    def __init__(self, num_joints: int, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.channels = Split()
        self.scale = nn.Parameter(torch.ones(num_joints, features))
        self.bias = nn.Parameter(torch.zeros(num_joints, features))

    def forward(self, x, mask=None):
        return layer_norm(x, self.scale, self.bias, self.eps, self.channels)


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
