"""Building blocks the RT-ST-GCN layer shares with ST-GCN — the port of the
parts of ``stgx/models/stgcn.py`` it needs: the torch-style inits, the norm
factory and the partitioned graph-conv layer. Parameter shapes are stgx's:
a GraphConv holds ``kernel (P, C_in, C_out)`` and ``bias (P, C_out)``."""

from __future__ import annotations

import torch
from torch import nn

from stgx_torch.ops.graph_conv import partitioned_gcn
from stgx_torch.ops.norms import BatchNorm, LayerNorm
from stgx_torch.ops.rt_fused import rt_fused_gcn_acc

__all__ = [
    "torch_conv_init",
    "torch_bias_init",
    "make_norm",
    "GraphConv",
    "Dense",
]


def torch_bias_init(fan_in: int):
    """torch Conv2d default bias init: U(−1/√fan_in, 1/√fan_in). Returns
    ``init(shape, generator) -> tensor``."""

    def init(shape, generator: torch.Generator):
        bound = 1.0 / (fan_in**0.5)
        return torch.empty(shape).uniform_(-bound, bound, generator=generator)

    return init


def torch_conv_init(fan_in: int):
    """torch Conv2d default weight init, kaiming_uniform(a=√5), which is
    U(−1/√fan_in, 1/√fan_in) with the torch fan-in passed explicitly."""
    return torch_bias_init(fan_in)


def make_norm(kind: str, features: int, num_joints: int, per_joint: bool = False):
    """``LayerNorm([C,1,V])`` or BatchNorm without running stats."""
    if kind == "LayerNorm":
        return LayerNorm(num_joints=num_joints, features=features)
    if kind == "BatchNorm":
        return BatchNorm(features=features, num_joints=num_joints,
                         per_joint=per_joint)
    raise ValueError(f"unknown normalization: {kind!r}")


class Dense(nn.Module):
    """``y = x @ kernel + bias`` with a flax-layout ``(in, out)`` kernel.

    The kernel and bias take torch's conv init, or with ``kernel_std`` the
    init of a flax ``nn.Dense`` given a normal kernel init: N(0, std²) and
    a zero bias."""

    def __init__(self, features_in: int, features_out: int,
                 generator: torch.Generator, kernel_std: float | None = None):
        super().__init__()
        shape = (features_in, features_out)
        if kernel_std is None:
            kernel = torch_conv_init(features_in)(shape, generator)
            bias = torch_bias_init(features_in)((features_out,), generator)
        else:
            kernel = torch.empty(shape).normal_(0.0, kernel_std, generator=generator)
            bias = torch.zeros(features_out)
        self.kernel = nn.Parameter(kernel)
        self.bias = nn.Parameter(bias)

    def forward(self, x):
        return x @ self.kernel + self.bias


class GraphConv(nn.Module):
    """Partitioned graph conv with stgx's parameter shapes."""

    def __init__(self, in_channels: int, out_channels: int, partitions: int,
                 generator: torch.Generator):
        super().__init__()
        self.kernel = nn.Parameter(torch_conv_init(in_channels)(
            (partitions, in_channels, out_channels), generator))
        self.bias = nn.Parameter(torch_bias_init(in_channels)(
            (partitions, out_channels), generator))

    def forward(self, x, A, fused_acc=None):
        """``fused_acc=(Γ, s)`` runs the RT-layer chain gcn + causal
        window-sum as one fused op (:mod:`stgx_torch.ops.rt_fused`)."""
        if fused_acc is not None:
            return rt_fused_gcn_acc(x, A, self.kernel, self.bias, *fused_acc)
        return partitioned_gcn(x, A, self.kernel, self.bias)
