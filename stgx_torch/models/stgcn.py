"""ST-GCN (Yan et al. 2018), the batch window classifier, and the blocks
the other families share with it — the port of ``stgx/models/stgcn.py``.

* Shared blocks: the torch-style inits, the norm factory, :class:`Dense`
  and the partitioned graph-conv layer :class:`GraphConv`. Parameter shapes
  are stgx's: a GraphConv holds ``kernel (P, C_in, C_out)`` and ``bias (P,
  C_out)``.
* :class:`StgcnLayer`: partitioned graph conv → norm → ReLU → centered
  (Γ, 1) temporal conv (strided where the layer is) → norm → dropout, plus
  the residual (zero, identity, or a strided 1×1 conv with its norm), and a
  ReLU of the sum. On the card a shared adjacency ``(P, V, V)`` takes the
  ``gcn_core`` kernel (and ``gcn_grads`` under autograd); a per-sample one
  ``(N, P, V, V)`` (AA-GCN's) stays two einsums, as the JAX package keeps
  it outside Pallas. The temporal conv is
  :func:`stgx_torch.ops.temporal.temporal_conv`.
* :class:`Stgcn`: input norm, 1×1 feature remap, the layers with per-layer
  learnable edge importance, a global (L, V) mean and a 1×1 head: a window
  ``(N, L, V, C)`` gives ``(N, num_classes)``. The ``window`` ``Trainer``
  kind and the window streaming cell turn that into per-frame predictions.

BatchNorm keeps no running stats (the framework-wide BN adaptation).
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from stgx_torch import default_device
from stgx_torch.graph import Graph
from stgx_torch.models._remat import checkpointed
from stgx_torch.ops.graph_conv import partitioned_gcn
from stgx_torch.ops.norms import BatchNorm, LayerNorm
from stgx_torch.ops.rt_fused import rt_fused_gcn_acc
from stgx_torch.ops.temporal import temporal_conv

__all__ = [
    "torch_conv_init",
    "torch_bias_init",
    "make_norm",
    "dropout",
    "GraphConv",
    "Dense",
    "StgcnLayer",
    "Stgcn",
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


def dropout(x, rate: float, generator: torch.Generator | None):
    """Inverted dropout as flax's ``nn.Dropout``: keep each element with
    probability ``1 − rate`` and scale the kept ones by ``1 / (1 − rate)``.
    The keep-mask comes from ``generator``, which the caller owns."""
    if rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


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
        """``A`` is ``(P, V, V)``, or ``(N, P, V, V)`` per sample (AA-GCN's
        attention: two einsums summed in fp32 and cast to x's type, with
        the bias carried through A, never a kernel). ``fused_acc=(Γ, s)``
        runs the RT-layer chain gcn + causal window-sum as one fused op
        (:mod:`stgx_torch.ops.rt_fused`)."""
        if A.dim() == 4:
            acc = torch.promote_types(x.dtype, torch.float32)
            agg = torch.einsum("nlvc,npvw->nlwpc", x.to(acc), A.to(acc)).to(x.dtype)
            y = torch.einsum("nlwpc,pcd->nlwd", agg.to(acc),
                             self.kernel.to(acc)).to(x.dtype)
            bias = torch.einsum("npvw,pd->nwd", A, self.bias.to(A.dtype))
            return y + bias[:, None].to(x.dtype)
        if fused_acc is not None:
            return rt_fused_gcn_acc(x, A, self.kernel, self.bias, *fused_acc)
        return partitioned_gcn(x, A, self.kernel, self.bias)


class StgcnLayer(nn.Module):
    """gcn → (norm, ReLU, temporal conv, norm, dropout) → + residual → ReLU.

    The residual is zero for ``residual=False``, the identity where the
    channels agree and the stride is 1, else a strided 1×1 conv with bias
    and its norm. Norms past the stride see the decimated mask ``mask[:,
    ::stride]``. Parameters: ``res_kernel``, ``res_bias`` and ``res_norm``
    (the 1×1 conv only), ``gcn``, ``norm`` (after the graph conv),
    ``tcn_kernel (Γ, C, C)``, ``tcn_bias`` and ``tcn_norm``.
    """

    def __init__(self, in_channels: int, out_channels: int, gamma: int,
                 partitions: int, num_joints: int, generator: torch.Generator,
                 stride: int = 1, dropout: float = 0.0, residual: bool = True,
                 normalization: str = "LayerNorm", dilation: int = 1):
        super().__init__()
        self.gamma = gamma
        self.stride = stride
        self.dilation = dilation
        self.residual = residual
        self.identity = in_channels == out_channels and stride == 1
        if residual and not self.identity:
            self.res_kernel = nn.Parameter(torch_conv_init(in_channels)(
                (in_channels, out_channels), generator))
            self.res_bias = nn.Parameter(torch_bias_init(in_channels)(
                (out_channels,), generator))
            self.res_norm = make_norm(normalization, out_channels, num_joints)
        self.gcn = GraphConv(in_channels, out_channels, partitions, generator)
        self.norm = make_norm(normalization, out_channels, num_joints)
        fan_in = out_channels * gamma
        self.tcn_kernel = nn.Parameter(torch_conv_init(fan_in)(
            (gamma, out_channels, out_channels), generator))
        self.tcn_bias = nn.Parameter(torch_bias_init(fan_in)((out_channels,), generator))
        self.tcn_norm = make_norm(normalization, out_channels, num_joints)
        self.dropout = float(dropout)

    def forward(self, x, A, mask=None, train: bool = False,
                generator: torch.Generator | None = None):
        """``train`` turns dropout on; its keep-mask is drawn from
        ``generator`` (on x's device), never from the global RNG."""
        smask = mask[:, :: self.stride] if mask is not None else None
        if not self.residual:
            res = 0.0
        elif self.identity:
            res = x
        else:
            res = self.res_norm(x[:, :: self.stride] @ self.res_kernel + self.res_bias,
                                mask=smask)
        x = torch.relu(self.norm(self.gcn(x, A), mask=mask))
        x = temporal_conv(x, self.tcn_kernel, self.tcn_bias, stride=self.stride,
                          dilation=self.dilation)
        x = self.tcn_norm(x, mask=smask)
        if train and self.dropout > 0:
            x = dropout(x, self.dropout, generator)
        return torch.relu(x + res)


class Stgcn(nn.Module):
    """Window-classifier ST-GCN: ``(N, L, V, C)`` → ``(N, num_classes)``.

    ``remat=True`` recomputes each layer's interior in the backward pass of
    a training forward (:mod:`stgx_torch.models._remat`), with the same
    dropout masks. Parameters are drawn from ``generator`` (a fresh one
    seeded 0 if None) on the CPU and the model is moved to ``device``
    (``cuda`` if None).
    """

    def __init__(self, num_classes: int, in_feat: int, graph: dict[str, Any],
                 strategy: str = "spatial", normalization: str = "BatchNorm",
                 kernel: int = 9,
                 in_ch: Sequence[int] = (64, 64, 64, 64, 128, 128, 128, 256, 256),
                 out_ch: Sequence[int] = (64, 64, 64, 128, 128, 128, 256, 256, 256),
                 stride: Sequence[int] = (1, 1, 1, 2, 1, 1, 2, 1, 1),
                 residual: Sequence[int] = (1,) * 9,
                 dropout: Sequence[float] = (0.0,) * 9,
                 importance: bool = True, remat: bool = False,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        device = default_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.remat = remat
        self.kernel = kernel
        self.in_feat = in_feat
        self.in_ch, self.out_ch = tuple(in_ch), tuple(out_ch)
        self.stride = tuple(stride)
        self.importance = importance

        g = Graph(strategy=strategy, **graph)
        self.register_buffer("A", torch.tensor(g.A, dtype=torch.float32),
                             persistent=False)
        self.num_joints = g.num_node
        self.partitions = g.A.shape[0]
        self.norm_in = make_norm(normalization, in_feat, self.num_joints,
                                 per_joint=True)
        self.fcn_in = Dense(in_feat, self.in_ch[0], generator)
        self.layers = nn.ModuleList(
            StgcnLayer(
                in_channels=self.in_ch[i],
                out_channels=self.out_ch[i],
                gamma=kernel,
                partitions=self.partitions,
                num_joints=self.num_joints,
                generator=generator,
                stride=self.stride[i],
                dropout=dropout[i],
                residual=bool(residual[i]),
                normalization=normalization,
            )
            for i in range(len(self.in_ch))
        )
        if importance:
            self.edge_importance = nn.Parameter(torch.ones(
                len(self.in_ch), self.partitions, self.num_joints, self.num_joints))
        self.fcn_out = Dense(self.out_ch[-1], num_classes, generator)
        self.to(device)

    def layer_A(self, i: int):
        return self.A * self.edge_importance[i] if self.importance else self.A

    def forward(self, x, mask=None, train: bool = False,
                generator: torch.Generator | None = None):
        """Window logits. ``mask`` is an optional ``(N, L)`` frame mask,
        decimated after each strided layer; ``train`` turns dropout on, with
        its masks drawn from ``generator``."""
        x = self.fcn_in(self.norm_in(x, mask=mask))
        for i, layer in enumerate(self.layers):
            if self.remat and train:
                x = checkpointed(layer, x, self.layer_A(i), mask=mask, train=True,
                                 generator=generator)
            else:
                x = layer(x, self.layer_A(i), mask=mask, train=train, generator=generator)
            if mask is not None:
                mask = mask[:, :: self.stride[i]]
        return self.fcn_out(x.mean(dim=(1, 2)))  # global (L, V) pool
