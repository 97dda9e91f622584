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

Under tensor parallelism (:func:`stgx_torch.parallel.tp.shard_params_tp`,
the mesh's ``model`` axis) a layer holds one block of its output channels,
as CoST-GCN's does: its whole input enters, its graph conv (``gcn_core`` on
its block of ``W``, the per-sample einsums likewise) and its strided 1×1
residual give its block, the norm and ReLU act on the block, the blocks are
gathered whole before the temporal conv (whose ``(Γ, C, C)`` kernel
contracts every channel) and that conv's block of ``W`` gives this rank's
block again; the second norm, dropout, the residual add and the ReLU act on
it, and the blocks are gathered as it leaves. ``fcn_in`` is sharded too;
``norm_in`` and the head stay whole (``TP_WHOLE``), and the edge
importance's gradient is partial (``TP_PARTIAL``).

Under sequence parallelism (the mesh's ``seq`` axis splits each window's
frames, :mod:`stgx_torch.parallel.halo`) a layer takes the temporal conv's
4 frames a side as halos, its strided residual and decimated mask at the
block's global phase, and runs its norm, dropout and the next layer on the
strided block (:func:`~stgx_torch.parallel.mesh.strided_layout`); the
head's (L, V) mean adds every rank's frames.

BatchNorm keeps no running stats (the framework-wide BN adaptation).
"""

from __future__ import annotations

import contextlib
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
from stgx_torch.parallel.halo import decimate, frame_mean, frame_split, sp_temporal_conv
from stgx_torch.parallel.mesh import Split, current_shards, strided_layout
from stgx_torch.parallel.tp import enter, gather_channels

__all__ = [
    "TP_WHOLE",
    "TP_PARTIAL",
    "torch_conv_init",
    "torch_bias_init",
    "make_norm",
    "dropout",
    "GraphConv",
    "Dense",
    "StgcnLayer",
    "Stgcn",
]


# leaves GSPMD may shard whose activation the port keeps whole, and why
TP_WHOLE = {
    "norm_in": "the per-joint input norm acts on the whole input, before the first product",
    "fcn_out": "the head's logits are read whole by the loss",
}
# whole on every rank, a share of the gradient on each: summed over model
TP_PARTIAL = ("edge_importance",)


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


def dropout(x, rate: float, generator: torch.Generator | None, channels: Split | None = None):
    """Inverted dropout as flax's ``nn.Dropout``: keep each element with
    probability ``1 − rate`` and scale the kept ones by ``1 / (1 − rate)``.
    The keep-mask comes from ``generator``, which the caller owns. Under a
    mesh (:func:`stgx_torch.parallel.mesh.use_shards`) every rank draws the
    whole batch's mask and keeps its block, so the masks are the
    one-process run's; ``channels`` (the ``model`` split of a
    tensor-parallel layer, whose ``x`` is one block of the last axis) cuts
    the mask's channel block too."""
    if rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    if rate >= 1.0:
        return torch.zeros_like(x)
    shards = current_shards()
    split_c = channels is not None and channels.size > 1
    if shards is None and not split_c:
        keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    else:  # the whole batch's mask, as one process draws it; this rank's block of it
        shape = list(x.shape if shards is None else shards.global_shape(x.shape))
        block = [slice(None)] * x.dim()
        if shards is not None:
            block[:2] = shards.block(x.shape)
        if split_c:
            k = x.shape[-1]
            shape[-1] *= channels.size
            block[-1] = slice(channels.index * k, (channels.index + 1) * k)
        keep = (torch.rand(shape, generator=generator, device=x.device) >= rate)[tuple(block)]
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class Dense(nn.Module):
    """``y = x @ kernel + bias`` with a flax-layout ``(in, out)`` kernel.

    The kernel and bias take torch's conv init, or with ``kernel_std`` the
    init of a flax ``nn.Dense`` given a normal kernel init: N(0, std²) and
    a zero bias. Under tensor parallelism (``channels``, the ``model``
    split) the kernel and bias are this rank's output block: the whole
    input enters, the blocks' outputs are gathered whole."""

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
        self.channels = Split()

    def forward(self, x):
        c = self.channels
        return gather_channels(enter(x, c) @ self.kernel + self.bias, c)


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
        self.channels = Split()  # the model split under tensor parallelism

    def forward(self, x, A, mask=None, train: bool = False,
                generator: torch.Generator | None = None):
        """``train`` turns dropout on; its keep-mask is drawn from
        ``generator`` (on x's device), never from the global RNG."""
        frames = frame_split()
        smask = decimate(mask, self.stride, frames)
        c = self.channels
        x = enter(x, c)
        if not self.residual:
            res = 0.0
        elif self.identity:
            res = c.part(x, -1)
        else:
            res = self.res_norm(decimate(x, self.stride, frames) @ self.res_kernel
                                + self.res_bias, mask=smask)
        x = torch.relu(self.norm(self.gcn(x, A), mask=mask))

        def whole(t):  # the temporal conv contracts over every channel
            return enter(gather_channels(t, c), c)

        if frames is None:
            x = temporal_conv(whole(x), self.tcn_kernel, self.tcn_bias,
                              stride=self.stride, dilation=self.dilation)
        else:
            x = sp_temporal_conv(x, self.tcn_kernel, self.tcn_bias, stride=self.stride,
                                 dilation=self.dilation, frames=frames, extended=whole)
        x = self.tcn_norm(x, mask=smask)
        if train and self.dropout > 0:
            with strided_layout(self.stride):  # the mask of the strided frames
                x = dropout(x, self.dropout, generator, c)
        return gather_channels(torch.relu(x + res), c)


class Stgcn(nn.Module):
    """Window-classifier ST-GCN: ``(N, L, V, C)`` → ``(N, num_classes)``.

    Tensor parallelism shards ``fcn_in`` and the layers (``TP_MODULES``),
    keeps ``TP_WHOLE`` whole and sums the ``TP_PARTIAL`` gradients over
    ``model``.

    ``remat=True`` recomputes each layer's interior in the backward pass of
    a training forward (:mod:`stgx_torch.models._remat`), with the same
    dropout masks. Parameters are drawn from ``generator`` (a fresh one
    seeded 0 if None) on the CPU and the model is moved to ``device``
    (``cuda`` if None).
    """

    TP_WHOLE = TP_WHOLE
    TP_PARTIAL = TP_PARTIAL

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
        self.TP_MODULES = ("fcn_in", *(f"layers.{i}" for i in range(len(self.in_ch))))
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
        with contextlib.ExitStack() as layouts:
            for i, layer in enumerate(self.layers):
                if self.remat and train:
                    x = checkpointed(layer, x, self.layer_A(i), mask=mask, train=True,
                                     generator=generator)
                else:
                    x = layer(x, self.layer_A(i), mask=mask, train=train, generator=generator)
                mask = decimate(mask, self.stride[i], frame_split())
                layouts.enter_context(strided_layout(self.stride[i]))
            # global (L, V) pool, over every seq rank's frames
            return self.fcn_out(frame_mean(x, frames=frame_split()))
