"""RT-ST-GCN — the continual realtime model, ported from
``stgx/models/rtstgcn.py``.

Two forms share one parameter set:

* **Batch form** (:class:`RtStgcn`): per layer a partitioned graph conv
  (edge importance folded into A), a causal uniform accumulation
  ``y[t] = Σ_{i<Γ//s} x[t−i·s]``, norm → ReLU, residual add, ReLU (if
  residual), dropout. Time is never downsampled; the stride only widens the
  tap spacing. On the card the layer core runs the ``gcn_core`` and
  ``window_sum`` kernels, or the ``rt_fused`` kernel under
  :func:`stgx_torch.ops.rt_fused.set_rt_fused`.
* **Streaming cell** (:func:`stream_step`): the same math one frame at a
  time with an O(1) shift-FIFO carry per layer, batched over B concurrent
  streams; its graph conv runs ``gcn_core`` at R = B rows.

BatchNorm keeps no running stats, in the streaming cell too: its stats are
taken over the one frame of every stream in the batch, so co-served streams
share them, and at B = 1 the per-joint input norm gives exactly its bias.
That is the reference's behaviour. FIFO ≡ batch equality therefore holds
under LayerNorm only.

Output: ``(N, L, num_classes)`` per-frame logits.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from stgx_torch import default_device
from stgx_torch.graph import Graph
from stgx_torch.models.stgcn import Dense, GraphConv, make_norm, torch_conv_init
from stgx_torch.ops.graph_conv import partitioned_gcn
from stgx_torch.ops.norms import LayerNorm, batch_norm, layer_norm
from stgx_torch.ops.rt_fused import rt_fused_enabled
from stgx_torch.ops.temporal import (
    causal_accumulate,
    causal_accumulate_step,
    init_accumulator_state,
)

__all__ = [
    "dropout",
    "RtLayer",
    "RtStgcn",
    "init_stream_state",
    "stream_step",
    "stream_sequence",
]


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


class RtLayer(nn.Module):
    """One RT-ST-GCN layer (batch form).

    The residual branch is a plain (unstrided, bias-free) 1×1 conv + norm
    when the shapes differ; the main branch is gcn → causal accumulate →
    norm → ReLU; the combine is ``dropout(relu(x + res))`` when residual,
    else ``dropout(x)``. Parameters: ``res_kernel`` and ``res_norm`` (only
    with the 1×1 conv), ``gcn``, ``norm``.
    """

    def __init__(self, in_channels: int, out_channels: int, gamma: int,
                 partitions: int, num_joints: int, generator: torch.Generator,
                 stride: int = 1, dropout: float = 0.0, residual: bool = True,
                 normalization: str = "LayerNorm"):
        super().__init__()
        self.gamma = gamma
        self.stride = stride
        self.residual = residual
        self.identity = in_channels == out_channels and stride == 1
        if residual and not self.identity:
            self.res_kernel = nn.Parameter(torch_conv_init(in_channels)(
                (in_channels, out_channels), generator))
            self.res_norm = make_norm(normalization, out_channels, num_joints)
        self.gcn = GraphConv(in_channels, out_channels, partitions, generator)
        self.norm = make_norm(normalization, out_channels, num_joints)
        self.dropout = float(dropout)

    def forward(self, x, A, mask=None, train: bool = False,
                generator: torch.Generator | None = None):
        """``train`` turns dropout on; its keep-mask is drawn from
        ``generator`` (on x's device), never from the global RNG."""
        if not self.residual:
            res = 0.0
        elif self.identity:
            res = x
        else:
            res = self.res_norm(x @ self.res_kernel, mask=mask)

        if rt_fused_enabled() and self.gamma // self.stride > 1:
            x = self.gcn(x, A, fused_acc=(self.gamma, self.stride))
        else:
            x = causal_accumulate(self.gcn(x, A), self.gamma, self.stride)
        x = torch.relu(self.norm(x, mask=mask))
        x = x + res
        if self.residual:
            x = torch.relu(x)
        if train and self.dropout > 0:
            x = dropout(x, self.dropout, generator)
        return x


class RtStgcn(nn.Module):
    """Per-frame segmentation RT-ST-GCN: ``(N, L, V, C)`` → ``(N, L, classes)``.

    ``remat=True`` (per-layer rematerialisation) is not ported yet.
    Parameters are drawn from ``generator`` (a fresh one seeded 0 if None)
    on the CPU and the model is moved to ``device`` (``cuda`` if None).
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
        if remat:
            raise NotImplementedError(
                "RT-ST-GCN remat is not ported to stgx_torch yet; see the module "
                "queue in ROADMAP.md")
        device = default_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
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
            RtLayer(
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
        """Per-frame logits. ``train`` turns dropout on, with its masks drawn
        from ``generator`` (see :func:`dropout`)."""
        x = self.norm_in(x, mask=mask)
        x = self.fcn_in(x)
        for i, layer in enumerate(self.layers):
            x = layer(x, self.layer_A(i), mask=mask, train=train,
                      generator=generator)
        x = x.mean(dim=2)  # pool joints only: (N, L, C)
        return self.fcn_out(x)


# -- streaming (FIFO) inference ----------------------------------------------


def init_stream_state(model: RtStgcn, batch: int = 1, dtype=None):
    """Zero FIFO carries for all layers (the empty-buffer start), on the
    model's device and, unless ``dtype`` is given, in its type."""
    dtype = dtype or model.A.dtype
    return [
        init_accumulator_state(
            batch, model.num_joints, model.out_ch[i], model.kernel,
            model.stride[i], dtype=dtype, device=model.A.device,
        )
        for i in range(len(model.in_ch))
    ]


def _stream_norm(norm: nn.Module, x_t, per_joint: bool = False):
    """A norm on one frame ``(B, V, C)`` with stats over that frame only."""
    x = x_t[:, None]
    if isinstance(norm, LayerNorm):
        y = layer_norm(x, norm.scale, norm.bias, norm.eps)
    else:
        y = batch_norm(x, norm.scale, norm.bias,
                       axes=(0, 1) if per_joint else (0, 1, 2), eps=norm.eps)
    return y[:, 0]


@torch.no_grad()
def stream_step(model: RtStgcn, state, x_t):
    """One frame of B streams through the whole network.

    Args:
        state: list of per-layer FIFO carries (:func:`init_stream_state`).
        x_t: ``(B, V, C_in)`` one frame per stream.

    Returns ``(logits_t (B, classes), new_state)``; under LayerNorm equal to
    frame t of the batch form.
    """
    x = _stream_norm(model.norm_in, x_t, per_joint=True)
    x = model.fcn_in(x)
    new_state = []
    for i, layer in enumerate(model.layers):
        if not layer.residual:
            res = 0.0
        elif layer.identity:
            res = x
        else:
            res = _stream_norm(layer.res_norm, x @ layer.res_kernel)
        # the graph conv on one frame: B rows of the gcn_core kernel
        y = partitioned_gcn(x[:, None], model.layer_A(i).to(x.dtype),
                            layer.gcn.kernel, layer.gcn.bias)[:, 0]
        y, st = causal_accumulate_step(state[i], y, model.kernel, model.stride[i])
        new_state.append(st)
        y = torch.relu(_stream_norm(layer.norm, y))
        x = y + res
        if layer.residual:
            x = torch.relu(x)
    x = x.mean(dim=1)  # pool joints: (B, C)
    return model.fcn_out(x), new_state


@torch.no_grad()
def stream_sequence(model: RtStgcn, x, state=None):
    """Run a ``(B, L, V, C)`` capture through the streaming cell frame by
    frame; returns ``(logits (B, L, classes), final_state)``."""
    if state is None:
        state = init_stream_state(model, batch=x.shape[0], dtype=x.dtype)
    outs = []
    for t in range(x.shape[1]):
        logits, state = stream_step(model, state, x[:, t])
        outs.append(logits)
    return torch.stack(outs, dim=1), state
