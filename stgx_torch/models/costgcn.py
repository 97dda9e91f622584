"""CoST-GCN — the continual ST-GCN baseline, ported from
``stgx/models/costgcn.py``.

Two forms share one parameter set:

* **Batch form** (:class:`CoStgcn`): per layer a partitioned graph conv
  (edge importance folded into A), norm → ReLU, a *causal* Γ-tap temporal
  conv dilated by the layer's ``dilation`` (no temporal downsampling),
  norm, dropout, then ReLU of the sum with the residual delayed by Γ//2
  frames, so that both branches refer to the same frame. On the card the
  graph conv runs the ``gcn_core`` kernel (and ``gcn_grads`` under
  autograd); the temporal conv is ``F.conv2d`` (cuDNN), as the JAX package
  runs it through XLA's convolution rather than a Pallas kernel.
* **Streaming cell** (:func:`stream_step`): the same math one frame at a
  time, batched over B streams, with two shift FIFOs a layer (newest in
  the last slot): the main FIFO of the last ``(Γ−1)·d + 1`` graph-conv
  outputs, and the residual FIFO of the last Γ//2 residual values. Its
  graph conv runs ``gcn_core`` at R = B rows.

BatchNorm keeps no running stats, in the streaming cell too (the stats of a
frame are taken over every stream in the batch), so stream ≡ batch holds
under LayerNorm only, the family's published normalization.

Output: ``(N, L, num_classes)`` per-frame logits.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from stgx_torch import default_device
from stgx_torch.graph import Graph
from stgx_torch.models._remat import checkpointed
from stgx_torch.models.rtstgcn import _stream_norm, dropout
from stgx_torch.models.stgcn import (
    Dense,
    GraphConv,
    make_norm,
    torch_bias_init,
    torch_conv_init,
)
from stgx_torch.ops.graph_conv import partitioned_gcn
from stgx_torch.ops.temporal import temporal_conv

__all__ = [
    "CoStgcnLayer",
    "CoStgcn",
    "init_stream_state",
    "stream_step",
    "stream_sequence",
]


class CoStgcnLayer(nn.Module):
    """gcn → (norm, ReLU, causal dilated conv, norm, dropout) → + res[t − Γ//2].

    The residual branch is a 1×1 conv with bias and a norm where the
    channel counts differ, the identity where they agree, and absent when
    ``residual`` is off. Parameters: ``res_kernel``, ``res_bias`` and
    ``res_norm`` (the 1×1 conv only), ``gcn``, ``norm`` (after the graph
    conv), ``tcn_kernel (Γ, C, C)``, ``tcn_bias`` and ``tcn_norm``.
    """

    def __init__(self, in_channels: int, out_channels: int, gamma: int,
                 partitions: int, num_joints: int, generator: torch.Generator,
                 dilation: int = 1, dropout: float = 0.0, residual: bool = True,
                 normalization: str = "LayerNorm"):
        super().__init__()
        self.gamma = gamma
        self.dilation = dilation
        self.residual = residual
        self.identity = in_channels == out_channels
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
        if not self.residual:
            res = 0.0
        else:
            res = x if self.identity else self.res_norm(
                x @ self.res_kernel + self.res_bias, mask=mask)
            # delayed by Γ//2: frame t of the main branch meets res[t − Γ//2]
            res = F.pad(res, (0, 0, 0, 0, self.gamma // 2, 0))[:, : x.shape[1]]
        x = torch.relu(self.norm(self.gcn(x, A), mask=mask))
        x = temporal_conv(x, self.tcn_kernel, self.tcn_bias, dilation=self.dilation,
                          padding="causal")
        x = self.tcn_norm(x, mask=mask)
        if train and self.dropout > 0:
            x = dropout(x, self.dropout, generator)
        return torch.relu(x + res)


class CoStgcn(nn.Module):
    """Continual ST-GCN: ``(N, L, V, C)`` → per-frame logits ``(N, L, classes)``.

    ``remat=True`` recomputes each layer's interior in the backward pass of
    a training forward (:mod:`stgx_torch.models._remat`), with the same
    dropout masks. Parameters are drawn from ``generator`` (a fresh one
    seeded 0 if None) on the CPU and the model is moved to ``device``
    (``cuda`` if None).
    """

    def __init__(self, num_classes: int, in_feat: int, graph: dict[str, Any],
                 strategy: str = "spatial", normalization: str = "LayerNorm",
                 kernel: int = 9,
                 in_ch: Sequence[int] = (64, 64, 64, 64, 128, 128, 128, 256, 256),
                 out_ch: Sequence[int] = (64, 64, 64, 128, 128, 128, 256, 256, 256),
                 dilation: Sequence[int] = (1, 1, 1, 2, 1, 1, 2, 1, 1),
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
        self.dilation = tuple(dilation)
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
            CoStgcnLayer(
                in_channels=self.in_ch[i],
                out_channels=self.out_ch[i],
                gamma=kernel,
                partitions=self.partitions,
                num_joints=self.num_joints,
                generator=generator,
                dilation=self.dilation[i],
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
        from ``generator``."""
        x = self.fcn_in(self.norm_in(x, mask=mask))
        for i, layer in enumerate(self.layers):
            if self.remat and train:
                x = checkpointed(layer, x, self.layer_A(i), mask=mask, train=True,
                                 generator=generator)
            else:
                x = layer(x, self.layer_A(i), mask=mask, train=train, generator=generator)
        return self.fcn_out(x.mean(dim=2))  # pool joints only: (N, L, C)


# -- streaming form -----------------------------------------------------------


def init_stream_state(model: CoStgcn, batch: int = 1, dtype=None):
    """Empty carries for all layers, on the model's device and, unless
    ``dtype`` is given, in its type: a main FIFO of depth ``(Γ−1)·d + 1``
    and a residual FIFO of depth ``max(Γ//2, 1)``, all zeros."""
    dtype = dtype or model.A.dtype
    v, device = model.num_joints, model.A.device
    return [
        {
            "fifo": torch.zeros(((model.kernel - 1) * model.dilation[i] + 1, batch, v, c),
                                dtype=dtype, device=device),
            "res_fifo": torch.zeros((max(model.kernel // 2, 1), batch, v, c),
                                    dtype=dtype, device=device),
        }
        for i, c in enumerate(model.out_ch)
    ]


@torch.no_grad()
def stream_step(model: CoStgcn, state, x_t):
    """One frame of B streams through the whole network.

    Args:
        state: list of per-layer carries (:func:`init_stream_state`).
        x_t: ``(B, V, C_in)`` one frame per stream.

    Returns ``(logits_t (B, classes), new_state)``; under LayerNorm equal to
    frame t of the batch form.
    """
    x = model.fcn_in(_stream_norm(model.norm_in, x_t, per_joint=True))
    delay = model.kernel // 2
    new_state = []
    for i, layer in enumerate(model.layers):
        st = state[i]
        res, res_fifo = 0.0, st["res_fifo"]
        if layer.residual:
            res = x if layer.identity else _stream_norm(
                layer.res_norm, x @ layer.res_kernel + layer.res_bias)
            if delay > 0:  # slot 0 holds frame t − Γ//2; shift this frame in
                res, res_fifo = res_fifo[0], torch.cat([res_fifo[1:], res[None]])
        # the graph conv on one frame: B rows of the gcn_core kernel
        y = partitioned_gcn(x[:, None], model.layer_A(i).to(x.dtype), layer.gcn.kernel,
                            layer.gcn.bias)[:, 0]
        y = torch.relu(_stream_norm(layer.norm, y))
        fifo = torch.cat([st["fifo"][1:], y[None]])
        # the batch form's y[t] = Σ_j W[j]·u[t − (Γ−1−j)·d]: u[t − (Γ−1−j)·d]
        # sits at slot j·d (depth − 1 = (Γ−1)·d), so the taps are the strided
        # view fifo[::d] against W as it is (no host-built index, no mask)
        y = torch.einsum("knvc,kcd->nvd", fifo[:: layer.dilation],
                         layer.tcn_kernel) + layer.tcn_bias
        y = _stream_norm(layer.tcn_norm, y)
        new_state.append({"fifo": fifo, "res_fifo": res_fifo})
        x = torch.relu(y + res)
    return model.fcn_out(x.mean(dim=1)), new_state


@torch.no_grad()
def stream_sequence(model: CoStgcn, x, state=None):
    """Run a ``(B, L, V, C)`` capture through the streaming cell frame by
    frame; returns ``(logits (B, L, classes), final_state)``."""
    if state is None:
        state = init_stream_state(model, batch=x.shape[0], dtype=x.dtype)
    outs = []
    for t in range(x.shape[1]):
        logits, state = stream_step(model, state, x[:, t])
        outs.append(logits)
    return torch.stack(outs, dim=1), state
