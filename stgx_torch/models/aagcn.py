"""2s-AGCN / AA-GCN — the two-stream adaptive graph convolutional network,
ported from ``stgx/models/aagcn.py``.

* Two independent streams, joints and bones; a bone vector points from a
  joint's centrifugal parent to the joint (:func:`bone_parents`,
  :func:`bone_vectors`).
* Each layer's adjacency is ``A·importance + B + C``: ``B`` a free
  ``(P, V, V)`` parameter initialised to zero and ``C`` the data-dependent
  attention ``softmax(θᵀφ)``, contracted over the embedding channels and
  the whole window, padding frames included, with no mask (as in the JAX
  package). The rest of the layer is an :class:`~stgx_torch.models.stgcn.StgcnLayer`
  whose graph conv takes the per-sample adjacency: two einsums, never the
  ``gcn_core`` kernel (the JAX package computes it outside Pallas too).
* The prediction sums the two streams' outputs after the ``output_type``
  adapter (logits, log-softmax or softmax).

Under tensor parallelism each :class:`~stgx_torch.models.stgcn.StgcnLayer`
and each stream's ``fcn_in`` hold one block of their output channels, as
ST-GCN's do. The attention embeddings ``theta_*`` / ``phi_*`` stay whole
(``TP_WHOLE``): ``softmax(θᵀφ)`` contracts every embedding channel, and
each rank forms the whole attention from the whole input rather than
summing blocks of the scores over ``model`` before the softmax. The
adjacency ``A·importance + B + C`` enters the layer through
:func:`~stgx_torch.parallel.tp.enter`, whose backward sums each rank's
share of its gradient (its block's graph conv reads all of it), so the
gradients of ``θ``, ``φ``, ``B`` and the edge importance are complete on
every rank and none is partial.

Under sequence parallelism each layer's attention scores, a sum over the
window's frames, add every ``seq`` rank's frames before the softmax; the
rest is ST-GCN's (:mod:`stgx_torch.models.stgcn`).

Output: ``(N, num_classes)`` per window.
"""

from __future__ import annotations

import contextlib
from typing import Any, Sequence

import numpy as np
import torch
from torch import nn

from stgx_torch import default_device
from stgx_torch.graph import Graph
from stgx_torch.models._remat import checkpointed
from stgx_torch.models.mstcn import output_adapter
from stgx_torch.models.stgcn import (
    Dense,
    StgcnLayer,
    make_norm,
    torch_bias_init,
    torch_conv_init,
)
from stgx_torch.parallel.halo import decimate, frame_mean, frame_split
from stgx_torch.parallel.mesh import strided_layout, sum_parts
from stgx_torch.parallel.tp import enter

__all__ = ["bone_parents", "bone_vectors", "AgcnLayer", "AaGcn"]


def bone_parents(graph_spec: dict, strategy: str = "spatial") -> np.ndarray:
    """Per-joint parent index for the bones, -1 where the joint is no
    joint's centrifugal neighbour (its bone stays zero): joint ``j``'s parent
    is the last ``i`` in index order whose raw far-partition row holds
    ``j``, the reference's loop."""
    g = Graph(strategy=strategy, **graph_spec)
    far = g.A_spatial_raw[2].astype(bool)  # rows i → centrifugal neighbours j
    parents = np.full(g.num_node, -1, dtype=np.int32)
    for i in range(g.num_node):
        parents[far[i]] = i
    return parents


def bone_vectors(x, parents):
    """``(N, L, V, C)`` joints → bones ``x[..., j, :] − x[..., parent(j), :]``,
    zero where a joint has no parent. ``parents`` is a ``(V,)`` integer
    tensor on x's device."""
    has_parent = parents >= 0
    bones = x - x[:, :, torch.clamp_min(parents, 0)]
    return torch.where(has_parent[None, None, :, None], bones, torch.zeros_like(bones))


class AgcnLayer(nn.Module):
    """The adaptive adjacency ``A + B + C`` in front of a standard
    :class:`StgcnLayer` (``layer``). Parameters: ``B (P, V, V)``,
    ``theta_kernel``, ``theta_bias``, ``phi_kernel``, ``phi_bias`` (the two
    1×1 embeddings to ``P · C_out / coeff_embedding`` channels) and
    ``layer``."""

    def __init__(self, in_channels: int, out_channels: int, gamma: int,
                 partitions: int, num_joints: int, generator: torch.Generator,
                 stride: int = 1, dropout: float = 0.0, residual: bool = True,
                 normalization: str = "LayerNorm", coeff_embedding: int = 4):
        super().__init__()
        self.partitions = partitions
        self.emb = out_channels // coeff_embedding
        width = partitions * self.emb
        self.B = nn.Parameter(torch.zeros(partitions, num_joints, num_joints))
        init = torch_conv_init(in_channels)
        self.theta_kernel = nn.Parameter(init((in_channels, width), generator))
        self.theta_bias = nn.Parameter(torch_bias_init(in_channels)((width,), generator))
        self.phi_kernel = nn.Parameter(init((in_channels, width), generator))
        self.phi_bias = nn.Parameter(torch_bias_init(in_channels)((width,), generator))
        self.layer = StgcnLayer(in_channels, out_channels, gamma, partitions, num_joints,
                                generator, stride=stride, dropout=dropout,
                                residual=residual, normalization=normalization)

    def forward(self, x, A, mask=None, train: bool = False,
                generator: torch.Generator | None = None):
        n, l, v, _ = x.shape
        acc = torch.promote_types(x.dtype, torch.float32)
        theta = (x @ self.theta_kernel + self.theta_bias).reshape(n, l, v, self.partitions,
                                                                  self.emb)
        phi = (x @ self.phi_kernel + self.phi_bias).reshape(n, l, v, self.partitions, self.emb)
        # attention over the full window: embedding channels and time contracted
        scores = torch.einsum("nlvpe,nlwpe->npvw", theta.to(acc), phi.to(acc))
        frames = frame_split()
        if frames is not None:  # every seq rank's frames, summed before the softmax
            scores = sum_parts(scores, frames.group)
        C = torch.softmax(scores, dim=-1).to(x.dtype)
        # (N, P, V, V); under tensor parallelism each rank's block sees all of it
        A_total = enter(A[None] + self.B[None] + C, self.layer.channels)
        return self.layer(x, A_total, mask=mask, train=train, generator=generator)


class _Stream(nn.Module):
    """One stream: ``norm_in`` → ``fcn_in`` → AgcnLayers (``layers``, with
    ``edge_importance``) → global (L, V) mean → ``fcn_out``."""

    def __init__(self, num_classes, in_feat, num_joints, partitions, normalization, kernel,
                 in_ch, out_ch, stride, residual, dropout, importance, remat, generator):
        super().__init__()
        self.remat = remat
        self.importance = importance
        self.stride = tuple(stride)
        self.norm_in = make_norm(normalization, in_feat, num_joints, per_joint=True)
        self.fcn_in = Dense(in_feat, in_ch[0], generator)
        if importance:
            self.edge_importance = nn.Parameter(
                torch.ones(len(in_ch), partitions, num_joints, num_joints))
        self.layers = nn.ModuleList(
            AgcnLayer(in_ch[i], out_ch[i], kernel, partitions, num_joints, generator,
                      stride=stride[i], dropout=dropout[i], residual=bool(residual[i]),
                      normalization=normalization)
            for i in range(len(in_ch))
        )
        self.fcn_out = Dense(out_ch[-1], num_classes, generator)

    def forward(self, x, A, mask=None, train: bool = False, generator=None):
        x = self.fcn_in(self.norm_in(x, mask=mask))
        with contextlib.ExitStack() as layouts:
            for i, layer in enumerate(self.layers):
                A_i = A * self.edge_importance[i] if self.importance else A
                if self.remat and train:
                    x = checkpointed(layer, x, A_i, mask=mask, train=True, generator=generator)
                else:
                    x = layer(x, A_i, mask=mask, train=train, generator=generator)
                # strided layers shorten the frame axis
                mask = decimate(mask, self.stride[i], frame_split())
                layouts.enter_context(strided_layout(self.stride[i]))
            return self.fcn_out(frame_mean(x, frames=frame_split()))


class AaGcn(nn.Module):
    """Two-stream AA-GCN window classifier: ``(N, L, V, C)`` → ``(N, classes)``.

    ``remat=True`` recomputes each layer's interior in the backward pass of
    a training forward. Parameters are drawn from ``generator`` (a fresh one
    seeded 0 if None) on the CPU, the joint stream's first, and the model is
    moved to ``device`` (``cuda`` if None).

    Tensor parallelism shards each stream's ``fcn_in`` and its layers'
    ST-GCN parts (``TP_MODULES``) and keeps ``TP_WHOLE`` whole.
    """

    TP_WHOLE = {
        "*.norm_in": "the per-joint input norm acts on the whole input, before the first "
                     "product",
        "*.fcn_out": "the head's logits are read whole by the loss",
        "*.theta_*": "the attention softmax(θᵀφ) contracts every embedding channel; each "
                     "rank forms it whole",
        "*.phi_*": "the attention softmax(θᵀφ) contracts every embedding channel; each "
                   "rank forms it whole",
    }
    TP_PARTIAL = ()

    def __init__(self, num_classes: int, in_feat: int, graph: dict[str, Any],
                 strategy: str = "spatial", normalization: str = "LayerNorm",
                 output_type: str = "logits", kernel: int = 9,
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
        self.prob = output_adapter(output_type)
        self.kernel = kernel
        self.in_feat = in_feat
        self.in_ch, self.out_ch = tuple(in_ch), tuple(out_ch)
        self.stride = tuple(stride)
        self.importance = importance
        g = Graph(strategy=strategy, **graph)
        self.register_buffer("A", torch.tensor(g.A, dtype=torch.float32), persistent=False)
        self.register_buffer("parents", torch.tensor(bone_parents(graph, strategy),
                                                     dtype=torch.int64), persistent=False)
        self.num_joints = g.num_node
        self.partitions = g.A.shape[0]
        common = dict(num_classes=num_classes, in_feat=in_feat, num_joints=g.num_node,
                      partitions=self.partitions, normalization=normalization, kernel=kernel,
                      in_ch=self.in_ch, out_ch=self.out_ch, stride=self.stride,
                      residual=residual, dropout=dropout, importance=importance,
                      remat=remat, generator=generator)
        self.joint_stream = _Stream(**common)
        self.bone_stream = _Stream(**common)
        self.TP_MODULES = tuple(
            m for s in ("joint_stream", "bone_stream")
            for m in (f"{s}.fcn_in", *(f"{s}.layers.{i}.layer" for i in range(len(in_ch)))))
        self.to(device)

    def forward(self, x, mask=None, train: bool = False,
                generator: torch.Generator | None = None):
        """Window outputs: the two streams' adapted outputs summed. ``mask``
        is an optional ``(N, L)`` frame mask (it reaches the norms, not the
        attention); ``train`` turns dropout on, masks from ``generator``."""
        bones = bone_vectors(x, self.parents)
        kw = dict(mask=mask, train=train, generator=generator)
        return self.prob(self.joint_stream(x, self.A, **kw)) + self.prob(
            self.bone_stream(bones, self.A, **kw))
