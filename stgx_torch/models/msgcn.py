"""MS-GCN — an ST-GCN generator and MS-TCN refinement (Filtjens et al.),
ported from ``stgx/models/msgcn.py``.

The generator is a full window-classifier :class:`~stgx_torch.models.stgcn.Stgcn`
over every frame's receptive-field window, whose batch axis is time: on
the card its graph convs run the ``gcn_core`` kernel (``gcn_grads`` under
autograd). Its window logits form a time series ``(1, T, classes)``, which
``stages`` MS-TCN :class:`~stgx_torch.models.mstcn.SingleStage` s refine
through the ``refine`` adapter.

Input: the window tensor ``(T, W, V, C)``, one window per output frame
(:func:`stgx_torch.parallel.segments.sliding_windows`). Output:
``(stages + 1, 1, T, num_classes)``. The refinement can run one stage a
rank of the mesh's ``model`` axis
(:func:`stgx_torch.parallel.pipeline.msgcn_refine_pipelined`).

Under tensor parallelism the ST-GCN's ``fcn_in`` and layers and the
refinement stages' ``conv_in`` and layers hold one block of their output
channels (:mod:`stgx_torch.models.stgcn`, :mod:`stgx_torch.models.mstcn`);
the ST-GCN's input norm and head and every ``conv_out`` stay whole
(``TP_WHOLE``), and the edge importance's gradient is partial
(``TP_PARTIAL``).

Under a mesh whose ``data`` ranks split the windows, the generator runs on
this rank's windows and the refinement on its block of the chunk's time
axis (the windows), as GSPMD splits it for the JAX package: each dilated
conv takes the frames past the block from the other data ranks as halos
(:func:`~stgx_torch.parallel.halo.sp_temporal_conv`, a dilation of up to
2⁹ reaching past several blocks), and dropout keeps its block of the
whole chunk's mask. Under ``seq`` the generator's windows are split over
the frames (:class:`~stgx_torch.models.stgcn.Stgcn`), its scores are whole
on every ``seq`` rank and the refinement runs on them there.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from stgx_torch import default_device
from stgx_torch.models import mstcn, stgcn
from stgx_torch.models.mstcn import SingleStage, output_adapter, stage_tp_modules
from stgx_torch.models.stgcn import Stgcn
from stgx_torch.parallel.mesh import Shards, Split, current_shards, equal_split, use_shards

__all__ = ["MsGcn"]


class MsGcn(nn.Module):
    """``generator_stage`` (the ST-GCN) and ``refinement_stages``
    (``stages`` single stages, the ``ms-tcn`` config group), the
    reference's names. Parameters are drawn from ``generator`` (a fresh one
    seeded 0 if None) on the CPU, the ST-GCN's first, and the model is moved
    to ``device`` (``cuda`` if None).

    Tensor parallelism shards the ST-GCN's ``fcn_in`` and layers and every
    stage's ``conv_in`` and layers (``TP_MODULES``), keeps ``TP_WHOLE``
    whole and sums the ``TP_PARTIAL`` gradients over ``model``."""

    TP_WHOLE = {**{f"generator_stage.{k}": why for k, why in stgcn.TP_WHOLE.items()},
                **mstcn.TP_WHOLE}
    TP_PARTIAL = tuple(f"generator_stage.{k}" for k in stgcn.TP_PARTIAL)

    def __init__(self, num_classes: int, in_feat: int, graph: dict[str, Any],
                 strategy: str = "spatial", normalization: str = "LayerNorm",
                 kernel: int = 9,
                 in_ch: Sequence[int] = (64, 64, 64, 64, 128, 128, 128, 256, 256),
                 out_ch: Sequence[int] = (64, 64, 64, 128, 128, 128, 256, 256, 256),
                 stride: Sequence[int] = (1, 1, 1, 2, 1, 1, 2, 1, 1),
                 residual: Sequence[int] = (1,) * 9,
                 dropout: Sequence[float] = (0.0,) * 9,
                 importance: bool = True, stages: int = 4,
                 filters: Sequence[int] = (64, 64, 64, 64),
                 layers: Sequence[int] = (10, 10, 10, 10),
                 refine_kernel: Sequence[int] = (3, 3, 3, 3),
                 refine_dropout: Sequence[float] = (0.5, 0.5, 0.5, 0.5),
                 refine: str = "softmax", output_type: str = "logits",
                 remat: bool = False, device=None, generator: torch.Generator | None = None):
        super().__init__()
        device = default_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.stages = stages
        self.filters, self.layers = tuple(filters), tuple(layers)
        self.refine_kernel, self.refine_dropout = tuple(refine_kernel), tuple(refine_dropout)
        self.prob = output_adapter(refine)
        self.out = output_adapter(output_type)
        self.generator_stage = Stgcn(num_classes, in_feat, graph, strategy, normalization,
                                     kernel, in_ch, out_ch, stride, residual, dropout,
                                     importance, remat, device="cpu", generator=generator)
        self.refinement_stages = nn.ModuleList(
            SingleStage(num_classes, num_classes, generator, filters[s], layers[s],
                        refine_kernel[s], refine_dropout[s], remat=remat)
            for s in range(stages)
        )
        self.TP_MODULES = (*(f"generator_stage.{m}" for m in self.generator_stage.TP_MODULES),
                           *(m for s, st in enumerate(self.refinement_stages)
                             for m in stage_tp_modules(f"refinement_stages.{s}", st)))
        self.to(device)

    @property
    def A(self):
        return self.generator_stage.A

    def forward(self, windows, mask=None, train: bool = False,
                generator: torch.Generator | None = None):
        """``windows`` ``(T, W, V, C)`` with an optional ``(T, W)`` mask →
        every stage's outputs ``(stages + 1, 1, T, classes)`` (under a
        ``data`` split this rank's T windows of each)."""
        y = self.generator_stage(windows, mask=mask, train=train, generator=generator)[None]
        outputs = [self.out(y)]
        with use_shards(self._refine_layout(y.shape[1])):
            for stage in self.refinement_stages:
                y = stage(self.prob(y)[:, :, None, :], train=train,
                          generator=generator)[:, :, 0, :]
                outputs.append(self.out(y))
        return torch.stack(outputs)

    @staticmethod
    def _refine_layout(windows: int):
        """The refinement's layout: the chunk's windows, its time axis, split
        over ``data`` as the generator's batch is (this rank's ``windows``
        of them), so that its dilated convs exchange halos with the other
        data ranks; None where the windows are whole. The ``seq`` ranks hold
        replicas of it."""
        shards = current_shards()
        if shards is None or shards.n.size == 1:
            return None
        t = equal_split(shards.n, windows * shards.n.size)
        return Shards(Split(), t, t.group, t.size, shards.device)
