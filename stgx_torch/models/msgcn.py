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
``(stages + 1, 1, T, num_classes)``.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from stgx_torch import default_device
from stgx_torch.models.mstcn import SingleStage, output_adapter
from stgx_torch.models.stgcn import Stgcn

__all__ = ["MsGcn"]


class MsGcn(nn.Module):
    """``generator_stage`` (the ST-GCN) and ``refinement_stages``
    (``stages`` single stages, the ``ms-tcn`` config group), the
    reference's names. Parameters are drawn from ``generator`` (a fresh one
    seeded 0 if None) on the CPU, the ST-GCN's first, and the model is moved
    to ``device`` (``cuda`` if None)."""

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
        self.layers = tuple(layers)
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
        self.to(device)

    @property
    def A(self):
        return self.generator_stage.A

    def forward(self, windows, mask=None, train: bool = False,
                generator: torch.Generator | None = None):
        """``windows`` ``(T, W, V, C)`` with an optional ``(T, W)`` mask →
        every stage's outputs ``(stages + 1, 1, T, classes)``."""
        y = self.generator_stage(windows, mask=mask, train=train, generator=generator)[None]
        outputs = [self.out(y)]
        for stage in self.refinement_stages:
            y = stage(self.prob(y)[:, :, None, :], train=train, generator=generator)[:, :, 0, :]
            outputs.append(self.out(y))
        return torch.stack(outputs)
