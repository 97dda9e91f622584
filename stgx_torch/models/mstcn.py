"""MS-TCN — the multi-stage temporal convolutional network (Farha & Gall
2019), ported from ``stgx/models/mstcn.py``.

A generator :class:`SingleStage` over the raw features, then refinement
stages over (an adapter of) the previous stage's class scores. A stage is
a 1×1 in-conv, ``layers`` :class:`DilatedResidualLayer` s (kernel k,
dilation 2^i, padded by the dilation on both sides whatever k is, ReLU, 1×1
conv, dropout, residual add) and a 1×1 out-conv. The joints are averaged
after the generator stage. The dilated convs are
:func:`stgx_torch.ops.temporal.temporal_conv` (the JAX package runs them
through XLA's convolution, no Pallas kernel): with dilations up to 512
they take its taps route on the card in both types.

Output: ``(stages, N, L, num_classes)`` per-frame outputs of every stage.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from stgx_torch import default_device
from stgx_torch.models._remat import checkpointed
from stgx_torch.models.stgcn import Dense, dropout, torch_bias_init, torch_conv_init
from stgx_torch.ops.temporal import temporal_conv

__all__ = ["output_adapter", "DilatedResidualLayer", "SingleStage", "MsTcn"]


def output_adapter(kind: str):
    """The function of an ``output_type`` / ``refine`` name: ``"logits"``
    (identity), ``"logsoftmax"`` or ``"softmax"`` over the class axis."""
    if kind == "logits":
        return lambda x: x
    if kind == "logsoftmax":
        return lambda x: torch.log_softmax(x, dim=-1)
    if kind == "softmax":
        return lambda x: torch.softmax(x, dim=-1)
    raise ValueError(f"unknown output adapter: {kind!r}")


class DilatedResidualLayer(nn.Module):
    """``x + dropout(pointwise(relu(conv(x))))``: ``conv_kernel (k, F, F)``
    and ``conv_bias`` the dilated temporal conv, ``pointwise`` the 1×1."""

    def __init__(self, features: int, generator: torch.Generator, kernel: int = 3,
                 dilation: int = 1, dropout: float = 0.5):
        super().__init__()
        self.dilation = dilation
        fan_in = features * kernel
        self.conv_kernel = nn.Parameter(torch_conv_init(fan_in)(
            (kernel, features, features), generator))
        self.conv_bias = nn.Parameter(torch_bias_init(fan_in)((features,), generator))
        self.pointwise = Dense(features, features, generator)
        self.dropout = float(dropout)

    def forward(self, x, train: bool = False, generator: torch.Generator | None = None):
        # padded by the dilation on both sides whatever the kernel (the
        # reference's padding): the same length only for kernel 3
        y = temporal_conv(x, self.conv_kernel, self.conv_bias, dilation=self.dilation,
                          padding=self.dilation)
        y = self.pointwise(torch.relu(y))
        if train and self.dropout > 0:
            y = dropout(y, self.dropout, generator)
        return x + y


class SingleStage(nn.Module):
    """``conv_in`` (``in_channels`` → ``num_filters``), ``layers`` dilated
    residual layers (dilations 1, 2, 4, …) and ``conv_out`` (→
    ``out_channels``), over the last axis of ``(N, L, V, C)``."""

    def __init__(self, in_channels: int, out_channels: int, generator: torch.Generator,
                 num_filters: int = 64, num_layers: int = 10, kernel: int = 3,
                 dropout: float = 0.0, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.conv_in = Dense(in_channels, num_filters, generator)
        self.layers = nn.ModuleList(
            DilatedResidualLayer(num_filters, generator, kernel=kernel, dilation=2**i,
                                 dropout=dropout)
            for i in range(num_layers)
        )
        self.conv_out = Dense(num_filters, out_channels, generator)

    def forward(self, x, train: bool = False, generator: torch.Generator | None = None):
        x = self.conv_in(x)
        for layer in self.layers:
            if self.remat and train:
                x = checkpointed(layer, x, train=True, generator=generator)
            else:
                x = layer(x, train=train, generator=generator)
        return self.conv_out(x)


class MsTcn(nn.Module):
    """``(N, L, V, C)`` → ``(stages, N, L, classes)``.

    ``generator_stage`` is the first stage (which, as in the JAX package,
    never rematerialises), ``refinement_stages`` the other ``stages − 1``
    (the reference's names). Parameters are drawn from ``generator`` (a
    fresh one seeded 0 if None) on the CPU and the model is moved to
    ``device`` (``cuda`` if None)."""

    def __init__(self, num_classes: int, in_feat: int, stages: int = 4,
                 filters: Sequence[int] = (64, 64, 64, 64),
                 layers: Sequence[int] = (10, 10, 10, 10),
                 kernel: Sequence[int] = (3, 3, 3, 3),
                 dropout: Sequence[float] = (0.5, 0.5, 0.5, 0.5),
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
        self.generator_stage = SingleStage(in_feat, num_classes, generator, filters[0],
                                           layers[0], kernel[0], dropout[0])
        self.refinement_stages = nn.ModuleList(
            SingleStage(num_classes, num_classes, generator, filters[s], layers[s],
                        kernel[s], dropout[s], remat=remat)
            for s in range(1, stages)
        )
        self.to(device)

    def forward(self, x, mask=None, train: bool = False,
                generator: torch.Generator | None = None):
        """Every stage's per-frame outputs. ``mask`` is accepted for the
        Trainer's call and unused (the JAX model takes none into account);
        ``train`` turns dropout on, masks from ``generator``."""
        y = self.generator_stage(x, train=train, generator=generator).mean(dim=2)  # pool joints
        outputs = [self.out(y)]
        for stage in self.refinement_stages:
            y = stage(self.prob(y)[:, :, None, :], train=train, generator=generator)[:, :, 0, :]
            outputs.append(self.out(y))
        return torch.stack(outputs)
