"""Shift-GCN (Cheng et al. 2020) — the window classifier, ported from
``stgx/models/shiftgcn.py``.

* **Spatial shift block**: joint-circular channel rotation in, the
  learnable feature-mask gate ``tanh(M) + 1``, a pointwise linear, the
  reverse rotation out, a per-joint norm, plus a 1×1 down-projection with
  its norm when the widths differ; ``relu(x + res)``.
* **Temporal shift block**: norm → learnable per-channel temporal shift →
  1×1 linear → ReLU → a second shift with the unit's stride → norm. Both
  shifts are :func:`stgx_torch.ops.shift.temporal_shift`: the
  ``temporal_shift`` kernel on the card, its plain version on the CPU.
* **Model**: input norm, 10 units (64×4 → 128×3, stride 2 → 256×3,
  stride 2), a global (L, V) mean and a linear head.

Under tensor parallelism (:func:`stgx_torch.parallel.tp.shard_params_tp`)
a unit holds one block of its output channels. Its whole input enters
(:func:`~stgx_torch.parallel.tp.enter`); the spatial block rotates and
gates the whole input and its pointwise linear (and the down-projection,
and the unit's 1×1 residual) give this rank's block; the reverse rotation
takes the block's columns of the whole-width index (the rotation of channel
j depends on j, so the block's offset counts); the temporal block's norm and
first shift act on the block, which is gathered whole for its 1×1 linear,
whose block of ``W`` gives the block again for the second shift and the
norm; the unit's output is gathered as it leaves. Both temporal shifts are
launched on the rank's channel block. The whole parameters that act on the
whole input after ``enter`` (``feature_mask``) or on a block through
``c.part`` (``shift_in``, ``shift_out``) see a share of their gradient on
each rank: they are partial (``TP_PARTIAL``), summed over ``model``. The
input norm and the head stay whole (``TP_WHOLE``).

Under sequence parallelism (the mesh's ``seq`` axis) both temporal shifts
run on each rank's block extended by its halos
(:func:`~stgx_torch.parallel.halo.sp_temporal_shift`), the strided
residual and mask take the block's global phase, and the head's mean adds
every rank's frames.

BatchNorm keeps no running stats (the framework-wide BN adaptation), as in
the JAX package. A window ``(N, W, V, C)`` gives ``(N, num_classes)``; the
window ``Trainer`` kind and the window streaming cell turn that into
per-frame predictions.
"""

from __future__ import annotations

import contextlib
from typing import Any, Sequence

import torch
from torch import nn

from stgx_torch import default_device
from stgx_torch.graph import Graph
from stgx_torch.models._remat import checkpointed
from stgx_torch.models.stgcn import Dense, make_norm, torch_bias_init, torch_conv_init
from stgx_torch.ops.shift import spatial_shift, spatial_shift_index
from stgx_torch.parallel.halo import decimate, frame_mean, frame_split, sp_temporal_shift
from stgx_torch.parallel.mesh import Split, strided_layout
from stgx_torch.parallel.tp import enter, gather_channels

__all__ = ["shift_init", "SpatialShiftBlock", "TemporalShiftBlock", "ShiftUnit",
           "ShiftGcn", "TP_WHOLE", "tp_partial"]

# leaves GSPMD may shard whose activation the port keeps whole, and why
TP_WHOLE = {
    "data_bn": "the per-joint input norm acts on the whole input, before the first product",
    "fc": "the head's logits are read whole by the loss",
}


def tp_partial(units: str) -> tuple:
    """The partial parameters of the shift units under ``units`` (a name
    pattern): whole on every rank, each rank's gradient a share."""
    return tuple(f"{units}.{leaf}" for leaf in
                 ("spatial.feature_mask", "temporal.shift_in", "temporal.shift_out"))


def shift_init(scale: float = 1.0):
    """U(−scale, scale) init of the learnable temporal shifts. Returns
    ``init(shape, generator) -> tensor``."""

    def init(shape, generator: torch.Generator):
        return torch.empty(shape).uniform_(-scale, scale, generator=generator)

    return init


class SpatialShiftBlock(nn.Module):
    """Parameters: ``kernel (C_in, C_out)``, ``bias``, ``feature_mask (V,
    C_in)``, ``norm`` (per joint); with ``C_in ≠ C_out`` also
    ``down_kernel``, ``down_bias`` and ``down_norm``."""

    def __init__(self, in_channels: int, out_channels: int, num_joints: int,
                 generator: torch.Generator, normalization: str = "BatchNorm"):
        super().__init__()
        cin, cout = in_channels, out_channels
        self.kernel = nn.Parameter(
            torch.empty(cin, cout).normal_(0.0, (1.0 / cout) ** 0.5, generator=generator))
        self.bias = nn.Parameter(torch.zeros(cout))
        # zeros: the gate tanh(0) + 1 starts at 1
        self.feature_mask = nn.Parameter(torch.zeros(num_joints, cin))
        self.norm = make_norm(normalization, cout, num_joints, per_joint=True)
        self.down = cin != cout
        if self.down:
            self.down_kernel = nn.Parameter(torch_conv_init(cin)((cin, cout), generator))
            self.down_bias = nn.Parameter(torch_bias_init(cin)((cout,), generator))
            self.down_norm = make_norm(normalization, cout, num_joints)
        self.register_buffer("src_in", spatial_shift_index(num_joints, cin),
                             persistent=False)
        self.register_buffer("src_out", spatial_shift_index(num_joints, cout, True),
                             persistent=False)
        self.channels = Split()  # the model split under tensor parallelism

    def forward(self, x0, mask=None):
        """``x0`` whole; under tensor parallelism this rank's block out."""
        c = self.channels
        x = spatial_shift(x0, index=self.src_in)
        x = x * (torch.tanh(self.feature_mask) + 1.0)
        x = x @ self.kernel + self.bias
        # the block's columns of the whole-width rotation
        x = spatial_shift(x, reverse=True, index=c.part(self.src_out, -1))
        x = self.norm(x, mask=mask)
        if self.down:
            res = self.down_norm(x0 @ self.down_kernel + self.down_bias, mask=mask)
        else:
            res = c.part(x0, -1)
        return torch.relu(x + res)


class TemporalShiftBlock(nn.Module):
    """Parameters: ``in_norm``, ``shift_in (C_in,)``, ``shift_out (C_out,)``,
    ``linear_kernel (C_in, C_out)``, ``linear_bias``, ``out_norm``."""

    def __init__(self, in_channels: int, out_channels: int, num_joints: int,
                 generator: torch.Generator, stride: int = 1,
                 normalization: str = "BatchNorm"):
        super().__init__()
        cin, cout = in_channels, out_channels
        self.stride = stride
        self.in_norm = make_norm(normalization, cin, num_joints)
        self.shift_in = nn.Parameter(shift_init(1.0)((cin,), generator))
        self.shift_out = nn.Parameter(shift_init(1.0)((cout,), generator))
        self.linear_kernel = nn.Parameter(torch_conv_init(cin)((cin, cout), generator))
        self.linear_bias = nn.Parameter(torch_bias_init(cin)((cout,), generator))
        self.out_norm = make_norm(normalization, cout, num_joints)
        self.channels = Split()  # the model split under tensor parallelism

    def forward(self, x, mask=None):
        """Under tensor parallelism ``x`` and the output are this rank's
        channel block."""
        c = self.channels
        frames = frame_split()
        x = self.in_norm(x, mask=mask)
        x = sp_temporal_shift(x, c.part(self.shift_in, -1), frames=frames)
        # the 1×1 linear contracts over every channel
        x = torch.relu(enter(gather_channels(x, c), c) @ self.linear_kernel + self.linear_bias)
        x = sp_temporal_shift(x, c.part(self.shift_out, -1), self.stride, frames)
        return self.out_norm(x, mask=decimate(mask, self.stride, frames))


class ShiftUnit(nn.Module):
    """Spatial block, temporal block (of class ``temporal_block``) and the
    residual: none, the identity (same width, stride 1) or a strided 1×1
    conv ``res_kernel``, ``res_bias`` with its ``res_norm``; ReLU of the
    sum (:meth:`preactivation` is the sum itself)."""

    temporal_block = TemporalShiftBlock

    def __init__(self, in_channels: int, out_channels: int, num_joints: int,
                 generator: torch.Generator, stride: int = 1, residual: bool = True,
                 normalization: str = "BatchNorm"):
        super().__init__()
        self.stride = stride
        self.residual = residual
        self.identity = in_channels == out_channels and stride == 1
        self.spatial = SpatialShiftBlock(in_channels, out_channels, num_joints,
                                         generator, normalization)
        self.temporal = self.temporal_block(out_channels, out_channels, num_joints,
                                            generator, stride, normalization)
        if residual and not self.identity:
            self.res_kernel = nn.Parameter(
                torch_conv_init(in_channels)((in_channels, out_channels), generator))
            self.res_bias = nn.Parameter(
                torch_bias_init(in_channels)((out_channels,), generator))
            self.res_norm = make_norm(normalization, out_channels, num_joints)
        self.channels = Split()  # the model split under tensor parallelism

    def preactivation(self, x, mask=None):
        """The sum before the ReLU, whole (gathered under tensor
        parallelism)."""
        c = self.channels
        x = enter(x, c)
        y = self.temporal(self.spatial(x, mask=mask), mask=mask)
        if not self.residual:
            return gather_channels(y, c)
        if self.identity:
            return gather_channels(y + c.part(x, -1), c)
        frames = frame_split()
        res = decimate(x, self.stride, frames) @ self.res_kernel + self.res_bias
        return gather_channels(y + self.res_norm(res, mask=decimate(mask, self.stride, frames)),
                               c)

    def forward(self, x, mask=None):
        return torch.relu(self.preactivation(x, mask))


class ShiftGcn(nn.Module):
    """10-unit Shift-GCN window classifier: ``(N, W, V, C)`` → ``(N, classes)``.

    ``kernel``, ``dropout`` and ``importance`` are accepted for the config
    schema and unused, as in the JAX package (shift blocks have no Γ and no
    dropout). ``remat=True`` recomputes each unit's interior in the
    backward pass of a training forward (:mod:`stgx_torch.models._remat`).
    Parameters are drawn from ``generator`` (a fresh one seeded 0 if None)
    on the CPU and the model is moved to ``device`` (``cuda`` if None).

    Tensor parallelism shards the units (``TP_MODULES``), keeps
    ``TP_WHOLE`` whole and sums the ``TP_PARTIAL`` gradients over ``model``.
    """

    TP_WHOLE = TP_WHOLE
    TP_PARTIAL = tp_partial("units.*")

    def __init__(self, num_classes: int, in_feat: int, graph: dict[str, Any],
                 strategy: str = "spatial", normalization: str = "BatchNorm",
                 in_ch: Sequence[int] = (3, 64, 64, 64, 64, 128, 128, 128, 256, 256),
                 out_ch: Sequence[int] = (64, 64, 64, 64, 128, 128, 128, 256, 256, 256),
                 stride: Sequence[int] = (1, 1, 1, 1, 2, 1, 1, 2, 1, 1),
                 residual: Sequence[int] = (0, 1, 1, 1, 1, 1, 1, 1, 1, 1),
                 kernel: int = 9, dropout: Sequence[float] = (),
                 importance: bool = False, remat: bool = False,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        device = default_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.remat = remat
        self.num_classes = num_classes
        self.in_feat = in_feat
        self.stride = tuple(stride)
        self.num_joints = Graph(strategy=strategy, **graph).num_node
        in_ch = (in_feat,) + tuple(in_ch[1:])
        self.data_bn = make_norm(normalization, in_feat, self.num_joints,
                                 per_joint=True)
        self.units = nn.ModuleList(
            ShiftUnit(in_ch[i], out_ch[i], self.num_joints, generator,
                      stride=self.stride[i], residual=bool(residual[i]),
                      normalization=normalization)
            for i in range(len(out_ch))
        )
        self.TP_MODULES = tuple(f"units.{i}" for i in range(len(out_ch)))
        self.fc = Dense(out_ch[-1], num_classes, generator,
                        kernel_std=(2.0 / num_classes) ** 0.5)
        self.to(device)

    def forward(self, x, mask=None, train: bool = False,
                generator: torch.Generator | None = None):
        """Window logits. ``mask`` is an optional ``(N, W)`` frame mask;
        ``train`` and ``generator`` are accepted for the Trainer's call and
        unused (Shift-GCN has no dropout)."""
        x = self.data_bn(x, mask=mask)
        with contextlib.ExitStack() as layouts:
            for unit in self.units:
                x = (checkpointed(unit, x, mask=mask) if self.remat and train
                     else unit(x, mask=mask))
                mask = decimate(mask, unit.stride, frame_split())
                layouts.enter_context(strided_layout(unit.stride))
            return self.fc(frame_mean(x, frames=frame_split()))
