"""Shift-GCN++ — a teacher, a student of dynamic shift experts and their
margin-ReLU distillation; the port of ``stgx/models/shiftgcn_plus.py``.

* **Teacher** (:class:`ShiftGcnPlusTeacher`): 10 Shift-GCN units at 64×4,
  128×3, 256×3 channels, strides (1,1,1,1,2,1,1,2,1,1). Before every unit
  after the first, the normalised input ``x0`` is concatenated back at the
  unit's time scale (``x0``, ``x0`` mean-pooled by 2, by 4). A unit returns
  its output before the ReLU, so the distillation taps (units 3, 6, 9) see
  pre-ReLU features.
* **Student** (:class:`ShiftGcnPlusStudent`): 7 units at ``c_mul``·(8, 8, 8,
  16, 16, 32, 32) channels, strides (1,1,1,2,1,2,1), taps at units 2, 4, 6.
  Each pointwise linear is a mixture of 4 experts weighted per sample by a
  :class:`DySEGate`: an SE pool over (L, V), two dense layers, then
  ``softmax(z / τ)`` with τ falling from 30 to 1 over 60 epochs. The mixed
  weight is applied per sample, ``torch.bmm`` over ``(N, L·V, C)`` (an XLA
  ``dot_general`` in the JAX package, no Pallas kernel).
* **Wrapper** (:class:`ShiftGcnPlus`): the teacher on a detached input under
  ``torch.no_grad()``, the student with the epoch; each student tap through
  a bias-free connector and a norm, held against the teacher's tap by
  :func:`distillation_loss` with margins from the teacher's tap norms
  (:func:`margin_from_norm_params`), the stages weighted 1/4, 1/2, 1.
  Returns ``(student_logits, loss)``. The teacher's parameters get no
  gradient, so Adam leaves them as they are, as JAX's zero gradients do.

Every temporal shift is :func:`stgx_torch.ops.shift.temporal_shift`: the
``temporal_shift`` kernel on the card (and ``temporal_shift_bwd`` in the
backward), its plain version on the CPU. A forward of the teacher launches
20, of the student 14, of the wrapper 34.

Three faults of the JAX package are copied, not mended (ROADMAP.md §3):

1. The window must be a multiple of 4 frames: the stride-2 units round the
   length up (50 → 25 → 13) while the skips' mean pool rounds it down
   (50 → 25 → 12), and the concatenation fails
   (``stgx/models/shiftgcn_plus.py:299-301, 401-403``). Here that is a
   ``ValueError`` naming both lengths, raised before anything runs.
2. The wrapper takes ``mask`` and passes it to neither model nor to the
   connector norms (``stgx/models/shiftgcn_plus.py:536-553``).
3. The teacher and the student mask their input norm only; their units see
   no mask (``stgx/models/shiftgcn_plus.py:291, 305, 407``).

Under tensor parallelism (:func:`stgx_torch.parallel.tp.shard_params_tp`)
the teacher's and the student's units hold one block of their output
channels, as Shift-GCN's do (:mod:`stgx_torch.models.shiftgcn`), and
gather their output as they leave, so the taps are whole. A student
block's gates stay whole (``TP_WHOLE``): each reads the whole input (the
temporal block's gathers the shifted block first) and each rank forms all 4
weights; the expert stacks' output channels are sharded, so each rank
mixes its block of every expert. The gates, like the feature masks and the
shifts, get a share of their gradient on each rank (``TP_PARTIAL``). The
wrapper's connectors and connector norms stay whole (``TP_WHOLE``): they
read the whole student taps and are compared with the whole teacher taps,
so every rank forms the same distillation loss; the margins come from the
teacher's tap norms gathered whole. The teacher's whole feature masks and
shifts need no sum: it gets no gradient (``TP_NO_GRAD``).

Under expert parallelism (:mod:`stgx_torch.parallel.ep`) each rank holds
``4 / model`` of every student block's experts and the partial mixtures are
summed over ``model`` (:func:`~stgx_torch.parallel.ep.expert_sum`).

Under sequence parallelism both models' shifts run on each rank's
extended block, as Shift-GCN's do; the skips' pooled pairs that straddle
two blocks are completed from the next one
(:func:`~stgx_torch.parallel.halo.sp_avg_pool`), the gates' and the
heads' window means add every rank's frames, the length check reads the
whole window, and each rank's distillation loss sums its frames (its share
of the whole).

Under bf16 compute the gate's softmax and the expert mixture are formed in
fp32 and the mixed weight is cast to the activations' type; the margins are
formed in fp32 and cast to the tap's type, and the distillation loss is
summed in fp32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Sequence

import torch
from torch import nn

from stgx_torch import default_device
from stgx_torch.graph import Graph
from stgx_torch.models._remat import checkpointed
from stgx_torch.models.shiftgcn import (
    TP_WHOLE,
    ShiftUnit,
    TemporalShiftBlock,
    shift_init,
    tp_partial,
)
from stgx_torch.models.stgcn import Dense, make_norm, torch_bias_init, torch_conv_init
from stgx_torch.ops.shift import spatial_shift, spatial_shift_index
from stgx_torch.parallel.ep import expert_sum
from stgx_torch.parallel.halo import (
    decimate,
    frame_mean,
    frame_split,
    sp_avg_pool,
    sp_temporal_shift,
)
from stgx_torch.parallel.mesh import Split, strided_layout
from stgx_torch.parallel.tp import enter, gather_channels

__all__ = [
    "DySEGate",
    "StudentSpatialShift",
    "StudentTemporalShift",
    "TeacherTemporalShift",
    "ShiftGcnPlusTeacher",
    "ShiftGcnPlusStudent",
    "ShiftGcnPlus",
    "distillation_loss",
    "margin_from_norm_params",
    "graft_teacher_params",
    "EXPERTS",
]

EXPERTS = 4  # experts of each dynamic pointwise linear
TAU_START, TAU_EPOCHS = 30.0, 60.0  # the gate's temperature: 30 → 1 over 60 epochs


def _acc(t):
    """fp32, or fp64 for an fp64 tensor: the type the gates, the margins and
    the loss are formed in."""
    return torch.promote_types(t.dtype, torch.float32)


def _tau(epoch, like):
    """The gates' temperature at ``epoch``: 30 − 29·epoch/60 before epoch 60
    and 1 from then on. A number gives a number (nothing is copied to the
    device, so a CUDA graph can capture the step); a tensor (the Trainer's,
    made on the device) gives a 0-d tensor of ``like``'s type."""
    if not isinstance(epoch, torch.Tensor):
        epoch = float(epoch)
        return -(TAU_START - 1.0) / TAU_EPOCHS * epoch + TAU_START if epoch < TAU_EPOCHS else 1.0
    epoch = epoch.to(device=like.device, dtype=like.dtype)
    return torch.where(epoch < TAU_EPOCHS,
                       -(TAU_START - 1.0) / TAU_EPOCHS * epoch + TAU_START, 1.0)


# why a student block's gate stays whole under tensor parallelism
_GATE_WHOLE = ("the gate pools the whole input and its softmax reads all 4 experts' "
               "scores; each rank forms every weight")


class DySEGate(nn.Module):
    """The experts' weights per sample: ``softmax(dense_1(relu(dense_0(
    mean_{L,V} x))) / τ)``, τ = 30 − 29·epoch/60 before epoch 60 and 1 from
    then on (∞ included). The hidden width is C / 4 (C itself for C = 3).
    Returns ``(N, 4)`` in fp32 (fp64 for fp64 input)."""

    def __init__(self, channels: int, generator: torch.Generator, reduction: int = 4):
        super().__init__()
        hidden = channels // (1 if channels == 3 else reduction)
        self.dense_0 = Dense(channels, hidden, generator, kernel_std=(1.0 / channels) ** 0.5)
        self.dense_1 = Dense(hidden, EXPERTS, generator, kernel_std=(1.0 / hidden) ** 0.5)

    def forward(self, x, epoch):
        # the SE pool over every seq rank's frames
        z = self.dense_1(torch.relu(self.dense_0(frame_mean(x, frames=frame_split()))))
        z = z.to(_acc(z))
        return torch.softmax(z / _tau(epoch, z), dim=-1)


def _experts(x, kernel, bias, g, experts: Split = Split(), channels: Split = Split()):
    """``x (N, L, V, C_in)`` through the per-sample mixture of the experts
    ``kernel (4, C_in, C_out)``, ``bias (4, C_out)`` weighted by ``g (N, 4)``.

    Under expert parallelism (``experts``, the ``model`` split) the kernel
    and bias hold this rank's experts: its partial mixture is summed over
    ``model`` (:func:`~stgx_torch.parallel.ep.expert_sum`; with tensor
    parallelism, ``channels``, into this rank's channel block). Alone, the
    gate's output enters first, since each rank's gradient of it covers its
    own experts only."""
    n, l, v, cin = x.shape
    if experts.size > 1:
        if channels.size == 1:
            g = enter(g, experts)
        g = experts.part(g, -1)
    wf = expert_sum(torch.einsum("kcd,nk->ncd", kernel.to(g.dtype), g), experts, channels)
    bf = expert_sum(torch.einsum("kc,nk->nc", bias.to(g.dtype), g), experts, channels)
    y = torch.bmm(x.reshape(n, l * v, cin), wf.to(x.dtype)).reshape(n, l, v, -1)
    return y + bf.to(x.dtype)[:, None, None, :]


def _expert_init(cin: int, cout: int, generator: torch.Generator):
    """``kernel (4, C_in, C_out)`` from N(0, 1/C_out) and a zero bias."""
    kernel = torch.empty(EXPERTS, cin, cout).normal_(0.0, (1.0 / cout) ** 0.5,
                                                     generator=generator)
    return nn.Parameter(kernel), nn.Parameter(torch.zeros(EXPERTS, cout))


class StudentSpatialShift(nn.Module):
    """The spatial shift block with a dynamic pointwise linear. Parameters:
    ``kernel (4, C_in, C_out)``, ``bias (4, C_out)``, ``feature_mask (V,
    C_in)``, ``gate`` (on the block's input), ``norm`` (per joint); with
    ``C_in ≠ C_out`` also ``down_kernel``, ``down_bias`` and ``down_norm``."""

    def __init__(self, in_channels: int, out_channels: int, num_joints: int,
                 generator: torch.Generator, normalization: str = "BatchNorm"):
        super().__init__()
        cin, cout = in_channels, out_channels
        self.kernel, self.bias = _expert_init(cin, cout, generator)
        self.feature_mask = nn.Parameter(torch.zeros(num_joints, cin))
        self.gate = DySEGate(cin, generator)
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
        self.experts = Split()  # the model split under expert parallelism

    def forward(self, x0, epoch, mask=None):
        """``x0`` whole; under tensor parallelism this rank's block out."""
        c = self.channels
        g = self.gate(x0, epoch)
        x = spatial_shift(x0, index=self.src_in)
        x = x * (torch.tanh(self.feature_mask) + 1.0)
        x = _experts(x, self.kernel, self.bias, g, self.experts, c)
        # the block's columns of the whole-width rotation
        x = self.norm(spatial_shift(x, reverse=True, index=c.part(self.src_out, -1)),
                      mask=mask)
        if self.down:
            res = self.down_norm(x0 @ self.down_kernel + self.down_bias, mask=mask)
        else:
            res = c.part(x0, -1)
        return torch.relu(x + res)


class StudentTemporalShift(nn.Module):
    """norm → temporal shift → dynamic pointwise linear (its gate on the
    shifted input) → ReLU → a second shift with the stride → norm.
    Parameters: ``in_norm``, ``shift_in (C_in,)``, ``temporal_kernel (4,
    C_in, C_out)``, ``temporal_bias (4, C_out)``, ``gate``, ``shift_out
    (C_out,)``, ``out_norm``."""

    def __init__(self, in_channels: int, out_channels: int, num_joints: int,
                 generator: torch.Generator, stride: int = 1,
                 normalization: str = "BatchNorm"):
        super().__init__()
        cin, cout = in_channels, out_channels
        self.stride = stride
        self.in_norm = make_norm(normalization, cin, num_joints)
        self.shift_in = nn.Parameter(shift_init(1.0)((cin,), generator))
        self.temporal_kernel, self.temporal_bias = _expert_init(cin, cout, generator)
        self.gate = DySEGate(cin, generator)
        self.shift_out = nn.Parameter(shift_init(1.0)((cout,), generator))
        self.out_norm = make_norm(normalization, cout, num_joints)
        self.channels = Split()  # the model split under tensor parallelism
        self.experts = Split()  # the model split under expert parallelism

    def forward(self, x, epoch, mask=None):
        """Under tensor parallelism ``x`` and the output are this rank's
        channel block; the gate and the mixture read it gathered whole."""
        c = self.channels
        frames = frame_split()
        x = sp_temporal_shift(self.in_norm(x, mask=mask), c.part(self.shift_in, -1),
                              frames=frames)
        x = enter(gather_channels(x, c), c)
        g = self.gate(x, epoch)
        x = torch.relu(_experts(x, self.temporal_kernel, self.temporal_bias, g,
                                self.experts, c))
        x = sp_temporal_shift(x, c.part(self.shift_out, -1), self.stride, frames)
        return self.out_norm(x, mask=decimate(mask, self.stride, frames))


class TeacherTemporalShift(TemporalShiftBlock):
    """The teacher's temporal block: Shift-GCN's (a static pointwise
    linear). Its ``out_norm`` is the pre-ReLU norm whose affine parameters
    give the distillation margins."""


class _TeacherUnit(ShiftUnit):
    """A Shift-GCN unit with a :class:`TeacherTemporalShift` that returns
    ``y + res`` before the ReLU (the caller applies it)."""

    temporal_block = TeacherTemporalShift

    def forward(self, x, mask=None):
        return self.preactivation(x, mask)


class _StudentUnit(nn.Module):
    """Student spatial and temporal blocks plus the residual: none, the
    identity, or a strided 1×1 conv ``res_kernel``, ``res_bias`` with no
    norm. Returns ``y + res`` before the ReLU."""

    def __init__(self, in_channels: int, out_channels: int, num_joints: int,
                 generator: torch.Generator, stride: int = 1, residual: bool = True,
                 normalization: str = "BatchNorm"):
        super().__init__()
        self.stride = stride
        self.residual = residual
        self.identity = in_channels == out_channels and stride == 1
        self.spatial = StudentSpatialShift(in_channels, out_channels, num_joints,
                                           generator, normalization)
        self.temporal = StudentTemporalShift(out_channels, out_channels, num_joints,
                                             generator, stride, normalization)
        if residual and not self.identity:
            self.res_kernel = nn.Parameter(
                torch_conv_init(in_channels)((in_channels, out_channels), generator))
            self.res_bias = nn.Parameter(
                torch_bias_init(in_channels)((out_channels,), generator))
        self.channels = Split()  # the model split under tensor parallelism

    def forward(self, x, epoch, mask=None):
        c = self.channels
        x = enter(x, c)
        y = self.temporal(self.spatial(x, epoch, mask=mask), epoch, mask=mask)
        if not self.residual:
            return gather_channels(y, c)
        if self.identity:
            return gather_channels(y + c.part(x, -1), c)
        res = decimate(x, self.stride, frame_split()) @ self.res_kernel + self.res_bias
        return gather_channels(y + res, c)


def _check_lengths(model, window: int) -> None:
    """Raise ``ValueError`` where a unit's features and the skip concatenated
    to them would differ in length (fault 1): the units' strides round up,
    the skips' pool rounds down."""
    h, pooled = window, (window, window // 2, window // 4)
    for i, (scale, stride) in enumerate(zip(model.skip_scale, model.stride)):
        if scale is not None and pooled[scale] < h:
            raise ValueError(
                f"{type(model).__name__}: unit {i} concatenates its input of {h} frames "
                f"with the input pooled to {pooled[scale]} frames (window W = {window}); "
                "W must be a multiple of 4")
        h = -(-h // stride)


class _Backbone(nn.Module):
    """What the teacher and the student share: the per-joint input norm,
    the units with the input concatenated back at their time scale, the
    ReLU after each unit, a global (L, V) mean and the linear head."""

    def _setup(self, num_classes, in_feat, graph, strategy, normalization, channels,
               stride, skip_scale, remat, make_unit, generator):
        self.remat = remat
        self.num_classes = num_classes
        self.in_feat = in_feat
        self.channels = tuple(channels)
        self.stride = tuple(stride)
        self.skip_scale = tuple(skip_scale)
        self.num_joints = Graph(strategy=strategy, **graph).num_node
        self.data_bn = make_norm(normalization, in_feat, self.num_joints, per_joint=True)
        ins = [in_feat] + [c + in_feat for c in self.channels[:-1]]
        self.units = nn.ModuleList(
            make_unit(ins[i], self.channels[i], self.num_joints, generator,
                      stride=self.stride[i], residual=i != 0, normalization=normalization)
            for i in range(len(self.channels)))
        self.TP_MODULES = tuple(f"units.{i}" for i in range(len(self.channels)))
        self.fc = Dense(self.channels[-1], num_classes, generator,
                        kernel_std=(2.0 / num_classes) ** 0.5)

    def _run(self, x, mask, train, extract_features, unit_args=()):
        frames = frame_split()  # under seq: this rank's block of the window
        _check_lengths(self, x.shape[1] if frames is None else frames.edges(x.shape[1])[-1])
        x0 = self.data_bn(x, mask=mask)
        # the skips at the time scales 1, 1/2, 1/4, each split as the units' features
        pooled = [x0, sp_avg_pool(x0, 2, frames)]
        pooled.append(sp_avg_pool(pooled[1], 2, None if frames is None else frames.strided(2)))
        feats, h = [], x0
        with contextlib.ExitStack() as layouts:
            for i, unit in enumerate(self.units):
                if self.skip_scale[i] is not None:
                    h = torch.cat([h, pooled[self.skip_scale[i]][:, : h.shape[1]]], dim=-1)
                # fault 3: the units see no mask
                if self.remat and train:
                    h = checkpointed(unit, h, *unit_args)
                else:
                    h = unit(h, *unit_args)
                layouts.enter_context(strided_layout(unit.stride))
                if extract_features and i in self.feature_taps:
                    feats.append(h)
                h = torch.relu(h)
            out = self.fc(frame_mean(h, frames=frame_split()))
        return (feats, out) if extract_features else out


class ShiftGcnPlusTeacher(_Backbone):
    """The 10-unit teacher: ``(N, W, V, C)`` → ``(N, classes)``, or with
    ``extract_features`` ``([taps of units 3, 6, 9], logits)``. W must be a
    multiple of 4. ``remat=True`` recomputes each unit in the backward pass
    of a training forward. Parameters are drawn from ``generator`` (a fresh
    one seeded 0 if None) on the CPU and the model is moved to ``device``
    (``cuda`` if None)."""

    feature_taps = (3, 6, 9)
    TP_WHOLE = TP_WHOLE
    TP_PARTIAL = tp_partial("units.*")

    def __init__(self, num_classes: int, in_feat: int, graph: dict[str, Any],
                 strategy: str = "spatial", normalization: str = "BatchNorm",
                 channels: Sequence[int] = (64, 64, 64, 64, 128, 128, 128, 256, 256, 256),
                 stride: Sequence[int] = (1, 1, 1, 1, 2, 1, 1, 2, 1, 1),
                 remat: bool = False, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = default_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self._setup(num_classes, in_feat, graph, strategy, normalization, channels, stride,
                    (None, 0, 0, 0, 0, 1, 1, 1, 2, 2), remat, _TeacherUnit, generator)
        self.to(device)

    def forward(self, x, mask=None, train: bool = False,
                generator: torch.Generator | None = None, extract_features: bool = False):
        """``mask`` ``(N, W)`` reaches the input norm only (fault 3);
        ``generator`` is accepted for the Trainer's call and unused (no
        dropout)."""
        return self._run(x, mask, train, extract_features)


class ShiftGcnPlusStudent(_Backbone):
    """The 7-unit student of dynamic shift experts: ``forward(x, epoch)``
    gives ``(N, classes)``, or with ``extract_features`` ``([taps of units
    2, 4, 6], logits)``. ``epoch`` (a number or a 0-d tensor; ∞ gives τ = 1)
    sets the gates' temperature. Otherwise as :class:`ShiftGcnPlusTeacher`."""

    feature_taps = (2, 4, 6)
    TP_WHOLE = {**TP_WHOLE, "units.*.gate": _GATE_WHOLE}
    TP_PARTIAL = (*tp_partial("units.*"), "units.*.gate")

    def __init__(self, num_classes: int, in_feat: int, graph: dict[str, Any],
                 strategy: str = "spatial", normalization: str = "BatchNorm",
                 c_mul: int = 4, stride: Sequence[int] = (1, 1, 1, 2, 1, 2, 1),
                 remat: bool = False, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = default_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.c_mul = c_mul
        channels = [8 * c_mul] * 3 + [16 * c_mul] * 2 + [32 * c_mul] * 2
        self._setup(num_classes, in_feat, graph, strategy, normalization, channels, stride,
                    (None, 0, 0, 0, 1, 1, 2), remat, _StudentUnit, generator)
        self.to(device)

    def forward(self, x, epoch=math.inf, mask=None, train: bool = False,
                generator: torch.Generator | None = None, extract_features: bool = False):
        return self._run(x, mask, train, extract_features, (epoch,))


# -- distillation -------------------------------------------------------------------


def margin_from_norm_params(scale, bias):
    """The margin of each channel from a pre-ReLU norm's affine parameters:
    the mean of N(bias, scale²) below zero, ``m − s·φ(m/s)/Φ(−m/s)``, and
    −3s where ``Φ(−m/s) ≤ 1e-3`` (s = max(|scale|, 1e-12), the CDF floored
    at 1e-12 in the division). In fp32 (fp64 for fp64 input) but for the
    CDF, of the input's shape (``(C,)`` for a BatchNorm, ``(V, C)`` for a
    LayerNorm)."""
    s = torch.clamp_min(torch.abs(scale.to(_acc(scale))), 1e-12)
    m = bias.to(s.dtype)
    # the CDF in float64: float32's ndtr is 1e-5 off in the tail near the
    # branch, where the margin amplifies it twelvefold
    cdf = torch.special.ndtr((-m / s).double()).to(s.dtype)
    val = (-s * torch.exp(-((m / s) ** 2) / 2.0) / math.sqrt(2.0 * math.pi)
           / torch.clamp_min(cdf, 1e-12) + m)
    return torch.where(cdf > 1e-3, val, -3.0 * s)


def distillation_loss(source, target, margin):
    """Heo et al.'s margin-ReLU loss, summed: ``(s − m)²`` where s > m ≥ t;
    ``(s − t)²`` where s > t > m and t ≤ 0, or where t > 0. The target is
    detached. Summed in fp32 (fp64 for fp64 input) whatever the inputs'
    type."""
    acc = _acc(source)
    s, t, m = source.to(acc), target.detach().to(acc), margin.to(acc)
    loss = ((s - m) ** 2 * ((s > m) & (t <= m))
            + (s - t) ** 2 * ((s > t) & (t > m) & (t <= 0))
            + (s - t) ** 2 * (t > 0))
    return loss.abs().sum()


class ShiftGcnPlus(nn.Module):
    """The distillation wrapper: ``forward(x, epoch)`` gives
    ``(student_logits, loss)``. Parameters: ``teacher``, ``student``,
    ``connectors.i`` ``(C_student, C_teacher)`` (bias-free) and
    ``connector_norms.i``. Load a trained teacher with
    :func:`graft_teacher_params`. ``remat`` reaches the student's units,
    not the teacher's. ``mask`` is accepted and unused (fault 2).

    Tensor parallelism shards the teacher's and the student's units
    (``TP_MODULES``); the connectors, their norms and both models' input
    norms and heads stay whole (``TP_WHOLE``)."""

    TP_WHOLE = {
        **{f"{m}.{k}": why for m in ("teacher", "student") for k, why in TP_WHOLE.items()},
        "student.units.*.gate": _GATE_WHOLE,
        "connectors": "a connector reads the whole student tap, and its output is held "
                      "against the whole teacher tap in the distillation loss",
        "connector_norms": "the connector's output is whole (see connectors)",
    }
    # the teacher gets no gradient: only the student's whole parameters are partial
    TP_PARTIAL = (*tp_partial("student.units.*"), "student.units.*.gate")
    TP_NO_GRAD = {"teacher": "the teacher runs under no_grad, so its whole feature masks "
                             "and shifts need no sum over model"}

    def __init__(self, num_classes: int, in_feat: int, graph: dict[str, Any],
                 strategy: str = "spatial", normalization: str = "BatchNorm",
                 c_mul: int = 4, remat: bool = False, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = default_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        common = dict(num_classes=num_classes, in_feat=in_feat, graph=graph,
                      strategy=strategy, normalization=normalization, device="cpu",
                      generator=generator)
        self.teacher = ShiftGcnPlusTeacher(**common)
        self.student = ShiftGcnPlusStudent(c_mul=c_mul, remat=remat, **common)
        self.remat = remat
        self.num_classes, self.in_feat = num_classes, in_feat
        self.num_joints = self.teacher.num_joints
        t_ch = [self.teacher.channels[u] for u in self.teacher.feature_taps]
        s_ch = [self.student.channels[u] for u in self.student.feature_taps]
        self.connectors = nn.ParameterList(
            torch.empty(s, t).normal_(0.0, (2.0 / t) ** 0.5, generator=generator)
            for s, t in zip(s_ch, t_ch))
        self.connector_norms = nn.ModuleList(
            make_norm(normalization, t, self.num_joints) for t in t_ch)
        self.TP_MODULES = tuple(f"{m}.{u}" for m in ("teacher", "student")
                                for u in getattr(self, m).TP_MODULES)
        self.to(device)

    def margins(self):
        """The margins of the three stages, from the out norm of each tap
        unit's :class:`TeacherTemporalShift` (its blocks gathered whole under
        tensor parallelism), in fp32 (fp64 for an fp64 model) and detached."""
        out = []
        for u in self.teacher.feature_taps:
            unit = self.teacher.units[u]
            with torch.no_grad():
                scale, bias = (gather_channels(t, unit.channels) for t in
                               (unit.temporal.out_norm.scale, unit.temporal.out_norm.bias))
            out.append(margin_from_norm_params(scale, bias).detach())
        return out

    def forward(self, x, epoch=math.inf, mask=None, train: bool = False,
                generator: torch.Generator | None = None):
        # fault 2: mask reaches neither model nor the connector norms
        with torch.no_grad():
            t_feats, _ = self.teacher(x.detach(), extract_features=True)
            margins = self.margins()
        s_feats, s_out = self.student(x, epoch, train=train, extract_features=True)
        n = len(t_feats)
        loss = 0.0
        for i, (sf, tf, margin) in enumerate(zip(s_feats, t_feats, margins)):
            sf = self.connector_norms[i](sf @ self.connectors[i])
            loss = loss + distillation_loss(sf, tf, margin.to(tf.dtype)) / 2 ** (n - i - 1)
        return s_out, loss


def graft_teacher_params(wrapper: ShiftGcnPlus, teacher_state) -> None:
    """Load a trained teacher into ``wrapper.teacher``: ``teacher_state`` is
    the ``state_dict`` of a :class:`ShiftGcnPlusTeacher` (a checkpoint of a
    ``shift-gcn++-teacher`` run holds it under ``"model"``). Raises
    ``ValueError`` when the keys or a shape differ from the wrapper's
    teacher."""
    own = wrapper.teacher.state_dict()
    if set(teacher_state) != set(own):
        diff = sorted(set(teacher_state) ^ set(own))
        raise ValueError("teacher checkpoint does not match the wrapper's teacher "
                         f"architecture (keys differ: {diff[:4]})")
    for k, v in teacher_state.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"teacher leaf shape mismatch at {k}: {tuple(own[k].shape)} "
                             f"vs {tuple(v.shape)}")
    wrapper.teacher.load_state_dict(teacher_state, strict=True)
