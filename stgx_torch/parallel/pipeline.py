"""Pipeline parallelism: the MS-TCN / MS-GCN refinement stages one a rank
of the mesh's ``model`` axis — the port of ``stgx/parallel/pipeline.py``.

The JAX package stacks the S stages' parameters, shards the stack over
``model`` inside a ``shard_map`` and runs a GPipe ``scan`` of S + M − 1
ticks whose activations ride ``ppermute``; XLA differentiates through it.
The port runs one process a device, so the schedule is written out:

* every rank holds every stage's parameters (as the JAX ``Trainer`` keeps
  them replicated under ``pipeline``) and runs stage ``s`` = its ``model``
  index on each of the M microbatches in turn, receiving the microbatch
  from rank ``s − 1`` (stage 0: the generator's output) and sending its
  output to rank ``s + 1`` (``torch.distributed`` point-to-point, as the
  halo exchange sends). Idle ticks are skipped: a rank waits for its input
  instead;
* the backward runs the schedule in reverse: a rank receives the gradient
  of its outputs from rank ``s + 1``, adds the loss's own share (every
  stage's outputs are gathered to every rank, since the loss reads them
  all) and sends its input's gradient one hop back;
* stage ``s``'s parameters get their gradient on rank ``s`` only (zeros
  elsewhere): the caller sums them over ``model``
  (:func:`stgx_torch.parallel.tp.sum_partial_grads`; the ``Trainer`` does),
  so every rank ends the step with the same whole parameters. The first
  stage's input, the generator's output, is replicated over ``model``: its
  gradient through the pipeline (stage 0's) is broadcast to every model
  rank, so the generator's own gradients are whole on each and counted
  once.

Microbatch samples split over ``data`` as the caller lays the batch out
(the ``Trainer`` gives each data rank its trials); ``seq`` ranks under the
pipeline hold replicas.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.func import functional_call

__all__ = [
    "stack_stage_params",
    "pipeline_apply",
    "uniform_refine",
    "stage_parameters",
    "mstcn_apply_pipelined",
    "msgcn_refine_pipelined",
]

STAGES = "refinement_stages"  # the pipelined stages' module in MsTcn and MsGcn


def stack_stage_params(params: dict, names: list) -> dict:
    """``{leaf: (S, ...) tensor}``: the stages ``params[name]`` (each a
    ``{leaf: tensor}`` dict of one shape) stacked on a new leading stage
    axis, differentiably."""
    stages = [params[n] for n in names]
    return {k: torch.stack([st[k] for st in stages]) for k in stages[0]}


def microbatches(n: int, stages: int, num_microbatches: int | None = None) -> int:
    """M: ``num_microbatches``, else S where it divides N, else gcd(N, S)
    (``stgx/parallel/pipeline.py:90-100``); must divide N."""
    if num_microbatches is not None:
        m = num_microbatches
    elif n % stages == 0:
        m = stages
    else:
        m = math.gcd(n, stages)
    if n % m:
        raise ValueError(f"batch {n} not divisible into {m} microbatches")
    return m


class _Schedule:
    """One call's GPipe schedule on this rank: stage ``split.index`` of
    ``split.size`` over M microbatches, with the local graphs kept for the
    backward."""

    def __init__(self, stage_fn, keys, split, m, need_grad):
        self.stage_fn, self.keys, self.split, self.m = stage_fn, keys, split, m
        self.need_grad = need_grad
        self.saved = []

    def _peer(self, offset):
        return dist.get_global_rank(self.split.group, self.split.index + offset)

    def forward(self, y, params):
        s, size = self.split.index, self.split.size
        y_mb = y.reshape(self.m, y.shape[0] // self.m, *y.shape[1:])
        self.leaves = [p.detach().requires_grad_(self.need_grad) for p in params]
        stage = dict(zip(self.keys, self.leaves))
        outs, sends = [], []
        for m in range(self.m):
            if s == 0:
                inp = y_mb[m].detach()
            else:
                inp = torch.empty_like(y_mb[m])
                dist.recv(inp, self._peer(-1))
            with torch.enable_grad():
                inp.requires_grad_(self.need_grad)
                out = self.stage_fn(stage, inp)
            if self.need_grad:
                self.saved.append((inp, out))
            out = out.detach()
            outs.append(out)
            if s + 1 < size:
                sends.append(dist.isend(out.contiguous(), self._peer(1)))
        for req in sends:
            req.wait()
        local = torch.cat(outs).contiguous()  # (N, ...) of this stage
        every = [torch.empty_like(local) for _ in range(size)]
        dist.all_gather(every, local, group=self.split.group)
        return torch.stack(every)

    def backward(self, g, y):
        s, size = self.split.index, self.split.size
        mine = g[s].reshape(self.m, -1, *g.shape[2:])
        gy = torch.zeros((self.m, *mine.shape[1:]), dtype=y.dtype, device=y.device)
        gp = [torch.zeros_like(p) for p in self.leaves]
        sends = []
        for m in reversed(range(self.m)):
            inp, out = self.saved[m]
            gout = mine[m].to(out.dtype).clone()
            if s + 1 < size:
                buf = torch.empty_like(gout)
                dist.recv(buf, self._peer(1))
                gout += buf
            grads = torch.autograd.grad(out, [inp, *self.leaves], gout, allow_unused=True)
            gin = grads[0] if grads[0] is not None else torch.zeros_like(inp)
            if s > 0:
                sends.append(dist.isend(gin.contiguous(), self._peer(-1)))
            else:
                gy[m] = gin
            for acc, gr in zip(gp, grads[1:]):
                if gr is not None:
                    acc += gr
        for req in sends:
            req.wait()
        self.saved = []
        # y is replicated over model: stage 0's gradient, on every model rank
        dist.broadcast(gy, self._peer(-s), group=self.split.group)
        return gy.reshape(y.shape), gp


class _Pipeline(torch.autograd.Function):

    @staticmethod
    def forward(ctx, schedule, y, *params):
        ctx.schedule = schedule
        ctx.save_for_backward(y)
        return schedule.forward(y, params)

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        gy, gp = ctx.schedule.backward(g.contiguous(), y)
        return (None, gy, *gp)


def pipeline_apply(stage_fn, stacked_params: dict, y, mesh, axis: str = "model",
                   num_microbatches: int | None = None):
    """Run ``stage_fn`` S times, one stage a rank of ``axis``.

    Args:
        stage_fn: ``(one_stage_params, y) -> y'``, one refinement stage with
            its input adapter; the stage's output has its input's shape.
        stacked_params: ``{leaf: (S, ...)}`` (:func:`stack_stage_params`),
            S the size of ``axis``.
        y: ``(N, ...)``, this rank's input to the first stage (the same on
            every rank of ``axis``).
        mesh: a :class:`~stgx_torch.parallel.mesh.Mesh`.
        num_microbatches: M (:func:`microbatches`).

    Returns ``(S, N, ...)``, every stage's output in stage order, on every
    rank of ``axis``; differentiable (see the module's note: the stages'
    gradients are this rank's stage's only).
    """
    split = mesh.split(axis)
    keys = list(stacked_params)
    s_leaf = stacked_params[keys[0]].shape[0]
    if s_leaf != split.size:
        raise ValueError(
            f"stage count {s_leaf} != mesh axis {axis!r} size {split.size}; "
            "size the mesh so one device holds one refinement stage")
    m = microbatches(y.shape[0], split.size, num_microbatches)
    params = [stacked_params[k][split.index] for k in keys]
    need_grad = torch.is_grad_enabled() and (y.requires_grad
                                             or any(p.requires_grad for p in params))
    return _Pipeline.apply(_Schedule(stage_fn, keys, split, m, need_grad), y, *params)


def uniform_refine(model, lo: int) -> tuple:
    """The one ``(filters, layers, kernel, dropout)`` plan of stages ``lo``
    onwards; ``ValueError`` if they differ (a pipeline stacks them)."""
    kernel = getattr(model, "refine_kernel", None) or model.kernel
    drop = getattr(model, "refine_dropout", None) or model.dropout
    plans = {(model.filters[s], model.layers[s], kernel[s], drop[s])
             for s in range(lo, len(model.filters))}
    if len(plans) != 1:
        raise ValueError("pipeline parallelism needs a stage-uniform refinement plan; "
                         f"got {sorted(plans)}")
    return next(iter(plans))


def stage_parameters(model) -> set:
    """The names of the pipelined stages' parameters: each gets its gradient
    on its own ``model`` rank only, so they are summed over ``model``."""
    return {n for n, _ in model.named_parameters() if n.startswith(STAGES + ".")}


def _sub(params: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in params.items() if k.startswith(prefix + ".")}


def _refine(model, params, y, mesh, axis, num_microbatches, dropout):
    """Every refinement stage's output ``(stages, N, L, classes)`` over the
    pipeline, from the generator's per-frame output ``y``. With the stages'
    ``dropout`` 0 they run their training form, which keeps ``remat`` (its
    recompute in the schedule's backward), as the JAX pipeline does; it
    draws no random number, so it equals the eval form."""
    names = [f"{STAGES}.{s}" for s in range(len(model.refinement_stages))]
    stacked = stack_stage_params({n: _sub(params, n) for n in names}, names)
    template = model.refinement_stages[0]
    train = {"train": dropout == 0.0}

    def stage_fn(sp, yin):
        return functional_call(template, sp, (model.prob(yin)[:, :, None, :],),
                               train)[:, :, 0, :]

    return pipeline_apply(stage_fn, stacked, y, mesh, axis, num_microbatches)


def mstcn_apply_pipelined(model, x, mesh, axis: str = "model",
                          num_microbatches: int | None = None, params: dict | None = None):
    """``MsTcn.forward(x)`` with its ``stages − 1`` refinement stages
    pipelined over ``axis``: ``(stages, N, L, classes)``, equal to the
    sequential model's (eval form; with dropout 0, as the ``Trainer``
    requires, also the training form). ``params`` (``{name: tensor}``, e.g.
    cast for bf16 compute) replaces the model's own."""
    dropout = uniform_refine(model, 1)[3]
    params = dict(model.named_parameters()) if params is None else params
    y = functional_call(model.generator_stage, _sub(params, "generator_stage"), (x,))
    y = y.mean(dim=2)  # pool joints: (N, L, C)
    refined = _refine(model, params, y, mesh, axis, num_microbatches, dropout)
    return torch.cat([model.out(y)[None], model.out(refined)])


def msgcn_refine_pipelined(model, gen_logits, mesh, axis: str = "model",
                           num_microbatches: int | None = None):
    """MS-GCN's refinement over pipelined stages: ``gen_logits`` the ST-GCN
    generator's window logits as a ``(1, T, classes)`` series; returns
    ``(stages + 1, 1, T, classes)`` as ``MsGcn.forward``."""
    dropout = uniform_refine(model, 0)[3]
    refined = _refine(model, dict(model.named_parameters()), gen_logits, mesh, axis,
                      num_microbatches, dropout)
    return torch.cat([model.out(gen_logits)[None], model.out(refined)])
