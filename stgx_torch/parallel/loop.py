"""Training and evaluation, on one device or over a mesh of processes — the port of
``stgx/parallel/loop.py`` for its four kinds: ``frame`` (RT-ST-GCN,
CoST-GCN), ``frame_ms`` (MS-TCN), ``window`` (ST-GCN, AA-GCN, Shift-GCN)
and ``window_ms`` (MS-GCN).

* **Unequal-length trials** are padded to static length buckets with frame
  masks (:func:`stgx_torch.parallel.segments.pad_to_bucket`).
* **Window models** see a trial as its per-frame receptive-field windows
  (:func:`stgx_torch.parallel.segments.sliding_windows`, ``W =
  receptive_field``), one window per frame, processed in ``segment``-sized
  chunks (the reference's memory knob). A chunk's window logits ``(B,
  classes)`` form the per-frame series ``(1, B, classes)`` the loss sees
  (``window_ms``: MS-GCN's ``(S, 1, B, classes)``, every stage); a window
  is masked as a whole (its frame mask broadcast over W), never frame by
  frame. A chunk's loss is divided by ``divisor · len(chunks)``, and a
  trial's reported CE and MSE are the mean over its chunks.
* **Multi-stage kinds** (``_ms``) emit ``(S, N, L, classes)``: the loss
  sums over the stages (``LossMultiStage``) and the top-1/top-5 counts take
  the last stage (``StatisticsMultiStage``, the default for these kinds).
* **Gradient accumulation** keeps the JAX ``Trainer``'s exact divisors:
  every trial's loss is divided by ``batch_size``, except the ragged final
  group's, divided by ``len(dataset) % batch_size``; gradients add up in
  the parameters' ``.grad`` and Adam steps every ``batch_size`` trials and
  after the last one.
* **trial_batch** (frame kinds) stacks up to that many consecutive
  same-bucket trials into one forward, each with its own loss normalisation
  and divisor, never across an optimizer step or the ragged boundary.
  BatchNorm statistics then span the stack, as in the JAX package.
* **Learning rate** decays as ``lr · decay^epoch`` (:meth:`Trainer.set_lr`).
* **Adam** is ``torch.optim.Adam`` with betas (0.9, 0.999) and eps 1e-8, the
  same update as optax's ``adam``.
* **compute_dtype="bfloat16"** runs forward and backward in bf16: the
  parameters stay fp32 in the optimizer and are cast at the step boundary
  (``torch.func.functional_call``), so their gradients come back fp32
  through the cast; norm statistics and the loss stay fp32.
* **Dropout** draws its masks from a ``torch.Generator`` on the model's
  device, seeded ``opt.seed + 1000 + epoch`` unless the caller passes one,
  so a run resumed at epoch e draws what an unbroken run draws there.
* **Checkpoints** (:meth:`Trainer.save`, :meth:`Trainer.restore`) hold the
  model, Adam's state and the epoch (:mod:`stgx_torch.utils.checkpoint`);
  :meth:`Trainer.load_adam_moments` writes moments imported from a
  reference checkpoint into Adam's state.
* **pass_epoch** (the models of ``MODEL_EPOCH_ARG``: Shift-GCN++, whose
  expert gates anneal their temperature over the epochs) gives the model
  the epoch as its second argument, a 0-d float32 tensor on its device made
  once an epoch (so a captured step copies nothing from the host); ∞ at
  evaluation and prediction (τ = 1).
* **Auxiliary losses**: a model that returns ``(logits, aux)`` (the
  Shift-GCN++ wrapper's distillation loss) trains a window chunk on
  ``(ce + mse + aux) / divisor``; the reported CE and MSE leave aux out,
  and evaluation ignores it, as in the JAX ``Trainer``.

* **A mesh** (``mesh=``, :func:`stgx_torch.parallel.mesh.make_mesh`): one
  process a device, every process running the same epoch on its block of
  each step's batch, as the JAX ``Trainer`` shards it (``_shard``): trials
  (or a chunk's windows) split over ``data`` only where their count
  divides, else every data rank computes the whole step; frames (the
  frame kinds' trial frames, the window kinds' W frames of every window)
  split over ``seq`` only where their count divides, else the ``seq`` ranks
  hold replicas. The step runs under
  :func:`~stgx_torch.parallel.mesh.use_shards`: synced BatchNorm
  statistics, the halos of the frame-axis ops and the sums over the frames
  (:mod:`stgx_torch.parallel.halo`; the blocks' bounds follow every
  strided layer, so they may differ in length), dropout masks sliced from
  the one-process draw, and each rank's share of the loss
  (:mod:`stgx_torch.utils.loss`). A window chunk's logits are whole on
  every ``seq`` rank: each of these replicas carries ``1/seq`` of their
  loss. Each step's gradients are summed (not averaged: the divisors are
  already the whole batch's) over the ranks that hold different parts
  before they join the accumulated ``.grad``; the reported
  losses, top-k counts and the evaluation's per-frame top-1 are summed or
  gathered over the ranks that hold different parts of the loss, so every
  rank logs the same numbers (durations: the slowest rank's). Each rank
  feeds the metrics a contiguous block of the trials, which their
  ``reduce`` gathers across processes in trial order. Rank 0 alone writes
  checkpoints. The parameters are broadcast from rank 0 at the start.
  Under a mesh past one device the fused RT kernel is switched off, with
  the JAX ``Trainer``'s warning. ``remat`` runs under every layout: each
  layer's recompute in the backward pass runs under the layout the layer
  ran under, its collectives again in the same order on every rank
  (:mod:`stgx_torch.models._remat`), and the pipelined stages keep it, as
  the JAX pipeline does.
* **The mesh's ``model`` axis**, as the JAX ``Trainer``'s ``place_params``
  uses it: tensor parallelism for every family and kind
  (:func:`stgx_torch.parallel.tp.shard_params_tp` cuts the parameters, and
  so Adam's state, to this rank's channel blocks), or with
  ``pipeline=True`` the MS-TCN refinement stages one a ``model`` rank
  (:func:`stgx_torch.parallel.pipeline.mstcn_apply_pipelined`; the JAX
  checks: the ``frame_ms`` kind, a ``model`` axis, zero dropout). Under the
  pipeline the ``seq`` ranks hold replicas, as the JAX pipeline replicates
  its input over ``seq``. Each gradient is summed over the ranks that hold
  other parts of the batch (at this rank's ``model`` position), and the
  partial ones (TP's edge importance, the pipeline's stages) over ``model``
  too; the rest are complete on every ``model`` rank. Checkpoints hold the
  whole state (:mod:`stgx_torch.utils.checkpoint`).
* The ``window_ms`` kind (MS-GCN) splits a chunk's windows over ``data``
  for the generator stage and the refinement alike; the refinement's
  dilated convs take their halos from the other data ranks
  (:class:`stgx_torch.models.msgcn.MsGcn`).
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from stgx_torch.parallel.mesh import (
    Shards,
    Split,
    gather_blocks,
    reduce_scalars,
    replicate,
    use_shards,
)
from stgx_torch.parallel.segments import pad_to_bucket, sliding_windows
from stgx_torch.parallel.tp import local_state, sum_partial_grads
from stgx_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from stgx_torch.utils.statistics import Statistics, StatisticsMultiStage

__all__ = ["Trainer", "OptimizerConfig", "MODEL_KIND", "MODEL_EPOCH_ARG"]

# how each model family consumes a trial and emits per-frame predictions
MODEL_KIND = {
    "st-gcn": "window",
    "aa-gcn": "window",
    "shift-gcn": "window",
    "shift-gcn++": "window",
    "shift-gcn++-teacher": "window",
    "co-st-gcn": "frame",
    "rt-st-gcn": "frame",
    "ms-tcn": "frame_ms",
    "ms-gcn": "window_ms",
}

# models whose forward takes the epoch (Shift-GCN++'s DY-SE gate anneals its
# softmax temperature 30 → 1 over 60 epochs)
MODEL_EPOCH_ARG = frozenset({"shift-gcn++"})

COMPUTE_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}
KINDS = ("frame", "frame_ms", "window", "window_ms")
_FRAME_KINDS = ("frame", "frame_ms")


@dataclass
class OptimizerConfig:
    learning_rate: float = 5e-4
    learning_rate_decay: float = 1.0
    batch_size: int = 16
    epochs: int = 10
    seed: int = 0
    checkpoint_indices: tuple = ()


@dataclass
class Trainer:
    """Trains ``model`` in place with its own Adam optimizer.

    ``model`` is a port model (``forward(x, mask=, train=, generator=)``) on
    the device the trainer runs on; ``loss`` a :class:`~stgx_torch.utils.Loss`.
    """

    model: Any
    kind: str  # 'frame' | 'frame_ms' | 'window' | 'window_ms'
    loss: Any
    opt: OptimizerConfig
    receptive_field: int = 50  # window size W of the window kind
    segment: int | None = None  # windows per chunk of the window kind
    bucket: int = 128  # length-bucket granularity
    trial_batch: int = 1  # trials stacked into one forward (frame kinds)
    compute_dtype: str | None = None  # None / 'float32' or 'bfloat16'
    statistics: Any = None  # top-1/top-5 strategy; by the kind if unset
    pass_epoch: bool = False  # the epoch as the model's second argument
    mesh: Any = None  # a (data, seq, model) Mesh of stgx_torch.parallel.mesh, or one process
    # MS-TCN's refinement stages one a rank of the mesh's model axis
    pipeline: bool = False

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown Trainer kind {self.kind!r} (have {KINDS})")
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"unknown compute_dtype: {self.compute_dtype!r}")
        if self.statistics is None:
            self.statistics = (StatisticsMultiStage() if self.kind.endswith("_ms")
                               else Statistics())
        self.device = next(self.model.parameters()).device
        if self.pipeline:
            if self.kind != "frame_ms":
                raise ValueError("pipeline=True needs an ms-tcn-kind model")
            if self.mesh is None or self.mesh.shape["model"] < 2:
                raise ValueError("pipeline=True needs a mesh with a `model` axis sized to "
                                 "the refinement-stage count")
            if any(d != 0.0 for d in self.model.dropout):
                raise ValueError("pipelined ms-tcn needs zero dropout in every stage")
        self._partial, self._model_group = set(), None  # ids of the partial parameters
        if self.mesh is not None:
            self._check_mesh()
        self.optimizer = torch.optim.Adam(
            self.model.parameters(), lr=self.opt.learning_rate,
            betas=(0.9, 0.999), eps=1e-8,
        )

    def _check_mesh(self):
        tp = self.mesh.shape["model"] > 1 and not self.pipeline
        if self.mesh.size > 1:
            from stgx_torch.ops.rt_fused import rt_fused_enabled, set_rt_fused

            if rt_fused_enabled():
                warnings.warn(
                    "arch.rt_fused disabled: the fused RT-layer kernel sees one rank's "
                    "block only; falling back to the gcn_core + window_sum chain on this "
                    f"{self.mesh.size}-device mesh")
                set_rt_fused(False)
        replicate(self.mesh, self.model)
        if self.mesh.shape["model"] == 1:
            return
        self._model_group = self.mesh.split("model").group
        if tp:
            from stgx_torch.parallel.tp import shard_params_tp

            partial = shard_params_tp(self.model, self.mesh)["partial"]
        else:
            from stgx_torch.parallel.pipeline import stage_parameters

            partial = stage_parameters(self.model)
        self._partial = {id(p) for n, p in self.model.named_parameters() if n in partial}

    # -- the batch over the mesh ------------------------------------------------

    def layout(self, x):
        """The :class:`~stgx_torch.parallel.mesh.Shards` of a step's batch
        ``x`` (``(N, L, V, C)`` trials, or a chunk's ``(B, W, V, C)``
        windows), or None without a mesh, as the JAX ``Trainer``'s
        ``_shard`` lays it out: axis 0 over ``data`` where N (B) divides,
        axis 1, the frames (a window's W frames), over ``seq`` where L (W)
        divides, in equal blocks whose bounds the strided layers follow."""
        if self.mesh is None:
            return None
        # under the pipeline the seq ranks hold replicas (the JAX pipeline's input spec)
        split_l = not self.pipeline and x.shape[1] % self.mesh.shape["seq"] == 0
        return self.mesh.shards(x.shape[0] % self.mesh.shape["data"] == 0, split_l,
                                x.shape[1])

    def _local(self, shards, x, y, mask):
        """This rank's block of the global ``x``, ``y`` and ``mask`` (None
        stays None): axes 0 and 1 of each for the frame kinds; of the window
        kinds' ``x`` axes 0 and 1, of their per-window labels and mask axis 0."""
        axes = 2 if self.kind in _FRAME_KINDS else 1
        return (shards.local(x), shards.local(y, axes),
                None if mask is None else shards.local(mask, axes))

    def _loss_layout(self, shards):
        """The layout of the loss's ``(N, L)`` series: the batch's for the
        frame kinds; for the window kinds, a chunk's windows are its frames,
        split over ``data`` only (the ``seq`` ranks hold replicas of them,
        :meth:`_replicas`)."""
        if shards is None or self.kind in _FRAME_KINDS:
            return shards
        n = shards.n
        return Shards(Split(), n, n.group, n.size, shards.device)

    def _replicas(self, shards) -> int:
        """How many ranks hold each of the loss's parts: a window chunk's
        ``seq`` ranks, whose logits are each window's whole (1 for the
        frame kinds, whose frames are the loss's)."""
        if shards is None or self.kind in _FRAME_KINDS:
            return 1
        return shards.l.size

    def _sum(self, shards, *values) -> list:
        """Per-part numbers summed over the ranks that hold the parts."""
        if shards.group is None:
            return [float(v) for v in values]
        return reduce_scalars(values, shards.group, shards.device)

    def slowest(self, seconds: float) -> float:
        """``seconds`` of this process, or under a mesh the slowest
        process's (so that every rank reports the same)."""
        if self.mesh is None:
            return seconds
        return reduce_scalars([seconds], dist.group.WORLD, self.mesh.device,
                              op=dist.ReduceOp.MAX)[0]

    def _backward(self, scaled, shards):
        """``scaled``'s gradient into ``.grad``; under a mesh this step's
        gradients summed over the ranks that hold the parts first, and the
        partial ones (:attr:`_partial`) over ``model`` too."""
        parts = shards is not None and shards.group is not None
        if not parts and not self._partial:
            scaled.backward()
            return
        params = [p for p in self.model.parameters() if p.requires_grad]
        grads = list(torch.autograd.grad(scaled, params, allow_unused=True))
        partial = [i for i, p in enumerate(params) if id(p) in self._partial]
        for i in partial:  # a rank may not reach a stage it did not run
            if grads[i] is None:
                grads[i] = torch.zeros_like(params[i])
        if parts:
            used = [i for i, g in enumerate(grads) if g is not None]
            for i, total in zip(used, sum_partial_grads([grads[i] for i in used],
                                                        shards.group)):
                grads[i] = total
        if partial:
            for i, total in zip(partial, sum_partial_grads([grads[i] for i in partial],
                                                           self._model_group)):
                grads[i] = total
        for p, g in zip(params, grads):
            if g is None:
                continue
            if p.grad is None:
                p.grad = g.clone()
            else:
                p.grad.add_(g)

    def _feeds(self, n_visit: int) -> range:
        """The trials whose metric rows this process adds: every one in one
        process; under a mesh a contiguous block a rank, in rank order, so
        that the metrics' cross-process reduce sees each row once, in
        trial order."""
        if self.mesh is None:
            return range(n_visit)
        r, w = dist.get_rank(), dist.get_world_size()
        return range(r * n_visit // w, (r + 1) * n_visit // w)

    def set_lr(self, epoch: int) -> float:
        """``lr · decay^epoch`` into every parameter group; returns it."""
        rate = self.opt.learning_rate * (self.opt.learning_rate_decay**epoch)
        for group in self.optimizer.param_groups:
            group["lr"] = rate
        return rate

    # -- state in and out -------------------------------------------------------

    def save(self, out_dir: str, epoch: int, name: str | None = None) -> str:
        """Checkpoint the model, Adam's state and ``epoch`` to
        ``{out_dir}/epoch-{epoch}`` (or ``{out_dir}/{name}``)."""
        return save_checkpoint(out_dir, epoch, self.model, self.optimizer, name)

    def restore(self, path: str) -> int:
        """Load a checkpoint's model and Adam state and set the learning rate
        of its epoch; returns that epoch (training resumes after it)."""
        epoch = restore_checkpoint(path, self.model, self.optimizer)
        self.set_lr(epoch)
        return epoch

    def load_adam_moments(self, mu: dict, nu: dict, count: int) -> None:
        """Replace Adam's first and second moments and its step count:
        ``mu`` and ``nu`` map every parameter name of the model to a tensor
        of its shape (a reference checkpoint's moments, imported)."""
        params = dict(self.model.named_parameters())
        for moments in (mu, nu):
            if set(moments) != set(params):
                raise ValueError(
                    f"Adam moments for {sorted(set(moments) ^ set(params))[:4]} do "
                    "not match the model's parameters")
        # whole moments: this rank's blocks under tensor parallelism
        mu, nu = local_state(self.model, mu), local_state(self.model, nu)
        for name, p in params.items():
            self.optimizer.state[p] = {
                "step": torch.tensor(float(count)),
                "exp_avg": mu[name].detach().to(p).clone(),
                "exp_avg_sq": nu[name].detach().to(p).clone(),
            }

    def epoch_generator(self, epoch: int) -> torch.Generator:
        """The dropout generator of ``epoch``: seeded ``seed + 1000 + epoch``."""
        return torch.Generator(device=self.device).manual_seed(
            self.opt.seed + 1000 + epoch)

    def epoch_tensor(self, epoch=None) -> torch.Tensor:
        """The epoch as the model sees it with ``pass_epoch``: a 0-d float32
        tensor on the model's device; None gives ∞ (evaluation)."""
        return torch.tensor(np.inf if epoch is None else float(epoch),
                            dtype=torch.float32, device=self.device)

    # -- steps -----------------------------------------------------------------

    def _outputs(self, x, mask, train: bool, generator=None, epoch=None):
        """``(out, aux)``: per-frame outputs in fp32, ``(N, L, C)`` of N
        stacked trials, or ``(1, B, C)`` of a chunk of B windows ``(B, W,
        V, C)`` with the ``(B,)`` mask, each window masked as a whole; a
        leading stage axis for the ``_ms`` kinds. ``aux`` is the auxiliary
        loss of a model that returns ``(logits, aux)``, else 0. With
        ``pass_epoch`` the model gets ``epoch`` (∞ if None) after ``x``."""
        dt = COMPUTE_DTYPES[self.compute_dtype]
        if self.kind.startswith("window") and mask is not None:
            mask = mask[:, None].expand(x.shape[0], x.shape[1])
        kwargs = {"mask": mask, "train": train, "generator": generator}
        args = (x if dt is None else x.to(dt),)
        if self.pass_epoch:
            if not isinstance(epoch, torch.Tensor):
                epoch = self.epoch_tensor(epoch)
            args += (epoch,)
        params = None if dt is None else {k: p.to(dt)
                                          for k, p in self.model.named_parameters()}
        if self.pipeline:
            from stgx_torch.parallel.pipeline import mstcn_apply_pipelined

            # dropout is 0 (checked at construction): the train forward is this one
            out = mstcn_apply_pipelined(self.model, args[0], self.mesh, params=params)
        elif dt is None:
            out = self.model(*args, **kwargs)
        else:
            out = functional_call(self.model, params, args, kwargs)
        aux = 0.0
        if isinstance(out, tuple):
            out, aux = out
        if self.kind == "window":  # window_ms models emit (S, 1, B, C) themselves
            out = out[None]
        return out.float(), aux

    def _series(self, y, mask):
        """Labels and mask as the loss sees them: a window chunk's ``(B,)``
        become the ``(1, B)`` series of its outputs."""
        if self.kind.startswith("window"):
            return y[None], None if mask is None else mask[None]
        return y, mask

    def grad_step(self, x, y, mask, divisors, generator=None, epoch=None):
        """Forward, loss and backward of ``N`` stacked trials (or one chunk
        of windows), adding each trial's ``(ce + mse) / divisor`` gradient
        into ``.grad`` (``(ce + mse + aux) / divisor`` for a model with an
        auxiliary loss).

        ``divisors`` is one float for a single trial or chunk (the loss over
        its frames) or one per stacked trial (per-trial losses; an auxiliary
        loss is then left out, as the JAX package leaves it). ``epoch``
        reaches a ``pass_epoch`` model (∞ if None). Returns ``(ce, mse,
        top1_correct, top5_correct, total)``, ce and mse summed over the
        stack. Under a mesh ``x``, ``y`` and ``mask`` are the whole batch;
        each rank runs its block (:meth:`layout`) and the returned numbers
        are the whole batch's.
        """
        shards = self.layout(x)
        if shards is not None:
            x, y, mask = self._local(shards, x, y, mask)
            if not isinstance(divisors, (int, float)):
                divisors = [float(d) for d in shards.n.part(torch.tensor(divisors), 0)]
        lshards = self._loss_layout(shards)
        loss_kw = {} if shards is None else {"shards": lshards}
        # each of r replicas of the logits carries 1/r of their loss, so that
        # the gradients summed over every part count it once (an auxiliary
        # loss is each part's own share already)
        replicas = self._replicas(shards)
        with use_shards(shards):
            out, aux = self._outputs(x, mask, True, generator, epoch)
            y, mask = self._series(y, mask)
            if isinstance(divisors, (int, float)):
                ce, mse = self.loss(out, y, mask, **loss_kw)
                scaled = ((ce + mse) / replicas + aux) / divisors
            else:
                div = torch.tensor(divisors, dtype=torch.float32, device=out.device)
                ce_v, mse_v = self.loss(out, y, mask, per_sample=True, **loss_kw)
                scaled = ((ce_v + mse_v) / div).sum() / replicas
                ce, mse = ce_v.sum(), mse_v.sum()
            self._backward(scaled, shards)
        _, _, c1, c5, tot = self.statistics(out.detach(), y, mask)
        if shards is not None:
            return tuple(self._sum(lshards, ce, mse, c1, c5, tot))
        return ce.detach(), mse.detach(), c1, c5, tot

    def _step(self):
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)

    def stack_trials(self, xs, ys, masks):
        """Bucket-padded numpy trials (``pad_to_bucket``'s three outputs,
        one sequence each) stacked into ``(x, y, mask)`` on the device."""
        return (torch.as_tensor(np.stack(xs), dtype=torch.float32).to(self.device),
                torch.as_tensor(np.stack(ys), dtype=torch.int64).to(self.device),
                torch.as_tensor(np.stack(masks)).to(self.device))

    # -- trial preparation -----------------------------------------------------

    def prepare(self, x, y):
        """One trial bucket-padded and laid out for the model kind, on the
        device: ``(1, L, V, C)``, ``(1, L)``, ``(1, L)`` for the frame kinds;
        its windows ``(L, W, V, C)``, labels ``(L,)`` and mask ``(L,)`` for
        the window kinds."""
        xb, yb, mb = self.stack_trials(*([a] for a in pad_to_bucket(x, y, self.bucket)))
        if self.kind in _FRAME_KINDS:
            return xb, yb, mb
        return sliding_windows(xb, self.receptive_field)[0], yb[0], mb[0]

    def chunks(self, x, y, mask):
        """A prepared trial split into ``segment``-sized chunks of windows
        (window kinds with ``segment`` set), else the trial whole.

        A chunk that holds no frame of the trial, only bucket padding, is
        left out. The JAX ``Trainer`` keeps it, and its masked loss is then
        0/0: the whole epoch turns NaN (ROADMAP.md §3). Where no chunk is
        all padding (``segment`` divides ``bucket``, and the bucket ends
        less than a segment past the trial), the two agree exactly."""
        seg = self.segment
        if seg is None or not self.kind.startswith("window") or x.shape[0] <= seg:
            return [(x, y, mask)]
        frames = max(1, int(mask.sum().item()))  # padding only follows them
        return [(x[i: i + seg], y[i: i + seg], mask[i: i + seg])
                for i in range(0, frames, seg)]

    # -- epochs ----------------------------------------------------------------

    def train_epoch(self, dataset, epoch: int, generator=None,
                    log: Callable[[str], None] | None = None) -> dict:
        """One epoch in dataset order with trial-level gradient accumulation;
        returns ``{ce, mse, top1, top5, duration}``."""
        self.set_lr(epoch)
        if generator is None:
            generator = self.epoch_generator(epoch)
        epoch_t = self.epoch_tensor(epoch) if self.pass_epoch else None
        self.optimizer.zero_grad(set_to_none=True)
        if self.trial_batch > 1 and self.kind in _FRAME_KINDS:
            return self._batched_epoch(dataset, generator, log, epoch_t)
        n = len(dataset)
        bs = self.opt.batch_size
        ragged = n % bs
        ce_sum = mse_sum = 0.0
        c1 = c5 = tot = 0
        t0 = time.time()
        for i in range(n):
            x, y = dataset[i]
            divisor = float(bs if (ragged == 0 or i < n - ragged) else ragged)
            chunks = self.chunks(*self.prepare(x, y))
            trial_ce = trial_mse = 0.0
            for cx, cy, cm in chunks:
                # the reference's ce / num_subsegments (processor.py:392,532-543)
                ce, mse, ic1, ic5, itot = self.grad_step(
                    cx, cy, cm, divisor * len(chunks), generator, epoch_t)
                trial_ce += float(ce) / len(chunks)
                trial_mse += float(mse) / len(chunks)
                c1, c5, tot = c1 + int(ic1), c5 + int(ic5), tot + int(itot)
            ce_sum += trial_ce
            mse_sum += trial_mse
            if log:
                log(f"[trial {i}]: loss = {trial_ce + trial_mse:.4f}")
            if (i + 1) % bs == 0 or (i + 1) == n:
                self._step()
        return {"ce": ce_sum, "mse": mse_sum, "top1": c1 / max(tot, 1),
                "top5": c5 / max(tot, 1), "duration": self.slowest(time.time() - t0)}

    def _batched_epoch(self, dataset, generator, log, epoch_t=None):
        """Epoch with consecutive same-bucket trials stacked per forward."""
        n = len(dataset)
        bs = self.opt.batch_size
        ragged = n % bs
        ce_sum = mse_sum = 0.0
        c1 = c5 = tot = 0
        t0 = time.time()
        i = 0
        since_step = 0
        while i < n:
            # stack consecutive same-bucket, same-divisor-region trials,
            # never across an optimizer-step boundary
            group = []
            while i < n and len(group) < self.trial_batch and since_step + len(group) < bs:
                x, y = dataset[i]
                xp, yp, mask = pad_to_bucket(x, y, self.bucket)
                if group and xp.shape[0] != group[0][0].shape[0]:
                    break
                in_ragged = ragged != 0 and i >= n - ragged
                if group and group[0][3] != in_ragged:
                    break
                group.append((xp, yp, mask, in_ragged))
                i += 1
            xb, yb, mb = self.stack_trials(*zip(*(g[:3] for g in group)))
            divisors = [float(ragged if g[3] else bs) for g in group]
            ce, mse, ic1, ic5, itot = self.grad_step(xb, yb, mb, divisors, generator, epoch_t)
            ce_sum += float(ce)
            mse_sum += float(mse)
            c1, c5, tot = c1 + int(ic1), c5 + int(ic5), tot + int(itot)
            since_step += len(group)
            if log:
                log(f"[trials ..{i - 1}]: ce = {float(ce):.4f}")
            if since_step >= bs or i == n:
                self._step()
                since_step = 0
        return {"ce": ce_sum, "mse": mse_sum, "top1": c1 / max(tot, 1),
                "top5": c5 / max(tot, 1), "duration": self.slowest(time.time() - t0)}

    def _eval_forward(self, x, y, mask, per_sample: bool = False):
        """An eval forward of the whole batch ``(x, y, mask)``: ``(ce, mse,
        top1, c1, c5, tot)``, ce and mse per trial with ``per_sample``; under
        a mesh each rank runs its block and every number and the per-frame
        top-1 are the whole batch's."""
        shards = self.layout(x)
        if shards is not None:
            x, y, mask = self._local(shards, x, y, mask)
        lshards = self._loss_layout(shards)
        with use_shards(shards):
            out, _ = self._outputs(x, mask, False)
            ly, lm = self._series(y, mask)
            kw = {} if shards is None else {"shards": lshards}
            ce, mse = self.loss(out, ly, lm, per_sample=per_sample, **kw)
        top1, _, c1, c5, tot = self.statistics(out, ly, lm)
        if shards is None:
            return ce, mse, top1, c1, c5, tot
        top1 = gather_blocks(top1, lshards)
        if per_sample:  # every trial's shares, summed over its frames' ranks
            ce, mse = (gather_blocks(v[:, None], shards).sum(dim=1) for v in (ce, mse))
            return (ce, mse, top1, *self._sum(shards, c1, c5, tot))
        ce, mse, c1, c5, tot = self._sum(lshards, ce, mse, c1, c5, tot)
        return ce, mse, top1, c1, c5, tot

    @torch.no_grad()
    def predict(self, x, y) -> np.ndarray:
        """Per-frame top-1 of one trial ``(L, V, C)`` with labels ``(L,)``:
        one eval forward over the whole bucket-padded trial (a window-kind
        trial's windows all at once, unchunked, as the JAX CLI's
        segmentation dump runs them), cut to the trial's length. Under a
        mesh every rank must call it (the forward is split over them)."""
        top1 = self._eval_forward(*self.prepare(x, y))[2]
        return top1.reshape(-1)[: len(y)].cpu().numpy()

    @torch.no_grad()
    def evaluate(self, dataset, metrics=(), num_samples=None,
                 log: Callable[[str], None] | None = None) -> dict:
        """Whole-dataset eval: losses, top-1/top-5 and the duck-typed
        segmental ``metrics`` (``init_metric(n)``, ``m(labels, pred)``,
        ``reduce()``) per trial. A window-kind trial's per-frame top-1 is
        its chunks' joined and cut to the trial's length."""
        n_visit = len(dataset) if num_samples is None else min(len(dataset), num_samples)
        for m in metrics:
            m.init_metric(n_visit)
        if self.trial_batch > 1 and self.kind in _FRAME_KINDS:
            return self._evaluate_batched(dataset, metrics, n_visit, log)
        feeds = self._feeds(n_visit)
        c1 = c5 = tot = 0
        ce_sum = mse_sum = 0.0
        t0 = time.time()
        for i in range(n_visit):
            x, y = dataset[i]
            chunks = self.chunks(*self.prepare(x, y))
            top1_parts = []
            trial_ce = trial_mse = 0.0
            for cx, cy, cm in chunks:
                ce, mse, top1, ic1, ic5, itot = self._eval_forward(cx, cy, cm)
                trial_ce += float(ce) / len(chunks)
                trial_mse += float(mse) / len(chunks)
                c1, c5, tot = c1 + int(ic1), c5 + int(ic5), tot + int(itot)
                top1_parts.append(top1.reshape(-1))
            ce_sum += trial_ce
            mse_sum += trial_mse
            if i in feeds:
                valid = torch.cat(top1_parts)[: len(y)].cpu().numpy()
                for m in metrics:
                    m(np.asarray(y), valid)
            if log:
                log(f"[trial {i}]: loss = {trial_ce + trial_mse:.4f}")
        for m in metrics:
            m.reduce()
        return {"top1": c1 / max(tot, 1), "top5": c5 / max(tot, 1),
                "ce": ce_sum, "mse": mse_sum, "duration": self.slowest(time.time() - t0)}

    def _evaluate_batched(self, dataset, metrics, n_visit, log):
        """Frame-kinds eval with same-bucket trials stacked per forward."""
        feeds = self._feeds(n_visit)
        c1 = c5 = tot = 0
        ce_sum = mse_sum = 0.0
        t0 = time.time()
        i = 0
        while i < n_visit:
            group, labels = [], []
            while i < n_visit and len(group) < self.trial_batch:
                x, y = dataset[i]
                xp, yp, mask = pad_to_bucket(x, y, self.bucket)
                if group and xp.shape[0] != group[0][0].shape[0]:
                    break
                group.append((xp, yp, mask))
                labels.append(y)
                i += 1
            xb, yb, mb = self.stack_trials(*zip(*group))
            ce_v, mse_v, top1, ic1, ic5, itot = self._eval_forward(xb, yb, mb, per_sample=True)
            ce_v, mse_v, top1 = ce_v.cpu().numpy(), mse_v.cpu().numpy(), top1.cpu().numpy()
            c1, c5, tot = c1 + int(ic1), c5 + int(ic5), tot + int(itot)
            ce_sum += float(ce_v.sum())
            mse_sum += float(mse_v.sum())
            for j, y in enumerate(labels):
                if i - len(labels) + j in feeds:
                    for m in metrics:
                        m(np.asarray(y), top1[j][: len(y)])
                if log:
                    log(f"[trial {i - len(labels) + j}]: "
                        f"loss = {float(ce_v[j] + mse_v[j]):.4f}")
        for m in metrics:
            m.reduce()
        return {"top1": c1 / max(tot, 1), "top5": c5 / max(tot, 1),
                "ce": ce_sum, "mse": mse_sum, "duration": self.slowest(time.time() - t0)}
