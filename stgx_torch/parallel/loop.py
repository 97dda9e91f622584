"""Training and evaluation on one device — the port of
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

Not ported yet: meshes and their parallel modes, the pipelined MS-TCN,
``pass_epoch`` and auxiliary losses (Shift-GCN++) (see ROADMAP.md).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
from torch.func import functional_call

from stgx_torch.parallel.segments import pad_to_bucket, sliding_windows
from stgx_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from stgx_torch.utils.statistics import Statistics, StatisticsMultiStage

__all__ = ["Trainer", "OptimizerConfig", "MODEL_KIND"]

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

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown Trainer kind {self.kind!r} (have {KINDS})")
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"unknown compute_dtype: {self.compute_dtype!r}")
        if self.statistics is None:
            self.statistics = (StatisticsMultiStage() if self.kind.endswith("_ms")
                               else Statistics())
        self.device = next(self.model.parameters()).device
        self.optimizer = torch.optim.Adam(
            self.model.parameters(), lr=self.opt.learning_rate,
            betas=(0.9, 0.999), eps=1e-8,
        )

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

    # -- steps -----------------------------------------------------------------

    def _outputs(self, x, mask, train: bool, generator=None):
        """Per-frame outputs in fp32: ``(N, L, C)`` of N stacked trials, or
        ``(1, B, C)`` of a chunk of B windows ``(B, W, V, C)`` with the
        ``(B,)`` mask, each window masked as a whole; a leading stage axis
        for the ``_ms`` kinds."""
        dt = COMPUTE_DTYPES[self.compute_dtype]
        if self.kind.startswith("window") and mask is not None:
            mask = mask[:, None].expand(x.shape[0], x.shape[1])
        kwargs = {"mask": mask, "train": train, "generator": generator}
        if dt is None:
            out = self.model(x, **kwargs)
        else:
            params = {k: p.to(dt) for k, p in self.model.named_parameters()}
            out = functional_call(self.model, params, (x.to(dt),), kwargs)
        if self.kind == "window":  # window_ms models emit (S, 1, B, C) themselves
            out = out[None]
        return out.float()

    def _series(self, y, mask):
        """Labels and mask as the loss sees them: a window chunk's ``(B,)``
        become the ``(1, B)`` series of its outputs."""
        if self.kind.startswith("window"):
            return y[None], None if mask is None else mask[None]
        return y, mask

    def grad_step(self, x, y, mask, divisors, generator=None):
        """Forward, loss and backward of ``N`` stacked trials (or one chunk
        of windows), adding each trial's ``(ce + mse) / divisor`` gradient
        into ``.grad``.

        ``divisors`` is one float for a single trial or chunk (the loss over
        its frames) or one per stacked trial (per-trial losses). Returns
        ``(ce, mse, top1_correct, top5_correct, total)``, ce and mse summed
        over the stack, as tensors.
        """
        out = self._outputs(x, mask, True, generator)
        y, mask = self._series(y, mask)
        if isinstance(divisors, (int, float)):
            ce, mse = self.loss(out, y, mask)
            scaled = (ce + mse) / divisors
        else:
            div = torch.tensor(divisors, dtype=torch.float32, device=out.device)
            ce_v, mse_v = self.loss(out, y, mask, per_sample=True)
            scaled = ((ce_v + mse_v) / div).sum()
            ce, mse = ce_v.sum(), mse_v.sum()
        scaled.backward()
        _, _, c1, c5, tot = self.statistics(out.detach(), y, mask)
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
        self.optimizer.zero_grad(set_to_none=True)
        if self.trial_batch > 1 and self.kind in _FRAME_KINDS:
            return self._batched_epoch(dataset, generator, log)
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
                    cx, cy, cm, divisor * len(chunks), generator)
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
                "top5": c5 / max(tot, 1), "duration": time.time() - t0}

    def _batched_epoch(self, dataset, generator, log):
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
            ce, mse, ic1, ic5, itot = self.grad_step(xb, yb, mb, divisors, generator)
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
                "top5": c5 / max(tot, 1), "duration": time.time() - t0}

    @torch.no_grad()
    def predict(self, x, y) -> np.ndarray:
        """Per-frame top-1 of one trial ``(L, V, C)`` with labels ``(L,)``:
        one eval forward over the whole bucket-padded trial (a window-kind
        trial's windows all at once, unchunked, as the JAX CLI's
        segmentation dump runs them), cut to the trial's length."""
        xd, yd, md = self.prepare(x, y)
        out = self._outputs(xd, md, False)
        top1 = self.statistics(out, *self._series(yd, md))[0]
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
        c1 = c5 = tot = 0
        ce_sum = mse_sum = 0.0
        t0 = time.time()
        for i in range(n_visit):
            x, y = dataset[i]
            chunks = self.chunks(*self.prepare(x, y))
            top1_parts = []
            trial_ce = trial_mse = 0.0
            for cx, cy, cm in chunks:
                out = self._outputs(cx, cm, False)
                ly, lm = self._series(cy, cm)
                ce, mse = self.loss(out, ly, lm)
                top1, _, ic1, ic5, itot = self.statistics(out, ly, lm)
                trial_ce += float(ce) / len(chunks)
                trial_mse += float(mse) / len(chunks)
                c1, c5, tot = c1 + int(ic1), c5 + int(ic5), tot + int(itot)
                top1_parts.append(top1.reshape(-1))
            ce_sum += trial_ce
            mse_sum += trial_mse
            valid = torch.cat(top1_parts)[: len(y)].cpu().numpy()
            for m in metrics:
                m(np.asarray(y), valid)
            if log:
                log(f"[trial {i}]: loss = {trial_ce + trial_mse:.4f}")
        for m in metrics:
            m.reduce()
        return {"top1": c1 / max(tot, 1), "top5": c5 / max(tot, 1),
                "ce": ce_sum, "mse": mse_sum, "duration": time.time() - t0}

    def _evaluate_batched(self, dataset, metrics, n_visit, log):
        """Frame-kinds eval with same-bucket trials stacked per forward."""
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
            out = self._outputs(xb, mb, False)
            ce_v, mse_v = self.loss(out, yb, mb, per_sample=True)
            top1, _, ic1, ic5, itot = self.statistics(out, yb, mb)
            ce_v, mse_v, top1 = ce_v.cpu().numpy(), mse_v.cpu().numpy(), top1.cpu().numpy()
            c1, c5, tot = c1 + int(ic1), c5 + int(ic5), tot + int(itot)
            ce_sum += float(ce_v.sum())
            mse_sum += float(mse_v.sum())
            for j, y in enumerate(labels):
                for m in metrics:
                    m(np.asarray(y), top1[j][: len(y)])
                if log:
                    log(f"[trial {i - len(labels) + j}]: "
                        f"loss = {float(ce_v[j] + mse_v[j]):.4f}")
        for m in metrics:
            m.reduce()
        return {"top1": c1 / max(tot, 1), "top5": c5 / max(tot, 1),
                "ce": ce_sum, "mse": mse_sum, "duration": time.time() - t0}
