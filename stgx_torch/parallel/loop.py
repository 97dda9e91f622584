"""Training and evaluation on one device — the port of
``stgx/parallel/loop.py`` for the ``frame`` kind (RT-ST-GCN).

* **Unequal-length trials** are padded to static length buckets with frame
  masks (:func:`stgx_torch.parallel.segments.pad_to_bucket`).
* **Gradient accumulation** keeps the JAX ``Trainer``'s exact divisors:
  every trial's loss is divided by ``batch_size``, except the ragged final
  group's, divided by ``len(dataset) % batch_size``; gradients add up in
  the parameters' ``.grad`` and Adam steps every ``batch_size`` trials and
  after the last one.
* **trial_batch** stacks up to that many consecutive same-bucket trials into
  one forward, each with its own loss normalisation and divisor, never
  across an optimizer step or the ragged boundary. BatchNorm statistics
  then span the stack, as in the JAX package.
* **Learning rate** decays as ``lr · decay^epoch`` (:meth:`Trainer.set_lr`).
* **Adam** is ``torch.optim.Adam`` with betas (0.9, 0.999) and eps 1e-8, the
  same update as optax's ``adam``.
* **compute_dtype="bfloat16"** runs forward and backward in bf16: the
  parameters stay fp32 in the optimizer and are cast at the step boundary
  (``torch.func.functional_call``), so their gradients come back fp32
  through the cast; norm statistics and the loss stay fp32.
* **Dropout** draws its masks from a ``torch.Generator`` on the model's
  device, seeded ``opt.seed + 1000 + epoch`` unless the caller passes one.

Not ported yet: meshes and their parallel modes, the MS-TCN pipeline, the
window kinds and their chunks, loading Adam moments from a checkpoint, and
rematerialisation (see ROADMAP.md).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
from torch.func import functional_call

from stgx_torch.parallel.segments import pad_to_bucket
from stgx_torch.utils.statistics import Statistics

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
    kind: str  # only 'frame' is ported
    loss: Any
    opt: OptimizerConfig
    bucket: int = 128  # length-bucket granularity
    trial_batch: int = 1  # trials stacked into one forward
    compute_dtype: str | None = None  # None / 'float32' or 'bfloat16'
    statistics: Any = None  # top-1/top-5 strategy; Statistics() if unset

    def __post_init__(self):
        if self.kind != "frame":
            raise NotImplementedError(
                f"Trainer kind {self.kind!r} is not ported to stgx_torch yet; "
                "see ROADMAP.md"
            )
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"unknown compute_dtype: {self.compute_dtype!r}")
        if self.statistics is None:
            self.statistics = Statistics()
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

    def epoch_generator(self, epoch: int) -> torch.Generator:
        """The dropout generator of ``epoch``: seeded ``seed + 1000 + epoch``."""
        return torch.Generator(device=self.device).manual_seed(
            self.opt.seed + 1000 + epoch)

    # -- steps -----------------------------------------------------------------

    def _outputs(self, x, mask, train: bool, generator=None):
        """Per-frame outputs ``(N, L, C)`` in fp32."""
        dt = COMPUTE_DTYPES[self.compute_dtype]
        kwargs = {"mask": mask, "train": train, "generator": generator}
        if dt is None:
            out = self.model(x, **kwargs)
        else:
            params = {k: p.to(dt) for k, p in self.model.named_parameters()}
            out = functional_call(self.model, params, (x.to(dt),), kwargs)
        return out.float()

    def grad_step(self, x, y, mask, divisors, generator=None):
        """Forward, loss and backward of ``N`` stacked trials, adding each
        trial's ``(ce + mse) / divisor`` gradient into ``.grad``.

        ``divisors`` is one float for a single trial (the loss over its
        frames) or one per stacked trial (per-trial losses). Returns
        ``(ce, mse, top1_correct, top5_correct, total)``, ce and mse summed
        over the stack, as tensors.
        """
        out = self._outputs(x, mask, True, generator)
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

    # -- epochs ----------------------------------------------------------------

    def train_epoch(self, dataset, epoch: int, generator=None,
                    log: Callable[[str], None] | None = None) -> dict:
        """One epoch in dataset order with trial-level gradient accumulation;
        returns ``{ce, mse, top1, top5, duration}``."""
        self.set_lr(epoch)
        if generator is None:
            generator = self.epoch_generator(epoch)
        self.optimizer.zero_grad(set_to_none=True)
        if self.trial_batch > 1:
            return self._batched_epoch(dataset, generator, log)
        n = len(dataset)
        bs = self.opt.batch_size
        ragged = n % bs
        ce_sum = mse_sum = 0.0
        c1 = c5 = tot = 0
        t0 = time.time()
        for i in range(n):
            x, y = dataset[i]
            xb, yb, mb = self.stack_trials(*([a] for a in pad_to_bucket(x, y, self.bucket)))
            divisor = float(bs if (ragged == 0 or i < n - ragged) else ragged)
            ce, mse, ic1, ic5, itot = self.grad_step(xb, yb, mb, divisor, generator)
            ce_sum += float(ce)
            mse_sum += float(mse)
            c1, c5, tot = c1 + int(ic1), c5 + int(ic5), tot + int(itot)
            if log:
                log(f"[trial {i}]: loss = {float(ce) + float(mse):.4f}")
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
    def evaluate(self, dataset, metrics=(), num_samples=None,
                 log: Callable[[str], None] | None = None) -> dict:
        """Whole-dataset eval: losses, top-1/top-5 and the duck-typed
        segmental ``metrics`` (``init_metric(n)``, ``m(labels, pred)``,
        ``reduce()``) per trial."""
        n_visit = len(dataset) if num_samples is None else min(len(dataset), num_samples)
        for m in metrics:
            m.init_metric(n_visit)
        c1 = c5 = tot = 0
        ce_sum = mse_sum = 0.0
        t0 = time.time()
        step = max(1, self.trial_batch)
        i = 0
        while i < n_visit:
            group, labels = [], []
            while i < n_visit and len(group) < step:
                x, y = dataset[i]
                xp, yp, mask = pad_to_bucket(x, y, self.bucket)
                if group and xp.shape[0] != group[0][0].shape[0]:
                    break
                group.append((xp, yp, mask))
                labels.append(y)
                i += 1
            xb, yb, mb = self.stack_trials(*zip(*group))
            out = self._outputs(xb, mb, False)
            if self.trial_batch > 1:
                ce_v, mse_v = self.loss(out, yb, mb, per_sample=True)
            else:
                ce_v, mse_v = (t[None] for t in self.loss(out, yb, mb))
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
