"""Faults planted in the program's timed path, to show that the checks
catch them: in the CPU tests (``tests/test_bench_harness.py``) and on the
card at a cell's own size (``readings.py --fault``), where they give the
training cells' numbers their upper readings.

* ``state_unchanged``: the optimizer's step returns the state unchanged.
* ``half_batch``: every other trial left out of the step, the rest weighing
  double (the mean over the rest).
* ``stream_half_batch``: the streaming cell steps the first half of the
  streams and serves their logits twice.
* ``stream_logit_altered``: one stream's logit altered where it is produced.
* ``label_altered``: one frame's label altered where ``predict`` makes it.
"""

from __future__ import annotations

import importlib

import torch

__all__ = ["FAULTS", "plant"]


def _state_unchanged(orig):
    def step(self):
        self.optimizer.zero_grad(set_to_none=True)

    return step


def _half_batch(orig):
    seen = []

    def grad_step(self, x, y, mask, divisors, *args, **kwargs):
        seen.append(1)
        if len(seen) % 2 == 0:
            zero = torch.zeros((), device=x.device)
            return zero, zero, 0, 0, 0
        return orig(self, x, y, mask, divisors / 2, *args, **kwargs)

    return grad_step


def _stream_half_batch(orig):
    def step(model, state, x_t):
        h = x_t.shape[0] // 2
        logits, new = orig(model, [{k: v[:, :h] for k, v in s.items()} for s in state], x_t[:h])
        state = [{k: torch.cat([n[k], s[k][:, h:]], dim=1) for k in s}
                 for n, s in zip(new, state)]
        return torch.cat([logits, logits]), state

    return step


def _stream_logit_altered(orig):
    def step(model, state, x_t):
        logits, state = orig(model, state, x_t)
        logits = logits.clone()
        logits[0, 0] += 1.0
        return logits, state

    return step


def _label_altered(orig):
    def predict(self, x, y):
        labels = orig(self, x, y).copy()
        labels[len(labels) // 2] = (labels[len(labels) // 2] + 1) % self.model.fcn_out.bias.numel()
        return labels

    return predict


_LOOP, _RT = "stgx_torch.parallel.loop", "stgx_torch.models.rtstgcn"
# name: (module, class or None, attribute, the broken version of it)
FAULTS = {
    "state_unchanged": (_LOOP, "Trainer", "_step", _state_unchanged),
    "half_batch": (_LOOP, "Trainer", "grad_step", _half_batch),
    "stream_half_batch": (_RT, None, "stream_step", _stream_half_batch),
    "stream_logit_altered": (_RT, None, "stream_step", _stream_logit_altered),
    "label_altered": (_LOOP, "Trainer", "predict", _label_altered),
}


def plant(name: str, setattr_=setattr):
    """Plant fault ``name`` in the program (through ``setattr_``, a test's
    ``monkeypatch.setattr`` where given)."""
    module, cls, attr, broken = FAULTS[name]
    owner = importlib.import_module(module)
    if cls is not None:
        owner = getattr(owner, cls)
    setattr_(owner, attr, broken(getattr(owner, attr)))
