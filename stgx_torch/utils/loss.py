"""Segmentation loss: class-weighted CE + truncated temporal-smoothing MSE —
the port of ``stgx/utils/loss.py``.

* CE with class weights ``w_c = 1 − dist_c / Σdist`` and the weighted-mean
  reduction ``Σ w_{y_t}·nll_t / Σ w_{y_t}``;
* plus ``0.15 · mean(clamp((p_t − p_{t−1}.detach())², 0, 16))`` on the
  adapter-transformed outputs;
* input adapters per model ``output_type`` (``logits`` models get the MSE on
  log-probabilities, ``logsoftmax`` ones on probabilities, ``softmax`` ones
  on the outputs themselves);
* an optional ``(N, L)`` frame mask for bucketed, padded trials, and
  ``per_sample`` results for trials stacked on the batch axis;
* multi-stage variants sum over stages.

Everything takes ``(N, L, C)`` outputs as tensors on any device.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Loss", "LossMultiStage", "class_weights", "weighted_cross_entropy",
           "smoothing_mse"]


def class_weights(class_dist, device=None):
    """``w_c = 1 − dist_c / Σdist`` as an fp32 tensor."""
    d = torch.as_tensor(np.asarray(class_dist, dtype=np.float32), device=device)
    return 1.0 - d / d.sum()


def weighted_cross_entropy(logits, labels, weights, mask=None,
                           per_sample: bool = False):
    """Weighted-mean CE over frames.

    Args:
        logits: ``(N, L, C)``.
        labels: ``(N, L)`` int.
        weights: ``(C,)`` class weights.
        mask: optional ``(N, L)`` validity.
        per_sample: return the ``(N,)`` per-trial weighted means.
    """
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    w = weights.to(logits.device)[labels.long()]
    if mask is not None:
        w = w * mask.to(w.dtype)
    if per_sample:
        return (w * nll).sum(dim=-1) / w.sum(dim=-1)
    return (w * nll).sum() / w.sum()


def smoothing_mse(outputs, mask=None, per_sample: bool = False):
    """``0.15 · mean(clamp((p_t − p_{t−1}.detach())², 0, 16))`` over frames
    ``1..L−1``; ``outputs`` already in the adapter's domain."""
    d = outputs[:, 1:] - outputs[:, :-1].detach()
    sq = torch.clamp(d * d, 0.0, 16.0)
    if mask is not None:
        m = (mask[:, 1:] * mask[:, :-1]).to(sq.dtype)[..., None]
    if per_sample:
        if mask is None:
            return 0.15 * sq.mean(dim=(1, 2))
        return 0.15 * (sq * m).sum(dim=(1, 2)) / (m.sum(dim=(1, 2)) * sq.shape[-1])
    if mask is None:
        return 0.15 * sq.mean()
    return 0.15 * (sq * m).sum() / (m.sum() * sq.shape[-1])


class Loss:
    """Callable bundling the CE+MSE pair over ``(N, L, C)`` outputs; returns
    ``(ce, mse)``."""

    def __init__(self, class_dist, output_type: str = "logits"):
        self.weights = class_weights(class_dist)
        if output_type == "logits":
            self.to_ce = lambda x: x
            self.to_mse = lambda x: torch.log_softmax(x, dim=-1)
        elif output_type == "logsoftmax":
            self.to_ce = lambda x: x
            self.to_mse = torch.exp
        elif output_type == "softmax":
            self.to_ce = torch.log
            self.to_mse = lambda x: x
        else:
            raise ValueError(f"unknown output_type: {output_type!r}")

    def __call__(self, outputs, labels, mask=None, per_sample: bool = False):
        if self.weights.device != outputs.device:
            self.weights = self.weights.to(outputs.device)
        ce = weighted_cross_entropy(self.to_ce(outputs), labels, self.weights,
                                    mask, per_sample)
        mse = smoothing_mse(self.to_mse(outputs), mask, per_sample)
        return ce, mse


class LossMultiStage(Loss):
    """Sums CE and MSE over the leading stage axis ``(S, N, L, C)``."""

    def __call__(self, outputs, labels, mask=None, per_sample: bool = False):
        ce_tot, mse_tot = 0.0, 0.0
        for s in range(outputs.shape[0]):
            ce, mse = super().__call__(outputs[s], labels, mask, per_sample)
            ce_tot = ce_tot + ce
            mse_tot = mse_tot + mse
        return ce_tot, mse_tot
