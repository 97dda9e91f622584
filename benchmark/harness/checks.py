"""The numbers that decide ``correct``, each a gap between what the timed
path produced and what the reference works out for the same inputs.

* :func:`relative_gap`: ``|a − b| / |b|``.
* :func:`leaf_norm_gap`: over the leaves of two parameter trees, the worst
  gap between their norms, each measured against the reference's norm of
  that leaf or of the median leaf, whichever is larger (some gradients are
  all but zero).
* :func:`logit_gap`: served logits against the reference's, the largest
  difference over the reference's spread.
* :func:`label_gap`: per-frame labels against the reference's logits, the
  widest gap by which a label's logit lies below the reference's best, over
  the spread of the reference's logits.
"""

from __future__ import annotations

import statistics

import torch

__all__ = ["relative_gap", "leaf_norms", "leaf_norm_gap", "quiet_leaves", "logit_gap",
           "label_gap"]


def relative_gap(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def leaf_norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def quiet_leaves(grads: dict, share: float = 1e-3) -> set:
    """Leaves whose reference gradient is under ``share`` of the median
    leaf's: nought to rounding, so Adam moves them by round-off alone."""
    norms = leaf_norms(grads)
    floor = share * statistics.median(norms.values())
    return {k for k, n in norms.items() if n < floor}


def leaf_norm_gap(program: dict, reference: dict, leave_out=()) -> tuple[float, str]:
    """``(gap, leaf)``: the worst leaf's ``|‖p‖ − ‖r‖| / max(‖r‖, median ‖r‖)``."""
    ref = {k: n for k, n in leaf_norms(reference).items() if k not in leave_out}
    prog = leaf_norms({k: program[k] for k in ref})
    median = statistics.median(ref.values())
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], median) for k in ref}
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def logit_gap(program, reference) -> float:
    """``max |p − r| / std(r)`` over logits of one shape."""
    r = reference.double()
    return float((program.double() - r).abs().max() / r.std())


def label_gap(labels, reference) -> float:
    """``max_t (max_c r[t, c] − r[t, label_t]) / std(r)`` for labels ``(L,)``
    and reference logits ``(L, classes)``."""
    r = reference.double()
    lab = torch.as_tensor(labels, device=r.device, dtype=torch.int64)
    best = r.max(dim=-1).values
    return float((best - r.gather(-1, lab[:, None])[:, 0]).max() / r.std())
