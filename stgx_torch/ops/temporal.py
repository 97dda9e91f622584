"""The RT-ST-GCN causal accumulator, batch and streaming — the port of
``stgx/ops/temporal.py`` (its RT parts).

``y[t] = Σ_{i<K} x[t − i·s]`` with ``K = Γ // s`` taps spaced ``s`` frames
apart; frames before the start are zero (the empty FIFO). Time is never
downsampled: ``s`` only widens the tap spacing.

* Batch form: :func:`causal_accumulate`, the window-sum kernel for a CUDA
  tensor (:mod:`stgx_torch.ops.window_sum`), its plain version for a CPU
  one.
* Streaming form: :func:`causal_accumulate_step`, an O(1)-per-frame shift
  FIFO of the last ``(K−1)·s + 1`` frames, in plain tensor ops (the JAX
  package ran it without a Pallas kernel too).
"""

from __future__ import annotations

import torch

from stgx_torch import default_device
from stgx_torch.ops.window_sum import window_sum

__all__ = [
    "causal_accumulate",
    "init_accumulator_state",
    "causal_accumulate_step",
    "ACC_STEP_IMPLS",
]

ACC_STEP_IMPLS = ("auto", "taps", "fifo_sum")


def causal_accumulate(x, kernel_size: int, stride: int):
    """Batch form of the RT-ST-GCN FIFO over ``(N, L, V, C)``; same length out."""
    return window_sum(x, kernel_size, stride)


def init_accumulator_state(batch, num_joints, channels, kernel_size, stride,
                           dtype=torch.float32, device=None):
    """Zero carry for the streaming accumulator: a shift FIFO of the last
    ``(K−1)·s + 1`` frames, newest at slot ``depth − 1``."""
    k = kernel_size // stride
    depth = (k - 1) * stride + 1
    return {
        "fifo": torch.zeros((depth, batch, num_joints, channels), dtype=dtype,
                            device=default_device(device)),
    }


def causal_accumulate_step(state, x_t, kernel_size: int, stride: int,
                           impl: str = "auto"):
    """One streaming step of the accumulator.

    Args:
        state: carry from :func:`init_accumulator_state`.
        x_t: ``(B, V, C)`` the current frame.
        impl: ``"taps"`` sums the K−1 static FIFO slots; ``"fifo_sum"`` is
            one reduction over the whole FIFO (non-tap slots masked when
            s > 1); ``"auto"`` picks ``fifo_sum`` iff K ≥ 16 and B ≥ 8, the
            JAX package's rule (``stgx/ops/temporal.py:338-343``).

    Returns ``(y_t, new_state)``, ``y_t`` equal to frame t of
    :func:`causal_accumulate` up to the order of the fp adds.
    """
    if impl not in ACC_STEP_IMPLS:
        raise ValueError(f"unknown acc step impl: {impl!r}")
    k = kernel_size // stride
    if k == 1:
        return x_t, state
    if impl == "auto":
        impl = "fifo_sum" if (k >= 16 and x_t.shape[0] >= 8) else "taps"
    fifo = torch.cat([state["fifo"][1:], x_t[None]], dim=0)
    depth = fifo.shape[0]
    if impl == "fifo_sum":
        if stride == 1:
            y_t = fifo.sum(dim=0)
        else:
            tap_mask = torch.tensor(
                [(depth - 1 - s) % stride == 0 for s in range(depth)],
                dtype=fifo.dtype, device=fifo.device,
            )
            y_t = (fifo * tap_mask[:, None, None, None]).sum(dim=0)
        return y_t, {"fifo": fifo}
    # frame (t − i·s) sits at static slot depth − 1 − i·s
    taps = [fifo[depth - 1 - i * stride] for i in range(1, k)]
    y_t = x_t + torch.stack(taps).sum(dim=0)
    return y_t, {"fifo": fifo}
