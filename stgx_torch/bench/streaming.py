"""Per-frame streaming latency of one capture — the port of
``stgx/bench/streaming.py:measure_stream_latency``.

The deployed realtime loop calls a one-frame cell once per arriving frame,
threading its state. RT-ST-GCN's cell is its FIFO streaming step
(:func:`stgx_torch.models.rtstgcn.stream_step`). A window classifier (the
JAX package's ``WINDOW_MODELS``; Shift-GCN in the port) streams by
re-running its window on each frame (:func:`window_step`): a ``(B, W, V,
C)`` buffer that starts as zeros (the empty buffer), is rolled by one
frame and gets the new frame last, then the model on the buffer with
``train=False`` and no mask.

Each step is timed with CUDA events from before its first launch to after
its last: the wait a frame sees from arrival to logits on the device,
launch overhead included. This is a device measurement: a model on the CPU
raises.
"""

from __future__ import annotations

import numpy as np
import torch

from stgx_torch.models.rtstgcn import RtStgcn, init_stream_state, stream_step

__all__ = ["measure_stream_latency", "timed_steps", "init_window_state",
           "window_step"]


def init_window_state(model, batch: int = 1, window: int = 50, dtype=None):
    """The empty buffer of the window cell: ``(B, W, V, C_in)`` zeros on the
    model's device, in ``dtype`` (float32 if None)."""
    device = next(model.parameters()).device
    return {"buf": torch.zeros((batch, window, model.num_joints, model.in_feat),
                               dtype=dtype or torch.float32, device=device)}


@torch.no_grad()
def window_step(model, state, x_t):
    """One frame ``(B, V, C)`` of B streams through the window cell: the
    buffer rolled by one frame with ``x_t`` last, then the model on it.
    Returns ``(logits (B, classes), new_state)``."""
    buf = torch.cat([state["buf"][:, 1:], x_t[:, None]], dim=1)
    return model(buf), {"buf": buf}


def timed_steps(model, state, frames, warmup: int = 20, step=stream_step):
    """Stream ``frames`` ``(L, B, V, C)`` through the cell ``step`` from
    ``state``, timing each step with CUDA events after ``warmup`` untimed
    steps on frame 0 (from a throwaway copy of the state).

    Returns ``(logits (B, L, classes), step_ms (L,))``.
    """
    if frames.device.type != "cuda":
        raise RuntimeError("step latency is a device measurement; frames are "
                           f"on {frames.device}")
    warm_state = state
    for _ in range(warmup):
        _, warm_state = step(model, warm_state, frames[0])
    del warm_state  # at large B a copy of the state is gigabytes
    torch.cuda.synchronize()
    l = frames.shape[0]
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(l)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(l)]
    outs = []
    for t in range(l):
        starts[t].record()
        logits, state = step(model, state, frames[t])
        ends[t].record()
        outs.append(logits)
    torch.cuda.synchronize()
    step_ms = np.asarray([s.elapsed_time(e) for s, e in zip(starts, ends)])
    return torch.stack(outs, dim=1), step_ms


def measure_stream_latency(model, frames, warmup: int = 20, window: int = 50):
    """Per-frame latency stats over one ``(L, V, C)`` capture at B = 1,
    through RT-ST-GCN's FIFO cell or, for a window model, the window cell
    of ``window`` frames.

    Returns ``(mean_ms, p50_ms, p99_ms, logits (L, classes))``.
    """
    frames = frames[:, None]  # (L, 1, V, C)
    if isinstance(model, RtStgcn):
        state, step = init_stream_state(model, batch=1, dtype=frames.dtype), stream_step
    else:
        state, step = init_window_state(model, 1, window, frames.dtype), window_step
    logits, step_ms = timed_steps(model, state, frames, warmup, step)
    return (
        float(step_ms.mean()),
        float(np.percentile(step_ms, 50)),
        float(np.percentile(step_ms, 99)),
        logits[0].float().cpu().numpy(),
    )
