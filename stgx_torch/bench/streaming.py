"""Per-frame streaming latency of one capture — the port of
``stgx/bench/streaming.py:measure_stream_latency``.

The deployed realtime loop calls the one-frame streaming cell once per
arriving frame, threading the FIFO carry. Each step is timed with CUDA
events from before its first launch to after its last: the wait a frame
sees from arrival to logits on the device, launch overhead included. This
is a device measurement: a model on the CPU raises.
"""

from __future__ import annotations

import numpy as np
import torch

from stgx_torch.models.rtstgcn import init_stream_state, stream_step

__all__ = ["measure_stream_latency", "timed_steps"]


def timed_steps(model, state, frames, warmup: int = 20):
    """Stream ``frames`` ``(L, B, V, C)`` through the cell from ``state``,
    timing each step with CUDA events after ``warmup`` untimed steps on
    frame 0 (from a throwaway copy of the state).

    Returns ``(logits (B, L, classes), step_ms (L,))``.
    """
    if frames.device.type != "cuda":
        raise RuntimeError("step latency is a device measurement; frames are "
                           f"on {frames.device}")
    warm_state = state
    for _ in range(warmup):
        _, warm_state = stream_step(model, warm_state, frames[0])
    del warm_state  # at large B a copy of the state is gigabytes
    torch.cuda.synchronize()
    l = frames.shape[0]
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(l)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(l)]
    outs = []
    for t in range(l):
        starts[t].record()
        logits, state = stream_step(model, state, frames[t])
        ends[t].record()
        outs.append(logits)
    torch.cuda.synchronize()
    step_ms = np.asarray([s.elapsed_time(e) for s, e in zip(starts, ends)])
    return torch.stack(outs, dim=1), step_ms


def measure_stream_latency(model, frames, warmup: int = 20):
    """Per-frame latency stats over one ``(L, V, C)`` capture at B = 1.

    Returns ``(mean_ms, p50_ms, p99_ms, logits (L, classes))``.
    """
    frames = frames[:, None]  # (L, 1, V, C)
    state = init_stream_state(model, batch=1, dtype=frames.dtype)
    logits, step_ms = timed_steps(model, state, frames, warmup)
    return (
        float(step_ms.mean()),
        float(np.percentile(step_ms, 50)),
        float(np.percentile(step_ms, 99)),
        logits[0].float().cpu().numpy(),
    )
