"""Serving capacity: concurrent real-time streams one H100 sustains — the
port of the plain cell of ``stgx/bench/serving.py``.

A serving deployment runs many captures at once: the streaming cell's FIFO
carry is batched over a leading stream axis, so one step advances B streams
by one frame each. This tool streams B captures frame by frame through that
batched cell, times every step with CUDA events, and turns the latency into
the capacity figure

    streams(B) = B   if step_latency(B) <= 1/fps
    capacity   = max over measured B

taking the step's p99 as its latency (a stream is real time only if nearly
every frame is), with an optional ``--bisect`` refinement.

Numerics: the FIFO carries never mix streams. Under LayerNorm co-served
streams are independent; under BatchNorm (no running stats) the stats are
taken over the frame of every stream in the batch, so B co-served streams
share them. That is a deployment choice of the JAX package, kept as it is.

Run (on the card):
    python -m stgx_torch.bench.serving --config configs/pku-mmd/as_is/rtstgcn.json
        --batches 1,64 --frames 256 [--dtype bfloat16] [--bisect] [--profile]

Prints one JSON line per batch size and a final capacity line. With
``--profile`` each batch size also gets a line that says where a step's
time goes: the device's busy share of the wall time, the device launches a
step makes, and the kernels that take the most device time
(``torch.profiler`` over a separate window of steps).
"""

from __future__ import annotations

import argparse
import copy
import json
import time
from collections import defaultdict

import numpy as np
import torch

from stgx_torch.bench.streaming import timed_steps
from stgx_torch.models.rtstgcn import init_stream_state, stream_step

__all__ = [
    "serving_cell",
    "make_frames",
    "measure_step_latency",
    "bisect_capacity",
    "profile_steps",
    "main",
    "WARMUP_STEPS",
]

WARMUP_STEPS = 8
NUM_CLASSES = 52  # PKU-MMD's action classes
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def serving_cell(model, batch: int, dtype=None):
    """``(state0, model_like)`` of the plain fp32 or bf16 cell: parameters
    and FIFO state both in ``dtype`` (the model itself is left as it is)."""
    if dtype is not None and dtype != next(model.parameters()).dtype:
        model = copy.deepcopy(model).to(dtype)
    return init_stream_state(model, batch=batch, dtype=dtype), model


def make_frames(model, batch: int, frames: int, dtype=None):
    """``(frames, B, V, C)`` random captures (seed 0), on the model's device."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(frames, batch, model.num_joints, model.in_feat))
    return torch.tensor(x, dtype=dtype or torch.float32, device=model.A.device)


def measure_step_latency(model, batch: int, frames: int = 256, dtype=None,
                         warmup: int = WARMUP_STEPS):
    """Stream B captures of ``frames`` frames through the batched cell.

    Returns ``(step_ms (frames,), logits (B, frames, classes))``.
    """
    state, cell = serving_cell(model, batch, dtype)
    x = make_frames(cell, batch, frames, dtype)
    logits, step_ms = timed_steps(cell, state, x, warmup)
    return step_ms, logits


def profile_steps(model, batch: int, frames: int = 64, dtype=None):
    """Where a step of the B-stream cell spends its time, from a
    ``torch.profiler`` trace of ``frames`` steps after a warm-up.

    Returns ``{"step_ms", "device_busy_share", "launches_per_step",
    "top_kernels": [{"name", "ms_per_step", "per_step"}, ...]}``: the wall
    time of a step (host clock around the traced steps, synchronised), the
    share of it the device spent running anything (one stream, so device
    activities do not overlap), and the six device activities that took the most time.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    state, cell = serving_cell(model, batch, dtype)
    x = make_frames(cell, batch, frames, dtype)
    for _ in range(WARMUP_STEPS):
        _, state = stream_step(cell, state, x[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(frames):
            _, state = stream_step(cell, state, x[t])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = defaultdict(float)
    count = defaultdict(int)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            busy[e.name] += e.time_range.elapsed_us() / 1e3
            count[e.name] += 1
    order = sorted(busy, key=busy.get, reverse=True)
    return {
        "step_ms": wall_ms / frames,
        "device_busy_share": sum(busy.values()) / wall_ms,
        "launches_per_step": sum(count.values()) / frames,
        "top_kernels": [
            {"name": n[:80], "ms_per_step": busy[n] / frames,
             "per_step": count[n] / frames}
            for n in order[:6]
        ],
    }


def bisect_capacity(probe_ms, lo: int, hi: int, budget_ms: float,
                    resolution: int = 128):
    """Binary-search the real-time boundary: largest B with
    ``probe_ms(B) <= budget_ms``, assuming step latency is monotone in B.

    ``lo`` must already be known real-time (or 0) and ``hi`` known late.
    Returns ``(capacity_lo, first_late_hi)`` with
    ``first_late_hi - capacity_lo <= resolution``.
    """
    if hi - lo <= resolution:
        return lo, hi
    while hi - lo > resolution:
        mid = (lo + hi) // 2
        # keep probes on resolution multiples so reported capacity is tidy
        mid -= mid % resolution
        if mid <= lo or mid >= hi:
            break
        if probe_ms(mid) <= budget_ms:
            lo = mid
        else:
            hi = mid
    return lo, hi


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m stgx_torch.bench.serving")
    ap.add_argument("--config", default="configs/pku-mmd/as_is/rtstgcn.json")
    ap.add_argument("--batches", default="1,64",
                    help="comma-list of concurrent-stream batch sizes")
    ap.add_argument("--fps", type=float, default=30.0,
                    help="real-time frame rate each stream must sustain")
    ap.add_argument("--frames", type=int, default=256,
                    help="frames streamed per batch size")
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    ap.add_argument("--bisect", action="store_true",
                    help="binary-search the real-time boundary between the "
                    "largest real-time and smallest late measured batch")
    ap.add_argument("--resolution", type=int, default=128,
                    help="bisection resolution in streams")
    ap.add_argument("--profile", action="store_true",
                    help="also trace 64 steps per batch size and print where "
                    "a step's time goes")
    args = ap.parse_args(argv)

    from stgx_torch.config import build_model, load_config

    cfg = load_config(args.config)
    model = build_model(cfg, NUM_CLASSES)
    dtype = DTYPES[args.dtype]
    budget_ms = 1e3 / args.fps
    variant = {"model": cfg["processor"]["model"], "dtype": args.dtype,
               "device": torch.cuda.get_device_name(model.A.device)}

    def probe(b):
        try:
            step_ms, _ = measure_step_latency(model, b, args.frames, dtype)
        except torch.OutOfMemoryError:
            # B streams' state does not fit on the card: a row, late for good
            torch.cuda.empty_cache()
            rec = {**variant, "streams": b, "oom": True, "realtime": False}
            print(json.dumps(rec), flush=True)
            return float("inf"), rec
        p99 = float(np.percentile(step_ms, 99))
        rec = {
            **variant,
            "streams": b,
            "frames": args.frames,
            "step_ms_p50": float(np.percentile(step_ms, 50)),
            "step_ms_p99": p99,
            "step_ms_mean": float(step_ms.mean()),
            "frames_per_s": b / (float(np.percentile(step_ms, 50)) * 1e-3),
            "per_stream_budget_ms": budget_ms,
            "realtime": p99 <= budget_ms,
        }
        print(json.dumps(rec), flush=True)
        if args.profile:
            prof = profile_steps(model, b, dtype=dtype)
            print(json.dumps({**variant, "streams": b, "profile": prof}),
                  flush=True)
        return p99, rec

    capacity, first_late = 0, None
    results = []
    for b in (int(s) for s in args.batches.split(",")):
        _, rec = probe(b)
        results.append(rec)
        if rec["realtime"]:
            capacity = max(capacity, b)
        else:
            first_late = b if first_late is None else min(first_late, b)

    note = ("largest measured batch whose per-step p99 latency fits the "
            "per-frame budget; batches between the measured points were not "
            "probed")
    if args.bisect and first_late is not None and first_late > capacity:
        capacity, first_late = bisect_capacity(
            lambda b: probe(b)[0], capacity, first_late, budget_ms,
            resolution=args.resolution,
        )
        note = (f"bisected real-time boundary: capacity is in "
                f"[{capacity}, {first_late})")
    print(json.dumps({
        "metric": f"{variant['model']}_concurrent_{int(args.fps)}fps_streams",
        **{k: v for k, v in variant.items() if k != "model"},
        "capacity": capacity,
        "note": note,
    }), flush=True)
    return results


if __name__ == "__main__":
    main()
