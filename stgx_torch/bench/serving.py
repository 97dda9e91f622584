"""Serving capacity: concurrent real-time streams one H100 sustains — the
port of ``stgx/bench/serving.py`` (RT-ST-GCN and CoST-GCN, the plain cells
and the int8 one), and the same for ST-GCN's window cell (the window of
W = 50 frames, every config's receptive field, re-run each frame; plain,
or int8 with ``--quant``) and AA-GCN's (plain), which the JAX tool does
not serve.

A serving deployment runs many captures at once: the streaming cell's FIFO
carry is batched over a leading stream axis, so one step advances B streams
by one frame each. This tool streams B captures frame by frame through that
batched cell, times every step with CUDA events, and turns the latency into
the capacity figure

    streams(B) = B   if step_latency(B) <= 1/fps
    capacity   = max over measured B

taking the step's p99 as its latency (a stream is real time only if nearly
every frame is), with an optional ``--bisect`` refinement.

Cell variants:

* ``--dtype float32|bfloat16``: the plain cell with parameters and state
  in that type;
* ``--quant int8-static [--state-dtype float32|bfloat16|int8]``: the int8
  cell (:mod:`stgx_torch.bench.quant`) under static scales calibrated on
  256 normal frames (seed 0, drawn after the JAX tool's warm-up draw), its
  FIFO state in ``--state-dtype`` (float32 if unset): int8 state is a
  quarter of fp32 state's bytes.

Numerics: the FIFO carries never mix streams. Under LayerNorm co-served
streams are independent; under BatchNorm (no running stats) the stats are
taken over the frame of every stream in the batch, so B co-served streams
share them. That is a deployment choice of the JAX package, kept as it is.
:func:`check_stream_drift` (``--check-drift``) streams one capture through
the fp32 cell and the chosen variant and reports how far the logits drift
apart, and whether the drift grows along the stream.

Run (on the card):
    python -m stgx_torch.bench.serving [--model rt-st-gcn|co-st-gcn|st-gcn|aa-gcn]
        [--config F] [--kernel GAMMA] --batches 1,64 --frames 256
        [--dtype bfloat16 | --quant int8-static [--state-dtype int8]]
        [--check-drift] [--bisect] [--profile]

``--model`` picks the family's canonical config (``FAMILY_CONFIGS``) unless
``--config`` names another.

Prints one JSON line per batch size (step p50 / p99, the state's bytes and
the peak device memory of the probe) and a final capacity line. With
``--profile`` each batch size also gets a line that says where a step's
time goes: the device's busy share of the wall time, the device launches a
step makes, and the kernels that take the most device time
(``torch.profiler`` over a separate window of steps).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import time
from collections import defaultdict

import numpy as np
import torch

from stgx_torch.bench.quant import QUANT_MODELS, calibrate_scales, quant_mode
from stgx_torch.bench.headline import state_tensors
from stgx_torch.bench.streaming import init_window_state, streaming_fns, timed_steps, window_step
from stgx_torch.config import FAMILY_CONFIGS
from stgx_torch.models import CoStgcn, RtStgcn, Stgcn

__all__ = [
    "serving_cell",
    "quant_cell",
    "calibration_frames",
    "state_bytes",
    "make_frames",
    "measure_step_latency",
    "check_stream_drift",
    "bisect_capacity",
    "profile_steps",
    "main",
    "WARMUP_STEPS",
]

WARMUP_STEPS = 8
NUM_CLASSES = 52  # PKU-MMD's action classes
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
STATE_DTYPES = {**DTYPES, "int8": torch.int8}
QUANT = ("int8-static",)
CALIB_FRAMES = 256


def _plain_fns(model):
    """``(init(model, batch=, dtype=), step(model, state, x_t))`` of the
    model's plain cell: its FIFO cell, or the window cell."""
    return streaming_fns(model) or (init_window_state, window_step)


def serving_cell(model, batch: int, dtype=None):
    """``(state0, model_like)`` of the plain fp32 or bf16 cell: parameters
    and state (FIFOs, or the window buffer) both in ``dtype`` (the model
    itself is left as it is)."""
    if dtype is not None and dtype != next(model.parameters()).dtype:
        model = copy.deepcopy(model).to(dtype)
    return _plain_fns(model)[0](model, batch=batch, dtype=dtype), model


def quant_cell(model, batch: int, quant: str = "int8-static", state_dtype=None,
               scales=None):
    """``(state0, step, ctx)`` of the int8 cell: ``step(state, x_t)`` under
    ``ctx`` (``quant_mode("static", scales)``), FIFO state in
    ``state_dtype`` (float32 if None)."""
    if quant not in QUANT:
        raise ValueError(f"unknown quant mode {quant!r} (have {QUANT})")
    if scales is None:
        raise ValueError("int8-static serving needs calibrated scales")
    quantize, qstep_fn, qinit = QUANT_MODELS[_family(model)]
    qparams = quantize(model)
    state = qinit(model, batch=batch, dtype=state_dtype or torch.float32)
    return (state, lambda st, x_t: qstep_fn(model, qparams, st, x_t),
            quant_mode("static", scales))


def _family(model) -> str:
    name = {RtStgcn: "rt-st-gcn", CoStgcn: "co-st-gcn", Stgcn: "st-gcn"}.get(type(model))
    if name is None:
        raise ValueError(f"{type(model).__name__} has no int8 streaming cell")
    return name


def _cell(model, batch, dtype=None, quant=None, state_dtype=None, scales=None):
    """``(state0, step(model, state, x_t), ctx, frame dtype)`` of a serving
    variant: the plain cell in ``dtype``, or the int8 cell."""
    if quant is None:
        state, cell = serving_cell(model, batch, dtype)
        fn = _plain_fns(cell)[1]
        return state, lambda m, st, x_t: fn(cell, st, x_t), contextlib.nullcontext(), dtype
    state, step, ctx = quant_cell(model, batch, quant, state_dtype, scales)
    return state, lambda m, st, x_t: step(st, x_t), ctx, None


def calibration_frames(model, n: int = CALIB_FRAMES, seed: int = 0):
    """``(n, V, C)`` normal frames from ``seed`` on the model's device, drawn
    after a ``(1, 16, V, C)`` warm-up draw, as the JAX tool draws its
    calibration frames after the frames it initialises the model on."""
    rng = np.random.default_rng(seed)
    rng.normal(size=(1, 16, model.num_joints, model.in_feat))
    return torch.tensor(rng.normal(size=(n, model.num_joints, model.in_feat)),
                        dtype=torch.float32, device=model.A.device)


def state_bytes(model, batch: int, dtype=None, quant=None, state_dtype=None) -> int:
    """Bytes of the state (FIFOs, or the window buffer) of ``batch`` streams
    of a serving variant."""
    if quant is None:
        state = _plain_fns(model)[0](model, batch=1, dtype=dtype or torch.float32)
    else:
        state = QUANT_MODELS[_family(model)][2](model, batch=1,
                                                dtype=state_dtype or torch.float32)
    return batch * sum(t.numel() * t.element_size() for t in state_tensors(state))


def make_frames(model, batch: int, frames: int, dtype=None):
    """``(frames, B, V, C)`` random captures (seed 0), on the model's device."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(frames, batch, model.num_joints, model.in_feat))
    return torch.tensor(x, dtype=dtype or torch.float32, device=model.A.device)


def measure_step_latency(model, batch: int, frames: int = 256, dtype=None,
                         warmup: int = WARMUP_STEPS, quant=None, state_dtype=None, scales=None):
    """Stream B captures of ``frames`` frames through the batched cell (the
    plain one in ``dtype``, or the int8 one: ``quant``, ``state_dtype``,
    ``scales``).

    Returns ``(step_ms (frames,), logits (B, frames, classes))``.
    """
    state, step, ctx, fdt = _cell(model, batch, dtype, quant, state_dtype, scales)
    x = make_frames(model, batch, frames, fdt)
    with ctx:
        logits, step_ms = timed_steps(model, state, x, warmup, step)
    return step_ms, logits


def profile_steps(model, batch: int, frames: int = 64, dtype=None, quant=None,
                  state_dtype=None, scales=None):
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

    state, step, ctx, fdt = _cell(model, batch, dtype, quant, state_dtype, scales)
    x = make_frames(model, batch, frames, fdt)
    with ctx:
        for _ in range(WARMUP_STEPS):
            _, state = step(model, state, x[0])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for t in range(frames):
                _, state = step(model, state, x[t])
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


def check_stream_drift(model, l: int = 256, batch: int = 4, seed: int = 0,
                       dtype=None, quant=None, state_dtype=None, scales=None) -> dict:
    """Stream one capture of ``l`` frames and ``batch`` streams (normal
    from ``seed``) through the fp32 cell and a serving variant of
    ``model`` (the plain cell in ``dtype``, fp32 if None, or the int8 cell
    ``quant`` with ``state_dtype`` state under ``scales``), frame by frame;
    returns the drift of the per-frame logits: ``max_abs_drift``,
    ``max_rel_drift`` (over max|fp32 logits|), the max abs drift of each
    half of the stream, and ``top1_agreement``, the share of (frame,
    stream) pairs with the same top-1. A FIFO slot is rounded once when it
    is written, so the drift should stay bounded along the stream rather
    than grow with it. The int8 cell without ``scales`` is calibrated on
    :func:`calibration_frames` first."""
    rng = np.random.default_rng(seed)
    frames = torch.tensor(rng.normal(size=(l, batch, model.num_joints, model.in_feat)),
                          dtype=torch.float32, device=model.A.device)
    if quant is not None and scales is None:
        scales = _calibrate(model)

    def run(dt, quant_=None):
        state, step, ctx, fdt = _cell(model, batch, dt, quant_, state_dtype, scales)
        fr = frames if fdt is None else frames.to(fdt)
        outs = []
        with ctx:
            for t in range(l):
                logits, state = step(model, state, fr[t])
                outs.append(logits.float())
        return torch.stack(outs).cpu().numpy()

    ref, got = run(torch.float32), run(dtype, quant)
    err = np.abs(got - ref)
    half = l // 2
    return {
        "max_abs_drift": float(err.max()),
        "max_rel_drift": float(err.max() / max(float(np.abs(ref).max()), 1e-9)),
        "max_abs_drift_first_half": float(err[:half].max()),
        "max_abs_drift_second_half": float(err[half:].max()),
        "top1_agreement": float((got.argmax(-1) == ref.argmax(-1)).mean()),
    }


def _calibrate(model) -> dict:
    name = _family(model)
    return calibrate_scales(model, QUANT_MODELS[name][0](model), calibration_frames(model),
                            name)


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
    ap.add_argument("--model", default=None, choices=sorted(FAMILY_CONFIGS),
                    help="the family, served from its canonical config "
                    "(default rt-st-gcn)")
    ap.add_argument("--config", default=None,
                    help="the model's config (default: the --model family's)")
    ap.add_argument("--kernel", type=int, default=None,
                    help="temporal kernel Gamma override (default: the config's)")
    ap.add_argument("--batches", default="1,64",
                    help="comma-list of concurrent-stream batch sizes")
    ap.add_argument("--fps", type=float, default=30.0,
                    help="real-time frame rate each stream must sustain")
    ap.add_argument("--frames", type=int, default=256,
                    help="frames streamed per batch size")
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    ap.add_argument("--quant", default=None, choices=list(QUANT),
                    help="serve the int8 cell (static scales calibrated on 256 normal "
                    "frames) instead of the plain one")
    ap.add_argument("--state-dtype", default=None, choices=sorted(STATE_DTYPES),
                    help="FIFO-state type of the int8 cell (default float32); "
                    "alone it implies --quant int8-static")
    ap.add_argument("--check-drift", action="store_true",
                    help="also stream one capture through the fp32 cell and the "
                    "chosen variant and print the logits' drift")
    ap.add_argument("--bisect", action="store_true",
                    help="binary-search the real-time boundary between the "
                    "largest real-time and smallest late measured batch")
    ap.add_argument("--resolution", type=int, default=128,
                    help="bisection resolution in streams")
    ap.add_argument("--profile", action="store_true",
                    help="also trace 64 steps per batch size and print where "
                    "a step's time goes")
    args = ap.parse_args(argv)
    if args.state_dtype is not None and args.quant is None:
        args.quant = QUANT[0]  # a FIFO type other than the model's is the int8 cell's
    if args.quant is not None and args.dtype != "float32":
        ap.error("--quant serves the int8 cell, which manages its own types: drop --dtype")

    from stgx_torch import strict_numerics
    from stgx_torch.config import build_model, load_config

    strict_numerics()
    cfg = load_config(args.config or FAMILY_CONFIGS[args.model or "rt-st-gcn"])
    name = cfg["processor"]["model"]
    if args.model is not None and name != args.model:
        raise ValueError(f"--model {args.model} but {args.config} configures {name}")
    if args.kernel is not None:
        set_kernel(cfg, args.kernel)
    model = build_model(cfg, NUM_CLASSES)
    _plain_fns(model)  # MS-TCN and MS-GCN stream in no form: ValueError
    dtype = DTYPES[args.dtype]
    budget_ms = 1e3 / args.fps
    variant = {"model": name, "dtype": args.dtype, "kernel": model.kernel,
               "device": torch.cuda.get_device_name(model.A.device)}
    quant = {}
    if args.quant:
        dtype = None  # the int8 cell manages its own types
        quant = {"quant": args.quant, "state_dtype": STATE_DTYPES[args.state_dtype or "float32"],
                 "scales": _calibrate(model)}
        variant.update(quant=args.quant, state_dtype=args.state_dtype or "float32")
    if args.check_drift:
        drift = check_stream_drift(model, dtype=dtype, **quant)
        print(json.dumps({**variant, "drift": drift}), flush=True)

    def probe(b):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        try:
            step_ms, _ = measure_step_latency(model, b, args.frames, dtype, **quant)
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
            "state_bytes": state_bytes(model, b, dtype, quant.get("quant"),
                                       quant.get("state_dtype")),
            "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
        }
        print(json.dumps(rec), flush=True)
        if args.profile:
            prof = profile_steps(model, b, dtype=dtype, **quant)
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


def set_kernel(cfg, gamma: int) -> None:
    """Set the temporal kernel Γ of ``cfg`` wherever ``build_model`` may
    read it: ``arch.kernel`` and the family's sub-dict (or the ``st-gcn``
    one it falls back to)."""
    arch = cfg["arch"]
    arch["kernel"] = gamma
    for key in (cfg["processor"]["model"], "st-gcn"):
        if isinstance(arch.get(key), dict):
            arch[key]["kernel"] = gamma


if __name__ == "__main__":
    main()
