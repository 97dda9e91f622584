"""Per-frame streaming latency of one capture — the port of
``stgx/bench/streaming.py:measure_stream_latency``.

The deployed realtime loop calls a one-frame cell once per arriving frame,
threading its state. RT-ST-GCN's and CoST-GCN's cells are their FIFO
streaming steps (:func:`streaming_fns`). A window classifier (the
JAX package's ``WINDOW_MODELS``; Shift-GCN in the port) streams by
re-running its window on each frame (:func:`window_step`): a ``(B, W, V,
C)`` buffer that starts as zeros (the empty buffer), is rolled by one
frame and gets the new frame last, then the model on the buffer with
``train=False`` and no mask.

Each step is timed with CUDA events from before its first launch to after
its last: the wait a frame sees from arrival to logits on the device,
launch overhead included. This is a device measurement: a model on the CPU
raises.

:func:`run_streaming_benchmark` is the CLI's ``benchmark`` command (the
port of the JAX function of that name): the configured model's cell over
the first validation trial, with ``latency.csv``, ``model-size.csv`` and
``accuracy.csv`` written and one JSON line printed, and for RT-ST-GCN and
CoST-GCN the int8 rows (:mod:`stgx_torch.bench.quant`). A run the config
puts on the CPU (``job.platform: "cpu"``) times its steps with the host's
clock and says so (``"clock": "host"``).

The JAX package's on-chip view (a scan's per-frame slope) is, in the port,
the cell captured in a CUDA graph and replayed frame after frame
(:func:`graph_frame_ms`, :func:`measure_quant`; the capture machinery of
:mod:`stgx_torch.bench.headline`): the device's time for one frame after
another, host dispatch taken out. It needs the card: on the CPU the
``*_onchip_ms`` figures are not measured (empty in the CSVs, null in the
line).
"""

from __future__ import annotations

import csv
import json
import os
import pickle
import time

import numpy as np
import torch

from stgx_torch.bench.quant import QUANT_MODELS, calibrate_scales, quant_mode, quantized_size_bytes
from stgx_torch.models import costgcn, rtstgcn

__all__ = ["measure_stream_latency", "timed_steps", "init_window_state",
           "window_step", "streaming_fns", "run_streaming_benchmark", "graph_frame_ms",
           "measure_quant"]

# the continual families and the modules of their FIFO cells
_CELLS = {rtstgcn.RtStgcn: rtstgcn, costgcn.CoStgcn: costgcn}


def streaming_fns(model):
    """``(init_stream_state, stream_step)`` of the model's FIFO cell, or
    ``None`` for a window classifier, which streams through
    :func:`window_step`."""
    mod = _CELLS.get(type(model))
    return None if mod is None else (mod.init_stream_state, mod.stream_step)


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


def timed_steps(model, state, frames, warmup: int = 20, step=None):
    """Stream ``frames`` ``(L, B, V, C)`` through the cell ``step`` (the
    model's FIFO step if None) from ``state``, timing each step with CUDA
    events after ``warmup`` untimed steps on frame 0 (from a throwaway copy
    of the state).

    Returns ``(logits (B, L, classes), step_ms (L,))``.
    """
    if frames.device.type != "cuda":
        raise RuntimeError("step latency is a device measurement; frames are "
                           f"on {frames.device}")
    step = step or streaming_fns(model)[1]
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


def measure_stream_latency(model, frames, warmup: int = 20, window: int = 50, cell=None):
    """Per-frame latency stats over one ``(L, V, C)`` capture at B = 1,
    through the model's FIFO cell or, for a window model, the window cell
    of ``window`` frames, or through ``cell``, a ``(state, step)`` pair.

    Returns ``(mean_ms, p50_ms, p99_ms, logits (L, classes))``.
    """
    frames = frames[:, None]  # (L, 1, V, C)
    state, step = cell or _cell(model, frames, window)
    logits, step_ms = timed_steps(model, state, frames, warmup, step)
    return _stats(step_ms, logits)


def _cell(model, frames, window):
    """``(state, step)`` of the model's streaming cell for ``frames`` ``(L,
    B, V, C)``: its FIFO cell, else the window cell."""
    fns = streaming_fns(model)
    if fns is None:
        return init_window_state(model, frames.shape[1], window, frames.dtype), window_step
    init, step = fns
    return init(model, batch=frames.shape[1], dtype=frames.dtype), step


def _stats(step_ms, logits):
    return (
        float(step_ms.mean()),
        float(np.percentile(step_ms, 50)),
        float(np.percentile(step_ms, 99)),
        logits[0].float().cpu().numpy(),
    )


def host_stream_latency(model, frames, warmup: int = 20, window: int = 50, cell=None):
    """:func:`measure_stream_latency` for a model on the CPU, each step timed
    with the host's clock (a CPU run: no device figure)."""
    frames = frames[:, None]
    state, step = cell or _cell(model, frames, window)
    warm_state = state
    for _ in range(warmup):
        _, warm_state = step(model, warm_state, frames[0])
    outs, times = [], []
    for t in range(frames.shape[0]):
        t0 = time.perf_counter()
        logits, state = step(model, state, frames[t])
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append(logits)
    return _stats(np.asarray(times), torch.stack(outs, dim=1))


def graph_frame_ms(model, frames, repeats: int = 3, step=None, state=None,
                   window: int = 50) -> float:
    """Per-frame device time of a B = 1 cell over ``frames`` ``(L, V, C)``:
    the step captured once in a CUDA graph and replayed once per frame
    (:class:`stgx_torch.bench.headline.StaticStream`), the least of
    ``repeats`` replays of all L frames. The model's plain cell (its FIFO
    cell, or the window cell of ``window`` frames) unless ``step(state,
    x_t)`` and ``state`` are given. A device measurement: a model on the
    CPU raises."""
    from stgx_torch.bench.headline import StaticStream, capture, replay_ms

    if frames.device.type != "cuda":
        raise RuntimeError("the graph replay is a device measurement; frames are on "
                           f"{frames.device}")
    if step is None:
        fns = streaming_fns(model)
        if fns is None:  # the window cell: its buffer as a one-layer state
            state = [init_window_state(model, 1, window, frames.dtype)]

            def step(st, x_t):
                logits, buf = window_step(model, st[0], x_t)
                return logits, [buf]
        else:
            init, fn = fns
            state = init(model, batch=1, dtype=frames.dtype)
            step = lambda st, x_t: fn(model, st, x_t)  # noqa: E731
    stream = StaticStream(model, frames, step=step, state=state)
    graph = capture(stream)
    n = frames.shape[0]
    return min(replay_ms(graph, stream, n) / n for _ in range(repeats))


def measure_quant(model, name, qparams, frames, repeats: int = 3, mode: str = "dynamic",
                  scales=None, state_dtype=None) -> float:
    """Per-frame device time (ms) of the B = 1 int8 cell of ``name`` in one
    quantization ``mode`` (``"dynamic"``, ``"static"`` with ``scales``,
    ``"w8"``) and FIFO ``state_dtype`` (float32 if None; int8 needs
    ``"static"``): the port of ``measure_quant_onchip``. The cell is
    captured and replayed (:func:`graph_frame_ms`) inside the
    ``quant_mode`` context, which holds the static scales' device tensors
    the graph reads."""
    _, qstep_fn, qinit = QUANT_MODELS[name]
    frames = torch.as_tensor(frames, dtype=torch.float32).to(model.A.device)
    with quant_mode(mode, scales):
        state = qinit(model, batch=1, dtype=state_dtype or torch.float32)
        return graph_frame_ms(model, frames, repeats,
                              step=lambda st, x_t: qstep_fn(model, qparams, st, x_t),
                              state=state)


def _load_weights(cfg, model, name, out_dir):
    """The benchmark's weights, by the JAX CLI's rules: a reference
    checkpoint (``processor.torch_checkpoint``; one of another architecture
    aborts the run), else ``processor.checkpoint`` or the newest
    ``epoch-N`` under ``out``; an unreadable file leaves the random init,
    said aloud."""
    from stgx_torch.utils.checkpoint import latest_epoch, restore_params

    proc = cfg["processor"]
    if proc.get("torch_checkpoint"):
        from stgx_torch.utils.torch_import import load_reference_checkpoint, load_reference_into
        from stgx_torch.weights import to_jax_params

        try:
            tree = load_reference_checkpoint(proc["torch_checkpoint"], model, name)
        except (OSError, KeyError, ValueError) as e:
            print(f"torch checkpoint import failed ({e}); benchmarking random init")
            return
        got = dict(_shapes(tree))
        want = dict(_shapes(to_jax_params(model)))
        bad = sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))
        if bad:
            # an architecture mismatch is a config error: abort rather than
            # write plausible-looking artifacts from random weights
            raise SystemExit(f"torch_checkpoint does not match the model arch "
                             f"(e.g. {bad[:4]}); fix the config or drop the key")
        load_reference_into(model, tree)
        print(f"imported reference torch checkpoint {proc['torch_checkpoint']}")
        return
    ckpt = proc.get("checkpoint") or latest_epoch(out_dir)
    if ckpt and os.path.exists(ckpt):
        try:
            restore_params(ckpt, model)
        except (OSError, RuntimeError, KeyError, pickle.UnpicklingError) as e:
            print(f"checkpoint load failed ({e}); benchmarking random init")


def _shapes(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _shapes(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.shape(v)


def _int8_rows(model, name, frames, top1_fp32, labels, measure) -> dict:
    """The JAX benchmark's int8 rows for a family of ``QUANT_MODELS``: the
    dynamic cell's eager p50 and its predictions (top-1 and agreement with
    the fp32 cell), the quantized size and, on the card, the graph replays
    of the dynamic, calibrated-static and w8 cells (calibrated on the same
    frames, as the JAX benchmark does); on the CPU those are not measured
    (None)."""
    quantize, qstep_fn, qinit = QUANT_MODELS[name]
    qparams = quantize(model)
    cell = (qinit(model, batch=1), lambda m, st, x_t: qstep_fn(m, qparams, st, x_t))
    _, q_p50, _, q_logits = measure(model, frames, cell=cell)
    q_top1 = q_logits.argmax(-1)
    onchip = {"int8_onchip_ms": None, "int8_static_onchip_ms": None, "w8_onchip_ms": None}
    if frames.device.type == "cuda":
        onchip["int8_onchip_ms"] = measure_quant(model, name, qparams, frames, mode="dynamic")
        scales = calibrate_scales(model, qparams, frames, name)
        onchip["int8_static_onchip_ms"] = measure_quant(model, name, qparams, frames,
                                                        mode="static", scales=scales)
        onchip["w8_onchip_ms"] = measure_quant(model, name, qparams, frames, mode="w8")
    return {
        "int8_p50_ms": q_p50,
        **onchip,
        "int8_top1": float((q_top1 == labels).mean()),
        "int8_size_mb": quantized_size_bytes(qparams) / 1e6,
        "int8_agrees_fp32": float((q_top1 == top1_fp32).mean()),
    }


def run_streaming_benchmark(cfg, device=None) -> int:
    """CLI entry: stream the first validation trial (up to 256 frames)
    through the configured model's cell on ``device`` (``cuda`` if None) and
    write ``latency.csv``, ``model-size.csv`` (the JAX package's columns)
    and ``accuracy.csv`` under ``processor.out``; prints one JSON line. For
    RT-ST-GCN and CoST-GCN the int8 rows follow the fp32 ones
    (:func:`_int8_rows`), whatever ``processor.quantize`` says, as in the
    JAX benchmark."""
    from stgx_torch import default_device
    from stgx_torch.config import build_model
    from stgx_torch.data import build_datasets, load_actions

    device = default_device(device)
    proc = cfg["processor"]
    name = proc["model"]
    out_dir = proc["out"]
    os.makedirs(out_dir, exist_ok=True)
    _, val = build_datasets(proc)
    model = build_model(cfg, len(load_actions(proc["actions"])), device=device)
    _load_weights(cfg, model, name, out_dir)

    x, y = val[0]
    n_frames = min(len(x), 256)
    frames = torch.as_tensor(x[:n_frames], dtype=torch.float32, device=device)
    window = cfg["arch"].get("receptive_field", 50)
    on_card = device.type == "cuda"
    measure = measure_stream_latency if on_card else host_stream_latency
    mean_ms, p50_ms, p99_ms, logits = measure(model, frames, window=window)
    top1 = logits.argmax(-1)
    acc = float((top1 == y[:n_frames]).mean())
    size_mb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e6
    # the dispatch-free view: the graph replay
    onchip_ms = graph_frame_ms(model, frames, window=window) if on_card else None
    int8 = (_int8_rows(model, name, frames, top1, y[:n_frames], measure)
            if name in QUANT_MODELS else {})

    for fname, header, row in (
        ("latency.csv",
         ["mean_ms", "p50_ms", "p99_ms", "onchip_ms", "frames", "int8_p50_ms",
          "int8_onchip_ms", "int8_static_onchip_ms", "w8_onchip_ms"],
         [mean_ms, p50_ms, p99_ms, onchip_ms, n_frames, int8.get("int8_p50_ms"),
          int8.get("int8_onchip_ms"), int8.get("int8_static_onchip_ms"),
          int8.get("w8_onchip_ms")]),
        ("model-size.csv", ["fp32_mb", "int8_mb"], [size_mb, int8.get("int8_size_mb")]),
        ("accuracy.csv", ["top1", "frames"], [acc, n_frames]),
    ):
        with open(os.path.join(out_dir, fname), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(header)
            w.writerow(row)
    print(json.dumps({
        "model": name,
        "latency_ms_per_frame": mean_ms,
        "p50_ms": p50_ms,
        "p99_ms": p99_ms,
        "onchip_ms": onchip_ms,
        "top1": acc,
        "model_size_mb": size_mb,
        **int8,
        "frames": n_frames,
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
        "clock": "cuda_events" if on_card else "host",
    }))
    return 0
