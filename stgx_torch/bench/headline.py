"""Headline benchmark of the port: RT-ST-GCN₉'s streaming per-frame latency
on one CUDA device, and its bf16 train-step throughput — the port of
``bench.py``.

Run (on the card):
    python -m stgx_torch.bench.headline [--no-train]

Prints ONE JSON line with ``bench.py``'s keys (``metric``, ``value``,
``unit``, ``vs_baseline``, ``value_repeat_median``,
``value_repeat_spread_pct``, ``repeats``, ``per_dispatch_ms``,
``latency_note`` and, unless ``--no-train``, ``train_frames_per_s_bf16``,
``train_repeat_median``, ``train_repeat_spread_pct``,
``train_model_tflops``, ``train_mfu_pct``, ``train_hbm_sol_pct``), plus
``card`` (``nvidia-smi``'s name and power limit) and ``train_form``.

Model: RT-ST-GCN₉ at its canonical configuration
(``configs/pku-mmd/as_is/rtstgcn.json``: 9 layers, channels 64→256, Γ = 9,
52 classes, BatchNorm), random weights from the config's seed; latency
does not depend on the weights.

* ``value``: the streaming step at B = 1
  (:func:`stgx_torch.models.rtstgcn.stream_step`) captured once in a CUDA
  graph over static buffers (:class:`StaticStream`, :func:`capture`) and replayed once per
  frame over ``FRAMES`` distinct frames from seed 0, all replays between
  two CUDA events; the least per-frame time over ``REPEATS`` repeats, with
  their median and spread beside it. The graph takes the host's dispatch
  out of the frame-to-frame figure, as the JAX package's on-device
  ``lax.scan`` does: what is left is the device's time for one frame
  after another, each depending on the last one's state.
* ``per_dispatch_ms``: the graph-free step's p50 over 64 frames
  (:func:`stgx_torch.bench.streaming.measure_stream_latency`), one
  dispatch of every op a frame, the reference's way of timing.
* the train fields: :func:`stgx_torch.bench.train_throughput
  .measure_train_throughput` in bf16 at 8 × 1024 frames, in the form the
  canonical config selects (``train_form``: ``arch.rt_fused`` or not).
  Frames per second at the least step time, the median beside it; model
  TFLOP/s from :func:`stgx_torch.utils.flops.rt_stgcn_macs_per_frame` (× 3
  for forward and backward, 2 flops a MAC) over the H100's bf16 peak, and
  the share of its 3.35 TB/s that
  :func:`stgx_torch.utils.flops.rt_stgcn_train_hbm_bytes_per_frame` needs.

``vs_baseline`` is 20 ms over ``value``: the reference's published
RT-ST-GCN₉ fp32 per-frame latency (``bench.py``). With no CUDA device this
raises; there is no CPU run.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from stgx_torch.bench.streaming import measure_stream_latency
from stgx_torch.bench.train_throughput import H100_HBM_BYTES_S, H100_PEAK_FLOPS, NUM_CLASSES
from stgx_torch.models.rtstgcn import init_stream_state, stream_step
from stgx_torch.utils.flops import rt_stgcn_macs_per_frame, rt_stgcn_train_hbm_bytes_per_frame

__all__ = ["StaticStream", "capture", "replay_ms", "assemble", "streaming_figures",
           "train_figures", "main", "FRAMES", "REPEATS"]

CONFIG = "configs/pku-mmd/as_is/rtstgcn.json"
FRAMES = 32768  # streamed frames a repeat, as bench.py streams
REPEATS = 4
DISPATCH_FRAMES = 64  # graph-free steps for per_dispatch_ms, as bench.py
TRAIN_TRIALS, TRAIN_FRAMES = 8, 1024
BASELINE_MS = 20.0  # the reference's RT-ST-GCN9 fp32 per-frame latency
LATENCY_NOTE = (
    "value = per-frame time of the streaming step captured in a CUDA graph "
    "and replayed frame after frame (host dispatch taken out, as the JAX "
    "package's on-device scan); per_dispatch_ms = graph-free step p50, one "
    "dispatch of every op a frame (the reference's timing)"
)


def state_tensors(state):
    """The tensors of a cell's state, a tree of dicts and lists (a list of
    per-layer FIFO dicts, or a window cell's buffer dict), in a fixed order."""
    if torch.is_tensor(state):
        yield state
    elif isinstance(state, dict):
        for k in sorted(state):
            yield from state_tensors(state[k])
    else:
        for v in state:
            yield from state_tensors(v)


class StaticStream:
    """A streaming cell at B = 1 over static buffers, the body a CUDA graph
    captures (:func:`capture`): :func:`stream_step` by default, or any
    ``step(state, x_t) -> (logits, new_state)`` from ``state`` (tensors in
    dicts and lists: per-layer FIFOs, or a window buffer), such as the int8 cells
    (:func:`stgx_torch.bench.streaming.measure_quant`).

    A :meth:`step` reads frame ``cursor`` of ``frames`` ``(L, V, C)``, runs
    the cell on the static state, writes the new state back into it (the
    cells return new tensors), stores the logits in row ``cursor`` of
    ``logits`` ``(L, classes)`` and advances the cursor, all on the device,
    with no host work and no host-to-device copy. :meth:`reset` empties the
    state and rewinds the cursor; at most ``L`` steps follow a reset.
    """

    def __init__(self, model, frames: torch.Tensor, step=None, state=None):
        self.model, self.frames = model, frames
        self.cursor = torch.zeros(1, dtype=torch.long, device=frames.device)
        if step is None:
            step = lambda st, x_t: stream_step(model, st, x_t)  # noqa: E731
            state = init_stream_state(model, batch=1, dtype=frames.dtype)
        self.cell, self.state = step, state
        classifier = model.fcn_out if hasattr(model, "fcn_out") else model.fc  # Shift-GCN: fc
        self.logits = torch.zeros((frames.shape[0], classifier.kernel.shape[1]),
                                  dtype=frames.dtype, device=frames.device)

    def _tensors(self, state):
        return list(state_tensors(state))

    def step(self):
        x_t = self.frames.index_select(0, self.cursor)  # (1, V, C)
        logits, new_state = self.cell(self.state, x_t)
        for old, new in zip(self._tensors(self.state), self._tensors(new_state)):
            if new is not old:
                old.copy_(new)
        self.logits.index_copy_(0, self.cursor, logits.to(self.logits.dtype))
        self.cursor.add_(1)

    def reset(self):
        self.cursor.zero_()
        for t in self._tensors(self.state):
            t.zero_()
        self.logits.zero_()


def capture(stream: StaticStream, warmup: int = 3) -> torch.cuda.CUDAGraph:
    """One :meth:`StaticStream.step` captured in a CUDA graph; the stream is
    reset after. The first calls (the kernel build, library handles) run
    before the capture on a side stream, as PyTorch's notes on CUDA graphs
    ask."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            stream.step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        stream.step()
    stream.reset()
    return graph


def replay_ms(graph, stream: StaticStream, frames: int) -> float:
    """Replay ``frames`` frames from a reset; their device time in ms (CUDA
    events around all replays)."""
    if frames > stream.frames.shape[0]:
        raise ValueError(f"{frames} replays past the {stream.frames.shape[0]} frames")
    stream.reset()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(frames):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def card() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _spread_pct(samples) -> float:
    return 100.0 * (max(samples) - min(samples)) / max(float(np.median(samples)), 1e-12)


def assemble(frame_ms, per_dispatch_ms: float, card_line: str, train=None) -> dict:
    """The result line from the measurements: ``frame_ms`` the per-frame
    time of each repeat, ``train`` None or ``(step_ms, trials, frames,
    form)`` of the bf16 train steps."""
    value = min(frame_ms)
    result = {
        "metric": "rtstgcn9_streaming_latency",
        "value": value,
        "unit": "ms/frame",
        "vs_baseline": BASELINE_MS / value,
        "value_repeat_median": float(np.median(frame_ms)),
        "value_repeat_spread_pct": _spread_pct(frame_ms),
        "repeats": len(frame_ms),
        "per_dispatch_ms": per_dispatch_ms,
        "latency_note": LATENCY_NOTE,
        "card": card_line,
    }
    if train is not None:
        step_ms, trials, frames, form = train
        fps = [trials * frames / ms * 1e3 for ms in step_ms]
        best = max(fps)
        tflops = best * 3 * 2 * rt_stgcn_macs_per_frame() / 1e12
        result.update(
            train_frames_per_s_bf16=best,
            train_repeat_median=float(np.median(fps)),
            train_repeat_spread_pct=_spread_pct(fps),
            train_model_tflops=tflops,
            train_mfu_pct=100 * tflops * 1e12 / H100_PEAK_FLOPS["bfloat16"],
            train_hbm_sol_pct=100 * best * rt_stgcn_train_hbm_bytes_per_frame()
            / H100_HBM_BYTES_S,
            train_form=form,
        )
    return result


def streaming_figures(model, frames: int = FRAMES, repeats: int = REPEATS):
    """``(frame_ms per repeat, per_dispatch_ms, stream)`` of the B = 1 cell
    over ``frames`` frames from seed 0; ``stream.logits`` holds the last
    repeat's logits."""
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(frames, model.num_joints, model.in_feat)),
                     dtype=torch.float32, device=model.A.device)
    stream = StaticStream(model, x)
    graph = capture(stream)
    frame_ms = [replay_ms(graph, stream, frames) / frames for _ in range(repeats)]
    per_dispatch_ms = measure_stream_latency(model, x[:DISPATCH_FRAMES])[1]
    return frame_ms, per_dispatch_ms, stream


def train_figures(cfg):
    """``(step_ms, trials, frames, form)`` of the bf16 train step of the
    config's model, in the form the config selects."""
    from stgx_torch.bench.train_throughput import measure_train_throughput
    from stgx_torch.config import build_model
    from stgx_torch.ops.rt_fused import rt_fused_enabled, set_rt_fused
    from stgx_torch.parallel.loop import OptimizerConfig, Trainer
    from stgx_torch.utils import LOSS

    fused = bool(cfg["arch"].get("rt_fused", False))
    set_rt_fused(fused)
    try:
        trainer = Trainer(model=build_model(cfg, NUM_CLASSES), kind="frame",
                          loss=LOSS["rt-st-gcn"](np.ones(NUM_CLASSES, np.float32)),
                          opt=OptimizerConfig(learning_rate=1e-4),
                          compute_dtype="bfloat16")
        _, _, step_ms = measure_train_throughput(trainer, TRAIN_TRIALS, TRAIN_FRAMES)
        form = "fused" if rt_fused_enabled() else "unfused"
    finally:
        set_rt_fused(False)
    return step_ms, TRAIN_TRIALS, TRAIN_FRAMES, form


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-train", action="store_true",
                    help="skip the bf16 train-throughput measurement")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the headline benchmark is a device measurement; no CUDA "
                           "device is available")
    from stgx_torch import strict_numerics
    from stgx_torch.config import build_model, load_config

    strict_numerics()
    cfg = load_config(CONFIG)
    frame_ms, per_dispatch_ms, _ = streaming_figures(build_model(cfg, NUM_CLASSES))
    train = None if args.no_train else train_figures(cfg)
    result = assemble(frame_ms, per_dispatch_ms, card(), train)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
