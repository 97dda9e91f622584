"""Serving: the streaming cell steps B live streams in lockstep, closed loop.

Each step advances every stream by one frame (``stream_step`` of the
model's family on the FIFO state of ``init_stream_state``); the next step is
sent when the previous call returns. Frames come from a ring of captures
made on the device during set-up (step ``k`` serves frame ``k mod ring``).
Set-up warms the cell up with ``warmup_steps`` steps of the same streams.
CUDA events around each step time it; ``stream_step_p95_ms`` is the 95th
percentile over every step of the window.

The check keeps the logits of ``check_steps`` steps drawn from the seed
(one in each run of ``check_stride`` steps from ``check_from`` on) and has
the reference work them out again from each stream's last frames: the
streaming form with every norm's statistics over the streams' current
frame. It compares all B streams' logits of every kept step.
"""

from __future__ import annotations

import importlib
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.harness import checks, data, program
from benchmark.reference.common import fp32_products

END_TO_END = "stream_step_p95_ms"

# the module of each family's streaming cell in the program
CELLS = {"rt-st-gcn": "stgx_torch.models.rtstgcn"}


def _step(st):
    frame = st.ring[st.k % st.ring.shape[0]]
    logits, st.state = st.cell.stream_step(st.model, st.state, frame)
    st.k += 1
    return logits


def setup(run):
    program.numerics(run)
    tr = run.traffic
    model = program.model(run)
    run.mark("model built")
    cell = importlib.import_module(CELLS[run.cfg["processor"]["model"]])
    ring = data.stream_ring(tr, run.num_classes, run.joints, run.in_feat, run.seed, run.device)
    st = SimpleNamespace(model=model, cell=cell, ring=ring, k=0, kept={}, times=[],
                         state=cell.init_stream_state(model, batch=tr["streams"]))
    run.mark("frames staged")
    for _ in range(tr["warmup_steps"]):
        _step(st)
    gen = data.generator(run.seed, "sample", "cpu")
    stride = tr["check_stride"]
    offsets = torch.randint(stride, (tr["check_steps"],), generator=gen).tolist()
    st.sample = {tr["check_from"] + j * stride + o for j, o in enumerate(offsets)}
    return st


def unit(run, st, i):
    if run.device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        logits = _step(st)
        end.record()
        st.times.append((start, end))
    else:  # the CPU runs the tests: its host clock times a step
        t = time.perf_counter()
        logits = _step(st)
        st.times.append((time.perf_counter() - t) * 1e3)
    if st.k - 1 in st.sample:
        st.kept[st.k - 1] = logits.clone()
    return {"attempted": 1, "steps": 1, "frames": run.traffic["streams"]}


def _step_ms(st) -> np.ndarray:
    return np.asarray([t if isinstance(t, float) else t[0].elapsed_time(t[1])
                       for t in st.times])


def measure(run, st, window_s, counts):
    ms = _step_ms(st)
    p50, p95, p99 = (float(v) for v in np.percentile(ms, [50, 95, 99]))
    run.out(f"steps {len(ms)}: p50 {p50!r} ms, p95 {p95!r} ms, p99 {p99!r} ms, "
            f"max {float(ms.max())!r} ms, {counts['frames'] / window_s!r} frames/s")
    return p95


def release(run, st):
    del st.model, st.state


def check(run, st):
    fp32_products()
    ref = run.reference
    reach = ref.history(run.cfg)
    ring = st.ring.shape[0]
    gaps = {}
    for k, logits in sorted(st.kept.items()):
        if k < reach:
            raise ValueError(f"step {k} has fewer than {reach} frames before it")
        idx = torch.arange(k - reach, k + 1, device=st.ring.device) % ring
        frames = st.ring[idx].transpose(0, 1)  # (B, T, V, C)
        gaps[k] = checks.logit_gap(logits, ref.stream_logits(run.weights, run.cfg, frames))
    run.out(f"compared steps {sorted(gaps)} of {st.k}: logit gaps {list(gaps.values())}")
    return {"logit_gap": max(gaps.values()) if gaps else float("inf")}
