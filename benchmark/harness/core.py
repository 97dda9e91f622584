"""One run of one cell: set-up, the measured window, the trace, the check,
and the result line.

A driver (``drivers/<name>.py``) is a module with

* ``END_TO_END``: the end-to-end metric it measures;
* ``setup(run)``: build the program's objects from the run's inputs and
  warm up every shape the window uses; returns the driver's state;
* ``unit(run, state, i)``: one unit of the window's work (an epoch, a
  step, a trial), returning its counts (numbers add up, lists join);
* ``measure(run, state, window_s, counts)``: the end-to-end metric's value;
* ``release(run, state)``: drop the program's state once the window closed;
* ``check(run, state)``: the numbers compared with the limits, worked out
  by the reference from the run's own inputs.

The window runs whole units until ``seconds`` have passed, then waits for
the device. With ``trace`` the units ``trace_from`` … ``trace_from +
trace_units − 1`` of the traffic run under the profiler, and the per-layer
metrics are read from that slice.
"""

from __future__ import annotations

import contextlib
import gc
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field

import torch

from benchmark.harness import data
from benchmark.harness.spec import BENCH_DIR, Cell, load_file_module
from benchmark.harness.trace import Tracer
from benchmark.reference.common import adjacency

__all__ = ["Run", "MetricContext", "run_cell", "forbidden_modules"]

# top-level modules the process may not hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "stgx")


def forbidden_modules() -> list[str]:
    """The forbidden top-level modules loaded, compared by whole name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclass
class Run:
    cell: Cell
    seed: int
    device: torch.device
    control: bool = False  # the program one precision down: TF32 on
    out: object = print  # earlier lines of the standard output
    t0: float = 0.0  # when the process started
    weights: dict = field(default_factory=dict)

    def mark(self, label: str) -> None:
        """A line with the seconds since the process started."""
        self.out(f"at {time.time() - self.t0:.3f} s: {label}")

    @property
    def cfg(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    @property
    def reference(self):
        return self.cell.reference

    @property
    def num_classes(self) -> int:
        return int(self.cfg["num_classes"])

    @property
    def joints(self) -> int:
        return adjacency(self.cfg["processor"]["graph"]).shape[1]

    @property
    def in_feat(self) -> int:
        return int(self.cfg["arch"]["in_feat"])

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@dataclass
class MetricContext:
    """What a per-layer metric's reader gets: the traced slice and its counts."""

    cfg: dict
    num_classes: int
    trace: object  # benchmark.harness.trace.Trace, or None where nothing was traced
    counts: dict


def _add(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, [] if isinstance(v, list) else 0) + v


def _card(device) -> str:
    """The card's name, power limit, clocks and temperature from ``nvidia-smi``."""
    if device.type != "cuda":
        return "no card"
    query = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        done = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader",
                               f"--id={device.index or 0}"],
                              capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return f"{query}: {done.stdout.strip()}"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float,
             control: bool = False, out=print) -> tuple[dict, list[str]]:
    """Run ``cell`` once; returns the result line's object and the lines
    that name each compared number beside its limit."""
    device = torch.device(device)
    run = Run(cell, seed, device, control, out, t0)
    run.mark("set-up starts")
    shapes = cell.reference.param_shapes(run.cfg, run.num_classes)
    run.weights = data.weights(shapes, seed, device)
    run.mark("weights made")
    driver = cell.driver
    state = driver.setup(run)
    run.sync()
    run.mark("set-up done")
    tracer = Tracer(device) if trace else None
    first, span = int(cell.traffic["trace_from"]), int(cell.traffic["trace_units"])
    totals, traced, ends = {}, {}, []
    start = time.time()
    setup_s = start - t0
    i = 0
    while True:
        if tracer is not None and i == first:
            tracer.start()
        with tracer.span("bench.unit") if tracer is not None else contextlib.nullcontext():
            counts = driver.unit(run, state, i)
        ends.append(time.time())
        _add(totals, counts)
        if tracer is not None and first <= i < first + span:
            _add(traced, counts)
        i += 1
        if tracer is not None and i == first + span:
            tracer.stop()
        # a traced run goes on until its slice is whole
        if time.time() - start >= seconds and (tracer is None or i >= first + span):
            break
    run.sync()
    window_s = time.time() - start
    if tracer is not None:
        tracer.stop()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    out(f"window: {i} units in {window_s:.6f} s; counts {_summary(totals)}")
    out(f"host seconds a unit, as each returned: {_spread(start, ends)}")
    metrics = {}
    if not trace:
        value = driver.measure(run, state, window_s, totals)
        unit = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics[driver.END_TO_END] = {"value": value, "unit": unit[driver.END_TO_END]}
        metrics["setup_s"] = {"value": setup_s, "unit": unit["setup_s"]}
    out(f"card: {_card(device)}")
    out(f"setup_s {setup_s:.6f}; peak memory {peak} bytes")
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    result = {"correct": False, "attempted": int(totals.get("attempted", 0)),
              "failed": int(totals.get("failed", 0)), "metrics": metrics, "device": device_info}
    if trace:
        found = tracer.trace
        ctx = MetricContext(run.cfg, run.num_classes, found, traced)
        for spec in cell.per_layer:
            reader = load_file_module(cell.root / BENCH_DIR / "metrics" / f"{spec['name']}.py",
                                      f"bench_metric_{spec['name']}")
            value = reader.read(ctx)
            if value is not None:
                metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
        if found is not None:
            device_info["busy_s"] = found.busy_s
            device_info["window_s"] = found.window_s
            result["breakdown"] = found.breakdown()
            out(f"traced slice: {_summary(traced)}; {len(found.device)} device activities")
    driver.release(run, state)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    run.mark("check starts")
    readings = driver.check(run, state)
    run.mark("check done")
    checks, lines, correct = {}, [], True
    for name, value in readings.items():
        limit = float(cell.limits[name]["limit"])
        checks[name] = {"value": value, "limit": limit}
        ok = math.isfinite(value) and value <= limit
        correct = correct and ok
        lines.append(f"check {name} {value!r} limit {limit!r} {'ok' if ok else 'FAILED'}")
    missing = set(cell.limits) - set(readings)
    if missing:
        correct = False
        lines.append(f"check missing: {sorted(missing)}")
    result["correct"] = correct and bool(readings)
    result["checks"] = checks
    return result, lines


def _spread(start: float, ends: list[float]) -> str:
    """Each unit's seconds on the host's clock where the window has few,
    else their least, median and largest."""
    took = [b - a for a, b in zip([start] + ends[:-1], ends)]
    if len(took) <= 64:
        return " ".join(f"{t:.4f}" for t in took)
    took.sort()
    return f"least {took[0]:.6f}, median {took[len(took) // 2]:.6f}, largest {took[-1]:.6f}"


def _summary(counts: dict) -> dict:
    return {k: (len(v) if isinstance(v, list) else v) for k, v in counts.items()}
