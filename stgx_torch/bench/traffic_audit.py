"""Bytes each op of the measured train step moves — the port of
``stgx/bench/hlo_audit.py`` (the JAX tool reads the compiled step's HLO; the
port runs eagerly, so it counts the ops the step dispatches).

One step of :mod:`stgx_torch.bench.train_throughput` (forward, loss,
backward and Adam, or with ``--fwd-only`` the training forward and the
loss) runs once under :class:`TrafficCounter`, a ``TorchDispatchMode``. The
rules, the counterpart of ``audit_hlo_text``'s:

* every op that makes a buffer counts one write of each output and one read
  of each tensor it takes (a tensor taken twice read once); a buffer's bytes
  are its elements × their size (the card pads no tile);
* views, aliases, ``detach`` and bare allocations move nothing
  (:data:`FREE_OPS`, and every op whose schema says its output is a view),
  nor do the profiler's own range ops;
* an in-place op writes the operand it mutates (and reads it, but for
  ``copy_`` and ``out=`` operands, which it only writes); Adam's
  ``_foreach_*`` ops take lists of tensors, and every tensor of a list counts;
* the hand-written kernels launch through ctypes inside autograd Functions,
  where the mode sees only their allocations: each launch is counted where
  its wrapper makes it (:data:`KERNEL_SITES`, patched on the names the port
  looks up at call time), with the bytes and operations the kernel table of
  ``PERF.md`` counts for its bound at those shapes (:func:`kernel_traffic`:
  each input read once, each output written once).

Ops are grouped by (phase, op, the shapes they take): the phase is
``backward`` for an op the autograd engine runs (with its autograd node's
name), ``optimizer`` inside Adam's step, else ``forward``. On the CPU the
kernels' plain versions run, so a CPU count lists their ops instead.

The summary has ``hlo_audit``'s fields: the op count, the bytes written,
read and in all, bytes a frame beside the analytic minimum of
:mod:`stgx_torch.utils.flops` (``train_throughput.rooflines``), the cost
(FLOPs of the aten ops from ``torch.utils.flop_counter.FlopCounterMode``,
the kernels' operations beside them) and the memory (parameter and Adam
state bytes, the step's peak allocated memory). On the card it adds the
step's p50 (``measure_train_throughput``, a separate pass without the
counter), the audited bytes' and the analytic minimum's share of
3.35 TB/s at that step time, and, from one profiled step under the
counter, each row's device ms, launches and achieved GB/s: the counter
wraps each op in a ``torch.profiler.record_function`` range, and a device
activity belongs to the innermost range open at its launch
(:func:`stgx_torch.bench.quant_profile.device_activity`); ``outside_ms``
is device time no row holds. ``loss_unchanged`` says whether the counted
step's loss equals the same step's without the counter, bit for bit.

The step's inputs are drawn as ``stgx.bench.hlo_audit.build_step`` draws
them: ``trials`` trials of ``--frames`` frames, or for ST-GCN (the window
kind) ``trials · 1024 // 50`` windows of 50 frames; the model is the
family's canonical config (``config.FAMILY_CONFIGS``, CoST-GCN's with
LayerNorm where the JAX tool builds BatchNorm), as train_throughput's.

Run (on the card):
    python -m stgx_torch.bench.traffic_audit [--model st-gcn] [--dtype float32]
        [--fwd-only] [--frames 1024] [--top 40] [--dump ops.jsonl]

Prints the summary JSON (with ``groups``: the bytes, device ms and GB/s of
each phase and of each kernel), then the top byte streams. ``--dump`` writes every
counted op, in order, as JSON lines.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
from unittest import mock

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["TrafficCounter", "FREE_OPS", "KERNEL_SITES", "kernel_traffic", "window_adds",
           "launch_counters", "counting", "report", "audit_inputs", "audit", "run", "main"]

# ops that make no buffer, beside those whose schema says they return a view
FREE_OPS = {"aten::detach", "aten::alias", "aten::lift_fresh", "aten::empty",
            "aten::empty_strided", "aten::empty_like", "aten::new_empty",
            "aten::new_empty_strided", "aten::_unsafe_view", "aten::resize_", "aten::set_"}
# (module, name, kernel): where the port looks each kernel's launch up at
# call time; the wrapper whose ``launches`` counts it is LAUNCH_COUNTERS'
KERNEL_SITES = (
    ("stgx_torch.ops.gcn_core", "launch", "gcn_core"),
    ("stgx_torch.ops.gcn_core", "gcn_grads", "gcn_grads"),
    ("stgx_torch.ops.window_sum", "_window", "window_sum"),
    ("stgx_torch.ops.rt_fused", "_fwd", "rt_fused"),
    ("stgx_torch.ops.rt_fused", "rt_fused_bwd", "rt_fused_bwd"),
)
LAUNCH_COUNTERS = {"gcn_core": ("stgx_torch.ops.gcn_core", "gcn_core"),
                   "gcn_grads": ("stgx_torch.ops.gcn_grads", "gcn_grads"),
                   "window_sum": ("stgx_torch.ops.window_sum", "window_sum"),
                   "rt_fused": ("stgx_torch.ops.rt_fused", "rt_fused_core"),
                   "rt_fused_bwd": ("stgx_torch.ops.rt_fused", "rt_fused_bwd")}
_SHORT = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
          torch.float64: "f64", torch.int64: "s64", torch.int32: "s32", torch.int8: "s8",
          torch.bool: "pred", torch.uint8: "u8"}


def launch_counters() -> dict:
    """Each kernel's launches so far, from its wrapper's counter."""
    return {k: getattr(importlib.import_module(mod), fn).launches
            for k, (mod, fn) in LAUNCH_COUNTERS.items()}


def window_adds(n: int, l: int, q: int, k: int, s: int) -> int:
    """Adds of a window sum of ``k`` taps ``s`` apart over ``(n, l, q)``:
    each output's taps inside the sequence, less one."""
    return n * q * sum(min(k, t // s + 1) - 1 for t in range(l))


def kernel_traffic(kernel: str, *args, **kwargs):
    """``(read bytes, write bytes, operations)`` of one launch of ``kernel``
    on its wrapper's arguments, as the kernel table counts them for the
    bound: every input read once, every output written once (gradients of
    the weights in fp32), the products' multiply-adds as two operations and
    the window's adds as one."""
    x = args[0]
    isz = x.element_size()
    if kernel == "window_sum":  # _window(x, taps, stride, reverse)
        n, l, v, c = x.shape
        b = x.numel() * isz
        return b, b, window_adds(n, l, v * c, args[1], args[2])
    A, W = (args[1], args[2]) if kernel in ("gcn_core", "rt_fused") else (args[2], args[3])
    p, cin, cout = W.shape
    v = A.shape[-1]
    rows = x.numel() // (v * cin)
    weights = p * v * v + p * cin * cout
    if kernel == "gcn_core":  # launch(x, A, W)
        return (isz * (rows * v * cin + weights), isz * rows * v * cout,
                2 * rows * v * p * cin * (v + cout))
    if kernel == "gcn_grads":  # gcn_grads(x, g, A, W)
        return (isz * (rows * v * (cin + cout) + weights), 4 * weights,
                4 * rows * p * v * cin * (v + cout))
    n, l = x.shape[:2]
    gamma, stride = args[4], args[5]
    adds = window_adds(n, l, v * cout, gamma // stride, stride)
    if kernel == "rt_fused":  # _fwd(x, A, W, beff, gamma, stride)
        return (isz * (rows * v * cin + weights + v * cout), isz * rows * v * cout,
                2 * rows * v * p * cin * (v + cout) + adds)
    if kernel == "rt_fused_bwd":  # rt_fused_bwd(x, g, A, W, gamma, stride, need_gx)
        need_gx = args[6] if len(args) > 6 else kwargs.get("need_gx", True)
        return (isz * (rows * v * (cin + cout) + weights),
                isz * rows * v * cin * bool(need_gx) + 4 * (weights + v * cout),
                2 * rows * p * v * (2 * cin * cout + 3 * v * cin) + adds + rows * v * cout)
    raise ValueError(f"no traffic count for kernel {kernel!r}")


def _tensors(value):
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, (list, tuple)):
        return [t for v in value for t in _tensors(v)]
    return []


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _shape(value) -> str:
    if isinstance(value, torch.Tensor):
        return f"{_SHORT.get(value.dtype, str(value.dtype))}[{','.join(map(str, value.shape))}]"
    ts = _tensors(value)
    return f"{len(ts)} tensors of {sum(t.numel() for t in ts)} values"


def _op_traffic(func, args, kwargs, out):
    """``(read bytes, write bytes)`` of one aten op by the rules above."""
    schema = func._schema
    read, written = {}, {}
    for i, arg in enumerate(schema.arguments):
        if i < len(args):
            value = args[i]
        elif arg.name in kwargs:
            value = kwargs[arg.name]
        else:
            continue
        ts = _tensors(value)
        mutated = arg.alias_info is not None and arg.alias_info.is_write
        for t in ts:
            if mutated:
                written[id(t)] = t
            if not (arg.is_out or (mutated and schema.name == "aten::copy_")):
                read[id(t)] = t
    returns = out if isinstance(out, (tuple, list)) else (out,)
    for ret, value in zip(schema.returns, returns):
        if ret.alias_info is None:
            for t in _tensors(value):
                written[id(t)] = t
    return sum(map(_nbytes, read.values())), sum(map(_nbytes, written.values()))


class TrafficCounter(TorchDispatchMode):
    """Counts the bytes of every op dispatched while it is active, grouped
    into rows by (phase, autograd node, op, the shapes it takes); with
    ``ranges`` each op (and each kernel launch, under :func:`counting`)
    runs inside a ``record_function`` range named by its row's label."""

    def __init__(self, ranges: bool = False):
        super().__init__()
        self.ranges = ranges
        self.phase = "forward"
        self.rows = {}
        self.calls = []  # (row, read bytes, write bytes) in dispatch order

    def row(self, op, values):
        node = torch._C._current_autograd_node()
        phase, node = ("backward", node.name()) if node is not None else (self.phase, None)
        shapes = ", ".join(_shape(v) for v in values if _tensors(v))
        key = (phase, node, op, shapes)
        row = self.rows.get(key)
        if row is None:
            row = self.rows[key] = {"label": f"traffic:{len(self.rows)}", "phase": phase,
                                    "node": node, "op": op, "shapes": shapes, "count": 0,
                                    "read_bytes": 0, "write_bytes": 0, "operations": 0}
        return row

    def add(self, row, read, write, operations=0, count=1):
        row["count"] += count
        row["read_bytes"] += read
        row["write_bytes"] += write
        row["operations"] += operations
        self.calls.append((row, read, write))

    def span(self, row):
        if self.ranges:
            return torch.profiler.record_function(row["label"])
        return contextlib.nullcontext()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name
        if func.is_view or name in FREE_OPS or name.startswith("profiler::"):
            return func(*args, **kwargs)
        row = self.row(name, list(args) + list(kwargs.values()))
        with self.span(row):
            out = func(*args, **kwargs)
        self.add(row, *_op_traffic(func, args, kwargs, out))
        return out

    def kernel_site(self, kernel, fn):
        """``fn``, a kernel's launch site, counting each launch it makes
        (its wrapper's counter moved) as a ``kernel:<name>`` row with
        :func:`kernel_traffic`'s bytes; a CPU call (the plain version)
        passes through, its ops counted one by one."""
        mod, attr = LAUNCH_COUNTERS[kernel]

        def site(*args, **kwargs):
            if args[0].device.type != "cuda":
                return fn(*args, **kwargs)
            counter = getattr(importlib.import_module(mod), attr)
            row = self.row(f"kernel:{kernel}", args)
            row.setdefault("dims", [list(t.shape) for t in args if isinstance(t, torch.Tensor)])
            row.setdefault("itemsize", args[0].element_size())
            before = counter.launches
            with self.span(row):
                out = fn(*args, **kwargs)
            n = counter.launches - before
            if n:
                read, write, ops = kernel_traffic(kernel, *args, **kwargs)
                self.add(row, n * read, n * write, n * ops, n)
            return out

        return site


@contextlib.contextmanager
def counting(counter: TrafficCounter):
    """``counter`` active, and every kernel launch site of
    :data:`KERNEL_SITES` counting through it; the sites put back after."""
    saved = []
    try:
        for mod_name, attr, kernel in KERNEL_SITES:
            mod = importlib.import_module(mod_name)
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, counter.kernel_site(kernel, getattr(mod, attr)))
        with counter:
            yield counter
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def report(counter: TrafficCounter, top: int = 40) -> dict:
    """The counterpart of ``audit_hlo_text``'s result: op count, bytes
    written, read and in all, the kernels' operations, and the ``top`` rows
    ranked by bytes (each an (op, shapes) group with its count)."""
    rows = [dict(r, total_bytes=r["read_bytes"] + r["write_bytes"])
            for r in counter.rows.values()]
    rows.sort(key=lambda r: -r["total_bytes"])
    write = sum(r["write_bytes"] for r in rows)
    read = sum(r["read_bytes"] for r in rows)
    return {"ops": sum(r["count"] for r in rows), "write_bytes": write, "read_bytes": read,
            "total_bytes": write + read,
            "kernel_operations": sum(r["operations"] for r in rows), "top": rows[:top],
            "rows": rows}


def audit_inputs(trainer, frames: int = 1024, trials: int = 8):
    """``(x, y, mask, frames a step)`` as ``stgx.bench.hlo_audit.build_step``
    draws them (window kind: ``trials · 1024 // 50`` windows of 50
    frames), on the trainer's device."""
    from stgx_torch.bench.train_throughput import step_inputs

    if trainer.kind == "window":
        frames, trials = 50, max(1, trials * 1024 // 50)
    x, y, mask = step_inputs(trainer, trials, frames)
    return x, y, mask, trials * (1 if trainer.kind == "window" else frames)


def _counted_step(trainer, step, counter, profile: bool):
    """Run ``step`` once under ``counter`` (Adam's step in the
    ``optimizer`` phase) and a FLOP counter; with ``profile`` inside
    ``torch.profiler``. Returns ``(loss, flops, profiler or None)``."""
    from torch.profiler import ProfilerActivity
    from torch.utils.flop_counter import FlopCounterMode

    opt_step = trainer.optimizer.step

    def phased_step(*args, **kwargs):
        counter.phase = "optimizer"
        try:
            return opt_step(*args, **kwargs)
        finally:
            counter.phase = "forward"

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with contextlib.ExitStack() as stack:
        prof = stack.enter_context(torch.profiler.profile(activities=acts)) if profile else None
        stack.enter_context(mock.patch.object(trainer.optimizer, "step", phased_step))
        flops = stack.enter_context(FlopCounterMode(display=False))
        stack.enter_context(counting(counter))
        loss = step()
        if profile:
            torch.cuda.synchronize()
    return loss, flops.get_total_flops(), prof


def audit(trainer, name: str, frames: int = 1024, trials: int = 8, fwd_only: bool = False,
          top: int = 40, timed: bool | None = None) -> dict:
    """Audit one step of ``trainer`` (model ``name``) on
    :func:`audit_inputs`. ``timed`` (default: on a CUDA device) adds the
    step's p50 and peak memory from a separate timed pass and profiles the
    counted step; a CPU model cannot be timed. Returns the summary, with
    ``report``'s rows under ``"rows"`` (the ``top`` first under ``"top"``)
    and the counter under ``"counter"``."""
    from stgx_torch.bench import train_throughput as tt
    from stgx_torch.bench.quant_profile import device_activity

    on_card = trainer.device.type == "cuda"
    timed = on_card if timed is None else timed
    if timed and not on_card:
        raise RuntimeError(f"the audit's timing is a device measurement; the model is on "
                           f"{trainer.device}")
    x, y, mask, n_frames = audit_inputs(trainer, frames, trials)
    epoch = trainer.epoch_tensor(0) if trainer.pass_epoch else None
    step = tt.step_fn(trainer, x, y, mask, epoch, fwd_only)
    summary = {"model": name, "dtype": trainer.compute_dtype or "float32",
               "fwd_only": fwd_only, "frames_per_step": n_frames}
    if timed:
        torch.cuda.reset_peak_memory_stats(trainer.device)
        _, p50, _ = tt.measure_train_throughput(trainer, x.shape[0], x.shape[1], fwd_only)
        peak = torch.cuda.max_memory_allocated(trainer.device)

    model = trainer.model
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    counter = TrafficCounter(ranges=timed)
    before = launch_counters()
    loss, flops, prof = _counted_step(trainer, step, counter, profile=timed)
    after = launch_counters()
    model.load_state_dict(state)
    plain = step()
    rep = report(counter, top)
    _, nbytes = tt.rooflines(model, name, summary["dtype"], x.shape[1])
    opt_bytes = sum(t.numel() * t.element_size() for st in trainer.optimizer.state.values()
                    for t in st.values() if torch.is_tensor(t))
    summary.update({
        "ops": rep["ops"],
        "est_write_mb": rep["write_bytes"] / 1e6,
        "est_read_mb": rep["read_bytes"] / 1e6,
        "est_total_mb": rep["total_bytes"] / 1e6,
        "est_bytes_per_frame_mb": rep["total_bytes"] / n_frames / 1e6,
        "min_bytes_per_frame_mb": None if nbytes is None else nbytes / 1e6,
        "cost_analysis": {"flops": flops, "kernel_operations": rep["kernel_operations"]},
        "memory_analysis": {
            "param_bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
            "optimizer_state_bytes": opt_bytes,
            "peak_allocated_bytes": peak if timed else None},
        "kernel_launches": {k: after[k] - before[k] for k in after if after[k] != before[k]},
        "loss": [float(t) for t in loss],
        "loss_unchanged": all(torch.equal(a, b) for a, b in zip(loss, plain)),
        "device": torch.cuda.get_device_name(trainer.device) if on_card else "cpu",
    })
    if timed:
        labels = {r["label"]: r for r in rep["rows"]}
        for r in rep["rows"]:
            r["device_ms"], r["launches"] = 0.0, 0
        busy = outside = 0.0
        outside_n = 0
        for group, _, ms in device_activity(prof, set(labels)):
            busy += ms
            if group in labels:
                labels[group]["device_ms"] += ms
                labels[group]["launches"] += 1
            else:
                outside += ms
                outside_n += 1
        for r in rep["rows"]:
            r["gb_s"] = r["total_bytes"] / r["device_ms"] / 1e6 if r["device_ms"] else None
        seconds = p50 / 1e3
        summary.update({
            "step_ms_p50": p50,
            "traffic_share": rep["total_bytes"] / seconds / tt.H100_HBM_BYTES_S,
            "min_share": (None if nbytes is None
                          else nbytes * n_frames / seconds / tt.H100_HBM_BYTES_S),
            "profiled_busy_ms": busy, "rows_ms": sum(r["device_ms"] for r in rep["rows"]),
            "outside_ms": outside, "outside_launches": outside_n,
        })
    summary["groups"] = _groups(rep["rows"])
    summary["top"] = rep["top"]
    summary["rows"] = rep["rows"]
    summary["counter"] = counter
    return summary


def _groups(rows) -> dict:
    """Bytes (and on the card device ms and GB/s) of each phase's rows and
    of each kernel's."""
    out = {}
    for r in rows:
        for key in [r["phase"]] + ([r["op"]] if r["op"].startswith("kernel:") else []):
            g = out.setdefault(key, {"count": 0, "total_mb": 0.0})
            g["count"] += r["count"]
            g["total_mb"] += r["total_bytes"] / 1e6
            if "device_ms" in r:
                g["device_ms"] = g.get("device_ms", 0.0) + r["device_ms"]
    for g in out.values():
        if g.get("device_ms"):
            g["gb_s"] = g["total_mb"] / g["device_ms"]
    return out


def run(name: str = "rt-st-gcn", dtype: str = "bfloat16", frames: int = 1024,
        fwd_only: bool = False, top: int = 40, trials: int = 8, device=None,
        overrides=()) -> dict:
    """:func:`audit` of ``name``'s canonical config (``overrides`` as the
    CLI's ``--set``) on ``device`` (``cuda`` if None), after
    :func:`stgx_torch.strict_numerics`."""
    from stgx_torch import default_device, strict_numerics
    from stgx_torch.bench.train_throughput import trainer_for
    from stgx_torch.config import FAMILY_CONFIGS, load_config

    device = default_device(device)
    strict_numerics()
    cfg = load_config(FAMILY_CONFIGS[name], list(overrides))
    trainer = trainer_for(cfg, dtype, device)
    return audit(trainer, name, frames, trials, fwd_only, top)


def _line(r) -> str:
    where = r["phase"] + (f" {r['node']}" if r["node"] else "")
    timing = ""
    if "device_ms" in r:
        rate = "-" if r["gb_s"] is None else f"{r['gb_s']:.0f} GB/s"
        timing = f" {r['device_ms']:8.3f} ms {r['launches']:5d} launches {rate:>11}"
    return (f"{r['total_bytes'] / 1e6:9.1f} MB{timing}  x{r['count']:<4d} {r['op']:<24} "
            f"{where:<28} {r['shapes'][:90]}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="rt-st-gcn",
                    choices=["rt-st-gcn", "co-st-gcn", "st-gcn"])
    ap.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    ap.add_argument("--fwd-only", action="store_true")
    ap.add_argument("--frames", type=int, default=1024)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--dump", default=None, help="write every counted op here as JSON lines")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the traffic audit times and profiles the step on the card; no "
                           "CUDA device")

    out = run(args.model, args.dtype, args.frames, args.fwd_only, args.top)
    counter = out.pop("counter")
    rows, top = out.pop("rows"), out.pop("top")
    if args.dump:
        with open(args.dump, "w") as f:
            for row, read, write in counter.calls:
                f.write(json.dumps({k: row[k] for k in ("phase", "node", "op", "shapes")}
                                   | {"read_bytes": read, "write_bytes": write}) + "\n")
    print(json.dumps(out, indent=1), flush=True)
    print("\n# top byte streams (writes + reads of each (op, shapes) group)", flush=True)
    for r in top:
        print(_line(r), flush=True)
    return dict(out, top=top, rows=rows)


if __name__ == "__main__":
    main()
