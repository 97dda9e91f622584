"""RT-ST-GCN's int8 modes probed in one process — the port of
``stgx/bench/quant_probe.py``, which localised the static-vs-dynamic
inversion of the JAX cells on the TPU.

Each figure is the B = 1 cell captured in a CUDA graph and replayed frame
after frame (:func:`stgx_torch.bench.streaming.graph_frame_ms` for fp32,
:func:`stgx_torch.bench.streaming.measure_quant` for the int8 modes, the
method of :mod:`stgx_torch.bench.quant_ab`; the JAX tool took a scan's
slope, which this card does not need), the least of ``--repeats`` replays of
``--frames`` normal frames from seed 0, in ms a frame:

* ``fp32_ms``, ``dynamic_ms``, ``static_ms`` (scales calibrated on the same
  frames), ``w8_ms``;
* ``static_ones_ms``: static mode with every scale 1.0, the same cell with
  other scale values;
* ``hybrid_{fcn,gcn,res}_static_ms``: dynamic mode with one site family's
  calibrated scale (:func:`hybrid`, ``stgx/bench/quant_probe.py:116-135``'s
  rule: ``fcn`` is every site starting ``fcn``, another family every site
  holding ``.<family>``), every other site, and any call handed a scale, at
  the live ``max(max|x|, 1e-12) / 127``.

Then what the static cell runs that the dynamic one does not, as
``static − dynamic`` ordered by the size of the difference: the op
histogram of one eager step in each mode, counted by
:class:`stgx_torch.bench.traffic_audit.TrafficCounter` (``op_diff``, which a
CPU run gives too), and on the card the kernels a step launches by name,
from ``torch.profiler`` (``kernel_diff``).

Run (on the card):
    python -m stgx_torch.bench.quant_probe [--kernel 69] [--frames 4096] [--repeats 3]
        [--skip-hybrids]

Prints one JSON line a figure, then one with everything. Without a CUDA
device it raises.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json

import numpy as np
import torch

__all__ = ["CONFIGS", "FAMILIES", "hybrid", "cell_context", "op_histogram",
           "kernel_histogram", "diff", "setup", "figures", "run", "main"]

NAME = "rt-st-gcn"
NUM_CLASSES = 52
CONFIGS = {9: "configs/pku-mmd/as_is/rtstgcn.json", 69: "configs/pku-mmd/as_is/rtstgcn_69.json"}
FAMILIES = ("fcn", "gcn", "res")


@contextlib.contextmanager
def hybrid(family: str, scales: dict, device):
    """Dynamic mode's ``_act_scale`` (``stgx_torch.bench.quant``, where the
    cells look it up) replaced for the block by the JAX tool's hybrid: the
    calibrated scale of ``scales`` at a site of ``family``, as a 0-d fp32
    tensor on ``device`` made here (before any capture; a host float would
    turn the division into a product with the reciprocal), the live abs-max
    scale elsewhere. Put back after the block, whatever it did."""
    import stgx_torch.bench.quant as tq

    static = {site: torch.tensor(float(s), dtype=torch.float32, device=device)
              for site, s in scales.items()}

    def act_scale(x, scale=None, site=None):
        use_static = site is not None and (
            site.startswith("fcn") if family == "fcn" else f".{family}" in site)
        if scale is None and use_static:
            return static[site]
        return tq._abs_max_scale(x)

    orig = tq._act_scale
    tq._act_scale = act_scale
    try:
        yield
    finally:
        tq._act_scale = orig


def cell_context(model, mode: str, scales=None, family=None):
    """The context a cell of ``mode`` (or, in dynamic mode, the hybrid of
    ``family``) runs in; ``scales`` the calibration."""
    import stgx_torch.bench.quant as tq

    stack = contextlib.ExitStack()
    stack.enter_context(tq.quant_mode(mode, scales if mode == "static" else None))
    if family is not None:
        stack.enter_context(hybrid(family, scales, model.A.device))
    return stack


def op_histogram(model, qparams, x_t, mode: str, scales=None, family=None) -> collections.Counter:
    """Ops of one eager step of the int8 cell (``mode``, or the dynamic
    hybrid of ``family``) on the frame ``x_t`` ``(1, V, C)`` from an empty
    FIFO, by name, as the traffic audit counts them (views and bare
    allocations left out; a kernel launch as ``kernel:<name>``)."""
    import stgx_torch.bench.quant as tq
    from stgx_torch.bench.traffic_audit import TrafficCounter, counting

    _, qstep, qinit = tq.QUANT_MODELS[NAME]
    with cell_context(model, mode, scales, family):
        state = qinit(model, batch=1)
        counter = TrafficCounter()
        with counting(counter):
            qstep(model, qparams, state, x_t)
    hist = collections.Counter()
    for row in counter.rows.values():
        hist[row["op"]] += row["count"]
    return hist


def kernel_histogram(model, qparams, x_t, mode: str, scales=None, steps: int = 4) -> dict:
    """Kernels a step of the eager int8 cell launches, by name (the first
    100 characters), averaged over ``steps`` profiled steps after one."""
    import stgx_torch.bench.quant as tq
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, qstep, qinit = tq.QUANT_MODELS[NAME]
    with cell_context(model, mode, scales), torch.no_grad():
        state = qinit(model, batch=1)
        _, state = qstep(model, qparams, state, x_t)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                _, state = qstep(model, qparams, state, x_t)
            torch.cuda.synchronize()
    hist = collections.Counter(e.name[:100] for e in prof.events()
                               if e.device_type == DeviceType.CUDA
                               and not getattr(e, "is_user_annotation", False))
    return {k: n / steps for k, n in hist.items()}


def diff(static, dynamic) -> dict:
    """``static − dynamic`` where they differ, the largest first."""
    d = {k: static.get(k, 0) - dynamic.get(k, 0) for k in set(static) | set(dynamic)}
    return dict(sorted(((k, v) for k, v in d.items() if v), key=lambda kv: (-abs(kv[1]), kv[0])))


def setup(kernel: int = 9, frames: int = 4096):
    """``(model, x, qparams, scales)``: RT-ST-GCN at Γ = ``kernel`` (its
    PKU-MMD config, random weights from the config's seed) on the card,
    ``frames`` normal frames ``(L, V, C)`` from seed 0, its int8 weights
    and the scales calibrated on those frames."""
    if not torch.cuda.is_available():
        raise RuntimeError("quant_probe times the int8 cells on the card; no CUDA device")
    import stgx_torch.bench.quant as tq
    from stgx_torch import strict_numerics
    from stgx_torch.config import build_model, load_config

    strict_numerics()
    model = build_model(load_config(CONFIGS[kernel]), NUM_CLASSES)
    x = torch.tensor(np.random.default_rng(0).normal(
        size=(frames, model.num_joints, model.in_feat)), dtype=torch.float32,
        device=model.A.device)
    qparams = tq.QUANT_MODELS[NAME][0](model)
    return model, x, qparams, tq.calibrate_scales(model, qparams, x, NAME)


def figures(model, x, qparams, scales, repeats: int = 3, skip_hybrids: bool = False,
            emit=None) -> dict:
    """Every figure of the module's docstring for :func:`setup`'s model,
    frames, weights and scales; each ``(key, value)`` passed to ``emit`` as
    it is made."""
    from stgx_torch.bench.streaming import graph_frame_ms, measure_quant

    out = {"model": f"{NAME}-{model.kernel}", "frames": x.shape[0],
           "device": torch.cuda.get_device_name(model.A.device)}
    emit = emit or (lambda key, value: None)

    def put(key, value):
        out[key] = value
        emit(key, value)

    put("fp32_ms", graph_frame_ms(model, x, repeats))
    put("dynamic_ms", measure_quant(model, NAME, qparams, x, repeats, mode="dynamic"))
    put("static_ms", measure_quant(model, NAME, qparams, x, repeats, mode="static",
                                   scales=scales))
    put("w8_ms", measure_quant(model, NAME, qparams, x, repeats, mode="w8"))
    ones = dict.fromkeys(scales, 1.0)
    put("static_ones_ms", measure_quant(model, NAME, qparams, x, repeats, mode="static",
                                        scales=ones))
    if not skip_hybrids:
        for family in FAMILIES:
            with hybrid(family, scales, model.A.device):
                put(f"hybrid_{family}_static_ms",
                    measure_quant(model, NAME, qparams, x, repeats, mode="dynamic"))
    x_t = x[:1]
    ops = {m: op_histogram(model, qparams, x_t, m, scales) for m in ("dynamic", "static")}
    put("op_diff_static_minus_dynamic", diff(ops["static"], ops["dynamic"]))
    put("total_ops", {m: sum(h.values()) for m, h in ops.items()})
    kernels = {m: kernel_histogram(model, qparams, x_t, m, scales) for m in ("dynamic", "static")}
    put("kernel_diff_static_minus_dynamic", diff(kernels["static"], kernels["dynamic"]))
    put("kernels_a_step", {m: sum(h.values()) for m, h in kernels.items()})
    return out


def run(kernel: int = 9, frames: int = 4096, repeats: int = 3, skip_hybrids: bool = False,
        emit=None) -> dict:
    """:func:`figures` of :func:`setup`'s probe."""
    return figures(*setup(kernel, frames), repeats, skip_hybrids, emit)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=4096)
    ap.add_argument("--kernel", type=int, default=9, choices=sorted(CONFIGS))
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--skip-hybrids", action="store_true")
    args = ap.parse_args(argv)
    out = run(args.kernel, args.frames, args.repeats, args.skip_hybrids,
              emit=lambda key, value: print(json.dumps({key: value}), flush=True))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
