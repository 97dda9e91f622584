"""Where a step of an int8 serving cell spends its device time.

``torch.profiler`` over a steady window of eager steps of the int8 cell
(``quant_mode("static", ...)`` after a calibration on serving's frames),
at B streams, with the FIFO state in the given type. Every device
activity is put in one group by the host call that launched it:

* ``products``: the int8 products (``int8_gemm`` / ``w8_gemm``);
* ``quantize``: the activation's scale in front of a product
  (``_act_scale``: dynamic mode's abs-max pass; the codes are made inside
  the product);
* ``aggregate``: the graph conv's adjacency ``einsum`` and the bias carried
  through A (``_graph_conv`` less its product);
* ``fifo``: the FIFOs' ``torch.cat`` and any ``torch.stack`` (CoST-GCN's
  tap stack; RT-ST-GCN's accumulator taps);
* ``fifo_write``: the value stored into a FIFO slot (a cast, or int8 codes);
* ``other``: the norms, activations and the rest of the cell.

The groups are host ranges (``torch.profiler.record_function``) around the
cell module's functions, put there by this script alone; a device activity
belongs to the innermost range open when its launch was made (the CUPTI
correlation of the kernel with its launch call).

Run (on the card), from the repository root:
    python -m stgx_torch.bench.quant_profile --config configs/pku-mmd/ln/costgcn.json \\
        --batch 4096 --state-dtype float32

Prints one JSON line: the step's wall time, the device's busy share, the
device time a step by group and by kernel name, and launches a step.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from collections import defaultdict
from unittest import mock

import torch

__all__ = ["profile_cell", "device_activity", "main"]

STEPS = 16  # profiled steps
WARMUP = 8


def _labelled(fn, label):
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)
    return wrapped


def _patches(tq):
    """The (object, attribute, label) ranges this script opens."""
    names = {
        "int8_gemm": "products", "w8_gemm": "products", "_act_scale": "quantize",
        "_graph_conv": "aggregate", "_fifo_put": "fifo_write",
    }
    return ([(tq, n, label) for n, label in names.items()]
            + [(torch, "cat", "fifo"), (torch, "stack", "fifo")])


def device_activity(prof, labels):
    """``(range, name, ms)`` for every device activity of ``prof``: ``range``
    the innermost host range named in ``labels`` open when its launch was
    made (CUPTI's correlation of the activity with its launch call),
    ``"other"`` where none was, None where the launch call was not
    recorded. Ranges are matched by time alone, so the labelled ranges of
    two threads must not overlap (the autograd engine's backward thread
    runs while the thread that called ``backward`` waits)."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    ranges = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                    if e.device_type == DeviceType.CPU and e.name in labels)
    launch_at = {e.id: e.time_range.start for e in events
                 if e.device_type == DeviceType.CPU and e.name.startswith("cu")}
    out = []
    for e in events:
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        t = launch_at.get(e.id)
        group = None
        if t is not None:
            group = "other"
            for start, end, name in ranges:  # the latest start holding t
                if start > t:
                    break
                if end >= t:
                    group = name
        out.append((group, e.name, e.time_range.elapsed_us() / 1e3))
    return out


def _groups(prof, labels, steps):
    """Device ms a step by group and by kernel name, and launches a step."""
    by_group, by_name, count = defaultdict(float), defaultdict(float), defaultdict(int)
    unlinked = 0
    for group, name, ms in device_activity(prof, labels):
        unlinked += group is None
        by_group[group or "other"] += ms
        by_name[name] += ms
        count[name] += 1
    names = sorted(by_name, key=by_name.get, reverse=True)
    return ({g: by_group[g] / steps for g in sorted(by_group)},
            [{"name": n[:100], "ms": by_name[n] / steps, "launches": count[n] / steps}
             for n in names],
            unlinked / steps)


def profile_cell(config: str, batch: int, state_dtype: str = "float32",
                 steps: int = STEPS) -> dict:
    """The profile of ``steps`` eager steps of the static int8 cell of the
    model at ``config`` at ``batch`` streams (random weights from the
    config's seed, normal frames from seed 0)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the profile is a device measurement; no CUDA device")
    import stgx_torch.bench.quant as tq
    from stgx_torch import strict_numerics
    from stgx_torch.bench.serving import (
        NUM_CLASSES,
        STATE_DTYPES,
        calibration_frames,
        make_frames,
    )
    from stgx_torch.config import build_model, load_config

    strict_numerics()
    cfg = load_config(config)
    name = cfg["processor"]["model"]
    model = build_model(cfg, NUM_CLASSES)
    quantize, qstep, qinit = tq.QUANT_MODELS[name]
    qparams = quantize(model)
    scales = tq.calibrate_scales(model, qparams, calibration_frames(model), name)
    x = make_frames(model, batch, WARMUP + steps)
    patches = _patches(tq)
    labels = {label for _, _, label in patches}
    with torch.no_grad(), tq.quant_mode("static", scales):
        state = qinit(model, batch=batch, dtype=STATE_DTYPES[state_dtype])
        for t in range(WARMUP):
            _, state = qstep(model, qparams, state, x[t])
        torch.cuda.synchronize()
        with contextlib.ExitStack() as stack:
            for obj, attr, label in patches:
                stack.enter_context(mock.patch.object(obj, attr,
                                                      _labelled(getattr(obj, attr), label)))
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                for t in range(WARMUP, WARMUP + steps):
                    _, state = qstep(model, qparams, state, x[t])
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / steps
    groups, kernels, unlinked = _groups(prof, labels, steps)
    busy = sum(groups.values())
    return {
        "config": config, "model": name, "streams": batch, "state_dtype": state_dtype,
        "mode": "int8-static", "steps": steps, "step_ms": wall, "device_ms": busy,
        "busy_share": busy / wall, "groups_ms": groups,
        "launches": sum(k["launches"] for k in kernels), "unlinked_per_step": unlinked,
        "kernels": kernels[:12], "device": torch.cuda.get_device_name(0),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--batch", type=int, required=True)
    ap.add_argument("--state-dtype", default="float32",
                    choices=("float32", "bfloat16", "int8"))
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    res = profile_cell(args.config, args.batch, args.state_dtype, args.steps)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
