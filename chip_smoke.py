#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``stgx_torch``) on one GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``stgx_torch/csrc``, holds each
kernel against its plain PyTorch version at the main path's shapes (fp32
and bf16) and times kernel, plain version and the one-call PyTorch
yardstick where there is one. It then drives the main path: RT-ST-GCN₉ at
its PKU-MMD width (``configs/pku-mmd/as_is/rtstgcn.json``, random weights
from the config's seed) in its batch form, unfused and fused, and its
streaming cell through ``stgx_torch.bench.serving``; it checks from the
launch counters that the path ran every kernel, and holds every output
against the all-plain run on the card. Under LayerNorm it checks that the
streamed logits equal the batch form's.

Every phase that fails ends the run with a non-zero exit. Without a CUDA
device, or outside the repository, it exits non-zero and prints no result.
The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the card's name and power limit, and before that a ``kernels`` line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from contextlib import contextmanager
from unittest import mock

CONFIG = "configs/pku-mmd/as_is/rtstgcn.json"
NUM_CLASSES = 52
N_BATCH, L_BATCH = 4, 1024  # batch form: captures x frames
B_STREAM, L_STREAM = 64, 256  # streaming check: streams x frames
SEED = 0

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

# Tolerances, relative to max(1, max|plain|):
# kernel vs plain, fp32: the same fp32 products summed in another order, over
#   up to P*V*C_in = 19,200 terms;
# kernel vs plain, bf16: both sum in fp32, one rounding of the output to bf16
#   (2^-8 relative) plus the order;
# whole model: nine normalised layers of fp32 sums in another order.
TOL_FP32, TOL_BF16, TOL_MODEL = 1e-4, 1e-2, 1e-4


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def rel_err(got, ref) -> tuple[float, float]:
    """(max abs error, that error over max(1, max|ref|))."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / max(1.0, ref.float().abs().max().item())


def time_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Median over ``reps`` of one call, CUDA events around each call."""
    import torch

    for _ in range(warm):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[len(times) // 2]


@contextmanager
def plain_ops():
    """Send the model's three kernel calls to their plain PyTorch versions,
    for the all-plain reference run on the card."""
    import stgx_torch.ops.gcn_core as gcm
    import stgx_torch.ops.graph_conv as gconv
    import stgx_torch.ops.rt_fused as rtf
    import stgx_torch.ops.temporal as temporal
    import stgx_torch.ops.window_sum as wsm

    with mock.patch.object(gconv, "gcn_core", gcm.gcn_core_plain), \
            mock.patch.object(temporal, "window_sum", wsm.window_sum_plain), \
            mock.patch.object(rtf, "rt_fused_core", rtf.rt_fused_plain):
        yield


def counts():
    from stgx_torch.ops.gcn_core import gcn_core
    from stgx_torch.ops.rt_fused import rt_fused_core
    from stgx_torch.ops.window_sum import window_sum

    return {"gcn_core": gcn_core.launches, "window_sum": window_sum.launches,
            "rt_fused": rt_fused_core.launches}


def reset_counts():
    from stgx_torch.ops.gcn_core import gcn_core
    from stgx_torch.ops.rt_fused import rt_fused_core
    from stgx_torch.ops.window_sum import window_sum

    gcn_core.launches = window_sum.launches = rt_fused_core.launches = 0


def diff(after, before):
    return {k: after[k] - before[k] for k in after}


# ----------------------------------------------------------------- kernels


def kernel_phase(model, layers):
    """Each kernel against its plain version at the main path's shapes.
    Returns the per-kernel records of the ``kernels`` line (without
    launches)."""
    import torch
    import torch.nn.functional as F

    from stgx_torch.ops.gcn_core import gcn_core, gcn_core_plain
    from stgx_torch.ops.rt_fused import rt_fused_core, rt_fused_plain
    from stgx_torch.ops.window_sum import window_sum, window_sum_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    v, p, gamma = model.num_joints, model.partitions, model.kernel
    A0 = model.A

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    def bound(nbytes, flops, dtype="float32"):
        t_b = nbytes / PEAK_BYTES_S * 1e3
        t_o = flops / PEAK_FLOPS[dtype] * 1e3
        return max(t_b, t_o), t_b, t_o

    recs = {}

    def add(name, shape, err, ms, plain_ms, lib_ms, b):
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        print(f"  {name} {shape} float32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {lib}, bound {b[0]:.4f} ms "
              f"({'bytes' if b[1] >= b[2] else 'operations'})", flush=True)
        r = recs.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                   "library_ms": 0.0 if lib_ms is not None else None,
                                   "bound_ms": 0.0, "_tb": 0.0, "_to": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        if lib_ms is not None:
            r["library_ms"] += lib_ms
        r["bound_ms"] += b[0]
        r["_tb"] += b[1]
        r["_to"] += b[2]

    def compare(name, shape, kern, plain, dtype, tol):
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        print(f"  {name} {shape} {dtype}: max abs err {err:.3e} "
              f"(relative {rel:.3e}, tolerance {tol:g})", flush=True)
        check(bool(torch.isfinite(got.float()).all()), f"{name} {shape}: non-finite")
        check(rel <= tol, f"{name} {shape} {dtype}: relative error {rel:.3e} > {tol}")
        return err

    # gcn_core: R = N*L rows in the batch form, R = B streams in the cell
    print("gcn_core vs plain (csrc/gcn_core.cu)", flush=True)
    step_ms = {}
    for rows in (N_BATCH * L_BATCH, 1, B_STREAM):
        for cin, cout, _ in layers:
            A = (A0 * (1.0 + 0.1 * rnd(p, v, v))).contiguous()
            W = rnd(p, cin, cout, scale=cin**-0.5)
            x32 = rnd(rows, v, cin)
            errs = {}
            for dt, tol in ((torch.float32, TOL_FP32), (torch.bfloat16, TOL_BF16)):
                x = x32.to(dt)
                errs[dt] = compare("gcn_core", (rows, v, cin, cout), lambda: gcn_core(x, A, W),
                                   lambda: gcn_core_plain(x, A, W), str(dt)[6:], tol)
            ms = time_ms(lambda: gcn_core(x32, A, W))
            if rows == N_BATCH * L_BATCH:
                plain_ms = time_ms(lambda: gcn_core_plain(x32, A, W))
                lib_ms = time_ms(lambda: torch.einsum("rvc,pvw,pcd->rwd", x32, A, W))
                flops = 2 * rows * v * p * cin * (v + cout)
                nbytes = 4 * (rows * v * (cin + cout) + p * v * v + p * cin * cout)
                add("gcn_core", (rows, v, cin, cout), errs[torch.float32], ms,
                    plain_ms, lib_ms, bound(nbytes, flops))
            else:
                print(f"  gcn_core {(rows, v, cin, cout)} float32: kernel {ms:.4f} ms",
                      flush=True)
                step_ms[rows] = step_ms.get(rows, 0.0) + ms
    for rows, ms in step_ms.items():
        print(f"  gcn_core at R={rows}: {ms:.4f} ms per streaming step (9 launches)",
              flush=True)

    print("window_sum vs plain (csrc/window_sum.cu)", flush=True)
    for _, cout, s in layers:
        x32 = rnd(N_BATCH, L_BATCH, v, cout)
        k = gamma // s
        for dt, tol in ((torch.float32, TOL_FP32), (torch.bfloat16, TOL_BF16)):
            x = x32.to(dt)
            for rev in (False, True):
                e = compare(f"window_sum{' reverse' if rev else ''}", tuple(x.shape) + (gamma, s),
                            lambda: window_sum(x, gamma, s, rev),
                            lambda: window_sum_plain(x, gamma, s, rev), str(dt)[6:], tol)
                if dt == torch.float32 and not rev:
                    err = e
        ms = time_ms(lambda: window_sum(x32, gamma, s))
        plain_ms = time_ms(lambda: window_sum_plain(x32, gamma, s))
        ones = torch.ones(1, 1, k, 1, device="cuda")
        x4 = x32.view(N_BATCH, 1, L_BATCH, v * cout)
        lib_ms = time_ms(lambda: F.conv2d(x4, ones, padding=((k - 1) * s, 0),
                                          dilation=(s, 1))[:, :, :L_BATCH])
        adds = N_BATCH * v * cout * sum(min(k, t // s + 1) - 1 for t in range(L_BATCH))
        add("window_sum", tuple(x32.shape) + (gamma, s), err, ms, plain_ms, lib_ms,
            bound(2 * 4 * x32.numel(), adds))

    print("rt_fused vs plain (csrc/rt_fused.cu)", flush=True)
    for cin, cout, s in layers:
        A = (A0 * (1.0 + 0.1 * rnd(p, v, v))).contiguous()
        W = rnd(p, cin, cout, scale=cin**-0.5)
        beff = rnd(v, cout, scale=0.1)
        x32 = rnd(N_BATCH, L_BATCH, v, cin)
        for dt, tol in ((torch.float32, TOL_FP32), (torch.bfloat16, TOL_BF16)):
            x = x32.to(dt)
            e = compare("rt_fused", (N_BATCH, L_BATCH, v, cin, cout, gamma, s),
                        lambda: rt_fused_core(x, A, W, beff, gamma, s),
                        lambda: rt_fused_plain(x, A, W, beff, gamma, s), str(dt)[6:], tol)
            if dt == torch.float32:
                err = e
        ms = time_ms(lambda: rt_fused_core(x32, A, W, beff, gamma, s))
        plain_ms = time_ms(lambda: rt_fused_plain(x32, A, W, beff, gamma, s))
        k = gamma // s
        rows = N_BATCH * L_BATCH
        flops = 2 * rows * v * p * cin * (v + cout) + N_BATCH * v * cout * sum(
            min(k, t // s + 1) - 1 for t in range(L_BATCH))
        nbytes = 4 * (rows * v * (cin + cout) + p * v * v + p * cin * cout + v * cout)
        add("rt_fused", (N_BATCH, L_BATCH, v, cin, cout, gamma, s), err, ms, plain_ms,
            None, bound(nbytes, flops))
    return recs


# -------------------------------------------------------------- main path


def main_path(cfg):
    """Drive the serving path once with the counters at zero; return the
    outputs and the counts of each part."""
    import numpy as np
    import torch

    from stgx_torch.bench import serving
    from stgx_torch.config import build_model
    from stgx_torch.ops.rt_fused import set_rt_fused

    model = build_model(cfg, NUM_CLASSES)
    set_rt_fused(False)
    x = torch.tensor(np.random.default_rng(SEED).normal(
        size=(N_BATCH, L_BATCH, model.num_joints, model.in_feat)),
        dtype=torch.float32, device="cuda")

    reset_counts()
    c0 = counts()
    with torch.inference_mode():
        y_unfused = model(x)
        torch.cuda.synchronize()
        c1 = counts()
        set_rt_fused(True)
        y_fused = model(x)
        torch.cuda.synchronize()
        set_rt_fused(False)
        c2 = counts()
        records = serving.main(["--config", CONFIG, "--batches", f"1,{B_STREAM}",
                                "--frames", str(L_STREAM)])
        c3 = counts()
    parts = {"unfused": diff(c1, c0), "fused": diff(c2, c1), "serving": diff(c3, c2)}
    return model, x, y_unfused, y_fused, records, parts, c3


def run() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "stgx_torch")):
        print("chip_smoke: run it from the repository (stgx_torch/ is missing)",
              file=sys.stderr)
        return 2
    os.chdir(here)
    sys.path.insert(0, here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import numpy as np

    from stgx_torch.bench.serving import WARMUP_STEPS, measure_step_latency
    from stgx_torch.config import build_model, load_config
    from stgx_torch.kernels import build
    from stgx_torch.models.rtstgcn import stream_sequence

    smi = smi_line()
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    build.load()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"(library {build.source_hash()})", flush=True)
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)

    cfg = load_config(CONFIG)
    arch = cfg["arch"]["rt-st-gcn"]
    layers = list(zip(arch["in_ch"], arch["out_ch"], arch["stride"]))

    # each kernel against its plain version, at the main path's shapes
    shape_model = build_model(cfg, NUM_CLASSES)
    recs = kernel_phase(shape_model, layers)

    # the main path, with the launch counters at zero
    model, x, y_unfused, y_fused, records, parts, launched = main_path(cfg)
    n = len(layers)
    steps = 2 * (WARMUP_STEPS + L_STREAM)  # serving ran B = 1 and B = B_STREAM
    print(f"launches on the main path: {json.dumps(parts)}", flush=True)
    check(parts["unfused"] == {"gcn_core": n, "window_sum": n, "rt_fused": 0},
          f"unfused batch forward launched {parts['unfused']}")
    check(parts["fused"] == {"gcn_core": 0, "window_sum": 0, "rt_fused": n},
          f"fused batch forward launched {parts['fused']}")
    check(parts["serving"] == {"gcn_core": n * steps, "window_sum": 0, "rt_fused": 0},
          f"serving launched {parts['serving']}, want {n * steps} gcn_core")
    check(all(v > 0 for v in launched.values()), f"a kernel never launched: {launched}")

    before = counts()
    with torch.inference_mode(), plain_ops():
        y_plain = model(x)
    torch.cuda.synchronize()
    check(counts() == before, "the plain reference run launched a kernel")
    check(y_unfused.shape == (N_BATCH, L_BATCH, NUM_CLASSES), f"shape {y_unfused.shape}")
    for name, y in (("unfused", y_unfused), ("fused", y_fused)):
        check(bool(torch.isfinite(y).all()), f"batch form {name}: non-finite logits")
        err, rel = rel_err(y, y_plain)
        print(f"batch form {name} vs all-plain: max abs err {err:.3e} "
              f"(relative {rel:.3e}, tolerance {TOL_MODEL:g})", flush=True)
        check(rel <= TOL_MODEL, f"batch form {name}: relative error {rel:.3e}")

    from stgx_torch.ops.rt_fused import set_rt_fused

    with torch.inference_mode():
        for fused in (False, True):
            set_rt_fused(fused)
            ms = time_ms(lambda: model(x), reps=5, warm=1)
            print(f"batch form {'fused' if fused else 'unfused'} forward, "
                  f"N={N_BATCH} x L={L_BATCH}, fp32: {ms:.3f} ms "
                  f"({N_BATCH * L_BATCH / ms * 1e3:.0f} frames/s)", flush=True)
        set_rt_fused(False)
        with plain_ops():
            ms = time_ms(lambda: model(x), reps=5, warm=1)
        print(f"batch form all-plain forward: {ms:.3f} ms", flush=True)

    # the streaming cell against the all-plain cell
    step_ms, logits = measure_step_latency(model, B_STREAM, L_STREAM)
    with plain_ops():
        plain_step_ms, logits_plain = measure_step_latency(model, B_STREAM, L_STREAM)
    check(bool(torch.isfinite(logits).all()), "streaming cell: non-finite logits")
    err, rel = rel_err(logits, logits_plain)
    print(f"streaming cell B={B_STREAM} x {L_STREAM} frames vs all-plain: max abs err "
          f"{err:.3e} (relative {rel:.3e}, tolerance {TOL_MODEL:g}); step p50 "
          f"{np.percentile(step_ms, 50):.4f} ms, all-plain p50 "
          f"{np.percentile(plain_step_ms, 50):.4f} ms", flush=True)
    check(rel <= TOL_MODEL, f"streaming cell: relative error {rel:.3e}")
    for rec in records:
        print(f"serving B={rec['streams']}: step p50 {rec['step_ms_p50']:.4f} ms, "
              f"p99 {rec['step_ms_p99']:.4f} ms", flush=True)

    # FIFO == batch under LayerNorm
    cfg_ln = load_config(CONFIG, ["arch.normalization=LayerNorm"])
    ln = build_model(cfg_ln, NUM_CLASSES)
    x_ln = x[:2, :128]
    with torch.inference_mode():
        y_batch = ln(x_ln)
        y_stream, _ = stream_sequence(ln, x_ln)
    err, rel = rel_err(y_stream, y_batch)
    print(f"LayerNorm FIFO == batch, 2 x 128 frames: max abs err {err:.3e} "
          f"(relative {rel:.3e}, tolerance {TOL_MODEL:g})", flush=True)
    check(rel <= TOL_MODEL, f"FIFO != batch under LayerNorm: {rel:.3e}")

    # the kernels line
    meta = {
        "gcn_core": ("stgx_torch/csrc/gcn_core.cu", "stgx/ops/pallas_gcn.py:76"),
        "window_sum": ("stgx_torch/csrc/window_sum.cu", "stgx/ops/pallas_acc.py:60"),
        "rt_fused": ("stgx_torch/csrc/rt_fused.cu", "stgx/ops/rt_fused.py:122"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        r = recs[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launched[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes" if r["_tb"] >= r["_to"] else "operations",
            "library_ms": r["library_ms"],
        })
    print("kernel times are summed over the 9 layers of one fp32 batch forward "
          f"(N={N_BATCH}, L={L_BATCH})", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(run())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
