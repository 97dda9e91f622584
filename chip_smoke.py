#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``stgx_torch``) on one GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``stgx_torch/csrc``, holds each
kernel against its plain PyTorch version at the main path's shapes (fp32
and bf16) and times kernel, plain version and the one-call PyTorch
yardstick where there is one; for the fused layer kernels, which no one
PyTorch call computes, the yardstick is the port's unfused kernels for the
same function at the same shapes. It then drives the main path: RT-ST-GCN₉ at
its PKU-MMD width (``configs/pku-mmd/as_is/rtstgcn.json``, random weights
from the config's seed) in its batch form, unfused and fused, and its
streaming cell through ``stgx_torch.bench.serving``; it checks from the
launch counters that the path ran every kernel, and holds every output
against the all-plain run on the card. Under LayerNorm it checks that the
streamed logits equal the batch form's.

The training path follows: synthetic PKU-MMD trials through the port's
``Trainer`` (forward, backward through the ``gcn_grads`` and
``rt_fused_bwd`` kernels and the forward kernels' backward launches, Adam),
unfused and fused, with the exact launches of each step, the first step's
gradients against the all-plain run in float64, and a falling CE; then
``stgx_torch.bench.train_throughput`` at 8 x 1024 frames in fp32 and bf16,
unfused and fused.

RT-ST-GCN at Gamma = 69 follows (``configs/pku-mmd/as_is/rtstgcn_69.json``,
the same model with 69 taps; every layer's halo is past the fused kernel's
limit): ``window_sum`` against its plain version at the 9 layers' shapes
and at ragged ones (the plain version's bits, device times and bounds into
the kernels line as ``g69_`` figures), the batch forward with the fused core
off and on (both launch gcn_core and window_sum only; logits against the
all-plain run), one unfused train step (its exact launches, peak memory,
first-step gradients against the all-plain run in float64), and
``train_throughput`` in fp32 and bf16 with window_sum's share of the
device time.

Shift-GCN follows, at its PKU-MMD width (``configs/pku-mmd/as_is/shiftgcn.json``,
W = 50, random weights from the config's seed): the ``temporal_shift``
kernel against its plain version at the seven shapes of its 20 launches per
forward, and its backward kernel (``temporal_shift_bwd``) against
``temporal_shift_vjp_plain`` at the same shapes; the offline forward of
1024 windows (exactly 20 launches, logits against the all-plain run); the
window streaming cell at B = 1 (20 launches a step, logits against the
all-plain cell; under LayerNorm the streamed logits of frame t equal the
offline logits of window t); the ``window`` ``Trainer`` on synthetic trials
cut into chunks of ``SG_SEGMENT`` windows (20 launches of the shift and 20
of its backward a chunk step, the first step's gradients against the
all-plain run in float64, a falling CE); and ``train_throughput`` for
Shift-GCN in fp32 and bf16. Peak device memory of the offline forward and
of a train step is printed. Each phase prints its seconds.

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
import tempfile
import time
from contextlib import contextmanager
from unittest import mock

CONFIG = "configs/pku-mmd/as_is/rtstgcn.json"
CONFIG_69 = "configs/pku-mmd/as_is/rtstgcn_69.json"  # the same model at Gamma = 69
NUM_CLASSES = 52
N_BATCH, L_BATCH = 4, 1024  # batch form: captures x frames
N_TRAIN, L_TRAIN = 8, 1024  # train step: stacked trials x frames
# training path: synthetic PKU-MMD trials of 512-2048 frames, stacked 4 to a
# step in one 2048-frame bucket, one Adam step per 4 trials
TRAIN_TRIALS, TRAIN_LEN, TRAIN_BS, TRAIN_EPOCHS = 8, (512, 2048), 4, 3
B_STREAM, L_STREAM = 64, 256  # streaming check: streams x frames
SEED = 0

SG_CONFIG = "configs/pku-mmd/as_is/shiftgcn.json"
SG_WINDOWS = 1024  # offline forward: windows of one capture, one per frame
SG_STREAM = 256  # window streaming cell at B = 1: frames
SG_LN_FRAMES = 96  # LayerNorm streamed == offline: frames
# window Trainer: synthetic PKU-MMD trials of 300-700 frames in chunks of
# SG_SEGMENT windows (buckets of the same size), one Adam step per 2 trials
SG_TRIALS, SG_LEN, SG_BS, SG_EPOCHS, SG_SEGMENT = 4, (300, 700), 2, 3, 256
SG_THROUGHPUT_WINDOWS = 256  # train_throughput: windows a step
SLEEP_CYCLES = 60_000_000  # device_ms: ~30 ms of a sleeping kernel, ahead of the host

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): fp32 on the
# CUDA cores, TF32 and bf16 on the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
# fp32 arithmetic that is not an FMA (an add, a product not fused into one):
# one instruction a lane, 128 lanes an SM, 132 SMs at 1.98 GHz; the FMA rate
# above counts two flops an instruction
PEAK_INSTR_S = 33.5e12
# Shapes off the main path for the graph-conv kernels, (R, V, P, C_in, C_out):
# C_in not a multiple of the copy width (3), C_out not one in bf16 (52, 300),
# C_out past one 256-wide tile, P = 4 (two partition groups), V = 7
RAGGED_GCN = [(1000, 25, 3, 3, 52), (1000, 25, 3, 200, 300), (37, 7, 4, 40, 24)]
# Shapes off the main path for window_sum, (N, L, V, C, Gamma, s): L shorter
# than the halo (40 < 68, 66), L not a multiple of the chunk, Q = V*C not a
# multiple of 4 (the scalar route), stride 2 with L odd, Gamma = 9 at V = 7,
# L = 5 and an odd C, and a halo (2099 frames) past what shared memory holds
RAGGED_WS = [(2, 40, 25, 64, 69, 1), (2, 40, 25, 64, 69, 2), (3, 1000, 25, 64, 69, 1),
             (2, 301, 25, 3, 69, 1), (2, 1023, 25, 128, 69, 2), (2, 45, 7, 52, 9, 1),
             (3, 5, 25, 64, 9, 1), (1, 777, 25, 13, 9, 2), (1, 3000, 25, 8, 2100, 1)]
# Shapes off the main path for the fused layer kernels, (N, L, V, P, C_in,
# C_out, Gamma, s): V = 7, P = 4, C_in = 3 with C_out = 52 and 300 (L = 45,
# not a multiple of any tile; stride 2); a sequence shorter than its halo
# (L = 5 < H = 8); the longest halos the dispatch rule admits (H = 64 at
# C = 64, H = 32 at C = 256)
RAGGED_RT = [(2, 45, 7, 4, 3, 52, 9, 1), (2, 45, 7, 4, 3, 300, 9, 2), (3, 5, 25, 3, 64, 64, 9, 1),
             (2, 200, 25, 3, 64, 64, 65, 1), (1, 100, 25, 3, 256, 256, 33, 1)]

# Tolerances, relative to max(1, max|plain|):
# kernel vs plain, an fp32 output: the same fp32 products summed in another
#   order, over up to P*V*C_in = 19,200 terms (bf16 inputs too: both sides
#   take the same bf16 values and sum them in fp32);
# kernel vs plain, a bf16 output: both sum in fp32, one rounding of the
#   output to bf16 (2^-8 relative) plus the order;
# whole model: nine normalised layers of fp32 sums in another order.
TOL_FP32, TOL_BF16, TOL_MODEL = 1e-4, 1e-2, 1e-4
# first-step parameter gradients, relative to max|ref| of each parameter.
# TOL_GRAD holds the fp32 kernel runs against the all-plain run in float64.
# The gradients of a layer's graph-conv weight and bias are sums over
# N*L*V = 204,800 terms that largely cancel after BatchNorm, so any fp32 run
# sits some way from the exact value: on the card the kernel runs are
# 2.0e-4 from it at worst (layers.7.gcn.bias) and the fp32 all-plain run
# 6.9e-4 (layers.7.gcn.kernel). Beside it, each parameter's kernel error
# must stay within GRAD_VS_PLAIN times the fp32 all-plain run's own error
# (plus TOL_FORMS): the kernels are never the less accurate side. TOL_FORMS
# holds the fused and the unfused kernel runs against each other. At
# Gamma = 69 the fp32 all-plain run is 4.55e-4 from float64 and the kernel
# run 4.57e-4 (layers.7.gcn.kernel), inside TOL_GRAD, which holds both.
TOL_GRAD, TOL_FORMS, GRAD_VS_PLAIN = 5e-4, 1e-5, 2.0
# Shift-GCN's first-step gradients against float64. Any fp32 run sits far
# from the exact value here: on the card the kernel run and the fp32
# all-plain run are both 6.84e-3 from it at worst (units.8.temporal
# .linear_kernel) and 1.7e-6 from each other, the kernels' only difference
# being the temporal shift's forward (the same bits as its plain version in
# fp32) and its closed-form backward. TOL_GRAD_SG is about twice that
# reading; the per-parameter GRAD_VS_PLAIN check is the one that would
# catch a kernel. The gradients that are zero in exact arithmetic (biases
# feeding a batch norm) are held to TOL_GRAD of the model's largest.
TOL_GRAD_SG = 1.5e-2


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


def device_ms(fn, calls: int = 10) -> float:
    """Device time of one call, for kernels that run shorter than their
    wrapper's host time (where ``time_ms`` reads the host): a sleeping kernel
    holds the stream while the host queues ``calls`` calls behind it, CUDA
    events around those calls; the median of three such runs."""
    import torch

    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        torch.cuda._sleep(SLEEP_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / calls)
    return sorted(runs)[1]


@contextmanager
def plain_ops():
    """Send the model's kernel calls to their plain PyTorch versions, for the
    all-plain reference run on the card. The plain versions are einsums and
    shifted adds that autograd differentiates itself, so a backward under
    this context runs no kernel either: the autograd Functions whose
    backwards launch gcn_grads and rt_fused_bwd are never entered."""
    import stgx_torch.models.shiftgcn as sgm
    import stgx_torch.ops.gcn_core as gcm
    import stgx_torch.ops.graph_conv as gconv
    import stgx_torch.ops.rt_fused as rtf
    import stgx_torch.ops.shift as shm
    import stgx_torch.ops.temporal as temporal
    import stgx_torch.ops.window_sum as wsm

    with mock.patch.object(gconv, "gcn_core", gcm.gcn_core_plain), \
            mock.patch.object(temporal, "window_sum", wsm.window_sum_plain), \
            mock.patch.object(rtf, "rt_fused_core", rtf.rt_fused_plain), \
            mock.patch.object(sgm, "temporal_shift", shm.temporal_shift_plain):
        yield


def _wrappers():
    from stgx_torch.ops.gcn_core import gcn_core
    from stgx_torch.ops.gcn_grads import gcn_grads
    from stgx_torch.ops.rt_fused import rt_fused_bwd, rt_fused_core
    from stgx_torch.ops.shift import temporal_shift, temporal_shift_bwd
    from stgx_torch.ops.window_sum import window_sum

    return {"gcn_core": gcn_core, "window_sum": window_sum, "rt_fused": rt_fused_core,
            "gcn_grads": gcn_grads, "rt_fused_bwd": rt_fused_bwd,
            "temporal_shift": temporal_shift, "temporal_shift_bwd": temporal_shift_bwd}


def counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def phase_done(name: str, t0: float) -> None:
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)


def diff(after, before):
    return {k: after[k] - before[k] for k in after}


# ----------------------------------------------------------------- kernels


def bound(nbytes, flops, dtype="float32", instr=0):
    """(bound ms, bytes ms, operations ms) at the H100's peaks: ``flops`` of
    FMAs (or tensor-core products) at the type's peak, ``instr`` other fp32
    operations (adds, separate products) at PEAK_INSTR_S."""
    t_b = nbytes / PEAK_BYTES_S * 1e3
    t_o = (flops / PEAK_FLOPS[dtype] + instr / PEAK_INSTR_S) * 1e3
    return max(t_b, t_o), t_b, t_o


# the fp32 route of each tensor-core kernel: gcn_core's runs on the CUDA
# cores, gcn_grads' as three TF32 passes on the tensor cores
FP32_ROUTE = {"gcn_core": "FMA", "gcn_grads": "3 x TF32"}


def add_tensor_core_record(recs, name, shape, flops, b32, b16, ms16, lib16):
    """Print and add the tensor-core figures of gcn_core or gcn_grads: the
    bound of the kernel's fp32 route (the fp32 FMA bound ``b32``, or for
    three TF32 passes 3 x flops at the TF32 peak over the same bytes) and
    the bf16 kernel and einsum times beside the bf16 bound (``b16``: flops
    at the bf16 peak, the bf16 bytes)."""
    route = (b32[0] if FP32_ROUTE[name] == "FMA"
             else max(b32[1], 3 * flops / PEAK_FLOPS["tf32"] * 1e3))
    print(f"  {name} {shape}: bounds fp32 FMA {b32[0]:.4f} ms, fp32 route "
          f"({FP32_ROUTE[name]}) {route:.4f} ms; bfloat16: kernel {ms16:.4f} ms, "
          f"library {lib16:.4f} ms, bound {b16[0]:.4f} ms", flush=True)
    r = recs[name]
    for key, val in (("route_bound_ms", route), ("bf16_ms", ms16),
                     ("bf16_library_ms", lib16), ("bf16_bound_ms", b16[0])):
        r[key] = r.get(key, 0.0) + val


def add_fused_record(recs, name, shape, unfused_ms, ms16, unfused16, b16):
    """Print and add the yardstick of a fused kernel: the port's unfused
    kernels for the same function at the same shapes, in fp32 and bf16, and
    the bf16 kernel beside its bound (``b16``: flops at the bf16 peak, the
    bf16 bytes)."""
    print(f"  {name} {shape}: unfused kernels fp32 {unfused_ms:.4f} ms; bfloat16: kernel "
          f"{ms16:.4f} ms, unfused kernels {unfused16:.4f} ms, bound {b16[0]:.4f} ms",
          flush=True)
    r = recs[name]
    for key, val in (("unfused_ms", unfused_ms), ("bf16_ms", ms16),
                     ("bf16_unfused_ms", unfused16), ("bf16_bound_ms", b16[0])):
        r[key] = r.get(key, 0.0) + val


def add_record(recs, name, shape, err, ms, plain_ms, lib_ms, b):
    """Print one kernel timing and add it into ``recs[name]`` (the kernels
    line sums a kernel's records over the layers)."""
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


def window_adds(n, l, q, k, s):
    """Adds of a window-sum of k taps s apart over (n, l, q): each output's
    taps inside the sequence, less one."""
    return n * q * sum(min(k, t // s + 1) - 1 for t in range(l))


def check_equal(name, got, ref):
    """The kernel gives the plain version's bits."""
    import torch

    torch.cuda.synchronize()
    check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite")
    check(torch.equal(got, ref), f"{name}: not the plain version's bits (max abs err "
          f"{rel_err(got, ref)[0]:.3e})")


def window_records(recs, prefix, shapes, gamma, rnd):
    """window_sum against its plain version at the 9 layers' shapes
    ``(N_BATCH, L_BATCH, 25, C_out)`` with ``gamma`` and each layer's stride,
    both directions, fp32 and bf16: the plain version's bits. Times are
    device times (``device_ms``) summed over the layers, into
    ``recs["window_sum"]`` under ``prefix`` (the Gamma = 9 record's own keys,
    or ``g69_`` ones): fp32 forward (``ms``) and reverse, bf16 both, the
    plain version, ``F.conv2d`` with a ones kernel (the library yardstick),
    and the bounds (bytes, or the adds at PEAK_INSTR_S)."""
    import torch
    import torch.nn.functional as F

    from stgx_torch.ops.window_sum import window_sum, window_sum_plain

    sums = {}

    def add(key, val):
        sums[key] = sums.get(key, 0.0) + val

    for cout, s in shapes:
        x32 = rnd(N_BATCH, L_BATCH, 25, cout)
        k = gamma // s
        shape = tuple(x32.shape) + (gamma, s)
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            for rev in (False, True):
                check_equal(f"window_sum {shape} {str(dt)[6:]}{' reverse' if rev else ''}",
                            window_sum(x, gamma, s, rev), window_sum_plain(x, gamma, s, rev))
                add(("bf16_" if dt == torch.bfloat16 else "") + ("reverse_ms" if rev else "ms"),
                    device_ms(lambda: window_sum(x, gamma, s, rev)))
        ones = torch.ones(1, 1, k, 1, device="cuda")
        x4 = x32.view(N_BATCH, 1, L_BATCH, 25 * cout)
        add("plain_ms", device_ms(lambda: window_sum_plain(x32, gamma, s), calls=3))
        if not prefix:  # the way earlier runs timed it: host time included
            add("wall_ms", time_ms(lambda: window_sum(x32, gamma, s)))
        add("library_ms", device_ms(lambda: F.conv2d(x4, ones, padding=((k - 1) * s, 0),
                                                     dilation=(s, 1))[:, :, :L_BATCH], calls=3))
        adds = window_adds(N_BATCH, L_BATCH, 25 * cout, k, s)
        b32, b16 = bound(8 * x32.numel(), 0, instr=adds), bound(4 * x32.numel(), 0, instr=adds)
        for key, val in (("bound_ms", b32[0]), ("_tb", b32[1]), ("_to", b32[2]),
                         ("bf16_bound_ms", b16[0])):
            add(key, val)
    by = "bytes" if sums["_tb"] >= sums["_to"] else "operations"
    print(f"  window_sum over the 9 layers at Gamma={gamma} (device time): float32 forward "
          f"{sums['ms']:.4f} ms, reverse {sums['reverse_ms']:.4f} ms, bound {sums['bound_ms']:.4f} "
          f"ms ({by}); bfloat16 forward {sums['bf16_ms']:.4f} ms, reverse "
          f"{sums['bf16_reverse_ms']:.4f} ms, bound {sums['bf16_bound_ms']:.4f} ms; plain "
          f"{sums['plain_ms']:.4f} ms, F.conv2d {sums['library_ms']:.4f} ms", flush=True)
    r = recs.setdefault("window_sum", {"max_abs_err": 0.0})
    for key, val in sums.items():
        if not key.startswith("_") or not prefix:
            r[prefix + key] = val
    if prefix:
        r[prefix + "bound_by"] = by


def compare(name, shape, kern, plain, dtype, tol):
    """Kernel against plain version on the same inputs; returns the max abs
    error (of the worst output where there are several). ``tol`` holds the
    outputs stored in the input's type; an fp32 output of bf16 inputs (the
    backward kernels' gradients) is held to TOL_FP32."""
    import torch

    got, ref = kern(), plain()
    torch.cuda.synchronize()
    if isinstance(got, torch.Tensor):
        got, ref = (got,), (ref,)
    worst = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        if g is None and r is None:
            continue
        t = TOL_FP32 if g.dtype == torch.float32 else tol
        err, rel = rel_err(g, r)
        print(f"  {name} {shape} {dtype} output {i}: max abs err {err:.3e} "
              f"(relative {rel:.3e}, tolerance {t:g})", flush=True)
        check(bool(torch.isfinite(g.float()).all()), f"{name} {shape}: non-finite")
        check(rel <= t, f"{name} {shape} {dtype} output {i}: relative error "
              f"{rel:.3e} > {t}")
        worst = max(worst, err)
    return worst


def kernel_phase(model, layers):
    """Each forward kernel against its plain version at the main path's
    shapes. Returns the per-kernel records of the ``kernels`` line (without
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

    recs = {}

    def add(*a):
        add_record(recs, *a)

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
                values = rows * v * (cin + cout) + p * v * v + p * cin * cout
                b32 = bound(4 * values, flops)
                add("gcn_core", (rows, v, cin, cout), errs[torch.float32], ms,
                    plain_ms, lib_ms, b32)
                xb, Ab, Wb = x32.bfloat16(), A.bfloat16(), W.bfloat16()
                add_tensor_core_record(
                    recs, "gcn_core", (rows, v, cin, cout), flops, b32,
                    bound(2 * values, flops, "bfloat16"), time_ms(lambda: gcn_core(xb, Ab, Wb)),
                    time_ms(lambda: torch.einsum("rvc,pvw,pcd->rwd", xb, Ab, Wb)))
            else:
                print(f"  gcn_core {(rows, v, cin, cout)} float32: kernel {ms:.4f} ms",
                      flush=True)
                step_ms[rows] = step_ms.get(rows, 0.0) + ms
    for rows, ms in step_ms.items():
        print(f"  gcn_core at R={rows}: {ms:.4f} ms per streaming step (9 launches)",
              flush=True)
    for rows, vr, pr, cin, cout in RAGGED_GCN:
        A = torch.rand(pr, vr, vr, generator=gen, device="cuda")
        W = rnd(pr, cin, cout, scale=cin**-0.5)
        x32 = rnd(rows, vr, cin)
        for dt, tol in ((torch.float32, TOL_FP32), (torch.bfloat16, TOL_BF16)):
            x = x32.to(dt)
            compare("gcn_core", (rows, vr, pr, cin, cout), lambda: gcn_core(x, A, W),
                    lambda: gcn_core_plain(x, A, W), str(dt)[6:], tol)

    print("window_sum vs plain (csrc/window_sum.cu)", flush=True)
    window_records(recs, "", [(cout, s) for _, cout, s in layers], gamma, rnd)

    print("rt_fused vs plain (csrc/rt_fused.cu)", flush=True)
    rows = N_BATCH * L_BATCH
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
        flops = 2 * rows * v * p * cin * (v + cout)
        adds = window_adds(N_BATCH, L_BATCH, v * cout, gamma // s, s)
        values = rows * v * (cin + cout) + p * v * v + p * cin * cout + v * cout
        add("rt_fused", (N_BATCH, L_BATCH, v, cin, cout, gamma, s), err, ms, plain_ms,
            None, bound(4 * values, flops, instr=adds))
        # the yardstick: the port's unfused kernels for the same function,
        # gcn_core then window_sum, and the bf16 kernel beside its bound
        xb, Ab, Wb = x32.bfloat16(), A.bfloat16(), W.bfloat16()
        add_fused_record(
            recs, "rt_fused", (N_BATCH, L_BATCH, v, cin, cout, gamma, s),
            time_ms(lambda: window_sum(gcn_core(x32.view(rows, v, cin), A, W).view(
                N_BATCH, L_BATCH, v, cout), gamma, s)),
            time_ms(lambda: rt_fused_core(xb, Ab, Wb, beff, gamma, s)),
            time_ms(lambda: window_sum(gcn_core(xb.view(rows, v, cin), Ab, Wb).view(
                N_BATCH, L_BATCH, v, cout), gamma, s)),
            bound(2 * values, flops, "bfloat16", instr=adds))
    for n_, l_, vr, pr, cin, cout, gamma_r, s in RAGGED_RT:
        A = torch.rand(pr, vr, vr, generator=gen, device="cuda")
        W = rnd(pr, cin, cout, scale=cin**-0.5)
        beff = rnd(vr, cout, scale=0.1)
        x32 = rnd(n_, l_, vr, cin)
        for dt, tol in ((torch.float32, TOL_FP32), (torch.bfloat16, TOL_BF16)):
            x = x32.to(dt)
            compare("rt_fused", (n_, l_, vr, pr, cin, cout, gamma_r, s),
                    lambda: rt_fused_core(x, A, W, beff, gamma_r, s),
                    lambda: rt_fused_plain(x, A, W, beff, gamma_r, s), str(dt)[6:], tol)
    return recs


def check_repeatable(name, kern):
    """Two calls give the same bits: the cross-block sums run in a fixed
    order, with no atomics."""
    import torch

    a, b = kern(), kern()
    check(all(torch.equal(x, y) for x, y in zip(a, b)),
          f"{name}: two calls on the same inputs differ")


def print_split(name, dt, prof, parts):
    """The device time of a wrapper's kernels by name, summed over the 9
    layers (torch.profiler; a kernel's name, a template, ends in '<...>')."""
    split = {part: sum(t["ms"] for t in prof["top_kernels"] if f"::{part}<" in t["name"])
             for part in parts}
    print(f"  {name} split over the 9 layers, {dt}: "
          + ", ".join(f"{part} {ms:.4f} ms" for part, ms in split.items()), flush=True)


def backward_kernel_phase(model, layers):
    """The two backward kernels against their plain versions at the training
    path's shapes (N_TRAIN x L_TRAIN frames, each of the 9 layers), fp32 and
    bf16. Returns their records of the ``kernels`` line."""
    import torch

    from stgx_torch.bench.train_throughput import profile_steps
    from stgx_torch.ops.gcn_core import gcn_core
    from stgx_torch.ops.gcn_grads import gcn_grads, gcn_grads_plain
    from stgx_torch.ops.rt_fused import rt_fused_bwd, rt_fused_bwd_plain
    from stgx_torch.ops.window_sum import window_sum

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    v, p, gamma = model.num_joints, model.partitions, model.kernel
    n, l = N_TRAIN, L_TRAIN
    rows = n * l
    recs = {}

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    print("gcn_grads vs plain (csrc/gcn_grads.cu)", flush=True)
    split_inputs = []
    for cin, cout, _ in layers:
        A = (model.A * (1.0 + 0.1 * rnd(p, v, v))).contiguous()
        W = rnd(p, cin, cout, scale=cin**-0.5)
        x32, g32 = rnd(rows, v, cin), rnd(rows, v, cout)
        errs = {}
        for dt, tol in ((torch.float32, TOL_FP32), (torch.bfloat16, TOL_BF16)):
            x, g = x32.to(dt), g32.to(dt)
            errs[dt] = compare("gcn_grads", (rows, v, cin, cout), lambda: gcn_grads(x, g, A, W),
                               lambda: gcn_grads_plain(x, g, A, W), str(dt)[6:], tol)
            check_repeatable("gcn_grads", lambda: gcn_grads(x, g, A, W))
        ms = time_ms(lambda: gcn_grads(x32, g32, A, W))
        plain_ms = time_ms(lambda: gcn_grads_plain(x32, g32, A, W))
        # the yardstick: _core_bwd's two fp32 einsums (pallas_gcn.py:228-231)
        lib_ms = time_ms(lambda: (torch.einsum("rvc,pvw,rwd->pcd", x32, A, g32),
                                  torch.einsum("rvc,rwd,pcd->pvw", x32, g32, W)))
        flops = 4 * rows * p * v * cin * (v + cout)
        ins, outs = rows * v * (cin + cout) + p * v * v + p * cin * cout, p * v * v + p * cin * cout
        b32 = bound(4 * (ins + outs), flops)
        add_record(recs, "gcn_grads", (rows, v, cin, cout), errs[torch.float32], ms,
                   plain_ms, lib_ms, b32)
        xb, gb, Ab, Wb = x32.bfloat16(), g32.bfloat16(), A.bfloat16(), W.bfloat16()
        split_inputs.append(((x32, g32, A, W), (xb, gb, Ab, Wb)))
        add_tensor_core_record(
            recs, "gcn_grads", (rows, v, cin, cout), flops, b32,
            bound(2 * ins + 4 * outs, flops, "bfloat16"),
            time_ms(lambda: gcn_grads(xb, gb, Ab, Wb)),
            time_ms(lambda: (torch.einsum("rvc,pvw,rwd->pcd", xb, Ab, gb),
                             torch.einsum("rvc,rwd,pcd->pvw", xb, gb, Wb))))
    # the device time of gcn_grads' own kernels, summed over the 9 layers
    for k, dt in enumerate(("float32", "bfloat16")):
        prof = profile_steps(lambda: [gcn_grads(*inputs[k]) for inputs in split_inputs])
        print_split("gcn_grads", dt, prof, ("gw_kernel", "ga_kernel", "reduce_kernel"))
    del split_inputs
    for r_, vr, pr, cin, cout in RAGGED_GCN:
        A = torch.rand(pr, vr, vr, generator=gen, device="cuda")
        W = rnd(pr, cin, cout, scale=cin**-0.5)
        x32, g32 = rnd(r_, vr, cin), rnd(r_, vr, cout)
        for dt, tol in ((torch.float32, TOL_FP32), (torch.bfloat16, TOL_BF16)):
            x, g = x32.to(dt), g32.to(dt)
            compare("gcn_grads", (r_, vr, pr, cin, cout), lambda: gcn_grads(x, g, A, W),
                    lambda: gcn_grads_plain(x, g, A, W), str(dt)[6:], tol)
            check_repeatable("gcn_grads", lambda: gcn_grads(x, g, A, W))

    print("rt_fused_bwd vs plain (csrc/rt_fused_bwd.cu)", flush=True)
    split_inputs = []
    for cin, cout, s in layers:
        A = (model.A * (1.0 + 0.1 * rnd(p, v, v))).contiguous()
        W = rnd(p, cin, cout, scale=cin**-0.5)
        x32, g32 = rnd(n, l, v, cin), rnd(n, l, v, cout)
        errs = {}
        for dt, tol in ((torch.float32, TOL_FP32), (torch.bfloat16, TOL_BF16)):
            x, g = x32.to(dt), g32.to(dt)
            errs[dt] = compare("rt_fused_bwd", (n, l, v, cin, cout, gamma, s),
                               lambda: rt_fused_bwd(x, g, A, W, gamma, s),
                               lambda: rt_fused_bwd_plain(x, g, A, W, gamma, s),
                               str(dt)[6:], tol)
            check_repeatable("rt_fused_bwd", lambda: rt_fused_bwd(x, g, A, W, gamma, s))
        ms = time_ms(lambda: rt_fused_bwd(x32, g32, A, W, gamma, s))
        plain_ms = time_ms(lambda: rt_fused_bwd_plain(x32, g32, A, W, gamma, s))
        # (gx, gA, gW) at their least work; the window's adds and gbe's sum
        flops = 2 * rows * p * v * (2 * cin * cout + 3 * v * cin)
        adds = window_adds(n, l, v * cout, gamma // s, s) + rows * v * cout
        ins, outs = rows * v * (cin + cout) + p * v * v + p * cin * cout, (
            rows * v * cin, p * v * v + p * cin * cout + v * cout)
        add_record(recs, "rt_fused_bwd", (n, l, v, cin, cout, gamma, s), errs[torch.float32],
                   ms, plain_ms, None, bound(4 * (ins + sum(outs)), flops, instr=adds))

        # the yardstick: the port's unfused backward kernels for the same
        # function, window_sum reverse, gcn_core on (gy, A^T, W^T), gcn_grads
        def unfused(x, g, A, W):
            gy = window_sum(g, gamma, s, reverse=True).view(rows, v, cout)
            return (gcn_core(gy, A.transpose(1, 2).contiguous(), W.transpose(1, 2).contiguous()),
                    gcn_grads(x.view(rows, v, cin), gy, A, W))

        xb, gb, Ab, Wb = x32.bfloat16(), g32.bfloat16(), A.bfloat16(), W.bfloat16()
        split_inputs.append(((x32, g32, A, W, gamma, s), (xb, gb, Ab, Wb, gamma, s)))
        add_fused_record(
            recs, "rt_fused_bwd", (n, l, v, cin, cout, gamma, s),
            time_ms(lambda: unfused(x32, g32, A, W)),
            time_ms(lambda: rt_fused_bwd(xb, gb, Ab, Wb, gamma, s)),
            time_ms(lambda: unfused(xb, gb, Ab, Wb)),
            bound(2 * (ins + outs[0]) + 4 * outs[1], flops, "bfloat16", instr=adds))
    # the device time of rt_fused_bwd's own kernels, summed over the 9 layers
    for k, dt in enumerate(("float32", "bfloat16")):
        prof = profile_steps(lambda: [rt_fused_bwd(*inputs[k]) for inputs in split_inputs])
        print_split("rt_fused_bwd", dt, prof, ("window_kernel", "gw_kernel", "ga_kernel",
                                               "reduce_kernel"))
    del split_inputs
    for n_, l_, vr, pr, cin, cout, gamma_r, s in RAGGED_RT:
        A = torch.rand(pr, vr, vr, generator=gen, device="cuda")
        W = rnd(pr, cin, cout, scale=cin**-0.5)
        x32, g32 = rnd(n_, l_, vr, cin), rnd(n_, l_, vr, cout)
        for dt, tol in ((torch.float32, TOL_FP32), (torch.bfloat16, TOL_BF16)):
            x, g = x32.to(dt), g32.to(dt)
            compare("rt_fused_bwd", (n_, l_, vr, pr, cin, cout, gamma_r, s),
                    lambda: rt_fused_bwd(x, g, A, W, gamma_r, s),
                    lambda: rt_fused_bwd_plain(x, g, A, W, gamma_r, s), str(dt)[6:], tol)
            check_repeatable("rt_fused_bwd", lambda: rt_fused_bwd(x, g, A, W, gamma_r, s))
    return recs


def grad_err(got, ref) -> float:
    """Max abs error over max|ref|: each parameter's gradient at its own
    scale, however small."""
    err = (got.double() - ref.double()).abs().max().item()
    scale = ref.double().abs().max().item()
    return err / scale if scale > 0 else err


def worst_grad_err(got, ref):
    """(worst grad_err over the parameters, that parameter's name)."""
    return max((grad_err(got[k], ref[k]), k) for k in ref)


def first_step_grads(trainer, batch, divisors=None):
    """The parameter gradients of one grad step on ``batch``, cleared after.
    ``divisors`` defaults to the batch size for each stacked trial."""
    trainer.optimizer.zero_grad(set_to_none=True)
    if divisors is None:
        divisors = [float(trainer.opt.batch_size)] * batch[0].shape[0]
    trainer.grad_step(*batch, divisors)
    grads = {k: p.grad.detach().clone() for k, p in trainer.model.named_parameters()}
    trainer.optimizer.zero_grad(set_to_none=True)
    return grads


def float64_grads(trainer, batch):
    """The first step's parameter gradients in float64: a copy of the model
    and the batch in float64 through the all-plain unfused path (the plain
    versions sum in the input's type where it is wider than fp32), with the
    loss and divisors of ``first_step_grads``."""
    import copy

    import torch

    from stgx_torch.ops.rt_fused import rt_fused_enabled

    check(not rt_fused_enabled(), "the float64 witness runs the unfused form")
    model = copy.deepcopy(trainer.model).double()
    x, y, mask = batch
    with plain_ops():
        out = model(x.double(), mask=mask, train=True)
        ce, mse = trainer.loss(out, y, mask, per_sample=True)
        ((ce + mse) / float(trainer.opt.batch_size)).sum().backward()
    grads = {k: p.grad.detach() for k, p in model.named_parameters()}
    check(all(g.dtype == torch.float64 for g in grads.values()),
          "the float64 witness lost its precision")
    return grads


def training_phase(cfg, data_dir):
    """The training path at full width: synthetic PKU-MMD trials through the
    Trainer, unfused and fused. Checks the per-step launches, the first
    step's gradients against the all-plain run in float64 (the fp32
    all-plain run's own distance from it is printed beside) and a falling
    CE; returns the launch counts of the two paths."""
    import numpy as np
    import torch

    from stgx_torch.config import build_model
    from stgx_torch.data import SkeletonDirDataset, class_distribution
    from stgx_torch.data.synth import generate
    from stgx_torch.ops.rt_fused import set_rt_fused
    from stgx_torch.parallel.loop import OptimizerConfig, Trainer
    from stgx_torch.parallel.segments import pad_to_bucket
    from stgx_torch.utils import LOSS

    generate(data_dir, skeleton="pku-mmd", num_classes=NUM_CLASSES, in_feat=3,
             num_train=TRAIN_TRIALS, num_val=0, min_len=TRAIN_LEN[0],
             max_len=TRAIN_LEN[1], seed=SEED)
    ds = SkeletonDirDataset(os.path.join(data_dir, "train", "features"),
                            os.path.join(data_dir, "train", "labels"))
    dist = class_distribution(ds, NUM_CLASSES)
    n_layers = len(cfg["arch"]["rt-st-gcn"]["in_ch"])
    steps = -(-TRAIN_TRIALS // TRAIN_BS) * TRAIN_EPOCHS
    first = [pad_to_bucket(*ds[i], TRAIN_LEN[1]) for i in range(TRAIN_BS)]
    launched, kernel_grads, exact = {}, {}, None
    for fused in (False, True):
        name = "fused" if fused else "unfused"
        set_rt_fused(fused)
        trainer = Trainer(model=build_model(cfg, NUM_CLASSES), kind="frame",
                          loss=LOSS["rt-st-gcn"](dist),
                          opt=OptimizerConfig(
                              learning_rate=cfg["optimizer"]["learning_rate"],
                              batch_size=TRAIN_BS, seed=SEED),
                          bucket=TRAIN_LEN[1], trial_batch=TRAIN_BS)
        batch = trainer.stack_trials(*zip(*first))
        before = counts()
        if exact is None:  # the same start and batch in both forms
            exact = float64_grads(trainer, batch)
        with plain_ops():
            ref = first_step_grads(trainer, batch)
        check(counts() == before, "the all-plain training steps launched a kernel")
        got = kernel_grads[name] = first_step_grads(trainer, batch)
        check(all(bool(torch.isfinite(g).all()) for g in got.values()),
              f"train {name}: non-finite gradients")
        worst = worst_grad_err(got, exact)
        plain32 = worst_grad_err(ref, exact)
        print(f"train {name}: first-step gradients vs all-plain float64, worst relative "
              f"error {worst[0]:.3e} ({worst[1]}, tolerance {TOL_GRAD:g}); the fp32 "
              f"all-plain run's {plain32[0]:.3e} ({plain32[1]}); kernels vs fp32 "
              f"all-plain {worst_grad_err(got, ref)[0]:.3e}", flush=True)
        errs = sorted(((grad_err(got[k], exact[k]), grad_err(ref[k], exact[k]), k)
                       for k in exact), reverse=True)
        for e_k, e_p, k in errs[:5]:
            print(f"  {k}: kernels {e_k:.3e}, fp32 all-plain {e_p:.3e} from float64",
                  flush=True)
        check(worst[0] <= TOL_GRAD, f"train {name}: gradient {worst[1]} off by {worst[0]:.3e}")
        for e_k, e_p, k in errs:
            check(e_k <= GRAD_VS_PLAIN * e_p + TOL_FORMS,
                  f"train {name}: gradient {k} {e_k:.3e} from float64, the fp32 "
                  f"all-plain run only {e_p:.3e}")

        ce0 = trainer.evaluate(ds)["ce"]
        torch.cuda.synchronize()
        reset_counts()
        c0 = counts()
        t0 = time.perf_counter()
        ces = [trainer.train_epoch(ds, epoch)["ce"] for epoch in range(TRAIN_EPOCHS)]
        torch.cuda.synchronize()
        launched[name] = diff(counts(), c0)
        secs = time.perf_counter() - t0
        ce1 = trainer.evaluate(ds)["ce"]
        print(f"train {name}: {TRAIN_EPOCHS} epochs x {TRAIN_TRIALS} trials "
              f"({steps} Adam steps) in {secs:.2f} s; epoch CE {np.round(ces, 4).tolist()}; "
              f"eval CE {ce0:.4f} -> {ce1:.4f}; launches {json.dumps(launched[name])}",
              flush=True)
        check(np.isfinite(ces).all() and ce1 < ce0, f"train {name}: CE did not fall")
        want = ({"rt_fused": n_layers, "rt_fused_bwd": n_layers} if fused else
                {"gcn_core": 2 * n_layers, "gcn_grads": n_layers, "window_sum": 2 * n_layers})
        per_step = {k: v / steps for k, v in launched[name].items()}
        check(per_step == {k: want.get(k, 0) for k in per_step},
              f"train {name}: launches per step {per_step}, want {want}")
    set_rt_fused(False)
    # the two forms run different kernels for the same gradients
    worst = worst_grad_err(kernel_grads["fused"], kernel_grads["unfused"])
    print(f"train: fused vs unfused first-step gradients (both on the kernels), worst "
          f"relative error {worst[0]:.3e} ({worst[1]}, tolerance {TOL_FORMS:g})", flush=True)
    check(worst[0] <= TOL_FORMS, f"train: the two forms' gradients differ by {worst[0]:.3e}")
    return launched


def throughput_phase():
    """train_throughput at 8 x 1024 frames: fp32 and bf16, unfused and fused."""
    from stgx_torch.bench import train_throughput
    from stgx_torch.ops.rt_fused import set_rt_fused

    records = []
    for dtype in ("float32", "bfloat16"):
        for fused in (False, True):
            argv = ["--dtype", dtype, "--trials", str(N_TRAIN), "--frames", str(L_TRAIN),
                    "--profile"]
            records.append(train_throughput.main(argv + (["--fused"] if fused else [])))
    set_rt_fused(False)
    return records


# ------------------------------------------------------------ Gamma = 69


def gamma69_kernel_phase(recs, layers):
    """window_sum at Gamma = 69: the 9 layers' shapes (into the kernels line
    as g69_ figures), the ragged shapes, repeatability."""
    import torch

    from stgx_torch.ops.window_sum import window_sum, window_sum_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    print("window_sum vs plain at Gamma=69 (csrc/window_sum.cu)", flush=True)
    window_records(recs, "g69_", [(cout, s) for _, cout, s in layers], 69, rnd)
    for n_, l_, v_, c_, gamma, s in RAGGED_WS:
        x32 = rnd(n_, l_, v_, c_)
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            for rev in (False, True):
                check_equal(f"window_sum {(n_, l_, v_, c_, gamma, s)} {str(dt)[6:]}"
                            f"{' reverse' if rev else ''}", window_sum(x, gamma, s, rev),
                            window_sum_plain(x, gamma, s, rev))
            # one element in: no pointer aligned for a 16-byte load (the scalar route)
            off = torch.empty(x.numel() + 1, dtype=dt, device="cuda")[1:].view(x.shape)
            off.copy_(x)
            check_equal(f"window_sum {(n_, l_, v_, c_, gamma, s)} {str(dt)[6:]} misaligned",
                        window_sum(off, gamma, s), window_sum_plain(x, gamma, s))
    print(f"  window_sum: the plain version's bits at {len(RAGGED_WS)} ragged shapes, both "
          f"directions, fp32 and bf16, and misaligned", flush=True)
    x = rnd(N_BATCH, L_BATCH, 25, 256)
    check_repeatable("window_sum", lambda: (window_sum(x, 69, 1), window_sum(x, 69, 2, True)))


def gamma69_phase(cfg):
    """RT-ST-GCN at Gamma = 69 (CONFIG_69), full width, random weights from
    the config's seed. Every layer's halo is past the fused kernel's limit,
    so with set_rt_fused on or off a batch forward launches gcn_core and
    window_sum only; its logits against the all-plain run. One unfused train
    step of N_TRAIN x L_TRAIN frames: its launches, peak memory, and first
    step gradients against the all-plain run in float64. Returns the launch
    counts of the forward and the train step."""
    import numpy as np
    import torch

    from stgx_torch.config import build_model
    from stgx_torch.ops.rt_fused import set_rt_fused
    from stgx_torch.parallel.loop import OptimizerConfig, Trainer
    from stgx_torch.utils import LOSS

    model = build_model(cfg, NUM_CLASSES)
    n = len(model.layers)
    check(model.kernel == 69, f"{CONFIG_69}: Gamma {model.kernel}")
    rng = np.random.default_rng(SEED + 5)
    x = torch.tensor(rng.normal(size=(N_BATCH, L_BATCH, model.num_joints, model.in_feat)),
                     dtype=torch.float32, device="cuda")
    none = {k: 0 for k in counts()}
    parts, ys = {}, {}
    with torch.inference_mode():
        for fused in (False, True):
            set_rt_fused(fused)
            name = "fused" if fused else "unfused"
            reset_counts()
            ys[name] = model(x)
            torch.cuda.synchronize()
            parts[name] = counts()
            check(parts[name] == {**none, "gcn_core": n, "window_sum": n},
                  f"Gamma=69 batch forward ({name} asked) launched {parts[name]}")
        set_rt_fused(False)
        before = counts()
        with plain_ops():
            y_plain = model(x)
        check(counts() == before, "the plain reference run launched a kernel")
        for name, y in ys.items():
            check(y.shape == (N_BATCH, L_BATCH, NUM_CLASSES), f"shape {tuple(y.shape)}")
            check(bool(torch.isfinite(y).all()), f"Gamma=69 batch form {name}: non-finite")
            err, rel = rel_err(y, y_plain)
            print(f"Gamma=69 batch form ({name} asked) vs all-plain: max abs err {err:.3e} "
                  f"(relative {rel:.3e}, tolerance {TOL_MODEL:g}); launches "
                  f"{json.dumps(parts[name])}", flush=True)
            check(rel <= TOL_MODEL, f"Gamma=69 batch form {name}: relative error {rel:.3e}")
        ms = time_ms(lambda: model(x), reps=5, warm=1)
        with plain_ops():
            plain_ms = time_ms(lambda: model(x), reps=5, warm=1)
    print(f"Gamma=69 batch form forward, N={N_BATCH} x L={L_BATCH}, fp32: {ms:.3f} ms "
          f"({N_BATCH * L_BATCH / ms * 1e3:.0f} frames/s); all-plain {plain_ms:.3f} ms",
          flush=True)

    # one unfused train step, every trial full length
    trainer = Trainer(model=model, kind="frame",
                      loss=LOSS["rt-st-gcn"](np.ones(NUM_CLASSES, np.float32)),
                      opt=OptimizerConfig(learning_rate=cfg["optimizer"]["learning_rate"],
                                          batch_size=N_TRAIN, seed=SEED),
                      bucket=L_TRAIN, trial_batch=N_TRAIN)
    xt = torch.tensor(rng.normal(size=(N_TRAIN, L_TRAIN, model.num_joints, model.in_feat)),
                      dtype=torch.float32, device="cuda")
    yt = torch.tensor(rng.integers(0, NUM_CLASSES, size=(N_TRAIN, L_TRAIN)), device="cuda")
    batch = (xt, yt, torch.ones((N_TRAIN, L_TRAIN), dtype=torch.float32, device="cuda"))
    before = counts()
    exact = float64_grads(trainer, batch)
    with plain_ops():
        ref = first_step_grads(trainer, batch)
    check(counts() == before, "the all-plain training steps launched a kernel")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    got = first_step_grads(trainer, batch)
    torch.cuda.synchronize()
    parts["train"] = counts()
    peak = torch.cuda.max_memory_allocated()
    want = {**none, "gcn_core": 2 * n, "gcn_grads": n, "window_sum": 2 * n}
    print(f"Gamma=69 train step, {N_TRAIN} x {L_TRAIN} frames: launches "
          f"{json.dumps(parts['train'])}; peak device memory {peak / 2**20:.1f} MiB",
          flush=True)
    check(parts["train"] == want, f"Gamma=69 train step launched {parts['train']}, want {want}")
    check(all(bool(torch.isfinite(g).all()) for g in got.values()),
          "Gamma=69 train: non-finite gradients")
    worst, plain32 = worst_grad_err(got, exact), worst_grad_err(ref, exact)
    print(f"Gamma=69 train: first-step gradients vs all-plain float64, worst relative error "
          f"{worst[0]:.3e} ({worst[1]}, tolerance {TOL_GRAD:g}); the fp32 all-plain run's "
          f"{plain32[0]:.3e} ({plain32[1]}); kernels vs fp32 all-plain "
          f"{worst_grad_err(got, ref)[0]:.3e}", flush=True)
    errs = sorted(((grad_err(got[k], exact[k]), grad_err(ref[k], exact[k]), k) for k in exact),
                  reverse=True)
    for e_k, e_p, k in errs[:5]:
        print(f"  {k}: kernels {e_k:.3e}, fp32 all-plain {e_p:.3e} from float64", flush=True)
    check(worst[0] <= TOL_GRAD, f"Gamma=69 train: gradient {worst[1]} off by {worst[0]:.3e}")
    for e_k, e_p, k in errs:
        check(e_k <= GRAD_VS_PLAIN * e_p + TOL_FORMS,
              f"Gamma=69 train: gradient {k} {e_k:.3e} from float64, the fp32 all-plain run "
              f"only {e_p:.3e}")
    return parts


def gamma69_throughput_phase(cfg):
    """train_throughput at Gamma = 69, 8 x 1024 frames, fp32 and bf16, and
    window_sum's share of the device time of a step (a profile of every
    kernel of train_throughput's step)."""
    import numpy as np

    from stgx_torch.bench import train_throughput
    from stgx_torch.config import build_model
    from stgx_torch.parallel.loop import OptimizerConfig, Trainer
    from stgx_torch.utils import LOSS

    records = []
    for dtype in ("float32", "bfloat16"):
        rec = train_throughput.main(["--config", CONFIG_69, "--dtype", dtype, "--trials",
                                     str(N_TRAIN), "--frames", str(L_TRAIN), "--profile"])
        trainer = Trainer(model=build_model(cfg, NUM_CLASSES), kind="frame",
                          loss=LOSS["rt-st-gcn"](np.ones(NUM_CLASSES, np.float32)),
                          opt=OptimizerConfig(learning_rate=1e-4), compute_dtype=dtype)
        prof = train_throughput.profile_steps(
            train_throughput.make_step(trainer, N_TRAIN, L_TRAIN), top=None)
        window = sum(t["ms"] for t in prof["top_kernels"] if "window_kernel<" in t["name"])
        rec["window_share"] = window / prof["device_busy_ms_per_step"]
        records.append(rec)
    return records


# ---------------------------------------------------------------- Shift-GCN


def shift_shapes(cfg):
    """``{(L, C, stride): launches per forward}`` of the temporal shift in a
    Shift-GCN forward of W-frame windows: two per unit, the second with the
    unit's stride."""
    from stgx_torch.config import build_model

    model = build_model(cfg, NUM_CLASSES, device="cpu")
    shapes, l = {}, cfg["arch"]["receptive_field"]
    for unit in model.units:
        c = unit.temporal.shift_in.shape[0]
        shapes[(l, c, 1)] = shapes.get((l, c, 1), 0) + 1
        shapes[(l, c, unit.stride)] = shapes.get((l, c, unit.stride), 0) + 1
        l = -(-l // unit.stride)
    return shapes


def shift_kernel_phase(shapes):
    """The temporal_shift kernel against its plain version at each shape of
    the Shift-GCN forward, SG_WINDOWS windows, fp32 and bf16, with shifts
    that are integers, negative, fractional, exactly +-8 and beyond +-8.
    Returns its record of the ``kernels`` line: times and bounds summed over
    one forward's launches (each shape times its launches)."""
    import numpy as np
    import torch

    from stgx_torch.ops.shift import (
        temporal_shift,
        temporal_shift_bwd,
        temporal_shift_plain,
        temporal_shift_vjp_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rng = np.random.default_rng(SEED)
    cases = [0.0, 1.0, -2.0, 3.0, 0.25, -0.75, 2.5, -3.3, 8.0, -8.0, 9.7, -12.0, 7.6,
             -7.9, 0.5, 5.01]
    recs = {}
    print("temporal_shift vs plain (csrc/temporal_shift.cu)", flush=True)
    for (l, c, s), count in shapes.items():
        shift = rng.uniform(-10.0, 10.0, size=c).astype(np.float32)
        shift[: len(cases)] = cases
        shift = torch.tensor(shift, device="cuda")
        x32 = torch.randn(SG_WINDOWS, l, 25, c, generator=gen, device="cuda")
        shape = (SG_WINDOWS, l, 25, c, s)
        errs = {}
        for dt, tol in ((torch.float32, TOL_FP32), (torch.bfloat16, TOL_BF16)):
            x = x32.to(dt)
            errs[dt] = compare("temporal_shift", shape, lambda: temporal_shift(x, shift, s),
                               lambda: temporal_shift_plain(x, shift, s), str(dt)[6:], tol)
            check_repeatable("temporal_shift", lambda: (temporal_shift(x, shift, s),))
        ms = time_ms(lambda: temporal_shift(x32, shift, s))
        plain_ms = time_ms(lambda: temporal_shift_plain(x32, shift, s))
        lo = -(-l // s)
        # one read of x and of the shifts, one write of y; 3 operations an
        # output (two products, one add, not fused)
        nbytes = 4 * (SG_WINDOWS * 25 * c * (l + lo) + c)
        b = bound(nbytes, 0, instr=3 * SG_WINDOWS * lo * 25 * c)
        print(f"  x {count} launches per forward", flush=True)
        add_record(recs, "temporal_shift", shape, errs[torch.float32], count * ms,
                   count * plain_ms, None, tuple(count * t for t in b))

        # the backward kernel at a train step's SG_THROUGHPUT_WINDOWS windows
        n = SG_THROUGHPUT_WINDOWS
        x32, g32 = x32[:n], torch.randn(n, lo, 25, c, generator=gen, device="cuda")
        shape = (n, l, 25, c, s)
        err = 0.0
        for dt, tol in ((torch.float32, TOL_FP32), (torch.bfloat16, TOL_BF16)):
            x, g, sh = x32.to(dt), g32.to(dt), shift.to(dt)
            gx, gs = temporal_shift_bwd(x, sh, g, s)
            ref_gx, ref_gs = temporal_shift_vjp_plain(x, sh, g, s)
            check_equal(f"temporal_shift_bwd {shape} {str(dt)[6:]} gx", gx, ref_gx)
            e, rel = rel_err(gs, ref_gs)
            print(f"  temporal_shift_bwd {shape} {str(dt)[6:]}: gx the plain version's bits; "
                  f"g_shift max abs err {e:.3e} (relative {rel:.3e}, tolerance {tol:g})",
                  flush=True)
            check(bool(torch.isfinite(gs.float()).all()), "temporal_shift_bwd: non-finite")
            check(rel <= tol, f"temporal_shift_bwd {shape} {dt}: g_shift relative error {rel:.3e}")
            check_repeatable("temporal_shift_bwd", lambda: temporal_shift_bwd(x, sh, g, s))
            if dt == torch.float32:
                err = e
        ms = device_ms(lambda: temporal_shift_bwd(x32, shift, g32, s))
        plain_ms = device_ms(lambda: temporal_shift_vjp_plain(x32, shift, g32, s), calls=3)
        # one read of g and x, one write of gx (and the shifts, g_shift);
        # 3 operations an input element (gx), 3 an output (g_shift's product,
        # difference and add)
        nbytes = 4 * (n * 25 * c * (lo + 2 * l) + 2 * c)
        b = bound(nbytes, 0, instr=3 * n * 25 * c * (l + lo))
        add_record(recs, "temporal_shift_bwd", shape, err, count * ms, count * plain_ms, None,
                   tuple(count * t for t in b))
    return recs


def shift_serving_phase(cfg):
    """Shift-GCN serving with the counters at zero: the offline forward of
    SG_WINDOWS windows and the window streaming cell at B = 1, each against
    its all-plain run; under LayerNorm the streamed logits against the
    offline ones. Returns the launch counts of the two."""
    import numpy as np
    import torch

    from stgx_torch.bench.streaming import measure_stream_latency
    from stgx_torch.config import build_model, load_config
    from stgx_torch.parallel.segments import sliding_windows

    w = cfg["arch"]["receptive_field"]
    model = build_model(cfg, NUM_CLASSES)
    capture = torch.tensor(np.random.default_rng(SEED + 3).normal(
        size=(1, SG_WINDOWS, model.num_joints, model.in_feat)),
        dtype=torch.float32, device="cuda")
    windows = sliding_windows(capture, w)[0]
    none = {k: 0 for k in counts()}
    parts = {}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    with torch.inference_mode():
        y = model(windows)
        torch.cuda.synchronize()
    parts["offline"] = counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"Shift-GCN offline forward, {SG_WINDOWS} windows of {w} frames: launches "
          f"{json.dumps(parts['offline'])}; peak device memory {peak / 2**20:.1f} MiB "
          f"({(peak - base) / 2**20:.1f} MiB above the model and input)", flush=True)
    check(parts["offline"] == {**none, "temporal_shift": 20},
          f"Shift-GCN offline forward launched {parts['offline']}, want 20 temporal_shift")
    with torch.inference_mode(), plain_ops():
        y_plain = model(windows)
    check(y.shape == (SG_WINDOWS, NUM_CLASSES), f"Shift-GCN logits shape {tuple(y.shape)}")
    check(bool(torch.isfinite(y).all()), "Shift-GCN offline forward: non-finite logits")
    err, rel = rel_err(y, y_plain)
    print(f"Shift-GCN offline forward vs all-plain: max abs err {err:.3e} (relative "
          f"{rel:.3e}, tolerance {TOL_MODEL:g})", flush=True)
    check(rel <= TOL_MODEL, f"Shift-GCN offline forward: relative error {rel:.3e}")
    with torch.inference_mode():
        ms = time_ms(lambda: model(windows), reps=5, warm=1)
        with plain_ops():
            plain_ms = time_ms(lambda: model(windows), reps=5, warm=1)
    print(f"Shift-GCN offline forward, {SG_WINDOWS} windows, fp32: {ms:.3f} ms "
          f"({SG_WINDOWS / ms * 1e3:.0f} windows/s); all-plain {plain_ms:.3f} ms", flush=True)

    # the window streaming cell, B = 1, 20 warm-up steps
    frames = capture[0, :SG_STREAM]
    reset_counts()
    mean, p50, p99, logits = measure_stream_latency(model, frames, window=w)
    parts["streaming"] = counts()
    logits = torch.as_tensor(logits)
    steps = 20 + SG_STREAM
    check(parts["streaming"] == {**none, "temporal_shift": 20 * steps},
          f"window cell launched {parts['streaming']}, want {20 * steps} temporal_shift")
    with plain_ops():
        _, plain_p50, _, logits_plain = measure_stream_latency(model, frames, window=w)
    logits_plain = torch.as_tensor(logits_plain)
    check(bool(torch.isfinite(logits).all()), "window cell: non-finite logits")
    err, rel = rel_err(logits, logits_plain)
    print(f"Shift-GCN window cell B=1 x {SG_STREAM} frames vs all-plain: max abs err "
          f"{err:.3e} (relative {rel:.3e}, tolerance {TOL_MODEL:g}); step mean {mean:.4f} "
          f"ms, p50 {p50:.4f} ms, p99 {p99:.4f} ms; all-plain p50 {plain_p50:.4f} ms",
          flush=True)
    check(rel <= TOL_MODEL, f"window cell: relative error {rel:.3e}")

    # LayerNorm takes no batch statistics: frame t streamed == window t offline
    ln = build_model(load_config(SG_CONFIG, ["arch.normalization=LayerNorm"]), NUM_CLASSES)
    with torch.inference_mode():
        y_off = ln(windows[:SG_LN_FRAMES])
    _, _, _, y_stream = measure_stream_latency(ln, frames[:SG_LN_FRAMES], warmup=1, window=w)
    err, rel = rel_err(torch.as_tensor(y_stream), y_off.cpu())
    print(f"LayerNorm Shift-GCN streamed == offline windows, {SG_LN_FRAMES} frames: max "
          f"abs err {err:.3e} (relative {rel:.3e}, tolerance {TOL_MODEL:g})", flush=True)
    check(rel <= TOL_MODEL, f"window cell != offline windows under LayerNorm: {rel:.3e}")
    return parts


def float64_window_grads(trainer, chunk, divisor):
    """A window-kind first step's parameter gradients in float64: a copy of
    the model and the chunk in float64 through the all-plain path, with the
    loss and divisor of ``first_step_grads``."""
    import copy

    import torch

    model = copy.deepcopy(trainer.model).double()
    x, y, mask = chunk
    with plain_ops():
        out = model(x.double(), mask=mask[:, None].expand(x.shape[0], x.shape[1]),
                    train=True)[None]
        ce, mse = trainer.loss(out, y[None], mask[None])
        ((ce + mse) / divisor).backward()
    grads = {k: p.grad.detach() for k, p in model.named_parameters()}
    check(all(g.dtype == torch.float64 for g in grads.values()),
          "the float64 witness lost its precision")
    return grads


def shift_training_phase(cfg, data_dir):
    """The window-kind training path at full width: synthetic PKU-MMD trials
    through the Trainer in chunks of SG_SEGMENT windows. Checks 20 launches
    a chunk step, the first step's gradients against the all-plain run in
    float64 and a falling CE; returns the launch counts."""
    import numpy as np
    import torch

    from stgx_torch.config import build_model
    from stgx_torch.data import SkeletonDirDataset, class_distribution
    from stgx_torch.data.synth import generate
    from stgx_torch.parallel.loop import OptimizerConfig, Trainer
    from stgx_torch.utils import LOSS

    generate(data_dir, skeleton="pku-mmd", num_classes=NUM_CLASSES, in_feat=3,
             num_train=SG_TRIALS, num_val=0, min_len=SG_LEN[0], max_len=SG_LEN[1],
             seed=SEED + 1)
    ds = SkeletonDirDataset(os.path.join(data_dir, "train", "features"),
                            os.path.join(data_dir, "train", "labels"))
    trainer = Trainer(model=build_model(cfg, NUM_CLASSES), kind="window",
                      loss=LOSS["shift-gcn"](class_distribution(ds, NUM_CLASSES)),
                      opt=OptimizerConfig(learning_rate=cfg["optimizer"]["learning_rate"],
                                          batch_size=SG_BS, seed=SEED),
                      receptive_field=cfg["arch"]["receptive_field"], segment=SG_SEGMENT,
                      bucket=SG_SEGMENT)
    chunks = [len(trainer.chunks(*trainer.prepare(*ds[i]))) for i in range(len(ds))]
    chunk0 = trainer.chunks(*trainer.prepare(*ds[0]))[0]
    divisor = float(SG_BS * chunks[0])
    before = counts()
    exact = float64_window_grads(trainer, chunk0, divisor)
    with plain_ops():
        ref = first_step_grads(trainer, chunk0, divisor)
    check(counts() == before, "the all-plain training steps launched a kernel")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    got = first_step_grads(trainer, chunk0, divisor)
    peak = torch.cuda.max_memory_allocated()
    print(f"Shift-GCN train step, one chunk of {chunk0[0].shape[0]} windows: peak device "
          f"memory {peak / 2**20:.1f} MiB", flush=True)
    check(all(bool(torch.isfinite(g).all()) for g in got.values()),
          "Shift-GCN train: non-finite gradients")
    # a bias added just before a batch norm (the spatial block's, its
    # down-projection's, the residual conv's) has a zero gradient in exact
    # arithmetic: held to zero at the model's gradient scale, not its own
    zero = sorted(k for k in exact if k.endswith(("spatial.bias", "down_bias", "res_bias")))
    scale = max(g.abs().max().item() for g in exact.values())
    noise = max((got[k].abs().max().item() / scale, k) for k in zero)
    print(f"Shift-GCN train: {len(zero)} gradients that are zero in exact arithmetic, "
          f"largest {noise[0]:.3e} of the model's largest gradient ({noise[1]}, "
          f"tolerance {TOL_GRAD:g})", flush=True)
    check(noise[0] <= TOL_GRAD, f"Shift-GCN train: gradient {noise[1]} is {noise[0]:.3e}")
    got, ref, exact = ({k: v for k, v in d.items() if k not in zero} for d in (got, ref, exact))
    worst = worst_grad_err(got, exact)
    plain32 = worst_grad_err(ref, exact)
    print(f"Shift-GCN train: first-step gradients vs all-plain float64, worst relative "
          f"error {worst[0]:.3e} ({worst[1]}, tolerance {TOL_GRAD_SG:g}); the fp32 all-plain "
          f"run's {plain32[0]:.3e} ({plain32[1]}); kernels vs fp32 all-plain "
          f"{worst_grad_err(got, ref)[0]:.3e}", flush=True)
    errs = sorted(((grad_err(got[k], exact[k]), grad_err(ref[k], exact[k]), k)
                   for k in exact), reverse=True)
    for e_k, e_p, k in errs[:5]:
        print(f"  {k}: kernels {e_k:.3e}, fp32 all-plain {e_p:.3e} from float64", flush=True)
    check(worst[0] <= TOL_GRAD_SG,
          f"Shift-GCN train: gradient {worst[1]} off by {worst[0]:.3e}")
    for e_k, e_p, k in errs:
        check(e_k <= GRAD_VS_PLAIN * e_p + TOL_FORMS,
              f"Shift-GCN train: gradient {k} {e_k:.3e} from float64, the fp32 all-plain "
              f"run only {e_p:.3e}")

    ce0 = trainer.evaluate(ds)["ce"]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    ces = [trainer.train_epoch(ds, epoch)["ce"] for epoch in range(SG_EPOCHS)]
    torch.cuda.synchronize()
    launched = counts()
    secs = time.perf_counter() - t0
    ce1 = trainer.evaluate(ds)["ce"]
    steps = SG_EPOCHS * sum(chunks)
    print(f"Shift-GCN train: {SG_EPOCHS} epochs x {SG_TRIALS} trials ({chunks} chunks of "
          f"{SG_SEGMENT} windows, {steps} chunk steps) in {secs:.2f} s; epoch CE "
          f"{np.round(ces, 4).tolist()}; eval CE {ce0:.4f} -> {ce1:.4f}; launches "
          f"{json.dumps(launched)}", flush=True)
    check(np.isfinite(ces).all() and ce1 < ce0, "Shift-GCN train: CE did not fall")
    want = {**{k: 0 for k in launched}, "temporal_shift": 20 * steps,
            "temporal_shift_bwd": 20 * steps}
    check(launched == want, f"Shift-GCN train: launches {launched}, want {want}")
    return launched


def shift_throughput_phase():
    """train_throughput for Shift-GCN, SG_THROUGHPUT_WINDOWS windows a step,
    fp32 and bf16."""
    from stgx_torch.bench import train_throughput

    return [train_throughput.main(["--config", SG_CONFIG, "--trials",
                                   str(SG_THROUGHPUT_WINDOWS), "--dtype", dtype, "--profile"])
            for dtype in ("float32", "bfloat16")]


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

    # each kernel against its plain version, at the main paths' shapes
    t_phase = time.perf_counter()
    shape_model = build_model(cfg, NUM_CLASSES)
    recs = kernel_phase(shape_model, layers)
    phase_done("forward kernels vs plain", t_phase)
    t_phase = time.perf_counter()
    recs.update(backward_kernel_phase(shape_model, layers))
    phase_done("backward kernels vs plain", t_phase)

    # the serving path, with the launch counters at zero
    t_phase = time.perf_counter()
    model, x, y_unfused, y_fused, records, parts, launched = main_path(cfg)
    n = len(layers)
    steps = 2 * (WARMUP_STEPS + L_STREAM)  # serving ran B = 1 and B = B_STREAM
    none = {k: 0 for k in counts()}
    print(f"launches on the serving path: {json.dumps(parts)}", flush=True)
    check(parts["unfused"] == {**none, "gcn_core": n, "window_sum": n},
          f"unfused batch forward launched {parts['unfused']}")
    check(parts["fused"] == {**none, "rt_fused": n},
          f"fused batch forward launched {parts['fused']}")
    check(parts["serving"] == {**none, "gcn_core": n * steps},
          f"serving launched {parts['serving']}, want {n * steps} gcn_core")

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
    del ln, model, shape_model
    phase_done("serving path", t_phase)

    # the training path, with the launch counters at zero for each form.
    # Every layer's input needs a gradient (fcn_in comes before layer 0),
    # so the unfused backward launches gcn_core for gx in every layer; a
    # layer whose input needed none would skip that launch.
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as data_dir:
        trained = training_phase(cfg, data_dir)
    phase_done("training path", t_phase)
    for part in trained.values():
        launched = {k: launched[k] + part[k] for k in launched}
    check(all(v > 0 for k, v in launched.items() if not k.startswith("temporal_shift")),
          f"an RT-ST-GCN kernel never launched: {launched}")

    t_phase = time.perf_counter()
    throughput = throughput_phase()
    phase_done("train throughput", t_phase)
    smi_now = smi_line()
    for rec in throughput:
        print(f"train step {rec['dtype']} {'fused' if rec['fused'] else 'unfused'}, "
              f"{rec['trials']} x {rec['frames']} frames: p50 {rec['step_ms_p50']:.3f} ms, "
              f"{rec['frames_per_s']:.0f} frames/s, {rec['model_tflops']:.3f} model "
              f"TFLOP/s ({100 * rec['peak_share']:.2f} % of peak) [{smi_now}]", flush=True)

    # RT-ST-GCN at Gamma = 69: window_sum at its shapes, then the batch
    # forward and a train step with the counters at zero
    t_phase = time.perf_counter()
    gamma69_kernel_phase(recs, layers)
    cfg69 = load_config(CONFIG_69)
    for part in gamma69_phase(cfg69).values():
        launched = {k: launched[k] + part[k] for k in launched}
    g69_throughput = gamma69_throughput_phase(cfg69)
    smi_now = smi_line()
    for rec in g69_throughput:
        prof = rec["profile"]
        print(f"Gamma=69 train step {rec['dtype']}, {rec['trials']} x {rec['frames']} frames: "
              f"p50 {rec['step_ms_p50']:.3f} ms, {rec['frames_per_s']:.0f} frames/s, device "
              f"busy {100 * prof['busy_share']:.1f} %, window_sum "
              f"{100 * rec['window_share']:.1f} % of device time [{smi_now}]", flush=True)
    phase_done("Gamma=69", t_phase)

    # Shift-GCN: its kernel against the plain version, then its serving and
    # training paths, each with the launch counters at zero
    sg_cfg = load_config(SG_CONFIG)
    t_phase = time.perf_counter()
    recs.update(shift_kernel_phase(shift_shapes(sg_cfg)))
    phase_done("temporal_shift vs plain", t_phase)
    t_phase = time.perf_counter()
    sg_parts = shift_serving_phase(sg_cfg)
    phase_done("Shift-GCN serving path", t_phase)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as data_dir:
        sg_parts["train"] = shift_training_phase(sg_cfg, data_dir)
    phase_done("Shift-GCN training path", t_phase)
    for part in sg_parts.values():
        launched = {k: launched[k] + part[k] for k in launched}
    check(all(v > 0 for v in launched.values()), f"a kernel never launched: {launched}")
    t_phase = time.perf_counter()
    sg_throughput = shift_throughput_phase()
    phase_done("Shift-GCN train throughput", t_phase)
    smi_now = smi_line()
    for rec in sg_throughput:
        print(f"Shift-GCN train step {rec['dtype']}, {rec['trials']} windows of "
              f"{rec['frames']} frames: p50 {rec['step_ms_p50']:.3f} ms, "
              f"{rec['frames_per_s']:.0f} windows/s [{smi_now}]", flush=True)

    # the kernels line
    meta = {
        "gcn_core": ("stgx_torch/csrc/gcn_core.cu", "stgx/ops/pallas_gcn.py:76"),
        "window_sum": ("stgx_torch/csrc/window_sum.cu", "stgx/ops/pallas_acc.py:60"),
        "rt_fused": ("stgx_torch/csrc/rt_fused.cu", "stgx/ops/rt_fused.py:122"),
        "gcn_grads": ("stgx_torch/csrc/gcn_grads.cu", "stgx/ops/pallas_gcn.py:137"),
        "rt_fused_bwd": ("stgx_torch/csrc/rt_fused_bwd.cu", "stgx/ops/rt_fused.py:217"),
        "temporal_shift": ("stgx_torch/csrc/temporal_shift.cu", "stgx/ops/shift.py:96"),
        # no TPU kernel: the JAX VJP of the shift (_ts_bwd) is XLA
        "temporal_shift_bwd": ("stgx_torch/csrc/temporal_shift.cu", "stgx/ops/shift.py:149"),
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
            **{k: v for k, v in r.items() if not k.startswith("_") and k not in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")},
        })
    print("kernel times are summed over the 9 layers at fp32: the forward kernels at "
          f"one batch forward's shapes (N={N_BATCH}, L={L_BATCH}), the backward ones at "
          f"one train step's (N={N_TRAIN}, L={L_TRAIN}); temporal_shift over the 20 "
          f"launches of one Shift-GCN forward of {SG_WINDOWS} windows; launches are those "
          f"of the serving and training paths of both models; gcn_core and gcn_grads "
          f"also give their fp32 route's bound and their bf16 times and bound, rt_fused "
          f"and rt_fused_bwd the port's unfused kernels for the same function "
          f"(unfused_ms) and their bf16 times and bound",
          flush=True)
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
