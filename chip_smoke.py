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

The training path follows: synthetic PKU-MMD trials through the port's
``Trainer`` (forward, backward through the ``gcn_grads`` and
``rt_fused_bwd`` kernels and the forward kernels' backward launches, Adam),
unfused and fused, with the exact launches of each step, the first step's
gradients against the all-plain run in float64, and a falling CE; then
``stgx_torch.bench.train_throughput`` at 8 x 1024 frames in fp32 and bf16,
unfused and fused.

Shift-GCN follows, at its PKU-MMD width (``configs/pku-mmd/as_is/shiftgcn.json``,
W = 50, random weights from the config's seed): the ``temporal_shift``
kernel against its plain version at the seven shapes of its 20 launches per
forward; the offline forward of 1024 windows (exactly 20 launches, logits
against the all-plain run); the window streaming cell at B = 1 (20 launches
a step, logits against the all-plain cell; under LayerNorm the streamed
logits of frame t equal the offline logits of window t); the ``window``
``Trainer`` on synthetic trials cut into chunks of ``SG_SEGMENT`` windows
(20 launches a chunk step, the first step's gradients against the all-plain
run in float64, a falling CE); and ``train_throughput`` for Shift-GCN in
fp32 and bf16. Peak device memory of the offline forward and of a train
step is printed. Each phase prints its seconds.

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

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

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
# holds the fused and the unfused kernel runs against each other.
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
    from stgx_torch.ops.shift import temporal_shift
    from stgx_torch.ops.window_sum import window_sum

    return {"gcn_core": gcn_core, "window_sum": window_sum, "rt_fused": rt_fused_core,
            "gcn_grads": gcn_grads, "rt_fused_bwd": rt_fused_bwd,
            "temporal_shift": temporal_shift}


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


def bound(nbytes, flops, dtype="float32"):
    """(bound ms, bytes ms, operations ms) at the H100's peaks."""
    t_b = nbytes / PEAK_BYTES_S * 1e3
    t_o = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_b, t_o), t_b, t_o


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


def check_repeatable(name, kern):
    """Two calls give the same bits: the cross-block sums run in a fixed
    order, with no atomics."""
    import torch

    a, b = kern(), kern()
    check(all(torch.equal(x, y) for x, y in zip(a, b)),
          f"{name}: two calls on the same inputs differ")


def backward_kernel_phase(model, layers):
    """The two backward kernels against their plain versions at the training
    path's shapes (N_TRAIN x L_TRAIN frames, each of the 9 layers), fp32 and
    bf16. Returns their records of the ``kernels`` line."""
    import torch

    from stgx_torch.ops.gcn_grads import gcn_grads, gcn_grads_plain
    from stgx_torch.ops.rt_fused import rt_fused_bwd, rt_fused_bwd_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    v, p, gamma = model.num_joints, model.partitions, model.kernel
    n, l = N_TRAIN, L_TRAIN
    rows = n * l
    recs = {}

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    print("gcn_grads vs plain (csrc/gcn_grads.cu)", flush=True)
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
        nbytes = 4 * (rows * v * (cin + cout) + 2 * (p * v * v + p * cin * cout))
        add_record(recs, "gcn_grads", (rows, v, cin, cout), errs[torch.float32], ms,
                   plain_ms, lib_ms, bound(nbytes, flops))

    print("rt_fused_bwd vs plain (csrc/rt_fused_bwd.cu)", flush=True)
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
        k = gamma // s
        # (gx, gA, gW) at their least work, the window's adds and gbe's sum
        window_adds = n * v * cout * sum(min(k, (l - 1 - t) // s + 1) - 1 for t in range(l))
        flops = (2 * rows * p * v * (2 * cin * cout + 3 * v * cin) + window_adds
                 + rows * v * cout)
        nbytes = 4 * (rows * v * (2 * cin + cout) + 2 * (p * v * v + p * cin * cout)
                      + v * cout)
        add_record(recs, "rt_fused_bwd", (n, l, v, cin, cout, gamma, s), errs[torch.float32],
                   ms, plain_ms, None, bound(nbytes, flops))
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

    from stgx_torch.ops.shift import temporal_shift, temporal_shift_plain

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
        # output (two products, one add)
        nbytes = 4 * (SG_WINDOWS * 25 * c * (l + lo) + c)
        b = bound(nbytes, 3 * SG_WINDOWS * lo * 25 * c)
        print(f"  x {count} launches per forward", flush=True)
        add_record(recs, "temporal_shift", shape, errs[torch.float32], count * ms,
                   count * plain_ms, None, tuple(count * t for t in b))
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
    check(launched == {**{k: 0 for k in launched}, "temporal_shift": 20 * steps},
          f"Shift-GCN train: launches {launched}, want {20 * steps} temporal_shift")
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
    check(all(v > 0 for k, v in launched.items() if k != "temporal_shift"),
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
    print("kernel times are summed over the 9 layers at fp32: the forward kernels at "
          f"one batch forward's shapes (N={N_BATCH}, L={L_BATCH}), the backward ones at "
          f"one train step's (N={N_TRAIN}, L={L_TRAIN}); temporal_shift over the 20 "
          f"launches of one Shift-GCN forward of {SG_WINDOWS} windows; launches are those "
          f"of the serving and training paths of both models", flush=True)
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
