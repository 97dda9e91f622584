"""Train-step throughput on the card — the port of
``stgx/bench/train_throughput.py`` for ``rt-st-gcn`` and ``co-st-gcn`` (the
``frame`` kind), ``st-gcn``, ``shift-gcn`` and ``shift-gcn++`` (the
``window`` kind; Shift-GCN++ at epoch 0, the distillation loss added).

One train step is the :class:`~stgx_torch.parallel.loop.Trainer`'s: forward,
loss, backward through the hand-written kernels and an Adam update, on
random inputs and labels from a seed with an all-ones mask. A frame-kind
step takes ``--trials`` stacked trials of ``--frames`` frames each; a
window-kind step takes ``--trials`` windows of the config's receptive field
W (``--frames`` is unused), and since one window classifies one frame,
windows/s is frames/s, as in the JAX package. Each step is timed with CUDA
events after ``WARMUP`` steps; the median of ``STEPS`` steps is the step
time. For RT-ST-GCN, CoST-GCN and ST-GCN the report also gives the
model's TFLOP/s (MACs a frame, or a window, from
:mod:`stgx_torch.utils.flops`, ×3 for forward and backward, 2 flops a MAC)
as a share of the H100's peak for the compute type (``peak_share``), and
the least device-memory traffic of a step at that rate as a share of the
H100's bandwidth (``hbm_share``: RT-ST-GCN's bytes a frame, ST-GCN's a
window, CoST-GCN's as an ST-GCN window of one frame with no stride, as the
JAX package counts them); the JAX package counts neither for Shift-GCN, so
there they are null.

The record also gives the peak device memory of the timed steps
(``peak_mib``). ``--remat`` trains with ``arch.remat`` (each layer
recomputed in the backward pass), as ``--set arch.remat=true`` does.
:func:`make_step` and :func:`measure_train_throughput` also take the JAX
package's ablation knobs: ``fwd_only`` (forward and loss only, no backward
or Adam) and ``use_mask=False`` (``mask=None`` end to end).

Run (on the card):
    python -m stgx_torch.bench.train_throughput [--model co-st-gcn] [--dtype bfloat16]
        [--fused] [--remat] [--profile]
    python -m stgx_torch.bench.train_throughput \
        --config configs/pku-mmd/as_is/shiftgcn.json --trials 256 [--dtype bfloat16]
    python -m stgx_torch.bench.train_throughput --model st-gcn --trials 256
    python -m stgx_torch.bench.train_throughput \
        --config configs/pku-mmd/as_is/shiftgcn_plus.json \
        --set arch.receptive_field=52 --trials 256 [--dtype bfloat16] [--profile]

``--model`` picks the family's canonical config (RT-ST-GCN₉ or CoST-GCN₉ at
their PKU-MMD widths) unless ``--config`` names another; ``--set
group.key=value`` overrides it as the CLI's does.

Prints one JSON line. With ``--profile`` a second line says where a step's
device time goes: ``torch.profiler`` over a separate window of steps, the
device time of each kernel a step launches, summed by name, and the device's
busy share of the profiled window.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from stgx_torch import strict_numerics
from stgx_torch.config import FAMILY_CONFIGS, build_model, load_config
from stgx_torch.ops.rt_fused import set_rt_fused
from stgx_torch.parallel.loop import MODEL_EPOCH_ARG, MODEL_KIND, OptimizerConfig, Trainer
from stgx_torch.utils import LOSS
from stgx_torch.utils.flops import (
    costgcn_macs_per_frame,
    rt_stgcn_macs_per_frame,
    rt_stgcn_train_hbm_bytes_per_frame,
    stgcn_macs_per_window,
    stgcn_train_hbm_bytes_per_window,
)

__all__ = ["step_inputs", "make_step", "step_fn", "trainer_for", "measure_train_throughput",
           "profile_steps", "rooflines", "main", "H100_PEAK_FLOPS", "H100_HBM_BYTES_S"]

NUM_CLASSES = 52  # PKU-MMD's action classes
# H100 SXM, NVIDIA data sheet (dense, 700 W): fp32 outside the tensor cores,
# bf16 on them; HBM3 bandwidth
H100_PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
H100_HBM_BYTES_S = 3.35e12
STEPS, WARMUP = 10, 2  # timed steps (their median is reported), untimed first
PROFILE_STEPS, PROFILE_TOP = 2, 12  # profiled steps, kernels listed
SEED = 0  # of the random trials


def step_inputs(trainer: Trainer, trials: int = 8, frames: int = 1024, use_mask: bool = True):
    """``(x, y, mask)`` of a step on ``trainer``'s device: ``trials`` stacked
    trials of ``frames`` normal frames (window kind: ``trials`` windows, one
    label each), then their labels, drawn from one numpy generator seeded
    ``SEED`` in the JAX package's order; an all-ones mask, or None."""
    model = trainer.model
    device = trainer.device
    rng = np.random.default_rng(SEED)
    x = torch.tensor(rng.normal(size=(trials, frames, model.num_joints, model.in_feat)),
                     dtype=torch.float32, device=device)
    series = (trials,) if trainer.kind == "window" else (trials, frames)
    y = torch.tensor(rng.integers(0, NUM_CLASSES, size=series), device=device)
    mask = torch.ones(series, dtype=torch.float32, device=device) if use_mask else None
    return x, y, mask


def make_step(trainer: Trainer, trials: int = 8, frames: int = 1024, fwd_only: bool = False,
              use_mask: bool = True):
    """One train step of ``trainer`` on :func:`step_inputs`, as
    :func:`step_fn` makes it. Raises on a model that is not on a CUDA
    device: a CPU run is no device measurement."""
    device = trainer.device
    if device.type != "cuda":
        raise RuntimeError("train throughput is a device measurement; the "
                           f"model is on {device}")
    epoch = trainer.epoch_tensor(0) if trainer.pass_epoch else None
    return step_fn(trainer, *step_inputs(trainer, trials, frames, use_mask), epoch, fwd_only)


def step_fn(trainer: Trainer, x, y, mask, epoch=None, fwd_only: bool = False):
    """The step on ``(x, y, mask)``: forward, loss, backward and Adam; with
    ``fwd_only`` the training forward and the loss only, without autograd.
    The step returns the loss's ``(ce, mse)``. ``mask`` None runs the step
    with no mask anywhere."""
    if fwd_only:
        def forward():
            with torch.no_grad():
                out, _ = trainer._outputs(x, mask, True, None, epoch)
                return trainer.loss(out, *trainer._series(y, mask))

        return forward

    def step():
        ce, mse, *_ = trainer.grad_step(x, y, mask, 1.0, None, epoch)
        trainer.optimizer.step()
        trainer.optimizer.zero_grad(set_to_none=True)
        return ce, mse

    return step


def trainer_for(cfg, dtype: str = "float32", device=None) -> Trainer:
    """The :class:`~stgx_torch.parallel.loop.Trainer` a step of ``cfg``'s
    model runs in: its config's model (52 classes) on ``device`` (``cuda``
    if None), the family's loss with unit class weights, Adam at 1e-4,
    ``dtype`` compute, the epoch passed where the family takes it."""
    name = cfg["processor"]["model"]
    return Trainer(
        model=build_model(cfg, NUM_CLASSES, device), kind=MODEL_KIND[name],
        loss=LOSS[name](np.ones(NUM_CLASSES, np.float32)),
        opt=OptimizerConfig(learning_rate=1e-4),
        compute_dtype=dtype,
        receptive_field=cfg["arch"].get("receptive_field", 50),
        pass_epoch=name in MODEL_EPOCH_ARG,
    )


def measure_train_throughput(trainer: Trainer, trials: int = 8, frames: int = 1024,
                             fwd_only: bool = False, use_mask: bool = True,
                             steps: int = STEPS, warmup: int = WARMUP):
    """Time ``steps`` train steps of ``trainer`` on stacked random trials,
    after ``warmup`` untimed ones (``fwd_only`` and ``use_mask`` as
    :func:`make_step`).

    Returns ``(frames_per_s, step_ms_p50, step_ms)``: the median step and
    every step's time. A window-kind step classifies ``trials`` frames.
    """
    step = make_step(trainer, trials, frames, fwd_only, use_mask)
    for _ in range(warmup):
        step()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(steps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(steps)]
    for s, e in zip(starts, ends):
        s.record()
        step()
        e.record()
    torch.cuda.synchronize()
    step_ms = [s.elapsed_time(e) for s, e in zip(starts, ends)]
    p50 = float(np.median(step_ms))
    per_step = trials if trainer.kind == "window" else trials * frames
    return per_step / p50 * 1e3, p50, step_ms


def profile_steps(step, top: int | None = PROFILE_TOP) -> dict:
    """Device time of ``PROFILE_STEPS`` calls of ``step`` by kernel name, per
    step (the ``top`` longest, every kernel for None), and the device's busy
    share of the profiled window's wall time."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()  # warm: the profiled window holds no first-call work
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [
        (e.key, e.self_device_time_total / 1e3 / PROFILE_STEPS, e.count / PROFILE_STEPS)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    kernels.sort(key=lambda k: -k[1])
    busy = sum(k[1] for k in kernels)
    return {
        "profiled_steps": PROFILE_STEPS,
        "device_busy_ms_per_step": busy,
        "wall_ms_per_step": wall_ms / PROFILE_STEPS,
        "busy_share": busy * PROFILE_STEPS / wall_ms,
        "launches_per_step": sum(k[2] for k in kernels),
        "top_kernels": [{"name": n[:120], "ms": ms, "launches": c}
                        for n, ms, c in kernels[:top]],
    }


def rooflines(model, name: str, dtype: str, window: int = 50):
    """``(MACs a frame, least device-memory bytes a trained frame)`` of a
    frame-kind model at its widths (ST-GCN: a window of ``window`` frames,
    which classifies one frame), or ``(None, None)`` for a family the JAX
    package counts neither for."""
    if name not in ("rt-st-gcn", "co-st-gcn", "st-gcn"):
        return None, None
    shape = dict(in_ch=model.in_ch, out_ch=model.out_ch,
                 num_joints=model.num_joints, partitions=model.partitions,
                 in_feat=model.in_feat)
    residual = tuple(int(layer.residual) for layer in model.layers)
    dtype_bytes = 2 if dtype == "bfloat16" else 4
    if name == "st-gcn":
        return (stgcn_macs_per_window(window=window, num_classes=NUM_CLASSES,
                                      kernel=model.kernel, stride=model.stride,
                                      residual=residual, **shape),
                stgcn_train_hbm_bytes_per_window(window=window, kernel=model.kernel,
                                                 stride=model.stride, residual=residual,
                                                 dtype_bytes=dtype_bytes, **shape))
    if name == "rt-st-gcn":
        return (rt_stgcn_macs_per_frame(num_classes=NUM_CLASSES, residual=residual, **shape),
                rt_stgcn_train_hbm_bytes_per_frame(dtype_bytes=dtype_bytes, **shape))
    # continual layers keep every frame: an ST-GCN window of one frame with
    # no stride decimation
    return (costgcn_macs_per_frame(num_classes=NUM_CLASSES, kernel=model.kernel,
                                   residual=residual, **shape),
            stgcn_train_hbm_bytes_per_window(window=1, stride=(1,) * len(model.in_ch),
                                             residual=residual, dtype_bytes=dtype_bytes,
                                             **shape))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default=None, choices=sorted(FAMILY_CONFIGS),
                    help="a family, trained from its canonical config (default rt-st-gcn)")
    ap.add_argument("--config", default=None,
                    help="the model's config (default: the --model family's)")
    ap.add_argument("--dtype", default="float32", choices=sorted(H100_PEAK_FLOPS))
    ap.add_argument("--fused", action="store_true",
                    help="the fused layer core (rt_fused forward and backward kernels)")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each layer in the backward pass (arch.remat)")
    ap.add_argument("--trials", type=int, default=8,
                    help="stacked trials a step (window kind: windows a step)")
    ap.add_argument("--frames", type=int, default=1024,
                    help="frames a trial (frame kind only)")
    ap.add_argument("--profile", action="store_true",
                    help="also print where a step's device time goes")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="GROUP.KEY=VALUE", help="override a config value; repeatable")
    args = ap.parse_args(argv)

    strict_numerics()
    overrides = args.overrides + (["arch.remat=true"] if args.remat else [])
    cfg = load_config(args.config or FAMILY_CONFIGS[args.model or "rt-st-gcn"], overrides)
    name = cfg["processor"]["model"]
    if args.model is not None and name != args.model:
        raise ValueError(f"--model {args.model} but {args.config} configures {name}")
    trainer = trainer_for(cfg, args.dtype)
    model, kind = trainer.model, trainer.kind
    set_rt_fused(args.fused)
    frames = cfg["arch"]["receptive_field"] if kind == "window" else args.frames
    torch.cuda.reset_peak_memory_stats(trainer.device)
    fps, p50, step_ms = measure_train_throughput(trainer, args.trials, frames)
    peak_mib = torch.cuda.max_memory_allocated(trainer.device) / 2**20
    tflops = share = hbm_share = None
    macs, nbytes = rooflines(model, name, args.dtype, frames)
    if macs is not None:
        tflops = fps * 3 * 2 * macs / 1e12
        share = tflops * 1e12 / H100_PEAK_FLOPS[args.dtype]
        hbm_share = fps * nbytes / H100_HBM_BYTES_S
    record = {
        "model": name, "kind": kind, "dtype": args.dtype, "fused": args.fused,
        "remat": bool(cfg["arch"].get("remat", False)), "peak_mib": peak_mib,
        "trials": args.trials, "frames": frames, "steps": STEPS,
        "step_ms_p50": p50, "step_ms_min": min(step_ms), "step_ms_max": max(step_ms),
        "frames_per_s": fps, "model_tflops": tflops, "peak_share": share,
        "hbm_share": hbm_share, "kernel": getattr(model, "kernel", None),
        "device": torch.cuda.get_device_name(trainer.device),
    }
    print(json.dumps(record), flush=True)
    if args.profile:
        prof = profile_steps(make_step(trainer, args.trials, frames))
        print(json.dumps({"profile": prof, "dtype": args.dtype, "fused": args.fused}),
              flush=True)
        record["profile"] = prof
    return record


if __name__ == "__main__":
    main()
