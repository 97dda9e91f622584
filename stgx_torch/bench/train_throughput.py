"""Train-step throughput on the card — the port of
``stgx/bench/train_throughput.py`` for ``rt-st-gcn`` (the ``frame`` kind)
and ``shift-gcn`` (the ``window`` kind).

One train step is the :class:`~stgx_torch.parallel.loop.Trainer`'s: forward,
loss, backward through the hand-written kernels and an Adam update, on
random inputs and labels from a seed with an all-ones mask. A frame-kind
step takes ``--trials`` stacked trials of ``--frames`` frames each; a
window-kind step takes ``--trials`` windows of the config's receptive field
W (``--frames`` is unused), and since one window classifies one frame,
windows/s is frames/s, as in the JAX package. Each step is timed with CUDA
events after ``WARMUP`` steps; the median of ``STEPS`` steps is the step
time. For RT-ST-GCN the report also gives the model's TFLOP/s (from
:func:`stgx_torch.utils.flops.rt_stgcn_macs_per_frame`, ×3 for forward and
backward, 2 flops a MAC) as a share of the H100's peak for the compute
type; the JAX package counts no MACs for Shift-GCN, so there both are null.

Run (on the card):
    python -m stgx_torch.bench.train_throughput [--dtype bfloat16] [--fused] [--profile]
    python -m stgx_torch.bench.train_throughput \
        --config configs/pku-mmd/as_is/shiftgcn.json --trials 256 [--dtype bfloat16]

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

from stgx_torch.config import build_model, load_config
from stgx_torch.ops.rt_fused import set_rt_fused
from stgx_torch.parallel.loop import MODEL_KIND, OptimizerConfig, Trainer
from stgx_torch.utils import LOSS
from stgx_torch.utils.flops import rt_stgcn_macs_per_frame

__all__ = ["make_step", "measure_train_throughput", "profile_steps", "main",
           "H100_PEAK_FLOPS"]

CONFIG = "configs/pku-mmd/as_is/rtstgcn.json"
NUM_CLASSES = 52  # PKU-MMD's action classes
# H100 SXM, NVIDIA data sheet (dense, 700 W): fp32 outside the tensor cores,
# bf16 on them
H100_PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
STEPS, WARMUP = 10, 2  # timed steps (their median is reported), untimed first
PROFILE_STEPS, PROFILE_TOP = 2, 12  # profiled steps, kernels listed
SEED = 0  # of the random trials


def make_step(trainer: Trainer, trials: int = 8, frames: int = 1024):
    """One train step of ``trainer`` on ``trials`` stacked random trials of
    ``frames`` frames (window kind: ``trials`` windows of ``frames`` frames,
    one label each): forward, loss, backward and Adam. Raises on a model
    that is not on a CUDA device: a CPU run is no device measurement."""
    device = trainer.device
    if device.type != "cuda":
        raise RuntimeError("train throughput is a device measurement; the "
                           f"model is on {device}")
    model = trainer.model
    rng = np.random.default_rng(SEED)
    x = torch.tensor(rng.normal(size=(trials, frames, model.num_joints, model.in_feat)),
                     dtype=torch.float32, device=device)
    series = (trials,) if trainer.kind == "window" else (trials, frames)
    y = torch.tensor(rng.integers(0, NUM_CLASSES, size=series), device=device)
    mask = torch.ones(series, dtype=torch.float32, device=device)

    def step():
        trainer.grad_step(x, y, mask, 1.0)
        trainer.optimizer.step()
        trainer.optimizer.zero_grad(set_to_none=True)

    return step


def measure_train_throughput(trainer: Trainer, trials: int = 8, frames: int = 1024):
    """Time ``STEPS`` train steps of ``trainer`` on stacked random trials,
    after ``WARMUP`` untimed ones.

    Returns ``(frames_per_s, step_ms_p50, step_ms)``: the median step and
    every step's time. A window-kind step classifies ``trials`` frames.
    """
    step = make_step(trainer, trials, frames)
    for _ in range(WARMUP):
        step()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(STEPS)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(STEPS)]
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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=CONFIG)
    ap.add_argument("--dtype", default="float32", choices=sorted(H100_PEAK_FLOPS))
    ap.add_argument("--fused", action="store_true",
                    help="the fused layer core (rt_fused forward and backward kernels)")
    ap.add_argument("--trials", type=int, default=8,
                    help="stacked trials a step (window kind: windows a step)")
    ap.add_argument("--frames", type=int, default=1024,
                    help="frames a trial (frame kind only)")
    ap.add_argument("--profile", action="store_true",
                    help="also print where a step's device time goes")
    args = ap.parse_args(argv)

    cfg = load_config(args.config)
    name = cfg["processor"]["model"]
    model = build_model(cfg, NUM_CLASSES)
    set_rt_fused(args.fused)
    kind = MODEL_KIND[name]
    trainer = Trainer(
        model=model, kind=kind,
        loss=LOSS[name](np.ones(NUM_CLASSES, np.float32)),
        opt=OptimizerConfig(learning_rate=1e-4),
        compute_dtype=args.dtype,
    )
    frames = cfg["arch"]["receptive_field"] if kind == "window" else args.frames
    fps, p50, step_ms = measure_train_throughput(trainer, args.trials, frames)
    tflops = share = None
    if name == "rt-st-gcn":
        arch = cfg["arch"].get("rt-st-gcn", {})
        shape = {k: tuple(arch[k]) for k in ("in_ch", "out_ch", "residual") if k in arch}
        macs = rt_stgcn_macs_per_frame(num_joints=model.num_joints,
                                       partitions=model.partitions,
                                       in_feat=model.in_feat, num_classes=NUM_CLASSES,
                                       **shape)
        tflops = fps * 3 * 2 * macs / 1e12
        share = tflops * 1e12 / H100_PEAK_FLOPS[args.dtype]
    record = {
        "model": name, "kind": kind, "dtype": args.dtype, "fused": args.fused,
        "trials": args.trials, "frames": frames, "steps": STEPS,
        "step_ms_p50": p50, "step_ms_min": min(step_ms), "step_ms_max": max(step_ms),
        "frames_per_s": fps, "model_tflops": tflops, "peak_share": share,
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
