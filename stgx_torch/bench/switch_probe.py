"""The port's process-wide switches A/B'd in one process — the port of
``stgx/bench/xla_probe.py``, which A/B'd XLA's scheduler and fusion flags;
the port has no compiler, so its levers are the switches every entry point
sets (:func:`stgx_torch.strict_numerics`) and the routes it picks.

Every variant runs in this one process through :func:`switched`, which
restores every switch of :data:`SWITCHES` when it exits, also when the
variant raises, bracketed by the baseline (``baseline_pre``,
``baseline_post``): what every entry point runs, ``strict_numerics()``
(TF32 off for matmuls and cuDNN, cuDNN's deterministic algorithms),
``conv_route`` as it is and ``rt_fused`` off. The variants:

  tf32                    ``torch.backends.cuda.matmul.allow_tf32`` and
                          ``torch.backends.cudnn.allow_tf32`` on
  cudnn_benchmark         ``torch.backends.cudnn.benchmark`` on, deterministic kept
  cudnn_nondeterministic  ``torch.backends.cudnn.deterministic`` off
  conv_route_cudnn        ``stgx_torch.ops.temporal.conv_route``, where
                          ``temporal_conv`` looks it up, sending every
                          temporal conv to cuDNN's convolution
  conv_route_taps         the same, to the taps (one product a tap)
  rt_fused                ``set_rt_fused(True)``: the fused layer core

Each variant builds the model's Trainer on the same weights (the config's
random init) and reports its first step's gradients on the same batch
against ``baseline_pre``'s: ``grad_dist``, the largest ``|g − g₀|`` over the
leaves as a share of the largest ``|g₀|``, and ``grads_equal``, every leaf
bit for bit; the step's launches by kernel; then, on the card,
``frames_per_s``, ``step_ms`` and ``repeat_spread_pct`` from
:func:`stgx_torch.bench.train_throughput.measure_train_throughput`. The
last line gives the bracket's drift, the best variant and the best against
the baseline, as the JAX tool's. A variant that raises is printed with its
error and the run goes on. A variant whose switch the model never reaches
is left out with its reason (:data:`NOT_RUN_BY`), as is ``conv_route_cudnn``
for a model with a temporal conv past a dilated span of 17 frames, where
cuDNN's heuristics take seconds a layer (``ops/temporal.py::conv_route``);
``--only`` refuses such a variant.

As in the JAX tool, the step is ``--frames`` frames a trial, 8 trials
(ST-GCN: ``--frames // 50`` windows of 50 frames), of the family's
canonical config.

Run (on the card):
    python -m stgx_torch.bench.switch_probe [--model co-st-gcn] [--dtype float32]
        [--frames 1024] [--only baseline_pre,tf32,...]

Prints one JSON line a variant, then the bracket line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import traceback
from dataclasses import replace

import numpy as np
import torch

__all__ = ["SWITCHES", "VARIANTS", "NOT_RUN_BY", "switch_state", "switched", "check_variant",
           "refusal", "probe", "bracket", "main"]

CUDNN_SPAN = 17  # conv_route's longest dilated span for cuDNN


class _Route:
    """``conv_route``'s stand-in: every temporal conv to one route."""

    def __init__(self, route: str):
        self.route = route

    def __call__(self, device_type, dtype, gamma, dilation) -> str:
        return self.route

    def __repr__(self) -> str:
        return f"always {self.route}"


def _temporal():
    import stgx_torch.ops.temporal as temporal

    return temporal


def _rt_fused():
    import stgx_torch.ops.rt_fused as rt_fused

    return rt_fused


# name -> (read it, set it): every switch a variant may set, each restored
# by `switched`
SWITCHES = {
    "cuda.matmul.allow_tf32": (lambda: torch.backends.cuda.matmul.allow_tf32,
                               lambda v: setattr(torch.backends.cuda.matmul, "allow_tf32", v)),
    "cudnn.allow_tf32": (lambda: torch.backends.cudnn.allow_tf32,
                         lambda v: setattr(torch.backends.cudnn, "allow_tf32", v)),
    "cudnn.benchmark": (lambda: torch.backends.cudnn.benchmark,
                        lambda v: setattr(torch.backends.cudnn, "benchmark", v)),
    "cudnn.deterministic": (lambda: torch.backends.cudnn.deterministic,
                            lambda v: setattr(torch.backends.cudnn, "deterministic", v)),
    "conv_route": (lambda: _temporal().conv_route,
                   lambda f: setattr(_temporal(), "conv_route", f)),
    "rt_fused": (lambda: _rt_fused().rt_fused_enabled(), lambda v: _rt_fused().set_rt_fused(v)),
}
VARIANTS = [
    ("baseline_pre", {}),
    ("tf32", {"cuda.matmul.allow_tf32": True, "cudnn.allow_tf32": True}),
    ("cudnn_benchmark", {"cudnn.benchmark": True}),
    ("cudnn_nondeterministic", {"cudnn.deterministic": False}),
    ("conv_route_cudnn", {"conv_route": _Route("cudnn")}),
    ("conv_route_taps", {"conv_route": _Route("taps")}),
    ("rt_fused", {"rt_fused": True}),
    ("baseline_post", {}),
]
_FUSED = "the fused kernels are RT-ST-GCN's layer core"
NOT_RUN_BY = {
    "rt-st-gcn": {"conv_route_cudnn": "RT-ST-GCN has no temporal conv",
                  "conv_route_taps": "RT-ST-GCN has no temporal conv"},
    "co-st-gcn": {"rt_fused": _FUSED},
    "st-gcn": {"rt_fused": _FUSED},
}


def switch_state() -> dict:
    """Every switch of :data:`SWITCHES` as it is now."""
    return {name: get() for name, (get, _) in SWITCHES.items()}


@contextlib.contextmanager
def switched(settings: dict):
    """``settings`` (switch name -> value) in force for the block; every
    switch of :data:`SWITCHES` as it was after it, whatever the block did."""
    saved = switch_state()
    try:
        for name, value in settings.items():
            SWITCHES[name][1](value)
        yield
    finally:
        for name, value in saved.items():
            SWITCHES[name][1](value)


def _span(model) -> int:
    """The longest dilated span ``(Γ − 1)·d + 1`` of the model's temporal
    convs (1 for a model without)."""
    dilation = max(getattr(model, "dilation", None) or (1,))
    return (getattr(model, "kernel", 1) - 1) * dilation + 1


def refusal(name: str, variant: str, model=None) -> str | None:
    """Why ``variant`` is not run for model ``name`` (``model`` its
    instance, for the span), or None."""
    if variant in NOT_RUN_BY[name]:
        return NOT_RUN_BY[name][variant]
    if variant == "conv_route_cudnn" and model is not None and _span(model) > CUDNN_SPAN:
        return (f"a temporal conv spans {_span(model)} frames, past the {CUDNN_SPAN} up to "
                "which cuDNN keeps its implicit-GEMM kernels (its direct ones take seconds a "
                "layer; ops/temporal.py::conv_route)")
    return None


def check_variant(name: str, variant: str, model=None) -> None:
    """Raise ``ValueError`` for an unknown variant, or one :func:`refusal`
    refuses, with the reason."""
    if variant not in dict(VARIANTS):
        raise ValueError(f"switch_probe: unknown variant {variant!r} "
                         f"(have {', '.join(n for n, _ in VARIANTS)})")
    reason = refusal(name, variant, model)
    if reason:
        raise ValueError(f"switch_probe: {variant} is not run for {name}: {reason}")


def _shape(name: str, frames: int):
    """``(trials, frames)`` of a step, as the JAX tool sizes it."""
    return (max(1, frames // 50), 50) if name == "st-gcn" else (8, frames)


def probe(name: str = "rt-st-gcn", dtype: str = "bfloat16", frames: int = 1024,
          only=None, device=None, timed: bool = True, steps: int | None = None,
          warmup: int | None = None, overrides=(), shape=None, emit=None) -> list:
    """Run the variants (``only``: those names, each checked by
    :func:`check_variant`; else every one :func:`refusal` lets through,
    the others recorded as refused) of ``name``'s canonical config
    (``overrides`` as the CLI's ``--set``) on ``device`` (``cuda`` if
    None). ``timed`` needs the card; ``steps`` / ``warmup`` as
    ``measure_train_throughput``'s; ``shape`` ``(trials, frames)`` in place
    of the JAX tool's sizes. Each record is passed to ``emit`` as it is
    made. Returns the records."""
    from stgx_torch import default_device, strict_numerics
    from stgx_torch.bench import train_throughput as tt
    from stgx_torch.bench.traffic_audit import launch_counters
    from stgx_torch.config import FAMILY_CONFIGS, load_config

    device = default_device(device)
    if timed and device.type != "cuda":
        raise RuntimeError(f"switch_probe times train steps on the card; asked for {device}")
    strict_numerics()
    cfg = load_config(FAMILY_CONFIGS[name], list(overrides))
    trainer = tt.trainer_for(cfg, dtype, device)
    model = trainer.model
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    if only is not None:
        for variant in only:
            check_variant(name, variant, model)
    trials, length = shape or _shape(name, frames)
    x, y, mask = tt.step_inputs(trainer, trials, length)
    timing = {k: v for k, v in (("steps", steps), ("warmup", warmup)) if v is not None}
    emit = emit or (lambda rec: None)
    records, base = [], None
    for variant, settings in VARIANTS:
        if only is not None and variant not in only:
            continue
        rec = {"variant": variant, "switches": {k: repr(v) if isinstance(v, _Route) else v
                                                for k, v in settings.items()}}
        reason = refusal(name, variant, model)
        if reason:
            rec["refused"] = reason
        else:
            try:
                with switched(settings):
                    model.load_state_dict(init)
                    trainer = replace(trainer)  # a fresh Adam
                    epoch = trainer.epoch_tensor(0) if trainer.pass_epoch else None
                    before = launch_counters()
                    ce, mse, *_ = trainer.grad_step(x, y, mask, 1.0, None, epoch)
                    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()
                             if p.grad is not None}
                    after = launch_counters()
                    trainer.optimizer.zero_grad(set_to_none=True)
                    rec["loss"] = float(ce) + float(mse)
                    rec["launches"] = {k: after[k] - before[k] for k in after
                                       if after[k] != before[k]}
                    if base is None and variant == "baseline_pre":
                        base = grads
                    if base is not None:
                        rec.update(_grad_dist(grads, base))
                    if timed:
                        fps, p50, samples = tt.measure_train_throughput(
                            trainer, trials, length, **timing)
                        rec.update({
                            "frames_per_s": fps, "step_ms": p50,
                            "repeat_spread_pct": 100.0 * (max(samples) - min(samples))
                            / max(float(np.median(samples)), 1e-9)})
            except Exception as e:  # a variant that fails is a finding, not a crash
                traceback.print_exc(file=sys.stderr)
                rec["error"] = f"{type(e).__name__}: {e}"[:300]
        records.append(rec)
        emit(rec)
    return records


def _grad_dist(grads, base) -> dict:
    """``grad_dist`` (the largest ``|g − g₀|`` over the leaves over the
    largest ``|g₀|``) and ``grads_equal`` (every leaf bit for bit)."""
    scale = max(g.abs().max().item() for g in base.values())
    dist = max((grads[k].float() - g.float()).abs().max().item() for k, g in base.items())
    equal = grads.keys() == base.keys() and all(torch.equal(grads[k], g)
                                                for k, g in base.items())
    return {"grad_dist": dist / max(scale, 1e-30), "grads_equal": equal}


def bracket(records) -> dict | None:
    """The JAX tool's last line: the baseline bracket's drift, the best
    variant by frames/s and the best against the better baseline."""
    rates = {r["variant"]: r["frames_per_s"] for r in records if "frames_per_s" in r}
    if "baseline_pre" not in rates or "baseline_post" not in rates:
        return None
    b0, b1 = rates["baseline_pre"], rates["baseline_post"]
    best = max(rates, key=rates.get)
    return {"baseline_bracket_drift_pct": 100 * abs(b1 - b0) / max(b0, 1e-9),
            "best_variant": best,
            "best_vs_baseline_pct": 100 * (rates[best] / max(b0, b1) - 1)}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="rt-st-gcn", choices=sorted(NOT_RUN_BY))
    ap.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    ap.add_argument("--frames", type=int, default=1024)
    ap.add_argument("--only", default=None, help="comma-list of variant names to run")
    args = ap.parse_args(argv)

    only = args.only.split(",") if args.only else None
    for variant in only or ():
        check_variant(args.model, variant)
    if not torch.cuda.is_available():
        raise RuntimeError("switch_probe times train steps on the card; no CUDA device")
    device = torch.cuda.get_device_name(0)
    records = probe(args.model, args.dtype, args.frames, only,
                    emit=lambda rec: print(json.dumps(dict(rec, device=device)), flush=True))
    line = bracket(records)
    if line is not None:
        print(json.dumps(line), flush=True)
    return records


if __name__ == "__main__":
    main()
