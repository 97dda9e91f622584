"""Subtractive op-cost profile of a train step on the card — the port of
``stgx/bench/ablate.py`` for RT-ST-GCN₉ and ST-GCN at their PKU-MMD widths.

Each variant patches one op to a shape-preserving no-op (or one knob of the
step) for one run of :func:`stgx_torch.bench.train_throughput.
measure_train_throughput`, and reads the op's marginal cost as
``t(full) − t(variant)``. A patch replaces the name where the port looks it
up at call time: several models import functions by name (RT-ST-GCN's
layer takes ``causal_accumulate`` from :mod:`stgx_torch.models.rtstgcn`'s
namespace, every graph conv ``partitioned_gcn`` and ST-GCN's layer
``temporal_conv`` from :mod:`stgx_torch.models.stgcn`'s), and a patch of the
defining module would change nothing without a word. The names patched:

Subtractive variants:
  full         the unmodified step
  no_norm      ``ops.norms.batch_norm``, ``ops.norms.layer_norm`` (which the
               norm modules call) → affine only, no statistics
  no_acc       ``models.rtstgcn.causal_accumulate`` → identity (RT-ST-GCN;
               no ``window_sum`` launch)
  no_tcn       ``models.stgcn.temporal_conv`` → strided identity plus the
               bias (ST-GCN)
  no_agg       ``models.stgcn.partitioned_gcn`` → the input broadcast over the
               P partitions, made whole, and one product with W (the
               adjacency's V × V product dropped, the P-expanded
               intermediate kept; no ``gcn_core`` launch)
  matmul_only  ``models.stgcn.partitioned_gcn`` → one channel product
               ``x · Σ_p W_p`` plus ``Σ_p b_p`` (no ``gcn_core`` launch)
  fwd_only     forward and loss only, no backward or Adam
  no_mask      ``mask=None`` end to end
  pad_v32      ``config.load_skeleton`` → the skeleton padded from V = 25 to
               32 joints, 7 chain-linked and self-looped (the graph-conv
               kernels already pad joints to 32 rows)
  remat        ``arch.remat``: each layer recomputed in the backward pass

Implementation A/Bs (same function, another route):
  rt_fused     ``ops.rt_fused._ENABLED``: the fused ``rt_fused`` /
               ``rt_fused_bwd`` kernels against the ``gcn_core`` +
               ``window_sum`` chain (RT-ST-GCN)
  rt_fused_fwd the same, forward only
  norm_native  ``ops.norms.batch_norm`` → the statistics in the compute type,
               no fp32 widening
  remat_dots   ``arch.remat`` with selective recompute that keeps the graph
               convs' products: ``models.{rtstgcn,stgcn}.checkpointed`` with
               ``torch.utils.checkpoint.create_selective_checkpoint_contexts``
               under a policy that saves ``torch.ops.stgx.gcn_core``'s outputs,
               and ``ops.gcn_core._core`` → that op (the eager call skips it,
               so the policy could not see the product)

Refused, each with its reason (:data:`REFUSED`): ``acc_reduce_window``,
``acc_slices`` and ``acc_toeplitz`` (XLA forms of the window sum; on the card
the port's window sum has one route, the kernel, and its plain version runs
only for CPU tensors), ``acc_pallas`` (that kernel: it is ``full``),
``gcn_wfirst`` (the port has one graph-conv route; the CLI refuses
``arch.gcn_impl``) and ``dots_native`` (``gcn_core`` and ``gcn_grads``
already write the compute type from fp32 sums: no fp32-then-cast form to
take away). A variant whose op the model does not run (``no_acc``,
``rt_fused`` and ``rt_fused_fwd`` for ST-GCN, ``no_tcn`` for RT-ST-GCN) is
left out of a full run and refused by ``--only``.

How to read the figures: the port runs eagerly, so no op fuses with
another. A marginal here is the op's own launches (and their host time),
not the cost of taking it out of a fusion as in the JAX package. As there,
compare variants within one run only: across processes the card's clocks
and the host's load move the step.

Run (on the card):
    python -m stgx_torch.bench.ablate [--model st-gcn] [--dtype float32]
        [--frames 1024] [--only full,no_acc,...]

``--frames`` is the frames of a trial (RT-ST-GCN, 8 trials a step) or, for
ST-GCN, 50 × the windows of a step (``--frames 12800``: 256 windows). One
JSON line a variant (its step, its rate, the card), then the marginal-cost
lines.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import sys

import numpy as np
import torch

__all__ = ["VARIANTS", "REFUSED", "NOT_RUN_BY", "ported", "check_variant", "variant_patches",
           "variant_trainer", "run_variant", "marginals", "main"]

NUM_CLASSES = 52
RT_TRIALS = 8  # trials a RT-ST-GCN step, as the JAX package
WINDOW = 50  # ST-GCN's window: --frames // WINDOW windows a step
# every variant of the JAX package, in its order
VARIANTS = ("full", "no_norm", "no_acc", "acc_reduce_window", "acc_slices", "acc_toeplitz",
            "acc_pallas", "no_agg", "matmul_only", "gcn_wfirst", "rt_fused", "rt_fused_fwd",
            "fwd_only", "no_mask", "pad_v32", "remat", "dots_native", "norm_native", "no_tcn",
            "remat_dots")
_XLA_ACC = ("an XLA form of the causal window sum; on the card the port's window sum has "
            "one route, the window_sum kernel, and its plain version runs only for CPU tensors")
REFUSED = {
    "acc_reduce_window": _XLA_ACC,
    "acc_slices": _XLA_ACC,
    "acc_toeplitz": _XLA_ACC,
    "acc_pallas": "the window sum's kernel, the port's only route on the card: it is `full`",
    "gcn_wfirst": "the port has one graph-conv route, the gcn_core kernel; the CLI refuses "
                  "arch.gcn_impl",
    "dots_native": "gcn_core and gcn_grads already write the compute type from fp32 sums: "
                   "there is no fp32-then-cast form to take away",
}
# the variants whose op a model does not run
NOT_RUN_BY = {
    "st-gcn": {"no_acc": "ST-GCN has no causal window sum",
               "rt_fused": "the fused kernels are RT-ST-GCN's layer core",
               "rt_fused_fwd": "the fused kernels are RT-ST-GCN's layer core"},
    "rt-st-gcn": {"no_tcn": "RT-ST-GCN has no temporal conv"},
}
FWD_ONLY = ("fwd_only", "rt_fused_fwd")
REMAT = ("remat", "remat_dots")


@contextlib.contextmanager
def _patched(monkey):
    """Set each ``(module, name, value)`` of ``monkey`` for the block; put
    the old values back after it."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in monkey]
    try:
        for mod, name, value in monkey:
            setattr(mod, name, value)
        yield
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)


def _padded_skeleton(load_skeleton):
    """``load_skeleton`` with its skeleton padded to 32 joints: 7 more,
    chain-linked from the last real joint, each with a self-loop as every
    joint has (``stgx/bench/ablate.py``)."""

    def load(name):
        skel = load_skeleton(name)
        v = skel["num_node"]
        skel["num_node"] = 32
        skel["edge"] = list(skel["edge"]) + [(i, i + 1) for i in range(v - 1, 31)] + [
            (i, i) for i in range(v, 32)]
        return skel

    return load


def variant_patches(name: str) -> list:
    """The ``(module, name, value)`` patches of variant ``name`` (empty for
    the variants that only set a knob of the step)."""
    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

    import stgx_torch.config as config
    import stgx_torch.models.rtstgcn as rtstgcn
    import stgx_torch.models.stgcn as stgcn
    import stgx_torch.ops.norms as norms
    import stgx_torch.ops.rt_fused as rt_fused
    from stgx_torch.models._remat import checkpointed

    gcn_core = sys.modules["stgx_torch.ops.gcn_core"]

    def affine_bn(x, weight, bias, axes, eps=1e-5, mask=None):
        return (weight * x + bias).to(x.dtype)

    def affine_ln(x, weight, bias, eps=1e-5, channels=None):
        return (weight * x + bias).to(x.dtype)

    def identity_acc(x, kernel_size, stride):
        return x

    def no_tcn(x, W, b=None, stride=1, dilation=1, padding="same"):
        # the tcn maps C_out to C_out: only the frame decimation is kept
        y = x[:, ::stride] if padding == "same" else x
        return y if b is None else y + b.to(y.dtype)

    def bias_term(y, A, b):
        if b is None:
            return y
        acc = torch.promote_types(y.dtype, torch.float32)
        return y + torch.einsum("pvw,pd->wd", A.to(acc), b.to(acc)).to(y.dtype)

    def broadcast_agg(x, A, W, b=None):
        n, l, v, c = x.shape
        p = W.shape[0]
        xp = x.unsqueeze(3).expand(n, l, v, p, c).reshape(n * l * v, p * c)
        y = (xp @ W.to(x.dtype).reshape(p * c, -1)).reshape(n, l, v, -1)
        return bias_term(y, A, b)

    def matmul_only(x, A, W, b=None):
        y = x @ W.sum(0).to(x.dtype)
        return y if b is None else y + b.sum(0).to(y.dtype)

    def bn_native_stats(x, weight, bias, axes, eps=1e-5, mask=None):
        axes = tuple(axes)
        if mask is None:
            mean = x.mean(dim=axes, keepdim=True)
            var = (x * x).mean(dim=axes, keepdim=True) - mean * mean
        else:
            m = mask[:, :, None, None].to(x.dtype)
            count = m.sum(dim=axes, keepdim=True) * (x.shape[2] if 2 in axes else 1)
            mean = (x * m).sum(dim=axes, keepdim=True) / count
            var = (x * x * m).sum(dim=axes, keepdim=True) / count - mean * mean
        return (weight * ((x - mean) / torch.sqrt(var + eps)) + bias).to(x.dtype)

    def save_gcn_core(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op is torch.ops.stgx.gcn_core.default
                else CheckpointPolicy.PREFER_RECOMPUTE)

    keep_dots = functools.partial(checkpointed, context_fn=functools.partial(
        create_selective_checkpoint_contexts, save_gcn_core))

    return {
        "no_norm": [(norms, "batch_norm", affine_bn), (norms, "layer_norm", affine_ln)],
        "no_acc": [(rtstgcn, "causal_accumulate", identity_acc)],
        "no_tcn": [(stgcn, "temporal_conv", no_tcn)],
        "no_agg": [(stgcn, "partitioned_gcn", broadcast_agg)],
        "matmul_only": [(stgcn, "partitioned_gcn", matmul_only)],
        "pad_v32": [(config, "load_skeleton", _padded_skeleton(config.load_skeleton))],
        "rt_fused": [(rt_fused, "_ENABLED", True)],
        "rt_fused_fwd": [(rt_fused, "_ENABLED", True)],
        "norm_native": [(norms, "batch_norm", bn_native_stats)],
        "remat_dots": [(rtstgcn, "checkpointed", keep_dots), (stgcn, "checkpointed", keep_dots),
                       (gcn_core, "_core", lambda x, A, W: torch.ops.stgx.gcn_core(x, A, W))],
    }.get(name, [])


def ported(model: str) -> list:
    """The variants a full run of ``model`` takes, in the JAX package's
    order."""
    return [n for n in VARIANTS if n not in REFUSED and n not in NOT_RUN_BY[model]]


def check_variant(model: str, name: str) -> None:
    """Raise ``ValueError`` with the reason for a variant the port does not
    run, or one whose op ``model`` does not run."""
    if name in REFUSED:
        raise ValueError(f"ablate: {name} has no counterpart in the port: {REFUSED[name]}")
    if name in NOT_RUN_BY[model]:
        raise ValueError(f"ablate: {name} changes nothing in {model}: {NOT_RUN_BY[model][name]}")
    if name not in VARIANTS:
        raise ValueError(f"ablate: unknown variant {name!r} (have {', '.join(VARIANTS)})")


def variant_trainer(model: str, name: str, dtype: str = "float32", device=None,
                    overrides=()):
    """The :class:`~stgx_torch.parallel.loop.Trainer` of ``model`` (its
    PKU-MMD config, BatchNorm, 52 classes; ``overrides`` as the CLI's
    ``--set``) for variant ``name``: remat on for ``remat`` and
    ``remat_dots``, the padded skeleton for ``pad_v32``."""
    from stgx_torch.config import FAMILY_CONFIGS, build_model, load_config
    from stgx_torch.parallel.loop import MODEL_KIND, OptimizerConfig, Trainer
    from stgx_torch.utils import LOSS

    check_variant(model, name)
    cfg = load_config(FAMILY_CONFIGS[model],
                      [*overrides, f"arch.remat={str(name in REMAT).lower()}"])
    with _patched(variant_patches("pad_v32") if name == "pad_v32" else []):
        net = build_model(cfg, NUM_CLASSES, device)
    return Trainer(model=net, kind=MODEL_KIND[model],
                   loss=LOSS[model](np.ones(NUM_CLASSES, np.float32)),
                   opt=OptimizerConfig(learning_rate=1e-4), compute_dtype=dtype,
                   receptive_field=WINDOW)


def run_variant(model: str, name: str, dtype: str = "float32", frames: int = 1024) -> dict:
    """One variant's timed steps on the card (``measure_train_throughput``):
    ``{"variant", "frames_per_s" | "windows_per_s", "step_ms", ...}``.
    ``frames`` is a trial's frames (RT-ST-GCN, 8 trials) or 50 × the
    windows of a step (ST-GCN)."""
    from stgx_torch.bench import train_throughput as tt

    trainer = variant_trainer(model, name, dtype)
    if trainer.kind == "window":
        length, count = WINDOW, max(1, frames // WINDOW)
    else:
        length, count = frames, RT_TRIALS
    with _patched(variant_patches(name)):
        rate, p50, _ = tt.measure_train_throughput(
            trainer, count, length, fwd_only=name in FWD_ONLY, use_mask=name != "no_mask")
    unit = "windows_per_s" if trainer.kind == "window" else "frames_per_s"
    return {"variant": name, "model": model, "dtype": dtype, unit: rate, "step_ms": p50,
            "trials": count, "frames": length, "device": torch.cuda.get_device_name(0)}


def marginals(results: dict, kind: str) -> list:
    """The marginal-cost lines of ``results`` (``{variant: record}``)
    against ``full``, as the JAX package prints them."""
    unit = "windows_per_s" if kind == "window" else "frames_per_s"
    per = "µs/window" if kind == "window" else "µs/frame"
    base = 1e6 / results["full"][unit]
    lines = []
    for name, rec in results.items():
        if name == "full":
            continue
        saved = base - 1e6 / rec[unit]
        lines.append(f"{name}: marginal cost {saved:.2f} {per} ({100 * saved / base:.1f}% of step)")
    return lines


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="rt-st-gcn", choices=sorted(NOT_RUN_BY))
    ap.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    ap.add_argument("--frames", type=int, default=1024,
                    help="frames a trial (rt-st-gcn) / 50 x windows a step (st-gcn)")
    ap.add_argument("--only", default=None, help="comma-list of variants")
    args = ap.parse_args(argv)

    from stgx_torch import strict_numerics

    if args.only:
        names = args.only.split(",")
        for name in names:
            check_variant(args.model, name)
    else:
        names = ported(args.model)
    if not torch.cuda.is_available():
        raise RuntimeError("ablate times train steps on the card; no CUDA device")
    strict_numerics()
    results = {}
    for name in names:
        results[name] = run_variant(args.model, name, args.dtype, args.frames)
        print(json.dumps(results[name]), flush=True)
    if "full" in results:
        kind = "window" if args.model == "st-gcn" else "frame"
        for line in marginals(results, kind):
            print(line, flush=True)
    return results


if __name__ == "__main__":
    main()
