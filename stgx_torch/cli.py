"""CLI of the port: ``python -m stgx_torch.cli {train|test|benchmark}
[--config F] [--set group.key=value ...]`` — the port of ``stgx/cli.py``.

Each command builds the data, the classes, the model and the ``Trainer``
from the config, runs, and writes the JAX CLI's artifacts under
``processor.out``:

* ``train``: ``train-validation-curve.csv`` and ``accuracy-curve.csv``
  (rewritten every epoch), ``macro-F1@k-{e}.csv``, ``edit-{e}.csv``,
  ``confusion-matrix-{e}.csv``, ``segmentation-{i}.csv`` for every
  ``processor.demo`` trial, a checkpoint ``epoch-{e}`` at every
  ``optimizer.checkpoint_indices`` epoch and ``final`` after the last;
* ``test``: ``macro-F1@k.csv``, ``edit.csv``, ``confusion-matrix.csv``,
  ``accuracy.csv`` and the segmentation dumps;
* ``benchmark``: :func:`stgx_torch.bench.streaming.run_streaming_benchmark`,
  with the int8 rows for RT-ST-GCN, CoST-GCN and ST-GCN; as in the JAX CLI
  it does not read ``processor.quantize`` or ``processor.state_dtype``
  (only ``export`` does), and MS-TCN and MS-GCN, which have no streaming
  form, raise ``ValueError``.

Every family of the JAX package but Shift-GCN++ runs: RT-ST-GCN, CoST-GCN
(``frame`` kind), MS-TCN (``frame_ms``), ST-GCN, AA-GCN, Shift-GCN
(``window``) and MS-GCN (``window_ms``); the multi-stage kinds report the
last stage's statistics (``StatisticsMultiStage``), as ``stgx/cli.py``
does.

Resume rules are the JAX CLI's: ``processor.checkpoint`` resumes training
after its epoch; ``processor.torch_checkpoint`` starts from a reference
PyTorch checkpoint (:mod:`stgx_torch.utils.torch_import`), resuming after
its epoch with its Adam moments unless ``processor.torch_resume`` is
false. ``job.log`` sends the log lines and stderr to files, ``job.email``
gets the completion and failure mail, ``job.profile`` names a directory
for a ``torch.profiler`` trace of the first epoch trained.

The commands run on the CUDA device, or on the CPU when the config's
``job.platform`` is ``"cpu"`` (any other value is refused). Not ported yet,
each refused with its place in ROADMAP.md's queue 1: ``export`` (item 9),
``job.distributed``, meshes past one device and the pipelined MS-TCN
(``arch.pipeline``) (item 10), Shift-GCN++ (item 8); and an
``arch.gcn_impl`` other than the
hand-written kernels, since the port has no other graph-conv route on the
card.
"""

from __future__ import annotations

import atexit
import csv
import os
import sys
import time

import numpy as np
import torch

__all__ = ["main", "cmd_train", "cmd_test", "cmd_benchmark", "select_device"]

# the JAX package's graph-conv backends; the port's one route is the kernel
# the "pallas" name stands for
_KERNEL_GCN_IMPL = "pallas"


def select_device(cfg) -> torch.device:
    """``job.platform``: unset runs on the CUDA device (raising where there
    is none), ``"cpu"`` on the CPU; any other value raises."""
    platform = cfg["job"].get("platform")
    if platform is None:
        from stgx_torch import default_device

        return default_device()
    if platform == "cpu":
        return torch.device("cpu")
    raise ValueError(
        f"job.platform {platform!r}: stgx_torch runs on the CUDA device (leave "
        "job.platform unset) or on the CPU (job.platform \"cpu\")"
    )


def _refuse_unported(command, cfg) -> None:
    job, arch = cfg["job"], cfg["arch"]

    def refuse(what, item):
        raise NotImplementedError(
            f"{what} is not ported to stgx_torch yet; see ROADMAP.md, queue 1 item {item}")

    if command == "export":
        refuse("export of the streaming cell", 9)
    mesh = job.get("mesh") or {}
    if job.get("distributed") or any((mesh.get(k) or 1) > 1 for k in ("data", "seq", "model")):
        refuse("multi-device training (job.distributed, job.mesh)", 10)
    if arch.get("pipeline"):
        refuse("the pipelined MS-TCN (arch.pipeline)", 10)
    if arch.get("shift-gcn++", {}).get("teacher_checkpoint"):
        refuse("Shift-GCN++ teacher grafting", 8)
    if arch.get("gcn_impl") not in (None, _KERNEL_GCN_IMPL):
        raise ValueError(
            f"arch.gcn_impl {arch['gcn_impl']!r}: stgx_torch has one graph-conv "
            f"route on the card, the hand-written kernels ({_KERNEL_GCN_IMPL!r})")


def _log_factory(job):
    """Log lines to ``job.log[0]`` and stderr to ``job.log[1]`` when set
    (``null`` means stdout and stderr). The stderr redirect only ever
    replaces the process's own stderr, and ``log.restore()`` undoes both and
    closes the files, so commands run one after another in one process do
    not stack redirections."""
    out_path, err_path = (list(job.get("log") or [None, None]) + [None])[:2]
    stream = sys.stdout
    if out_path:
        stream = open(out_path, "a", buffering=1)
        atexit.register(stream.close)
    err_stream = None
    if err_path and sys.stderr is sys.__stderr__:
        err_stream = open(err_path, "a", buffering=1)
        atexit.register(err_stream.close)
        sys.stderr = err_stream

    def log(msg):
        # after restore() the file is closed; a stale logger falls back to stdout
        target = stream if not stream.closed else sys.stdout
        print(msg, flush=True, file=target)

    def restore():
        if err_stream is not None:
            if sys.stderr is err_stream:
                sys.stderr = sys.__stderr__
            if not err_stream.closed:
                err_stream.close()
                atexit.unregister(err_stream.close)
        if stream is not sys.stdout and not stream.closed:
            stream.close()
            atexit.unregister(stream.close)

    log.restore = restore
    return log


def _build_all(cfg, device):
    """``(trainer, train_ds, val_ds, num_classes)`` from the config."""
    from stgx_torch.config import build_model
    from stgx_torch.data import PrefetchedDataset, build_datasets, class_distribution, load_actions
    from stgx_torch.parallel.loop import MODEL_KIND, OptimizerConfig, Trainer
    from stgx_torch.utils import LOSS, STATISTICS

    proc, arch, opt = cfg["processor"], cfg["arch"], cfg["optimizer"]
    train_ds, val_ds = build_datasets(proc)
    num_classes = len(load_actions(proc["actions"]))
    class_dist = class_distribution(train_ds, num_classes)
    prefetch = proc.get("prefetch", 4)
    if prefetch:
        train_ds = PrefetchedDataset(train_ds, ahead=prefetch)
        val_ds = PrefetchedDataset(val_ds, ahead=prefetch)

    name = proc["model"]
    model = build_model(cfg, num_classes, device=device)
    trainer = Trainer(
        model=model,
        kind=MODEL_KIND[name],
        loss=LOSS[name](class_dist, arch.get("output_type", "logits")),
        opt=OptimizerConfig(
            learning_rate=opt["learning_rate"],
            learning_rate_decay=opt["learning_rate_decay"],
            batch_size=opt["batch_size"],
            epochs=opt["epochs"],
            seed=opt["seed"],
            checkpoint_indices=tuple(opt.get("checkpoint_indices", ())),
        ),
        receptive_field=arch.get("receptive_field", 50),
        segment=arch.get("segment"),
        trial_batch=opt.get("trial_batch", 1),
        compute_dtype=opt.get("compute_dtype"),
        statistics=STATISTICS[name](),
    )
    return trainer, train_ds, val_ds, num_classes


def maybe_import_torch_checkpoint(cfg, trainer, log=print, want_optimizer=True):
    """``processor.torch_checkpoint``: load a reference-trained PyTorch
    checkpoint into the trainer's model, with its Adam moments when it has
    them and ``want_optimizer``; returns the saved epoch to resume after,
    or None (no key, ``torch_resume: false``, or moments that do not fit:
    then it is a weights-only start at epoch 0 with a fresh Adam)."""
    path = cfg["processor"].get("torch_checkpoint")
    if not path:
        return None
    from stgx_torch.utils.torch_import import (
        import_reference_optimizer,
        import_reference_state_dict,
        load_reference_into,
    )
    from stgx_torch.weights import from_jax_params

    name = cfg["processor"]["model"]
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    load_reference_into(trainer.model, import_reference_state_dict(ckpt, trainer.model, name))
    log(f"imported reference torch checkpoint {path}")
    if not cfg["processor"].get("torch_resume", True):
        return None
    epoch = ckpt.get("epoch") if isinstance(ckpt, dict) else None
    if want_optimizer and isinstance(ckpt, dict) and "optimizer_state_dict" in ckpt:
        try:
            mu, nu, count = import_reference_optimizer(ckpt, trainer.model, name)
            trainer.load_adam_moments(from_jax_params(mu, trainer.model),
                                      from_jax_params(nu, trainer.model), count)
            log(f"imported Adam moments (step count {count})")
        except (ValueError, KeyError, IndexError, TypeError) as e:
            # resuming at epoch + 1 with zeroed moments would be neither the
            # reference's resume nor a clean fine-tune
            log(f"optimizer state not imported ({e}); falling back to weights-only "
                "import (epoch 0, fresh optimizer — torch_resume=false semantics)")
            return None
    return epoch


def _metrics(cfg, num_classes):
    from stgx_torch.utils.metrics import ConfusionMatrix, EditScore, F1Score

    return [
        F1Score(num_classes, tuple(cfg["processor"]["iou_threshold"])),
        EditScore(num_classes),
        ConfusionMatrix(num_classes),
    ]


def _write_curve(path, rows, header):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


# the curve row cmd_train writes each epoch
_CURVE_COLS = ["epoch", "train_ce", "train_mse", "val_ce", "val_mse",
               "top1_train", "top5_train", "top1_val", "top5_val",
               "time_train", "time_val"]


def _load_existing_curve(out_dir, start_epoch):
    """The rows before ``start_epoch`` of a previous run's curve (none when
    starting fresh), so that a resumed run extends it."""
    path = os.path.join(out_dir, "train-validation-curve.csv")
    if start_epoch == 0 or not os.path.exists(path):
        return []
    rows = []
    with open(path, newline="") as f:
        for row in list(csv.reader(f))[1:]:
            if row and int(float(row[0])) < start_epoch:
                parsed = [int(float(row[0]))] + [float(v) for v in row[1:]]
                parsed += [0.0] * (len(_CURVE_COLS) - len(parsed))
                rows.append(parsed[: len(_CURVE_COLS)])
    return rows


def _write_epoch_curves(out_dir, curve):
    _write_curve(os.path.join(out_dir, "train-validation-curve.csv"), curve, _CURVE_COLS)
    _write_curve(
        os.path.join(out_dir, "accuracy-curve.csv"),
        [[r[0], r[5], r[7], r[6], r[8]] for r in curve],
        ["epoch", "top1_train", "top1_val", "top5_train", "top5_val"],
    )


def _email_stats_table(job, curve):
    """``verbose > 1``: the per-epoch table mailed newest first."""
    from stgx_torch.utils.notify import send_mail

    lines = [
        f"{'EPOCH':>6} {'LOSS_TRAIN':>11} {'LOSS_VAL':>9} {'TOP1_TRAIN':>11} "
        f"{'TOP5_TRAIN':>11} {'TOP1_VAL':>9} {'TOP5_VAL':>9} "
        f"{'TIME_TRAIN':>11} {'TIME_VAL':>9}"
    ]
    for r in reversed(curve):
        lines.append(
            f"{r[0]:>6d} {r[1] + r[2]:>11.6f} {r[3] + r[4]:>9.6f} "
            f"{r[5]:>11.4f} {r[6]:>11.4f} {r[7]:>9.4f} {r[8]:>9.4f} "
            f"{r[9]:>11.6f} {r[10]:>9.6f}"
        )
    send_mail(job.get("email"), f"[{job.get('jobname', 'stgx')}]: status update",
              "\n".join(lines))


def _demo_masks(trainer, dataset, demo_indices, out_dir, suffix=""):
    """``segmentation-{i}.csv``: (label, top-1) per frame of each demo trial."""
    for i in demo_indices:
        if i >= len(dataset):
            continue
        x, y = dataset[i]
        _write_curve(
            os.path.join(out_dir, f"segmentation-{i}{suffix}.csv"),
            np.stack([np.asarray(y), trainer.predict(x, y)]).T,
            ["label", "top1"],
        )


def _profiler(device):
    """A ``torch.profiler`` of the host and, on the card, the device."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def cmd_train(cfg, device=None):
    device = select_device(cfg) if device is None else device
    trainer, train_ds, val_ds, ncls = _build_all(cfg, device)
    out_dir = cfg["processor"]["out"]
    os.makedirs(out_dir, exist_ok=True)
    log = _log_factory(cfg["job"])

    start_epoch = 0
    torch_epoch = maybe_import_torch_checkpoint(cfg, trainer, log)
    if torch_epoch is not None:
        start_epoch = int(torch_epoch) + 1
        log(f"resuming at epoch {start_epoch}")
        if start_epoch >= trainer.opt.epochs:
            log(f"WARNING: checkpoint epoch {torch_epoch} >= configured epochs "
                f"{trainer.opt.epochs}; no epochs will run. Set "
                "processor.torch_resume=false to fine-tune from epoch 0, or raise "
                "optimizer.epochs.")
    if cfg["processor"].get("checkpoint"):
        start_epoch = trainer.restore(cfg["processor"]["checkpoint"]) + 1
        log(f"resumed from epoch {start_epoch - 1}")

    profile_dir = cfg["job"].get("profile")
    verbose = cfg["job"].get("verbose", 0)
    curve = _load_existing_curve(out_dir, start_epoch)
    t_start = time.time()
    for epoch in range(start_epoch, trainer.opt.epochs):
        prof = None
        if profile_dir and epoch == start_epoch:
            prof = _profiler(device)
            prof.start()
        tr = trainer.train_epoch(train_ds, epoch)
        if prof is not None:
            prof.stop()
            os.makedirs(profile_dir, exist_ok=True)
            path = os.path.join(profile_dir, f"trace-epoch-{epoch}.json")
            prof.export_chrome_trace(path)
            log(f"profile trace → {path}")
        metrics = _metrics(cfg, ncls)
        ev = trainer.evaluate(val_ds, metrics=metrics)
        curve.append([epoch, tr["ce"], tr["mse"], ev["ce"], ev["mse"],
                      tr["top1"], tr["top5"], ev["top1"], ev["top5"],
                      tr["duration"], ev["duration"]])
        log(
            f"[epoch {epoch}] train ce={tr['ce']:.3f} mse={tr['mse']:.3f} "
            f"top1={tr['top1']:.3f} ({tr['duration']:.1f}s) | "
            f"val ce={ev['ce']:.3f} top1={ev['top1']:.3f} top5={ev['top5']:.3f} "
            f"({ev['duration']:.1f}s) | "
            + ", ".join(filter(None, (m.log() for m in metrics)))
        )
        if verbose > 0:
            log(f"[epoch {epoch}]: train_time = {tr['duration']}, "
                f"val_time = {ev['duration']}")
        for m in metrics:
            m.save(out_dir, suffix=f"-{epoch}")
        _demo_masks(trainer, val_ds, cfg["processor"].get("demo", []), out_dir)
        _write_epoch_curves(out_dir, curve)
        if verbose > 1:
            _email_stats_table(cfg["job"], curve)
        if epoch in trainer.opt.checkpoint_indices:
            trainer.save(out_dir, epoch)

    trainer.save(out_dir, trainer.opt.epochs - 1, name="final")
    log(f"training done in {time.time() - t_start:.1f}s → {out_dir}")
    _write_epoch_curves(out_dir, curve)

    from stgx_torch.utils.notify import backup_results, send_mail

    copied = backup_results(out_dir, cfg["processor"].get("backup"))
    if copied:
        log(f"backed up {len(copied)} artifacts → {cfg['processor']['backup']}")
    send_mail(
        cfg["job"].get("email"),
        f"stgx train complete: {cfg['processor']['model']}",
        f"epochs={trainer.opt.epochs} out={out_dir}\nlast: {curve[-1] if curve else '-'}",
    )
    log.restore()
    return 0


def cmd_test(cfg, device=None):
    from stgx_torch.utils.checkpoint import latest_epoch

    device = select_device(cfg) if device is None else device
    trainer, _, val_ds, ncls = _build_all(cfg, device)
    out_dir = cfg["processor"]["out"]
    os.makedirs(out_dir, exist_ok=True)
    log = _log_factory(cfg["job"])

    if cfg["processor"].get("torch_checkpoint"):
        maybe_import_torch_checkpoint(cfg, trainer, log, want_optimizer=False)
    else:
        ckpt = cfg["processor"].get("checkpoint") or latest_epoch(out_dir)
        if ckpt:
            trainer.restore(ckpt)
            log(f"loaded checkpoint {ckpt}")

    metrics = _metrics(cfg, ncls)
    ev = trainer.evaluate(val_ds, metrics=metrics)
    for m in metrics:
        m.save(out_dir, suffix=None)
    _write_curve(
        os.path.join(out_dir, "accuracy.csv"),
        [[ev["top1"], ev["top5"], ev["ce"], ev["mse"]]],
        ["top1", "top5", "ce", "mse"],
    )
    _demo_masks(trainer, val_ds, cfg["processor"].get("demo", []), out_dir)
    log(
        f"test: top1={ev['top1']:.4f} top5={ev['top5']:.4f} ce={ev['ce']:.3f} | "
        + ", ".join(filter(None, (m.log() for m in metrics)))
    )
    log.restore()
    return 0


def cmd_benchmark(cfg, device=None):
    from stgx_torch.bench.streaming import run_streaming_benchmark

    return run_streaming_benchmark(cfg, select_device(cfg) if device is None else device)


def main(argv=None):
    from stgx_torch import strict_numerics
    from stgx_torch.config import parse_args

    command, cfg = parse_args(argv)
    strict_numerics()
    try:
        _refuse_unported(command, cfg)
        return {"train": cmd_train, "test": cmd_test,
                "benchmark": cmd_benchmark}[command](cfg)
    except (Exception, SystemExit) as e:
        # failure mail on any non-zero exit (an aborting SystemExit too)
        from stgx_torch.utils.notify import send_mail

        if not (isinstance(e, SystemExit) and not e.code):
            send_mail(
                cfg["job"].get("email"),
                f"[{cfg['job'].get('jobname', 'stgx')}]: FAILED ({command})",
                f"{type(e).__name__}: {e}",
            )
        raise


if __name__ == "__main__":
    sys.exit(main())
