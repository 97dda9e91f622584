"""The program under test, reached only through its own entry points:
``stgx_torch.config.build_model`` and the ``Trainer`` of
``stgx_torch.parallel.loop``, built as the port's CLI builds them. Its
modules are imported here, when a run builds it, and nowhere else in the
harness: the reference never sees them."""

from __future__ import annotations

import torch

__all__ = ["numerics", "model", "trainer"]


def numerics(run) -> None:
    """What every entry point of the program sets (TF32 off, cuDNN
    deterministic); the control run then switches TF32 back on, the
    program's own path one precision down."""
    from stgx_torch import strict_numerics

    strict_numerics()
    run.mark("program imported")
    if run.control:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True


def model(run):
    """The configured model on the run's device, holding the run's weights."""
    from stgx_torch.config import build_model

    net = build_model(run.cfg, run.num_classes, device=run.device)
    net.load_state_dict(run.weights, strict=True)
    return net


def trainer(run, class_dist):
    """The ``Trainer`` of the configured model as ``stgx_torch.cli`` builds it
    (``_build_all``), over the run's trials and their class counts."""
    from stgx_torch.parallel.loop import MODEL_EPOCH_ARG, MODEL_KIND, OptimizerConfig, Trainer
    from stgx_torch.utils import LOSS, STATISTICS

    cfg = run.cfg
    name, arch, opt = cfg["processor"]["model"], cfg["arch"], cfg["optimizer"]
    return Trainer(
        model=model(run),
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
        pass_epoch=name in MODEL_EPOCH_ARG,
    )
