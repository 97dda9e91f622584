"""Training: whole ``Trainer.train_epoch`` calls over the traffic's trials.

Set-up builds the ``Trainer`` (model, loss, Adam) as the port's CLI builds
it, from the run's weights, and drives it through the traffic's
``check_steps`` first epochs, each one Adam step over every trial: those
epochs warm up every shape and give the check its readings (each epoch's
loss, the first gradient from Adam's first moment, the parameters after the
last). The window trains on, an epoch a unit, from that same ``Trainer``.
``train_frames_per_s`` is the trials' own frames (not their padding) over
the window's time.

The check runs the reference's forward, loss, gradients and Adam over the
same trials from the same weights for the same epochs, and compares each
epoch's loss, every leaf's first gradient and every leaf's change
(:mod:`benchmark.harness.checks`). Leaves whose reference gradient is
nought to rounding are left out of the change.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from benchmark.harness import checks, data, program
from benchmark.reference.common import adam_step, class_weights, fp32_products, segmentation_loss

END_TO_END = "train_frames_per_s"


def _divisors(n: int, batch: int) -> list[float]:
    """Each trial's loss divisor in the ``Trainer``: the batch size, or the
    ragged last group's size."""
    ragged = n % batch
    return [float(batch if ragged == 0 or i < n - ragged else ragged) for i in range(n)]


def setup(run):
    program.numerics(run)
    dataset, class_dist = data.trials(run.traffic, run.num_classes, run.joints, run.in_feat,
                                      run.seed, run.device)
    if len(dataset) > run.cfg["optimizer"]["batch_size"]:
        raise ValueError("the check reads the first gradient from Adam's state after the "
                         "first epoch: the trials must make one Adam step an epoch")
    run.mark("trials made")
    trainer = program.trainer(run, class_dist)
    run.mark("trainer built")
    st = SimpleNamespace(trainer=trainer, dataset=dataset, class_dist=class_dist, losses=[],
                         lengths=[len(y) for _, y in dataset])
    b1 = trainer.optimizer.param_groups[0]["betas"][0]
    for epoch in range(run.traffic["check_steps"]):
        out = trainer.train_epoch(dataset, epoch)
        st.losses.append(out["ce"] + out["mse"])
        if epoch == 0:  # Adam's first moment after one step is (1 − β1)·g; none, no step
            st.grad1 = {n: trainer.optimizer.state[p].get("exp_avg", torch.zeros_like(p)) / (1 - b1)
                        for n, p in trainer.model.named_parameters()}
    st.after = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    st.epoch = run.traffic["check_steps"]
    run.mark("check epochs done")
    run.out(f"set-up epochs' loss {st.losses}")
    return st


def unit(run, st, i):
    st.trainer.train_epoch(st.dataset, st.epoch)
    st.epoch += 1
    return {"attempted": len(st.dataset), "frames": sum(st.lengths), "lengths": st.lengths}


def measure(run, st, window_s, counts):
    return counts["frames"] / window_s


def release(run, st):
    del st.trainer


def check(run, st):
    fp32_products()
    cfg, ref = run.cfg, run.reference
    opt = cfg["optimizer"]
    weights = class_weights(st.class_dist).to(run.device)
    params = {k: v.clone().requires_grad_(True) for k, v in run.weights.items()}
    divisors = _divisors(len(st.dataset), opt["batch_size"])
    adam, losses = {}, []
    for epoch in range(run.traffic["check_steps"]):
        total = 0.0
        for (x, y), div in zip(st.dataset, divisors):
            ce, mse = segmentation_loss(
                ref.forward(params, cfg, torch.as_tensor(x, device=run.device)),
                torch.as_tensor(y, device=run.device), weights)
            ((ce + mse) / div).backward()
            total += float(ce.detach()) + float(mse.detach())
        losses.append(total)
        grads = {k: p.grad for k, p in params.items()}
        if epoch == 0:
            grad1 = {k: g.clone() for k, g in grads.items()}
        with torch.no_grad():
            adam_step(params, grads, adam,
                      opt["learning_rate"] * opt["learning_rate_decay"] ** epoch)
        for p in params.values():
            p.grad = None
    quiet = checks.quiet_leaves(grad1)
    change_p = {k: st.after[k] - run.weights[k] for k in params}
    change_r = {k: params[k].detach() - run.weights[k] for k in params}
    grad_gap, grad_leaf = checks.leaf_norm_gap(st.grad1, grad1)
    change_gap, change_leaf = checks.leaf_norm_gap(change_p, change_r, quiet)
    run.out(f"reference epochs' loss {losses}; worst gradient leaf {grad_leaf}, worst "
            f"change leaf {change_leaf}; leaves left out of the change {sorted(quiet)}")
    return {"loss_gap": max(checks.relative_gap(p, r) for p, r in zip(st.losses, losses)),
            "grad_gap": grad_gap, "change_gap": change_gap}
