"""Offline segmentation: one ``Trainer.predict`` a trial, as the port's CLI
writes its segmentation dumps.

Set-up builds the ``Trainer`` as the CLI builds it and predicts one trial of
each padded length the traffic holds, so that the window meets no new
shape. The window predicts the trials in turn, a trial a unit, each
returning its per-frame labels to the host. ``offline_frames_per_s`` is the
trials' frames over the window's time.

The check takes ``check_trials`` predictions drawn from the seed among the
window's first two passes, and the first of the longest trial: for those, a
forward hook on the model keeps the logits that the labels were taken from.
The reference's forward over each trial gives the logits it compares them
with, and the widest gap by which a predicted label's logit lies below the
reference's best logit of its frame; each over the spread of the
reference's logits.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import torch

from benchmark.harness import checks, data, program
from benchmark.reference.common import fp32_products

END_TO_END = "offline_frames_per_s"


def setup(run):
    program.numerics(run)
    dataset, class_dist = data.trials(run.traffic, run.num_classes, run.joints, run.in_feat,
                                      run.seed, run.device)
    run.mark("trials made")
    trainer = program.trainer(run, class_dist)
    run.mark("trainer built")
    warmed = set()
    for x, y in dataset:
        padded = max(1, math.ceil(len(y) / trainer.bucket)) * trainer.bucket
        if padded not in warmed:
            trainer.predict(x, y)
            warmed.add(padded)
    gen = data.generator(run.seed, "sample", "cpu")
    n = len(dataset)
    sample = set(torch.randperm(2 * n, generator=gen)[: run.traffic["check_trials"]].tolist())
    sample.add(max(range(n), key=lambda j: len(dataset[j][1])))  # the longest, first pass
    st = SimpleNamespace(trainer=trainer, dataset=dataset, preds=[], sample=sample, kept={},
                         capture=False)

    def keep(module, args, out):
        if st.capture:
            st.kept[len(st.preds)] = out.detach().clone()

    trainer.model.register_forward_hook(keep)
    return st


def unit(run, st, i):
    j = i % len(st.dataset)
    x, y = st.dataset[j]
    st.capture = i in st.sample
    labels = st.trainer.predict(x, y)
    st.capture = False
    st.preds.append((j, labels))
    return {"attempted": 1, "frames": len(y), "lengths": [len(y)]}


def measure(run, st, window_s, counts):
    return counts["frames"] / window_s


def release(run, st):
    del st.trainer


@torch.no_grad()
def check(run, st):
    fp32_products()
    labels_gap, logits_gap = {}, {}
    for i, out in sorted(st.kept.items()):
        j, labels = st.preds[i]
        x = torch.as_tensor(st.dataset[j][0], device=run.device)
        ref = run.reference.forward(run.weights, run.cfg, x)
        labels_gap[i] = checks.label_gap(labels, ref)
        logits_gap[i] = checks.logit_gap(out[0, : len(labels)], ref)
    run.out(f"compared predictions {sorted(st.kept)} of {len(st.preds)}: label gaps "
            f"{list(labels_gap.values())}, logit gaps {list(logits_gap.values())}")
    worst = float("inf")
    return {"label_gap": max(labels_gap.values(), default=worst),
            "logit_gap": max(logits_gap.values(), default=worst)}
