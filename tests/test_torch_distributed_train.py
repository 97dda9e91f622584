"""Multi-process training, evaluation and metrics of the port over gloo on
the CPU — the counterpart of ``tests/test_distributed_train.py`` and
``tests/test_distributed_metrics.py``.

* Two ``Trainer`` epochs and an ``evaluate`` (F1@k, edit, confusion) of a
  small RT-ST-GCN with BatchNorm, on 10 trials of 26–32 frames stacked 4
  to a step (``trial_batch``) in one 32-frame bucket, run on 2 ranks under
  a ``data=2`` mesh (the 4 trials of a step split 2 and 2) and under a
  ``seq=2`` mesh (each step's 32 frames split 16 and 16). Both ranks end
  with the same numbers and bit-equal parameters. Without dropout the run
  equals the JAX ``Trainer`` on one device: losses and top-k within
  ``rtol = 1e-5`` (the JAX test's ``1e-4`` for its two-process run),
  metrics within ``1e-6`` (confusion counts exact), and the parameters
  within a thousandth of what Adam's steps can move them
  (``tests/test_torch_train.py``'s bound). With dropout the same holds
  against the port's one-process run: every rank draws the one-process
  masks and keeps its block.
* A 2-rank run resumed from the ``epoch-0`` checkpoint (written by rank 0,
  restored by both) ends its next epoch bit for bit where the unbroken run
  does.
* With ``arch.remat`` and dropout drawn from each epoch's generator, the
  two epochs on either layout end bit for bit where the stored run does:
  each layer's recompute replays its masks under the layout it ran under.
* Metrics reduced across 2 ranks, each holding a disjoint block of the
  trials, equal one process visiting them all (and the JAX package's); a
  truncated evaluation averages only the visited rows.
* ``python -m stgx_torch.cli train`` as 2 processes (``job.distributed``
  with a ``file://`` store and ``STGX_PROCESS_ID``, ``job.mesh.seq = 2``):
  both exit 0 with identical logs; rank 0 writes every artifact and rank 1,
  pointed at an empty directory, writes none; the single-process port's
  ``test`` then loads the final checkpoint.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_spawn import spawn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, C_IN, CLASSES, EPOCHS, LR = 7, 3, 4, 2, 1e-2
ARCH = dict(num_classes=CLASSES, in_feat=C_IN, kernel=3, in_ch=(8, 8), out_ch=(8, 8),
            stride=(1, 1), residual=(1, 1), normalization="BatchNorm")
LAYOUTS = {"data": (2, 1), "seq": (1, 2)}
DROPOUT = 0.3


def make_dataset(n=10, seed=3):
    """Unequal-length trials, all inside one 32-frame bucket."""
    rng = np.random.default_rng(seed)
    trials = []
    for _ in range(n):
        length = int(rng.integers(26, 33))
        x = rng.normal(size=(length, V, C_IN)).astype(np.float32)
        y = np.repeat(rng.integers(0, CLASSES, size=4), -(-length // 4))[:length]
        trials.append((x, y.astype(np.int64)))
    return trials


def _trial(seed, length=120, classes=5):
    rng = np.random.default_rng(seed)
    labels = np.repeat(rng.integers(0, classes, size=8), -(-length // 8))[:length]
    predicted = labels.copy()
    flip = rng.random(length) < 0.3
    predicted[flip] = rng.integers(0, classes, size=flip.sum())
    return labels.astype(np.int64), predicted


def _metrics(mod, classes):
    return [mod.F1Score(classes), mod.EditScore(classes), mod.ConfusionMatrix(classes)]


def run_training(params, mesh=None, dropout=0.0, remat=False):
    """Two epochs and an evaluation of the port's Trainer from ``params``
    (with ``arch.remat`` if ``remat``)."""
    from stgx_torch.graph import load_skeleton
    from stgx_torch.models.rtstgcn import RtStgcn
    from stgx_torch.parallel.loop import OptimizerConfig, Trainer
    from stgx_torch.utils import metrics
    from stgx_torch.utils.loss import Loss
    from stgx_torch.weights import from_jax_params

    model = RtStgcn(**ARCH, graph=load_skeleton("imu_fogit_ABCD"), dropout=(dropout, 0.0),
                    remat=remat, device="cpu")
    model.load_state_dict(from_jax_params(params, model), strict=True)
    trainer = Trainer(model=model, kind="frame", loss=Loss(np.ones(CLASSES, np.float32)),
                      opt=OptimizerConfig(learning_rate=LR, batch_size=4, epochs=EPOCHS),
                      bucket=32, trial_batch=4, mesh=mesh)
    dataset = make_dataset()
    out = {"train": []}
    for epoch in range(EPOCHS):
        tr = trainer.train_epoch(dataset, epoch)
        out["train"].append([tr["ce"], tr["mse"], tr["top1"], tr["top5"]])
    ms = _metrics(metrics, CLASSES)
    ev = trainer.evaluate(dataset[:6], metrics=ms)
    out["eval"] = [ev["ce"], ev["mse"], ev["top1"], ev["top5"]]
    out["metrics"] = [np.asarray(m.metric) for m in ms]
    out["params"] = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    return out


def _reduced_metrics(rank, world, visit=None):
    """Metrics over this rank's block of 6 trials (4 + 2), reduced."""
    from stgx_torch.utils import metrics

    trials = [_trial(s) for s in range(6)]
    mine = trials[:4] if rank == 0 else trials[4:]
    ms = _metrics(metrics, 5)
    for m in ms:
        m.init_metric(len(mine) if visit is None else 5)
    for y, p in mine[: None if visit is None else visit[rank]]:
        for m in ms:
            m(y, p)
    for m in ms:
        m.reduce()
    return [np.asarray(m.metric) for m in ms]


def _resumed(params, mesh, ckpt_dir):
    """Epoch 1 of a run resumed from the ``epoch-0`` checkpoint that rank 0
    wrote, and the unbroken run's parameters after it."""
    from stgx_torch.graph import load_skeleton
    from stgx_torch.models.rtstgcn import RtStgcn
    from stgx_torch.parallel.loop import OptimizerConfig, Trainer
    from stgx_torch.utils.loss import Loss
    from stgx_torch.weights import from_jax_params

    def trainer():
        model = RtStgcn(**ARCH, graph=load_skeleton("imu_fogit_ABCD"),
                        dropout=(DROPOUT, 0.0), device="cpu")
        model.load_state_dict(from_jax_params(params, model), strict=True)
        return Trainer(model=model, kind="frame", loss=Loss(np.ones(CLASSES, np.float32)),
                       opt=OptimizerConfig(learning_rate=LR, batch_size=4, epochs=EPOCHS,
                                           learning_rate_decay=0.5),
                       bucket=32, trial_batch=4, mesh=mesh)

    dataset = make_dataset()
    unbroken = trainer()
    unbroken.train_epoch(dataset, 0)
    path = unbroken.save(ckpt_dir, 0)
    unbroken.train_epoch(dataset, 1)
    resumed = trainer()
    assert resumed.restore(path) == 0
    resumed.train_epoch(dataset, 1)
    return [{k: v.numpy().copy() for k, v in t.model.state_dict().items()}
            for t in (unbroken, resumed)]


def _ranks(rank, world, params, ckpt_dir):
    from stgx_torch.parallel.mesh import make_mesh

    out = {}
    for layout, (data, seq) in LAYOUTS.items():
        mesh = make_mesh(data=data, seq=seq)
        for dropout in (0.0, DROPOUT):
            out[layout, dropout] = run_training(params, mesh, dropout)
        out[layout, "remat"] = run_training(params, mesh, DROPOUT, remat=True)
    out["resumed"] = _resumed(params, make_mesh(data=1, seq=2), ckpt_dir)
    out["metrics"] = _reduced_metrics(rank, world)
    out["truncated"] = _reduced_metrics(rank, world, visit=(2, 1))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX one-device run, the port's one-process runs and both ranks'
    runs, from the same initial parameters."""
    import jax

    from stgx.graph import load_skeleton
    from stgx.models.rtstgcn import RtStgcn as JRtStgcn
    from stgx.parallel.loop import OptimizerConfig as JOptimizerConfig
    from stgx.parallel.loop import Trainer as JTrainer
    from stgx.utils import metrics as j_metrics
    from stgx.utils.loss import Loss as JLoss

    jm = JRtStgcn(**ARCH, graph=load_skeleton("imu_fogit_ABCD"), dropout=(0.0, 0.0))
    jt = JTrainer(model=jm, kind="frame", loss=JLoss(np.ones(CLASSES, np.float32)),
                  opt=JOptimizerConfig(learning_rate=LR, batch_size=4, epochs=EPOCHS),
                  bucket=32, trial_batch=4)
    dataset = make_dataset()
    params, opt_state = jt.init(dataset[0][0][None])
    params = jax.tree.map(np.asarray, params)
    j_out = {"train": []}
    p = params
    for epoch in range(EPOCHS):
        p, opt_state, tr = jt.train_epoch(p, opt_state, dataset, epoch)
        j_out["train"].append([tr["ce"], tr["mse"], tr["top1"], tr["top5"]])
    ms = _metrics(j_metrics, CLASSES)
    ev = jt.evaluate(p, dataset[:6], metrics=ms)
    j_out["eval"] = [ev["ce"], ev["mse"], ev["top1"], ev["top5"]]
    j_out["metrics"] = [np.asarray(m.metric) for m in ms]
    j_out["params"] = jax.tree.map(np.asarray, p)
    tmp = tmp_path_factory.mktemp("dist_train")
    ranks = spawn(_ranks, 2, tmp, params, str(tmp), timeout=300)
    return {"jax": j_out, "one": run_training(params, dropout=DROPOUT), "ranks": ranks}


def _same_run(got, ref, params_ref):
    np.testing.assert_allclose(got["train"], ref["train"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["eval"], ref["eval"], rtol=1e-5, atol=1e-6)
    for a, b in zip(got["metrics"], ref["metrics"]):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    bound = 2 * LR * EPOCHS * 3  # Adam moves a parameter by about lr a step, 3 steps an epoch
    for name, value in got["params"].items():
        assert np.abs(value - params_ref[name]).max() <= 1e-3 * bound, name


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_two_rank_training_matches_the_jax_trainer(runs, layout):
    from stgx_torch.graph import load_skeleton
    from stgx_torch.models.rtstgcn import RtStgcn
    from stgx_torch.weights import from_jax_params

    got = runs["ranks"][0][layout, 0.0]
    tm = RtStgcn(**ARCH, graph=load_skeleton("imu_fogit_ABCD"), device="cpu")
    ref_params = {k: v.numpy() for k, v in from_jax_params(runs["jax"]["params"], tm).items()}
    _same_run(got, runs["jax"], ref_params)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_two_rank_training_with_dropout_matches_one_process(runs, layout):
    got = runs["ranks"][0][layout, DROPOUT]
    _same_run(got, runs["one"], runs["one"]["params"])
    assert got["params"].keys() == runs["one"]["params"].keys()


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("dropout", [0.0, DROPOUT])
def test_both_ranks_end_equal(runs, layout, dropout):
    a, b = (r[layout, dropout] for r in runs["ranks"])
    assert a["train"] == b["train"] and a["eval"] == b["eval"]
    for x, y in zip(a["metrics"], b["metrics"]):
        np.testing.assert_array_equal(x, y)
    for name in a["params"]:
        np.testing.assert_array_equal(a["params"][name], b["params"][name])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_two_rank_remat_training_with_dropout_equals_the_stored_run(runs, layout):
    for r in runs["ranks"]:
        got, ref = r[layout, "remat"], r[layout, DROPOUT]
        assert got["train"] == ref["train"] and got["eval"] == ref["eval"]
        for name, value in ref["params"].items():
            np.testing.assert_array_equal(got["params"][name], value, err_msg=name)


def test_two_rank_run_resumed_from_epoch_0_equals_the_unbroken_run(runs):
    """``seq=2``, dropout, the learning rate halved an epoch: rank 0 writes
    ``epoch-0``, both ranks restore it, and epoch 1 ends where the unbroken
    run's does, bit for bit."""
    for r in runs["ranks"]:
        unbroken, resumed = r["resumed"]
        for name, value in unbroken.items():
            np.testing.assert_array_equal(resumed[name], value, err_msg=name)


def test_metrics_reduced_across_ranks_match_one_process(runs):
    from stgx.utils import metrics as j_metrics
    from stgx_torch.utils import metrics

    trials = [_trial(s) for s in range(6)]
    for mod in (metrics, j_metrics):
        ms = _metrics(mod, 5)
        for m in ms:
            m.init_metric(len(trials))
        for y, p in trials:
            for m in ms:
                m(y, p)
        for m in ms:
            m.reduce()
        for r in runs["ranks"]:
            for got, m in zip(r["metrics"], ms):
                np.testing.assert_allclose(got, m.metric, rtol=1e-6)


def test_truncated_reduce_averages_only_visited_rows(runs):
    """Capacity 5 a rank, trials 0, 1 visited on rank 0 and 4 on rank 1:
    the mean over those 3 rows, not over zero-filled ones."""
    from stgx_torch.utils import metrics

    visited = [_trial(s) for s in (0, 1, 4)]
    ms = _metrics(metrics, 5)
    for m in ms:
        m.init_metric(3)
    for y, p in visited:
        for m in ms:
            m(y, p)
    for m in ms:
        m.reduce()
    for r in runs["ranks"]:
        for got, m in zip(r["truncated"], ms):
            np.testing.assert_allclose(got, m.metric, rtol=1e-6)


def test_cli_train_two_process_session(tmp_path):
    """``python -m stgx_torch.cli train`` as 2 processes on one config."""
    from stgx_torch.cli import main
    from stgx_torch.data.synth import generate

    data = str(tmp_path / "synth")
    generate(data, skeleton="imu_fogit_ABCD", num_classes=4, in_feat=6, num_train=4,
             num_val=2, min_len=40, max_len=80, seed=1)
    cfg = {
        "processor": {"model": "rt-st-gcn", "data": data, "out": None,
                      "actions": os.path.join(data, "actions.txt"), "graph": "imu_fogit_ABCD",
                      "demo": [0], "iou_threshold": [0.5], "prefetch": 0},
        "arch": {"in_feat": 6, "kernel": 3, "normalization": "BatchNorm",
                 "rt-st-gcn": {"importance": True, "in_ch": [8, 8], "out_ch": [8, 8],
                               "stride": [1, 2], "residual": [1, 1], "dropout": [0.2, 0]}},
        "optimizer": {"seed": 7, "epochs": 1, "checkpoint_indices": [0], "learning_rate": 2e-3,
                      "learning_rate_decay": 1.0, "batch_size": 2},
        "job": {"verbose": 0, "platform": "cpu", "mesh": {"seq": 2},
                "distributed": {"init_method": f"file://{tmp_path / 'store'}",
                                "num_processes": 2}},
    }
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    outs = [tmp_path / "out0", tmp_path / "out1"]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "stgx_torch.cli", "train", "--config", str(path),
         "--set", f"processor.out=\"{outs[pid]}\""],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=dict(os.environ, STGX_PROCESS_ID=str(pid), OMP_NUM_THREADS="1"))
        for pid in (0, 1)]
    try:
        logs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (stdout, stderr) in zip(procs, logs):
        assert p.returncode == 0, stderr[-3000:]
    lines = [log.replace(str(out), "OUT") for (log, _), out in zip(logs, outs)]
    assert lines[0] == lines[1] and "[epoch 0]" in lines[0]  # the out dirs named apart
    for name in ("train-validation-curve.csv", "accuracy-curve.csv", "macro-F1@k-0.csv",
                 "edit-0.csv", "confusion-matrix-0.csv", "segmentation-0.csv", "epoch-0",
                 "final"):
        assert (outs[0] / name).exists(), name
    assert os.listdir(outs[1]) == []
    cfg["processor"]["out"] = str(outs[0])
    del cfg["job"]["distributed"], cfg["job"]["mesh"]
    path.write_text(json.dumps(cfg))
    assert main(["test", "--config", str(path), "--set",
                 f"processor.checkpoint=\"{outs[0] / 'final'}\""]) == 0
    assert (outs[0] / "accuracy.csv").exists()
