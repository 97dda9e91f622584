"""Pipeline parallelism of the port (``stgx_torch.parallel.pipeline``: the
MS-TCN / MS-GCN refinement stages one a rank of the mesh's ``model`` axis)
on 8 gloo ranks against the JAX package on one device — the counterpart of
``tests/test_pipeline.py``, case for case, with its tolerances.

* The pipelined MS-TCN forward (5 stages, 4 refined over ``model`` = 4,
  the batch's 4 trials split over ``data`` = 2) equals the JAX model's
  within ``1e-5``; so does a single trial (one microbatch, the data ranks
  replicas) and MS-GCN's pipelined refinement of an ST-GCN generator's
  window logits.
* Its gradients: the mean squared error's value within ``rtol = 1e-5`` and
  every parameter's gradient within ``atol = 1e-5`` of ``jax.value_and_grad``
  of the sequential model, after the sums the ``Trainer`` makes (over the
  data ranks; the stages, which only their rank reaches, over ``model``).
* A stage count other than the ``model`` axis's and a refinement plan that
  is not stage-uniform raise ``ValueError``; ``stack_stage_params`` stacks.
* The pipelined ``Trainer`` epoch on the ``(1, 2, 4)`` mesh (the ``seq``
  ranks replicas, as the JAX pipeline makes them) equals the JAX
  sequential ``Trainer``: ce within ``rtol = 1e-4``, the evaluation's
  top-1 within ``1e-6``, the parameters within ``atol = 1e-4``,
  ``rtol = 1e-3``, and every rank ends with the same parameters. The JAX
  checks of a pipelined ``Trainer`` (the kind, a ``model`` axis, zero
  dropout) raise their ``ValueError`` s. With ``arch.remat`` the stages keep
  it, as the JAX pipeline does (each layer recomputed in the schedule's
  backward): the epoch's losses, evaluation and parameters equal the
  stored epoch's bit for bit on every rank.
* ``python -m stgx_torch.cli train --config configs/synth/mstcn_pp.json``
  over its 8 gloo processes (``data`` 1, ``seq`` 2, ``model`` 4) against
  ``stgx.cli.cmd_train`` on the same data and the same starting weights (a
  reference-format checkpoint), the JAX side without its mesh (its
  pipelined ``Trainer`` equals its sequential one, ``tests/test_pipeline.py``):
  every process exits 0 with the same log, and the curve's losses agree
  within ``rtol = 1e-4`` and its top-1 / top-5 within ``1e-6``.
"""

import csv
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_spawn import spawn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, C_IN, CLASSES = 7, 6, 5
MSTCN = dict(num_classes=CLASSES, in_feat=C_IN, stages=5, filters=(8,) * 5, layers=(2,) * 5,
             kernel=(3,) * 5, dropout=(0.0,) * 5)
MSGCN = dict(num_classes=CLASSES, in_feat=C_IN, normalization="LayerNorm", kernel=3,
             in_ch=(8, 16), out_ch=(16, 16), stride=(1, 1), residual=(1, 1),
             dropout=(0.0, 0.0), stages=4, filters=(8,) * 4, layers=(2,) * 4,
             refine_kernel=(3,) * 4, refine_dropout=(0.0,) * 4)
TRIALS, FRAMES, LR, BATCH = 4, 64, 1e-3, 2


def _inputs():
    rng = np.random.default_rng(0)
    return {
        "forward": rng.normal(size=(4, 32, V, C_IN)).astype(np.float32),
        "grad_x": rng.normal(size=(4, 16, V, C_IN)).astype(np.float32),
        "grad_y": rng.normal(size=(5, 4, 16, CLASSES)).astype(np.float32),
        "single": rng.normal(size=(1, 24, V, C_IN)).astype(np.float32),
        "windows": rng.normal(size=(16, 8, V, C_IN)).astype(np.float32),
    }


def _trials():
    rng = np.random.default_rng(3)
    return [(rng.normal(size=(FRAMES, V, C_IN)).astype(np.float32),
             rng.integers(0, CLASSES, size=(FRAMES,)).astype(np.int64)) for _ in range(TRIALS)]


def _port(cls, kw, params):
    from stgx_torch.weights import from_jax_params

    model = cls(**kw, device="cpu")
    model.load_state_dict(from_jax_params(params, model), strict=True)
    return model


def _pipelined_runs(mesh, params, inputs):
    """The forwards and the gradients on the ``(2, 1, 4)`` mesh: this data
    rank's block of each output, the loss and the summed gradients."""
    from stgx_torch.graph import load_skeleton
    from stgx_torch.models import MsGcn, MsTcn
    from stgx_torch.parallel.mesh import reduce_scalars, shard_batch
    from stgx_torch.parallel.pipeline import (
        msgcn_refine_pipelined,
        mstcn_apply_pipelined,
        pipeline_apply,
        stage_parameters,
    )
    from stgx_torch.parallel.tp import sum_partial_grads

    out = {}
    model = _port(MsTcn, MSTCN, params["ms-tcn"])
    with torch.no_grad():
        out["forward"] = mstcn_apply_pipelined(
            model, shard_batch(mesh, torch.tensor(inputs["forward"])), mesh).numpy()
        out["single"] = mstcn_apply_pipelined(model, torch.tensor(inputs["single"]),
                                              mesh).numpy()
    # gradients: each data rank's share of the mean, summed as the Trainer sums
    x = shard_batch(mesh, torch.tensor(inputs["grad_x"]))
    target = torch.tensor(inputs["grad_y"]).transpose(0, 1)
    target = shard_batch(mesh, target).transpose(0, 1)
    loss = ((mstcn_apply_pipelined(model, x, mesh) - target) ** 2).sum() / inputs["grad_y"].size
    names, ps = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, ps)
    grads = sum_partial_grads(list(grads), mesh.shards(True, False).group)
    stages = [i for i, n in enumerate(names) if n in stage_parameters(model)]
    for i, total in zip(stages, sum_partial_grads([grads[i] for i in stages],
                                                  mesh.split("model").group)):
        grads[i] = total
    out["loss"] = reduce_scalars([loss], mesh.shards(True, False).group, mesh.device)[0]
    out["grads"] = {n: g.numpy() for n, g in zip(names, grads)}

    gcn = _port(MsGcn, dict(MSGCN, graph=load_skeleton("imu_fogit_ABCD")), params["ms-gcn"])
    with torch.no_grad():
        logits = gcn.generator_stage(torch.tensor(inputs["windows"]))[None]
        out["msgcn"] = msgcn_refine_pipelined(gcn, logits, mesh).numpy()
    try:
        pipeline_apply(lambda p, y: y, {"w": torch.zeros((3, 2, 2))}, torch.zeros((4, 8)), mesh)
        out["stage count"] = "no error"
    except ValueError as e:
        out["stage count"] = str(e)
    return out


def _trainer(model, mesh=None, pipeline=False, kind="frame_ms"):
    from stgx_torch.parallel.loop import OptimizerConfig, Trainer
    from stgx_torch.utils import LOSS

    return Trainer(model=model, kind=kind, loss=LOSS["ms-tcn"](np.ones(CLASSES, np.float32)),
                   opt=OptimizerConfig(learning_rate=LR, batch_size=BATCH, epochs=1),
                   mesh=mesh, bucket=FRAMES, pipeline=pipeline)


def _epoch(mesh, params):
    """One pipelined Trainer epoch and an evaluation on the (1, 2, 4) mesh;
    the validation errors of a pipelined Trainer."""
    from stgx_torch.models import MsTcn

    out = {}
    for key, remat in (("", False), ("remat ", True)):
        tr = _trainer(_port(MsTcn, dict(MSTCN, remat=remat), params["ms-tcn"]), mesh,
                      pipeline=True)
        stats = tr.train_epoch(_trials(), 0)
        out.update({f"{key}stats": stats, f"{key}eval": tr.evaluate(_trials()),
                    f"{key}params": {k: v.detach().numpy()
                                     for k, v in tr.model.state_dict().items()}})
    try:
        _trainer(MsTcn(**dict(MSTCN, dropout=(0.1,) * 5), device="cpu"), mesh, pipeline=True)
        out["dropout"] = "no error"
    except ValueError as e:
        out["dropout"] = str(e)
    return out


def _ranks(rank, world, params, inputs):
    from stgx_torch.parallel.mesh import make_mesh

    return {"pipelined": _pipelined_runs(make_mesh(2, 1, 4), params, inputs),
            "epoch": _epoch(make_mesh(1, 2, 4), params)}


@pytest.fixture(scope="module")
def jax_ref():
    """Parameters (the port's init, moved off it) and every JAX result."""
    import jax
    import jax.numpy as jnp

    from stgx.graph import load_skeleton as j_load_skeleton
    from stgx.models import MODELS as J_MODELS
    from stgx.parallel.loop import OptimizerConfig as JOpt, Trainer as JTrainer
    from stgx.utils import LOSS as J_LOSS
    from stgx_torch.graph import load_skeleton
    from stgx_torch.models import MsGcn, MsTcn
    from stgx_torch.weights import to_jax_params

    rng = np.random.default_rng(1)

    def moved(tree):
        return jax.tree.map(lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32),
                            tree)

    params = {"ms-tcn": moved(to_jax_params(MsTcn(**MSTCN, device="cpu"))),
              "ms-gcn": moved(to_jax_params(MsGcn(**MSGCN, graph=load_skeleton("imu_fogit_ABCD"),
                                                  device="cpu")))}
    inputs = _inputs()
    jm = J_MODELS["ms-tcn"](**MSTCN)
    ref = {"forward": np.asarray(jax.jit(jm.apply)(params["ms-tcn"], inputs["forward"])),
           "single": np.asarray(jax.jit(jm.apply)(params["ms-tcn"], inputs["single"]))}

    def seq_loss(p):
        return jnp.mean((jm.apply(p, inputs["grad_x"], train=True) - inputs["grad_y"]) ** 2)

    ref["loss"], grads = jax.jit(jax.value_and_grad(seq_loss))(params["ms-tcn"])
    ref["grads"] = jax.tree.map(np.asarray, grads)
    gkw = dict(MSGCN, graph=j_load_skeleton("imu_fogit_ABCD"))
    ref["msgcn"] = np.asarray(jax.jit(J_MODELS["ms-gcn"](**gkw).apply)(params["ms-gcn"],
                                                                        inputs["windows"]))

    tr = JTrainer(model=jm, kind="frame_ms", loss=J_LOSS["ms-tcn"](np.ones(CLASSES, np.float32)),
                  opt=JOpt(learning_rate=LR, batch_size=BATCH, epochs=1), bucket=FRAMES)
    p = jax.tree.map(jnp.asarray, params["ms-tcn"])
    p, _, stats = tr.train_epoch(p, tr.tx.init(p), _trials(), 0)
    ref["epoch"] = (stats, tr.evaluate(p, _trials()), jax.tree.map(np.asarray, p))
    return params, inputs, ref


@pytest.fixture(scope="module")
def runs(jax_ref, tmp_path_factory):
    params, inputs, _ = jax_ref
    return spawn(_ranks, 8, tmp_path_factory.mktemp("pipeline"), params, inputs, timeout=300)


def _data_block(a, rank, axis=0):
    """Rank ``rank``'s block of ``a`` on the (2, 1, 4) mesh (data index
    rank // 4)."""
    step = a.shape[axis] // 2
    return np.take(a, range((rank // 4) * step, (rank // 4 + 1) * step), axis=axis)


@pytest.mark.parametrize("what", ["forward", "single"])
def test_mstcn_pipeline_matches_sequential(runs, jax_ref, what):
    ref = jax_ref[2][what]
    for rank, out in enumerate(runs):
        want = ref if what == "single" else _data_block(ref, rank, axis=1)
        assert out["pipelined"][what].shape == want.shape
        np.testing.assert_allclose(out["pipelined"][what], want, atol=1e-5)


def test_mstcn_pipeline_gradients_match(runs, jax_ref):
    from stgx_torch.models import MsTcn
    from stgx_torch.weights import from_jax_params

    ref = jax_ref[2]
    ref_grads = {k: v.numpy() for k, v in
                 from_jax_params(ref["grads"], MsTcn(**MSTCN, device="cpu")).items()}
    for rank, out in enumerate(runs):
        np.testing.assert_allclose(out["pipelined"]["loss"], float(ref["loss"]), rtol=1e-5)
        assert set(out["pipelined"]["grads"]) == set(ref_grads)
        for k, g in out["pipelined"]["grads"].items():
            np.testing.assert_allclose(g, ref_grads[k], atol=1e-5, err_msg=f"rank {rank}: {k}")


def test_msgcn_refine_pipeline_matches_sequential(runs, jax_ref):
    ref = jax_ref[2]["msgcn"]
    for out in runs:
        assert out["pipelined"]["msgcn"].shape == ref.shape == (5, 1, 16, CLASSES)
        np.testing.assert_allclose(out["pipelined"]["msgcn"], ref, atol=1e-5)


def test_pipeline_stage_count_mismatch_raises(runs):
    assert all("stage count 3" in out["pipelined"]["stage count"] for out in runs)


def test_stack_stage_params():
    from stgx_torch.parallel.pipeline import stack_stage_params

    p = {"S_0": {"w": torch.ones(2)}, "S_1": {"w": torch.full((2,), 2.0)}}
    np.testing.assert_allclose(stack_stage_params(p, ["S_0", "S_1"])["w"].numpy(),
                               [[1.0, 1.0], [2.0, 2.0]])


def test_pipeline_needs_a_uniform_refinement_plan():
    from stgx_torch.models import MsTcn
    from stgx_torch.parallel.pipeline import uniform_refine

    assert uniform_refine(MsTcn(**MSTCN, device="cpu"), 1) == (8, 2, 3, 0.0)
    mixed = MsTcn(**dict(MSTCN, filters=(8, 8, 8, 8, 16)), device="cpu")
    with pytest.raises(ValueError, match="stage-uniform"):
        uniform_refine(mixed, 1)


def test_trainer_pipelined_epoch_matches_sequential(runs, jax_ref):
    from stgx_torch.models import MsTcn
    from stgx_torch.weights import from_jax_params

    stats, ev, params = jax_ref[2]["epoch"]
    ref = {k: v.numpy() for k, v in from_jax_params(params, MsTcn(**MSTCN, device="cpu")).items()}
    first = runs[0]["epoch"]["params"]
    for out in runs:
        got = out["epoch"]
        np.testing.assert_allclose(got["stats"]["ce"], stats["ce"], rtol=1e-4)
        np.testing.assert_allclose(got["eval"]["top1"], ev["top1"], rtol=1e-6)
        for k, v in got["params"].items():
            np.testing.assert_allclose(v, ref[k], atol=1e-4, rtol=1e-3, err_msg=k)
            np.testing.assert_array_equal(v, first[k])  # every rank the same parameters


def test_trainer_pipelined_remat_epoch_equals_the_stored_one(runs):
    for out in runs:
        got = out["epoch"]
        for key in ("ce", "mse", "top1", "top5"):
            assert got["remat stats"][key] == got["stats"][key], key
            assert got["remat eval"][key] == got["eval"][key], key
        for k, v in got["params"].items():
            np.testing.assert_array_equal(got["remat params"][k], v, err_msg=k)


def test_trainer_pipeline_validation(runs):
    from stgx_torch.models import MsTcn

    model = MsTcn(**MSTCN, device="cpu")
    with pytest.raises(ValueError, match="ms-tcn"):
        _trainer(model, pipeline=True, kind="frame")
    with pytest.raises(ValueError, match="model"):
        _trainer(model, pipeline=True)
    assert all("zero dropout" in out["epoch"]["dropout"] for out in runs)


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_cli_trains_the_pipelined_config_over_8_processes(tmp_path):
    """configs/synth/mstcn_pp.json through the port's CLI on 8 gloo
    processes, against the JAX CLI on one device."""
    import jax

    from stgx.cli import cmd_train as j_cmd_train
    from stgx.config import load_config as j_load_config
    from stgx.models import MODELS as J_MODELS
    from stgx.utils.torch_import import export_reference_state_dict
    from stgx_torch.data.synth import generate

    data = str(tmp_path / "data")
    info = generate(data, skeleton="imu_fogit_ABCD", num_classes=CLASSES, in_feat=C_IN,
                    num_train=4, num_val=2, min_len=48, max_len=96, seed=2)
    with open(os.path.join(REPO, "configs/synth/mstcn_pp.json")) as f:
        cfg = json.load(f)
    arch = dict(cfg["arch"]["ms-tcn"], num_classes=info["num_classes"], in_feat=C_IN)
    jm = J_MODELS["ms-tcn"](**{k: tuple(v) if isinstance(v, list) else v for k, v in arch.items()})
    rng = np.random.default_rng(4)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=np.shape(a)).astype(np.float32),
        jm.init(jax.random.PRNGKey(3), np.zeros((1, 16, V, C_IN), np.float32)))
    ref_pt = str(tmp_path / "reference.pt")
    torch.save({"epoch": 0, "model_state_dict": {
        k: torch.tensor(v) for k, v in export_reference_state_dict(params, jm, "ms-tcn").items()}},
        ref_pt)
    cfg["processor"].update(data=data, actions=os.path.join(data, "actions.txt"),
                            torch_checkpoint=ref_pt, torch_resume=False, prefetch=0)
    overrides = {"processor": dict(cfg["processor"]),
                 "job": {"platform": "cpu", "distributed": {
                     "init_method": f"file://{tmp_path / 'store'}", "num_processes": 8}}}
    path = tmp_path / "overrides.json"
    outs = [tmp_path / f"out{r}" for r in range(8)]
    procs = []
    for r in range(8):
        sets = [f"processor.{k}={json.dumps(v)}" for k, v in overrides["processor"].items()
                if k != "out"]
        sets += [f"processor.out={json.dumps(str(outs[r]))}", "job.platform=\"cpu\"",
                 f"job.distributed={json.dumps(overrides['job']['distributed'])}"]
        argv = [sys.executable, "-m", "stgx_torch.cli", "train", "--config",
                "configs/synth/mstcn_pp.json"]
        for item in sets:
            argv += ["--set", item]
        procs.append(subprocess.Popen(
            argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
            env=dict(os.environ, STGX_PROCESS_ID=str(r), OMP_NUM_THREADS="1")))
    try:
        logs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, stderr) in zip(procs, logs):
        assert p.returncode == 0, stderr[-3000:]
    lines = {log.replace(str(out), "OUT") for (log, _), out in zip(logs, outs)}
    assert len(lines) == 1 and "[epoch 1]" in lines.pop()
    assert all(not os.listdir(out) for out in outs[1:])  # rank 0 alone writes

    cfg["processor"]["out"] = str(tmp_path / "jax")
    cfg["job"] = {"platform": "cpu"}  # one device: its pipelined Trainer equals this one
    cfg["arch"].pop("pipeline")
    path.write_text(json.dumps(cfg))
    assert j_cmd_train(j_load_config(str(path))) == 0
    got = np.asarray(_rows(outs[0] / "train-validation-curve.csv")[1:], float)
    ref = np.asarray(_rows(tmp_path / "jax" / "train-validation-curve.csv")[1:], float)
    assert got.shape == ref.shape == (2, 11)
    np.testing.assert_allclose(got[:, 1:5], ref[:, 1:5], rtol=1e-4)  # ce and mse
    np.testing.assert_allclose(got[:, 5:9], ref[:, 5:9], rtol=1e-6)  # top-1, top-5
