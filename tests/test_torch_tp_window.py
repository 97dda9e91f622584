"""Tensor parallelism (the mesh's ``model`` axis) for the window and
multi-stage families of the port — ST-GCN, AA-GCN, MS-GCN (``window`` and
``window_ms`` kinds, their graph convs through ``gcn_core`` /
``gcn_grads``' plain versions here) and the unpipelined MS-TCN
(``frame_ms``) — on gloo ranks against the JAX ``Trainer`` on one device.

One ``Trainer.grad_step`` (forward, loss and backward of 4 windows of 16
frames, one masked out whole; MS-GCN's 8 windows of 12; MS-TCN's 2 trials
of 16 frames, one padded by 4) with the parameters channel-sharded at
``model`` 2 and 4 and on the ``data`` 2 × ``model`` 2 mesh, each family
with LayerNorm (moments summed over ``model``) and BatchNorm (statistics
over ``data``), MS-TCN without a norm: the loss within ``rtol = 1e-5`` and
every gradient, gathered whole, within ``atol = 1e-5`` of the JAX step
(``tests/test_tp.py``'s tolerances). Under ``data`` MS-GCN's generator
runs on each rank's windows and its scores are gathered whole for the
refinement, which convolves across the windows.

``arch.remat`` under the mesh (:data:`REMAT`: every family once, at
``model`` 2 and on ``data`` 2 × ``model`` 2): each layer's recompute in the
backward pass runs under the layout the layer ran under, its collectives
(BatchNorm's sums over ``data``, LayerNorm's over ``model``, the channel
gathers) again in the same order on every rank. The step equals the stored
step on the same mesh bit for bit, and so the JAX step within the bounds
above.

Each world size (2, 4) is one gloo session that runs all its cases,
started before the JAX references are computed (:mod:`torch_tp_cases`).

And ``python -m stgx_torch.cli train`` of a window family, Shift-GCN, as 2
processes with ``job.mesh.model = 2``, whose ``final`` checkpoint the
one-process ``test`` reads back.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_tp_cases as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("st-gcn", "aa-gcn", "ms-gcn", "ms-tcn")
CASES = T.cases(NAMES)
REMAT = ((("st-gcn", "BatchNorm"), "data2-model2"), (("aa-gcn", "LayerNorm"), "model2"),
         (("ms-gcn", "BatchNorm"), "data2-model2"), (("ms-tcn", "LayerNorm"), "data2-model2"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    states = T.states(NAMES)
    return T.sessions(T.ranks, tmp_path_factory, states, T.LAYOUTS, states, REMAT)


@pytest.mark.parametrize("case", CASES, ids=[f"{n}-{m}" for n, m in CASES])
@pytest.mark.parametrize("layout", list(T.LAYOUTS))
def test_tp_step_matches_single_device(runs, layout, case):
    refs, outs = runs
    for rank, out in enumerate(outs[T.world(layout)]):  # every rank ends with the whole step
        T.assert_step_matches(out[case, layout], refs[case], what=f"rank {rank}")


@pytest.mark.parametrize("case,layout", REMAT, ids=[f"{n}-{m}-{lay}" for (n, m), lay in REMAT])
def test_remat_step_equals_the_stored_step(runs, case, layout):
    refs, outs = runs
    T.assert_remat_step(outs[T.world(layout)], (case, layout), refs[case])


def test_cli_trains_shift_gcn_tensor_parallel(tmp_path):
    """``python -m stgx_torch.cli train`` of Shift-GCN (tiny widths, W = 12,
    LayerNorm) as 2 processes with ``job.mesh.model = 2``: both log the same
    lines, rank 0 writes a ``final`` checkpoint of whole parameters, and the
    one-process ``test`` on it gives the last epoch's validation top-1 and CE
    again."""
    from stgx_torch.cli import main
    from stgx_torch.data.synth import generate

    data = str(tmp_path / "data")
    generate(data, skeleton=T.SKELETON, num_classes=4, in_feat=T.C_IN, num_train=3,
             num_val=2, min_len=20, max_len=40, seed=1)
    cfg = {
        "processor": {"model": "shift-gcn", "data": data, "out": None,
                      "actions": os.path.join(data, "actions.txt"), "graph": T.SKELETON,
                      "demo": [0], "iou_threshold": [0.5], "prefetch": 0},
        "arch": {"in_feat": T.C_IN, "normalization": "LayerNorm", "receptive_field": 12,
                 "segment": 16,
                 "shift-gcn": {"in_ch": [T.C_IN, 8], "out_ch": [8, 8], "stride": [1, 1],
                               "residual": [0, 1]}},
        "optimizer": {"seed": 7, "epochs": 1, "checkpoint_indices": [], "learning_rate": 2e-3,
                      "learning_rate_decay": 1.0, "batch_size": 2},
        "job": {"verbose": 0, "platform": "cpu", "mesh": {"model": 2},
                "distributed": {"init_method": f"file://{tmp_path / 'store'}",
                                "num_processes": 2}},
    }
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    outs = [tmp_path / "out0", tmp_path / "out1"]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "stgx_torch.cli", "train", "--config", str(path), "--set",
         f"processor.out={json.dumps(str(outs[r]))}"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=dict(os.environ, STGX_PROCESS_ID=str(r), OMP_NUM_THREADS="1")) for r in (0, 1)]
    try:
        logs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, stderr) in zip(procs, logs):
        assert p.returncode == 0, stderr[-3000:]
    lines = [log.replace(str(out), "OUT") for (log, _), out in zip(logs, outs)]
    assert lines[0] == lines[1] and "[epoch 0]" in lines[0]
    final = torch.load(outs[0] / "final", weights_only=True)["model"]
    assert final["units.1.temporal.linear_kernel"].shape == (8, 8)  # whole, not a block
    assert final["units.0.spatial.kernel"].shape == (T.C_IN, 8)
    cfg["processor"]["out"] = str(outs[0])
    cfg["job"] = {"platform": "cpu"}
    path.write_text(json.dumps(cfg))
    assert main(["test", "--config", str(path), "--set",
                 f"processor.checkpoint={json.dumps(str(outs[0] / 'final'))}"]) == 0
    with open(outs[0] / "accuracy.csv") as f:
        top1, _, ce, _ = (float(v) for v in f.read().splitlines()[1].split(","))
    assert f"val ce={ce:.3f} top1={top1:.3f}" in lines[0]
