"""Tensor parallelism of the port (``stgx_torch.parallel.tp``, the mesh's
``model`` axis) on gloo ranks against the JAX package on one device — the
counterpart of ``tests/test_tp.py``, case for case.

* The leaf rule, for every family of ``stgx_torch.models.MODELS``: the
  port's sharded set beside GSPMD's (``param_specs_tp`` of both packages,
  the JAX one mapped to the port's names), printed; every difference is a
  leaf the port keeps whole because its activation stays whole
  (``TP_WHOLE``, each with its reason), every other leaf agrees. The port
  shards a leaf of every tensor-parallel module and every layer's
  channel-mixing products (``PRODUCTS``), every parameter there is sharded,
  whole or partial, and the input norms and heads (``HEADS``, named here
  apart from ``TP_WHOLE``), the edge importance, an indivisible head and the
  partial leaves are never sharded.
* One step of the port's ``Trainer`` (``grad_step``: forward, loss and
  backward of 4 trials of 32 frames, one with 6 padding frames) with the
  parameters channel-sharded at ``model`` 2 and 4 and on the ``(2, 2, 2)``
  mesh (trials over ``data``, frames over ``seq``, channels over
  ``model``), for RT-ST-GCN and CoST-GCN (Γ = 3, dilation 2 in CoST's
  second layer), each with LayerNorm (moments summed over ``model``) and
  BatchNorm (statistics over ``data`` and ``seq``): the loss within
  ``rtol = 1e-5`` and every gradient, gathered whole, within
  ``atol = 1e-5`` of ``jax.value_and_grad`` on the whole batch (the JAX
  test's tolerances).
* With dropout (0.3) the ``(2, 2, 2)`` step equals the port's one-process
  step within the same bounds: every rank draws the whole mask and keeps
  its trial, frame and channel block.
* ``replicate`` on the 3-axis mesh still gives a working model.
* The streaming cells (``stream_sequence``) with TP parameters at
  ``model`` 2 and 4 against the JAX cells within ``2e-5``: RT-ST-GCN's,
  each rank keeping the FIFOs of its channel block, and CoST-GCN's, each
  rank keeping its block of the residual FIFO and the whole channels of the
  main FIFO (one frame gathered a layer a step).
* ``arch.remat`` on the ``(2, 2, 2)`` mesh (RT-ST-GCN and CoST-GCN,
  BatchNorm: statistics over ``data`` and ``seq``, window-sum and
  temporal-conv halos over ``seq``, channel gathers over ``model``): the
  step equals the stored step bit for bit, and so the JAX step within the
  bounds above.
* Refusals: a layer width the ``model`` axis does not divide raises
  ``ValueError``; ``remat`` under a mesh, refused before it was ported,
  now builds its ``Trainer`` (RT-ST-GCN at ``model`` 2, MS-TCN outside the
  pipeline and the ``window`` kind under ``seq``).
* ``python -m stgx_torch.cli train`` of CoST-GCN (dropout 0.2) as 2
  processes with ``job.mesh.model = 2``: both log the same lines, rank 0
  writes a ``final`` checkpoint of whole parameters, and the one-process
  ``test`` on it gives the last epoch's validation top-1 and CE again.

Each world size (2, 4, 8) is one gloo session, started at its first use,
that runs all its cases.
"""

import json
import os
import subprocess
import sys
from fnmatch import fnmatchcase

import numpy as np
import pytest
import torch

from test_torch_spawn import spawn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, L, V, C_IN, CLASSES = 4, 32, 7, 6, 5
BASE = dict(kernel=3, in_ch=(8, 16), out_ch=(16, 16), residual=(1, 1), dropout=(0.0, 0.0))
FAMILIES = {"rt-st-gcn": dict(BASE, stride=(1, 1)), "co-st-gcn": dict(BASE, dilation=(1, 2))}
CASES = [(name, norm) for name in FAMILIES for norm in ("LayerNorm", "BatchNorm")]
LAYOUTS = {"model2": (1, 1, 2), "model4": (1, 1, 4), "data-seq-model": (2, 2, 2)}
DROPOUT = 0.3
REMAT = (("rt-st-gcn", "BatchNorm"), ("co-st-gcn", "BatchNorm"))  # on data-seq-model


def _kwargs(name, norm, dropout=0.0, skeleton="imu_fogit_ABCD", **over):
    from stgx_torch.graph import load_skeleton

    arch = dict(FAMILIES[name], dropout=(dropout, dropout), **over)
    return dict(num_classes=CLASSES, in_feat=C_IN, graph=load_skeleton(skeleton),
                normalization=norm, **arch)


def _batch():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, L, V, C_IN)).astype(np.float32)
    y = rng.integers(0, CLASSES, size=(N, L)).astype(np.int64)
    mask = np.ones((N, L), np.float32)
    mask[1, L - 6:] = 0.0  # a trial bucket-padded by 6 frames
    return x, y, mask


def _port_step(name, norm, params, mesh, dropout=0.0, remat=False):
    """Loss and whole gradients of one port ``grad_step`` under ``mesh``
    (None: one process), with ``arch.remat`` if ``remat``."""
    from stgx_torch.models import MODELS
    from stgx_torch.parallel.loop import OptimizerConfig, Trainer
    from stgx_torch.parallel.tp import gather_state
    from stgx_torch.utils import LOSS
    from stgx_torch.weights import from_jax_params

    model = MODELS[name](**_kwargs(name, norm, dropout), remat=remat, device="cpu")
    model.load_state_dict(from_jax_params(params, model), strict=True)
    trainer = Trainer(model=model, kind="frame", loss=LOSS[name](np.ones(CLASSES, np.float32)),
                      opt=OptimizerConfig(), mesh=mesh)
    x, y, mask = (torch.tensor(a) for a in _batch())
    ce, mse, *_ = trainer.grad_step(x, y, mask, 1.0, torch.Generator().manual_seed(5))
    grads = gather_state(model, {k: p.grad for k, p in model.named_parameters()})
    return float(ce) + float(mse), {k: g.numpy() for k, g in grads.items()}


def _stream(name, params, mesh, x):
    """A streaming cell's logits with TP parameters, the graph convs'
    kernel blocks and CoST's first-layer FIFO shapes (None for RT)."""
    from stgx_torch.models import MODELS, costgcn, rtstgcn
    from stgx_torch.parallel.tp import shard_params_tp
    from stgx_torch.weights import from_jax_params

    model = MODELS[name](**_kwargs(name, "LayerNorm"), device="cpu")
    model.load_state_dict(from_jax_params(params, model), strict=True)
    shard_params_tp(model, mesh)
    widths = {tuple(layer.gcn.kernel.shape) for layer in model.layers}
    cell = costgcn if name == "co-st-gcn" else rtstgcn
    logits, state = cell.stream_sequence(model, torch.tensor(x))
    fifos = {k: tuple(v.shape) for k, v in state[0].items()} if cell is costgcn else None
    return logits.numpy(), widths, fifos


def _replicated_forward(mesh):
    from stgx_torch.models import MODELS
    from stgx_torch.parallel.mesh import replicate

    model = MODELS["rt-st-gcn"](**_kwargs("rt-st-gcn", "LayerNorm"), device="cpu")
    replicate(mesh, model)
    with torch.no_grad():
        return tuple(model(torch.zeros((2, 16, V, C_IN))).shape)


def _ranks(rank, world, params, stream_x):
    from stgx_torch.parallel.mesh import make_mesh

    out = {}
    for layout, shape in LAYOUTS.items():
        if int(np.prod(shape)) != world:
            continue
        mesh = make_mesh(*shape)
        for case in CASES:
            out[case, layout] = _port_step(*case, params[case], mesh)
        if shape[2] == world:  # TP alone: the serving cells, the refusals
            for name in FAMILIES:
                out["stream", name, layout] = _stream(name, params[name, "LayerNorm"], mesh,
                                                      stream_x)
            out["refusals", layout] = _refusals_in(mesh)
        else:
            out["dropout", layout] = _port_step("rt-st-gcn", "BatchNorm",
                                                params["rt-st-gcn", "BatchNorm"], mesh, DROPOUT)
            for case in REMAT:
                out[case, layout, "remat"] = _port_step(*case, params[case], mesh, remat=True)
            out["replicate", layout] = _replicated_forward(mesh)
    return out


def _refusals_in(mesh):
    """The messages of what a mesh with a ``model`` axis refuses, or "no
    error" where it trains."""
    from stgx_torch.models import MODELS, Stgcn
    from stgx_torch.parallel.loop import OptimizerConfig, Trainer
    from stgx_torch.parallel.mesh import make_mesh
    from stgx_torch.parallel.tp import shard_params_tp
    from stgx_torch.utils import LOSS

    def window_seq():
        model = Stgcn(**_kwargs("rt-st-gcn", "BatchNorm"), remat=True, device="cpu")
        Trainer(model=model, kind="window", loss=LOSS["st-gcn"](np.ones(CLASSES, np.float32)),
                opt=OptimizerConfig(), mesh=make_mesh(1, mesh.shape["model"], 1))

    def odd_width():
        model = MODELS["rt-st-gcn"](**_kwargs("rt-st-gcn", "LayerNorm", in_ch=(8, 5),
                                              out_ch=(5, 16)), device="cpu")
        shard_params_tp(model, mesh)

    def remat():
        model = MODELS["rt-st-gcn"](**_kwargs("rt-st-gcn", "LayerNorm"), remat=True, device="cpu")
        Trainer(model=model, kind="frame", loss=LOSS["rt-st-gcn"](np.ones(CLASSES, np.float32)),
                opt=OptimizerConfig(), mesh=mesh)

    def ms_tcn_seq():
        model = MODELS["ms-tcn"](num_classes=CLASSES, in_feat=C_IN, stages=2, filters=(8, 8),
                                 layers=(1, 1), kernel=(3, 3), dropout=(0.0, 0.0),
                                 remat=True, device="cpu")
        Trainer(model=model, kind="frame_ms", loss=LOSS["ms-tcn"](np.ones(CLASSES, np.float32)),
                opt=OptimizerConfig(), mesh=make_mesh(1, mesh.shape["model"], 1))

    out = {}
    for key, fn in (("window seq", window_seq), ("width", odd_width), ("remat", remat),
                    ("ms-tcn seq", ms_tcn_seq)):
        try:
            fn()
            out[key] = "no error"
        except (NotImplementedError, ValueError) as e:
            out[key] = f"{type(e).__name__}: {e}"
    return out


@pytest.fixture(scope="module")
def jax_ref():
    """Parameters and the one-device loss and gradients of each case; the
    streaming input and the JAX cell's output."""
    import jax
    import jax.numpy as jnp

    from stgx.models import MODELS as J_MODELS
    from stgx.models.costgcn import stream_sequence as j_cost_stream
    from stgx.models.rtstgcn import stream_sequence as j_stream_sequence
    from stgx.utils import LOSS as J_LOSS
    from stgx_torch.models import MODELS
    from stgx_torch.weights import from_jax_params, to_jax_params

    x, y, mask = (jnp.asarray(a) for a in _batch())
    rng = np.random.default_rng(1)
    ref = {}
    for name, norm in CASES:
        kw = _kwargs(name, norm)
        jm = J_MODELS[name](**kw)
        loss = J_LOSS[name](np.ones(CLASSES, np.float32))
        # the port's init from a seed, every leaf moved off it (no JAX init to run)
        params = jax.tree.map(
            lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32),
            to_jax_params(MODELS[name](**kw, device="cpu")))

        def f(p, jm=jm, loss=loss):
            ce, mse = loss(jm.apply(p, x, train=True, mask=mask), y, mask)
            return ce + mse

        value, grads = jax.jit(jax.value_and_grad(f))(params)
        tm = MODELS[name](**kw, device="cpu")
        ref[name, norm] = (jax.tree.map(np.asarray, params), float(value),
                           {k: v.numpy() for k, v in
                            from_jax_params(jax.tree.map(np.asarray, grads), tm).items()})
    stream_x = np.random.default_rng(5).normal(size=(2, 24, V, C_IN)).astype(np.float32)
    stream_ref = {}
    for name, j_stream in (("rt-st-gcn", j_stream_sequence), ("co-st-gcn", j_cost_stream)):
        jm = J_MODELS[name](**_kwargs(name, "LayerNorm"))
        stream_ref[name] = np.asarray(jax.jit(
            lambda p, t, jm=jm, f=j_stream: f(jm, p, t)[0])(
                ref[name, "LayerNorm"][0], jnp.asarray(stream_x)))
    return ref, stream_x, stream_ref


@pytest.fixture(scope="module")
def tp_runs(jax_ref, tmp_path_factory):
    """The port's results by key; one gloo session a world size."""
    ref, stream_x, _ = jax_ref
    params = {case: ref[case][0] for case in CASES}
    runs = {}

    def get(layout):
        world = int(np.prod(LAYOUTS[layout]))
        if world not in runs:
            runs[world] = spawn(_ranks, world, tmp_path_factory.mktemp("tp"), params,
                                stream_x, timeout=300)
        return runs[world]

    return get


@pytest.mark.parametrize("case", CASES, ids=[f"{n}-{m}" for n, m in CASES])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tp_step_matches_single_device(tp_runs, jax_ref, layout, case):
    ref = jax_ref[0][case]
    for rank, out in enumerate(tp_runs(layout)):  # every rank ends with the whole step
        loss, grads = out[case, layout]
        np.testing.assert_allclose(loss, ref[1], rtol=1e-5)
        assert set(grads) == set(ref[2])
        for k, g in grads.items():
            np.testing.assert_allclose(g, ref[2][k], atol=1e-5, err_msg=f"rank {rank}: {k}")


def test_tp_dropout_takes_the_one_process_masks(tp_runs, jax_ref):
    params = jax_ref[0]["rt-st-gcn", "BatchNorm"][0]
    ref_loss, ref_grads = _port_step("rt-st-gcn", "BatchNorm", params, None, DROPOUT)
    for out in tp_runs("data-seq-model"):
        loss, grads = out["dropout", "data-seq-model"]
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
        for k, g in grads.items():
            np.testing.assert_allclose(g, ref_grads[k], atol=1e-5, err_msg=k)


def test_replicate_still_works_on_3d_mesh(tp_runs):
    assert all(out["replicate", "data-seq-model"] == (2, 16, CLASSES)
               for out in tp_runs("data-seq-model"))


@pytest.mark.parametrize("layout", ["model2", "model4"])
def test_tp_streaming_matches_jax(tp_runs, jax_ref, layout):
    _, _, stream_ref = jax_ref
    size = LAYOUTS[layout][2]
    for out in tp_runs(layout):
        got, widths, _ = out["stream", "rt-st-gcn", layout]
        assert widths == {(3, 8, 16 // size), (3, 16, 16 // size)}  # each rank's block
        np.testing.assert_allclose(got, stream_ref["rt-st-gcn"], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("layout", ["model2", "model4"])
def test_tp_cost_streaming_matches_jax(tp_runs, jax_ref, layout):
    _, _, stream_ref = jax_ref
    size = LAYOUTS[layout][2]
    for out in tp_runs(layout):
        got, widths, fifos = out["stream", "co-st-gcn", layout]
        assert widths == {(3, 8, 16 // size), (3, 16, 16 // size)}  # each rank's block
        # layer 0 (Γ = 3, dilation 1, 16 channels): the main FIFO whole, the residual's a block
        assert fifos == {"fifo": (3, 2, V, 16), "res_fifo": (1, 2, V, 16 // size)}
        np.testing.assert_allclose(got, stream_ref["co-st-gcn"], atol=2e-5, rtol=2e-5)


def test_tp_refusals_name_their_roadmap_item(tp_runs):
    """A width ``model`` does not divide is refused; ``remat`` under a mesh
    (queue 1 item 10.4, refused until it was ported) is not."""
    messages = tp_runs("model2")[0]["refusals", "model2"]
    assert messages["width"].startswith("ValueError") and "does not split" in messages["width"]
    for key in ("window seq", "remat", "ms-tcn seq"):
        assert messages[key] == "no error", (key, messages[key])


@pytest.mark.parametrize("case", REMAT, ids=[f"{n}-{m}" for n, m in REMAT])
def test_tp_remat_step_equals_the_stored_step(tp_runs, jax_ref, case):
    ref = jax_ref[0][case]
    for rank, out in enumerate(tp_runs("data-seq-model")):
        loss, grads = out[case, "data-seq-model", "remat"]
        stored_loss, stored = out[case, "data-seq-model"]
        assert loss == stored_loss, (rank, loss, stored_loss)
        np.testing.assert_allclose(loss, ref[1], rtol=1e-5)
        for k, g in grads.items():
            np.testing.assert_array_equal(g, stored[k], err_msg=f"rank {rank}: {k}")
            np.testing.assert_allclose(g, ref[2][k], atol=1e-5, err_msg=f"rank {rank}: {k}")


LEAF_FAMILIES = ("rt-st-gcn", "co-st-gcn", "st-gcn", "aa-gcn", "ms-tcn", "ms-gcn", "shift-gcn",
                 "shift-gcn++", "shift-gcn++-teacher")
_GCN = ("layers.*.gcn.kernel", "layers.*.gcn.bias")
_SHIFT = ("units.*.spatial.kernel", "units.*.spatial.bias", "units.*.temporal.linear_kernel",
          "units.*.temporal.linear_bias")
# Each family's channel-mixing products, which every layer shards (``fnmatch``
# patterns of parameter names) ...
PRODUCTS = {
    "rt-st-gcn": _GCN, "co-st-gcn": _GCN, "st-gcn": _GCN,
    "aa-gcn": tuple(f"*.{p}" for p in _GCN),
    "ms-gcn": tuple(f"generator_stage.{p}" for p in _GCN),
    "ms-tcn": ("*layers.*.conv_kernel", "*layers.*.conv_bias", "*layers.*.pointwise.kernel",
               "*layers.*.pointwise.bias"),
    "shift-gcn": _SHIFT, "shift-gcn++-teacher": _SHIFT,
    "shift-gcn++": (*(f"teacher.{p}" for p in _SHIFT), "student.units.*.spatial.kernel",
                    "student.units.*.temporal.temporal_kernel"),
}
# ... and its input norms and heads, which stay whole.
_HEADS = ("norm_in.*", "fcn_out.*")
HEADS = {
    "rt-st-gcn": _HEADS, "co-st-gcn": _HEADS, "st-gcn": _HEADS,
    "aa-gcn": tuple(f"*.{p}" for p in _HEADS),
    "ms-gcn": ("generator_stage.norm_in.*", "*conv_out.*"),
    "ms-tcn": ("*conv_out.*",),
    "shift-gcn": ("data_bn.*", "fc.*"), "shift-gcn++-teacher": ("data_bn.*", "fc.*"),
    "shift-gcn++": ("*.data_bn.*", "*.fc.*", "connectors.*", "connector_norms.*"),
}


def _leaf_kwargs(name, config):
    """A family's keywords: the tests' small widths, or the published ones
    (9 layers of 64-256 channels, 52 classes, 3 features, PKU-MMD's 25
    joints)."""
    import torch_tp_cases

    if config == "small":
        return _kwargs(name, "LayerNorm") if name in FAMILIES else \
            torch_tp_cases.kwargs(name, "LayerNorm")
    kw = dict(num_classes=52, in_feat=3)
    if name != "ms-tcn":
        kw.update(normalization="BatchNorm",
                  graph=_kwargs("rt-st-gcn", "BatchNorm", skeleton="pku-mmd")["graph"])
    return kw


_SHAPES = {}


def _jax_shapes(name, config):
    """The JAX model's parameter shapes (``eval_shape`` of its init), once
    a family and config."""
    import jax

    from stgx.models import MODELS as J_MODELS

    if (name, config) not in _SHAPES:
        kw = _leaf_kwargs(name, config)
        joints = 25 if config == "pku-mmd" else V
        jm = J_MODELS[name](**kw)
        args = (np.zeros((1, 8, joints, kw["in_feat"]), np.float32),)
        if name == "shift-gcn++":
            args += (0.0,)  # the epoch
        _SHAPES[name, config] = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args)
    return _SHAPES[name, config]


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("config", ["small", "pku-mmd"])
@pytest.mark.parametrize("name", LEAF_FAMILIES)
def test_leaf_rule_against_gspmd(devices, name, config, size, capsys):
    """The sets printed side by side; each difference named with its reason."""
    import jax
    from jax.sharding import PartitionSpec as P

    from stgx.parallel.mesh import make_mesh as j_make_mesh
    from stgx.parallel.tp import param_specs_tp as j_param_specs_tp
    from stgx_torch.models import MODELS
    from stgx_torch.parallel.tp import (no_grad_reason, param_specs_tp, partial_names,
                                        whole_reason)
    from stgx_torch.weights import from_jax_params

    kw = _leaf_kwargs(name, config)
    params = _jax_shapes(name, config)
    specs = j_param_specs_tp(params, j_make_mesh(data=1, seq=1, model=size))
    flags = jax.tree.map(lambda a, s: np.full(a.shape, float(s != P())), params, specs,
                         is_leaf=lambda s: isinstance(s, P))
    tm = MODELS[name](**kw, device="cpu")
    gspmd = {k for k, v in from_jax_params(flags, tm).items() if bool(v.all())}
    port = {k for k, v in param_specs_tp(tm, size).items() if v}
    print(f"{name} {config} model={size}\n  GSPMD shards: {sorted(gspmd)}\n"
          f"  port shards:  {sorted(port)}")
    assert port <= gspmd
    for leaf in sorted(gspmd - port):
        reason = whole_reason(tm, leaf)
        assert reason, leaf
        print(f"  kept whole: {leaf}: {reason}")
    partial = partial_names(tm)
    assert not port & partial
    shapes = dict(tm.named_parameters())
    for prefix in tm.TP_MODULES:  # every tensor-parallel module shards its products
        names = [f"{prefix}.{n}" for n, _ in tm.get_submodule(prefix).named_parameters()]
        assert any(n in port for n in names), prefix
        for n in names:
            assert n in port or n in partial or whole_reason(tm, n) or \
                no_grad_reason(tm, n), n
    for pattern in PRODUCTS[name]:  # every layer's channel-mixing products
        names = [k for k in shapes if fnmatchcase(k, pattern)]
        assert names and all(k in port for k in names), (pattern, names)
    for pattern in HEADS[name]:  # input norms and heads whole
        names = [k for k in shapes if fnmatchcase(k, pattern)]
        assert names and not any(k in port for k in names), (pattern, names)
    assert not any("edge_importance" in k for k in port | gspmd)
    assert not any(shapes[k].shape[-1] == kw["num_classes"] for k in port)  # heads whole
    if kw["num_classes"] % size:
        assert not any(shapes[k].shape[-1] == kw["num_classes"] for k in gspmd)
    assert "kept whole" in capsys.readouterr().out or gspmd == port


def test_cli_trains_cost_gcn_tensor_parallel(tmp_path):
    from stgx_torch.cli import main
    from stgx_torch.data.synth import generate

    data = str(tmp_path / "data")
    generate(data, skeleton="imu_fogit_ABCD", num_classes=4, in_feat=C_IN, num_train=4,
             num_val=2, min_len=40, max_len=80, seed=1)
    cfg = {
        "processor": {"model": "co-st-gcn", "data": data, "out": None,
                      "actions": os.path.join(data, "actions.txt"), "graph": "imu_fogit_ABCD",
                      "demo": [0], "iou_threshold": [0.5], "prefetch": 0},
        "arch": {"in_feat": C_IN, "kernel": 3, "normalization": "LayerNorm",
                 "st-gcn": {"importance": True, "in_ch": [8, 8], "out_ch": [8, 8],
                            "dilation": [1, 2], "residual": [1, 1], "dropout": [0.2, 0]}},
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
    assert final["fcn_in.kernel"].shape == (C_IN, 8)  # whole, not one rank's block
    assert final["layers.1.tcn_kernel"].shape == (3, 8, 8)
    cfg["processor"]["out"] = str(outs[0])
    cfg["job"] = {"platform": "cpu"}
    path.write_text(json.dumps(cfg))
    assert main(["test", "--config", str(path), "--set",
                 f"processor.checkpoint={json.dumps(str(outs[0] / 'final'))}"]) == 0
    with open(outs[0] / "accuracy.csv") as f:
        top1, _, ce, _ = (float(v) for v in f.read().splitlines()[1].split(","))
    assert f"val ce={ce:.3f} top1={top1:.3f}" in lines[0]


def checkpoint_ranks(rank, world, kwargs, trials, out_dir):
    """Ranks of ``tests/test_torch_checkpoint.py``'s TP case (kept here, in a
    module without JAX): an RT-ST-GCN ``Trainer`` at ``model`` = ``world``
    trains epochs 0 and 1 unbroken; another saves ``epoch-0`` after epoch 0,
    a third restores it and trains epoch 1. Returns each run's whole state
    after epoch 1 (parameters and Adam's moments) and the checkpoint's
    path."""
    from stgx_torch.models.rtstgcn import RtStgcn
    from stgx_torch.parallel.loop import OptimizerConfig, Trainer
    from stgx_torch.parallel.mesh import make_mesh
    from stgx_torch.utils import LOSS

    mesh = make_mesh(1, 1, world)
    os.makedirs(out_dir, exist_ok=True)

    def trainer():
        model = RtStgcn(**kwargs, device="cpu", generator=torch.Generator().manual_seed(0))
        return Trainer(model=model, kind="frame", mesh=mesh, bucket=32,
                       loss=LOSS["rt-st-gcn"](np.ones(kwargs["num_classes"], np.float32)),
                       opt=OptimizerConfig(learning_rate=1e-3, batch_size=2, seed=0))

    def whole(tr):
        path = tr.save(out_dir, 1, name=f"whole-{len(states)}")
        return torch.load(path, weights_only=True)

    states = []
    unbroken = trainer()
    unbroken.train_epoch(trials, 0)
    unbroken.train_epoch(trials, 1)
    states.append(whole(unbroken))
    first = trainer()
    first.train_epoch(trials, 0)
    path = first.save(out_dir, 0)
    resumed = trainer()
    assert resumed.restore(path) == 0
    resumed.train_epoch(trials, 1)
    states.append(whole(resumed))
    return states + [path]
