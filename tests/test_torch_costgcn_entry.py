"""CoST-GCN through the port's entry points on the CPU: the builder, the
weights, the reference-checkpoint mapping, the MAC and byte counters, the
serving cell's drift check, the streaming benchmark and the CLI, against
the JAX package where it has the same function.

* ``build_model`` on the three CoST-GCN configs gives the JAX builder's
  geometry: the reference's ``stride`` array becomes the dilation unless
  ``dilation`` is given, and no stride reaches the model;
* ``from_jax_params`` loads strictly and ``to_jax_params`` gives the tree
  back exactly, with flax's norm names in creation order;
* the reference import and export equal the JAX package's bit for bit,
  and an imported model's forward equals the JAX forward within
  ``1e-4 · max(1, max|ref|)`` (fp32 sums in another order, through
  normalised layers), as at the published width;
* ``check_stream_drift`` reports the JAX function's fields, for the plain
  cells and the int8 one;
* the CLI trains, resumes from ``epoch-0`` (bit for bit on the CPU), tests
  and benchmarks ``configs/synth/costgcn.json`` cut to 2 layers.
"""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stgx.config import build_model as j_build_model
from stgx.config import load_config as j_load_config
from stgx.graph import load_skeleton
from stgx.models.costgcn import CoStgcn as JCoStgcn
from stgx.utils import flops as j_flops
from stgx.utils import torch_import as j_ti
from stgx_torch.bench import serving
from stgx_torch.bench.streaming import streaming_fns
from stgx_torch.bench.train_throughput import rooflines
from stgx_torch.cli import main
from stgx_torch.config import build_model, load_config
from stgx_torch.data.synth import generate
from stgx_torch.models import MODELS, AaGcn, MsGcn, MsTcn, Stgcn, costgcn
from stgx_torch.models.costgcn import CoStgcn
from stgx_torch.utils import flops
from stgx_torch.utils import torch_import as ti
from stgx_torch.weights import from_jax_params, to_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ["configs/pku-mmd/ln/costgcn.json", "configs/pku-mmd/ln/costgcn_69.json",
           "configs/synth/costgcn.json"]
# layer 0 the identity residual, layer 1 the 1×1 conv, layer 2 none
SMALL = dict(num_classes=5, in_feat=3, graph=load_skeleton("pku-mmd"), kernel=5,
             in_ch=(8, 8, 16), out_ch=(8, 16, 16), dilation=(1, 2, 1), residual=(1, 1, 0),
             dropout=(0.0, 0.0, 0.0))
NORMS = ["LayerNorm", "BatchNorm"]


def _models(normalization, seed=0):
    jm = JCoStgcn(**SMALL, normalization=normalization)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 24, 25, 3)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(seed), x)
    params = jax.tree.map(  # every leaf off its init value
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=np.shape(a)).astype(np.float32),
        params)
    tm = CoStgcn(**SMALL, normalization=normalization, device="cpu")
    return jm, params, tm, x


def _assert_same_tree(got, ref):
    gl = jax.tree_util.tree_leaves_with_path(got)
    rl = jax.tree_util.tree_leaves_with_path(ref)
    assert [jax.tree_util.keystr(p) for p, _ in gl] == [jax.tree_util.keystr(p) for p, _ in rl]
    for (p, g), (_, r) in zip(gl, rl):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r),
                                      err_msg=jax.tree_util.keystr(p))


def _assert_model_close(got, ref):
    ref = np.asarray(ref)
    assert np.abs(np.asarray(got) - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max())


# -- the builder ---------------------------------------------------------------------


@pytest.mark.parametrize("config", CONFIGS)
def test_build_model_gives_the_jax_geometry(config):
    tm = build_model(load_config(config), 52, device="cpu")
    jm = j_build_model(j_load_config(config), 52)
    assert isinstance(tm, CoStgcn) and not hasattr(tm, "stride")
    assert tm.kernel == jm.kernel
    for key in ("in_ch", "out_ch", "dilation"):
        assert getattr(tm, key) == tuple(getattr(jm, key)), key
    assert [layer.residual for layer in tm.layers] == [bool(r) for r in jm.residual]
    assert type(tm.norm_in).__name__ == jm.normalization == "LayerNorm"
    want = {"costgcn_69.json": (69, (1, 1, 1, 2, 2, 2, 4, 4, 4))}.get(
        os.path.basename(config), (9, (1, 1, 1, 2, 1, 1, 2, 1, 1)))
    assert (tm.kernel, tm.dilation) == want
    assert (tm.in_ch[-1], tm.out_ch[-1], tm.num_joints, tm.partitions) == (256, 256, 25, 3)


@pytest.mark.parametrize("sets,want", [
    (['arch.co-st-gcn={"stride": [2, 1]}'], (2, 1)),
    (['arch.co-st-gcn={"stride": [2, 1], "dilation": [3, 4]}'], (3, 4)),
    (['arch.co-st-gcn={"in_ch": [8, 8], "out_ch": [8, 8]}'], (1,) * 9),
])
def test_dilation_rule(sets, want):
    """``dilation`` wins over ``stride``; ``stride`` alone is the dilation;
    neither gives 1 everywhere (stgx/config.py:158-162)."""
    over = ["processor.model=co-st-gcn", "arch.normalization=LayerNorm"] + sets
    cfg = load_config("configs/pku-mmd/as_is/rtstgcn.json", over)
    if "in_ch" not in sets[0]:
        cfg["arch"]["co-st-gcn"].update(in_ch=[8, 8], out_ch=[8, 8])
    tm = build_model(cfg, 5, device="cpu")
    jm = j_build_model(j_load_config("configs/pku-mmd/as_is/rtstgcn.json", over), 5)
    assert tm.dilation == want == tuple(jm.dilation)


@pytest.mark.parametrize("name", ["st-gcn", "aa-gcn", "ms-tcn", "ms-gcn", "shift-gcn++",
                                  "shift-gcn++-teacher"])
def test_the_other_families_still_raise(name):
    """The window models are ported (the name is kept from when they
    raised): each key gives the port's class; Shift-GCN++ and its teacher
    still raise naming ROADMAP.md."""
    ported = {"st-gcn": Stgcn, "aa-gcn": AaGcn, "ms-tcn": MsTcn, "ms-gcn": MsGcn}
    if name in ported:
        assert MODELS[name] is ported[name]
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            MODELS[name]
    assert MODELS["co-st-gcn"] is CoStgcn


def test_no_device_asked_needs_a_cuda_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(load_config(CONFIGS[0]), 52)
    assert build_model(load_config(CONFIGS[0]), 52, device="cpu").A.device.type == "cpu"


def test_the_published_geometry_loads_jax_weights_strictly():
    """CoST-GCN₉ at its PKU-MMD width: the JAX init loads strictly and the
    two forwards agree on a short capture."""
    cfg = load_config(CONFIGS[0])
    jm = j_build_model(j_load_config(CONFIGS[0]), 52)
    x = np.random.default_rng(1).normal(size=(1, 12, 25, 3)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = build_model(cfg, 52, device="cpu")
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params), tm), strict=True)
    with torch.no_grad():
        _assert_model_close(tm(torch.tensor(x)).numpy(), jm.apply(params, jnp.asarray(x)))


# -- weights -------------------------------------------------------------------------


@pytest.mark.parametrize("normalization", NORMS)
def test_weights_round_trip_with_flax_norm_names(normalization):
    jm, params, tm, _ = _models(normalization)
    tm.load_state_dict(from_jax_params(params, tm), strict=True)
    _assert_same_tree(to_jax_params(tm), jax.tree.map(np.asarray, params))
    lp = params["params"]["layers_1"]  # the residual 1×1 conv: its norm is _0
    kind = normalization
    assert torch.equal(tm.layers[1].res_norm.scale, torch.tensor(lp[f"{kind}_0"]["scale"]))
    assert torch.equal(tm.layers[1].norm.scale, torch.tensor(lp[f"{kind}_1"]["scale"]))
    assert torch.equal(tm.layers[1].tcn_norm.scale, torch.tensor(lp[f"{kind}_2"]["scale"]))
    lp = params["params"]["layers_0"]
    assert torch.equal(tm.layers[0].tcn_norm.bias, torch.tensor(lp[f"{kind}_1"]["bias"]))
    with pytest.raises(ValueError, match="unexpected"):
        bad = jax.tree.map(np.asarray, params)
        bad["params"]["layers_0"]["stray"] = np.zeros(3, np.float32)
        from_jax_params(bad, tm)


# -- reference checkpoints -----------------------------------------------------------


@pytest.mark.parametrize("normalization", NORMS)
def test_reference_import_and_export_match_the_jax_package(normalization):
    jm, params, tm, x = _models(normalization)
    sd = j_ti.export_reference_state_dict(params, jm, "co-st-gcn")
    ckpt = {"epoch": 3, "model_state_dict": {f"module.{k}": torch.tensor(v)
                                             for k, v in sd.items()}}
    got = ti.import_reference_state_dict(ckpt, tm, "co-st-gcn")
    _assert_same_tree(got, j_ti.import_reference_state_dict(ckpt, jm, "co-st-gcn"))
    _assert_same_tree(got, jax.tree.map(np.asarray, params))
    ti.load_reference_into(tm, got)
    with torch.no_grad():
        _assert_model_close(tm(torch.tensor(x)).numpy(), jm.apply(params, x))

    back = ti.export_reference_state_dict(to_jax_params(tm), tm, "co-st-gcn")
    assert list(back) == list(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)


def test_reference_optimizer_moments_match_the_jax_import():
    jm, params, tm, _ = _models("LayerNorm", seed=2)
    sd = j_ti.export_reference_state_dict(params, jm, "co-st-gcn")
    keys = [k for k in sd if k != "A"]
    rng = np.random.default_rng(4)
    state = {i: {"step": torch.tensor(float(9 + (i % 2))),
                 "exp_avg": torch.tensor(rng.normal(size=sd[k].shape).astype(np.float32)),
                 "exp_avg_sq": torch.tensor(rng.random(sd[k].shape).astype(np.float32))}
             for i, k in enumerate(keys)}
    ckpt = {"model_state_dict": {k: torch.tensor(v) for k, v in sd.items()},
            "optimizer_state_dict": {"state": state,
                                     "param_groups": [{"params": list(range(len(keys)))}]}}
    mu, nu, count = ti.import_reference_optimizer(ckpt, tm, "co-st-gcn")
    jmu, jnu, jcount = j_ti.import_reference_optimizer(ckpt, jm, "co-st-gcn")
    assert count == jcount == 9
    _assert_same_tree(mu, jmu)
    _assert_same_tree(nu, jnu)


# -- counters ------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"kernel": 69},
                                {"num_joints": 7, "in_feat": 6, "kernel": 5, "in_ch": (8, 16),
                                 "out_ch": (16, 16), "residual": (1, 0)}])
def test_counters_match_jax(kw):
    assert flops.costgcn_macs_per_frame(**kw) == j_flops.costgcn_macs_per_frame(**kw)
    hbm = {k: v for k, v in kw.items() if k != "kernel"}
    for nbytes in (2, 4):
        for window, stride in ((50, (1, 1, 1, 2, 1, 1, 2, 1, 1)), (1, (1,) * 9)):
            st = stride[: len(hbm.get("in_ch", stride))]
            assert flops.stgcn_train_hbm_bytes_per_window(
                window=window, stride=st, dtype_bytes=nbytes, **hbm) == \
                j_flops.stgcn_train_hbm_bytes_per_window(window=window, stride=st,
                                                         dtype_bytes=nbytes, **hbm)


def test_train_throughput_counts_costgcn_as_the_jax_bench():
    """CoST-GCN's rooflines: its MACs a frame, and its bytes as an ST-GCN
    window of one frame with no stride (stgx/bench/train_throughput.py);
    RT-ST-GCN's as before, and none for Shift-GCN."""
    rt = build_model(load_config("configs/pku-mmd/as_is/rtstgcn.json"), 52, device="cpu")
    assert rooflines(rt, "rt-st-gcn", "bfloat16") == (
        j_flops.rt_stgcn_macs_per_frame(), j_flops.rt_stgcn_train_hbm_bytes_per_frame())
    sg = build_model(load_config("configs/pku-mmd/as_is/shiftgcn.json"), 52, device="cpu")
    assert rooflines(sg, "shift-gcn", "float32") == (None, None)
    for config, kernel in ((CONFIGS[0], 9), (CONFIGS[1], 69)):
        model = build_model(load_config(config), 52, device="cpu")
        for dtype, nbytes in (("float32", 4), ("bfloat16", 2)):
            assert rooflines(model, "co-st-gcn", dtype) == (
                j_flops.costgcn_macs_per_frame(kernel=kernel),
                j_flops.stgcn_train_hbm_bytes_per_window(window=1, stride=(1,) * 9,
                                                         dtype_bytes=nbytes))


# -- serving -------------------------------------------------------------------------


def test_serving_cell_and_drift_check():
    _, _, tm, _ = _models("LayerNorm")
    assert streaming_fns(tm) == (costgcn.init_stream_state, costgcn.stream_step)
    same = serving.check_stream_drift(tm, l=24, batch=2)
    assert same == {"max_abs_drift": 0.0, "max_rel_drift": 0.0,
                    "max_abs_drift_first_half": 0.0, "max_abs_drift_second_half": 0.0,
                    "top1_agreement": 1.0}
    drift = serving.check_stream_drift(tm, l=24, batch=2, dtype=torch.bfloat16)
    assert set(drift) == set(same)
    # the JAX test's bounds (tests/test_serving.py): bounded, not compounding
    assert drift["top1_agreement"] > 0.8, drift
    assert drift["max_rel_drift"] < 0.25, drift
    assert drift["max_abs_drift_second_half"] < 5 * drift["max_abs_drift_first_half"] + 1e-3


def test_the_routes_bench_is_a_device_measurement(monkeypatch):
    from stgx_torch.bench import temporal_conv as routes_bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device measurement"):
        routes_bench.main([])


def test_int8_cells_raise_naming_their_item(tmp_path, monkeypatch):
    """The int8 cells are ported (the name is kept from when they raised):
    the drift check runs the int8 cell, calibrating it first when no scales
    are given, and ``serving.main`` takes ``--quant`` and ``--state-dtype``
    (alone it serves the int8 cell), stopping on a machine without CUDA at
    the device, as every device measurement does, not at a refusal."""
    _, _, tm, _ = _models("LayerNorm")
    drift = serving.check_stream_drift(tm, l=4, batch=1, quant="int8-static")
    assert set(drift) == {"max_abs_drift", "max_rel_drift", "max_abs_drift_first_half",
                          "max_abs_drift_second_half", "top1_agreement"}
    assert all(np.isfinite(v) for v in drift.values()), drift
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["--model", "co-st-gcn", "--quant", "int8-static"],
                 ["--state-dtype", "int8"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            serving.main(argv)


# -- the CLI -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_cfg(tmp_path_factory):
    """configs/synth/costgcn.json cut to its first 2 layers, on synthetic
    PKU-MMD trials, on the CPU."""
    tmp = str(tmp_path_factory.mktemp("costgcn_cli"))
    data = os.path.join(tmp, "data")
    generate(data, skeleton="pku-mmd", num_classes=5, in_feat=3, num_train=3, num_val=2,
             min_len=40, max_len=70, seed=5)
    with open(os.path.join(REPO, "configs/synth/costgcn.json")) as f:
        cfg = json.load(f)
    sub = cfg["arch"]["co-st-gcn"]
    for key in ("in_ch", "out_ch", "stride", "residual", "dropout"):
        sub[key] = sub[key][:2]
    sub["dropout"] = [0.1, 0.1]  # masks from each epoch's own generator
    cfg["processor"].update(data=data, actions=os.path.join(data, "actions.txt"),
                            out=os.path.join(tmp, "out"))
    cfg["optimizer"].update(epochs=2, checkpoint_indices=[0], batch_size=2)
    cfg["job"] = {"platform": "cpu"}
    path = os.path.join(tmp, "costgcn.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return tmp, path, cfg


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_cli_train_resume_test_benchmark(cli_cfg, capsys):
    tmp, path, cfg = cli_cfg
    out = cfg["processor"]["out"]
    assert main(["train", "--config", path]) == 0
    for name in ["train-validation-curve.csv", "accuracy-curve.csv", "macro-F1@k-1.csv",
                 "edit-1.csv", "confusion-matrix-1.csv", "segmentation-0.csv", "epoch-0",
                 "final"]:
        assert os.path.exists(os.path.join(out, name)), name
    curve = np.asarray(_rows(os.path.join(out, "train-validation-curve.csv"))[1:], float)
    assert curve.shape[0] == 2 and np.isfinite(curve[:, 1:5]).all()

    resumed = os.path.join(tmp, "resumed")
    assert main(["train", "--config", path, "--set", f"processor.out={resumed}",
                 "--set", f"processor.checkpoint={out}/epoch-0"]) == 0
    a = torch.load(os.path.join(out, "final"), weights_only=True)
    b = torch.load(os.path.join(resumed, "final"), weights_only=True)
    assert a["epoch"] == b["epoch"] == 1
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for i, st in a["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, b["optimizer"]["state"][i][k]), (i, k)

    assert main(["test", "--config", path, "--set",
                 f"processor.checkpoint={out}/final"]) == 0
    assert float(_rows(os.path.join(out, "accuracy.csv"))[1][0]) == curve[1, 7]
    for name in ("macro-F1@k", "edit", "confusion-matrix"):
        assert _rows(os.path.join(out, f"{name}.csv")) == _rows(os.path.join(out, f"{name}-1.csv"))

    capsys.readouterr()
    assert main(["benchmark", "--config", path]) == 0
    line = json.loads([s for s in capsys.readouterr().out.splitlines() if s.startswith("{")][-1])
    assert line["model"] == "co-st-gcn" and line["clock"] == "host" and line["p99_ms"] > 0
    for name in ("latency.csv", "model-size.csv", "accuracy.csv"):
        assert os.path.exists(os.path.join(out, name)), name
    # processor.quantize is not read by benchmark (only export reads it), and
    # the int8 rows come with every RT-ST-GCN and CoST-GCN benchmark: on the
    # CPU the eager row, the accuracy and the size; the graph replays need
    # the card and stay empty (not measured)
    assert main(["benchmark", "--config", path, "--set", "processor.quantize=true"]) == 0
    line = json.loads([s for s in capsys.readouterr().out.splitlines() if s.startswith("{")][-1])
    latency = _rows(os.path.join(out, "latency.csv"))
    assert latency[0] == ["mean_ms", "p50_ms", "p99_ms", "onchip_ms", "frames", "int8_p50_ms",
                          "int8_onchip_ms", "int8_static_onchip_ms", "w8_onchip_ms"]
    row = dict(zip(*latency))
    assert float(row["int8_p50_ms"]) == line["int8_p50_ms"] > 0
    assert row["onchip_ms"] == row["int8_onchip_ms"] == row["w8_onchip_ms"] == ""
    size = _rows(os.path.join(out, "model-size.csv"))
    assert size[0] == ["fp32_mb", "int8_mb"]
    assert 0 < float(size[1][1]) == line["int8_size_mb"] < float(size[1][0])
    assert 0 <= line["int8_agrees_fp32"] <= 1 and 0 <= line["int8_top1"] <= 1
