"""The window models' entry points in the port against the JAX package on
the CPU: ``build_model`` for ST-GCN, AA-GCN, MS-TCN and MS-GCN from their
``configs/pku-mmd/as_is`` configs, reference checkpoints in and out, the
int8 ST-GCN window cell, and the CLI.

* ``build_model``: the keywords the JAX builder gives each family and,
  at the published widths, the same parameter shapes (the JAX tree from
  ``jax.eval_shape``);
* reference import / export / Adam moments on state dicts the JAX
  package's exporter writes from seeded, perturbed JAX parameters: the
  JAX import's tree leaf for leaf and bit for bit;
* the int8 window cell (``quantize_stgcn``, ``quantized_stgcn_window``
  through ``_stgcn_window_qstep``, ``calibrate_scales``) with fp32 and
  bf16 state: the quantized weights leaf for leaf, the static cell bit for
  bit, the dynamic cell within ``TOL_DYNAMIC`` and w8 within ``TOL_W8``
  (see :func:`test_window_cell_matches_jax`); bf16 state also against the
  fp32-state cell, int8 state refused;
* the CLI with ``job.platform: "cpu"``: ``train`` → ``test`` →
  ``benchmark`` for ST-GCN (with the int8 rows) and MS-GCN, and MS-TCN's
  ``benchmark`` refused with the JAX package's ``ValueError``.
"""

import csv
import itertools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stgx.bench.quant as jq
import stgx_torch.bench.quant as tq
from stgx.bench.streaming import _streaming_fns as j_streaming_fns
from stgx.config import build_model as j_build_model
from stgx.config import load_config as j_load_config
from stgx.graph import load_skeleton
from stgx.models import aagcn as j_aa
from stgx.models import msgcn as j_msgcn
from stgx.models import mstcn as j_mstcn
from stgx.models import stgcn as j_st
from stgx.utils import torch_import as j_ti
from stgx_torch.bench import serving
from stgx_torch.bench.streaming import streaming_fns
from stgx_torch.cli import main
from stgx_torch.config import FAMILY_CONFIGS, build_model, load_config
from stgx_torch.data.synth import generate
from stgx_torch.models import MODELS, AaGcn, MsGcn, MsTcn, Stgcn
from stgx_torch.utils import torch_import as ti
from stgx_torch.weights import from_jax_params, to_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ["st-gcn", "aa-gcn", "ms-tcn", "ms-gcn"]
V = 25
SMALL = dict(num_classes=5, in_feat=3, graph=load_skeleton("pku-mmd"), kernel=5,
             in_ch=(8, 8, 16), out_ch=(8, 16, 16), stride=(1, 2, 1), residual=(1, 1, 0),
             dropout=(0.0,) * 3)
MS = dict(stages=2, filters=(8, 8), layers=(2, 2))


# -- build_model ----------------------------------------------------------------------


@pytest.mark.parametrize("name", FAMILIES)
def test_build_model_matches_the_jax_builder(name):
    """Each as_is config: the family's class, the keywords the JAX builder
    passes (layer plan, kernel, stages, adapters) and the parameter shapes
    at the published widths (52 classes)."""
    cfg = load_config(FAMILY_CONFIGS[name])
    tm = build_model(cfg, 52, device="cpu")
    jm = j_build_model(j_load_config(FAMILY_CONFIGS[name]), 52)
    assert type(tm) is MODELS[name] and type(tm).__name__ == type(jm).__name__
    if name == "ms-tcn":
        assert (tm.stages, tm.layers) == (jm.stages, tuple(jm.layers)) == (4, (10,) * 4)
        assert [len(s.layers) for s in [tm.generator_stage, *tm.refinement_stages]] == [10] * 4
        x = jnp.zeros((1, 16, V, 3))
    else:
        body = tm.generator_stage if name == "ms-gcn" else tm
        for key in ("in_ch", "out_ch", "stride"):
            assert getattr(body, key) == tuple(getattr(jm, key)), key
        layers = body.joint_stream.layers if name == "aa-gcn" else body.layers
        layers = [getattr(layer, "layer", layer) for layer in layers]  # AA-GCN's ST-GCN layer
        assert tuple(int(layer.residual) for layer in layers) == tuple(jm.residual)
        assert body.kernel == jm.kernel == 9 and body.importance == jm.importance
        x = jnp.zeros((2, 50, V, 3))
    if name == "aa-gcn":
        assert jm.output_type == "logits"
    if name == "ms-gcn":
        assert (tm.stages, tm.layers) == (jm.stages, tuple(jm.layers)) == (4, (10,) * 4)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    want = jax.tree.map(lambda s: s.shape, shapes)
    got = jax.tree.map(np.shape, to_jax_params(tm))
    assert got == want


def test_ms_gcn_reads_its_two_config_groups():
    """The generator from the ``st-gcn`` group, the refinement from
    ``ms-tcn`` (its kernel and dropout as refine_kernel / refine_dropout),
    the adapters from ``arch``."""
    over = ['arch.ms-tcn={"stages": 2, "filters": [8, 16], "layers": [3, 1], '
            '"kernel": [3, 3], "dropout": [0.25, 0.5]}', "arch.refine=logits",
            "arch.output_type=softmax"]
    tm = build_model(load_config(FAMILY_CONFIGS["ms-gcn"], over), 7, device="cpu")
    jm = j_build_model(j_load_config(FAMILY_CONFIGS["ms-gcn"], over), 7)
    assert (tm.stages, tm.layers) == (jm.stages, tuple(jm.layers)) == (2, (3, 1))
    assert tuple(jm.refine_dropout) == (0.25, 0.5)
    assert [l.dropout for s in tm.refinement_stages for l in s.layers] == [0.25] * 3 + [0.5]
    assert tm.refinement_stages[1].conv_in.kernel.shape == (7, 16)
    assert (jm.refine, jm.output_type) == ("logits", "softmax")
    y = torch.randn(1, 3, 7)
    assert torch.equal(tm.prob(y), y) and torch.allclose(tm.out(y).sum(-1), torch.ones(1, 3))


# -- reference checkpoints ------------------------------------------------------------


def _pair(name, seed=0):
    """(JAX model, perturbed params, port model, input shape) of a family."""
    if name == "st-gcn":
        jm, tm, x = j_st.Stgcn(**SMALL), Stgcn(**SMALL, device="cpu"), (2, 12, V, 3)
    elif name == "aa-gcn":
        jm, tm, x = j_aa.AaGcn(**SMALL), AaGcn(**SMALL, device="cpu"), (2, 12, V, 3)
    elif name == "ms-tcn":
        kw = dict(MS, kernel=(3, 3), dropout=(0.0, 0.0))
        jm = j_mstcn.MsTcn(num_classes=5, in_feat=3, **kw)
        tm, x = MsTcn(5, 3, device="cpu", **kw), (1, 12, V, 3)
    else:
        kw = dict(SMALL, refine_kernel=(3, 3), refine_dropout=(0.0, 0.0), **MS)
        jm, tm, x = j_msgcn.MsGcn(**kw), MsGcn(**kw, device="cpu"), (6, 12, V, 3)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=np.shape(a)).astype(np.float32),
        jm.init(jax.random.PRNGKey(seed), jnp.zeros(x)))
    return jm, params, tm, x


def _assert_same_tree(got, ref):
    gl = jax.tree_util.tree_leaves_with_path(got)
    rl = jax.tree_util.tree_leaves_with_path(ref)
    assert [jax.tree_util.keystr(p) for p, _ in gl] == [jax.tree_util.keystr(p) for p, _ in rl]
    for (p, g), (_, r) in zip(gl, rl):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r),
                                      err_msg=jax.tree_util.keystr(p))


def _moments(sd, name, rng):
    """A reference ``optimizer_state_dict`` for ``sd``: moments of each
    parameter's shape in ``named_parameters()`` order (MS-GCN: the
    generator's first), step counts 7 and 9."""
    if name == "ms-gcn":
        shapes = [v.shape for k, v in sd["generator_stage"].items() if k != "A"]
        shapes += [v.shape for v in sd["refinement_stages"].values()]
    else:
        shapes = [v.shape for k, v in sd.items() if k != "A"]
    state = {i: {"exp_avg": torch.tensor(rng.normal(size=s).astype(np.float32)),
                 "exp_avg_sq": torch.tensor(rng.random(size=s).astype(np.float32)),
                 "step": torch.tensor(7.0 + 2 * (i % 2))} for i, s in enumerate(shapes)}
    return {"state": state, "param_groups": [{"params": list(range(len(shapes)))}]}


@pytest.mark.parametrize("name", FAMILIES)
def test_reference_checkpoints_match_the_jax_package(name):
    """Import (the JAX import's tree, bit for bit; loaded strictly, the JAX
    forward within 1e-5 of max(1, max|ref|)), export (back through the JAX
    import: the same tree) and the Adam moments, exactly."""
    jm, params, tm, shape = _pair(name)
    sd = j_ti.export_reference_state_dict(params, jm, name)
    got = ti.import_reference_state_dict(sd, tm, name)
    ref_tree = j_ti.import_reference_state_dict(sd, jm, name)
    _assert_same_tree(got, ref_tree)
    ti.load_reference_into(tm, got)
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    ref = np.asarray(jm.apply(ref_tree, jnp.asarray(x)))
    with torch.no_grad():
        out = tm(torch.tensor(x)).numpy()
    assert np.abs(out - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max())
    back = ti.export_reference_state_dict(to_jax_params(tm), tm, name)
    _assert_same_tree(j_ti.import_reference_state_dict(back, jm, name), ref_tree)
    ckpt = {"epoch": 2, "model_state_dict": sd,
            "optimizer_state_dict": _moments(sd, name, np.random.default_rng(2))}
    mu, nu, count = ti.import_reference_optimizer(ckpt, tm, name)
    j_mu, j_nu, j_count = j_ti.import_reference_optimizer(ckpt, jm, name)
    _assert_same_tree(mu, j_mu)
    _assert_same_tree(nu, j_nu)
    assert count == j_count == 7
    from_jax_params(mu, tm)  # the moments map onto the port's parameters


# -- the int8 window cell -------------------------------------------------------------

# the dynamic cell's logits against JAX's, relative to max(1, max|ref|): its
# abs-max scales are taken over fp32 activations that differ from XLA's in
# their last bits (the norms and the adjacency einsum sum in another order),
# so a scale, and with it every code at a rounding tie, may shift by one
# step. Measured on these weights: 3.6e-7 over these 14 frames (no code
# moved), 8.4e-5 over 20 (about one moved code's worth). The bound is
# twice the larger.
TOL_DYNAMIC = 2e-4
TOL_W8 = 1e-4  # no activation quantized: fp32 sums in another order
STATE_TYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
WINDOW = 12


@pytest.fixture(scope="module")
def window_cells():
    """Both packages' ST-GCN (BatchNorm, pku-mmd, Γ = 3), qparams, the JAX
    calibration, and every (mode, state type) cell run over 14 frames."""
    kw = dict(SMALL, kernel=3, normalization="BatchNorm")
    jm, tm = j_st.Stgcn(**kw), Stgcn(**kw, device="cpu")
    x = np.random.default_rng(0).normal(size=(1, 14, V, 3)).astype(np.float32)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:, :12])))
    tm.load_state_dict(from_jax_params(params, tm), strict=True)
    jqp, tqp = jq.quantize_stgcn(jm, params), tq.quantize_stgcn(tm)
    scales = jq.calibrate_scales(jm, jqp, jnp.asarray(x[0]), "st-gcn")
    runs = {}
    for mode, (jdt, tdt) in itertools.product(("dynamic", "static", "w8"), STATE_TYPES.values()):
        s = scales if mode == "static" else None
        with jq.quant_mode(mode, s):
            st = jq.QUANT_MODELS["st-gcn"][2](jm, window=WINDOW, dtype=jdt)
            ref = []
            for t in range(x.shape[1]):
                logits, st = jq._stgcn_window_qstep(jm, jqp, st, jnp.asarray(x[:, t]))
                ref.append(np.asarray(logits))
        runs[mode, tdt] = (np.stack(ref), _port_run(tm, tqp, x, mode, s, tdt))
    return dict(jm=jm, tm=tm, x=x, params=params, jqp=jqp, tqp=tqp, scales=scales, runs=runs)


def _port_run(tm, tqp, x, mode, scales, dtype=torch.float32):
    with tq.quant_mode(mode, scales):
        st = tq.QUANT_MODELS["st-gcn"][2](tm, dtype=dtype, window=WINDOW)
        out = []
        for t in range(x.shape[1]):
            logits, st = tq._stgcn_window_qstep(tm, tqp, st, torch.tensor(x[:, t]))
            out.append(logits.numpy())
    return np.stack(out)


def test_quantize_stgcn_matches_jax_leaf_for_leaf(window_cells):
    def flat(tree, path=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from flat(tree[k], f"{path}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from flat(v, f"{path}/{i}")
        else:
            yield path, np.asarray(tree)

    want, got = dict(flat(window_cells["jqp"])), dict(flat(window_cells["tqp"]))
    assert list(got) == list(want)
    for path, ref in want.items():
        assert got[path].dtype == ref.dtype, path
        np.testing.assert_array_equal(got[path], ref, err_msg=path)
    assert tq.quantized_size_bytes(window_cells["tqp"]) == jq.quantized_size_bytes(
        window_cells["jqp"])


@pytest.mark.parametrize("state", STATE_TYPES)
@pytest.mark.parametrize("mode", ["dynamic", "static", "w8"])
def test_window_cell_matches_jax(window_cells, mode, state):
    """The int8 window cell over 14 frames (a 12-frame window rolled each
    frame), its buffer fp32 or bf16, against the JAX cell on the same
    weights and state type: static under JAX's calibrated scales bit for
    bit (the integer products are exact, the epilogues round alike, and a
    bf16 input is quantized as JAX does it: the scale rounded to bf16 and
    ``x / scale`` divided in bf16); dynamic within ``TOL_DYNAMIC``; w8
    within ``TOL_W8``. Every product goes through ``int8_gemm`` /
    ``w8_gemm`` (their plain versions on the CPU)."""
    ref, got = window_cells["runs"][mode, STATE_TYPES[state][1]]
    assert got.shape == ref.shape == (14, 1, 5) and np.isfinite(got).all()
    if mode == "static":
        np.testing.assert_array_equal(got, ref)
        return
    rel = np.abs(got - ref).max() / max(1.0, np.abs(ref).max())
    print(f"{mode}, {state} state: logits {rel:.3e} of max(1, max|ref|) from the JAX cell's")
    assert rel <= (TOL_W8 if mode == "w8" else TOL_DYNAMIC), rel


def test_window_cell_calibration_and_state_types(window_cells):
    """The calibration's sites (JAX's, in JAX's order, values within 1e-6
    relative); bf16 state (the buffer of raw frames rounded to bf16) within
    the int8 cells' bound of the fp32-state cell (mean relative distance
    0.15, top-1 agreement > 0.8); int8 state refused with JAX's
    ``ValueError``."""
    tm, tqp, x = window_cells["tm"], window_cells["tqp"], window_cells["x"]
    scales = window_cells["scales"]
    got = tq.calibrate_scales(tm, tqp, x[0], "st-gcn")
    assert list(got) == list(scales)
    for site, s in scales.items():
        assert abs(got[site] - s) <= 1e-6 * s, site
    fp32 = window_cells["runs"]["static", torch.float32][1]
    bf16 = window_cells["runs"]["static", torch.bfloat16][1]
    assert np.isfinite(bf16).all()
    assert np.abs(bf16 - fp32).mean() / np.abs(fp32).mean() < 0.15
    assert (bf16.argmax(-1) == fp32.argmax(-1)).mean() > 0.8
    for init in (tq.QUANT_MODELS["st-gcn"][2], lambda m, dtype: jq.QUANT_MODELS["st-gcn"][2](
            window_cells["jm"], dtype=jnp.int8)):
        with pytest.raises(ValueError, match="raw input frames"):
            init(tm, dtype=torch.int8)


def test_window_serving_cells_and_drift_check():
    """``serving`` takes ST-GCN's window cell, plain and int8 (AA-GCN's plain
    only), and the multi-stage segmenters have no streaming form, as in the
    JAX package."""
    tm = Stgcn(**SMALL, device="cpu")
    state, _ = serving.serving_cell(tm, 2)
    assert state["buf"].shape == (2, 50, V, 3)
    assert serving.state_bytes(tm, 4) == 4 * 50 * V * 3 * 4
    assert serving.state_bytes(tm, 4, quant="int8-static", state_dtype=torch.bfloat16) == \
        4 * 50 * V * 3 * 2
    calib = np.random.default_rng(5).normal(size=(4, V, 3)).astype(np.float32)
    scales = tq.calibrate_scales(tm, tq.quantize_stgcn(tm), calib, "st-gcn")
    drift = serving.check_stream_drift(tm, l=3, batch=1, quant="int8-static", scales=scales)
    assert all(np.isfinite(v) for v in drift.values()), drift
    with pytest.raises(ValueError, match="no int8 streaming cell"):
        serving.quant_cell(AaGcn(**SMALL, device="cpu"), 1, scales={})
    for model in (MsTcn(5, 3, device="cpu", **MS), MsGcn(**SMALL, device="cpu", **MS)):
        with pytest.raises(ValueError, match="no streaming form"):
            streaming_fns(model)
    with pytest.raises(ValueError, match="no streaming form"):
        j_streaming_fns("ms-gcn")


# -- the CLI --------------------------------------------------------------------------


def _cli_config(tmp, name):
    """The family's as_is config cut to 2 layers of 8/16 channels (MS-GCN's
    refinement to 2 stages of 2 layers, dropout 0.5), on synthetic trials
    and the CPU."""
    data = os.path.join(tmp, "data")
    if not os.path.exists(data):
        generate(data, skeleton="pku-mmd", num_classes=5, in_feat=3, num_train=3,
                 num_val=2, min_len=20, max_len=30, seed=6)
    with open(os.path.join(REPO, FAMILY_CONFIGS[name])) as f:
        cfg = json.load(f)
    if name != "ms-tcn":
        cfg["arch"]["st-gcn"].update(in_ch=[8, 8], out_ch=[8, 16], stride=[1, 2],
                                     residual=[1, 1], dropout=[0.0, 0.0], kernel=5)
    cfg["arch"]["ms-tcn"] = {"stages": 2, "filters": [8, 8], "layers": [2, 2],
                             "kernel": [3, 3], "dropout": [0.5, 0.5]}
    cfg["arch"]["segment"] = 32
    cfg["processor"].update(data=data, actions=os.path.join(data, "actions.txt"),
                            out=os.path.join(tmp, name), demo=[0])
    cfg["optimizer"].update(epochs=1, checkpoint_indices=[0], batch_size=2)
    cfg["job"] = {"platform": "cpu"}
    path = os.path.join(tmp, f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path, cfg


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("name", ["st-gcn", "ms-gcn"])
def test_cli_train_test_benchmark(tmp_path, capsys, name):
    """``train`` (one epoch, every artifact, finite losses), ``test`` on
    ``final`` (the epoch's top1_val again), and ``benchmark``: ST-GCN's
    window cell with the int8 rows (eager row, accuracy, size; the graph
    replays need the card), MS-GCN refused as the JAX CLI refuses it."""
    path, cfg = _cli_config(str(tmp_path), name)
    out = cfg["processor"]["out"]
    assert main(["train", "--config", path]) == 0
    for artifact in ["train-validation-curve.csv", "accuracy-curve.csv", "macro-F1@k-0.csv",
                     "edit-0.csv", "confusion-matrix-0.csv", "segmentation-0.csv", "epoch-0",
                     "final"]:
        assert os.path.exists(os.path.join(out, artifact)), artifact
    curve = np.asarray(_rows(os.path.join(out, "train-validation-curve.csv"))[1:], float)
    assert curve.shape[0] == 1 and np.isfinite(curve[:, 1:5]).all()
    assert main(["test", "--config", path, "--set", f"processor.checkpoint={out}/final"]) == 0
    assert float(_rows(os.path.join(out, "accuracy.csv"))[1][0]) == curve[0, 7]
    seg = np.asarray(_rows(os.path.join(out, "segmentation-0.csv"))[1:], int)
    assert seg.shape[1] == 2 and (seg[:, 1] >= 0).all() and (seg[:, 1] < 5).all()
    capsys.readouterr()
    if name == "ms-gcn":
        with pytest.raises(ValueError, match="no streaming form"):
            main(["benchmark", "--config", path])
        return
    assert main(["benchmark", "--config", path]) == 0
    line = json.loads([s for s in capsys.readouterr().out.splitlines() if s.startswith("{")][-1])
    assert line["model"] == "st-gcn" and line["clock"] == "host" and line["p99_ms"] > 0
    row = dict(zip(*_rows(os.path.join(out, "latency.csv"))))
    assert float(row["int8_p50_ms"]) == line["int8_p50_ms"] > 0
    assert row["int8_onchip_ms"] == row["int8_static_onchip_ms"] == row["w8_onchip_ms"] == ""
    size = _rows(os.path.join(out, "model-size.csv"))
    assert 0 < float(size[1][1]) == line["int8_size_mb"] < float(size[1][0])
    assert 0 <= line["int8_agrees_fp32"] <= 1


def test_ms_tcn_benchmark_refuses_as_jax_does(tmp_path):
    path, _ = _cli_config(str(tmp_path), "ms-tcn")
    with pytest.raises(ValueError, match="no streaming form"):
        main(["benchmark", "--config", path])
    with pytest.raises(ValueError, match="no streaming form"):
        j_streaming_fns("ms-tcn")
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        main(["train", "--config", path, "--set", "arch.pipeline=true"])


def test_train_throughput_counts_stgcn_as_the_jax_bench():
    """MACs and least bytes of an ST-GCN window, as the JAX train bench
    counts them for its canonical model."""
    from stgx.utils import flops as j_flops
    from stgx_torch.bench.train_throughput import rooflines

    model = build_model(load_config(FAMILY_CONFIGS["st-gcn"]), 52, device="cpu")
    for dtype, nbytes in (("float32", 4), ("bfloat16", 2)):
        assert rooflines(model, "st-gcn", dtype) == (
            j_flops.stgcn_macs_per_window(),
            j_flops.stgcn_train_hbm_bytes_per_window(dtype_bytes=nbytes))
