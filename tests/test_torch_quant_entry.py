"""The int8 cells through the port's entry points, on the CPU.

* ``check_stream_drift`` of the int8 cell with int8 FIFO state, at
  ``tests/test_serving.py``'s limits (top-1 agreement > 0.8, relative drift
  < 0.25, the second half's drift < 5 × the first's + 1e-3), for RT-ST-GCN
  and CoST-GCN at the JAX test's tiny size;
* ``serving.py``'s int8 arguments and cell, and the state's bytes;
* ``QUANT_MODELS["st-gcn"]`` raising, naming queue 1 item 7;
* the CLI's ``benchmark`` of RT-ST-GCN with ``processor.quantize`` set
  (which it does not read): ``latency.csv`` and ``model-size.csv`` with
  the JAX benchmark's headers, the CPU's int8 columns filled and the graph
  replays empty (not measured on the CPU);
* ``quant_ab``'s result line has the JAX tool's keys; it and
  ``measure_quant`` are device measurements and raise on the CPU.
"""

import ast
import csv
import json
import os

import numpy as np
import pytest
import torch

from stgx.graph import load_skeleton
from stgx_torch.bench import quant_ab, serving
from stgx_torch.bench.quant import QUANT_MODELS, calibrate_scales, quant_mode
from stgx_torch.bench.streaming import measure_quant
from stgx_torch.cli import main
from stgx_torch.data.synth import generate
from stgx_torch.models import MODELS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["rt-st-gcn", "co-st-gcn"]


def _tiny(name, normalization="LayerNorm"):
    """``tests/test_serving.py``'s tiny model, the port's own init."""
    kw = dict(num_classes=5, in_feat=3, graph=load_skeleton("pku-mmd"),
              normalization=normalization, kernel=3, in_ch=(8, 8), out_ch=(8, 8),
              residual=(1, 1), dropout=(0.0, 0.0), importance=True, device="cpu")
    kw["dilation" if name == "co-st-gcn" else "stride"] = (1, 2)
    return MODELS[name](**kw)


def _scales(model, name, n=64, seed=2):
    calib = np.random.default_rng(seed).normal(size=(n, 25, 3)).astype(np.float32)
    return calibrate_scales(model, QUANT_MODELS[name][0](model), torch.tensor(calib), name)


@pytest.mark.parametrize("name", NAMES)
def test_stream_drift_bounded_int8_state(name):
    model = _tiny(name)
    drift = serving.check_stream_drift(model, l=64, batch=2, quant="int8-static",
                                       state_dtype=torch.int8, scales=_scales(model, name))
    assert drift["top1_agreement"] > 0.8, drift
    assert drift["max_rel_drift"] < 0.25, drift
    assert drift["max_abs_drift_second_half"] < 5 * drift["max_abs_drift_first_half"] + 1e-3


@pytest.mark.parametrize("name", NAMES)
def test_the_serving_int8_cell_is_the_quantized_cell(name):
    """``quant_cell`` is the family's int8 cell under ``quant_mode("static")``
    with its state in the asked type; without scales it raises, as the JAX
    tool does."""
    model = _tiny(name)
    scales = _scales(model, name, n=16)
    x = torch.tensor(np.random.default_rng(3).normal(size=(6, 2, 25, 3)), dtype=torch.float32)
    state, step, ctx = serving.quant_cell(model, 2, state_dtype=torch.int8, scales=scales)
    assert all(t.dtype == torch.int8 for layer in state for t in layer.values())
    quantize, qstep, qinit = QUANT_MODELS[name]
    qparams = quantize(model)
    ref_state = qinit(model, batch=2, dtype=torch.int8)
    with ctx:
        for t in range(x.shape[0]):
            got, state = step(state, x[t])
            with quant_mode("static", scales):
                ref, ref_state = qstep(model, qparams, ref_state, x[t])
            assert torch.equal(got, ref)
    with pytest.raises(ValueError, match="calibrated scales"):
        serving.quant_cell(model, 2)
    with pytest.raises(ValueError, match="unknown quant mode"):
        serving.quant_cell(model, 2, quant="int4", scales=scales)
    b32 = serving.state_bytes(model, 64)
    assert serving.state_bytes(model, 64, quant="int8-static", state_dtype=torch.int8) * 4 == b32
    assert serving.state_bytes(model, 64, dtype=torch.bfloat16) * 2 == b32


def test_serving_arguments(monkeypatch):
    """``--state-dtype`` alone serves the int8 cell; ``--quant`` with a
    ``--dtype`` is refused (the int8 cell manages its own types), as is an
    unknown mode; the accepted calls run up to the device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["--quant", "int8-static", "--dtype", "bfloat16"], ["--quant", "int4"],
                 ["--state-dtype", "fp8"]):
        with pytest.raises(SystemExit):
            serving.main(argv)
    for argv in (["--model", "rt-st-gcn", "--quant", "int8-static", "--state-dtype", "bfloat16"],
                 ["--state-dtype", "float32", "--check-drift"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            serving.main(argv)
    frames = serving.calibration_frames(_tiny("rt-st-gcn"), n=8)
    rng = np.random.default_rng(0)
    rng.normal(size=(1, 16, 25, 3))  # the JAX tool's warm-up draw comes first
    np.testing.assert_array_equal(frames.numpy(), rng.normal(size=(8, 25, 3)).astype(np.float32))


def test_the_st_gcn_int8_cell_waits_for_stgcn():
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        QUANT_MODELS["st-gcn"]
    with pytest.raises(KeyError):
        QUANT_MODELS["shift-gcn"]
    assert sorted(QUANT_MODELS) == sorted(NAMES)


def test_device_measurements_refuse_the_cpu(monkeypatch):
    model = _tiny("rt-st-gcn")
    qparams = QUANT_MODELS["rt-st-gcn"][0](model)
    with pytest.raises(RuntimeError, match="device measurement"):
        measure_quant(model, "rt-st-gcn", qparams, torch.zeros(4, 25, 3))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device measurement"):
        quant_ab.main(["--config", "configs/pku-mmd/as_is/rtstgcn.json"])


def _jax_quant_ab_keys():
    """The keys of ``stgx/bench/quant_ab.py``'s result line, read from its
    source: the constant keys of the printed dict and the ``modes`` keys
    it spreads as ``{k}_onchip_ms``."""
    tree = ast.parse(open(os.path.join(REPO, "stgx/bench/quant_ab.py")).read())
    keys, modes = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "modes":
            modes = {k.value for k in node.value.keys}
        elif isinstance(node, ast.Dict) and any(k is None for k in node.keys):
            keys |= {k.value for k in node.keys if isinstance(k, ast.Constant)}
    return keys | {f"{m}_onchip_ms" for m in modes}


def test_quant_ab_line_has_the_jax_keys():
    line = quant_ab.assemble("co-st-gcn", "c.json", 0.5,
                             {"int8_dynamic": 0.7, "int8_static": 0.45, "w8": 0.6}, 40)
    want = _jax_quant_ab_keys()
    assert "int8_static_onchip_ms" in want and "best_quant_mode" in want
    assert set(line) == want
    assert line["best_quant_mode"] == "int8_static" and line["quant_beats_fp32"] is True
    assert line["calibration_sites"] == 40


@pytest.fixture(scope="module")
def rt_cli_cfg(tmp_path_factory):
    """configs/synth/rtstgcn.json on synthetic trials, on the CPU."""
    tmp = str(tmp_path_factory.mktemp("rt_quant_cli"))
    data = os.path.join(tmp, "data")
    generate(data, skeleton="imu_fogit_ABCD", num_classes=5, in_feat=6, num_train=2,
             num_val=1, min_len=40, max_len=60, seed=7)
    with open(os.path.join(REPO, "configs/synth/rtstgcn.json")) as f:
        cfg = json.load(f)
    cfg["processor"].update(data=data, actions=os.path.join(data, "actions.txt"),
                            out=os.path.join(tmp, "out"))
    cfg["job"] = {"platform": "cpu"}
    path = os.path.join(tmp, "rtstgcn.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path, cfg


def test_cli_benchmark_writes_the_int8_rows(rt_cli_cfg, capsys):
    path, cfg = rt_cli_cfg
    out = cfg["processor"]["out"]
    assert main(["benchmark", "--config", path, "--set", "processor.quantize=true",
                 "--set", "processor.state_dtype=int8"]) == 0
    line = json.loads([s for s in capsys.readouterr().out.splitlines() if s.startswith("{")][-1])
    assert line["model"] == "rt-st-gcn" and line["clock"] == "host"
    with open(os.path.join(out, "latency.csv"), newline="") as f:
        header, row = list(csv.reader(f))
    assert header == ["mean_ms", "p50_ms", "p99_ms", "onchip_ms", "frames", "int8_p50_ms",
                      "int8_onchip_ms", "int8_static_onchip_ms", "w8_onchip_ms"]
    row = dict(zip(header, row))
    assert float(row["int8_p50_ms"]) == line["int8_p50_ms"] > 0
    assert [row[k] for k in header if "onchip" in k] == ["", "", "", ""]
    assert all(line[k] is None for k in header if "onchip" in k)
    with open(os.path.join(out, "model-size.csv"), newline="") as f:
        header, row = list(csv.reader(f))
    assert header == ["fp32_mb", "int8_mb"]
    assert 0 < float(row[1]) == line["int8_size_mb"] < float(row[0]) == line["model_size_mb"]
    assert 0 <= line["int8_top1"] <= 1 and 0 <= line["int8_agrees_fp32"] <= 1
