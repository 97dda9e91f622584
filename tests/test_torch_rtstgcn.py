"""The port's RT-ST-GCN (stgx_torch.models.rtstgcn) against the JAX model.

The JAX variables are made once from a seed, perturbed so that no leaf
keeps its init value, carried into the port by ``from_jax_params`` and
loaded with ``strict=True``; both models then see the same numpy inputs on
the CPU, where the port's ops run their plain versions and the JAX fused
kernel runs in Pallas interpret mode. Tolerance for a whole model: max abs
error ≤ 1e-4 · max(1, max|ref|) (fp32 sums in another order, through
normalised layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stgx.config import build_model as j_build_model
from stgx.config import load_config as j_load_config
from stgx.graph import SKELETONS, Graph as JGraph, load_skeleton
from stgx.models.rtstgcn import RtStgcn as JRtStgcn
from stgx.models.rtstgcn import stream_sequence as j_stream_sequence
from stgx.ops import rt_fused as j_rtf
from stgx_torch.bench.serving import bisect_capacity, serving_cell
from stgx_torch.bench.streaming import measure_stream_latency
from stgx_torch.config import build_model, load_config
from stgx_torch.graph import Graph
from stgx_torch.models import MODELS
from stgx_torch.models.rtstgcn import (
    RtStgcn,
    init_stream_state,
    stream_sequence,
    stream_step,
)
from stgx_torch.ops import rt_fused
from stgx_torch.weights import from_jax_params

CONFIG = "configs/pku-mmd/as_is/rtstgcn.json"
SMALL = dict(
    num_classes=5,
    in_feat=3,
    graph=load_skeleton("pku-mmd"),
    kernel=9,
    in_ch=(8, 8, 16),
    out_ch=(8, 16, 16),
    stride=(1, 2, 1),
    residual=(1, 1, 0),  # layer 1 has the residual 1×1 conv, layer 2 none
    dropout=(0.0, 0.0, 0.0),
)


def _perturbed(params, seed):
    """Every leaf moved off its init value, deterministically."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=np.shape(a)).astype(np.float32),
        params,
    )


def _pair(normalization, cfg=SMALL, l=20, n=2, seed=0):
    jm = JRtStgcn(normalization=normalization, **cfg)
    x = np.random.default_rng(seed).normal(size=(n, l, 25, cfg["in_feat"]))
    x = x.astype(np.float32)
    params = _perturbed(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x)), seed)
    tm = RtStgcn(normalization=normalization, **cfg, device="cpu")
    tm.load_state_dict(from_jax_params(params, tm), strict=True)
    return jm, params, tm, x


def _assert_model_close(got, ref):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(got) - ref).max()
    assert err <= 1e-4 * max(1.0, np.abs(ref).max()), err


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("normalization", ["LayerNorm", "BatchNorm"])
def test_batch_forward_matches_jax(monkeypatch, normalization, fused):
    monkeypatch.setattr(j_rtf, "_INTERPRET", True)
    monkeypatch.setattr(j_rtf, "_ENABLED", fused)
    monkeypatch.setattr(rt_fused, "_ENABLED", fused)
    jm, params, tm, x = _pair(normalization)
    ref = jm.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.tensor(x))
    assert got.shape == (2, 20, 5)
    _assert_model_close(got.numpy(), ref)


@pytest.mark.parametrize("normalization", ["LayerNorm", "BatchNorm"])
def test_stream_sequence_matches_jax(normalization):
    jm, params, tm, x = _pair(normalization, l=14, n=3)
    ref, _ = j_stream_sequence(jm, params, jnp.asarray(x))
    got, state = stream_sequence(tm, torch.tensor(x))
    _assert_model_close(got.numpy(), ref)
    assert len(state) == 3 and state[1]["fifo"].shape == (7, 3, 25, 16)


def test_fifo_equals_batch_under_layernorm():
    _, _, tm, x = _pair("LayerNorm", l=24)
    with torch.no_grad():
        batch = tm(torch.tensor(x))
    stream, _ = stream_sequence(tm, torch.tensor(x))
    _assert_model_close(stream.numpy(), batch.numpy())


def test_stream_state_carries_across_chunks():
    _, _, tm, x = _pair("BatchNorm", l=16)
    full, _ = stream_sequence(tm, torch.tensor(x))
    first, state = stream_sequence(tm, torch.tensor(x[:, :7]))
    second, _ = stream_sequence(tm, torch.tensor(x[:, 7:]), state)
    torch.testing.assert_close(torch.cat([first, second], dim=1), full)


def test_full_width_rtstgcn9_matches_jax():
    """RT-ST-GCN₉ at its PKU-MMD width (the configured model), tiny N·L."""
    cfg = j_load_config(CONFIG)
    jm = j_build_model(cfg, 52)
    x = np.random.default_rng(1).normal(size=(1, 12, 25, 3)).astype(np.float32)
    params = _perturbed(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)), 1)
    tm = build_model(load_config(CONFIG), 52, device="cpu")
    tm.load_state_dict(from_jax_params(params, tm), strict=True)
    with torch.no_grad():
        got = tm(torch.tensor(x))
    _assert_model_close(got.numpy(), jm.apply(params, jnp.asarray(x)))


def test_from_jax_params_maps_norm_names():
    """In a layer with the residual 1×1 conv (layers 3 and 6 of RT-ST-GCN₉)
    BatchNorm_0 is the residual norm and BatchNorm_1 the main one; elsewhere
    BatchNorm_0 is the main norm."""
    cfg = j_load_config(CONFIG)
    jm = j_build_model(cfg, 52)
    params = _perturbed(jm.init(jax.random.PRNGKey(2), jnp.zeros((1, 4, 25, 3))), 2)
    p = params["params"]
    assert sorted(p["layers_3"]) == ["BatchNorm_0", "BatchNorm_1", "GraphConv_0",
                                     "res_kernel"]
    tm = build_model(load_config(CONFIG), 52, device="cpu")
    sd = from_jax_params(params, tm)
    for i in (3, 6):
        np.testing.assert_array_equal(sd[f"layers.{i}.res_norm.scale"].numpy(),
                                      p[f"layers_{i}"]["BatchNorm_0"]["scale"])
        np.testing.assert_array_equal(sd[f"layers.{i}.norm.bias"].numpy(),
                                      p[f"layers_{i}"]["BatchNorm_1"]["bias"])
    np.testing.assert_array_equal(sd["layers.0.norm.scale"].numpy(),
                                  p["layers_0"]["BatchNorm_0"]["scale"])
    np.testing.assert_array_equal(sd["layers.8.gcn.kernel"].numpy(),
                                  p["layers_8"]["GraphConv_0"]["kernel"])
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd, strict=True)


def test_strict_loading_refuses_a_wrong_tree():
    jm, params, tm, _ = _pair("LayerNorm")
    sd = from_jax_params(params, tm)
    del sd["layers.1.res_kernel"]
    with pytest.raises(RuntimeError, match="res_kernel"):
        tm.load_state_dict(sd, strict=True)
    params["params"]["layers_0"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="extra"):
        from_jax_params(params, tm)


def test_config_overrides_and_builder():
    overrides = ["arch.normalization=LayerNorm", "optimizer.seed=7"]
    cfg = load_config(CONFIG, overrides)
    assert cfg["arch"]["normalization"] == "LayerNorm"
    assert cfg["optimizer"]["seed"] == 7
    assert cfg["arch"]["rt-st-gcn"]["stride"] == [1, 1, 1, 2, 1, 1, 2, 1, 1]
    m1 = build_model(cfg, 52, device="cpu")
    m2 = build_model(cfg, 52, device="cpu")
    for a, b in zip(m1.parameters(), m2.parameters()):  # seeded from the config
        torch.testing.assert_close(a, b)
    j_params = j_build_model(j_load_config(CONFIG, overrides), 52).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 25, 3)))
    j_count = sum(np.size(a) for a in jax.tree.leaves(j_params))
    assert sum(t.numel() for t in m1.parameters()) == j_count


def test_config_rt_fused_key(monkeypatch):
    monkeypatch.setattr(rt_fused, "_ENABLED", False)
    build_model(load_config(CONFIG, ["arch.rt_fused=true"]), 52, device="cpu")
    assert rt_fused.rt_fused_enabled()


@pytest.mark.parametrize("name", ["st-gcn", "aa-gcn", "shift-gcn++"])
def test_unported_models_raise(name):
    """ST-GCN and AA-GCN are ported (the name is kept from when they
    raised): the RT config's layer plan builds them, through the ``st-gcn``
    fallback group for AA-GCN, as the JAX builder does; Shift-GCN++ still
    raises naming ROADMAP.md."""
    cfg = load_config(CONFIG, [f"processor.model={name}"])
    if name == "shift-gcn++":
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            build_model(cfg, 52, device="cpu")
    else:
        m = build_model(cfg, 52, device="cpu")
        jm = j_build_model(j_load_config(CONFIG, [f"processor.model={name}"]), 52)
        assert type(m) is MODELS[name] and m.in_ch == tuple(jm.in_ch)
        assert m.stride == tuple(jm.stride) == (1, 1, 1, 2, 1, 1, 2, 1, 1)
    with pytest.raises(KeyError):
        MODELS["no-such-model"]


@pytest.mark.parametrize("skeleton", sorted(SKELETONS))
def test_graph_copy_matches_jax_package(skeleton):
    spec = SKELETONS[skeleton]
    for strategy in ("uniform", "distance", "spatial"):
        ref = JGraph(strategy=strategy, **spec)
        got = Graph(strategy=strategy, **spec)
        np.testing.assert_array_equal(got.A, ref.A)
        np.testing.assert_array_equal(got.A_spatial_raw, ref.A_spatial_raw)


def test_bf16_serving_cell_on_the_cpu():
    _, _, tm, x = _pair("BatchNorm")
    state, cell = serving_cell(tm, batch=2, dtype=torch.bfloat16)
    assert next(tm.parameters()).dtype == torch.float32  # the model is untouched
    logits, state = stream_step(cell, state, torch.tensor(x[:, 0]).bfloat16())
    assert logits.dtype == torch.bfloat16 and logits.shape == (2, 5)
    assert torch.isfinite(logits.float()).all()
    assert state[0]["fifo"].dtype == torch.bfloat16


def test_latency_measurement_refuses_the_cpu():
    _, _, tm, x = _pair("LayerNorm")
    with pytest.raises(RuntimeError, match="device measurement"):
        measure_stream_latency(tm, torch.tensor(x[0]))
    assert init_stream_state(tm, batch=1)[0]["fifo"].device.type == "cpu"


def test_bisect_capacity():
    latency = lambda b: 0.01 * b  # noqa: E731 — 33.3 ms budget at b = 3333
    lo, hi = bisect_capacity(latency, 0, 8192, 1e3 / 30, resolution=128)
    assert lo == 3328 and hi - lo <= 128
    assert bisect_capacity(latency, 100, 200, 1.0, resolution=128) == (100, 200)
