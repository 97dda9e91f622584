"""The port's profiling probes on the CPU: the traffic audit
(``stgx_torch.bench.traffic_audit``, from ``stgx/bench/hlo_audit.py``), the
switch probe (``switch_probe``, from ``xla_probe.py``) and the int8 probe
(``quant_probe``, from ``quant_probe.py``).

* The byte counter on a product, a ReLU, an in-place add, a view and a
  ``_foreach_add_`` equals hand arithmetic; the view counts nothing.
* Small audited steps (``tests/test_torch_ablate.py``'s widths): RT-ST-GCN's
  and ST-GCN's steps have backward and optimizer rows, at least
  ``utils/flops.py``'s bytes a frame, and ``fwd_only`` counts fewer bytes
  than the whole step; the counted step's loss is the uncounted one's.
* The audited step's x, y and mask are ``stgx.bench.hlo_audit.build_step``'s
  (``rt-st-gcn``, float32, one trial of 24 frames), and its forward loss on
  the JAX weights (``from_jax_params``) is the JAX ``fwd_only`` step's
  within 1e-5.
* The switch probe: each variant's switches, and a raising block's, are put
  back; ``rt_fused`` gives the baseline's loss and gradients bit for bit
  here; a variant whose switch the model never reaches is refused with its
  reason; a raising variant is recorded and the run goes on; the timing
  refuses a CPU model.
* The int8 probe: the ``hybrid_{fcn,gcn,res}`` and ``static_ones`` cells of
  ``tests/test_torch_quant.py``'s 3-layer RT-ST-GCN against the JAX cells
  under ``stgx/bench/quant_probe.py:116-135``'s rule (copied here, on the
  JAX cell's ``_quantize_act``, for the test only), within that file's
  ``TOL_CELL``; the port's patch put back; the CPU op diff: the dynamic
  cell's abs-max once an activation site, the static cell's none.

No timing is asserted: the measurements need the card.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stgx.bench.quant as jq
import stgx_torch.bench.quant as tq
from stgx_torch.bench import quant_probe, switch_probe, traffic_audit
from stgx_torch.bench.train_throughput import step_fn, trainer_for
from stgx_torch.config import FAMILY_CONFIGS, load_config
from test_torch_quant import TOL_CELL, _pair, _run_jax, _run_port

SMALL = {name: [f"arch.{name}.{k}={v}" for k, v in (
    ("in_ch", "[8,8]"), ("out_ch", "[8,16]"), ("stride", "[1,2]"), ("residual", "[1,1]"),
    ("dropout", "[0,0]"))] for name in ("rt-st-gcn", "st-gcn", "co-st-gcn")}
QUANT_FRAMES = 8  # of test_torch_quant's 24-frame stream


# -- the traffic audit ------------------------------------------------------------------


def test_byte_counter_equals_hand_arithmetic():
    a, b = torch.randn(4, 8), torch.randn(8, 16)
    lists = [torch.zeros(3), torch.zeros(5)]
    counter = traffic_audit.TrafficCounter()
    with counter:
        c = a @ b
        d = torch.relu(c)
        d.add_(c)
        e = d.view(64)
        torch._foreach_add_(lists, 1.0)
    assert e.shape == (64,)
    rows = {r["op"]: r for r in counter.rows.values()}
    want = {  # (read, write) bytes
        "aten::mm": (4 * (4 * 8 + 8 * 16), 4 * 4 * 16),
        "aten::relu": (4 * 64, 4 * 64),
        "aten::add_": (4 * 64 * 2, 4 * 64),
        "aten::_foreach_add_": (4 * 8, 4 * 8),
    }
    assert set(rows) == set(want)  # the view moved nothing
    for op, (read, write) in want.items():
        assert (rows[op]["read_bytes"], rows[op]["write_bytes"], rows[op]["count"]) == (
            read, write, 1), op
    rep = traffic_audit.report(counter)
    assert rep["ops"] == 4
    assert rep["read_bytes"] == sum(r for r, _ in want.values())
    assert rep["total_bytes"] == sum(r + w for r, w in want.values())


@pytest.mark.parametrize("name", ["rt-st-gcn", "st-gcn"])
def test_small_audited_step(name):
    frames, trials = (40, 2) if name == "rt-st-gcn" else (50, 1)
    full = traffic_audit.run(name, "float32", frames, trials=trials, device="cpu",
                             overrides=SMALL[name])
    fwd = traffic_audit.run(name, "float32", frames, fwd_only=True, trials=trials,
                            device="cpu", overrides=SMALL[name])
    phases = {r["phase"] for r in full["rows"]}
    assert phases == {"forward", "backward", "optimizer"}, phases
    assert {r["phase"] for r in fwd["rows"]} == {"forward"}
    assert any(r["node"] == "SqrtBackward0" for r in full["rows"])  # a norm's backward
    assert full["loss_unchanged"] and fwd["loss_unchanged"]
    assert full["est_bytes_per_frame_mb"] >= full["min_bytes_per_frame_mb"] > 0
    assert fwd["est_total_mb"] < full["est_total_mb"]
    assert full["frames_per_step"] == (trials * frames if name == "rt-st-gcn" else 20)
    assert full["cost_analysis"]["flops"] > fwd["cost_analysis"]["flops"] > 0
    mem = full["memory_analysis"]
    assert mem["optimizer_state_bytes"] >= 2 * mem["param_bytes"]
    assert mem["peak_allocated_bytes"] is None and "step_ms_p50" not in full
    with pytest.raises(RuntimeError, match="device measurement"):
        trainer = trainer_for(load_config(FAMILY_CONFIGS[name], SMALL[name]), "float32", "cpu")
        traffic_audit.audit(trainer, name, frames, trials, timed=True)


def test_audited_step_is_build_steps():
    from stgx.bench.hlo_audit import build_step
    from stgx_torch.weights import from_jax_params

    step, (params, opt, x, y, mask), n_frames = build_step(
        "rt-st-gcn", "float32", frames=24, trials=1, fwd_only=True)
    _, _, ref = jax.jit(step)(params, opt, x, y, mask)
    trainer = trainer_for(load_config(FAMILY_CONFIGS["rt-st-gcn"]), "float32", "cpu")
    trainer.model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params),
                                                  trainer.model), strict=True)
    tx, ty, tm, frames = traffic_audit.audit_inputs(trainer, 24, 1)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(x))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(y))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(mask))
    assert frames == n_frames
    ce, mse = step_fn(trainer, tx, ty, tm, None, fwd_only=True)()
    assert abs(float(ce) + float(mse) - float(ref)) <= 1e-5 * max(1.0, abs(float(ref)))


# -- the switch probe -------------------------------------------------------------------


@pytest.mark.parametrize("variant", [n for n, _ in switch_probe.VARIANTS])
def test_each_variant_puts_every_switch_back(variant):
    settings = dict(switch_probe.VARIANTS)[variant]
    before = switch_probe.switch_state()
    with switch_probe.switched(settings):
        now = switch_probe.switch_state()
        assert all(now[k] == v for k, v in settings.items())
    assert switch_probe.switch_state() == before
    with pytest.raises(KeyError), switch_probe.switched(settings):
        raise KeyError("inside the block")
    assert switch_probe.switch_state() == before


def _probe(name, **kw):
    shape = (4, 50) if name == "st-gcn" else (2, 40)
    return switch_probe.probe(name, "float32", device="cpu", timed=False,
                              overrides=SMALL[name], shape=shape, **kw)


def test_rt_fused_gives_the_baselines_loss_and_gradients():
    recs = {r["variant"]: r for r in _probe("rt-st-gcn")}
    assert recs["rt_fused"]["grads_equal"] and recs["rt_fused"]["grad_dist"] == 0.0
    assert recs["rt_fused"]["loss"] == recs["baseline_pre"]["loss"]
    assert recs["baseline_post"]["grads_equal"]
    assert all("error" not in r for r in recs.values())
    assert {v for v, r in recs.items() if "refused" in r} == set(switch_probe.NOT_RUN_BY[
        "rt-st-gcn"])


def test_variants_a_model_never_reaches_are_refused_with_their_reason():
    for name, skipped in switch_probe.NOT_RUN_BY.items():
        for variant, reason in skipped.items():
            with pytest.raises(ValueError, match="is not run for") as e:
                switch_probe.check_variant(name, variant)
            assert reason in str(e.value)
            with pytest.raises(ValueError, match="is not run for"):
                switch_probe.main(["--model", name, "--only", variant])
    wide = types.SimpleNamespace(kernel=69, dilation=(1, 2, 4))
    with pytest.raises(ValueError, match="spans 273 frames"):
        switch_probe.check_variant("co-st-gcn", "conv_route_cudnn", wide)
    assert switch_probe.refusal("co-st-gcn", "conv_route_cudnn",
                                types.SimpleNamespace(kernel=9, dilation=(1, 2))) is None
    with pytest.raises(ValueError, match="unknown variant"):
        switch_probe.check_variant("st-gcn", "xla_flags")


def test_a_raising_variant_is_recorded_and_the_run_goes_on(monkeypatch):
    def broken(*args):
        raise RuntimeError("no route")

    variants = list(switch_probe.VARIANTS)
    variants.insert(1, ("broken", {"conv_route": broken, "cudnn.benchmark": True}))
    monkeypatch.setattr(switch_probe, "VARIANTS", variants)
    before = switch_probe.switch_state()
    recs = {r["variant"]: r for r in _probe("co-st-gcn")}
    assert recs["broken"]["error"] == "RuntimeError: no route"
    assert switch_probe.switch_state() == before
    ran = [v for v, r in recs.items() if "loss" in r]
    assert "conv_route_cudnn" in ran and "baseline_post" in ran
    assert recs["baseline_post"]["grads_equal"]


def test_the_timing_refuses_a_cpu_model():
    with pytest.raises(RuntimeError, match="on the card"):
        switch_probe.probe("st-gcn", device="cpu", overrides=SMALL["st-gcn"])


# -- the int8 probe ---------------------------------------------------------------------


def _jax_hybrid(family, scales):
    """``stgx/bench/quant_probe.py:116-135``'s hybrid quantizer."""

    def hybrid(x, scale=None, site=None):
        use_static = site is not None and (
            site.startswith("fcn") if family == "fcn" else f".{family}" in site)
        if scale is None and use_static:
            s = scales[site]
            xq = jnp.clip(jnp.round(x / s), -127, 127).astype(jnp.int8)
            return xq, s
        s = jnp.maximum(jnp.max(jnp.abs(x)), 1e-12) / 127.0
        xq = jnp.clip(jnp.round(x / s), -127, 127).astype(jnp.int8)
        return xq, s

    return hybrid


@pytest.fixture(scope="module")
def rt_cells():
    jm, params, tm, x = _pair("rt-st-gcn")
    jqp = jq.QUANT_MODELS["rt-st-gcn"][0](jm, params)
    tqp = tq.QUANT_MODELS["rt-st-gcn"][0](tm)
    scales = jq.calibrate_scales(jm, jqp, jnp.asarray(x[0]), "rt-st-gcn")
    return jm, jqp, tm, tqp, x[:, :QUANT_FRAMES], scales


@pytest.mark.parametrize("cell", ["hybrid_fcn", "hybrid_gcn", "hybrid_res", "static_ones"])
def test_probe_cells_match_jax(rt_cells, cell):
    jm, jqp, tm, tqp, x, scales = rt_cells
    orig = tq._act_scale
    if cell == "static_ones":
        ones = dict.fromkeys(scales, 1.0)
        (ref, _), (got, _) = (_run_jax("rt-st-gcn", jm, jqp, x, "static", "float32", ones),
                              _run_port("rt-st-gcn", tm, tqp, x, "static", "float32", ones))
    else:
        family = cell.split("_")[1]
        with pytest.MonkeyPatch.context() as mp:  # the JAX cell's, for this test only
            mp.setattr(jq, "_quantize_act", _jax_hybrid(family, scales))
            ref, _ = _run_jax("rt-st-gcn", jm, jqp, x, "dynamic", "float32", None)
        with quant_probe.hybrid(family, scales, "cpu"):
            assert tq._act_scale is not orig
            got, _ = _run_port("rt-st-gcn", tm, tqp, x, "dynamic", "float32", None)
        dyn, _ = _run_port("rt-st-gcn", tm, tqp, x, "dynamic", "float32", None)
        assert np.abs(got - dyn).max() > 0  # the calibrated scales reached the cell
    assert tq._act_scale is orig
    rel = np.abs(got - ref).max() / max(1.0, np.abs(ref).max())
    assert np.isfinite(got).all() and got.shape == ref.shape
    assert rel <= TOL_CELL, rel


def test_hybrid_patch_is_put_back_when_the_block_raises(rt_cells):
    orig = tq._act_scale
    with pytest.raises(ZeroDivisionError), quant_probe.hybrid("gcn", rt_cells[5], "cpu"):
        raise ZeroDivisionError
    assert tq._act_scale is orig


def test_op_diff_drops_the_abs_max_of_each_activation_site(rt_cells):
    _, _, tm, tqp, x, scales = rt_cells
    x_t = torch.tensor(x[:, 0])
    sites = [s for s in scales if not s.endswith(".state")]
    hist = {m: quant_probe.op_histogram(tm, tqp, x_t, m, scales) for m in ("dynamic", "static")}
    assert hist["dynamic"]["aten::amax"] == len(sites) == 6
    assert hist["static"]["aten::amax"] == 0
    d = quant_probe.diff(hist["static"], hist["dynamic"])
    assert d["aten::amax"] == -len(sites) and d["aten::abs"] == -len(sites)
    assert list(d.values()) == sorted(d.values(), key=abs, reverse=True)
