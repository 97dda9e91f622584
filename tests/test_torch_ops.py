"""The port's ops (stgx_torch.ops) against the JAX package on the CPU.

Each kernel's plain PyTorch version — what the port's wrapper runs for a CPU
tensor — is held against the JAX kernel in Pallas interpret mode (run as the
JAX package's own tests run it) and against the JAX XLA form, on the same
numpy inputs. The CUDA kernels themselves are held against these plain
versions on the card by chip_smoke.py. Tolerance, fp32: ``rtol = 1e-5``
and ``atol = 1e-5 · max(1, max|ref|)`` (the same fp32 products, summed in
another order; the scale keeps it relative for outputs of size ~10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from stgx.ops import graph_conv as j_gc
from stgx.ops import norms as j_norms
from stgx.ops import pallas_gcn as j_pgcn
from stgx.ops import rt_fused as j_rtf
from stgx.ops import temporal as j_temporal
from stgx.ops.pallas_acc import causal_accumulate_pallas
from stgx_torch.ops import graph_conv, norms, rt_fused, temporal
from stgx_torch.ops.gcn_core import gcn_core
from stgx_torch.ops.window_sum import window_sum

TOL = 1e-5


def _np(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return torch.tensor(a)


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(ref).max())))


GCN_SHAPES = [
    # (R, V, P, C_in, C_out)
    (37, 25, 3, 16, 32),  # ragged rows, the PKU-MMD rig
    (1, 25, 3, 24, 8),  # R = 1: one stream of the streaming cell
    (20, 7, 2, 6, 8),  # FOG-IT-like small rig
]


@pytest.mark.parametrize("r,v,p,cin,cout", GCN_SHAPES)
def test_gcn_core_matches_pallas(monkeypatch, r, v, p, cin, cout):
    monkeypatch.setattr(j_pgcn, "_INTERPRET", True)
    rng = np.random.default_rng(r + cin)
    x, A, W = _np(rng, r, v, cin), _np(rng, p, v, v), _np(rng, p, cin, cout, scale=0.3)
    ref = j_pgcn.gcn_core_pallas(jnp.asarray(x), jnp.asarray(A), jnp.asarray(W))
    _close(gcn_core(_t(x), _t(A), _t(W)), ref)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("n,l,v,p,cin,cout", [(2, 9, 25, 3, 16, 24), (3, 4, 7, 2, 6, 8)])
def test_partitioned_gcn_matches_jax(monkeypatch, n, l, v, p, cin, cout, bias):
    monkeypatch.setattr(j_pgcn, "_INTERPRET", True)
    rng = np.random.default_rng(n * l)
    x, A, W = _np(rng, n, l, v, cin), _np(rng, p, v, v), _np(rng, p, cin, cout, scale=0.3)
    b = _np(rng, p, cout) if bias else None
    jb = jnp.asarray(b) if bias else None
    got = graph_conv.partitioned_gcn(_t(x), _t(A), _t(W), _t(b) if bias else None)
    xj, Aj, Wj = jnp.asarray(x), jnp.asarray(A), jnp.asarray(W)
    _close(got, j_gc.partitioned_gcn(xj, Aj, Wj, jb))
    _close(got, j_pgcn.partitioned_gcn_pallas(xj, Aj, Wj, jb))


def test_gcn_aggregate_matches_jax():
    rng = np.random.default_rng(5)
    x, A = _np(rng, 2, 3, 25, 8), _np(rng, 3, 25, 25)
    _close(graph_conv.gcn_aggregate(_t(x), _t(A)),
           j_gc.gcn_aggregate(jnp.asarray(x), jnp.asarray(A)))


def test_gcn_core_bf16_matches_pallas(monkeypatch):
    """bf16 in, fp32 sums, bf16 out: the plain version rounds like the TPU
    kernel (A and W in x's type, the aggregate kept in fp32)."""
    monkeypatch.setattr(j_pgcn, "_INTERPRET", True)
    rng = np.random.default_rng(11)
    x, A, W = _np(rng, 10, 25, 16), _np(rng, 3, 25, 25), _np(rng, 3, 16, 32, scale=0.3)
    ref = j_pgcn.gcn_core_pallas(jnp.asarray(x, jnp.bfloat16), jnp.asarray(A),
                                 jnp.asarray(W))
    got = gcn_core(_t(x).bfloat16(), _t(A), _t(W))
    assert got.dtype == torch.bfloat16
    # one bf16 rounding of the output (2^-8 relative) apart at most
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=1e-2, atol=1e-2)


WS_CASES = [
    # (N, L, V, C, Γ, s): L not a multiple of any block, and L below the reach
    (2, 30, 7, 8, 9, 1),
    (2, 257, 5, 8, 9, 2),
    (1, 5, 7, 4, 9, 1),
    (1, 7, 3, 4, 9, 2),
]


@pytest.mark.parametrize("n,l,v,c,gamma,stride", WS_CASES)
def test_window_sum_matches_pallas(n, l, v, c, gamma, stride):
    x = _np(np.random.default_rng(l + stride), n, l, v, c)
    with pltpu.force_tpu_interpret_mode():
        ref = causal_accumulate_pallas(jnp.asarray(x), gamma, stride)
    _close(window_sum(_t(x), gamma, stride), ref)
    _close(temporal.causal_accumulate(_t(x), gamma, stride),
           j_temporal.causal_accumulate(jnp.asarray(x), gamma, stride))


@pytest.mark.parametrize("n,l,v,c,gamma,stride", WS_CASES)
def test_window_sum_reverse_is_the_jax_vjp(n, l, v, c, gamma, stride):
    rng = np.random.default_rng(100 + l)
    x, g = _np(rng, n, l, v, c), _np(rng, n, l, v, c)
    _, vjp = jax.vjp(lambda t: j_temporal.causal_accumulate(t, gamma, stride),
                     jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(g))
    _close(window_sum(_t(g), gamma, stride, reverse=True), ref)


def test_window_sum_single_tap_is_identity():
    x = torch.randn(1, 6, 3, 4)
    assert window_sum(x, 2, 2) is x
    assert window_sum(x, 9, 9, reverse=True) is x


RT_CASES = [
    # (N, L, V, P, C_in, C_out, Γ, s)
    (2, 40, 25, 3, 16, 24, 9, 1),  # L not a multiple of any tile
    (1, 37, 25, 3, 8, 16, 9, 2),  # stride-2 taps, ragged L
    (2, 5, 25, 3, 8, 8, 9, 1),  # L shorter than the 8-frame halo
    (1, 4, 11, 2, 6, 8, 9, 2),  # L shorter than the 6-frame halo
]


@pytest.mark.parametrize("n,l,v,p,cin,cout,gamma,stride", RT_CASES)
def test_rt_fused_matches_pallas(monkeypatch, n, l, v, p, cin, cout, gamma, stride):
    monkeypatch.setattr(j_rtf, "_INTERPRET", True)
    rng = np.random.default_rng(l * cin)
    x, A = _np(rng, n, l, v, cin), _np(rng, p, v, v)
    W, b = _np(rng, p, cin, cout, scale=0.3), _np(rng, p, cout)
    ref = j_rtf.rt_fused_gcn_acc(jnp.asarray(x), jnp.asarray(A), jnp.asarray(W),
                                 jnp.asarray(b), gamma, stride)
    got = rt_fused.rt_fused_gcn_acc(_t(x), _t(A), _t(W), _t(b), gamma, stride)
    _close(got, ref)


def test_rt_fused_long_halo_takes_the_unfused_chain(monkeypatch):
    """The JAX dispatch rule: a halo longer than the TPU kernel's smallest
    time tile sends the work to the unfused chain (gcn_core + window_sum),
    never to the fused kernel."""
    called = []
    monkeypatch.setattr(rt_fused, "rt_fused_core",
                        lambda *a: called.append(a) or pytest.fail("fused"))
    rng = np.random.default_rng(3)
    x, A, W, b = (_np(rng, 1, 80, 7, 8), _np(rng, 2, 7, 7),
                  _np(rng, 2, 8, 8, scale=0.3), _np(rng, 2, 8))
    got = rt_fused.rt_fused_gcn_acc(_t(x), _t(A), _t(W), _t(b), 70, 1)
    ref = j_temporal.causal_accumulate(
        j_gc.partitioned_gcn(jnp.asarray(x), jnp.asarray(A), jnp.asarray(W),
                             jnp.asarray(b)), 70, 1)
    _close(got, ref)
    assert not called


@pytest.mark.parametrize("masked", [False, True])
def test_layer_norm_matches_jax(masked):
    rng = np.random.default_rng(1)
    x, w, b = _np(rng, 2, 6, 25, 8), _np(rng, 25, 8), _np(rng, 25, 8)
    ln = norms.LayerNorm(25, 8)
    ln.scale.data, ln.bias.data = _t(w), _t(b)
    mask = _t(rng.random((2, 6)) > 0.3) if masked else None  # LayerNorm ignores it
    _close(ln(_t(x), mask=mask),
           j_norms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("per_joint", [False, True])
def test_batch_norm_matches_jax(per_joint, masked):
    rng = np.random.default_rng(2)
    x = _np(rng, 3, 7, 25, 8)
    shape = (25, 8) if per_joint else (8,)
    w, b = _np(rng, *shape), _np(rng, *shape)
    axes = (0, 1) if per_joint else (0, 1, 2)
    mask = rng.random((3, 7)) > 0.3
    got = norms.batch_norm(_t(x), _t(w), _t(b), axes,
                           mask=_t(mask) if masked else None)
    ref = j_norms.batch_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), axes,
                             mask=jnp.asarray(mask) if masked else None)
    _close(got, ref)


@pytest.mark.parametrize("impl", ["taps", "fifo_sum"])
@pytest.mark.parametrize("gamma,stride,batch", [(9, 1, 3), (9, 2, 3), (20, 1, 8)])
def test_causal_accumulate_step_matches_jax(gamma, stride, batch, impl):
    """Both step forms, against the JAX step with the same form pinned, over
    a stream longer than the FIFO."""
    rng = np.random.default_rng(gamma + stride)
    frames = _np(rng, 12, batch, 5, 4)
    saved = j_temporal.get_acc_step_impl()
    j_temporal.set_acc_step_impl(impl)
    try:
        j_state = j_temporal.init_accumulator_state(batch, 5, 4, gamma, stride)
        t_state = temporal.init_accumulator_state(batch, 5, 4, gamma, stride,
                                                  device="cpu")
        for f in frames:
            j_y, j_state = j_temporal.causal_accumulate_step(
                j_state, jnp.asarray(f), gamma, stride)
            t_y, t_state = temporal.causal_accumulate_step(
                t_state, _t(f), gamma, stride, impl)
            _close(t_y, j_y)
        _close(t_state["fifo"], j_state["fifo"])
    finally:
        j_temporal.set_acc_step_impl(saved)


def test_wrappers_refuse_devices_without_a_kernel():
    x = torch.empty(2, 3, 25, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        window_sum(x, 9, 1)
    with pytest.raises(ValueError, match="no kernel"):
        gcn_core(x[0], torch.empty(3, 25, 25, device="meta"),
                 torch.empty(3, 8, 8, device="meta"))
