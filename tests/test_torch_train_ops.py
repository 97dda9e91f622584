"""The port's backward ops against the JAX package on the CPU.

Each autograd Function of the port (``gcn_core``, ``window_sum``,
``rt_fused_core``) runs, on a CPU tensor, the same backward decomposition
the card runs, with each kernel's plain version in its place. Its gradients
are held against ``jax.vjp`` of the JAX Pallas kernels in interpret mode
(run as the JAX package's own tests run them), and the plain versions of
the two backward kernels (``gcn_grads_plain``, ``rt_fused_bwd_plain``)
against the JAX kernels' own outputs (``_grads_impl``, which the JAX core's
VJP calls under ``_BWD_IMPL="pallas"``, and ``_bwd_call``), on the same
numpy inputs. The CUDA kernels are held against the plain versions on
the card by chip_smoke.py.

Tolerance, fp32: ``rtol = 1e-5`` and ``atol = 1e-5 · max(1, max|ref|)``:
the same fp32 products summed in another order, over up to a few thousand
terms; the scale keeps the bound relative for gradients of size ~100.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from stgx.ops import pallas_gcn as j_pgcn
from stgx.ops import rt_fused as j_rtf
from stgx.ops.pallas_acc import causal_accumulate_pallas
from stgx_torch.models.rtstgcn import RtLayer, dropout
from stgx_torch.ops import graph_conv, rt_fused
from stgx_torch.ops.gcn_core import gcn_core
from stgx_torch.ops.gcn_grads import gcn_grads, gcn_grads_plain, gcn_grads_splits
from stgx_torch.ops.window_sum import window_sum

TOL = 1e-5

GCN_SHAPES = [
    # (R, V, P, C_in, C_out)
    (37, 25, 3, 16, 32),  # ragged rows, the PKU-MMD rig
    (1, 25, 3, 24, 8),  # R = 1: one row
    (20, 7, 2, 6, 8),  # FOG-IT-like small rig
]

RT_CASES = [
    # (N, L, V, P, C_in, C_out, Γ, s): L not a multiple of the JAX tile
    (2, 40, 25, 3, 16, 24, 9, 1),
    (1, 70, 11, 2, 6, 8, 9, 2),  # stride 2 (4 taps, a 6-frame halo), L past one tile
]


def _np(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(a, grad=False):
    return torch.tensor(a, requires_grad=grad)


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(ref).max())))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(j_pgcn, "_INTERPRET", True)
    monkeypatch.setattr(j_pgcn, "_BWD_IMPL", "pallas")
    monkeypatch.setattr(j_rtf, "_INTERPRET", True)


@pytest.mark.parametrize("r,v,p,cin,cout", GCN_SHAPES)
def test_gcn_core_grads_match_jax_vjp(interpret, r, v, p, cin, cout):
    """The port's gcn_core gradients against jax.vjp of the Pallas core, and
    gcn_grads_plain against the (gA, gW) of that VJP, which are
    ``_grads_impl``'s own outputs (fp32 in, fp32 out)."""
    rng = np.random.default_rng(r + cin)
    x, A, W = _np(rng, r, v, cin), _np(rng, p, v, v), _np(rng, p, cin, cout, scale=0.3)
    g = _np(rng, r, v, cout)
    _, vjp = jax.vjp(j_pgcn.gcn_core_pallas, *(jnp.asarray(a) for a in (x, A, W)))
    ref = vjp(jnp.asarray(g))
    xt, At, Wt = _t(x, True), _t(A, True), _t(W, True)
    y = gcn_core(xt, At, Wt)
    assert type(y.grad_fn).__name__ == "_GcnCoreBackward"
    for got, r_ in zip(torch.autograd.grad(y, (xt, At, Wt), _t(g)), ref):
        _close(got, r_)
    gA, gW = gcn_grads_plain(_t(x), _t(g), _t(A), _t(W))
    _close(gA, ref[1])
    _close(gW, ref[2])
    # the wrapper takes the plain version for a CPU tensor
    for got, r_ in zip(gcn_grads(_t(x), _t(g), _t(A), _t(W)), (gA, gW)):
        torch.testing.assert_close(got, r_, rtol=0, atol=0)


def test_partitioned_gcn_grads_with_bias_match_jax(interpret):
    """Through the conv bias too: A's gradient collects both its core and
    its bias term, the casts outside the Function carry theirs back."""
    l = 23
    rng = np.random.default_rng(7 + l)
    x, A = _np(rng, 2, l, 25, 16), _np(rng, 3, 25, 25)
    W, b, probe = _np(rng, 3, 16, 24, scale=0.3), _np(rng, 3, 24), _np(rng, 2, l, 25, 24)

    def j_loss(x, A, W, b):
        return jnp.sum(j_pgcn.partitioned_gcn_pallas(x, A, W, b) * probe)

    ref = jax.grad(j_loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (x, A, W, b)))
    ts = [_t(a, True) for a in (x, A, W, b)]
    loss = (graph_conv.partitioned_gcn(*ts) * _t(probe)).sum()
    for got, r_ in zip(torch.autograd.grad(loss, ts), ref):
        _close(got, r_)


@pytest.mark.parametrize("n,l,v,c,gamma,stride", [
    (2, 30, 7, 8, 9, 1), (2, 257, 5, 8, 9, 2), (1, 7, 3, 4, 9, 2)])
def test_window_sum_grad_matches_jax_vjp(n, l, v, c, gamma, stride):
    rng = np.random.default_rng(l)
    x, g = _np(rng, n, l, v, c), _np(rng, n, l, v, c)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda t: causal_accumulate_pallas(t, gamma, stride),
                         jnp.asarray(x))
        (ref,) = vjp(jnp.asarray(g))
    xt = _t(x, True)
    y = window_sum(xt, gamma, stride)
    assert type(y.grad_fn).__name__ == "_WindowSumBackward"
    (got,) = torch.autograd.grad(y, xt, _t(g))
    _close(got, ref)


def test_window_sum_single_tap_is_identity_with_identity_grad():
    x = torch.randn(1, 6, 3, 4, requires_grad=True)
    y = window_sum(x, 9, 9)
    assert y is x
    g = torch.randn(1, 6, 3, 4)
    (gx,) = torch.autograd.grad((y * g).sum(), x)
    torch.testing.assert_close(gx, g)


@pytest.mark.parametrize("n,l,v,p,cin,cout,gamma,stride", RT_CASES)
def test_rt_fused_grads_match_jax_vjp(interpret, n, l, v, p, cin, cout, gamma, stride):
    """Grads to x, A, W and b of the fused layer core, through the Function
    and the bias einsum outside it."""
    rng = np.random.default_rng(l * cout)
    x, A = _np(rng, n, l, v, cin), _np(rng, p, v, v)
    W, b, g = _np(rng, p, cin, cout, scale=0.3), _np(rng, p, cout), _np(rng, n, l, v, cout)
    _, vjp = jax.vjp(lambda *a: j_rtf.rt_fused_gcn_acc(*a, gamma, stride),
                     *(jnp.asarray(a) for a in (x, A, W, b)))
    ref = vjp(jnp.asarray(g))
    ts = [_t(a, True) for a in (x, A, W, b)]
    y = rt_fused.rt_fused_gcn_acc(*ts, gamma, stride)
    assert type(y.grad_fn).__name__ == "_RtCoreBackward"
    for got, r_ in zip(torch.autograd.grad(y, ts, _t(g)), ref):
        _close(got, r_)


@pytest.mark.parametrize("n,l,v,p,cin,cout,gamma,stride", RT_CASES)
def test_rt_fused_bwd_plain_matches_pallas(interpret, n, l, v, p, cin, cout, gamma, stride):
    """The backward kernel's plain version against the JAX kernel's call:
    (gx, gA, gW, gbe) for one upstream gradient."""
    rng = np.random.default_rng(3 + l)
    x, g, A = _np(rng, n, l, v, cin), _np(rng, n, l, v, cout), _np(rng, p, v, v)
    W = _np(rng, p, cin, cout, scale=0.3)
    ref = j_rtf._bwd_call(*(jnp.asarray(a) for a in (x, g, A, W)), gamma, stride)
    got = rt_fused.rt_fused_bwd(_t(x), _t(g), _t(A), _t(W), gamma, stride)
    for a, r_ in zip(got, ref):
        _close(a, r_)
    gx, *_ = rt_fused.rt_fused_bwd(_t(x), _t(g), _t(A), _t(W), gamma, stride,
                                   need_gx=False)
    assert gx is None


def test_gx_skipped_where_x_needs_no_grad(monkeypatch):
    """Only the parameter grads run when x needs none: no gx core call."""
    import stgx_torch.ops.gcn_core as gcm

    calls = []
    real = gcm._core
    monkeypatch.setattr(gcm, "_core", lambda *a: calls.append(a) or real(*a))
    x = torch.randn(5, 7, 4)
    A, W = torch.randn(2, 7, 7, requires_grad=True), torch.randn(2, 4, 6, requires_grad=True)
    gcn_core(x, A, W).sum().backward()
    assert len(calls) == 1 and A.grad is not None and W.grad is not None
    x.requires_grad_(True)
    gcn_core(x, A, W).sum().backward()
    assert len(calls) == 3 and x.grad is not None


def test_grads_splits_fill_the_card():
    """Split counts fill the card in one round and never exceed the rows:
    gcn_grads' kernels (one block an SM; gW tiles 64 x 128 or 64 x 64, gA
    tiles 32 wide, three partitions a block) at most 132 blocks each.
    rt_fused_bwd runs the same kernels with the same splits, its gbe
    partials summed by the gW kernel's blocks of the first C_in tile."""
    assert gcn_grads_splits(8192, 3, 64, 64) == (132, 66)
    assert gcn_grads_splits(8192, 3, 128, 256) == (33, 33)
    assert gcn_grads_splits(8192, 3, 256, 256) == (16, 16)
    assert gcn_grads_splits(8192, 4, 256, 256) == (8, 8)
    assert gcn_grads_splits(8192, 3, 1024, 1024) == (1, 4)
    assert gcn_grads_splits(1, 3, 64, 64) == (1, 1)
    assert gcn_grads_splits(100, 3, 64, 64) == (100, 66)


def test_dropout_draws_from_the_generator():
    x = torch.ones(4, 6, 5, 8)
    a = dropout(x, 0.3, torch.Generator().manual_seed(5))
    b = dropout(x, 0.3, torch.Generator().manual_seed(5))
    c = dropout(x, 0.3, torch.Generator().manual_seed(6))
    torch.testing.assert_close(a, b)
    assert not torch.equal(a, c)
    kept = a != 0
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 0.7))
    assert 0.5 < kept.float().mean() < 0.9
    state = torch.random.get_rng_state()
    dropout(x, 0.3, torch.Generator().manual_seed(5))
    assert torch.equal(state, torch.random.get_rng_state())  # global RNG untouched
    assert dropout(x, 0.0, None) is x
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.3, None)


def test_rt_layer_dropout_only_in_training():
    layer = RtLayer(8, 8, 9, 3, 25, torch.Generator().manual_seed(0), dropout=0.5)
    x, A = torch.randn(1, 6, 25, 8), torch.rand(3, 25, 25)
    off = layer(x, A)
    torch.testing.assert_close(off, layer(x, A, train=False))
    on1 = layer(x, A, train=True, generator=torch.Generator().manual_seed(1))
    on2 = layer(x, A, train=True, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(on1, on2)
    assert not torch.equal(on1, off)
    zero = RtLayer(8, 8, 9, 3, 25, torch.Generator().manual_seed(0), dropout=0.0)
    torch.testing.assert_close(zero(x, A, train=True), zero(x, A))


def test_adam_step_is_optax_adam():
    """torch.optim.Adam(betas=(0.9, 0.999), eps=1e-8) is optax.adam's
    update: three steps on the same gradients, fp32 rounding apart."""
    rng = np.random.default_rng(0)
    p0 = {"w": _np(rng, 5, 4), "b": _np(rng, 4)}
    grads = [{k: _np(rng, *v.shape) for k, v in p0.items()} for _ in range(3)]
    tx = optax.adam(1e-3)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in p0.items()}
    opt = torch.optim.Adam(tp.values(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, v in g.items():
            tp[k].grad = torch.tensor(v)
        opt.step()
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
