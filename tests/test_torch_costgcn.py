"""The port's CoST-GCN (``stgx_torch.models.costgcn``) and its temporal
conv (``stgx_torch.ops.temporal.temporal_conv``) against the JAX package on
the CPU, and its training through the ``frame`` ``Trainer``.

The JAX variables are made from a seed and perturbed so that no leaf keeps
its init value (edge importance as ``tests/test_costgcn_equiv.py`` perturbs
it, then every leaf by 0.1·N(0, 1)), carried into the port by
``from_jax_params`` and loaded strictly; both packages then see the same
numpy inputs. On the CPU the port's graph conv runs its plain version and
the temporal conv ``F.conv2d``; one case runs the JAX side on its Pallas
graph-conv kernel in interpret mode.

Tolerances:
* ``temporal_conv`` and its gradients, on each route (the taps, and
  ``F.conv2d``, which the card takes for bf16 without dilation):
  ``1e-5 · max(1, max|ref|)`` (one fp32 dot of Γ·C_in terms, summed in
  another order);
* a whole model, forward, stream or gradients: ``1e-4 · max(1, max|ref|)``
  (fp32 sums in another order, through normalised layers);
* stream ≡ batch under LayerNorm: ``1e-4``, the JAX test's own bound;
* a ``Trainer`` epoch: the first Adam step's accumulated gradients
  ``1e-5 · max(1, max|ref|)`` and per-step losses ``rtol 1e-5``, as
  ``tests/test_torch_train.py`` holds RT-ST-GCN's; parameters after the
  epoch within a hundredth of the ``2·lr`` an Adam step can move one, per
  step. (RT-ST-GCN's test asks a thousandth. Here some temporal-conv
  weights have gradients of 1e-8, the size of Adam's eps, where Adam's
  step turns the last fp32 bits of the gradient into a share of lr: 2.7e-5
  of a bound of 8e-3 on the CPU.)
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stgx.data import SkeletonDirDataset as JDirDataset
from stgx.graph import load_skeleton
from stgx.models.costgcn import CoStgcn as JCoStgcn
from stgx.models.costgcn import stream_sequence as j_stream_sequence
from stgx.ops import graph_conv as j_graph_conv
from stgx.ops import pallas_gcn as j_pallas_gcn
from stgx.ops.temporal import temporal_conv as j_temporal_conv
from stgx.parallel.loop import OptimizerConfig as JOptimizerConfig
from stgx.parallel.loop import Trainer as JTrainer
from stgx.utils import LOSS as J_LOSS
from stgx_torch.data import SkeletonDirDataset, class_distribution, load_actions
from stgx_torch.data.synth import generate
from stgx_torch.models.costgcn import (
    CoStgcn,
    init_stream_state,
    stream_sequence,
    stream_step,
)
from stgx_torch.ops import temporal
from stgx_torch.ops.temporal import temporal_conv
from stgx_torch.parallel.loop import OptimizerConfig, Trainer
from stgx_torch.parallel.segments import pad_to_bucket
from stgx_torch.utils import LOSS
from stgx_torch.weights import from_jax_params

# tests/test_costgcn_equiv.py's model: 3 layers, 8/16 channels, Γ = 5,
# dilation (1, 2, 2); layer 1 has the residual 1×1 conv (8 → 16)
CFG = dict(num_classes=5, in_feat=6, graph=load_skeleton("imu_fogit_ABCD"), kernel=5,
           in_ch=(8, 8, 16), out_ch=(8, 16, 16), dilation=(1, 2, 2), residual=(1, 1, 1),
           dropout=(0.0, 0.0, 0.0), importance=True)


def _perturbed(params, seed):
    """Edge importance as the JAX test moves it, then every leaf off its
    init value."""
    p = jax.tree.map(np.asarray, params)
    ei = p["params"]["edge_importance"]
    p["params"]["edge_importance"] = ei + 0.05 * np.sin(
        np.arange(ei.size, dtype=np.float32).reshape(ei.shape))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: a + 0.1 * rng.normal(size=np.shape(a)).astype(np.float32), p)


def _pair(normalization="LayerNorm", l=40, n=2, seed=0, **over):
    cfg = dict(CFG, normalization=normalization, **over)
    jm = JCoStgcn(**cfg)
    x = np.random.default_rng(5 + seed).normal(size=(n, l, 7, 6)).astype(np.float32)
    params = _perturbed(jm.init(jax.random.PRNGKey(11 + seed), jnp.asarray(x)), seed)
    tm = CoStgcn(**cfg, device="cpu")
    tm.load_state_dict(from_jax_params(params, tm), strict=True)
    return jm, params, tm, x


def _close(got, ref, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


# -- temporal_conv --------------------------------------------------------------


@pytest.fixture(params=["taps", "cudnn"])
def route(request, monkeypatch):
    """Each route of ``temporal_conv``; the cuDNN one, which the card takes
    for bf16 without dilation, runs ``F.conv2d`` on the CPU here."""
    monkeypatch.setattr(temporal, "conv_route", lambda *a: request.param)
    return request.param


def test_conv_route_rule():
    """cuDNN for 16-bit types on the card up to a dilated span of 17 frames
    (CoST-GCN9's layers), the taps elsewhere (CoST-GCN at Gamma = 69)."""
    for args in (("cuda", torch.bfloat16, 9, 1), ("cuda", torch.bfloat16, 9, 2),
                 ("cuda", torch.float16, 17, 1)):
        assert temporal.conv_route(*args) == "cudnn", args
    for args in (("cuda", torch.bfloat16, 9, 4), ("cuda", torch.bfloat16, 33, 1),
                 ("cuda", torch.bfloat16, 69, 1), ("cuda", torch.float32, 9, 1),
                 ("cpu", torch.bfloat16, 9, 1), ("cuda", torch.float64, 9, 1)):
        assert temporal.conv_route(*args) == "taps", args


@pytest.mark.parametrize("stride,dilation", [(1, 1), (2, 1), (1, 3), (2, 2)])
@pytest.mark.parametrize("padding", ["same", "causal", "valid", 2])
def test_temporal_conv_matches_jax(route, padding, stride, dilation):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 23, 7, 6)).astype(np.float32)
    W = rng.normal(size=(5, 6, 8)).astype(np.float32)
    b = rng.normal(size=(8,)).astype(np.float32)
    ref = j_temporal_conv(jnp.asarray(x), jnp.asarray(W), jnp.asarray(b), stride=stride,
                          dilation=dilation, padding=padding)
    got = temporal_conv(torch.tensor(x), torch.tensor(W), torch.tensor(b), stride=stride,
                        dilation=dilation, padding=padding)
    assert got.is_contiguous()
    _close(got, ref, 1e-5)


@pytest.mark.parametrize("padding,stride,dilation", [
    ("causal", 1, 2), ("same", 2, 1), ("valid", 1, 3), (3, 2, 2)])
def test_temporal_conv_gradients_match_jax(route, padding, stride, dilation):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 19, 7, 4)).astype(np.float32)
    W = rng.normal(size=(4, 4, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    y, vjp = jax.vjp(lambda x, W, b: j_temporal_conv(x, W, b, stride=stride, dilation=dilation,
                                                     padding=padding),
                     jnp.asarray(x), jnp.asarray(W), jnp.asarray(b))
    g = rng.normal(size=y.shape).astype(np.float32)
    refs = vjp(jnp.asarray(g))
    ts = [torch.tensor(a, requires_grad=True) for a in (x, W, b)]
    out = temporal_conv(*ts, stride=stride, dilation=dilation, padding=padding)
    out.backward(torch.tensor(g))
    for t, r in zip(ts, refs):
        _close(t.grad, r, 1e-5)


# -- the model ---------------------------------------------------------------------


@pytest.mark.parametrize("residual", [(1, 1, 1), (0, 1, 0)])
@pytest.mark.parametrize("normalization", ["LayerNorm", "BatchNorm"])
def test_forward_matches_jax(normalization, residual):
    """(1, 1, 1): the identity residual, then the 1×1 conv, then the
    identity; (0, 1, 0): no residual around layers 0 and 2."""
    jm, params, tm, x = _pair(normalization, residual=residual)
    with torch.no_grad():
        got = tm(torch.tensor(x))
    assert got.shape == (2, 40, 5)
    _close(got, jm.apply(params, jnp.asarray(x)), 1e-4)


def test_forward_matches_jax_on_its_pallas_gcn_kernel(monkeypatch):
    monkeypatch.setattr(j_pallas_gcn, "_INTERPRET", True)
    jm, params, tm, x = _pair(l=24)
    j_graph_conv.set_gcn_impl("pallas")
    try:
        ref = jm.apply(params, jnp.asarray(x))
    finally:
        j_graph_conv.set_gcn_impl("einsum")
    with torch.no_grad():
        _close(tm(torch.tensor(x)), ref, 1e-4)


@pytest.mark.parametrize("normalization", ["LayerNorm", "BatchNorm"])
def test_loss_gradients_match_jax(normalization):
    """Every parameter's gradient of a masked per-frame loss, through the
    graph conv's autograd Function (gcn_grads' plain version on the CPU)
    and the temporal conv's backward."""
    jm, params, tm, x = _pair(normalization, l=24)
    rng = np.random.default_rng(3)
    w = rng.normal(size=(2, 24, 5)).astype(np.float32)
    mask = (rng.random((2, 24)) > 0.2).astype(np.float32)

    def loss(p):
        return (jm.apply(p, jnp.asarray(x), mask=jnp.asarray(mask)) * w).sum()

    ref = from_jax_params(jax.tree.map(np.asarray, jax.grad(loss)(params)), tm)
    (tm(torch.tensor(x), mask=torch.tensor(mask)) * torch.tensor(w)).sum().backward()
    for name, p in tm.named_parameters():
        _close(p.grad, ref[name], 1e-4)


# -- the streaming cell -------------------------------------------------------------


@pytest.mark.parametrize("normalization", ["LayerNorm", "BatchNorm"])
def test_stream_sequence_matches_jax(normalization):
    jm, params, tm, x = _pair(normalization, l=18, n=3)
    ref, ref_state = j_stream_sequence(jm, params, jnp.asarray(x))
    got, state = stream_sequence(tm, torch.tensor(x))
    _close(got, ref, 1e-4)
    for s, r in zip(state, ref_state):
        _close(s["fifo"], r["fifo"], 1e-4)
        _close(s["res_fifo"], r["res_fifo"], 1e-4)


def test_stream_equals_batch_under_layernorm():
    _, _, tm, x = _pair()
    with torch.no_grad():
        batch = tm(torch.tensor(x))
    stream, _ = stream_sequence(tm, torch.tensor(x))
    _close(stream, batch, 1e-4)


def test_stream_state_carries_across_chunks():
    _, _, tm, x = _pair()
    full, _ = stream_sequence(tm, torch.tensor(x))
    state = init_stream_state(tm, batch=2)
    first, state = stream_sequence(tm, torch.tensor(x[:, :17]), state)
    second, _ = stream_sequence(tm, torch.tensor(x[:, 17:]), state)
    _close(torch.cat([first, second], dim=1), full, 1e-4)


def test_stream_state_depths():
    _, _, tm, _ = _pair()
    state = init_stream_state(tm, batch=3)
    # main FIFO (Γ−1)·d + 1, residual FIFO Γ//2
    assert [tuple(s["fifo"].shape) for s in state] == [(5, 3, 7, 8), (9, 3, 7, 16),
                                                       (9, 3, 7, 16)]
    assert all(tuple(s["res_fifo"].shape[:2]) == (2, 3) for s in state)
    logits, new = stream_step(tm, state, torch.zeros(3, 7, 6))
    assert logits.shape == (3, 5) and len(new) == 3


def test_batch_form_is_causal():
    """tests/test_costgcn_equiv.py's probe: a non-uniform perturbation at
    frame 25 leaves the frames before it unchanged and shows at and after
    it."""
    _, _, tm, x = _pair()
    x2 = x.copy()
    x2[:, 25, 3, 1] += 10.0
    with torch.no_grad():
        y1, y2 = tm(torch.tensor(x)).numpy(), tm(torch.tensor(x2)).numpy()
    np.testing.assert_allclose(y1[:, :25], y2[:, :25], atol=1e-5)
    assert np.abs(y1[:, 25:] - y2[:, 25:]).max() > 1e-3


# -- training ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("synth"))
    # 30-64 frames: one length bucket of 64, trials of several lengths
    info = generate(d, num_train=6, num_val=0, min_len=30, max_len=64, seed=3)
    split = [os.path.join(d, "train", s) for s in ("features", "labels")]
    ds = SkeletonDirDataset(*split)
    ncls = len(load_actions(info["actions"]))
    return ds, JDirDataset(*split), class_distribution(ds, ncls), ncls


@pytest.mark.parametrize("trial_batch", [1, 2])
def test_one_epoch_matches_the_jax_trainer(synth, monkeypatch, trial_batch):
    """n = 6 trials, batch_size 4: divisors 4,4,4,4,2,2, Adam steps after
    trials 4 and 6; the frame kind with its length mask."""
    ds, jds, dist, ncls = synth
    lr = 2e-3
    arch = dict(CFG, num_classes=ncls, normalization="LayerNorm", kernel=3,
                dilation=(1, 2, 2))
    jt = JTrainer(model=JCoStgcn(**arch), kind="frame", loss=J_LOSS["co-st-gcn"](dist),
                  opt=JOptimizerConfig(learning_rate=lr, batch_size=4), bucket=64,
                  trial_batch=trial_batch)
    params, opt_state = jt.init(jds[0][0][None])
    tm = CoStgcn(**arch, device="cpu")
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params), tm), strict=True)
    tt = Trainer(model=tm, kind="frame", loss=LOSS["co-st-gcn"](dist),
                 opt=OptimizerConfig(learning_rate=lr, batch_size=4), bucket=64,
                 trial_batch=trial_batch)

    # the first optimizer step's accumulated gradients (trials 0..3)
    j_name = "_grad_step_batched" if trial_batch > 1 else "_grad_step"
    j_make = getattr(jt, j_name)
    accum = None
    for i in range(4):
        xd, yd, md = jt._prepare(*jds[i])
        div = jnp.asarray([4.0]) if trial_batch > 1 else 4.0
        grads = j_make(xd.shape)(params, xd, yd, md, div, jax.random.PRNGKey(i),
                                 jnp.asarray(0.0))[0]
        accum = grads if accum is None else jax.tree.map(jnp.add, accum, grads)
        x, y, m = tt.stack_trials(*([a] for a in pad_to_bucket(*ds[i], 64)))
        tt.grad_step(x, y, m, [4.0] if trial_batch > 1 else 4.0)
    ref = from_jax_params(jax.tree.map(np.asarray, accum), tt.model)
    for name, p in tt.model.named_parameters():
        _close(p.grad, ref[name], 1e-5)
    tt.optimizer.zero_grad(set_to_none=True)

    j_losses, t_losses = [], []

    def j_spy(shape_key):
        fn = j_make(shape_key)

        def run(*a):
            out = fn(*a)
            j_losses.append((float(out[1]), float(out[2])))
            return out
        return run

    monkeypatch.setattr(jt, j_name, j_spy)
    t_step = tt.grad_step

    def t_spy(*a, **k):
        out = t_step(*a, **k)
        t_losses.append((float(out[0]), float(out[1])))
        return out

    monkeypatch.setattr(tt, "grad_step", t_spy)
    p1, _, j_stats = jt.train_epoch(params, opt_state, jds, 0)
    t_stats = tt.train_epoch(ds, 0)
    assert len(t_losses) == len(j_losses) >= (6 if trial_batch == 1 else 3)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5, atol=1e-6)
    for key in ("ce", "mse", "top1", "top5"):
        np.testing.assert_allclose(t_stats[key], j_stats[key], rtol=1e-5)
    bound = 2 * lr * 2  # two Adam steps
    ref = from_jax_params(jax.tree.map(np.asarray, p1), tt.model)
    for name, p in tt.model.state_dict().items():
        assert np.abs(p.numpy() - ref[name].numpy()).max() <= 1e-2 * bound, name


def test_bf16_step_runs_and_keeps_fp32_parameters(synth):
    ds, _, dist, ncls = synth
    tm = CoStgcn(**dict(CFG, num_classes=ncls, normalization="LayerNorm"), device="cpu")
    tt = Trainer(model=tm, kind="frame", loss=LOSS["co-st-gcn"](dist),
                 opt=OptimizerConfig(batch_size=1), bucket=64, compute_dtype="bfloat16")
    x, y, m = tt.stack_trials(*([a] for a in pad_to_bucket(*ds[0], 64)))
    ce = tt.grad_step(x, y, m, 1.0)[0]
    assert np.isfinite(float(ce))
    for name, p in tm.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, name
        assert bool(torch.isfinite(p.grad).all()), name


@pytest.mark.parametrize("normalization", ["LayerNorm", "BatchNorm"])
def test_remat_gradients_equal_the_stored_ones(normalization):
    """``remat`` with dropout drawn from an explicit generator: the same
    gradients, bit for bit, and the generator left where the stored path
    leaves it."""
    x = np.random.default_rng(4).normal(size=(2, 20, 7, 6)).astype(np.float32)
    grads, states = {}, {}
    for remat in (False, True):
        tm = CoStgcn(**dict(CFG, dropout=(0.5, 0.3, 0.2), normalization=normalization),
                     remat=remat, device="cpu", generator=torch.Generator().manual_seed(0))
        gen = torch.Generator().manual_seed(2)
        out = tm(torch.tensor(x), mask=torch.ones(2, 20), train=True, generator=gen)
        (out ** 2).sum().backward()
        grads[remat] = {k: p.grad.clone() for k, p in tm.named_parameters()}
        states[remat] = gen.get_state()
    for k in grads[False]:
        assert torch.equal(grads[True][k], grads[False][k]), k
    assert torch.equal(states[True], states[False])
