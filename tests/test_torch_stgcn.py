"""The port's ST-GCN (``stgx_torch.models.stgcn``), the segment helpers,
the window MAC counter and the ``window`` Trainer on ST-GCN against the
JAX package on the CPU.

The JAX variables are made from a seed and moved off their init values,
carried into the port by ``from_jax_params`` and loaded strictly; both
sides then see the same numpy inputs. The JAX side runs its default
``einsum`` graph conv (``conftest.py`` pins the highest matmul precision);
on the CPU the port's graph conv runs ``gcn_core``'s plain version and its
autograd backward, the backward the card runs through ``gcn_grads``.

Size: 3 layers of 8/16 channels, Γ = 5, W = 12; layer 0 an identity
residual, layer 1 8 → 16 at stride 2 (the strided residual 1×1 conv),
layer 2 no residual.

Tolerances: outputs ``1e-5 · max(1, max|ref|)`` (fp32 sums in another
order through normalised layers; the worst measured is 4e-7); each
parameter's gradient ``1e-5 · max(1, max|ref|)``, except a bias that feeds
a batch norm, whose gradient is zero in exact arithmetic and is held to
zero on both sides within ``1e-5`` of the model's largest gradient; the
Trainer's gradients over five chunks ``1e-4`` (as the Shift-GCN window
test) and its losses and statistics ``rtol = 1e-5``; the segment helpers
and the counters exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stgx.data import SkeletonDirDataset as JDirDataset
from stgx.graph import Graph as JGraph
from stgx.graph import load_skeleton
from stgx.models import aagcn as j_aa
from stgx.models import msgcn as j_msgcn
from stgx.models import mstcn as j_mstcn
from stgx.models import stgcn as j_st
from stgx.parallel import segments as j_seg
from stgx.parallel.loop import OptimizerConfig as JOptimizerConfig
from stgx.parallel.loop import Trainer as JTrainer
from stgx.utils import LOSS as J_LOSS
from stgx.utils import flops as j_flops
from stgx_torch.data import SkeletonDirDataset, class_distribution, load_actions
from stgx_torch.data.synth import generate
from stgx_torch.models import AaGcn, MsGcn, MsTcn
from stgx_torch.models import stgcn as st
from stgx_torch.parallel import segments as seg
from stgx_torch.parallel.loop import OptimizerConfig, Trainer
from stgx_torch.utils import LOSS, flops
from stgx_torch.weights import _TCN_LAYER, _layer, from_jax_params, to_jax_params

V = 25
GRAPH = load_skeleton("pku-mmd")
SMALL = dict(num_classes=5, in_feat=3, graph=GRAPH, kernel=5, in_ch=(8, 8, 16),
             out_ch=(8, 16, 16), stride=(1, 2, 1), residual=(1, 1, 0), dropout=(0.0,) * 3)
W_FIELD = 12
SEGMENT = 16
BUCKET = 16
TOL = 1e-5


def _perturbed(params, seed):
    """Every leaf moved off its init value (edge importance too)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=np.shape(a)).astype(np.float32), params)


def _close(got, ref, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


def _inputs(n=3, length=W_FIELD, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, length, V, 3)).astype(np.float32)
    mask = np.ones((n, length), np.float32)
    mask[1, length - 3:] = 0.0  # a window with padding frames
    return x, mask


def _model_pair(normalization, seed=0, **over):
    kw = dict(SMALL, normalization=normalization, **over)
    jm = j_st.Stgcn(**kw)
    x, _ = _inputs()
    params = _perturbed(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x)), seed)
    tm = st.Stgcn(**kw, device="cpu")
    tm.load_state_dict(from_jax_params(params, tm), strict=True)
    return jm, params, tm


def _feeds_batch_norm(pname):
    """A per-channel bias added just before a batch norm (the residual 1×1
    conv's and the temporal conv's): the norm subtracts it again, so its
    gradient is zero in exact arithmetic."""
    return pname.endswith(("res_bias", "tcn_bias"))


def assert_grads_close(tm, jax_grads, normalization, tol=TOL, feeds=_feeds_batch_norm):
    """Each parameter's ``.grad`` against the JAX gradient tree."""
    ref = from_jax_params(jax.tree.map(np.asarray, jax_grads), tm)
    scale = max(np.abs(r.numpy()).max() for r in ref.values())
    for pname, p in tm.named_parameters():
        r = ref[pname].numpy()
        if normalization == "BatchNorm" and feeds(pname):
            assert max(np.abs(p.grad.numpy()).max(), np.abs(r).max()) <= 1e-5 * scale, pname
            continue
        err = np.abs(p.grad.numpy() - r).max()
        assert err <= tol * max(1.0, np.abs(r).max()), (pname, err)


# -- the layer and the model -------------------------------------------------------


LAYER_FORMS = {"identity": (8, 8, 1, True), "conv": (8, 16, 2, True), "zero": (8, 16, 2, False)}


@pytest.mark.parametrize("normalization", ["BatchNorm", "LayerNorm"])
@pytest.mark.parametrize("form", sorted(LAYER_FORMS))
def test_layer_matches_jax(form, normalization):
    """Every residual form (identity; a strided 1×1 conv with its norm,
    which sees the decimated mask; none) under both norms, with a mask."""
    cin, cout, stride, residual = LAYER_FORMS[form]
    x, mask = _inputs()
    x = np.random.default_rng(1).normal(size=(3, W_FIELD, V, cin)).astype(np.float32)
    A = np.asarray(JGraph(strategy="spatial", **GRAPH).A, np.float32)
    jl = j_st.StgcnLayer(cin, cout, 5, 3, V, stride=stride, residual=residual,
                         normalization=normalization)
    params = _perturbed(jl.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(A),
                                mask=jnp.asarray(mask)), 2)
    tl = st.StgcnLayer(cin, cout, 5, 3, V, torch.Generator().manual_seed(0), stride=stride,
                       residual=residual, normalization=normalization)
    sd = {}
    _layer(params["params"], lambda k, v: sd.__setitem__(k, torch.tensor(v)), "", *_TCN_LAYER)
    tl.load_state_dict(sd, strict=True)
    ref = jl.apply(params, jnp.asarray(x), jnp.asarray(A), mask=jnp.asarray(mask))
    with torch.no_grad():
        got = tl(torch.tensor(x), torch.tensor(A), mask=torch.tensor(mask))
    assert got.shape == (3, -(-W_FIELD // stride), V, cout)
    _close(got, ref)


@pytest.mark.parametrize("normalization", ["BatchNorm", "LayerNorm"])
def test_forward_and_gradients_match_jax_vjp(normalization):
    """The window logits with a mask, and the gradients of ``<out, g>`` for
    a fixed cotangent g with respect to every parameter and the input,
    against ``jax.vjp``."""
    jm, params, tm = _model_pair(normalization)
    x, mask = _inputs()
    g = np.random.default_rng(3).normal(size=(3, 5)).astype(np.float32)
    ref, vjp = jax.vjp(lambda p, xx: jm.apply(p, xx, mask=jnp.asarray(mask)),
                       jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    out = tm(xt, mask=torch.tensor(mask))
    _close(out, ref)
    (out * torch.tensor(g)).sum().backward()
    assert_grads_close(tm, gp, normalization)
    _close(xt.grad, gx)


@pytest.mark.parametrize("normalization", ["BatchNorm", "LayerNorm"])
def test_weights_round_trip_with_flax_norm_names(normalization):
    jm, params, tm = _model_pair(normalization)
    back = to_jax_params(tm)
    assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(np.asarray, params))
    for got, ref in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(got, np.asarray(ref))
    lp = params["params"]["layers_1"]  # the residual 1×1 conv: its norm is _0
    assert torch.equal(tm.layers[1].res_norm.scale,
                       torch.tensor(np.asarray(lp[f"{normalization}_0"]["scale"])))
    assert torch.equal(tm.layers[1].tcn_norm.bias,
                       torch.tensor(np.asarray(lp[f"{normalization}_2"]["bias"])))
    with pytest.raises(ValueError, match="unexpected"):
        bad = jax.tree.map(np.asarray, params)
        bad["params"]["layers_2"]["stray"] = np.zeros(3, np.float32)
        from_jax_params(bad, tm)


def test_remat_gradients_equal_the_stored_ones():
    """``remat`` with dropout drawn from an explicit generator: the same
    gradients, bit for bit, and the generator left where the stored path
    leaves it."""
    x, mask = _inputs()
    grads, states = {}, {}
    for remat in (False, True):
        tm = st.Stgcn(**dict(SMALL, dropout=(0.5, 0.3, 0.2)), remat=remat, device="cpu",
                      generator=torch.Generator().manual_seed(0))
        gen = torch.Generator().manual_seed(2)
        out = tm(torch.tensor(x), mask=torch.tensor(mask), train=True, generator=gen)
        (out ** 2).sum().backward()
        grads[remat] = {k: p.grad.clone() for k, p in tm.named_parameters()}
        states[remat] = gen.get_state()
    for k in grads[False]:
        assert torch.equal(grads[True][k], grads[False][k]), k
    assert torch.equal(states[True], states[False])


def test_dropout_keeps_its_rate_and_scale():
    """Dropout's mask statistics: about ``1 − rate`` of the elements kept,
    scaled by ``1 / (1 − rate)``, the rest zero; the same generator state
    gives the same mask."""
    x = torch.ones(200_000)
    y = st.dropout(x, 0.3, torch.Generator().manual_seed(5))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 5e-3  # ~7 sigma of a binomial
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert torch.equal(y, st.dropout(x, 0.3, torch.Generator().manual_seed(5)))
    with pytest.raises(ValueError, match="Generator"):
        st.dropout(x, 0.3, None)


# -- segments -----------------------------------------------------------------------


@pytest.mark.parametrize("length,segment,overlap", [(30, 10, 3), (10, 10, 3), (5, 8, 2),
                                                    (31, 9, 4)])
def test_segments_match_jax(length, segment, overlap):
    pad = seg.segment_padding(length, segment, overlap)
    assert pad == j_seg.segment_padding(length, segment, overlap)
    x = np.random.default_rng(0).normal(size=(1, length + pad, 4, 2)).astype(np.float32)
    chunks = seg.segment_overlapping(torch.tensor(x), segment, overlap)
    np.testing.assert_array_equal(
        chunks.numpy(), np.asarray(j_seg.segment_overlapping(jnp.asarray(x), segment, overlap)))
    preds = np.random.default_rng(1).normal(size=(chunks.shape[0], segment, 3)).astype(np.float32)
    got = seg.fold_segments(torch.tensor(preds), length, overlap)
    ref = j_seg.fold_segments(jnp.asarray(preds), length, overlap)
    assert got.shape == (1, length, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# -- counters -----------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, dict(window=12, kernel=5, stride=(1, 2, 2, 1, 1, 2, 1, 1, 1)),
                                dict(window=50, residual=(0,) * 9, num_classes=60)])
def test_window_macs_match_jax(kw):
    assert flops.stgcn_macs_per_window(**kw) == j_flops.stgcn_macs_per_window(**kw)
    if not kw:
        assert flops.stgcn_macs_per_window() == 1_399_776_512  # 1.40 GMAC a window


def test_param_words_match_jax():
    """The parameter count of each window family, as the JAX function
    counts the flax tree."""
    x = np.zeros((4, W_FIELD, V, 3), np.float32)
    ms = dict(stages=2, filters=(8, 8), layers=(2, 2))
    for jm, tm in (
        (j_st.Stgcn(**SMALL), st.Stgcn(**SMALL, device="cpu")),
        (j_aa.AaGcn(**SMALL), AaGcn(**SMALL, device="cpu")),
        (j_mstcn.MsTcn(num_classes=5, in_feat=3, kernel=(3, 3), dropout=(0, 0), **ms),
         MsTcn(5, 3, kernel=(3, 3), dropout=(0, 0), device="cpu", **ms)),
        (j_msgcn.MsGcn(**SMALL, refine_kernel=(3, 3), refine_dropout=(0, 0), **ms),
         MsGcn(**SMALL, refine_kernel=(3, 3), refine_dropout=(0, 0), device="cpu", **ms)),
    ):
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
        assert flops.param_words(tm) == j_flops.param_words(shapes), type(tm).__name__


# -- the window Trainer -------------------------------------------------------------


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("synth_stgcn"))
    # trials of 17-40 frames in buckets of 16: 2 or 3 chunks each, the last
    # one masked past the trial's end and never all padding
    info = generate(d, skeleton="pku-mmd", num_classes=5, in_feat=3, num_train=3,
                    num_val=1, min_len=17, max_len=40, seed=7)
    split = [os.path.join(d, "train", s) for s in ("features", "labels")]
    val = [os.path.join(d, "val", s) for s in ("features", "labels")]
    ds = SkeletonDirDataset(*split)
    ncls = len(load_actions(info["actions"]))
    return (ds, SkeletonDirDataset(*val), JDirDataset(*split), JDirDataset(*val),
            class_distribution(ds, ncls), ncls)


def test_window_epoch_and_evaluate_match_the_jax_trainer(synth, monkeypatch):
    """n = 3 trials, batch_size 2 (divisors 2, 2, 1), each windowed (W = 12)
    and cut into chunks of 16 windows. The first Adam step's accumulated
    gradients agree to 1e-4 of max(1, max|ref|) (five chunks of
    batch-normalised windows summed in another order), every chunk's loss
    through the epoch and the epoch's statistics to rtol 1e-5, the
    parameters after the epoch within 2·lr per Adam step (under BatchNorm
    the biases that feed a norm have rounding-noise gradients, which Adam
    scales up to steps of lr); ``evaluate`` gives JAX's losses, top-k and
    per-frame predictions."""
    ds, val, jds, jval, dist, ncls = synth
    lr = 2e-3
    arch = dict(SMALL, num_classes=ncls, normalization="BatchNorm")
    kw = dict(receptive_field=W_FIELD, segment=SEGMENT, bucket=BUCKET)
    jt = JTrainer(model=j_st.Stgcn(**arch), kind="window", loss=J_LOSS["st-gcn"](dist),
                  opt=JOptimizerConfig(learning_rate=lr, batch_size=2), **kw)
    params, _ = jt.init(np.zeros((4, W_FIELD, V, 3), np.float32))
    params = jax.tree.map(jnp.asarray, _perturbed(params, 7))
    opt_state = jt.tx.init(params)
    tm = st.Stgcn(**arch, device="cpu")
    tm.load_state_dict(from_jax_params(params, tm), strict=True)
    tt = Trainer(model=tm, kind="window", loss=LOSS["st-gcn"](dist),
                 opt=OptimizerConfig(learning_rate=lr, batch_size=2), **kw)
    assert [len(tt.chunks(*tt.prepare(*ds[i]))) for i in range(len(ds))] == [2, 3, 2]

    accum = None
    for i in range(2):
        jx, jy, jmask = jt._prepare(*jds[i])
        chunks = jt._window_chunks(jx, jy, jmask)
        for cx, cy, cm in chunks:
            grads = jt._grad_step(cx.shape)(params, cx, cy, cm, 2.0 * len(chunks),
                                            jax.random.PRNGKey(i), jnp.asarray(0.0))[0]
            accum = grads if accum is None else jax.tree.map(jnp.add, accum, grads)
        for cx, cy, cm in tt.chunks(*tt.prepare(*ds[i])):
            tt.grad_step(cx, cy, cm, 2.0 * len(chunks))
    assert_grads_close(tt.model, accum, "BatchNorm", tol=1e-4)
    tt.optimizer.zero_grad(set_to_none=True)

    j_rec, t_rec = _Record(), _Record()
    j_ev = jt.evaluate(params, jval, metrics=[j_rec])
    t_ev = tt.evaluate(val, metrics=[t_rec])
    for key in ("ce", "mse", "top1", "top5"):
        np.testing.assert_allclose(t_ev[key], j_ev[key], rtol=1e-5, err_msg=key)
    assert t_rec.seen == j_rec.seen

    j_losses, t_losses = spy_losses(jt, tt, monkeypatch)
    p1, _, j_stats = jt.train_epoch(params, opt_state, jds, 0)
    t_stats = tt.train_epoch(ds, 0)
    assert len(t_losses) == len(j_losses) == 7
    assert [d for *_, d in t_losses] == [d for *_, d in j_losses]
    np.testing.assert_allclose([l[:2] for l in t_losses], [l[:2] for l in j_losses],
                               rtol=1e-5, atol=1e-6)
    for key in ("ce", "mse", "top1", "top5"):
        np.testing.assert_allclose(t_stats[key], j_stats[key], rtol=1e-5, err_msg=key)
    ref = from_jax_params(jax.tree.map(np.asarray, p1), tt.model)
    for name, p in tt.model.state_dict().items():
        assert np.abs(p.numpy() - ref[name].numpy()).max() <= 2 * lr * 2, name


class _Record:
    """A segmental metric that keeps each trial's (labels, predictions)."""

    def __init__(self):
        self.seen = []

    def init_metric(self, n):
        self.seen.append(n)

    def __call__(self, labels, pred):
        self.seen.append((np.asarray(labels).tolist(), np.asarray(pred).tolist()))

    def reduce(self):
        self.seen.append("reduce")


def spy_losses(jt, tt, monkeypatch, batched=False):
    """Record each grad step's (ce, mse, divisor) on both Trainers."""
    j_losses, t_losses = [], []
    j_name = "_grad_step_batched" if batched else "_grad_step"
    j_make = getattr(jt, j_name)

    def j_spy(shape_key):
        fn = j_make(shape_key)

        def run(*a):
            out = fn(*a)
            j_losses.append((float(out[1]), float(out[2]), np.asarray(a[4]).tolist()))
            return out
        return run

    monkeypatch.setattr(jt, j_name, j_spy)
    t_step = tt.grad_step

    def t_spy(*a, **k):
        out = t_step(*a, **k)
        t_losses.append((float(out[0]), float(out[1]), a[3]))
        return out

    monkeypatch.setattr(tt, "grad_step", t_spy)
    return j_losses, t_losses
