"""The port's multi-stage segmenters (``stgx_torch.models.mstcn``,
``stgx_torch.models.msgcn``) and the ``frame_ms`` / ``window_ms`` Trainer
kinds against the JAX package on the CPU.

The JAX variables are made from a seed and moved off their init values,
carried into the port by ``from_jax_params`` and loaded strictly; dropout
is 0 wherever the two packages are compared (JAX's dropout stream cannot be
drawn in torch; the port's dropout is tested by its mask statistics and
its replay under ``remat`` in ``tests/test_torch_stgcn.py``).

Sizes: MS-TCN of 3 stages, 8 filters, 6/2/2 layers (the generator's
dilations reach 32, past a 12-frame input: the padding by the dilation
reaches past the trial on both sides); MS-GCN's generator the 3-layer
ST-GCN of ``tests/test_torch_stgcn.py`` (W = 12), 2 refinement stages of
2 layers (one in the Trainer epoch).

Tolerances: outputs ``1e-5 · max(1, max|ref|)`` (fp32 sums in another
order; the softmax refinement passes them on); the Trainers' first Adam
step's accumulated gradients ``1e-4 · max(1, max|ref|)`` (the losses of
every stage summed, over several steps, in another order), each step's
losses and the epoch's statistics ``rtol = 1e-5``, the parameters after the
epoch within 2·lr per Adam step (Adam's first steps are of size lr
whatever the gradient's size, so a gradient that is rounding noise on both
sides may step either way).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stgx.data import SkeletonDirDataset as JDirDataset
from stgx.graph import load_skeleton
from stgx.models import msgcn as j_msgcn
from stgx.models import mstcn as j_mstcn
from stgx.ops.temporal import temporal_conv as j_temporal_conv
from stgx.parallel.loop import OptimizerConfig as JOptimizerConfig
from stgx.parallel.loop import Trainer as JTrainer
from stgx.utils import LOSS as J_LOSS
from stgx_torch.data import SkeletonDirDataset, class_distribution, load_actions
from stgx_torch.data.synth import generate
from stgx_torch.models import msgcn, mstcn
from stgx_torch.ops.temporal import temporal_conv
from stgx_torch.parallel.loop import OptimizerConfig, Trainer
from stgx_torch.parallel.segments import pad_to_bucket
from stgx_torch.utils import LOSS, LossMultiStage, StatisticsMultiStage
from stgx_torch.weights import from_jax_params
from test_torch_stgcn import SMALL, _close, _perturbed, spy_losses

V = 25
TCN = dict(stages=3, filters=(8, 8, 8), layers=(6, 2, 2), kernel=(3, 3, 3), dropout=(0.0,) * 3)
GCN = dict(SMALL, stages=2, filters=(8, 8), layers=(2, 2), refine_kernel=(3, 3),
           refine_dropout=(0.0, 0.0))


@pytest.mark.parametrize("dilation,length", [(1, 12), (8, 12), (32, 12), (512, 20)])
def test_taps_route_takes_a_dilation_past_the_trial(dilation, length):
    """MS-TCN's symmetric padding by the dilation, which reaches past a
    short trial on both sides (512 at its tenth layer)."""
    rng = np.random.default_rng(dilation)
    x = rng.normal(size=(2, length, 3, 4)).astype(np.float32)
    w = rng.normal(size=(3, 4, 5)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    ref = j_temporal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), dilation=dilation,
                          padding=dilation)
    got = temporal_conv(torch.tensor(x), torch.tensor(w), torch.tensor(b), dilation=dilation,
                        padding=dilation)
    _close(got, ref)


def test_dilated_residual_layer_and_single_stage_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 12, 1, 8)).astype(np.float32)
    for jl, tl in (
        (j_mstcn.DilatedResidualLayer(features=8, kernel=3, dilation=4, dropout=0.0),
         mstcn.DilatedResidualLayer(8, torch.Generator().manual_seed(0), 3, 4, 0.0)),
        (j_mstcn.SingleStage(out_channels=5, num_filters=8, num_layers=5),
         mstcn.SingleStage(8, 5, torch.Generator().manual_seed(0), 8, 5)),
    ):
        params = _perturbed(jl.init(jax.random.PRNGKey(1), jnp.asarray(x)), 1)["params"]
        if isinstance(tl, mstcn.SingleStage):
            tm = mstcn.MsTcn(5, 8, stages=1, filters=(8,), layers=(5,), kernel=(3,),
                             dropout=(0.0,), device="cpu")
            tm.load_state_dict(from_jax_params({"params": {"SingleStage_0": params}}, tm))
            tl = tm.generator_stage
        else:
            sd = {"conv_kernel": params["conv_kernel"], "conv_bias": params["conv_bias"],
                  "pointwise.kernel": params["Dense_0"]["kernel"],
                  "pointwise.bias": params["Dense_0"]["bias"]}
            tl.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
        ref = jl.apply({"params": params}, jnp.asarray(x))
        with torch.no_grad():
            _close(tl(torch.tensor(x)), ref)


@pytest.mark.parametrize("refine,output_type", [("softmax", "logits"),
                                                ("logits", "logsoftmax"),
                                                ("logsoftmax", "softmax")])
def test_models_match_jax(refine, output_type):
    """MS-TCN ``(stages, N, L, classes)`` on a 12-frame trial and MS-GCN
    ``(stages + 1, 1, T, classes)`` on 6 windows with a window mask, every
    adapter pair of the configs."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 12, V, 3)).astype(np.float32)
    jm = j_mstcn.MsTcn(num_classes=5, in_feat=3, refine=refine, output_type=output_type, **TCN)
    params = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 0)
    tm = mstcn.MsTcn(5, 3, refine=refine, output_type=output_type, device="cpu", **TCN)
    tm.load_state_dict(from_jax_params(params, tm), strict=True)
    with torch.no_grad():
        got = tm(torch.tensor(x))
    assert got.shape == (3, 2, 12, 5)
    _close(got, jm.apply(params, jnp.asarray(x)))

    w = rng.normal(size=(6, 12, V, 3)).astype(np.float32)
    wmask = np.ones((6, 12), np.float32)
    wmask[5] = 0.0  # a window of padding only
    jg = j_msgcn.MsGcn(refine=refine, output_type=output_type, normalization="BatchNorm", **GCN)
    gparams = _perturbed(jg.init(jax.random.PRNGKey(1), jnp.asarray(w)), 1)
    tg = msgcn.MsGcn(refine=refine, output_type=output_type, normalization="BatchNorm",
                     device="cpu", **GCN)
    tg.load_state_dict(from_jax_params(gparams, tg), strict=True)
    with torch.no_grad():
        got = tg(torch.tensor(w), mask=torch.tensor(wmask))
    assert got.shape == (3, 1, 6, 5)
    _close(got, jg.apply(gparams, jnp.asarray(w), mask=jnp.asarray(wmask)))


# -- the Trainer kinds ----------------------------------------------------------------


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("synth_ms"))
    info = generate(d, skeleton="pku-mmd", num_classes=5, in_feat=3, num_train=3,
                    num_val=1, min_len=17, max_len=40, seed=9)
    split = [os.path.join(d, "train", s) for s in ("features", "labels")]
    val = [os.path.join(d, "val", s) for s in ("features", "labels")]
    ds = SkeletonDirDataset(*split)
    ncls = len(load_actions(info["actions"]))
    return (ds, SkeletonDirDataset(*val), JDirDataset(*split), JDirDataset(*val),
            class_distribution(ds, ncls), ncls)


def _trainers(synth, name, lr, **kw):
    ds, _, jds, _, dist, ncls = synth
    if name == "ms-tcn":
        jmodel = j_mstcn.MsTcn(num_classes=ncls, in_feat=3, **TCN)
        tmodel = mstcn.MsTcn(ncls, 3, device="cpu", **TCN)
        kind, x0 = "frame_ms", jds[0][0][None]
    else:
        # one refinement stage: the Trainer's multi-stage path at the least cost
        gcn = dict(GCN, num_classes=ncls, normalization="BatchNorm", stages=1, filters=(8,),
                   layers=(2,), refine_kernel=(3,), refine_dropout=(0.0,))
        jmodel, tmodel = j_msgcn.MsGcn(**gcn), msgcn.MsGcn(**gcn, device="cpu")
        kind, x0 = "window_ms", np.zeros((4, kw["receptive_field"], V, 3), np.float32)
    jt = JTrainer(model=jmodel, kind=kind, loss=J_LOSS[name](dist),
                  opt=JOptimizerConfig(learning_rate=lr, batch_size=2), **kw)
    params, _ = jt.init(x0)
    params = jax.tree.map(jnp.asarray, _perturbed(params, 5))
    opt_state = jt.tx.init(params)
    tmodel.load_state_dict(from_jax_params(params, tmodel), strict=True)
    tt = Trainer(model=tmodel, kind=kind, loss=LOSS[name](dist),
                 opt=OptimizerConfig(learning_rate=lr, batch_size=2), **kw)
    assert isinstance(tt.loss, LossMultiStage) and isinstance(tt.statistics, StatisticsMultiStage)
    return jt, params, opt_state, tt


@pytest.mark.parametrize("name,trial_batch", [("ms-tcn", 1), ("ms-tcn", 2), ("ms-gcn", 1)])
def test_one_epoch_matches_the_jax_trainer(synth, monkeypatch, name, trial_batch):
    """n = 3 trials, batch_size 2 (divisors 2, 2, 1): ``frame_ms`` in
    buckets of 64, one trial a step or two stacked (``trial_batch = 2``,
    each keeping its own loss and divisor); ``window_ms`` with W = 12 in
    chunks of 16 windows. The first Adam step's accumulated gradients, every
    step's losses, the epoch's statistics, the parameters after the epoch
    and ``evaluate``'s losses, top-k and per-frame predictions against the
    JAX Trainer's."""
    ds, val, jds, jval, _, _ = synth
    lr = 2e-3
    kw = (dict(bucket=64, trial_batch=trial_batch) if name == "ms-tcn"
          else dict(receptive_field=12, segment=16, bucket=16))
    jt, params, opt_state, tt = _trainers(synth, name, lr, **kw)

    accum = None
    for i in range(2):
        if trial_batch > 1:
            xd, yd, md = jt._prepare(*jds[i])
            grads = jt._grad_step_batched(xd.shape)(params, xd, yd, md, jnp.asarray([2.0]),
                                                    jax.random.PRNGKey(i), jnp.asarray(0.0))[0]
            x, y, m = tt.stack_trials(*([a] for a in pad_to_bucket(*ds[i], 64)))
            tt.grad_step(x, y, m, [2.0])
            accum = grads if accum is None else jax.tree.map(jnp.add, accum, grads)
            continue
        jx, jy, jmask = jt._prepare(*jds[i])
        chunks = jt._window_chunks(jx, jy, jmask)
        for cx, cy, cm in chunks:
            grads = jt._grad_step(cx.shape)(params, cx, cy, cm, 2.0 * len(chunks),
                                            jax.random.PRNGKey(i), jnp.asarray(0.0))[0]
            accum = grads if accum is None else jax.tree.map(jnp.add, accum, grads)
        t_chunks = tt.chunks(*tt.prepare(*ds[i]))
        assert len(t_chunks) == len(chunks)
        for cx, cy, cm in t_chunks:
            tt.grad_step(cx, cy, cm, 2.0 * len(chunks))
    ref = from_jax_params(jax.tree.map(np.asarray, accum), tt.model)
    for pname, p in tt.model.named_parameters():
        _close(p.grad, ref[pname], 1e-4)
    tt.optimizer.zero_grad(set_to_none=True)

    j_ev = jt.evaluate(params, jval)
    t_ev = tt.evaluate(val)
    for key in ("ce", "mse", "top1", "top5"):
        np.testing.assert_allclose(t_ev[key], j_ev[key], rtol=1e-5, err_msg=key)
    x, y = val[0]
    np.testing.assert_array_equal(tt.predict(x, y), _j_predict(jt, params, x, y))

    j_losses, t_losses = spy_losses(jt, tt, monkeypatch, batched=trial_batch > 1)
    p1, _, j_stats = jt.train_epoch(params, opt_state, jds, 0)
    t_stats = tt.train_epoch(ds, 0)
    assert len(t_losses) == len(j_losses) >= 2
    np.testing.assert_allclose([l[:2] for l in t_losses], [l[:2] for l in j_losses],
                               rtol=1e-5, atol=1e-6)
    for key in ("ce", "mse", "top1", "top5"):
        np.testing.assert_allclose(t_stats[key], j_stats[key], rtol=1e-5, err_msg=key)
    ref = from_jax_params(jax.tree.map(np.asarray, p1), tt.model)
    for pname, p in tt.model.state_dict().items():
        assert np.abs(p.numpy() - ref[pname].numpy()).max() <= 2 * lr * 2, pname


def _j_predict(jt, params, x, y):
    """The JAX Trainer's per-frame top-1 of one trial, as its CLI dumps it."""
    xd, yd, md = jt._prepare(x, y)
    top1 = jt._eval_step(xd.shape)(params, xd, yd, md)[2]
    return np.asarray(top1).reshape(-1)[: len(y)]


def test_dropout_draws_from_the_generator_and_remat_replays_it():
    """MS-TCN and MS-GCN at the configs' dropout 0.5: two training forwards
    from one generator state are equal and differ from the eval forward;
    under ``remat`` the gradients equal the stored path's bit for bit."""
    x = np.random.default_rng(3).normal(size=(1, 12, V, 3)).astype(np.float32)
    w = np.random.default_rng(4).normal(size=(4, 12, V, 3)).astype(np.float32)
    cases = ((lambda r: mstcn.MsTcn(5, 3, **dict(TCN, dropout=(0.5,) * 3), remat=r,
                                    device="cpu"), x),
             (lambda r: msgcn.MsGcn(**dict(GCN, refine_dropout=(0.5, 0.5)), remat=r,
                                    device="cpu"), w))
    for make, inp in cases:
        grads = {}
        for remat in (False, True):
            tm = make(remat)
            runs = [tm(torch.tensor(inp), train=True, generator=torch.Generator().manual_seed(1))
                    for _ in range(2)]
            assert torch.equal(runs[0], runs[1])
            with torch.no_grad():
                assert not torch.equal(runs[0], tm(torch.tensor(inp)))
            runs[0].square().sum().backward()
            grads[remat] = {k: p.grad.clone() for k, p in tm.named_parameters()}
        for k in grads[False]:
            assert torch.equal(grads[True][k], grads[False][k]), k


def test_unknown_kinds_raise():
    tm = mstcn.MsTcn(5, 3, device="cpu", **TCN)
    with pytest.raises(ValueError, match="unknown Trainer kind"):
        Trainer(model=tm, kind="frames", loss=LOSS["ms-tcn"]([1.0] * 5), opt=OptimizerConfig())
