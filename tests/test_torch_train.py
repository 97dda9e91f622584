"""The port's training path (stgx_torch.utils, .parallel, .data, .bench)
against the JAX package on the CPU.

Losses, statistics, bucketing, the dataset and its synthetic generator are
held against their JAX counterparts on the same inputs; whole-model loss
gradients against ``jax.grad`` with the parameters carried by
``from_jax_params``; and one epoch of the port's ``Trainer`` against the
JAX ``Trainer`` from the same start. On the CPU the port's kernels run
their plain versions and their autograd Functions the backward the card
runs; the JAX fused kernel runs in Pallas interpret mode.

Tolerances: losses and statistics fp32, ``rtol = atol = 1e-5``; gradients
of a whole model ``1e-4 · max(1, max|ref|)`` (fp32 sums in another order,
through normalised layers).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stgx.data import SkeletonDirDataset as JDirDataset
from stgx.data import class_distribution as j_class_distribution
from stgx.data import load_actions as j_load_actions
from stgx.data.synth import generate as j_generate
from stgx.graph import load_skeleton
from stgx.models import MODELS as J_MODELS
from stgx.models.rtstgcn import RtStgcn as JRtStgcn
from stgx.ops import rt_fused as j_rtf
from stgx.parallel.loop import MODEL_KIND as J_MODEL_KIND
from stgx.parallel.loop import OptimizerConfig as JOptimizerConfig
from stgx.parallel.loop import Trainer as JTrainer
from stgx.parallel.segments import pad_to_bucket as j_pad_to_bucket
from stgx.utils import LOSS as J_LOSS
from stgx.utils import STATISTICS as J_STATISTICS
from stgx.utils import flops as j_flops
from stgx_torch.bench.train_throughput import measure_train_throughput
from stgx_torch.data import SkeletonDirDataset, class_distribution, load_actions
from stgx_torch.data.synth import generate
from stgx_torch.models.rtstgcn import RtStgcn
from stgx_torch.ops import rt_fused
from stgx_torch.parallel.loop import MODEL_KIND, OptimizerConfig, Trainer
from stgx_torch.parallel.segments import pad_to_bucket
from stgx_torch.utils import LOSS, STATISTICS, flops
from stgx_torch.weights import from_jax_params

SMALL = dict(
    num_classes=5, in_feat=3, graph=load_skeleton("pku-mmd"), kernel=9,
    in_ch=(8, 8, 16), out_ch=(8, 16, 16), stride=(1, 2, 1),
    residual=(1, 1, 0), dropout=(0.0, 0.0, 0.0),
)


def _np(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _close(got, ref, tol=1e-5):
    ref = np.asarray(ref, dtype=np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=np.shape(a)).astype(np.float32),
        params,
    )


# -- loss, statistics, registries ---------------------------------------------


@pytest.mark.parametrize("output_type", ["logits", "logsoftmax", "softmax"])
@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_loss_matches_jax(output_type, per_sample, masked):
    rng = np.random.default_rng(3)
    logits = _np(rng, 3, 11, 6, scale=2.0)
    if output_type == "logsoftmax":
        logits = np.asarray(jax.nn.log_softmax(logits, axis=-1))
    elif output_type == "softmax":
        logits = np.asarray(jax.nn.softmax(logits, axis=-1))
    labels = rng.integers(0, 6, size=(3, 11))
    mask = (rng.random((3, 11)) > 0.3).astype(np.float32) if masked else None
    dist = rng.integers(1, 50, size=6).astype(np.float32)
    ref = J_LOSS["rt-st-gcn"](dist, output_type)(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask), per_sample)
    got = LOSS["rt-st-gcn"](dist, output_type)(
        torch.tensor(logits), torch.tensor(labels),
        None if mask is None else torch.tensor(mask), per_sample)
    for g, r in zip(got, ref):
        _close(g, r)


def test_multistage_loss_and_statistics_match_jax():
    rng = np.random.default_rng(4)
    out, labels = _np(rng, 2, 3, 9, 7), rng.integers(0, 7, size=(3, 9))
    mask = (rng.random((3, 9)) > 0.2).astype(np.float32)
    dist = np.arange(1, 8, dtype=np.float32)
    ref = J_LOSS["ms-tcn"](dist)(jnp.asarray(out), jnp.asarray(labels), jnp.asarray(mask))
    got = LOSS["ms-tcn"](dist)(torch.tensor(out), torch.tensor(labels), torch.tensor(mask))
    for g, r in zip(got, ref):
        _close(g, r)
    ref = J_STATISTICS["ms-tcn"]()(jnp.asarray(out), jnp.asarray(labels), jnp.asarray(mask))
    got = STATISTICS["ms-tcn"]()(torch.tensor(out), torch.tensor(labels), torch.tensor(mask))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))


@pytest.mark.parametrize("masked", [False, True])
def test_statistics_match_jax(masked):
    rng = np.random.default_rng(5)
    out, labels = _np(rng, 2, 13, 8), rng.integers(0, 8, size=(2, 13))
    mask = (rng.random((2, 13)) > 0.4).astype(np.float32) if masked else None
    ref = J_STATISTICS["rt-st-gcn"]()(jnp.asarray(out), jnp.asarray(labels),
                                       None if mask is None else jnp.asarray(mask))
    got = STATISTICS["rt-st-gcn"]()(torch.tensor(out), torch.tensor(labels),
                                     None if mask is None else torch.tensor(mask))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))


def test_registries_and_model_kinds_match_jax():
    assert {k: v.__name__ for k, v in LOSS.items()} == {
        k: v.__name__ for k, v in J_LOSS.items()}
    assert {k: v.__name__ for k, v in STATISTICS.items()} == {
        k: v.__name__ for k, v in J_STATISTICS.items()}
    assert MODEL_KIND == J_MODEL_KIND


def test_flops_match_jax():
    assert flops.rt_stgcn_macs_per_frame() == j_flops.rt_stgcn_macs_per_frame()
    assert flops.rt_stgcn_macs_per_frame(num_joints=7, in_feat=6, in_ch=(16,),
                                         out_ch=(32,), residual=(1,)) == \
        j_flops.rt_stgcn_macs_per_frame(num_joints=7, in_feat=6, in_ch=(16,),
                                        out_ch=(32,), residual=(1,))
    for nbytes in (2, 4):
        assert flops.rt_stgcn_train_hbm_bytes_per_frame(dtype_bytes=nbytes) == \
            j_flops.rt_stgcn_train_hbm_bytes_per_frame(dtype_bytes=nbytes)


# -- data ------------------------------------------------------------------------


@pytest.mark.parametrize("l,bucket", [(100, 64), (128, 64), (5, 128)])
def test_pad_to_bucket_matches_jax(l, bucket):
    rng = np.random.default_rng(l)
    x, y = _np(rng, l, 7, 6), rng.integers(0, 5, size=l)
    for got, ref in zip(pad_to_bucket(x, y, bucket), j_pad_to_bucket(x, y, bucket)):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


def test_synth_writes_the_jax_files_and_the_datasets_agree(tmp_path):
    kw = dict(skeleton="pku-mmd", num_classes=52, in_feat=3, num_train=3,
              num_val=1, min_len=40, max_len=90, seed=7)
    info = generate(str(tmp_path / "port"), **kw)
    j_generate(str(tmp_path / "jax"), **kw)
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert len(files) == 9
    for rel in files:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()
    split = [str(tmp_path / "port" / "train" / s) for s in ("features", "labels")]
    ds, jds = SkeletonDirDataset(*split), JDirDataset(*split)
    assert len(ds) == len(jds) == 3 and ds.lengths() == jds.lengths()
    for i in range(3):
        for got, ref in zip(ds[i], jds[i]):
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(class_distribution(ds, 52),
                                  j_class_distribution(jds, 52))
    assert load_actions(info["actions"]) == j_load_actions(info["actions"])


# -- whole-model gradients ------------------------------------------------------


@pytest.mark.parametrize("normalization,fused", [
    ("LayerNorm", False), ("BatchNorm", False), ("BatchNorm", True)])
def test_model_loss_grads_match_jax(monkeypatch, normalization, fused):
    """Masked loss of the small RT-ST-GCN (stride 2, a residual 1×1 conv, a
    layer without residual): every parameter's gradient against jax.grad.
    Both norms unfused, and the fused core under the shipped BatchNorm."""
    monkeypatch.setattr(j_rtf, "_INTERPRET", True)
    monkeypatch.setattr(j_rtf, "_ENABLED", fused)
    monkeypatch.setattr(rt_fused, "_ENABLED", fused)
    rng = np.random.default_rng(11)
    x = _np(rng, 2, 20, 25, 3)
    labels = rng.integers(0, 5, size=(2, 20))
    mask = np.ones((2, 20), np.float32)
    mask[1, 14:] = 0.0
    jm = JRtStgcn(normalization=normalization, **SMALL)
    params = jax.tree.map(jnp.asarray,
                          _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 0))
    dist = np.arange(1, 6, dtype=np.float32)
    j_loss = J_LOSS["rt-st-gcn"](dist)

    def loss_fn(p):
        out = jm.apply(p, jnp.asarray(x), train=True, mask=jnp.asarray(mask))
        ce, mse = j_loss(out, jnp.asarray(labels), jnp.asarray(mask))
        return ce + mse

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tm = RtStgcn(normalization=normalization, **SMALL, device="cpu")
    tm.load_state_dict(from_jax_params(params, tm), strict=True)
    mask_t = torch.tensor(mask)
    out = tm(torch.tensor(x), mask=mask_t, train=True)
    ce, mse = LOSS["rt-st-gcn"](dist)(out, torch.tensor(labels), mask_t)
    (ce + mse).backward()
    np.testing.assert_allclose(float((ce + mse).detach()), float(ref_loss), rtol=1e-5)
    ref = from_jax_params(jax.tree.map(np.asarray, ref_grads), tm)
    for name, p in tm.named_parameters():
        r = ref[name].numpy()
        err = np.abs(p.grad.numpy() - r).max()
        assert err <= 1e-4 * max(1.0, np.abs(r).max()), (name, err)


# -- the golden test: one epoch against the JAX Trainer --------------------------


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("synth"))
    # 30-64 frames: one length bucket of 64, trials of several lengths
    info = generate(d, num_train=8, num_val=3, min_len=30, max_len=64, seed=2)
    split = [os.path.join(d, "train", s) for s in ("features", "labels")]
    val = [os.path.join(d, "val", s) for s in ("features", "labels")]
    ds = SkeletonDirDataset(*split)
    ncls = len(load_actions(info["actions"]))
    return ds, SkeletonDirDataset(*val), JDirDataset(*split), class_distribution(ds, ncls), ncls


def _small_arch(num_classes):
    """The small arch of tests/test_train_loop.py."""
    return dict(
        num_classes=num_classes, in_feat=6, graph=load_skeleton("imu_fogit_ABCD"),
        kernel=3, in_ch=(16, 16), out_ch=(16, 32), dropout=(0.0, 0.0),
        residual=(1, 1), normalization="LayerNorm", stride=(1, 1),
    )


def _pair(synth, trial_batch, lr=2e-3, compute_dtype=None):
    ds, _, jds, dist, ncls = synth
    jm = J_MODELS["rt-st-gcn"](**_small_arch(ncls))
    jt = JTrainer(model=jm, kind="frame", loss=J_LOSS["rt-st-gcn"](dist),
                  opt=JOptimizerConfig(learning_rate=lr, batch_size=3), bucket=64,
                  trial_batch=trial_batch, compute_dtype=compute_dtype)
    params, opt_state = jt.init(jds[0][0][None])
    tm = RtStgcn(**_small_arch(ncls), device="cpu")
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params), tm), strict=True)
    tt = Trainer(model=tm, kind="frame", loss=LOSS["rt-st-gcn"](dist),
                 opt=OptimizerConfig(learning_rate=lr, batch_size=3), bucket=64,
                 trial_batch=trial_batch, compute_dtype=compute_dtype)
    return jt, params, opt_state, tt


@pytest.mark.parametrize("trial_batch", [1, 2])
def test_one_epoch_matches_the_jax_trainer(synth, monkeypatch, trial_batch):
    """n = 8 trials, batch_size 3: divisors 3,3,3,3,3,3,2,2, Adam steps
    after trials 3, 6 and 8. Per-step losses agree to fp32 rounding, and so
    do the first step's accumulated gradients. Parameters after the epoch:
    one Adam update moves a parameter by at most about lr, so the two runs
    can differ by at most 2·lr per step whatever their gradients; with
    gradients this close they must agree to a thousandth of that bound."""
    ds, _, jds, _, _ = synth
    jt, params, opt_state, tt = _pair(synth, trial_batch)

    # the first optimizer step's accumulated gradients (trials 0..2)
    jstep = jt._grad_step_batched if trial_batch > 1 else jt._grad_step
    accum = None
    for i in range(3):
        xd, yd, md = jt._prepare(*jds[i])
        rng_key = jax.random.PRNGKey(i)
        div = jnp.asarray([3.0]) if trial_batch > 1 else 3.0
        grads = jstep(xd.shape)(params, xd, yd, md, div, rng_key, jnp.asarray(0.0))[0]
        accum = grads if accum is None else jax.tree.map(jnp.add, accum, grads)
        x, y, m = tt.stack_trials(*([a] for a in pad_to_bucket(*ds[i], 64)))
        tt.grad_step(x, y, m, [3.0] if trial_batch > 1 else 3.0)
    ref = from_jax_params(jax.tree.map(np.asarray, accum), tt.model)
    for name, p in tt.model.named_parameters():
        r = ref[name].numpy()
        assert np.abs(p.grad.numpy() - r).max() <= 1e-5 * max(1.0, np.abs(r).max()), name
    tt.optimizer.zero_grad(set_to_none=True)

    # the whole epoch, recording each step's (ce, mse) on both sides
    j_losses, t_losses = [], []
    j_name = "_grad_step_batched" if trial_batch > 1 else "_grad_step"
    j_make = getattr(jt, j_name)

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
    assert len(t_losses) == len(j_losses) >= (8 if trial_batch == 1 else 4)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5, atol=1e-6)
    for key in ("ce", "mse", "top1", "top5"):
        np.testing.assert_allclose(t_stats[key], j_stats[key], rtol=1e-5)
    lr, steps = 2e-3, 3
    bound = 2 * lr * steps
    ref = from_jax_params(jax.tree.map(np.asarray, p1), tt.model)
    for name, p in tt.model.state_dict().items():
        assert np.abs(p.numpy() - ref[name].numpy()).max() <= 1e-3 * bound, name


def test_bf16_compute_step_matches_jax(synth):
    """One bf16 grad step (parameters cast at the step boundary, fp32 norm
    statistics and loss): loss and gradients against the JAX Trainer's.
    The two frameworks round to bf16 at other places, so the tolerance is
    a few bf16 roundings (2^-8 each) of the largest gradient."""
    ds, _, jds, _, _ = synth
    jt, params, _, tt = _pair(synth, 1, compute_dtype="bfloat16")
    xd, yd, md = jt._prepare(*jds[0])
    grads, ce, mse = jt._grad_step(xd.shape)(params, xd, yd, md, 1.0,
                                             jax.random.PRNGKey(0), jnp.asarray(0.0))[:3]
    x, y, m = tt.stack_trials(*([a] for a in pad_to_bucket(*ds[0], 64)))
    t_ce, t_mse = tt.grad_step(x, y, m, 1.0)[:2]
    np.testing.assert_allclose(float(t_ce), float(ce), rtol=2e-2)
    np.testing.assert_allclose(float(t_mse), float(mse), rtol=5e-2, atol=1e-3)
    ref = from_jax_params(jax.tree.map(lambda a: np.asarray(a, np.float32), grads), tt.model)
    for name, p in tt.model.named_parameters():
        assert p.grad.dtype == torch.float32  # fp32 through the cast
        r = ref[name].numpy()
        assert np.abs(p.grad.numpy() - r).max() <= 3e-2 * max(1.0, np.abs(r).max()), name


def test_trainer_learns_and_evaluates(synth):
    ds, val, _, _, ncls = synth
    _, _, _, tt = _pair(synth, 2)
    ev0 = tt.evaluate(val)
    for epoch in range(3):
        tt.train_epoch(ds, epoch)
    seen = []

    class Metric:
        def init_metric(self, n):
            seen.append(("init", n))

        def __call__(self, labels, pred):
            assert pred.shape == labels.shape
            seen.append("trial")

        def reduce(self):
            seen.append("reduce")

    ev1 = tt.evaluate(val, metrics=[Metric()])
    assert ev1["ce"] < ev0["ce"], (ev0, ev1)
    assert seen == [("init", 3), "trial", "trial", "trial", "reduce"]


def test_set_lr_decays_per_epoch(synth):
    _, _, _, tt = _pair(synth, 1, lr=0.1)
    tt.opt.learning_rate_decay = 0.5
    assert tt.set_lr(3) == pytest.approx(0.1 * 0.5**3)
    assert all(g["lr"] == pytest.approx(0.0125) for g in tt.optimizer.param_groups)
    gen = tt.epoch_generator(2)
    assert gen.initial_seed() == tt.opt.seed + 1002


def test_unported_kinds_and_cpu_measurement_refuse(synth):
    _, _, _, tt = _pair(synth, 1)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Trainer(model=tt.model, kind="window_ms", loss=tt.loss, opt=tt.opt)
    with pytest.raises(RuntimeError, match="device measurement"):
        measure_train_throughput(tt, trials=1, frames=8)
