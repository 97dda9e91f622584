"""The port's Shift-GCN slice (stgx_torch.models.shiftgcn, the ``window``
kind of the Trainer, the window streaming cell) against the JAX package on
the CPU.

The JAX variables are made from a seed and moved off their init values
(the learnable shifts spread over several frames), carried into the port by
``from_jax_params`` and loaded with ``strict=True``; both sides then see
the same numpy inputs. On the CPU the port's ``temporal_shift`` runs its
plain version and its closed-form backward, the backward the card runs.

Tolerances: outputs ``1e-4 · max(1, max|ref|)`` (fp32 sums in another
order, through normalised layers); each parameter's gradient ``1e-5 ·
max(1, max|ref|)``, as the RT-ST-GCN Trainer test holds them, except a
bias that feeds a batch norm, whose gradient is zero in exact arithmetic
and is held to zero on both sides within ``1e-5`` of the module's largest
gradient; losses and statistics of the Trainer fp32, ``rtol = 1e-5``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stgx.bench.streaming import _window_stream_fns as j_window_stream_fns
from stgx.config import build_model as j_build_model
from stgx.config import load_config as j_load_config
from stgx.data import SkeletonDirDataset as JDirDataset
from stgx.graph import load_skeleton
from stgx.models import shiftgcn as j_sg
from stgx.parallel.loop import OptimizerConfig as JOptimizerConfig
from stgx.parallel.loop import Trainer as JTrainer
from stgx.parallel.segments import sliding_windows as j_sliding_windows
from stgx.utils import LOSS as J_LOSS
from stgx_torch.bench.streaming import (
    init_window_state,
    measure_stream_latency,
    window_step,
)
from stgx_torch.config import build_model, load_config
from stgx_torch.data import SkeletonDirDataset, class_distribution, load_actions
from stgx_torch.data.synth import generate
from stgx_torch.models import MODELS
from stgx_torch.models import shiftgcn as sg
from stgx_torch.parallel.loop import OptimizerConfig, Trainer
from stgx_torch.parallel.segments import sliding_windows
from stgx_torch.utils import LOSS
from stgx_torch.weights import from_jax_params

CONFIG = "configs/pku-mmd/as_is/shiftgcn.json"
V = 25
# unit 0: 3 -> 8 with the spatial down-projection and no residual; unit 1
# the identity residual; unit 2: 8 -> 16 at stride 2 with the residual conv
SMALL = dict(num_classes=5, in_feat=3, in_ch=(3, 8, 8), out_ch=(8, 8, 16),
             stride=(1, 1, 2), residual=(0, 1, 1))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side on one thread, as ``tests/test_torch_shiftgcn_plus.py``
    runs it: its epochs are many small ops, which beside the other test
    workers' threads lose far more to thread hand-offs than they gain from
    a parallel loop (the file took 538 s of a six-worker run, a test of 1 s
    alone 160 s there)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _perturbed(params, seed):
    """Every leaf moved off its init value; the temporal shifts spread over
    ±5 frames, so the taps reach well past the neighbouring frames."""
    rng = np.random.default_rng(seed)

    def move(path, a):
        a = np.asarray(a)
        if "shift" in jax.tree_util.keystr(path):
            return rng.uniform(-5.0, 5.0, size=a.shape).astype(np.float32)
        return a + 0.1 * rng.normal(size=a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(move, params)


def _modules(name, normalization):
    """(JAX module, port module) of one kind, same widths."""
    graph = load_skeleton("pku-mmd")
    gen = torch.Generator().manual_seed(0)
    if name == "spatial":
        return (j_sg.SpatialShiftBlock(8, 16, V, normalization),
                sg.SpatialShiftBlock(8, 16, V, gen, normalization))
    if name == "temporal":
        return (j_sg.TemporalShiftBlock(8, 8, V, 2, normalization),
                sg.TemporalShiftBlock(8, 8, V, gen, 2, normalization))
    if name == "unit":
        return (j_sg.ShiftUnit(8, 16, V, 2, True, normalization),
                sg.ShiftUnit(8, 16, V, gen, 2, True, normalization))
    return (j_sg.ShiftGcn(graph=graph, normalization=normalization, **SMALL),
            sg.ShiftGcn(graph=graph, normalization=normalization, **SMALL,
                        device="cpu"))


def _feeds_batch_norm(pname):
    """A bias added just before a batch norm: the spatial block's main
    bias (the joint rotation keeps it constant per channel), its
    down-projection's and the residual conv's. The norm subtracts it again,
    so its gradient is zero in exact arithmetic."""
    return pname == "bias" or pname.endswith(("spatial.bias", "down_bias", "res_bias"))


def _assert_grads_close(tm, jax_grads, normalization, tol=1e-5):
    """Each parameter's ``.grad`` against the JAX gradient tree."""
    ref = from_jax_params(jax.tree.map(np.asarray, jax_grads), tm)
    scale = max(np.abs(r.numpy()).max() for r in ref.values())
    for pname, p in tm.named_parameters():
        r = ref[pname].numpy()
        if normalization == "BatchNorm" and _feeds_batch_norm(pname):
            # exactly zero: both sides hold only the rounding of sums whose
            # terms are of the module's gradient scale
            assert max(np.abs(p.grad.numpy()).max(), np.abs(r).max()) <= 1e-5 * scale, pname
            continue
        err = np.abs(p.grad.numpy() - r).max()
        assert err <= tol * max(1.0, np.abs(r).max()), (pname, err)


@pytest.mark.parametrize("normalization,masked", [
    ("BatchNorm", False), ("BatchNorm", True), ("LayerNorm", False)])
@pytest.mark.parametrize("name", ["spatial", "temporal", "unit", "model"])
def test_blocks_and_model_match_jax(name, normalization, masked):
    """Output, and every parameter's gradient of ``Σ out·g``, against JAX.
    A mask keeps padded frames out of the batch norms' statistics; a layer
    norm takes none (in both packages), so it runs unmasked only."""
    rng = np.random.default_rng(1)
    cin = 3 if name == "model" else 8
    x = rng.normal(size=(2, 19, V, cin)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((2, 19), np.float32)
        mask[1, 13:] = 0.0
    jm, tm = _modules(name, normalization)
    jmask = None if mask is None else jnp.asarray(mask)
    params = jax.tree.map(jnp.asarray, _perturbed(
        jm.init(jax.random.PRNGKey(0), jnp.asarray(x), mask=jmask), 3))
    ref_out = jm.apply(params, jnp.asarray(x), mask=jmask)
    g = rng.normal(size=ref_out.shape).astype(np.float32)
    ref_grads = jax.grad(
        lambda p: jnp.sum(jm.apply(p, jnp.asarray(x), mask=jmask) * g))(params)

    tm.load_state_dict(from_jax_params(params, tm), strict=True)
    out = tm(torch.tensor(x), mask=None if mask is None else torch.tensor(mask))
    ref_out = np.asarray(ref_out)
    assert out.shape == ref_out.shape
    err = np.abs(out.detach().numpy() - ref_out).max()
    assert err <= 1e-4 * max(1.0, np.abs(ref_out).max()), err
    (out * torch.tensor(g)).sum().backward()
    _assert_grads_close(tm, ref_grads, normalization)


def test_full_width_weights_load_strictly():
    """The PKU-MMD Shift-GCN at full width: a JAX tree of its shapes (from
    ``eval_shape``, filled from a seed) loads strictly, every value lands,
    and the parameter counts agree."""
    jm = j_build_model(j_load_config(CONFIG), 52)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 2, V, 3)))
    rng = np.random.default_rng(8)
    params = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), shapes)
    tm = build_model(load_config(CONFIG), 52, device="cpu")
    assert isinstance(tm, sg.ShiftGcn) and len(tm.units) == 10
    sd = from_jax_params(params, tm)
    tm.load_state_dict(sd, strict=True)
    assert sum(t.numel() for t in tm.parameters()) == \
        sum(np.size(a) for a in jax.tree.leaves(params))
    assert sorted(float(t.sum()) for t in sd.values()) == \
        sorted(float(torch.tensor(a).sum()) for a in jax.tree.leaves(params))


def test_build_model_builds_shift_gcn_from_its_config():
    cfg = load_config(CONFIG)
    model = build_model(cfg, 52, device="cpu")
    assert isinstance(model, MODELS["shift-gcn"])
    assert model.stride == (1, 1, 1, 1, 2, 1, 1, 2, 1, 1)
    assert [u.spatial.kernel.shape[1] for u in model.units] == \
        [64] * 4 + [128] * 3 + [256] * 3
    assert model.num_joints == V and model.fc.kernel.shape == (256, 52)
    # the same seed gives the same weights; arch.remat reaches the model
    again = build_model(cfg, 52, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))
    assert not model.remat
    assert build_model(load_config(CONFIG, ["arch.remat=true"]), 52, device="cpu").remat


@pytest.mark.parametrize("window", [1, 5, 12])
def test_sliding_windows_match_jax(window):
    x = np.random.default_rng(window).normal(size=(2, 10, 4, 3)).astype(np.float32)
    got = sliding_windows(torch.tensor(x), window)
    ref = np.asarray(j_sliding_windows(jnp.asarray(x), window))
    assert got.shape == (2, 10, window, 4, 3) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("normalization", ["BatchNorm", "LayerNorm"])
def test_window_streaming_cell_matches_jax(normalization):
    """A few frames through the window cell: the buffer rolled by one frame,
    the new frame last, the model on it (train=False, no mask)."""
    w = 6
    jm, tm = _modules("model", normalization)
    frames = np.random.default_rng(4).normal(size=(9, V, 3)).astype(np.float32)
    params = jax.tree.map(jnp.asarray, _perturbed(
        jm.init(jax.random.PRNGKey(0), jnp.zeros((1, w, V, 3))), 5))
    tm.load_state_dict(from_jax_params(params, tm), strict=True)
    j_init, j_cell = j_window_stream_fns(jm, w)
    j_step = jax.jit(lambda p, st, x_t: j_cell(jm, p, st, x_t))
    j_state = j_init(jm, params)
    state = init_window_state(tm, batch=1, window=w)
    assert state["buf"].shape == j_state["buf"].shape
    for t in range(len(frames)):
        ref, j_state = j_step(params, j_state, jnp.asarray(frames[t][None]))
        got, state = window_step(tm, state, torch.tensor(frames[t][None]))
        np.testing.assert_array_equal(state["buf"].numpy(), np.asarray(j_state["buf"]))
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max()), t


# -- the golden test: one window-kind epoch against the JAX Trainer -------------


W_FIELD, SEGMENT, BUCKET = 12, 16, 16


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("synth_window"))
    # trials of 18, 40 and 30 frames in buckets of 16: 2 or 3 chunks each,
    # the last one masked past the trial's end and never all padding
    info = generate(d, skeleton="pku-mmd", num_classes=5, in_feat=3, num_train=3,
                    num_val=1, min_len=17, max_len=40, seed=7)
    split = [os.path.join(d, "train", s) for s in ("features", "labels")]
    val = [os.path.join(d, "val", s) for s in ("features", "labels")]
    ds = SkeletonDirDataset(*split)
    ncls = len(load_actions(info["actions"]))
    return (ds, SkeletonDirDataset(*val), JDirDataset(*split), JDirDataset(*val),
            class_distribution(ds, ncls), ncls)


def _trainers(synth, lr, bucket=BUCKET):
    ds, _, jds, _, dist, ncls = synth
    graph = load_skeleton("pku-mmd")
    arch = dict(SMALL, num_classes=ncls, graph=graph, normalization="BatchNorm")
    kw = dict(receptive_field=W_FIELD, segment=SEGMENT, bucket=bucket)
    jt = JTrainer(model=j_sg.ShiftGcn(**arch), kind="window", loss=J_LOSS["shift-gcn"](dist),
                  opt=JOptimizerConfig(learning_rate=lr, batch_size=2), **kw)
    params, opt_state = jt.init(np.zeros((4, W_FIELD, V, 3), np.float32))
    params = jax.tree.map(jnp.asarray, _perturbed(params, 7))
    opt_state = jt.tx.init(params)
    tm = sg.ShiftGcn(**arch, device="cpu")
    tm.load_state_dict(from_jax_params(params, tm), strict=True)
    tt = Trainer(model=tm, kind="window", loss=LOSS["shift-gcn"](dist),
                 opt=OptimizerConfig(learning_rate=lr, batch_size=2), **kw)
    return jt, params, opt_state, tt


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


def test_window_epoch_and_evaluate_match_the_jax_trainer(synth, monkeypatch):
    """n = 3 trials, batch_size 2: divisors 2, 2 and 1 (the ragged final
    group) and Adam steps after trials 2 and 3. Each trial is windowed (W = 12) and cut into chunks
    of 16 windows, its last chunk masked past the trial's end, so every
    chunk's loss is divided by divisor · chunks. The first Adam step's
    accumulated gradients agree to 1e-4 of max(1, max|ref|) and every
    chunk's loss through the epoch to 1e-5. Parameters after the epoch stay within 2·lr per Adam
    step, the most two runs can differ: under BatchNorm the biases that feed
    a norm have gradients that are rounding noise on both sides, which Adam
    scales up to steps of lr. ``evaluate`` from the same start gives JAX's
    losses, top-k and per-frame predictions."""
    ds, val, jds, jval, _, _ = synth
    lr = 2e-3
    jt, params, opt_state, tt = _trainers(synth, lr)
    assert [len(tt.chunks(*tt.prepare(*ds[i]))) for i in range(len(ds))] == [2, 3, 2]

    # the first Adam step's accumulated gradients (trials 0 and 1, by chunk)
    accum = None
    for i in range(2):
        jx, jy, jmask = jt._prepare(*jds[i])
        chunks = jt._window_chunks(jx, jy, jmask)
        for cx, cy, cm in chunks:
            grads = jt._grad_step(cx.shape)(params, cx, cy, cm, 2.0 * len(chunks),
                                            jax.random.PRNGKey(i), jnp.asarray(0.0))[0]
            accum = grads if accum is None else jax.tree.map(jnp.add, accum, grads)
        t_chunks = tt.chunks(*tt.prepare(*ds[i]))
        assert len(t_chunks) == len(chunks)
        for cx, cy, cm in t_chunks:
            tt.grad_step(cx, cy, cm, 2.0 * len(t_chunks))
    # five chunks of batch-normalised windows summed in another order on
    # each side: the worst parameter here is 2.1e-5 from JAX
    _assert_grads_close(tt.model, accum, "BatchNorm", tol=1e-4)
    tt.optimizer.zero_grad(set_to_none=True)

    j_rec, t_rec = _Record(), _Record()
    j_ev = jt.evaluate(params, jval, metrics=[j_rec])
    t_ev = tt.evaluate(val, metrics=[t_rec])
    for key in ("ce", "mse", "top1", "top5"):
        np.testing.assert_allclose(t_ev[key], j_ev[key], rtol=1e-5, err_msg=key)
    assert t_rec.seen == j_rec.seen

    j_losses, t_losses = [], []
    j_make = jt._grad_step

    def j_spy(shape_key):
        fn = j_make(shape_key)

        def run(*a):
            out = fn(*a)
            j_losses.append((float(out[1]), float(out[2]), a[4]))
            return out
        return run

    monkeypatch.setattr(jt, "_grad_step", j_spy)
    t_step = tt.grad_step

    def t_spy(*a, **k):
        out = t_step(*a, **k)
        t_losses.append((float(out[0]), float(out[1]), a[3]))
        return out

    monkeypatch.setattr(tt, "grad_step", t_spy)
    p1, _, j_stats = jt.train_epoch(params, opt_state, jds, 0)
    t_stats = tt.train_epoch(ds, 0)
    assert len(t_losses) == len(j_losses) > len(ds)
    assert [d for *_, d in t_losses] == [d for *_, d in j_losses]
    np.testing.assert_allclose([l[:2] for l in t_losses], [l[:2] for l in j_losses],
                               rtol=1e-5, atol=1e-6)
    for key in ("ce", "mse", "top1", "top5"):
        np.testing.assert_allclose(t_stats[key], j_stats[key], rtol=1e-5, err_msg=key)
    bound = 2 * lr * 2
    ref = from_jax_params(jax.tree.map(np.asarray, p1), tt.model)
    for name, p in tt.model.state_dict().items():
        assert np.abs(p.numpy() - ref[name].numpy()).max() <= bound, name


def _epoch_record(tt, ds, monkeypatch):
    """Each grad step's (ce, mse, divisor) over one epoch, and the state."""
    losses = []
    step = tt.grad_step

    def spy(*a, **k):
        out = step(*a, **k)
        losses.append((float(out[0]), float(out[1]), a[3]))
        return out

    monkeypatch.setattr(tt, "grad_step", spy)
    stats = tt.train_epoch(ds, 0)
    return losses, stats, {k: v.clone() for k, v in tt.model.state_dict().items()}


def test_chunks_of_bucket_padding_only_are_left_out(synth, monkeypatch):
    """In buckets of 64 the 40-frame trial has a chunk of 16 windows that are
    all padding (windows 48-63); the JAX Trainer keeps it and its epoch
    turns NaN (0/0 in the masked loss). The port leaves it out and then
    trains exactly as in buckets of 16, where no chunk is all padding."""
    ds = synth[0]
    _, _, _, t16 = _trainers(synth, 2e-3)
    _, _, _, t64 = _trainers(synth, 2e-3, bucket=64)
    x, y, m = t64.prepare(*ds[1])
    assert x.shape[0] == 64 and len(y) == 64 and int(m.sum()) == len(ds[1][1]) == 40
    assert [int(c[2].sum()) for c in t64.chunks(x, y, m)] == [16, 16, 8]
    l16, s16, p16 = _epoch_record(t16, ds, monkeypatch)
    l64, s64, p64 = _epoch_record(t64, ds, monkeypatch)
    assert np.isfinite([l[:2] for l in l64]).all()
    assert l64 == l16 and s64 == {**s16, "duration": s64["duration"]}
    assert all(torch.equal(p64[k], p16[k]) for k in p16)


# -- entry points ------------------------------------------------------------------


@pytest.mark.parametrize("entry", ["ShiftGcn", "build_model"])
def test_entry_points_without_a_device_refuse_a_cudaless_machine(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "ShiftGcn": lambda: sg.ShiftGcn(graph=load_skeleton("pku-mmd"), **SMALL),
        "build_model": lambda: build_model(load_config(CONFIG), 52),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


def test_window_stream_latency_refuses_the_cpu():
    model = sg.ShiftGcn(graph=load_skeleton("pku-mmd"), **SMALL, device="cpu")
    with pytest.raises(RuntimeError, match="device measurement"):
        measure_stream_latency(model, torch.zeros(4, V, 3), window=8)
