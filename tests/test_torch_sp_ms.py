"""Sequence parallelism (the mesh's ``seq`` axis) for the multi-stage
kinds, MS-TCN (``frame_ms``: a trial's frames over ``seq``) and MS-GCN
(``window_ms``: a window's frames over ``seq``, the chunk's windows over
``data`` for the generator and the refinement alike), on gloo ranks
against the JAX ``Trainer`` on one device; and the halo exchange's reach.

* One ``Trainer.grad_step`` (:mod:`torch_tp_cases`, ``SP_*``) at ``seq``
  2, ``seq`` 4 and ``data`` 2 × ``seq`` 2: MS-TCN on 2 trials of 16 frames
  (one padded by 4), two stages of 4 dilated layers, whose dilation of 8
  spans two of ``seq`` 4's 4-frame blocks; MS-GCN (LayerNorm and BatchNorm)
  on 8 windows of W = 50 (blocks of 25, 13/12, 7/6 at ``seq`` 2; replicas
  at ``seq`` 4) and one refinement stage of 4 layers, whose dilation of 8
  spans two of ``data`` 2's 4-window blocks. The loss within
  ``rtol = 1e-5``, every gradient, gathered whole, within ``atol = 1e-5``.
* With ``arch.remat`` (MS-TCN's refinement at ``seq`` 4, MS-GCN BatchNorm
  on ``data`` 2 × ``seq`` 2) the step equals the stored step bit for bit:
  each layer's recompute exchanges its halos again at the layout it ran
  under (the refinement's over ``data``).
* MS-GCN's refinement under ``data`` 2 (an eval forward of the same 8
  windows): each rank's refinement stage takes its 4 windows, not the
  chunk's 8, and every stage's outputs of every rank, joined, equal the JAX
  model's within ``1e-5``.
* ``halo_exchange`` on 4 ranks whose blocks of a 13-frame sequence are
  4/3/3/3 (the W = 52 blocks after two strides): halos of 5 frames back and
  7 ahead, gathered from up to three blocks, equal the zero-padded whole
  sequence's frames bit for bit, and their backward adds every halo
  frame's gradient into its owner's block as autograd of the padded whole
  does (within ``1e-6``). ``sp_temporal_conv`` (Γ = 9, strides 1 and 2),
  ``sp_temporal_shift`` (strides 1 and 2, shifts over ±8) and
  ``sp_avg_pool`` on those blocks, joined, equal the op on the whole
  sequence (the shift bit for bit; the conv within ``1e-6``), their blocks
  split as the strided bounds say.
"""

import numpy as np
import pytest
import torch

import torch_tp_cases as T

NAMES = ("ms-gcn", "ms-tcn")
PARAMS, IDS = T.sp_params(NAMES)
MSGCN = ("ms-gcn", "BatchNorm", 50)
BOUNDS = (0, 4, 7, 10, 13)  # the W = 52 blocks at seq 4 after two strides
# arch.remat: MS-TCN's refinement layers at seq 4 (halos past a block);
# MS-GCN's generator layers at seq 2 and its refinement over data 2
REMAT = ((("ms-tcn", "LayerNorm", 16), "seq4"), (("ms-gcn", "BatchNorm", 50), "data2-seq2"))


def _refine_blocks(state):
    """MS-GCN's eval forward of :func:`torch_tp_cases.batch` under ``data``
    2: this rank's outputs of every stage and the shapes its refinement
    stages took."""
    from stgx_torch.parallel.loop import OptimizerConfig, Trainer
    from stgx_torch.parallel.mesh import make_mesh, use_shards
    from stgx_torch.utils import LOSS

    name, norm, frames = MSGCN
    model = T.build(name, norm, state, T.SP_ARCH)
    trainer = Trainer(model=model, kind="window_ms", opt=OptimizerConfig(),
                      loss=LOSS[name](np.ones(T.CLASSES, np.float32)),
                      mesh=make_mesh(2, 1, 1), receptive_field=frames)
    shapes = []
    for stage in model.refinement_stages:
        stage.register_forward_pre_hook(lambda m, args: shapes.append(tuple(args[0].shape)))
    x, y, mask = (torch.tensor(a) for a in T.batch(name, frames))
    shards = trainer.layout(x)
    x, y, mask = trainer._local(shards, x, y, mask)
    with torch.no_grad(), use_shards(shards):
        out, _ = trainer._outputs(x, mask, False)
    return out.numpy(), shapes


LEFT, RIGHT = 5, 7  # halos past up to three blocks of BOUNDS


def _halo_inputs():
    rng = np.random.default_rng(4)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {"x": f(2, 13, 3, 8), "g": f(2, LEFT + 13 + RIGHT, 3, 8), "W": f(9, 8, 8),
            "b": f(8), "shift": rng.uniform(-8.5, 8.5, size=8).astype(np.float32)}


def _halo_ops(rank):
    """``halo_exchange`` and the seq ops on this rank's block of
    :data:`BOUNDS`: its results and its input's gradient (the upstream
    gradient of its extended block cut from ``g``, the padded sequence's)."""
    import torch.distributed as dist

    from stgx_torch.parallel.halo import (
        halo_exchange,
        sp_avg_pool,
        sp_temporal_conv,
        sp_temporal_shift,
    )
    from stgx_torch.parallel.mesh import Split

    t = {k: torch.tensor(v) for k, v in _halo_inputs().items()}
    frames = Split(4, rank, dist.group.WORLD, BOUNDS)
    a, b = frames.start, frames.stop
    x = frames.part(t["x"], 1).clone().requires_grad_(True)
    ext = halo_exchange(x, LEFT, RIGHT, frames.group, BOUNDS)
    (ext * t["g"][:, a: b + LEFT + RIGHT]).sum().backward()
    out = {"ext": ext.detach(), "gx": x.grad}
    xl = frames.part(t["x"], 1)
    for s in (1, 2):
        out[f"conv{s}"] = sp_temporal_conv(xl, t["W"], t["b"], stride=s, frames=frames)
        out[f"shift{s}"] = sp_temporal_shift(xl, t["shift"], s, frames)
    out["pool"] = sp_avg_pool(xl, 2, frames)
    return {k: v.detach().numpy() for k, v in out.items()}


def _halo_whole():
    """What the blocks of :func:`_halo_ops` join to: the padded sequence's
    extended blocks, the gradient autograd gives it, and each op on the
    whole sequence."""
    import torch.nn.functional as F

    from stgx_torch.ops.shift import temporal_shift_plain
    from stgx_torch.ops.temporal import temporal_conv
    from stgx_torch.parallel.halo import sp_avg_pool

    t = {k: torch.tensor(v) for k, v in _halo_inputs().items()}
    x = t["x"].clone().requires_grad_(True)
    padded = F.pad(x, (0, 0, 0, 0, LEFT, RIGHT))
    exts = [padded[:, a: b + LEFT + RIGHT] for a, b in zip(BOUNDS[:-1], BOUNDS[1:])]
    sum((e * t["g"][:, a: b + LEFT + RIGHT]).sum()
        for e, a, b in zip(exts, BOUNDS[:-1], BOUNDS[1:])).backward()
    out = {"ext": [e.detach() for e in exts], "gx": x.grad}
    for s in (1, 2):
        out[f"conv{s}"] = temporal_conv(t["x"], t["W"], t["b"], stride=s)
        out[f"shift{s}"] = temporal_shift_plain(t["x"], t["shift"], s)
    out["pool"] = sp_avg_pool(t["x"], 2)
    return out


def _ranks(rank, world, layouts, states, msgcn_state):
    out = T.sp_ranks(rank, world, layouts, states, remat=REMAT)
    if world == 2:
        out["refine"] = _refine_blocks(msgcn_state)
    if world == 4:
        out["halo"] = _halo_ops(rank)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from test_torch_spawn import start

    states = T.sp_states(NAMES)
    msgcn_state = states[MSGCN]
    pending = {w: start(_ranks, w, tmp_path_factory.mktemp("sp"), T.SP_LAYOUTS, states,
                        msgcn_state, timeout=400) for w in (2, 4)}
    refs = T.sp_references(states)
    refs["refine"] = _jax_forward(msgcn_state)
    return refs, {w: results() for w, results in pending.items()}


def _jax_forward(state):
    """The JAX MS-GCN's eval outputs of every stage on the batch."""
    import jax.numpy as jnp

    from stgx.models import MODELS as J_MODELS
    from stgx_torch.weights import to_jax_params

    name, norm, frames = MSGCN
    x, _, mask = T.batch(name, frames)
    jm = J_MODELS[name](**T.kwargs(name, norm, T.SP_ARCH))
    params = to_jax_params(T.build(name, norm, state, T.SP_ARCH))
    wmask = np.broadcast_to(mask[:, None], x.shape[:2]).astype(np.float32)
    return np.asarray(jm.apply(params, jnp.asarray(x), mask=jnp.asarray(wmask)))


@pytest.mark.parametrize("case,layout", PARAMS, ids=IDS)
def test_sp_step_matches_single_device(runs, case, layout):
    refs, outs = runs
    for rank, out in enumerate(outs[T.sp_world(layout)]):
        T.assert_step_matches(out[case, layout], refs[case], what=f"rank {rank}")


@pytest.mark.parametrize("case,layout", REMAT, ids=[f"{n}-{m}-W{f}-{lay}" for (n, m, f), lay in REMAT])
def test_remat_step_equals_the_stored_step(runs, case, layout):
    refs, outs = runs
    T.assert_remat_step(outs[T.sp_world(layout)], (case, layout), refs[case])


def test_msgcn_refinement_runs_on_each_data_ranks_block(runs):
    refs, outs = runs
    blocks = [out["refine"] for out in outs[2]]
    for _, shapes in blocks:  # 4 of the chunk's 8 windows, classes as channels
        assert shapes == [(1, 4, 1, T.CLASSES)] * len(T.SP_ARCH["ms-gcn"]["filters"])
    joined = np.concatenate([o for o, _ in blocks], axis=2)
    assert joined.shape == refs["refine"].shape
    np.testing.assert_allclose(joined, refs["refine"], atol=1e-5)


def _joined(outs, key):
    return np.concatenate([out["halo"][key] for out in outs], axis=1)


def test_halo_exchange_reaches_past_a_block(runs):
    _, outs = runs
    whole = _halo_whole()
    for out, ext in zip(outs[4], whole["ext"]):
        assert np.array_equal(out["halo"]["ext"], ext.numpy())
    np.testing.assert_allclose(_joined(outs[4], "gx"), whole["gx"].numpy(), atol=1e-6)


@pytest.mark.parametrize("op", ["conv1", "conv2", "shift1", "shift2", "pool"])
def test_seq_ops_on_uneven_blocks_join_to_the_whole(runs, op):
    _, outs = runs
    whole = _halo_whole()[op].numpy()
    stride = {"conv2": 2, "shift2": 2, "pool": 2}.get(op, 1)
    bounds = [-(-e // stride) for e in BOUNDS]
    for out, a, b in zip(outs[4], bounds[:-1], bounds[1:]):  # the strided split's blocks
        assert out["halo"][op].shape[1] == min(b, whole.shape[1]) - min(a, whole.shape[1])
    got = _joined(outs[4], op)
    if op.startswith("shift") or op == "pool":
        assert np.array_equal(got, whole)
    else:
        np.testing.assert_allclose(got, whole, atol=1e-6)
