"""Sequence parallelism (the mesh's ``seq`` axis) for the port's ``window``
kind: ST-GCN and AA-GCN (their graph convs through ``gcn_core`` /
``gcn_grads``' plain versions here), on gloo ranks against the JAX
``Trainer`` on one device; and the two-card gradient check of
``chip_smoke.py`` in its repaired form, on gloo ranks.

* One ``Trainer.grad_step`` of 4 windows (one masked out whole) whose W
  frames are split over ``seq`` (:mod:`torch_tp_cases`, ``SP_*``: three
  layers, Γ = 9, strides 1, 2, 2), at ``seq`` 2, ``seq`` 4 and ``data`` 2 ×
  ``seq`` 2, and ST-GCN at ``seq`` 2 × ``model`` 2 too, LayerNorm and
  BatchNorm: the loss within ``rtol = 1e-5`` and every gradient, gathered
  whole, within ``atol = 1e-5`` of the JAX step. The windows show the hard
  parts: W = 50 splits in blocks of 25, which the strides leave 13/12 and
  7/6 (the temporal conv's taps, the strided residual and the decimated mask
  at each block's global phase); at ``seq`` 4 W = 50 falls back to replicas,
  as the JAX ``Trainer``'s ``_shard`` leaves an axis it cannot split whole;
  W = 52 splits in blocks of 13, then 7/6/7/6 and 4/3/3/3, where Γ = 9's
  4-frame halo reaches past a block. The head's (L, V) mean and AA-GCN's
  attention scores are summed over ``seq``; each ``seq`` rank's logits are
  whole and carry 1/seq of the loss.
* With dropout (0.3 in every layer) at ``seq`` 2 and W = 50 the step equals
  the port's one-process step within ``1e-5``: every rank draws the whole
  batch's mask and keeps its block, uneven after the strides.
* The two-card check (``chip_smoke.multi_rank_vs_one``): RT₉'s BatchNorm
  step (``chip_smoke._rt_step``, 2 × 128 frames) at ``seq`` 2 over two
  gloo ranks against one rank, held as :func:`chip_smoke.grads_held` holds
  it: every gradient within ``TOL_MULTI_RANK`` (5e-4) of the step's largest.
  It reads 7.9e-5 there, at ``layers.6.res_kernel``; the one-rank step
  itself is 7.9e-5 from float64 and the two-rank one 7.5e-7, so the
  difference is the one-rank step's rounding. The per-leaf form it replaces
  (each leaf at its own scale, within 1e-5) reads 7.2e-4 at
  ``layers.6.res_kernel`` and 2.5e-4 at ``layers.3.gcn.bias``, the graph
  conv's bias before BatchNorm, whose gradient is rounding noise: it would
  refuse this correct step.

* ``arch.remat`` under ``seq`` (:data:`REMAT`: ST-GCN at W = 52 on
  ``seq`` 4, whose 4/3/3/3 blocks after the strides a 4-frame halo reaches
  past, at ``seq`` 2 × ``model`` 2, AA-GCN on ``data`` 2 × ``seq`` 2; the
  dropout step above; RT₉'s step of the two-card check): each layer's
  recompute runs under the layout the layer ran under, strided or not, and
  exchanges its halos and sums its statistics again. Every step equals its
  stored step bit for bit (and so the JAX step within the bounds above).
  Without the layout restore, the recompute run with no layout, as a CUDA
  backward on autograd's device thread would run it (ST-GCN, no stride, W =
  50 at ``seq`` 2): under LayerNorm it takes zero halos where the forward
  exchanged them, and its gradients are off by 9.4e-3 of the largest with
  no error; under BatchNorm it takes each rank's own statistics, which save
  tensors of other shapes, and ``torch.utils.checkpoint`` raises. So these
  cases catch the fault the restore guards against.

Each world size (2, 4) is one gloo session that runs all its cases,
started before the JAX references are computed.
"""

import numpy as np
import pytest
import torch

import torch_tp_cases as T

NAMES = ("st-gcn", "aa-gcn")
PARAMS, IDS = T.sp_params(NAMES)
DROPOUT_CASE = ("st-gcn", "BatchNorm", 50)
DROPOUT_ARCH = {**T.SP_ARCH, "st-gcn": dict(T.SP_ARCH["st-gcn"], dropout=(0.3, 0.3, 0.3))}
REMAT = ((("st-gcn", "BatchNorm", 52), "seq4"), (("st-gcn", "LayerNorm", 50), "seq2-model2"),
         (("aa-gcn", "LayerNorm", 50), "data2-seq2"))
UNSTRIDED_ARCH = {**T.SP_ARCH, "st-gcn": dict(T.SP_ARCH["st-gcn"], stride=(1, 1, 1))}


def _unrestored(states, mesh):
    """For each norm of ``states``, an unstrided ST-GCN at seq 2: its
    stored step's gradients, and what its remat step does with the recompute
    run under no layout (the layout ``checkpointed`` takes at the call read
    as unset): ``("raised", message)`` or ``("gradients", gradients)``."""
    from stgx_torch.models import _remat

    out = {}
    for norm, state in states.items():
        _, stored = T.port_step("st-gcn", norm, state, mesh, UNSTRIDED_ARCH, 50)
        taken = _remat.current_shards
        _remat.current_shards = lambda: None
        try:
            got = ("gradients", T.port_step("st-gcn", norm, state, mesh, UNSTRIDED_ARCH, 50,
                                             remat=True)[1])
        except Exception as e:  # every rank raises alike: nothing is left pending
            got = ("raised", f"{type(e).__name__}: {e}")
        finally:
            _remat.current_shards = taken
        out[norm] = stored, got
    return out


def _ranks(rank, world, layouts, states, dropout_state, unstrided_state):
    """The SP cases; at world 2 also the dropout step at seq 2 and RT₉'s
    step for the two-card check, each with and without remat, and the
    unrestored recompute."""
    import chip_smoke
    from stgx_torch.parallel.mesh import make_mesh

    out = T.sp_ranks(rank, world, layouts, states, remat=REMAT)
    if world == 2:
        mesh = make_mesh(1, 2, 1)
        name, norm, frames = DROPOUT_CASE
        for remat in (False, True):
            out["dropout", remat] = T.port_step(name, norm, dropout_state, mesh, DROPOUT_ARCH,
                                                frames, remat=remat)
            out["rt", remat] = {k: v.numpy() for k, v in
                                chip_smoke._rt_step(mesh, "cpu", remat).items()}
        out["unrestored"] = _unrestored(unstrided_state, mesh)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from test_torch_spawn import start

    states = T.sp_states(NAMES)
    dropout_state = T.state_of(T.build(*DROPOUT_CASE[:2], arch=DROPOUT_ARCH))
    unstrided_state = {norm: T.state_of(T.build("st-gcn", norm, arch=UNSTRIDED_ARCH))
                       for norm in ("LayerNorm", "BatchNorm")}
    layouts = {**T.SP_LAYOUTS, **T.SP_TP_LAYOUTS}
    pending = {w: start(_ranks, w, tmp_path_factory.mktemp("sp"), layouts, states,
                        dropout_state, unstrided_state, timeout=400) for w in (2, 4)}
    refs = T.sp_references(states)
    name, norm, frames = DROPOUT_CASE
    one = {"dropout": T.port_step(name, norm, dropout_state, None, DROPOUT_ARCH, frames)}
    return refs, one, {w: results() for w, results in pending.items()}


@pytest.mark.parametrize("case,layout", PARAMS, ids=IDS)
def test_sp_step_matches_single_device(runs, case, layout):
    refs, _, outs = runs
    for rank, out in enumerate(outs[T.sp_world(layout)]):  # every rank ends with the whole step
        T.assert_step_matches(out[case, layout], refs[case], what=f"rank {rank}")


def test_sp_dropout_draws_the_one_process_masks(runs):
    _, one, outs = runs
    for rank, out in enumerate(outs[2]):
        T.assert_step_matches(out["dropout", False], one["dropout"], what=f"rank {rank}")


def test_two_card_check_holds_a_batchnorm_rt_step_at_seq2(runs):
    import chip_smoke

    _, _, outs = runs
    ref = chip_smoke._rt_step(None, "cpu")
    got = {k: torch.tensor(v) for k, v in outs[2][0]["rt", False].items()}
    assert set(got) == set(ref)
    worst, leaf = chip_smoke.grads_held(got, ref)
    assert worst <= chip_smoke.TOL_MULTI_RANK, (worst, leaf)
    assert all(np.array_equal(outs[2][1]["rt", False][k], v)
               for k, v in outs[2][0]["rt", False].items())


@pytest.mark.parametrize("case,layout", REMAT, ids=[f"{n}-{m}-W{f}-{lay}" for (n, m, f), lay in REMAT])
def test_remat_step_equals_the_stored_step(runs, case, layout):
    refs, _, outs = runs
    T.assert_remat_step(outs[T.sp_world(layout)], (case, layout), refs[case])


@pytest.mark.parametrize("what", ["dropout", "rt"])
def test_remat_replays_dropout_and_the_two_card_step_at_seq2(runs, what):
    """The dropout step (masks from the epoch generator, replayed in each
    recompute on the strided blocks) and RT₉'s BatchNorm step of the
    two-card check, with remat, equal their stored steps bit for bit."""
    _, _, outs = runs
    for rank, out in enumerate(outs[2]):
        got, ref = out[what, True], out[what, False]
        if what == "dropout":
            assert got[0] == ref[0], f"rank {rank}: loss {got[0]} != {ref[0]}"
            got, ref = got[1], ref[1]
        assert set(got) == set(ref)
        for k, g in got.items():
            np.testing.assert_array_equal(g, ref[k], err_msg=f"rank {rank} {what} {k}")


@pytest.mark.parametrize("norm", ["LayerNorm", "BatchNorm"])
def test_remat_without_the_layout_restore_gives_other_gradients(runs, norm):
    """The recompute under no layout: under LayerNorm it takes zero halos
    where the forward exchanged them, and its gradients are off with no
    error (9.4e-3 of the largest here, against bits with the restore); under
    BatchNorm ``torch.utils.checkpoint`` raises, since the one-process
    statistics save tensors of other shapes than the forward's."""
    _, _, outs = runs
    for rank, out in enumerate(outs[2]):
        stored, (what, got) = out["unrestored"][norm]
        if norm == "BatchNorm":
            assert what == "raised" and "CheckpointError" in got, (rank, what, str(got)[:500])
            continue
        assert what == "gradients", (rank, got[:500])
        top = max(np.abs(g).max() for g in stored.values())
        worst = max(np.abs(got[k] - g).max() for k, g in stored.items())
        assert worst > 1e-3 * top, (rank, worst, top)
