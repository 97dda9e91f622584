"""Tensor parallelism (the mesh's ``model`` axis) for Shift-GCN++: the
teacher (``shift-gcn++-teacher``, its 10 units with the input concatenated
back at each time scale) and the distillation wrapper (``shift-gcn++``: the
teacher under ``no_grad``, the DY-SE student with the epoch, the
connectors and the margin-ReLU loss), on gloo ranks.

One ``Trainer.grad_step`` of the ``window`` kind (4 windows of L = 16
frames, one masked out whole; epoch 3) at ``model`` 2 and 4 and on the
``data`` 2 × ``model`` 2 mesh (:mod:`torch_tp_cases`; the wrapper's teacher
taps pinned). The teacher's and the student's units are tensor-parallel,
the student's gates, feature masks and shifts partial, the connectors
whole; the wrapper's teacher gradients are zero on both sides. The loss
(ce + mse) within ``rtol = 1e-5``.

The reference: the JAX ``Trainer`` on one device, under both norms.
Gradients, gathered whole, within ``atol = 2e-4, rtol = 2e-3``
(``tests/test_ep.py``'s bounds, not ``tests/test_tp.py``'s 1e-5): the
teacher's BatchNorm gradients reach 4.6 and the one-device port is
7.1e-6 from JAX there (ten units of sums in another order), the LayerNorm
wrapper's 1.8e-4. The BatchNorm wrapper is held within ``atol = 5e-4,
rtol = 2e-3``, 2.5 times test_ep's ``atol``: the distillation loss sums
~10⁵ squared differences, its gradients reach 1.2e3, and where they
cancel (the connectors, the last unit's output-norm and residual biases)
sums in another order differ by ~3.5e-4. The two readings of that limit,
as the largest of ``|got − ref| / (2e-4 + 2e-3·|ref|)`` over every
gradient: the one-process port against JAX 1.72 (3.50e-4 at a connector
gradient of 1.7e-3), the sharded ranks against JAX 1.60–1.72 at every
layout (3.39e-4–3.50e-4), so the sharding adds nothing measurable; a
missed sum over ``model`` would move a gradient by a share of itself, far
above either.

The wrapper under sequence parallelism (the mesh's ``seq`` axis) at
``seq`` 2, ``seq`` 4 and ``data`` 2 × ``seq`` 2 shares these JAX
references: its 4 windows of 16 frames split in blocks of 8, 4 and 2 at
``seq`` 2 and of 4, 2 and 1 at ``seq`` 4, which the shifts' 8- and
9-frame halos span many times over (the shifts on each rank's extended
block, the pooled skips across block edges, the gates' window means summed
over ``seq``, each rank's share of the distillation loss), held within the
same bounds. W = 52, where the blocks come out uneven, is
``tests/test_torch_sp_plus.py``'s (in float64).

With ``arch.remat`` (the teacher's units; the wrapper's student units,
whose epoch argument the recompute gets again) the step equals the stored
step on the same mesh bit for bit (:data:`REMAT`), and so the JAX step
within the bounds above.

Each world size (2, 4) is one gloo session that runs all its cases,
started before the JAX references are computed, which run beside it.
"""

import pytest

import torch_tp_cases as T

NAMES = ("shift-gcn++-teacher", "shift-gcn++")
CASES = T.cases(NAMES)
TOL = {("shift-gcn++", "BatchNorm"): dict(atol=5e-4, rtol=2e-3)}
SP_FRAMES = {"shift-gcn++": (16,)}  # the TP cases' windows: the same JAX step
SP_CASES = T.sp_cases(("shift-gcn++",), SP_FRAMES)
REMAT = ((("shift-gcn++-teacher", "BatchNorm"), "data2-model2"),
         (("shift-gcn++", "LayerNorm"), "model2"))


def _ranks(rank, world, states, sp_states):
    out = T.ranks(rank, world, T.LAYOUTS, states, REMAT)
    out.update(T.sp_ranks(rank, world, T.SP_LAYOUTS, sp_states))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    states = T.states(NAMES)
    sp_states = T.sp_states(("shift-gcn++",), SP_FRAMES)
    return T.sessions(_ranks, tmp_path_factory, states, states, sp_states)


@pytest.mark.parametrize("case", CASES, ids=[f"{n}-{m}" for n, m in CASES])
@pytest.mark.parametrize("layout", list(T.LAYOUTS))
def test_tp_step_matches_single_device(runs, layout, case):
    refs, outs = runs
    tol = TOL.get(case, dict(atol=2e-4, rtol=2e-3))
    for rank, out in enumerate(outs[T.world(layout)]):
        T.assert_step_matches(out[case, layout], refs[case], what=f"rank {rank}", **tol)


@pytest.mark.parametrize("case", SP_CASES, ids=[f"{m}-W{f}" for _, m, f in SP_CASES])
@pytest.mark.parametrize("layout", list(T.SP_LAYOUTS))
def test_sp_step_matches_single_device(runs, layout, case):
    refs, outs = runs
    tol = TOL.get(case[:2], dict(atol=2e-4, rtol=2e-3))
    for rank, out in enumerate(outs[T.sp_world(layout)]):
        T.assert_step_matches(out[case, layout], refs[case[:2]], what=f"rank {rank}", **tol)


@pytest.mark.parametrize("case,layout", REMAT, ids=[f"{n}-{m}-{lay}" for (n, m), lay in REMAT])
def test_remat_step_equals_the_stored_step(runs, case, layout):
    refs, outs = runs
    tol = TOL.get(case, dict(atol=2e-4, rtol=2e-3))
    T.assert_remat_step(outs[T.world(layout)], (case, layout), refs[case], **tol)
