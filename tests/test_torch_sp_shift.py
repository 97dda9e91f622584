"""Sequence parallelism (the mesh's ``seq`` axis) for Shift-GCN and the
Shift-GCN++ teacher, on gloo ranks against the JAX ``Trainer`` on one
device: their temporal shifts (the ``temporal_shift`` and
``temporal_shift_bwd`` kernels on the card, their plain versions here)
launched on each rank's block extended by K = 8 frames back and 9 ahead.

One ``Trainer.grad_step`` of 4 windows (one masked out whole) whose W
frames are split over ``seq`` (:mod:`torch_tp_cases`, ``SP_*``), at
``seq`` 2, ``seq`` 4 and ``data`` 2 × ``seq`` 2, and Shift-GCN at ``seq`` 2
× ``model`` 2 too, LayerNorm and BatchNorm:

* Shift-GCN (3 units, strides 1, 2, 2) at W = 50: blocks of 25, 13/12
  and 7/6 at ``seq`` 2, the shift's halos past a block, the strided shift
  and the strided residual at each block's global phase, the head's mean
  summed over ``seq``; W = 50 falls back to replicas at ``seq`` 4. The
  loss within ``rtol = 1e-5``, every gradient within ``atol = 1e-5``.
* The teacher (10 units, strides 2 at units 4 and 7, the input pooled by 2
  and 4 concatenated back) at W = 52: blocks of 26, 13/13 and 7/6 at
  ``seq`` 2, of 13, 7/6/7/6 and 4/3/3/3 at ``seq`` 4, where the pooled pair
  (12, 13) and others straddle two blocks and a shift's 9-frame halo spans
  three. Gradients within ``atol = 2e-4, rtol = 2e-3``, the teacher's
  bounds in ``tests/test_torch_tp_plus.py``.

With ``arch.remat`` (Shift-GCN, BatchNorm, W = 50 at ``seq`` 2: blocks of
25, then 13/12 and 7/6 after the strides) each unit's recompute exchanges
its halos again at the bounds of the layout the unit ran under; the step
equals the stored step bit for bit.

Each world size (2, 4) is one gloo session that runs all its cases,
started before the JAX references are computed.
"""

import pytest

import torch_tp_cases as T

NAMES = ("shift-gcn", "shift-gcn++-teacher")
PARAMS, IDS = T.sp_params(NAMES)
TOL = {"shift-gcn++-teacher": dict(atol=2e-4, rtol=2e-3)}
REMAT = ((("shift-gcn", "BatchNorm", 50), "seq2"),)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return T.sp_sessions(tmp_path_factory, T.sp_states(NAMES),
                         {**T.SP_LAYOUTS, **T.SP_TP_LAYOUTS}, REMAT)


@pytest.mark.parametrize("case,layout", PARAMS, ids=IDS)
def test_sp_step_matches_single_device(runs, case, layout):
    refs, outs = runs
    tol = TOL.get(case[0], {})
    for rank, out in enumerate(outs[T.sp_world(layout)]):
        T.assert_step_matches(out[case, layout], refs[case], what=f"rank {rank}", **tol)


@pytest.mark.parametrize("case,layout", REMAT, ids=[f"{n}-{m}-W{f}-{lay}" for (n, m, f), lay in REMAT])
def test_remat_step_equals_the_stored_step(runs, case, layout):
    refs, outs = runs
    T.assert_remat_step(outs[T.sp_world(layout)], (case, layout), refs[case],
                        **TOL.get(case[0], {}))
