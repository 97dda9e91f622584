"""Sequence parallelism (the mesh's ``seq`` axis) for the Shift-GCN++
distillation wrapper (``shift-gcn++``: the teacher under ``no_grad``, the
DY-SE student with the epoch, the connectors and the margin-ReLU loss) at
W = 52, where the frame blocks come out uneven, on gloo ranks.

One ``Trainer.grad_step`` of the ``window`` kind (4 windows, one masked
out whole; epoch 3; the teacher taps pinned, :mod:`torch_tp_cases`) at
``seq`` 2, ``seq`` 4 and ``data`` 2 × ``seq`` 2: blocks of 26 and 13, then
7/6/7/6 and 4/3/3/3 after the student's strides; the pooled pairs
straddle the blocks; both models' shifts on each rank's block extended by
its halos, the gates' window means summed over ``seq``, each rank's share
of the distillation loss over its frames. LayerNorm and BatchNorm.

At W = 52 the bounds that hold the wrapper against JAX
(``tests/test_torch_tp_plus.py``, which holds it under ``seq`` at W = 16:
``atol = 2e-4, rtol = 2e-3``, BatchNorm ``atol = 5e-4``) do not hold the
one-process port itself: the distillation sums grow with the window, the
gradients reach 4.9e3 (LayerNorm) and 3.9e3 (BatchNorm), and where they
cancel the one-process port is 1.29 (LayerNorm) and 4.8 (BatchNorm) times
the bound from JAX (the sharded steps alike), at most 6e-7 of the step's
largest gradient. So W = 52 is held in float64: the sharded step against
the port's one-process step, the loss within ``rtol = 1e-5`` and every
gradient within ``atol = 1e-9`` (1.5e-12 measured under BatchNorm).

Each world size (2, 4) is one gloo session that runs all its cases,
started before the one-process references are computed.
"""

import pytest
import torch

import torch_tp_cases as T

NAME = "shift-gcn++"
CASES = T.sp_cases((NAME,))  # W = 52


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    states = T.sp_states((NAME,))
    pending = T.sp_start(tmp_path_factory, states, T.SP_LAYOUTS, torch.float64)
    refs = {case: T.port_step(*case[:2], state, None, T.SP_ARCH, case[2], torch.float64)
            for case, state in states.items()}
    return refs, {w: results() for w, results in pending.items()}


@pytest.mark.parametrize("case", CASES, ids=[f"{m}-W{f}" for _, m, f in CASES])
@pytest.mark.parametrize("layout", list(T.SP_LAYOUTS))
def test_sp_step_matches_one_process_in_float64(runs, layout, case):
    refs, outs = runs
    for rank, out in enumerate(outs[T.sp_world(layout)]):
        T.assert_step_matches(out[case, layout], refs[case], what=f"rank {rank}", atol=1e-9)
