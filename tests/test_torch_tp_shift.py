"""Tensor parallelism (the mesh's ``model`` axis) for Shift-GCN on gloo
ranks against the JAX ``Trainer`` on one device, the spatial shift's index
on a channel block, and a whole checkpoint of a tensor-parallel window
family.

* One ``Trainer.grad_step`` of the ``window`` kind (4 windows of 16
  frames, one masked out whole) at ``model`` 2 and 4 and on the ``data`` 2
  × ``model`` 2 mesh, LayerNorm and BatchNorm (:mod:`torch_tp_cases`):
  both temporal shifts run on each rank's channel block (the plain version
  here, the ``temporal_shift`` kernels on the card) and the whole feature
  masks and shifts are partial, summed over ``model``. The loss within
  ``rtol = 1e-5`` and every gradient, gathered whole, within
  ``atol = 1e-5``.
* The spatial block's reverse rotation on a channel block takes the block's
  columns of the whole-width index: at V = 7 and blocks of 8 or 4 channels
  every block gives the whole block's channels within ``1e-6`` (the 1×1
  products of a block and of the whole round alike but for the BLAS
  blocking), and at the blocks whose offset is not a multiple of V (8; 4,
  8, 12) the index built at the block's own width is off by more than 0.1.
* A Shift-GCN ``Trainer`` at ``model`` 2 (LayerNorm: under BatchNorm a bias
  before the norm trains on rounding noise) takes an Adam step and saves:
  the file holds the whole parameters and Adam moments, the one-process
  step's within ``1e-5``; restored at ``model`` 2 and saved again, and
  restored in one process and saved again, it is the same file bit for bit.

* With ``arch.remat`` at ``model`` 4 (BatchNorm) the step equals the
  stored step bit for bit: each unit's recompute gathers its channels and
  sums its statistics again, under the layout the unit ran under.

Each world size (2, 4) is one gloo session that runs all its cases,
started before the JAX references are computed.
"""

import os

import numpy as np
import pytest
import torch

import torch_tp_cases as T

NAMES = ("shift-gcn",)
CASES = T.cases(NAMES)
REMAT = ((("shift-gcn", "BatchNorm"), "model4"),)


def _trainer(mesh=None):
    from stgx_torch.parallel.loop import OptimizerConfig, Trainer
    from stgx_torch.utils import LOSS

    model = T.build("shift-gcn", "LayerNorm")
    return Trainer(model=model, kind="window", mesh=mesh, receptive_field=16,
                   loss=LOSS["shift-gcn"](np.ones(T.CLASSES, np.float32)),
                   opt=OptimizerConfig(learning_rate=1e-3, seed=0))


def _train_step(trainer):
    x, y, mask = (torch.tensor(a) for a in T.batch("shift-gcn"))
    trainer.grad_step(x, y, mask, T.DIVISOR)
    trainer._step()


def _checkpoint(mesh, out_dir):
    """Save after one step at ``model`` 2, restore into a fresh sharded
    trainer and save again; the two paths."""
    first = _trainer(mesh)
    _train_step(first)
    path = first.save(out_dir, 0)
    again = _trainer(mesh)
    assert again.restore(path) == 0
    return path, again.save(out_dir, 0, name="restored")


def _ranks(rank, world, states, out_dir):
    from stgx_torch.parallel.mesh import make_mesh

    out = T.ranks(rank, world, T.LAYOUTS, states, REMAT)
    if world == 2:
        out["checkpoint"] = _checkpoint(make_mesh(1, 1, 2), out_dir)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    states = T.states(NAMES)
    return T.sessions(_ranks, tmp_path_factory, states, states,
                      str(tmp_path_factory.mktemp("ckpt")))


@pytest.mark.parametrize("case", CASES, ids=[f"{n}-{m}" for n, m in CASES])
@pytest.mark.parametrize("layout", list(T.LAYOUTS))
def test_tp_step_matches_single_device(runs, layout, case):
    refs, outs = runs
    for rank, out in enumerate(outs[T.world(layout)]):
        T.assert_step_matches(out[case, layout], refs[case], what=f"rank {rank}")


@pytest.mark.parametrize("case,layout", REMAT, ids=[f"{n}-{m}-{lay}" for (n, m), lay in REMAT])
def test_remat_step_equals_the_stored_step(runs, case, layout):
    refs, outs = runs
    T.assert_remat_step(outs[T.world(layout)], (case, layout), refs[case])


@pytest.mark.parametrize("size", [2, 4])
def test_spatial_shift_block_takes_the_whole_index_columns(size):
    from stgx_torch.models.shiftgcn import SpatialShiftBlock
    from stgx_torch.ops.shift import spatial_shift_index
    from stgx_torch.parallel.mesh import Split

    cin, cout, width = 6, 16, 16 // size

    def block():
        b = SpatialShiftBlock(cin, cout, T.V, torch.Generator().manual_seed(0),
                              normalization="BatchNorm")
        T.perturb(b)
        return b

    whole = block()
    x0 = torch.tensor(np.random.default_rng(2).normal(size=(2, 5, T.V, cin)), dtype=torch.float32)
    with torch.no_grad():
        ref = whole(x0)
        offsets = []
        for i in range(size):
            part = block()  # this rank's block of every channel leaf; the mask whole
            for name, p in whole.named_parameters():
                if name != "feature_mask":
                    owner, _, leaf = name.rpartition(".")
                    setattr(part.get_submodule(owner), leaf,
                            torch.nn.Parameter(p[..., i * width:(i + 1) * width].clone()))
            part.channels = Split(size, i)
            want = ref[..., i * width:(i + 1) * width]
            np.testing.assert_allclose(part(x0).numpy(), want.numpy(), atol=1e-6, err_msg=i)
            if i * width % T.V:
                offsets.append(i * width)
                # the rotation built at the block's own width is off by the offset mod V
                part.channels = Split()
                part.src_out = spatial_shift_index(T.V, width, True)
                assert (part(x0) - want).abs().max() > 0.1, i
    assert offsets  # some block starts off a multiple of V


def test_tp_window_checkpoint_is_whole_and_restores_bit_for_bit(runs, tmp_path):
    path, again = runs[1][2][0]["checkpoint"]
    saved = torch.load(path, weights_only=True)
    assert torch.equal(torch.tensor(0), torch.tensor(saved["epoch"]))
    one = _trainer()
    _train_step(one)
    ref = torch.load(one.save(str(tmp_path), 0), weights_only=True)
    assert set(saved["model"]) == set(ref["model"])
    for k, v in saved["model"].items():  # whole, the one-process step's within 1e-5
        np.testing.assert_allclose(v.numpy(), ref["model"][k].numpy(), atol=1e-5, err_msg=k)
    for i, st in saved["optimizer"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert st[k].shape == ref["optimizer"]["state"][i][k].shape, (i, k)
            np.testing.assert_allclose(st[k].numpy(), ref["optimizer"]["state"][i][k].numpy(),
                                       atol=1e-5, err_msg=f"{i} {k}")
    at1 = _trainer()  # the model-2 file restored in one process
    at1.restore(path)
    for other in (torch.load(again, weights_only=True),
                  torch.load(at1.save(str(tmp_path), 0, name="at1"), weights_only=True)):
        for k, v in saved["model"].items():
            assert torch.equal(v, other["model"][k]), k
        for i, st in saved["optimizer"]["state"].items():
            for k, v in st.items():
                assert torch.equal(v, other["optimizer"]["state"][i][k]), (i, k)
    assert os.path.basename(path) == "epoch-0"
