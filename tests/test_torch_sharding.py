"""Data- and sequence-parallel training steps of the port on gloo ranks
against the JAX package on one device — the counterpart of
``tests/test_sharding.py``, whose meshes are 8 virtual devices.

One step of the port's ``Trainer`` (``grad_step``: forward, loss and
backward of a batch of 2 trials of 64 frames, one with 6 padding frames)
runs under a mesh of ``data=2``, ``seq=2`` (2 ranks) and ``data=2 x
seq=2`` (4 ranks); its loss and its gradients, summed over the ranks, are
held against ``jax.value_and_grad`` of the JAX model and loss on the whole
batch, within ``rtol = atol = 1e-5``. The models: RT-ST-GCN (Γ = 3, and
Γ = 5 with a stride-2 layer) and CoST-GCN (Γ = 5, dilation 2), each with
BatchNorm, whose statistics span the ranks, and with LayerNorm. Under
``seq`` the frame-axis ops run on halo-extended blocks and the smoothing
MSE takes each block's first ``p_{t−1}`` from the previous rank. A
window-kind ``Trainer`` under ``seq > 1`` is refused, naming ROADMAP.md's
queue 1 item 10.
"""

import numpy as np
import pytest
import torch

from test_torch_spawn import spawn

N, L, V, C_IN, CLASSES = 2, 64, 7, 6, 5
RT = dict(kernel=3, in_ch=(8, 16), out_ch=(16, 16), stride=(1, 1), residual=(1, 1),
          dropout=(0.0, 0.0))
RT_STRIDED = dict(kernel=5, in_ch=(8, 8, 16), out_ch=(8, 16, 16), stride=(1, 2, 1),
                  residual=(1, 1, 1), dropout=(0.0, 0.0, 0.0))
COST = dict(kernel=5, in_ch=(8, 16), out_ch=(16, 16), dilation=(1, 2), residual=(1, 1),
            dropout=(0.0, 0.0))
CASES = {
    "rt-BatchNorm": ("rt-st-gcn", RT, "BatchNorm"),
    "rt-LayerNorm": ("rt-st-gcn", RT, "LayerNorm"),
    "rt-strided-BatchNorm": ("rt-st-gcn", RT_STRIDED, "BatchNorm"),
    "rt-strided-LayerNorm": ("rt-st-gcn", RT_STRIDED, "LayerNorm"),
    "cost-BatchNorm": ("co-st-gcn", COST, "BatchNorm"),
    "cost-LayerNorm": ("co-st-gcn", COST, "LayerNorm"),
}
LAYOUTS = {"data": (2, 1), "seq": (1, 2), "data-seq": (2, 2)}


def _kwargs(case):
    from stgx_torch.graph import load_skeleton

    name, arch, norm = CASES[case]
    return name, dict(num_classes=CLASSES, in_feat=C_IN, graph=load_skeleton("imu_fogit_ABCD"),
                      normalization=norm, **arch)


def _batch():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, L, V, C_IN)).astype(np.float32)
    y = rng.integers(0, CLASSES, size=(N, L)).astype(np.int64)
    mask = np.ones((N, L), np.float32)
    mask[1, L - 6:] = 0.0  # a trial bucket-padded by 6 frames
    return x, y, mask


def _port_step(case, params, mesh):
    """Loss and summed gradients of one port ``grad_step`` under ``mesh``."""
    from stgx_torch.models import MODELS
    from stgx_torch.parallel.loop import OptimizerConfig, Trainer
    from stgx_torch.utils import LOSS
    from stgx_torch.weights import from_jax_params

    name, kw = _kwargs(case)
    model = MODELS[name](**kw, device="cpu")
    model.load_state_dict(from_jax_params(params, model), strict=True)
    trainer = Trainer(model=model, kind="frame", loss=LOSS[name](np.ones(CLASSES, np.float32)),
                      opt=OptimizerConfig(), mesh=mesh)
    x, y, mask = (torch.tensor(a) for a in _batch())
    ce, mse, *_ = trainer.grad_step(x, y, mask, 1.0)
    return float(ce) + float(mse), {k: p.grad.numpy() for k, p in model.named_parameters()}


def _ranks(rank, world, params):
    from stgx_torch.parallel.mesh import make_mesh

    out = {}
    for layout, (data, seq) in LAYOUTS.items():
        if data * seq != world:
            continue
        mesh = make_mesh(data=data, seq=seq)
        for case in CASES:
            out[case, layout] = _port_step(case, params[case], mesh)
        if seq > 1:
            out["refusal", layout] = _window_kind_under_seq(mesh)
    return out if rank == 0 else None


def _window_kind_under_seq(mesh):
    """What a window-kind Trainer with ``remat`` under ``seq > 1`` raises:
    "no error" now that ``seq`` (``tests/test_torch_sp_window.py``) and
    ``remat`` under a mesh (queue 1 item 10.4) are both ported."""
    from stgx_torch.graph import load_skeleton
    from stgx_torch.models import Stgcn
    from stgx_torch.parallel.loop import OptimizerConfig, Trainer
    from stgx_torch.utils import LOSS

    model = Stgcn(num_classes=CLASSES, in_feat=C_IN, graph=load_skeleton("imu_fogit_ABCD"),
                  kernel=3, in_ch=(8,), out_ch=(8,), stride=(1,), residual=(1,),
                  dropout=(0.0,), remat=True, device="cpu")
    try:
        Trainer(model=model, kind="window", loss=LOSS["st-gcn"](np.ones(CLASSES, np.float32)),
                opt=OptimizerConfig(), mesh=mesh)
    except NotImplementedError as e:
        return str(e)
    return "no error"


@pytest.fixture(scope="module")
def jax_ref():
    """Parameters and the one-device loss and gradients of each case."""
    import jax
    import jax.numpy as jnp

    from stgx.models import MODELS as J_MODELS
    from stgx.utils import LOSS as J_LOSS
    from stgx_torch.models import MODELS
    from stgx_torch.weights import from_jax_params

    x, y, mask = (jnp.asarray(a) for a in _batch())
    ref = {}
    for case in CASES:
        name, kw = _kwargs(case)
        jm = J_MODELS[name](**kw)
        loss = J_LOSS[name](np.ones(CLASSES, np.float32))
        params = jm.init(jax.random.PRNGKey(1), x)

        def f(p, jm=jm, loss=loss):
            ce, mse = loss(jm.apply(p, x, train=True, mask=mask), y, mask)
            return ce + mse

        value, grads = jax.jit(jax.value_and_grad(f))(params)
        tm = MODELS[name](**kw, device="cpu")
        ref[case] = (jax.tree.map(np.asarray, params), float(value),
                     {k: v.numpy() for k, v in
                      from_jax_params(jax.tree.map(np.asarray, grads), tm).items()})
    return ref


@pytest.fixture(scope="module")
def sharded(jax_ref, tmp_path_factory):
    """The port's steps by (case, layout); one gloo session a world size,
    started at its first use."""
    params = {case: jax_ref[case][0] for case in CASES}
    runs = {}

    def get(layout):
        world = LAYOUTS[layout][0] * LAYOUTS[layout][1]
        if world not in runs:
            runs[world] = spawn(_ranks, world, tmp_path_factory.mktemp("sharding"),
                                params)[0]
        return runs[world]

    return get


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sharded_step_matches_single_device(sharded, jax_ref, layout, case):
    loss, grads = sharded(layout)[case, layout]
    _, ref_loss, ref_grads = jax_ref[case]
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    assert set(grads) == set(ref_grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g, ref_grads[k], rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("layout", ["seq", "data-seq"])
def test_seq_for_the_window_kind_is_refused(sharded, layout):
    """Refused until ``remat`` under a mesh was ported (queue 1 item 10.4):
    a window-kind Trainer with ``remat`` under ``seq`` now builds."""
    message = sharded(layout)["refusal", layout]
    assert message == "no error", message
