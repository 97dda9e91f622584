"""The cases the tensor-parallel tests of the window, multi-stage and shift
families share (``tests/test_torch_tp_window.py``,
``tests/test_torch_tp_shift.py``, ``tests/test_torch_tp_plus.py``): small
models of every family the mesh's ``model`` axis now shards, their batch,
one port ``Trainer.grad_step`` under a mesh on gloo ranks, and the JAX
``Trainer``'s one-device step on the same parameters.

Each family is built at widths that divide by 4 (so ``model`` 2 and 4 cut
every tensor-parallel layer) on the 7-joint ``imu_fogit_ABCD`` skeleton,
from seed 0, every parameter moved off its init with numpy (the temporal
shifts spread over ±5 frames; Shift-GCN++'s teacher taps pinned, see
:func:`perturb`). The port's state goes to the JAX package through
``to_jax_params``. JAX is imported inside the functions that need it: the
gloo ranks import this module and must not load it.
"""

import math

import numpy as np
import torch

V, C_IN, CLASSES = 7, 6, 5
SKELETON = "imu_fogit_ABCD"
DIVISOR = 2.0
EPOCH = 3.0  # reaches Shift-GCN++'s gates (τ = 28.55)
LAYOUTS = {"model2": (1, 1, 2), "model4": (1, 1, 4), "data2-model2": (2, 1, 2)}
ST = dict(kernel=3, in_ch=(8, 8), out_ch=(8, 16), stride=(1, 2), residual=(1, 1),
          dropout=(0.0, 0.0))
ARCH = {
    "st-gcn": ST,
    "aa-gcn": ST,
    "ms-gcn": dict(ST, stages=1, filters=(8,), layers=(2,), refine_kernel=(3,),
                   refine_dropout=(0.0,)),
    "ms-tcn": dict(stages=2, filters=(8, 8), layers=(2, 2), kernel=(3, 3), dropout=(0.0, 0.0)),
    "shift-gcn": dict(in_ch=(C_IN, 8, 8), out_ch=(8, 8, 16), stride=(1, 1, 2),
                      residual=(0, 1, 1)),
    "shift-gcn++-teacher": dict(channels=(8,) * 4 + (16,) * 3 + (16,) * 3),
    "shift-gcn++": dict(c_mul=1),
}
KIND = {"st-gcn": "window", "aa-gcn": "window", "shift-gcn": "window",
        "shift-gcn++": "window", "shift-gcn++-teacher": "window", "ms-gcn": "window_ms",
        "ms-tcn": "frame_ms"}
WINDOW = {"ms-gcn": 12}  # frames a window; 16 for the other window families


def norms(name):
    return ("LayerNorm",) if name == "ms-tcn" else ("LayerNorm", "BatchNorm")


def cases(names):
    return [(name, norm) for name in names for norm in norms(name)]


def kwargs(name, norm, arch=None):
    """The model's keyword arguments: :data:`ARCH`'s widths, or ``arch``'s."""
    from stgx_torch.graph import load_skeleton

    kw = dict(num_classes=CLASSES, in_feat=C_IN, **(ARCH if arch is None else arch)[name])
    if name != "ms-tcn":
        kw.update(graph=load_skeleton(SKELETON), normalization=norm)
    return kw


def window(name, frames=None):
    """The frames of a window (of a trial for MS-TCN): ``frames``, or
    :data:`WINDOW`'s."""
    return WINDOW.get(name, 16) if frames is None else frames


def batch(name, frames=None):
    """``(x, y, mask)`` in numpy: 4 windows (one masked out whole) for the
    window kinds, 8 for MS-GCN's, 2 trials of 16 frames (one padded by a
    quarter) for MS-TCN's; ``frames`` a window (a trial), if given."""
    rng = np.random.default_rng(0)
    length = window(name, frames)
    if KIND[name] == "frame_ms":
        x = rng.normal(size=(2, length, V, C_IN)).astype(np.float32)
        y = rng.integers(0, CLASSES, size=(2, length)).astype(np.int64)
        mask = np.ones((2, length), np.float32)
        mask[1, length - length // 4:] = 0.0
        return x, y, mask
    n = 8 if name == "ms-gcn" else 4
    x = rng.normal(size=(n, length, V, C_IN)).astype(np.float32)
    y = rng.integers(0, CLASSES, size=(n,)).astype(np.int64)
    mask = np.ones((n,), np.float32)
    mask[-1] = 0.0
    return x, y, mask


def perturb(model, seed=3):
    """Every parameter moved off its init, in place: temporal shifts
    U(−5, 5), the rest by 0.1·N(0, 1). In a Shift-GCN++ wrapper the
    norms that end the teacher's tap units get scale 0 (each tap is then a
    constant a channel that both packages form bit for bit: the
    distillation loss jumps where a tap crosses a margin, and a tap formed
    in another order would cross it elsewhere), and the tap's output norm
    a bias of N(0, 3²), so the margins take both branches."""
    rng = np.random.default_rng(seed)
    pinned = set()
    if hasattr(model, "teacher"):
        for u in model.teacher.feature_taps:
            pinned |= {f"teacher.units.{u}.temporal.out_norm.scale",
                       f"teacher.units.{u}.res_norm.scale"}
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in pinned:
                p.zero_()
            elif "shift_" in name:
                p.copy_(torch.tensor(rng.uniform(-5.0, 5.0, size=p.shape), dtype=p.dtype))
            elif name.startswith("teacher.units.") and ".temporal.out_norm.bias" in name:
                p.copy_(torch.tensor(rng.normal(0.0, 3.0, size=p.shape), dtype=p.dtype))
            else:
                p.add_(torch.tensor(0.1 * rng.normal(size=p.shape), dtype=p.dtype))


def build(name, norm, state=None, arch=None, remat=False):
    """The port model on the CPU: from seed 0 and :func:`perturb`, or with
    ``state`` (``{name: numpy array}``) loaded; ``arch`` as :func:`kwargs`;
    ``remat`` its ``arch.remat``."""
    from stgx_torch.models import MODELS

    model = MODELS[name](**kwargs(name, norm, arch), remat=remat, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    if state is None:
        perturb(model)
    else:
        model.load_state_dict({k: torch.tensor(v) for k, v in state.items()}, strict=True)
    return model


def state_of(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def port_step(name, norm, state, mesh, arch=None, frames=None, dtype=torch.float32,
              remat=False):
    """Loss (ce + mse) and every gradient, gathered whole, of one port
    ``grad_step`` under ``mesh`` (None: one process); ``arch`` and
    ``frames`` as :func:`kwargs` and :func:`batch`; the model and the
    batch in ``dtype``; ``remat`` the model's ``arch.remat``."""
    from stgx_torch.parallel.loop import MODEL_EPOCH_ARG, OptimizerConfig, Trainer
    from stgx_torch.parallel.tp import gather_state
    from stgx_torch.utils import LOSS

    model = build(name, norm, state, arch, remat).to(dtype)
    trainer = Trainer(model=model, kind=KIND[name], loss=LOSS[name](np.ones(CLASSES, np.float32)),
                      opt=OptimizerConfig(), mesh=mesh, pass_epoch=name in MODEL_EPOCH_ARG,
                      receptive_field=window(name, frames))
    x, y, mask = (torch.tensor(a) for a in batch(name, frames))
    ce, mse, *_ = trainer.grad_step(x.to(dtype), y, mask, DIVISOR,
                                    torch.Generator().manual_seed(5),
                                    EPOCH)
    grads = gather_state(model, {k: torch.zeros_like(p) if p.grad is None else p.grad
                                 for k, p in model.named_parameters()})
    return float(ce) + float(mse), {k: g.numpy() for k, g in grads.items()}


def ranks(rank, world, layouts, states, remat=()):
    """Every case of ``states`` (``{(name, norm): state}``) at every layout
    of ``layouts`` that spans ``world`` ranks; each ``(case, layout)`` of
    ``remat`` also with ``arch.remat`` (under the key ``(case, layout,
    "remat")``)."""
    from stgx_torch.parallel.mesh import make_mesh

    out = {}
    for layout, shape in layouts.items():
        if math.prod(shape) != world:
            continue
        mesh = make_mesh(*shape)
        for case, state in states.items():
            out[case, layout] = port_step(*case, state, mesh)
            if (case, layout) in remat:
                out[case, layout, "remat"] = port_step(*case, state, mesh, remat=True)
    return out


def jax_step(name, norm, model, arch=None, frames=None):
    """The JAX ``Trainer``'s one-device step (``_grad_step``) on ``model``'s
    parameters and :func:`batch`: loss (ce + mse) and every gradient under
    the port's names; ``arch`` and ``frames`` as :func:`port_step`."""
    import jax
    import jax.numpy as jnp

    from stgx.models import MODELS as J_MODELS
    from stgx.parallel.loop import OptimizerConfig as JOptimizerConfig
    from stgx.parallel.loop import Trainer as JTrainer
    from stgx.utils import LOSS as J_LOSS
    from stgx_torch.parallel.loop import MODEL_EPOCH_ARG
    from stgx_torch.weights import from_jax_params, to_jax_params

    jt = JTrainer(model=J_MODELS[name](**kwargs(name, norm, arch)), kind=KIND[name],
                  loss=J_LOSS[name](np.ones(CLASSES, np.float32)), opt=JOptimizerConfig(),
                  pass_epoch=name in MODEL_EPOCH_ARG, receptive_field=window(name, frames))
    params = jax.tree.map(jnp.asarray, to_jax_params(model))
    x, y, mask = (jnp.asarray(a) for a in batch(name, frames))
    grads, ce, mse, *_ = jt._grad_step(x.shape)(params, x, y, mask, DIVISOR,
                                                jax.random.PRNGKey(0), jnp.asarray(EPOCH))
    return float(ce) + float(mse), {k: v.numpy() for k, v in
                                    from_jax_params(jax.tree.map(np.asarray, grads),
                                                    model).items()}


def states(names):
    """``{case: port state}`` of every case of ``names``, from seed 0 and
    :func:`perturb`."""
    return {case: state_of(build(*case)) for case in cases(names)}


def references(states):
    """``{case: (loss, gradients)}``: the JAX ``Trainer``'s one-device step
    on each case's state."""
    return {case: jax_step(*case, build(*case, state)) for case, state in states.items()}


def sessions(fn, tmp_path_factory, states, *args):
    """``(references(states), {world: every rank's fn(rank, world, *args)})``
    with one gloo session a world size of :data:`LAYOUTS`: the sessions are
    started first and the JAX references computed while they run."""
    from test_torch_spawn import start

    worlds = sorted({math.prod(shape) for shape in LAYOUTS.values()})
    pending = {w: start(fn, w, tmp_path_factory.mktemp("tp"), *args, timeout=300)
               for w in worlds}
    refs = references(states)
    return refs, {w: results() for w, results in pending.items()}


def world(layout):
    return math.prod(LAYOUTS[layout])


def assert_remat_step(outs, key, ref, what="", **tol):
    """Every rank's ``arch.remat`` step of ``key`` (``(case, layout)``)
    equals its stored step bit for bit and matches the JAX step ``ref``
    within ``tol`` (:func:`assert_step_matches`)."""
    for rank, out in enumerate(outs):
        (loss, grads), (ref_loss, ref_grads) = out[(*key, "remat")], out[key]
        assert loss == ref_loss, f"{what} rank {rank}: loss {loss} != {ref_loss}"
        assert set(grads) == set(ref_grads)
        for k, g in grads.items():
            np.testing.assert_array_equal(g, ref_grads[k], err_msg=f"{what} rank {rank} {k}")
        assert_step_matches(out[(*key, "remat")], ref, what=f"{what} rank {rank}", **tol)


def assert_step_matches(got, ref, atol=1e-5, rtol=0.0, what=""):
    """The loss within ``rtol = 1e-5`` and each gradient within ``atol`` and
    ``rtol``."""
    loss, grads = got
    np.testing.assert_allclose(loss, ref[0], rtol=1e-5, err_msg=f"{what} loss")
    assert set(grads) == set(ref[1])
    for k, g in grads.items():
        np.testing.assert_allclose(g, ref[1][k], atol=atol, rtol=rtol, err_msg=f"{what} {k}")


# -- sequence parallelism (the mesh's ``seq`` axis) ---------------------------------

SP_LAYOUTS = {"seq2": (1, 2, 1), "seq4": (1, 4, 1), "data2-seq2": (2, 2, 1)}
SP_TP_LAYOUTS = {"seq2-model2": (1, 2, 2)}
SP_TP_NAMES = ("st-gcn", "shift-gcn")  # the families held at seq 2 × model 2
# widths whose frame blocks come out uneven after the strides and whose
# halos reach past a block: Γ = 9 (4 frames a side) after two strides, the
# refinements' dilations up to 8
_ST9 = dict(kernel=9, in_ch=(8, 8, 8), out_ch=(8, 8, 16), stride=(1, 2, 2),
            residual=(1, 1, 1), dropout=(0.0, 0.0, 0.0))
SP_ARCH = {
    "st-gcn": _ST9,
    "aa-gcn": _ST9,
    "ms-gcn": dict(_ST9, stages=1, filters=(8,), layers=(4,), refine_kernel=(3,),
                   refine_dropout=(0.0,)),
    "ms-tcn": dict(stages=2, filters=(8, 8), layers=(4, 4), kernel=(3, 3), dropout=(0.0, 0.0)),
    # three units, as ST-GCN's layers (a fourth unit of 16 channels at strides
    # 1, 2, 1, 2 left one BatchNorm pre-activation within fp32 rounding of its
    # ReLU's kink: the one-process port put it at −7.2e-7, float64 at +1.6e-8,
    # and its step moved 5.7e-3 from JAX's while the port in float64 was
    # 6.7e-7 from it)
    "shift-gcn": dict(in_ch=(C_IN, 8, 16), out_ch=(8, 16, 16), stride=(1, 2, 2),
                      residual=(0, 1, 1)),
    "shift-gcn++-teacher": ARCH["shift-gcn++-teacher"],
    "shift-gcn++": ARCH["shift-gcn++"],
}
# the frames of a window (an MS-TCN trial) for each family. W = 50 splits at
# seq 2 in blocks of 25, which the strides leave 13/12 and 7/6, and falls
# back at seq 4 (50 % 4 ≠ 0) to replicas, as the JAX Trainer's _shard does.
# W = 52 splits at seq 4 too, in blocks of 13 that the strides leave
# 7/6/7/6 and 4/3/3/3 (Γ = 9's 4-frame halo reaches past a 3-frame block;
# Shift-GCN++'s pooled pairs straddle the blocks, its shifts' 8 and 9-frame
# halos span up to three). MS-TCN's 16 frames give blocks of 4 at seq 4, which
# its dilation of 8 spans twice; MS-GCN's 8 windows give the refinement
# blocks of 4 at data 2.
SP_FRAMES = {"st-gcn": (50, 52), "aa-gcn": (50,), "shift-gcn": (50,), "ms-gcn": (50,),
             "ms-tcn": (16,), "shift-gcn++-teacher": (52,), "shift-gcn++": (52,)}


def sp_cases(names, frames=None):
    """``(name, norm, frames)`` of every family of ``names``, its windows
    those of ``frames`` (``{name or (name, norm): windows}``) or
    :data:`SP_FRAMES`."""
    frames = SP_FRAMES if frames is None else {**SP_FRAMES, **frames}
    return [(name, norm, f) for name, norm in cases(names)
            for f in frames.get((name, norm), frames[name])]


def sp_states(names, frames=None):
    """``{case: port state}`` of :func:`sp_cases`, from seed 0 and :func:`perturb`."""
    return {case: state_of(build(*case[:2], arch=SP_ARCH)) for case in sp_cases(names, frames)}


def sp_ranks(rank, world, layouts, states, dtype=torch.float32, remat=()):
    """Every case of ``states`` (``{(name, norm, frames): state}``) at every
    layout of ``layouts`` that spans ``world`` ranks (a ``model`` axis for
    :data:`SP_TP_NAMES` only), its step in ``dtype``; each ``(case,
    layout)`` of ``remat`` also with ``arch.remat``, as :func:`ranks`."""
    from stgx_torch.parallel.mesh import make_mesh

    out = {}
    for layout, shape in layouts.items():
        if math.prod(shape) != world:
            continue
        mesh = make_mesh(*shape)
        for case, state in states.items():
            if shape[2] == 1 or case[0] in SP_TP_NAMES:
                for key in (False, True) if (case, layout) in remat else (False,):
                    out[(case, layout, "remat") if key else (case, layout)] = port_step(
                        *case[:2], state, mesh, SP_ARCH, case[2], dtype, remat=key)
    return out


def sp_start(tmp_path_factory, states, layouts, dtype=torch.float32, remat=()):
    """Start one gloo session a world size of ``layouts`` running
    :func:`sp_ranks`; returns ``{world: wait for its ranks' results}``."""
    from test_torch_spawn import start

    worlds = sorted({math.prod(shape) for shape in layouts.values()})
    return {w: start(sp_ranks, w, tmp_path_factory.mktemp("sp"), layouts, states, dtype,
                     remat, timeout=400) for w in worlds}


def sp_references(states):
    """The JAX ``Trainer``'s one-device step on each case of ``states``."""
    return {case: jax_step(*case[:2], build(*case[:2], state, SP_ARCH), SP_ARCH, case[2])
            for case, state in states.items()}


def sp_sessions(tmp_path_factory, states, layouts, remat=()):
    """``(JAX references, {world: every rank's sp_ranks})`` of the cases of
    ``states`` at ``layouts`` (``remat`` as :func:`sp_ranks`): the gloo
    sessions started first, the references computed while they run."""
    pending = sp_start(tmp_path_factory, states, layouts, remat=remat)
    refs = sp_references(states)
    return refs, {w: results() for w, results in pending.items()}


def sp_world(layout):
    return math.prod({**SP_LAYOUTS, **SP_TP_LAYOUTS}[layout])


def sp_params(names):
    """``(case, layout)`` of every SP test of ``names``, and their ids."""
    params = [(case, layout) for case in sp_cases(names)
              for layout in (*SP_LAYOUTS, *(SP_TP_LAYOUTS if case[0] in SP_TP_NAMES else ()))]
    return params, [f"{n}-{m}-W{f}-{layout}" for (n, m, f), layout in params]
