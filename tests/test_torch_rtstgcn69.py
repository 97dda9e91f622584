"""RT-ST-GCN at Γ = 69 (``configs/pku-mmd/as_is/rtstgcn_69.json``, narrowed)
against the JAX model on the CPU.

At Γ = 69 every layer's halo, (K − 1)·s = 68 (66 at s = 2), is past the
fused kernel's dispatch limit, so each layer runs the graph conv and the
window-sum apart, forward and backward, with 69 (34) taps an output. Three
layers, channels ≤ 16, L = 100 (longer than one halo, shorter than two),
stride 2 in the middle layer; the port's ops run their plain versions, as a
CPU tensor takes them. Tolerances as ``tests/test_torch_rtstgcn.py`` (a
whole model's logits, 1e-4 of max(1, max|ref|)) and
``tests/test_torch_train.py`` (a ``Trainer`` step's gradients, 1e-5 of
max(1, max|ref|), each parameter at its own scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stgx.graph import load_skeleton
from stgx.models.rtstgcn import RtStgcn as JRtStgcn
from stgx.ops import rt_fused as j_rtf
from stgx.parallel.loop import OptimizerConfig as JOptimizerConfig
from stgx.parallel.loop import Trainer as JTrainer
from stgx.utils import LOSS as J_LOSS
from stgx_torch.models.rtstgcn import RtStgcn
from stgx_torch.ops import rt_fused
from stgx_torch.parallel.loop import OptimizerConfig, Trainer
from stgx_torch.parallel.segments import pad_to_bucket
from stgx_torch.utils import LOSS
from stgx_torch.weights import from_jax_params

NARROW_69 = dict(
    num_classes=5, in_feat=3, graph=load_skeleton("pku-mmd"), kernel=69,
    in_ch=(8, 8, 16), out_ch=(8, 16, 16), stride=(1, 2, 1),
    residual=(1, 1, 0), dropout=(0.0, 0.0, 0.0),
)
L = 100


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=np.shape(a)).astype(np.float32),
        params,
    )


@pytest.mark.parametrize("fused", [False, True])
def test_batch_forward_matches_jax_at_gamma_69(monkeypatch, fused):
    """With the fused core asked for, both packages fall back to the unfused
    chain at this halo: the same logits either way."""
    monkeypatch.setattr(j_rtf, "_INTERPRET", True)
    monkeypatch.setattr(j_rtf, "_ENABLED", fused)
    monkeypatch.setattr(rt_fused, "_ENABLED", fused)
    jm = JRtStgcn(normalization="BatchNorm", **NARROW_69)
    x = np.random.default_rng(3).normal(size=(2, L, 25, 3)).astype(np.float32)
    params = _perturbed(jm.init(jax.random.PRNGKey(3), jnp.asarray(x)), 3)
    tm = RtStgcn(normalization="BatchNorm", **NARROW_69, device="cpu")
    tm.load_state_dict(from_jax_params(params, tm), strict=True)
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.tensor(x)).numpy()
    assert got.shape == (2, L, 5)
    assert np.abs(got - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max())


def test_trainer_first_step_gradients_match_jax_at_gamma_69():
    """One ``Trainer`` grad step of two stacked trials (one padded in its
    bucket) on both sides from the same parameters: every parameter's
    gradient."""
    rng = np.random.default_rng(5)
    trials = [(rng.normal(size=(l, 25, 3)).astype(np.float32),
               rng.integers(0, 5, size=l)) for l in (L, L - 23)]
    dist = np.arange(1, 6, dtype=np.float32)
    jm = JRtStgcn(normalization="BatchNorm", **NARROW_69)
    jt = JTrainer(model=jm, kind="frame", loss=J_LOSS["rt-st-gcn"](dist),
                  opt=JOptimizerConfig(learning_rate=1e-3, batch_size=2), bucket=128,
                  trial_batch=2)
    params, _ = jt.init(trials[0][0][None])
    params = jax.tree.map(jnp.asarray, _perturbed(params, 5))
    prepared = [jt._prepare(*t) for t in trials]
    xd, yd, md = (jnp.concatenate(parts) for parts in zip(*prepared))
    ref_grads = jt._grad_step_batched(xd.shape)(params, xd, yd, md, jnp.asarray([2.0, 2.0]),
                                               jax.random.PRNGKey(0), jnp.asarray(0.0))[0]

    tm = RtStgcn(normalization="BatchNorm", **NARROW_69, device="cpu")
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params), tm), strict=True)
    tt = Trainer(model=tm, kind="frame", loss=LOSS["rt-st-gcn"](dist),
                 opt=OptimizerConfig(learning_rate=1e-3, batch_size=2), bucket=128,
                 trial_batch=2)
    x, y, m = tt.stack_trials(*zip(*(pad_to_bucket(*t, 128) for t in trials)))
    tt.grad_step(x, y, m, [2.0, 2.0])
    ref = from_jax_params(jax.tree.map(np.asarray, ref_grads), tm)
    for name, p in tm.named_parameters():
        r = ref[name].numpy()
        assert np.abs(p.grad.numpy() - r).max() <= 1e-5 * max(1.0, np.abs(r).max()), name
