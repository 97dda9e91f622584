"""The port's reference-checkpoint mapping (``stgx_torch.utils.torch_import``)
against the JAX package's (``stgx.utils.torch_import``), on state dicts the
JAX package's own ``export_reference_state_dict`` builds from seeded,
perturbed JAX parameters (no checkpoint is downloaded).

* reference dict → the port's import gives the JAX import's tree, leaf for
  leaf and bit for bit; loaded into the port, its forward equals the JAX
  forward within 1e-5 · max(1, max|ref|) (fp32 sums in another order);
* the port's export → the JAX import gives the same tree back, exactly;
* the Adam moments of a reference checkpoint import as the JAX package
  imports them, exactly;
* a file that ``weights_only`` refuses fails, and families the port lacks
  raise.

BatchNorm and LayerNorm; layer 0 an identity residual, layer 1 a residual
1×1 conv, layer 2 none.
"""

import argparse
import pickle

import jax
import numpy as np
import pytest
import torch

from stgx.graph import load_skeleton
from stgx.models.rtstgcn import RtStgcn as JRtStgcn
from stgx.utils import torch_import as j_ti
from stgx_torch.models.rtstgcn import RtStgcn
from stgx_torch.utils import torch_import as ti
from stgx_torch.weights import from_jax_params, to_jax_params

SMALL = dict(num_classes=5, in_feat=3, graph=load_skeleton("pku-mmd"), kernel=9,
             in_ch=(8, 8, 16), out_ch=(8, 16, 16), stride=(1, 2, 1),
             residual=(1, 1, 0), dropout=(0.0, 0.0, 0.0))
NORMS = ["BatchNorm", "LayerNorm"]


def _models(normalization, seed=0):
    jm = JRtStgcn(**SMALL, normalization=normalization)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 24, 25, 3)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(seed), x)
    params = jax.tree.map(  # every leaf off its init value
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=np.shape(a)).astype(np.float32),
        params)
    tm = RtStgcn(**SMALL, normalization=normalization, device="cpu")
    return jm, params, tm, x


def _assert_same_tree(got, ref):
    gl = jax.tree_util.tree_leaves_with_path(got)
    rl = jax.tree_util.tree_leaves_with_path(ref)
    assert [jax.tree_util.keystr(p) for p, _ in gl] == [jax.tree_util.keystr(p) for p, _ in rl]
    for (p, g), (_, r) in zip(gl, rl):
        assert np.asarray(g).dtype == np.asarray(r).dtype, jax.tree_util.keystr(p)
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r),
                                      err_msg=jax.tree_util.keystr(p))


@pytest.mark.parametrize("normalization", NORMS)
def test_import_matches_the_jax_import_and_forward(normalization):
    jm, params, tm, x = _models(normalization)
    sd = j_ti.export_reference_state_dict(params, jm, "rt-st-gcn")
    # a checkpoint as the reference saves it, DataParallel prefix included
    ckpt = {"epoch": 3, "model_state_dict": {f"module.{k}": torch.tensor(v)
                                             for k, v in sd.items()}}
    got = ti.import_reference_state_dict(ckpt, tm, "rt-st-gcn")
    _assert_same_tree(got, j_ti.import_reference_state_dict(ckpt, jm, "rt-st-gcn"))
    _assert_same_tree(got, jax.tree.map(np.asarray, params))
    ti.load_reference_into(tm, got)
    ref = np.asarray(jm.apply(params, x))
    with torch.no_grad():
        out = tm(torch.tensor(x)).numpy()
    assert np.abs(out - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("normalization", NORMS)
def test_export_round_trips_through_the_jax_import(normalization):
    jm, params, tm, _ = _models(normalization, seed=1)
    tm.load_state_dict(from_jax_params(params, tm), strict=True)
    tree = to_jax_params(tm)
    _assert_same_tree(tree, jax.tree.map(np.asarray, params))
    sd = ti.export_reference_state_dict(tree, tm, "rt-st-gcn")
    ref_sd = j_ti.export_reference_state_dict(params, jm, "rt-st-gcn")
    assert list(sd) == list(ref_sd)
    for k in ref_sd:
        np.testing.assert_array_equal(sd[k], ref_sd[k], err_msg=k)
    _assert_same_tree(j_ti.import_reference_state_dict(sd, jm, "rt-st-gcn"),
                      jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("normalization", NORMS)
def test_optimizer_moments_match_the_jax_import(normalization):
    jm, params, tm, _ = _models(normalization, seed=2)
    sd = j_ti.export_reference_state_dict(params, jm, "rt-st-gcn")
    keys = [k for k in sd if k != "A"]
    rng = np.random.default_rng(4)
    state = {i: {"step": torch.tensor(float(17 + (i % 3))),
                 "exp_avg": torch.tensor(rng.normal(size=sd[k].shape).astype(np.float32)),
                 "exp_avg_sq": torch.tensor(rng.random(sd[k].shape).astype(np.float32))}
             for i, k in enumerate(keys)}
    ckpt = {"model_state_dict": {k: torch.tensor(v) for k, v in sd.items()},
            "optimizer_state_dict": {"state": state,
                                     "param_groups": [{"params": list(range(len(keys)))}]}}
    mu, nu, count = ti.import_reference_optimizer(ckpt, tm, "rt-st-gcn")
    jmu, jnu, jcount = j_ti.import_reference_optimizer(ckpt, jm, "rt-st-gcn")
    assert count == jcount == 17
    _assert_same_tree(mu, jmu)
    _assert_same_tree(nu, jnu)
    # the moments land in the port's Adam under the parameters' names
    from stgx_torch.parallel.loop import OptimizerConfig, Trainer
    from stgx_torch.utils import LOSS

    trainer = Trainer(model=tm, kind="frame", loss=LOSS["rt-st-gcn"](np.ones(5, np.float32)),
                      opt=OptimizerConfig())
    trainer.load_adam_moments(from_jax_params(mu, tm), from_jax_params(nu, tm), count)
    ref_mu = from_jax_params(jax.tree.map(np.asarray, jmu), tm)
    for name, p in tm.named_parameters():
        st = trainer.optimizer.state[p]
        assert float(st["step"]) == 17.0
        assert torch.equal(st["exp_avg"], ref_mu[name]), name
    with pytest.raises(ValueError, match="architectures differ"):
        bad = dict(ckpt, optimizer_state_dict={"state": state, "param_groups": [
            {"params": list(range(len(keys) - 1))}]})
        ti.import_reference_optimizer(bad, tm, "rt-st-gcn")


def test_reference_files_load_weights_only(tmp_path):
    jm, params, tm, _ = _models("BatchNorm", seed=3)
    sd = j_ti.export_reference_state_dict(params, jm, "rt-st-gcn")
    good = tmp_path / "good.pt"
    torch.save({"epoch": 0, "model_state_dict": {k: torch.tensor(v) for k, v in sd.items()}},
               good)
    _assert_same_tree(ti.load_reference_checkpoint(str(good), tm, "rt-st-gcn"),
                      j_ti.load_reference_checkpoint(str(good), jm, "rt-st-gcn"))
    bad = tmp_path / "bad.pt"
    torch.save({"model_state_dict": {}, "args": argparse.Namespace(lr=0.1)}, bad)
    with pytest.raises(pickle.UnpicklingError):
        ti.load_reference_checkpoint(str(bad), tm, "rt-st-gcn")


def test_a_tree_of_another_architecture_does_not_load():
    jm, params, tm, _ = _models("BatchNorm")
    wider = RtStgcn(**dict(SMALL, in_ch=(8, 8, 32), out_ch=(8, 32, 32)), device="cpu")
    with pytest.raises(RuntimeError):
        ti.load_reference_into(wider, jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("name", ["st-gcn", "ms-tcn", "ms-gcn", "aa-gcn"])
def test_families_not_ported_raise(name):
    """The four window families are ported (the name is kept from when they
    raised): a reference dict the JAX package exports from perturbed JAX
    parameters imports to the JAX import's tree, loads strictly, and
    exports back to the same tree; a name without an importer still
    raises ``ValueError``."""
    from stgx.models import MODELS as J_MODELS
    from stgx_torch.models import MODELS

    kw = dict(SMALL)
    if name in ("ms-tcn", "ms-gcn"):
        ms = dict(stages=2, filters=(8, 8), layers=(2, 2))
        kw = (dict(num_classes=5, in_feat=3, kernel=(3, 3), dropout=(0.0, 0.0), **ms)
              if name == "ms-tcn" else dict(SMALL, refine_kernel=(3, 3),
                                            refine_dropout=(0.0, 0.0), **ms))
    jm, tm = J_MODELS[name](**kw), MODELS[name](**kw, device="cpu")
    rng = np.random.default_rng(1)
    x = np.zeros((4, 12, 25, 3), np.float32)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=np.shape(a)).astype(np.float32),
        jm.init(jax.random.PRNGKey(1), x))
    sd = j_ti.export_reference_state_dict(params, jm, name)
    tree = ti.import_reference_state_dict(sd, tm, name)
    _assert_same_tree(tree, j_ti.import_reference_state_dict(sd, jm, name))
    ti.load_reference_into(tm, tree)
    back = ti.export_reference_state_dict(to_jax_params(tm), tm, name)
    _assert_same_tree(j_ti.import_reference_state_dict(back, jm, name), tree)
    with pytest.raises(ValueError, match="no importer"):
        ti.import_reference_state_dict({}, tm, "shift-gcn")
