"""The port's AA-GCN (``stgx_torch.models.aagcn``) against the JAX package
on the CPU: the bone parents and vectors, one adaptive layer, and the
two-stream model under each ``output_type``, forward and gradients.

The JAX variables are made from a seed and moved off their init values
(``B`` too, which starts at zero), carried into the port by
``from_jax_params`` and loaded strictly. The attention contracts over the
whole window, padding frames included, with no mask, in both packages; the
per-sample adjacency goes through two einsums, never ``gcn_core``.

Size: 3 layers of 8/16 channels, Γ = 5, W = 12 (layer 1 at stride 2 with
the residual 1×1 conv); pku-mmd's 25 joints.

Tolerances: outputs ``1e-5 · max(1, max|ref|)`` (fp32 sums in another
order through the softmax attention and normalised layers); each
parameter's gradient ``1e-5 · max(1, max|ref|)``, a bias that feeds a batch
norm held to zero on both sides within ``1e-5`` of the largest gradient;
the bones exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stgx.graph import Graph as JGraph
from stgx.graph import load_skeleton
from stgx.models import aagcn as j_aa
from stgx_torch.models import aagcn as aa
from stgx_torch.weights import _TCN_LAYER, _AGCN_LEAVES, _layer, from_jax_params, to_jax_params
from test_torch_stgcn import SMALL, _close, _inputs, _perturbed, assert_grads_close

V = 25
GRAPH = load_skeleton("pku-mmd")


@pytest.mark.parametrize("skeleton", ["pku-mmd", "openpose", "hugadb"])
def test_bone_parents_and_vectors_match_jax(skeleton):
    spec = load_skeleton(skeleton)
    parents = aa.bone_parents(spec)
    np.testing.assert_array_equal(parents, j_aa.bone_parents(spec))
    assert (parents == -1).sum() >= 1  # the centre keeps a zero bone
    x = np.random.default_rng(0).normal(size=(2, 5, spec["num_node"], 3)).astype(np.float32)
    got = aa.bone_vectors(torch.tensor(x), torch.tensor(parents, dtype=torch.int64))
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_aa.bone_vectors(jnp.asarray(x),
                                                                            parents)))


@pytest.mark.parametrize("normalization", ["BatchNorm", "LayerNorm"])
def test_adaptive_layer_matches_jax(normalization):
    """``A + B + softmax(θᵀφ)`` in front of a strided ST-GCN layer (8 → 16,
    stride 2, the residual conv), with a mask that reaches the norms only."""
    x, mask = _inputs()
    x = np.random.default_rng(1).normal(size=(3, 12, V, 8)).astype(np.float32)
    A = np.asarray(JGraph(strategy="spatial", **GRAPH).A, np.float32)
    jl = j_aa.AgcnLayer(8, 16, 5, 3, V, stride=2, normalization=normalization)
    params = _perturbed(jl.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(A),
                                mask=jnp.asarray(mask)), 2)
    tl = aa.AgcnLayer(8, 16, 5, 3, V, torch.Generator().manual_seed(0), stride=2,
                      normalization=normalization)
    sd = {k: torch.tensor(params["params"][k]) for k in _AGCN_LEAVES}
    _layer(params["params"]["StgcnLayer_0"],
           lambda k, v: sd.__setitem__(f"layer.{k}", torch.tensor(v)), "", *_TCN_LAYER)
    tl.load_state_dict(sd, strict=True)
    ref = jl.apply(params, jnp.asarray(x), jnp.asarray(A), mask=jnp.asarray(mask))
    with torch.no_grad():
        got = tl(torch.tensor(x), torch.tensor(A), mask=torch.tensor(mask))
    assert got.shape == (3, 6, V, 16)
    _close(got, ref)


def _feeds_batch_norm(pname):
    return pname.endswith(("layer.res_bias", "layer.tcn_bias"))


@pytest.mark.parametrize("normalization,output_type", [
    ("BatchNorm", "logits"), ("BatchNorm", "logsoftmax"), ("LayerNorm", "softmax")])
def test_model_and_gradients_match_jax(normalization, output_type):
    """The two streams summed after the adapter, with a mask; gradients of
    ``<out, g>`` against ``jax.vjp`` for every parameter and the input; the
    weights round-trip to the flax tree."""
    kw = dict(SMALL, normalization=normalization, output_type=output_type)
    jm = j_aa.AaGcn(**kw)
    x, mask = _inputs()
    params = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 0)
    tm = aa.AaGcn(**kw, device="cpu")
    tm.load_state_dict(from_jax_params(params, tm), strict=True)
    for got, ref in zip(jax.tree.leaves(to_jax_params(tm)), jax.tree.leaves(params)):
        np.testing.assert_array_equal(got, ref)
    g = np.random.default_rng(3).normal(size=(3, 5)).astype(np.float32)
    ref, vjp = jax.vjp(lambda p, xx: jm.apply(p, xx, mask=jnp.asarray(mask)),
                       jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    out = tm(xt, mask=torch.tensor(mask))
    _close(out, ref)
    (out * torch.tensor(g)).sum().backward()
    assert_grads_close(tm, gp, normalization, feeds=_feeds_batch_norm)
    _close(xt.grad, gx)


def test_the_per_sample_graph_conv_takes_no_kernel(monkeypatch):
    """The 4-D adjacency never reaches ``partitioned_gcn`` (``gcn_core`` on
    the card)."""
    import stgx_torch.models.stgcn as st

    def refuse(*a, **k):
        raise AssertionError("partitioned_gcn called with a per-sample adjacency")

    monkeypatch.setattr(st, "partitioned_gcn", refuse)
    tm = aa.AaGcn(**SMALL, device="cpu")
    x, _ = _inputs()
    assert tm(torch.tensor(x)).shape == (3, 5)
    with pytest.raises(ValueError, match="output adapter"):
        aa.AaGcn(**SMALL, output_type="probs", device="cpu")
