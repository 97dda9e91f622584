"""Reference PyTorch checkpoints in and out — the port of
``stgx/utils/torch_import.py`` for the families the port has.

The reference implementation trains with PyTorch and saves ``{epoch,
model_state_dict, optimizer_state_dict, loss}``. This module turns such a
``model_state_dict`` into the JAX package's parameter tree for an
RT-ST-GCN or a CoST-GCN (the same tree, leaf for leaf, that
``stgx.utils.torch_import.import_reference_state_dict`` gives), which
:func:`stgx_torch.weights.from_jax_params` then maps onto the port's
``state_dict``; :func:`load_reference_into` does both. The reverse
direction and the optimizer's Adam moments are ported too. The streaming
cell shares the batch form's parameters, so an imported checkpoint streams
as it is.

Everything is numpy over an already-loaded state dict; ``module.``
prefixes of a DataParallel dict are dropped. A file is read with
``torch.load(weights_only=True)``, which runs no code from the file: a
file that holds objects such a load refuses fails with its message.

The reference's other families with an importer in the JAX package
(``st-gcn``, ``ms-tcn``, ``ms-gcn``, ``aa-gcn``) raise
``NotImplementedError`` until their models are ported (ROADMAP.md, queue
1). Shift-GCN has no reference checkpoints, and no importer in either
package.

Layout transforms (reference → JAX tree):

==================  =======================  =========================
reference tensor    shape                    tree leaf
==================  =======================  =========================
1×1 Conv2d          (D, C, 1, 1)             Dense kernel (C, D)
partitioned 1×1     (P·D, C, 1, 1)           GraphConv kernel (P, C, D)
temporal Conv2d     (D, C, Γ, 1)             tcn_kernel (Γ, C, D)
custom LayerNorm    (C, 1, V)                scale/bias (V, C)
BatchNorm1d (V·C)   (V·C,)                   scale/bias (V, C)
BatchNorm2d         (C,)                     scale/bias (C,)
edge importance     per-layer (P, V, V)      stacked (layers, P, V, V)
==================  =======================  =========================

Names: RT-ST-GCN's layers are ``st_gcn.i`` (graph conv ``conv``, norm
``bn_relu.0``, edge importance ``st_gcn.i.edge_importance``); CoST-GCN
keeps ST-GCN's: ``gcn_networks.i`` (graph conv ``gcn.conv``, norms
``tcn.0`` and ``tcn.3`` around the temporal conv ``tcn.2``, the residual
``residual.0`` with its bias and ``residual.1``, edge importance
``edge_importance.i``).
"""

from __future__ import annotations

import numpy as np
import torch

from stgx_torch.models.rtstgcn import RtStgcn
from stgx_torch.weights import from_jax_params

__all__ = [
    "import_reference_state_dict",
    "export_reference_state_dict",
    "load_reference_checkpoint",
    "load_reference_into",
    "import_reference_optimizer",
]

# families the JAX package imports whose models the port lacks
_NOT_PORTED = ("st-gcn", "ms-tcn", "ms-gcn", "aa-gcn")
_FAMILIES = ("rt-st-gcn", "co-st-gcn")


def _check_family(name: str) -> None:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"reference checkpoints of {name!r} are not ported to stgx_torch yet; "
            "see the module queue (queue 1) in ROADMAP.md"
        )
    if name not in _FAMILIES:
        raise ValueError(f"no importer for {name!r}; supported: {list(_FAMILIES)}")


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=np.float32)


def _unwrap(state_dict) -> dict:
    if "model_state_dict" in state_dict:
        state_dict = state_dict["model_state_dict"]
    return {
        (k[len("module."):] if k.startswith("module.") else k): v
        for k, v in state_dict.items()
    }


def _kind(model) -> str:
    return type(model.norm_in).__name__  # "LayerNorm" or "BatchNorm"


def _has_res_conv(model, i) -> bool:
    return hasattr(model.layers[i], "res_kernel")


# -- reference → tree ---------------------------------------------------------


def _names(model):
    """``(rt, layer key)``: RT-ST-GCN's naming, or ST-GCN's (CoST-GCN)."""
    rt = isinstance(model, RtStgcn)
    return rt, "st_gcn" if rt else "gcn_networks"


def _conv1x1(sd, key):
    """(D, C, 1, 1) + (D,) → {'kernel': (C, D), 'bias': (D,)}."""
    out = {"kernel": _np(sd[f"{key}.weight"])[:, :, 0, 0].T}
    if f"{key}.bias" in sd:
        out["bias"] = _np(sd[f"{key}.bias"])
    return out


def _graph_conv(sd, key, partitions):
    """(P·D, C, 1, 1) stacked partition-major → kernel (P, C, D), bias (P, D)."""
    w = _np(sd[f"{key}.weight"])[:, :, 0, 0]  # (P·D, C)
    pd, c = w.shape
    d = pd // partitions
    out = {"kernel": w.reshape(partitions, d, c).transpose(0, 2, 1)}
    if f"{key}.bias" in sd:
        out["bias"] = _np(sd[f"{key}.bias"]).reshape(partitions, d)
    return out


def _tconv(sd, key):
    """(D, C, Γ, 1) → kernel (Γ, C, D), bias (D,)."""
    w = _np(sd[f"{key}.weight"])[:, :, :, 0]  # (D, C, Γ)
    return w.transpose(2, 1, 0), _np(sd[f"{key}.bias"])


def _norm(sd, key, kind, num_joints, per_joint_bn=False):
    """LayerNorm ``(C, 1, V)`` → (V, C); per-joint BatchNorm1d over V·C
    (V-major) → (V, C); BatchNorm2d (C,) → (C,)."""
    if kind == "LayerNorm":
        w, b = _np(sd[f"{key}.weight"]), _np(sd[f"{key}.bias"])
        return {"scale": w[:, 0, :].T, "bias": b[:, 0, :].T}
    bnk = f"{key}.norm" if f"{key}.norm.weight" in sd else key
    w, b = _np(sd[f"{bnk}.weight"]), _np(sd[f"{bnk}.bias"])
    if per_joint_bn:
        return {"scale": w.reshape(num_joints, -1), "bias": b.reshape(num_joints, -1)}
    return {"scale": w, "bias": b}


def _import_layer(sd, base, kind, V, out_ch, res_conv, rt):
    """One layer's subtree at prefix ``base``: an RT layer, or a CoST-GCN
    layer named as ST-GCN's."""
    conv_key = f"{base}.conv" if rt else f"{base}.gcn.conv"
    pd = _np(sd[f"{conv_key}.weight"]).shape[0]
    lp = {"GraphConv_0": _graph_conv(sd, conv_key, pd // out_ch)}
    idx = 0
    if res_conv:
        lp["res_kernel"] = _np(sd[f"{base}.residual.0.weight"])[:, :, 0, 0].T
        if f"{base}.residual.0.bias" in sd:  # CoST-GCN's has one, RT's not
            lp["res_bias"] = _np(sd[f"{base}.residual.0.bias"])
        lp[f"{kind}_{idx}"] = _norm(sd, f"{base}.residual.1", kind, V)
        idx += 1
    if rt:
        lp[f"{kind}_{idx}"] = _norm(sd, f"{base}.bn_relu.0", kind, V)
    else:
        lp[f"{kind}_{idx}"] = _norm(sd, f"{base}.tcn.0", kind, V)
        lp["tcn_kernel"], lp["tcn_bias"] = _tconv(sd, f"{base}.tcn.2")
        lp[f"{kind}_{idx + 1}"] = _norm(sd, f"{base}.tcn.3", kind, V)
    return lp


def _import_body(sd, model) -> dict:
    kind, V = _kind(model), model.num_joints
    rt, layer_key = _names(model)
    p = {
        "norm_in": _norm(sd, "norm_in", kind, V, per_joint_bn=True),
        "fcn_in": _conv1x1(sd, "fcn_in"),
        "fcn_out": _conv1x1(sd, "fcn_out"),
    }
    imp = []
    for i in range(len(model.in_ch)):
        base = f"{layer_key}.{i}"
        p[f"layers_{i}"] = _import_layer(sd, base, kind, V, model.out_ch[i],
                                         _has_res_conv(model, i), rt)
        imp_key = f"{base}.edge_importance" if rt else f"edge_importance.{i}"
        if imp_key in sd:
            imp.append(_np(sd[imp_key]))
    if imp:
        p["edge_importance"] = np.stack(imp)
    return {"params": p}


def import_reference_state_dict(state_dict, model, name: str) -> dict:
    """A reference ``model_state_dict`` (or the whole checkpoint dict) as
    the JAX parameter tree of ``model``, a port model of family ``name``
    built with the checkpoint's architecture."""
    _check_family(name)
    return _import_body(_unwrap(state_dict), model)


def load_reference_checkpoint(path: str, model, name: str) -> dict:
    """Read a reference ``.pt`` file (``weights_only=True``) and convert it
    (:func:`import_reference_state_dict`)."""
    _check_family(name)
    return import_reference_state_dict(
        torch.load(path, map_location="cpu", weights_only=True), model, name)


def load_reference_into(model, tree: dict) -> None:
    """Load an imported tree into ``model`` strictly: a tree of another
    architecture raises (``ValueError`` for a leaf the port does not know,
    ``RuntimeError`` for a missing leaf or another shape)."""
    model.load_state_dict(from_jax_params(tree, model), strict=True)


# -- tree → reference ---------------------------------------------------------


def _inv_conv1x1(dp):
    out = {"weight": _np(dp["kernel"]).T[:, :, None, None]}
    if "bias" in dp:
        out["bias"] = _np(dp["bias"])
    return out


def _inv_graph_conv(gp):
    k = _np(gp["kernel"])  # (P, C, D)
    p_, c, d = k.shape
    out = {"weight": k.transpose(0, 2, 1).reshape(p_ * d, c)[:, :, None, None]}
    if "bias" in gp:
        out["bias"] = _np(gp["bias"]).reshape(-1)
    return out


def _inv_tconv(kernel, bias):
    w = _np(kernel).transpose(2, 1, 0)[:, :, :, None]  # (D, C, Γ, 1)
    return {"weight": w, "bias": _np(bias)}


def _inv_norm(npz, kind, per_joint_bn=False):
    w, b = _np(npz["scale"]), _np(npz["bias"])
    if kind == "LayerNorm":
        return {"weight": w.T[:, None, :], "bias": b.T[:, None, :]}
    if per_joint_bn:
        return {"norm.weight": w.reshape(-1), "norm.bias": b.reshape(-1)}
    return {"weight": w, "bias": b}


def _emit(sd, base, tensors):
    for k, v in tensors.items():
        sd[f"{base}.{k}"] = v


def export_reference_state_dict(params: dict, model, name: str) -> dict:
    """The JAX parameter tree ``params`` of ``model`` (for the port's own
    weights: :func:`stgx_torch.weights.to_jax_params`) in the reference's
    state-dict naming, as numpy arrays, with the ``A`` adjacency buffer the
    reference model registers."""
    _check_family(name)
    p, kind, sd = params["params"], _kind(model), {}
    rt, layer_key = _names(model)
    _emit(sd, "norm_in", _inv_norm(p["norm_in"], kind, per_joint_bn=True))
    _emit(sd, "fcn_in", _inv_conv1x1(p["fcn_in"]))
    _emit(sd, "fcn_out", _inv_conv1x1(p["fcn_out"]))
    for i in range(len(model.in_ch)):
        base, lp = f"{layer_key}.{i}", p[f"layers_{i}"]
        _emit(sd, f"{base}.conv" if rt else f"{base}.gcn.conv",
              _inv_graph_conv(lp["GraphConv_0"]))
        idx = 0
        if _has_res_conv(model, i):
            sd[f"{base}.residual.0.weight"] = _np(lp["res_kernel"]).T[:, :, None, None]
            if "res_bias" in lp:
                sd[f"{base}.residual.0.bias"] = _np(lp["res_bias"])
            _emit(sd, f"{base}.residual.1", _inv_norm(lp[f"{kind}_{idx}"], kind))
            idx += 1
        if rt:
            _emit(sd, f"{base}.bn_relu.0", _inv_norm(lp[f"{kind}_{idx}"], kind))
        else:
            _emit(sd, f"{base}.tcn.0", _inv_norm(lp[f"{kind}_{idx}"], kind))
            _emit(sd, f"{base}.tcn.2", _inv_tconv(lp["tcn_kernel"], lp["tcn_bias"]))
            _emit(sd, f"{base}.tcn.3", _inv_norm(lp[f"{kind}_{idx + 1}"], kind))
        if "edge_importance" in p:
            key = f"{base}.edge_importance" if rt else f"edge_importance.{i}"
            sd[key] = _np(p["edge_importance"][i])
    sd["A"] = model.A.detach().cpu().numpy().astype(np.float32)
    return sd


# -- optimizer state ----------------------------------------------------------


def import_reference_optimizer(checkpoint: dict, model, name: str):
    """The reference checkpoint's Adam state as moment trees.

    The reference optimises ``Adam(model.parameters())`` and saves an
    ``optimizer_state_dict`` whose integer keys index ``named_parameters()``
    order, which is the model state dict's key order without its one
    buffer, ``A``. Each moment has its parameter's shape, so the weight
    transforms apply as they are.

    Returns ``(mu, nu, count)``: two trees shaped like the parameters and
    the least Adam step count.
    """
    _check_family(name)
    msd = _unwrap(checkpoint["model_state_dict"] if "model_state_dict" in checkpoint
                  else checkpoint)
    osd = checkpoint["optimizer_state_dict"]
    param_keys = [k for k in msd if k != "A"]
    state = osd["state"]
    order = osd["param_groups"][0]["params"]
    if len(order) != len(param_keys):
        raise ValueError(
            f"optimizer has {len(order)} params but the model dict has "
            f"{len(param_keys)} non-buffer tensors — architectures differ"
        )

    def moment_tree(field):
        return _import_body({k: state[idx][field] for k, idx in zip(param_keys, order)},
                            model)

    count = int(min(float(_np(state[i]["step"])) for i in order))
    return moment_tree("exp_avg"), moment_tree("exp_avg_sq"), count
