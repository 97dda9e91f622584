"""Reference PyTorch checkpoints in and out — the port of
``stgx/utils/torch_import.py``.

The reference implementation trains with PyTorch and saves ``{epoch,
model_state_dict, optimizer_state_dict, loss}``. This module turns such a
``model_state_dict`` into the JAX package's parameter tree for an
RT-ST-GCN, a CoST-GCN, an ST-GCN, an MS-TCN, an MS-GCN (whose checkpoint
holds two dicts, ``generator_stage`` and ``refinement_stages``) or an
AA-GCN (the same tree, leaf for leaf, that
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

Shift-GCN has no reference checkpoints, and no importer in either
package: a name without an importer raises ``ValueError``.

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
``bn_relu.0``, edge importance ``st_gcn.i.edge_importance``); ST-GCN's, and
CoST-GCN's after it, are ``gcn_networks.i`` (graph conv ``gcn.conv``,
norms ``tcn.0`` and ``tcn.3`` around the temporal conv ``tcn.2``, the
residual ``residual.0`` with its bias and ``residual.1``, edge importance
``edge_importance.i``). MS-TCN's stages are ``generator_stage`` and
``refinement_stages.s`` (``conv_in``, ``conv_out``, ``layers.j.conv.0``
the dilated conv and ``layers.j.conv.2`` the 1×1); AA-GCN's streams
``streams.{0,1}`` (``norm_in``, ``fcn_in``, ``fcn_out``,
``gcn_networks.i.{B,theta,phi}`` and the ST-GCN layer
``gcn_networks.i.st_gcn``). The reference AA-GCN has no edge importance:
an import sets it to ones (the identity mask) and an export folds it into
``B`` (``B + A·(importance − 1)``), both lossless for the forward.
"""

from __future__ import annotations

import numpy as np
import torch

from stgx_torch.models.aagcn import AaGcn
from stgx_torch.models.msgcn import MsGcn
from stgx_torch.models.rtstgcn import RtStgcn
from stgx_torch.weights import from_jax_params

__all__ = [
    "import_reference_state_dict",
    "export_reference_state_dict",
    "load_reference_checkpoint",
    "load_reference_into",
    "import_reference_optimizer",
]

_FAMILIES = ("st-gcn", "rt-st-gcn", "co-st-gcn", "ms-tcn", "ms-gcn", "aa-gcn")


def _check_family(name: str) -> None:
    if name not in _FAMILIES:
        raise ValueError(f"no importer for {name!r}; supported: {sorted(_FAMILIES)}")


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


def _import_body(sd, model, prefix="") -> dict:
    """The shared ST-GCN body (norm_in, fcn_in, layers, fcn_out, edge
    importance) at an optional key prefix of ``sd``."""
    kind, V = _kind(model), model.num_joints
    rt, layer_key = _names(model)
    p = {
        "norm_in": _norm(sd, f"{prefix}norm_in", kind, V, per_joint_bn=True),
        "fcn_in": _conv1x1(sd, f"{prefix}fcn_in"),
        "fcn_out": _conv1x1(sd, f"{prefix}fcn_out"),
    }
    imp = []
    for i in range(len(model.in_ch)):
        base = f"{prefix}{layer_key}.{i}"
        p[f"layers_{i}"] = _import_layer(sd, base, kind, V, model.out_ch[i],
                                         _has_res_conv(model, i), rt)
        imp_key = f"{base}.edge_importance" if rt else f"{prefix}edge_importance.{i}"
        if imp_key in sd:
            imp.append(_np(sd[imp_key]))
    if imp:
        p["edge_importance"] = np.stack(imp)
    return p


def _import_single_stage(sd, base, num_layers):
    sp = {"Dense_0": _conv1x1(sd, f"{base}.conv_in"),
          "Dense_1": _conv1x1(sd, f"{base}.conv_out")}
    for j in range(num_layers):
        lb = f"{base}.layers.{j}.conv"
        cw, cb = _tconv(sd, f"{lb}.0")
        sp[f"DilatedResidualLayer_{j}"] = {"conv_kernel": cw, "conv_bias": cb,
                                           "Dense_0": _conv1x1(sd, f"{lb}.2")}
    return sp


def _import_mstcn(sd, model) -> dict:
    return {f"SingleStage_{s}": _import_single_stage(
        sd, "generator_stage" if s == 0 else f"refinement_stages.{s - 1}", model.layers[s])
        for s in range(model.stages)}


def _split_msgcn(sd):
    """MS-GCN's checkpoint as ``(generator dict, refinement dict)``: the
    reference saves two dicts, ``generator_stage`` (an ST-GCN's, perhaps
    with DataParallel prefixes) and ``refinement_stages``; a whole-model
    dict holds both under those prefixes."""
    if "generator_stage" in sd:
        return (_unwrap(dict(sd["generator_stage"])),
                {f"refinement_stages.{k}": v for k, v in dict(sd["refinement_stages"]).items()})
    gen = {k.removeprefix("generator_stage."): v for k, v in sd.items()
           if k.startswith("generator_stage.")}
    return gen, {k: v for k, v in sd.items() if k.startswith("refinement_stages.")}


def _import_msgcn(sd, model) -> dict:
    gen_sd, ref_sd = _split_msgcn(sd)
    p = {"Stgcn_0": _import_body(gen_sd, model.generator_stage)}
    for s in range(model.stages):
        p[f"SingleStage_{s}"] = _import_single_stage(ref_sd, f"refinement_stages.{s}",
                                                     model.layers[s])
    return p


def _import_aagcn(sd, model) -> dict:
    p = {}
    for s, stream in enumerate(("joint_stream", "bone_stream")):
        st = getattr(model, stream)
        kind, V = _kind(st), model.num_joints
        sp = {
            f"{kind}_0": _norm(sd, f"streams.{s}.norm_in", kind, V, per_joint_bn=True),
            "Dense_0": _conv1x1(sd, f"streams.{s}.fcn_in"),
            "Dense_1": _conv1x1(sd, f"streams.{s}.fcn_out"),
            "edge_importance": np.ones(
                (len(model.in_ch),) + _np(sd[f"streams.{s}.gcn_networks.0.B"]).shape,
                np.float32),
        }
        for i, agcn in enumerate(st.layers):
            base = f"streams.{s}.gcn_networks.{i}"
            sp[f"AgcnLayer_{i}"] = {
                "B": _np(sd[f"{base}.B"]),
                "theta_kernel": _conv1x1(sd, f"{base}.theta")["kernel"],
                "theta_bias": _np(sd[f"{base}.theta.bias"]),
                "phi_kernel": _conv1x1(sd, f"{base}.phi")["kernel"],
                "phi_bias": _np(sd[f"{base}.phi.bias"]),
                "StgcnLayer_0": _import_layer(sd, f"{base}.st_gcn", kind, V, model.out_ch[i],
                                              hasattr(agcn.layer, "res_kernel"), rt=False),
            }
        p[stream] = sp
    return p


# family → tree of the checkpoint's dict
_IMPORTERS = {"ms-tcn": _import_mstcn, "ms-gcn": _import_msgcn, "aa-gcn": _import_aagcn}


def import_reference_state_dict(state_dict, model, name: str) -> dict:
    """A reference ``model_state_dict`` (or the whole checkpoint dict) as
    the JAX parameter tree of ``model``, a port model of family ``name``
    built with the checkpoint's architecture."""
    _check_family(name)
    return {"params": _IMPORTERS.get(name, _import_body)(_unwrap(state_dict), model)}


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


def _export_layer(sd, base, lp, kind, res_conv, rt):
    _emit(sd, f"{base}.conv" if rt else f"{base}.gcn.conv", _inv_graph_conv(lp["GraphConv_0"]))
    idx = 0
    if res_conv:
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


def _graph_A(model) -> np.ndarray:
    return model.A.detach().cpu().numpy().astype(np.float32)


def _export_body(p, model, sd, prefix=""):
    kind = _kind(model)
    rt, layer_key = _names(model)
    _emit(sd, f"{prefix}norm_in", _inv_norm(p["norm_in"], kind, per_joint_bn=True))
    _emit(sd, f"{prefix}fcn_in", _inv_conv1x1(p["fcn_in"]))
    _emit(sd, f"{prefix}fcn_out", _inv_conv1x1(p["fcn_out"]))
    for i in range(len(model.in_ch)):
        base = f"{prefix}{layer_key}.{i}"
        _export_layer(sd, base, p[f"layers_{i}"], kind, _has_res_conv(model, i), rt)
        if "edge_importance" in p:
            key = f"{base}.edge_importance" if rt else f"{prefix}edge_importance.{i}"
            sd[key] = _np(p["edge_importance"][i])
    sd[f"{prefix}A"] = _graph_A(model)
    return sd


def _export_single_stage(sd, base, sp, num_layers):
    _emit(sd, f"{base}.conv_in", _inv_conv1x1(sp["Dense_0"]))
    _emit(sd, f"{base}.conv_out", _inv_conv1x1(sp["Dense_1"]))
    for j in range(num_layers):
        lp = sp[f"DilatedResidualLayer_{j}"]
        _emit(sd, f"{base}.layers.{j}.conv.0", _inv_tconv(lp["conv_kernel"], lp["conv_bias"]))
        _emit(sd, f"{base}.layers.{j}.conv.2", _inv_conv1x1(lp["Dense_0"]))


def _export_mstcn(p, model):
    sd = {}
    for s in range(model.stages):
        _export_single_stage(sd, "generator_stage" if s == 0 else f"refinement_stages.{s - 1}",
                             p[f"SingleStage_{s}"], model.layers[s])
    return sd


def _export_msgcn(p, model):
    """The two-part dict the reference saves."""
    gen = _export_body(p["Stgcn_0"], model.generator_stage, {})
    ref = {}
    for s in range(model.stages):
        _export_single_stage(ref, str(s), p[f"SingleStage_{s}"], model.layers[s])
    return {"generator_stage": gen, "refinement_stages": ref}


def _export_aagcn(p, model):
    """The edge importance folds into the free matrix: ``B' = B + A·(imp −
    1)`` gives the reference's ``A + B' + C`` the port's ``A·imp + B + C``."""
    A = _graph_A(model)
    sd = {}
    for s, stream in enumerate(("joint_stream", "bone_stream")):
        sp, st = p[stream], getattr(model, stream)
        kind = _kind(st)
        imp = _np(sp["edge_importance"]) if "edge_importance" in sp else None
        _emit(sd, f"streams.{s}.norm_in", _inv_norm(sp[f"{kind}_0"], kind, per_joint_bn=True))
        _emit(sd, f"streams.{s}.fcn_in", _inv_conv1x1(sp["Dense_0"]))
        _emit(sd, f"streams.{s}.fcn_out", _inv_conv1x1(sp["Dense_1"]))
        for i, agcn in enumerate(st.layers):
            base, lp = f"streams.{s}.gcn_networks.{i}", sp[f"AgcnLayer_{i}"]
            B = _np(lp["B"])
            sd[f"{base}.B"] = B if imp is None else B + A * (imp[i] - 1.0)
            _emit(sd, f"{base}.theta", _inv_conv1x1(
                {"kernel": lp["theta_kernel"], "bias": lp["theta_bias"]}))
            _emit(sd, f"{base}.phi", _inv_conv1x1(
                {"kernel": lp["phi_kernel"], "bias": lp["phi_bias"]}))
            _export_layer(sd, f"{base}.st_gcn", lp["StgcnLayer_0"], kind,
                          hasattr(agcn.layer, "res_kernel"), rt=False)
    sd["A"] = A
    return sd


_EXPORTERS = {"ms-tcn": _export_mstcn, "ms-gcn": _export_msgcn, "aa-gcn": _export_aagcn}


def export_reference_state_dict(params: dict, model, name: str) -> dict:
    """The JAX parameter tree ``params`` of ``model`` (for the port's own
    weights: :func:`stgx_torch.weights.to_jax_params`) in the reference's
    state-dict naming, as numpy arrays, with the ``A`` adjacency buffer the
    reference model registers (MS-GCN: the reference's two-part dict)."""
    _check_family(name)
    p = params["params"]
    if name in _EXPORTERS:
        return _EXPORTERS[name](p, model)
    return _export_body(p, model, {})


# -- optimizer state ----------------------------------------------------------


def import_reference_optimizer(checkpoint: dict, model, name: str):
    """The reference checkpoint's Adam state as moment trees.

    The reference optimises ``Adam(model.parameters())`` and saves an
    ``optimizer_state_dict`` whose integer keys index ``named_parameters()``
    order, which is the model state dict's key order without its one
    buffer, ``A``. Each moment has its parameter's shape, so the weight
    transforms apply as they are.

    Returns ``(mu, nu, count)``: two trees shaped like the parameters and
    the least Adam step count. MS-GCN's flat order is its two dicts', the
    generator's parameters first. AA-GCN's edge importance, which the
    reference lacks, gets zero moments.
    """
    _check_family(name)
    msd = checkpoint["model_state_dict"] if "model_state_dict" in checkpoint else checkpoint
    osd = checkpoint["optimizer_state_dict"]
    if name == "ms-gcn":
        gen = _unwrap(dict(msd["generator_stage"]))
        param_keys = ([f"generator_stage/{k}" for k in gen if k != "A"]
                      + [f"refinement_stages/{k}" for k in msd["refinement_stages"]])
    else:
        msd = _unwrap(msd)
        param_keys = [k for k in msd if k != "A"]
    state = osd["state"]
    order = osd["param_groups"][0]["params"]
    if len(order) != len(param_keys):
        raise ValueError(
            f"optimizer has {len(order)} params but the model dict has "
            f"{len(param_keys)} non-buffer tensors — architectures differ"
        )

    def moment_tree(field):
        flat = {k: state[idx][field] for k, idx in zip(param_keys, order)}
        if name == "ms-gcn":
            two = {"generator_stage": {}, "refinement_stages": {}}
            for k, v in flat.items():
                part, sub = k.split("/", 1)
                two[part][sub] = v
            flat = two
        tree = import_reference_state_dict(flat, model, name)
        if name == "aa-gcn":
            for stream in ("joint_stream", "bone_stream"):
                imp = tree["params"][stream]["edge_importance"]
                tree["params"][stream]["edge_importance"] = np.zeros_like(imp)
        return tree

    count = int(min(float(_np(state[i]["step"])) for i in order))
    return moment_tree("exp_avg"), moment_tree("exp_avg_sq"), count
