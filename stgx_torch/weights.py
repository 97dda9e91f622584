"""Carry JAX (flax) variables into the port's ``state_dict``.

The port keeps stgx's parameter shapes, so the mapping is renames only.
RT-ST-GCN, CoST-GCN and ST-GCN:

==========================================  ===============================
flax leaf (under ``params``)                port key
==========================================  ===============================
``edge_importance``                         ``edge_importance``
``norm_in/{scale,bias}``                    ``norm_in.{scale,bias}``
``fcn_in/{kernel,bias}``                    ``fcn_in.{kernel,bias}``
``layers_i/res_kernel``                     ``layers.i.res_kernel``
``layers_i/GraphConv_0/{kernel,bias}``      ``layers.i.gcn.{kernel,bias}``
``layers_i/<Norm>_k/{scale,bias}``          ``layers.i.{res_norm,norm}.…``
``fcn_out/{kernel,bias}``                   ``fcn_out.{kernel,bias}``
CoST-GCN and ST-GCN only:
``layers_i/{res_bias,tcn_kernel,tcn_bias}`` ``layers.i.<the same name>``
``layers_i/<Norm>_k/{scale,bias}``          ``layers.i.tcn_norm.…`` (last)
==========================================  ===============================

AA-GCN, each of ``joint_stream`` and ``bone_stream`` (``S`` below):

==============================================  ===========================
flax leaf (under ``params``)                    port key
==============================================  ===========================
``S/<Norm>_0``, ``S/Dense_0``, ``S/Dense_1``    ``S.norm_in``, ``S.fcn_in``, ``S.fcn_out``
``S/edge_importance``                           ``S.edge_importance``
``S/AgcnLayer_i/{B,theta_*,phi_*}``             ``S.layers.i.<the same name>``
``S/AgcnLayer_i/StgcnLayer_0/…``                ``S.layers.i.layer.…`` (as ST-GCN's)
==============================================  ===========================

MS-TCN and MS-GCN (a stage ``T``: ``generator_stage`` or
``refinement_stages.s``):

==================================================  =======================
flax leaf (under ``params``)                        port key
==================================================  =======================
``SingleStage_s/Dense_0``, ``…/Dense_1``            ``T.conv_in``, ``T.conv_out``
``SingleStage_s/DilatedResidualLayer_j/conv_*``     ``T.layers.j.conv_*``
``SingleStage_s/DilatedResidualLayer_j/Dense_0``    ``T.layers.j.pointwise``
``Stgcn_0/…`` (MS-GCN)                              ``generator_stage.…`` (as ST-GCN's)
==================================================  =======================

MS-TCN's ``SingleStage_0`` is its ``generator_stage`` and ``SingleStage_s``
its ``refinement_stages.{s−1}``; MS-GCN's ``SingleStage_s`` are its
``refinement_stages.s``.

Shift-GCN:

==============================================  ===========================
flax leaf (under ``params``)                    port key
==============================================  ===========================
``data_bn``, ``fc``                             ``data_bn``, ``fc``
``units_i/SpatialShiftBlock_0/<leaf>``          ``units.i.spatial.<leaf>``
``units_i/SpatialShiftBlock_0/<Norm>_{0,1}``    ``units.i.spatial.{norm,down_norm}``
``units_i/TemporalShiftBlock_0/<leaf>``         ``units.i.temporal.<leaf>``
``units_i/TemporalShiftBlock_0/<Norm>_{0,1}``   ``units.i.temporal.{in_norm,out_norm}``
``units_i/res_{kernel,bias}``                   ``units.i.res_{kernel,bias}``
``units_i/<Norm>_0``                            ``units.i.res_norm``
==============================================  ===========================

Norm names: flax numbers a module's norms in creation order. An RT layer
with a residual 1×1 conv creates the residual norm first, so there
``*Norm_0`` is ``res_norm`` and ``*Norm_1`` is ``norm``; elsewhere
``*Norm_0`` is ``norm`` (the same sorted-name rule as
``stgx/models/rtstgcn.py:stream_step``). A CoST-GCN layer creates the
residual's norm (where it has the 1×1 conv), then the graph conv's, then
the temporal conv's: ``res_norm``, ``norm``, ``tcn_norm`` in that order. Shift-GCN's spatial block creates
its main per-joint norm before the down-projection's, its temporal block
the input norm before the output norm, and a unit's only own norm is the
residual's.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from stgx_torch.models.aagcn import AaGcn
from stgx_torch.models.costgcn import CoStgcn
from stgx_torch.models.msgcn import MsGcn
from stgx_torch.models.mstcn import MsTcn
from stgx_torch.models.rtstgcn import RtStgcn
from stgx_torch.models.shiftgcn import (
    ShiftGcn,
    ShiftUnit,
    SpatialShiftBlock,
    TemporalShiftBlock,
)
from stgx_torch.models.stgcn import Stgcn

__all__ = ["from_jax_params", "to_jax_params"]

_SHIFT_MODULES = (ShiftGcn, ShiftUnit, SpatialShiftBlock, TemporalShiftBlock)

_NORMS = ("LayerNorm", "BatchNorm")

# a layer's own leaves, and its norm roles in flax's creation order with and
# without the residual 1×1 conv
_TCN_LAYER = (("res_kernel", "res_bias", "tcn_kernel", "tcn_bias"),
              ("res_norm", "norm", "tcn_norm"), ("norm", "tcn_norm"))
_LAYERS = {
    RtStgcn: (("res_kernel",), ("res_norm", "norm"), ("norm",)),
    CoStgcn: _TCN_LAYER,
    Stgcn: _TCN_LAYER,
}
_AGCN_LEAVES = ("B", "theta_kernel", "theta_bias", "phi_kernel", "phi_bias")
_DRL_LEAVES = ("conv_kernel", "conv_bias")


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _norm_roles(name, sub, roles):
    """``{flax norm name: port role}`` for the norms of module ``sub``, in
    creation order; raises if they do not fit ``roles``."""
    norms = sorted(k for k in sub if k.startswith(_NORMS))
    if len(norms) != len(roles):
        raise ValueError(f"{name}: norms {norms} do not fit {roles}")
    return dict(zip(norms, roles))


def from_jax_params(params, model) -> dict[str, torch.Tensor]:
    """``{"params": {...}}`` with numpy leaves → the port's ``state_dict``
    for ``model`` (tensors on its device, in its parameter type), ready for
    ``model.load_state_dict(sd, strict=True)``. ``model`` is a model of any
    ported family, or one of Shift-GCN's units or blocks."""
    p = params["params"]
    ref = next(model.parameters())
    out = {}

    def put(key, value):
        out[key] = torch.tensor(np.asarray(value, dtype=np.float32)).to(
            device=ref.device, dtype=ref.dtype)

    if isinstance(model, _SHIFT_MODULES):
        _shift(p, put, "", type(model))
    elif isinstance(model, AaGcn):
        for name, sub in p.items():
            if name not in ("joint_stream", "bone_stream"):
                raise ValueError(f"unexpected JAX parameter {name}")
            _stream(sub, put, f"{name}.")
    elif isinstance(model, (MsTcn, MsGcn)):
        for name, sub in p.items():
            if name == "Stgcn_0" and isinstance(model, MsGcn):
                _layered(sub, put, Stgcn, "generator_stage.")
            elif name.startswith("SingleStage_"):
                _stage(sub, put, _stage_prefix(model, int(name.removeprefix("SingleStage_"))))
            else:
                raise ValueError(f"unexpected JAX parameter {name}")
    else:
        _layered(p, put, type(model))
    return out


def _array(t):
    return t.detach().float().cpu().numpy()


def _leaves(module):
    return {k: _array(v) for k, v in module.named_parameters()}


def _kind(module) -> str:
    return type(module.norm_in).__name__  # "LayerNorm" or "BatchNorm"


def to_jax_params(model) -> dict:
    """The inverse of :func:`from_jax_params` for a model of any ported
    family but Shift-GCN: its parameters as the JAX package's ``{"params":
    {...}}`` tree of float32 numpy arrays."""
    if isinstance(model, AaGcn):
        p = {name: _stream_tree(getattr(model, name)) for name in ("joint_stream", "bone_stream")}
    elif isinstance(model, (MsTcn, MsGcn)):
        p = {}
        if isinstance(model, MsGcn):
            p["Stgcn_0"] = _layered_tree(model.generator_stage)
        stages = [] if isinstance(model, MsGcn) else [model.generator_stage]
        stages += list(model.refinement_stages)
        p.update({f"SingleStage_{s}": _stage_tree(st) for s, st in enumerate(stages)})
    elif type(model) in _LAYERS:
        p = _layered_tree(model)
    else:
        raise TypeError(f"to_jax_params takes no {type(model).__name__}")
    return {"params": p}


def _layer_tree(layer, kind, own, with_res, without_res):
    lp = {"GraphConv_0": _leaves(layer.gcn)}
    lp.update({k: _array(getattr(layer, k)) for k in own if hasattr(layer, k)})
    norms = with_res if hasattr(layer, "res_kernel") else without_res
    for k, role in enumerate(norms):  # flax's creation order
        lp[f"{kind}_{k}"] = _leaves(getattr(layer, role))
    return lp


def _layered_tree(model) -> dict:
    kind = _kind(model)
    p = {name: _leaves(getattr(model, name)) for name in ("norm_in", "fcn_in", "fcn_out")}
    if model.importance:
        p["edge_importance"] = _array(model.edge_importance)
    for i, layer in enumerate(model.layers):
        p[f"layers_{i}"] = _layer_tree(layer, kind, *_LAYERS[type(model)])
    return p


def _stream_tree(stream) -> dict:
    kind = _kind(stream)
    p = {f"{kind}_0": _leaves(stream.norm_in), "Dense_0": _leaves(stream.fcn_in),
         "Dense_1": _leaves(stream.fcn_out)}
    if stream.importance:
        p["edge_importance"] = _array(stream.edge_importance)
    for i, agcn in enumerate(stream.layers):
        lp = {k: _array(getattr(agcn, k)) for k in _AGCN_LEAVES}
        lp["StgcnLayer_0"] = _layer_tree(agcn.layer, kind, *_TCN_LAYER)
        p[f"AgcnLayer_{i}"] = lp
    return p


def _stage_tree(stage) -> dict:
    p = {"Dense_0": _leaves(stage.conv_in), "Dense_1": _leaves(stage.conv_out)}
    for j, layer in enumerate(stage.layers):
        p[f"DilatedResidualLayer_{j}"] = {
            **{k: _array(getattr(layer, k)) for k in _DRL_LEAVES},
            "Dense_0": _leaves(layer.pointwise)}
    return p


def _layer(sub, put, prefix, own, with_res, without_res):
    """One layer's flax subtree into port keys under ``prefix``."""
    roles = with_res if "res_kernel" in sub else without_res
    rename = dict(_norm_roles(prefix, sub, roles), GraphConv_0="gcn")
    for k, v in sub.items():
        if k in own:
            put(f"{prefix}{k}", v)
        elif k in rename:
            for leaf, lv in _flat(v):
                put(f"{prefix}{rename[k]}.{leaf}", lv)
        else:
            raise ValueError(f"unexpected JAX parameter {prefix}{k}")


def _layered(p, put, cls, prefix=""):
    """The flax tree of an RT-ST-GCN, a CoST-GCN or an ST-GCN (``cls``)
    into port keys under ``prefix``."""
    for name, sub in p.items():
        if name == "edge_importance":
            put(prefix + name, sub)
        elif name in ("norm_in", "fcn_in", "fcn_out"):
            for leaf, v in _flat(sub):
                put(f"{prefix}{name}.{leaf}", v)
        elif name.startswith("layers_"):
            _layer(sub, put, f"{prefix}layers.{int(name.removeprefix('layers_'))}.",
                   *_LAYERS[cls])
        else:
            raise ValueError(f"unexpected JAX parameter {prefix}{name}")


def _stream(tree, put, prefix):
    """One AA-GCN stream's flax tree into port keys under ``prefix``."""
    rename = {"Dense_0": "fcn_in", "Dense_1": "fcn_out",
              **_norm_roles(prefix, tree, ("norm_in",))}
    for name, sub in tree.items():
        if name == "edge_importance":
            put(prefix + name, sub)
        elif name in rename:
            for leaf, v in _flat(sub):
                put(f"{prefix}{rename[name]}.{leaf}", v)
        elif name.startswith("AgcnLayer_"):
            base = f"{prefix}layers.{int(name.removeprefix('AgcnLayer_'))}."
            for k, v in sub.items():
                if k in _AGCN_LEAVES:
                    put(base + k, v)
                elif k == "StgcnLayer_0":
                    _layer(v, put, f"{base}layer.", *_TCN_LAYER)
                else:
                    raise ValueError(f"unexpected JAX parameter {base}{k}")
        else:
            raise ValueError(f"unexpected JAX parameter {prefix}{name}")


def _stage_prefix(model, s: int) -> str:
    """The port prefix of flax's ``SingleStage_s``: MS-TCN's first stage is
    its generator, MS-GCN's are all refinement stages."""
    if isinstance(model, MsTcn):
        return "generator_stage." if s == 0 else f"refinement_stages.{s - 1}."
    return f"refinement_stages.{s}."


def _stage(tree, put, prefix):
    """One MS-TCN single stage's flax tree into port keys under ``prefix``."""
    for name, sub in tree.items():
        if name in ("Dense_0", "Dense_1"):
            for leaf, v in _flat(sub):
                put(f"{prefix}{'conv_in' if name == 'Dense_0' else 'conv_out'}.{leaf}", v)
        elif name.startswith("DilatedResidualLayer_"):
            base = f"{prefix}layers.{int(name.removeprefix('DilatedResidualLayer_'))}."
            for k, v in sub.items():
                if k in _DRL_LEAVES:
                    put(base + k, v)
                elif k == "Dense_0":
                    for leaf, lv in _flat(v):
                        put(f"{base}pointwise.{leaf}", lv)
                else:
                    raise ValueError(f"unexpected JAX parameter {base}{k}")
        else:
            raise ValueError(f"unexpected JAX parameter {prefix}{name}")


def _shift(tree, put, prefix, cls):
    """The flax tree of Shift-GCN module ``cls`` into port keys under
    ``prefix``, recursing into its units and blocks."""
    if cls is ShiftGcn:
        for name, sub in tree.items():
            if name in ("data_bn", "fc"):
                for leaf, v in _flat(sub):
                    put(f"{prefix}{name}.{leaf}", v)
            elif name.startswith("units_"):
                _shift(sub, put, f"{prefix}units.{int(name.removeprefix('units_'))}.",
                       ShiftUnit)
            else:
                raise ValueError(f"unexpected JAX parameter {name}")
        return
    # (own leaves, child blocks, norm roles in creation order)
    leaves, children, roles = {
        ShiftUnit: ({"res_kernel", "res_bias"},
                    {"SpatialShiftBlock_0": ("spatial", SpatialShiftBlock),
                     "TemporalShiftBlock_0": ("temporal", TemporalShiftBlock)},
                    ["res_norm"] if "res_kernel" in tree else []),
        SpatialShiftBlock: ({"kernel", "bias", "feature_mask", "down_kernel", "down_bias"},
                            {}, ["norm", "down_norm"] if "down_kernel" in tree else ["norm"]),
        TemporalShiftBlock: ({"shift_in", "shift_out", "linear_kernel", "linear_bias"},
                             {}, ["in_norm", "out_norm"]),
    }[cls]
    norms = _norm_roles(prefix, tree, roles)
    for k, v in tree.items():
        if k in leaves:
            put(prefix + k, v)
        elif k in norms:
            for leaf, lv in _flat(v):
                put(f"{prefix}{norms[k]}.{leaf}", lv)
        elif k in children:
            name, child = children[k]
            _shift(v, put, f"{prefix}{name}.", child)
        else:
            raise ValueError(f"unexpected JAX parameter {prefix}{k}")
