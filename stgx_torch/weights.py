"""Carry JAX (flax) variables into the port's ``state_dict``.

The port keeps stgx's parameter shapes, so the mapping is renames only.
RT-ST-GCN:

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
==========================================  ===============================

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
``stgx/models/rtstgcn.py:stream_step``). Shift-GCN's spatial block creates
its main per-joint norm before the down-projection's, its temporal block
the input norm before the output norm, and a unit's only own norm is the
residual's.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from stgx_torch.models.shiftgcn import (
    ShiftGcn,
    ShiftUnit,
    SpatialShiftBlock,
    TemporalShiftBlock,
)

__all__ = ["from_jax_params"]

_SHIFT_MODULES = (ShiftGcn, ShiftUnit, SpatialShiftBlock, TemporalShiftBlock)

_NORMS = ("LayerNorm", "BatchNorm")


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
    ``model.load_state_dict(sd, strict=True)``. ``model`` is an RT-ST-GCN,
    a Shift-GCN or one of Shift-GCN's units or blocks."""
    p = params["params"]
    ref = next(model.parameters())
    out = {}

    def put(key, value):
        out[key] = torch.tensor(np.asarray(value, dtype=np.float32)).to(
            device=ref.device, dtype=ref.dtype)

    if isinstance(model, _SHIFT_MODULES):
        _shift(p, put, "", type(model))
    else:
        _rtstgcn(p, put)
    return out


def _rtstgcn(p, put):
    for name, sub in p.items():
        if name == "edge_importance":
            put(name, sub)
        elif name in ("norm_in", "fcn_in", "fcn_out"):
            for leaf, v in _flat(sub):
                put(f"{name}.{leaf}", v)
        elif name.startswith("layers_"):
            i = int(name.removeprefix("layers_"))
            roles = ["res_norm", "norm"] if "res_kernel" in sub else ["norm"]
            rename = dict(_norm_roles(name, sub, roles), GraphConv_0="gcn")
            for k, v in sub.items():
                if k == "res_kernel":
                    put(f"layers.{i}.res_kernel", v)
                elif k in rename:
                    for leaf, lv in _flat(v):
                        put(f"layers.{i}.{rename[k]}.{leaf}", lv)
                else:
                    raise ValueError(f"unexpected JAX parameter {name}/{k}")
        else:
            raise ValueError(f"unexpected JAX parameter {name}")


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
