"""Carry JAX (flax) RT-ST-GCN variables into the port's ``state_dict``.

The port keeps stgx's parameter shapes, so the mapping is renames only:

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

Norm names: flax numbers a layer's norms in creation order. A layer with a
residual 1×1 conv creates the residual norm first, so there ``*Norm_0`` is
``res_norm`` and ``*Norm_1`` is ``norm``; elsewhere ``*Norm_0`` is ``norm``
(the same sorted-name rule as ``stgx/models/rtstgcn.py:stream_step``).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

__all__ = ["from_jax_params"]


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def from_jax_params(params, model) -> dict[str, torch.Tensor]:
    """``{"params": {...}}`` with numpy leaves → the port's ``state_dict``
    for ``model`` (tensors on its device, in its parameter type), ready for
    ``model.load_state_dict(sd, strict=True)``."""
    p = params["params"]
    ref = next(model.parameters())
    out = {}

    def put(key, value):
        out[key] = torch.tensor(np.asarray(value, dtype=np.float32)).to(
            device=ref.device, dtype=ref.dtype)

    for name, sub in p.items():
        if name == "edge_importance":
            put(name, sub)
        elif name in ("norm_in", "fcn_in", "fcn_out"):
            for leaf, v in _flat(sub):
                put(f"{name}.{leaf}", v)
        elif name.startswith("layers_"):
            i = int(name.removeprefix("layers_"))
            norms = sorted(k for k in sub if k.startswith(("LayerNorm", "BatchNorm")))
            roles = ["res_norm", "norm"] if "res_kernel" in sub else ["norm"]
            if len(norms) != len(roles):
                raise ValueError(f"{name}: norms {norms} do not fit {roles}")
            rename = dict(zip(norms, roles), GraphConv_0="gcn")
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
    return out
