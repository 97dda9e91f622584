"""Config loading and the model builder — the port of ``stgx/config.py``.

The config schema is the JAX package's (groups ``processor``, ``arch``,
``optimizer``, ``job``), JSON file ⊕ dotted ``group.key=value`` overrides,
overrides winning. :func:`build_model` builds ``rt-st-gcn`` and
``shift-gcn``; the other families raise ``NotImplementedError`` (see
``ROADMAP.md``).
"""

from __future__ import annotations

import json
from typing import Any

import torch

from stgx_torch.graph import load_skeleton
from stgx_torch.models import MODELS
from stgx_torch.ops.rt_fused import set_rt_fused

__all__ = ["load_config", "build_model", "DEFAULTS"]

DEFAULTS: dict[str, dict[str, Any]] = {
    "processor": {
        "model": "rt-st-gcn",
        "data": None,
        "dataset_type": "dir",
        "out": "./out",
        "actions": None,
        "graph": "pku-mmd",
        "demo": [],
        "iou_threshold": [0.1, 0.25, 0.5],
        "checkpoint": None,
    },
    "arch": {
        "strategy": "spatial",
        "in_feat": 3,
        "stages": 1,
        "kernel": 9,
        "output_type": "logits",
        "refine": "softmax",
        "normalization": "BatchNorm",
        "receptive_field": 50,
        "segment": None,
    },
    "optimizer": {
        "seed": 1538574472,
        "epochs": 10,
        "checkpoint_indices": [],
        "learning_rate": 5e-4,
        "learning_rate_decay": 1.0,
        "batch_size": 16,
    },
    "job": {"email": None, "log": [None, None], "verbose": 0,
            "mesh": {"data": None, "seq": 1}},
}


def _deep_update(base: dict, new: dict) -> dict:
    for k, v in new.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_update(base[k], v)
        else:
            base[k] = v
    return base


def _parse_value(s: str):
    try:
        return json.loads(s)
    except json.JSONDecodeError:
        return s


def load_config(config_path: str | None, overrides: list[str] | None = None) -> dict:
    """Defaults ⊕ the JSON file ⊕ ``group.key=value`` overrides (JSON-parsed)."""
    cfg = json.loads(json.dumps(DEFAULTS))  # deep copy
    if config_path:
        with open(config_path) as f:
            _deep_update(cfg, json.load(f))
    for item in overrides or []:
        key, _, value = item.partition("=")
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _parse_value(value)
    return cfg


def build_model(cfg: dict, num_classes: int, device=None,
                generator: torch.Generator | None = None):
    """Build the configured model on ``device`` (``cuda`` if None).

    ``arch.rt_fused`` selects the fused layer core (process-wide, as in the
    JAX package's CLI). Parameters come from ``generator``, or from one
    seeded with ``optimizer.seed``.
    """
    arch = cfg["arch"]
    name = cfg["processor"]["model"]
    model_cls = MODELS[name]  # raises for the families not ported yet
    kw = dict(
        num_classes=num_classes,
        in_feat=arch["in_feat"],
        graph=load_skeleton(cfg["processor"]["graph"]),
        strategy=arch.get("strategy", "spatial"),
        normalization=arch.get("normalization", "BatchNorm"),
        remat=bool(arch.get("remat", False)),
    )
    # each family's own keywords, as stgx/config.py passes them
    if name == "shift-gcn":
        sub = arch.get(name, {})
        layer_keys = ("in_ch", "out_ch", "stride", "residual")
    else:
        sub = arch.get(name, arch.get("st-gcn", {}))
        kw["kernel"] = sub.get("kernel", arch.get("kernel", 9))
        kw["importance"] = bool(sub.get("importance", True))
        layer_keys = ("in_ch", "out_ch", "stride", "residual", "dropout")
    for key in layer_keys:
        if key in sub:
            kw[key] = tuple(sub[key])
    if "rt_fused" in arch:
        set_rt_fused(bool(arch["rt_fused"]))
    if generator is None:
        generator = torch.Generator().manual_seed(int(cfg["optimizer"]["seed"]))
    return model_cls(**kw, device=device, generator=generator)
