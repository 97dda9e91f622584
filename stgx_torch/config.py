"""Config loading and the model builder — the port of ``stgx/config.py``.

The config schema is the JAX package's (groups ``processor``, ``arch``,
``optimizer``, ``job``), JSON file ⊕ dotted ``group.key=value`` overrides,
overrides winning; :func:`parse_args` reads the command line of
``python -m stgx_torch.cli {train|test|benchmark|export} [--config F]
[--set group.key=value ...]``, the JAX package's grammar. :func:`build_model`
builds every family but Shift-GCN++ and its teacher, which raise
``NotImplementedError`` (see ``ROADMAP.md``).
"""

from __future__ import annotations

import argparse
import json
from typing import Any

import torch

from stgx_torch.graph import load_skeleton
from stgx_torch.models import MODELS
from stgx_torch.ops.rt_fused import set_rt_fused

__all__ = ["load_config", "build_model", "make_parser", "parse_args", "DEFAULTS",
           "FAMILY_CONFIGS"]

# the canonical PKU-MMD config of each family, which the serving and
# train-throughput benches take for --model
FAMILY_CONFIGS = {"rt-st-gcn": "configs/pku-mmd/as_is/rtstgcn.json",
                  "co-st-gcn": "configs/pku-mmd/ln/costgcn.json",
                  "st-gcn": "configs/pku-mmd/as_is/stgcn.json",
                  "aa-gcn": "configs/pku-mmd/as_is/aagcn.json",
                  "ms-tcn": "configs/pku-mmd/as_is/mstcn.json",
                  "ms-gcn": "configs/pku-mmd/as_is/msgcn.json"}

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


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="stgx_torch",
        description="spatial-temporal GNNs on one CUDA device "
        "(train | test | benchmark)",
    )
    sub = p.add_subparsers(dest="command", required=True)
    for name, doc in [
        ("train", "train a model, validating each epoch"),
        ("test", "evaluate a trained checkpoint"),
        ("benchmark", "streaming per-frame latency"),
        ("export", "export the streaming cell (not ported yet)"),
    ]:
        sp = sub.add_parser(name, help=doc)
        sp.add_argument("--config", type=str, default=None, help="JSON config")
        sp.add_argument(
            "--set",
            dest="overrides",
            action="append",
            default=[],
            metavar="GROUP.KEY=VALUE",
            help="override any config value (JSON-parsed); repeatable",
        )
    return p


def parse_args(argv=None):
    """``(command, config)`` from the command line."""
    args = make_parser().parse_args(argv)
    return args.command, load_config(args.config, args.overrides)


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
    if "rt_fused" in arch:
        set_rt_fused(bool(arch["rt_fused"]))
    if generator is None:
        generator = torch.Generator().manual_seed(int(cfg["optimizer"]["seed"]))
    remat = bool(arch.get("remat", False))
    refine = dict(refine=arch.get("refine", "softmax"),
                  output_type=arch.get("output_type", "logits"))
    if name == "ms-tcn":
        sub = arch.get("ms-tcn", {})
        return model_cls(
            num_classes=num_classes, in_feat=arch["in_feat"], stages=sub.get("stages", 4),
            filters=tuple(sub.get("filters", (64,) * 4)),
            layers=tuple(sub.get("layers", (10,) * 4)),
            kernel=tuple(sub.get("kernel", (3,) * 4)),
            dropout=tuple(sub.get("dropout", (0.5,) * 4)),
            remat=remat, device=device, generator=generator, **refine)
    kw = dict(
        num_classes=num_classes,
        in_feat=arch["in_feat"],
        graph=load_skeleton(cfg["processor"]["graph"]),
        strategy=arch.get("strategy", "spatial"),
        normalization=arch.get("normalization", "BatchNorm"),
        remat=remat,
    )
    # each family's own keywords, as stgx/config.py passes them
    if name == "shift-gcn":
        sub = arch.get(name, {})
        layer_keys = ("in_ch", "out_ch", "stride", "residual")
    else:
        # ms-gcn's generator is the st-gcn group
        sub = arch.get("st-gcn" if name == "ms-gcn" else name, arch.get("st-gcn", {}))
        kw["kernel"] = sub.get("kernel", arch.get("kernel", 9))
        kw["importance"] = bool(sub.get("importance", True))
        layer_keys = ("in_ch", "out_ch", "stride", "residual", "dropout")
    if name == "co-st-gcn":
        # the reference reuses its stride array as the conv's dilation
        # (stgx/config.py:158-162): "dilation" wins where both are given, and
        # the model has no stride
        layer_keys = ("in_ch", "out_ch", "residual", "dropout")
        kw["dilation"] = tuple(sub.get("dilation", sub.get("stride", (1,) * 9)))
    for key in layer_keys:
        if key in sub:
            kw[key] = tuple(sub[key])
    if name == "aa-gcn":
        kw["output_type"] = refine["output_type"]
    if name == "ms-gcn":
        # the refinement is the ms-tcn group (stgx/config.py:178-192)
        ref = arch.get("ms-tcn", {})
        kw.update(stages=ref.get("stages", 4), filters=tuple(ref.get("filters", (64,) * 4)),
                  layers=tuple(ref.get("layers", (10,) * 4)),
                  refine_kernel=tuple(ref.get("kernel", (3,) * 4)),
                  refine_dropout=tuple(ref.get("dropout", (0.5,) * 4)), **refine)
    return model_cls(**kw, device=device, generator=generator)
