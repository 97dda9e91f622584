"""Quantization A/B on one card: the fp32 cell against the int8 cells in
dynamic, calibrated-static and weight-only (w8) modes, measured in one
process — the port of ``stgx/bench/quant_ab.py``.

Each figure is the per-frame device time of the B = 1 streaming cell
captured in a CUDA graph and replayed frame after frame
(:func:`stgx_torch.bench.streaming.graph_frame_ms` for fp32,
:func:`stgx_torch.bench.streaming.measure_quant` for the int8 modes), the
least of ``--repeats`` replays of the ``--frames`` frames. The static
scales are calibrated on the same frames. Latency does not depend on the
weights, so the model runs from its config's random init and frames are
normal from seed 0.

Run (on the card):
    python -m stgx_torch.bench.quant_ab --config configs/pku-mmd/ln/costgcn.json
    python -m stgx_torch.bench.quant_ab --config configs/pku-mmd/as_is/rtstgcn_69.json

Prints one JSON line with the JAX tool's keys (``model``, ``config``,
``fp32_onchip_ms``, ``int8_dynamic_onchip_ms``, ``int8_static_onchip_ms``,
``w8_onchip_ms``, ``best_quant_mode``, ``quant_beats_fp32``,
``calibration_sites``) and ``device``. Without a CUDA device it raises.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

__all__ = ["main", "assemble"]


def assemble(name: str, config: str, fp32_ms: float, modes: dict, sites: int) -> dict:
    """The result line from the measured per-frame times: ``modes`` maps
    ``int8_dynamic``, ``int8_static`` and ``w8`` to their ms."""
    best = min(modes, key=modes.get)
    return {
        "model": name,
        "config": config,
        "fp32_onchip_ms": fp32_ms,
        **{f"{k}_onchip_ms": v for k, v in modes.items()},
        "best_quant_mode": best,
        "quant_beats_fp32": bool(modes[best] <= fp32_ms),
        "calibration_sites": int(sites),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m stgx_torch.bench.quant_ab")
    ap.add_argument("--config", required=True)
    ap.add_argument("--frames", type=int, default=4096)
    ap.add_argument("--classes", type=int, default=52,
                    help="used when the config's actions file is absent")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the quantization A/B is a device measurement; no CUDA device "
                           "is available")

    from stgx_torch import strict_numerics
    from stgx_torch.bench.quant import QUANT_MODELS, calibrate_scales
    from stgx_torch.bench.streaming import graph_frame_ms, measure_quant
    from stgx_torch.config import build_model, load_config
    from stgx_torch.data import load_actions

    strict_numerics()
    cfg = load_config(args.config)
    name = cfg["processor"]["model"]
    if name not in QUANT_MODELS:
        raise SystemExit(f"{name!r} has no quantized streaming cell")
    n_classes = args.classes
    actions = cfg["processor"].get("actions")
    if actions and os.path.exists(actions):
        n_classes = len(load_actions(actions))
    model = build_model(cfg, n_classes)

    rng = np.random.default_rng(0)
    frames = torch.tensor(rng.normal(size=(args.frames, model.num_joints, model.in_feat)),
                          dtype=torch.float32, device=model.A.device)
    qparams = QUANT_MODELS[name][0](model)
    fp32_ms = graph_frame_ms(model, frames, args.repeats)
    dyn_ms = measure_quant(model, name, qparams, frames, args.repeats, mode="dynamic")
    scales = calibrate_scales(model, qparams, frames, name)
    static_ms = measure_quant(model, name, qparams, frames, args.repeats, mode="static",
                              scales=scales)
    w8_ms = measure_quant(model, name, qparams, frames, args.repeats, mode="w8")
    result = assemble(name, args.config, fp32_ms,
                      {"int8_dynamic": dyn_ms, "int8_static": static_ms, "w8": w8_ms},
                      len(scales))
    result["device"] = torch.cuda.get_device_name(model.A.device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
