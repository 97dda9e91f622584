"""A copy of the benchmark at a tiny size, for runs on the CPU: every
configuration cut to three narrow layers, every traffic mix to a few short
trials or a few streams. The harness's code is the repository's; only the
files it finds by name are rewritten."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TINY_LAYERS = {"layers": 3, "in_ch": [8, 8, 16], "out_ch": [8, 16, 16], "stride": [1, 2, 1],
               "residual": [1, 1, 1], "dropout": [0.0, 0.0, 0.0]}
TINY_TRAFFIC = {"trials": {"trials": 4, "min_frames": 40, "max_frames": 90, "segments": 4,
                           "check_trials": 3, "trace_from": 0, "trace_units": 1},
                "streams": {"streams": 16, "ring_frames": 32, "check_from": 30,
                            "check_stride": 4, "check_steps": 3, "trace_from": 1,
                            "trace_units": 4}}


def _rewrite(path: Path, update) -> None:
    doc = json.loads(path.read_text())
    update(doc)
    path.write_text(json.dumps(doc, indent=1))


def tiny_root(tmp: Path) -> Path:
    """A checkout-like directory under ``tmp`` holding the tiny benchmark."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))

    def layers(doc):
        arch = doc["arch"]
        group = "rt-st-gcn" if "rt-st-gcn" in arch else "st-gcn"
        arch[group].update(TINY_LAYERS)

    for path in (tmp / "benchmark" / "configs").glob("*.json"):
        _rewrite(path, layers)
    for path in (tmp / "benchmark" / "traffic").glob("*.json"):
        _rewrite(path, lambda doc: doc.update(
            {k: v for k, v in TINY_TRAFFIC[doc["generator"]].items() if k in doc}))
    return tmp
