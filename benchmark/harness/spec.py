"""``BENCHMARK.json`` and the files a cell is made of, found by name.

A cell names a configuration and a traffic mix; the configuration's file
names its model family, whose reference is ``reference/<family>.py``
(hyphens as underscores); the traffic's file names its driver,
``drivers/<driver>.py``; the cell's limits are ``limits/<cell>.json``; each
per-layer metric is ``metrics/<metric>.py``. Nothing here knows a cell,
configuration, traffic mix or metric by name, so a later change adds one by
adding files and entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

__all__ = ["Cell", "load_benchmark", "resolve", "load_file_module", "cell_names"]

BENCH_DIR = "benchmark"


@dataclass
class Cell:
    """Everything one run of a cell needs, resolved from the files."""

    name: str
    root: Path
    chips: int
    config: dict
    traffic: dict
    driver: ModuleType
    reference: ModuleType
    limits: dict
    end_to_end: list
    per_layer: list


def load_benchmark(root: Path) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def cell_names(root: Path) -> list[str]:
    return [w["name"] for w in load_benchmark(root)["workloads"]]


def load_file_module(path: Path, name: str) -> ModuleType:
    """A module from a file, under ``name`` (a metric's name may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files loaded."""
    root = Path(root)
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[cell["config"]]["file"])
    base = root / BENCH_DIR
    traffic = _json(base / "traffic" / f"{cell['traffic']}.json")
    driver = load_file_module(base / "drivers" / f"{traffic['driver']}.py",
                              f"bench_driver_{traffic['driver']}")
    family = config["processor"]["model"].replace("-", "_")
    reference = importlib.import_module(f"{BENCH_DIR}.reference.{family}")
    limits = _json(base / "limits" / f"{name}.json")
    return Cell(
        name=name, root=root, chips=int(cell["chips"]), config=config, traffic=traffic,
        driver=driver, reference=reference, limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )
