"""The benchmark's harness on the CPU, at a tiny size (``tiny.py``).

Run: ``python -m pytest benchmark/tests -q``. Each cell runs through the
program's plain paths and the reference; faults planted in the program turn
``correct`` false; the frozen arithmetic equals the program's today; the
harness loads nothing of JAX or the JAX package, and the reference nothing
of the program.
"""

from __future__ import annotations

import json
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from tiny import tiny_root  # noqa: E402

from benchmark.harness import yardstick  # noqa: E402
from benchmark.harness.core import run_cell  # noqa: E402
from benchmark.harness.faults import FAULTS, plant  # noqa: E402
from benchmark.harness.spec import cell_names, load_benchmark, resolve  # noqa: E402

SEED = 2**31 + 77  # past 32 signed bits, as the driver's seeds are
CELLS = cell_names(ROOT)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


def _run(root, cell, trace=False, seconds=0.3):
    torch.set_num_threads(2)
    return run_cell(resolve(root, cell), SEED, seconds, trace, "cpu", time.time(),
                    out=lambda line: None)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_resolve_by_name(cell):
    c = resolve(ROOT, cell)
    bench = load_benchmark(ROOT)
    assert c.driver.END_TO_END in {m["name"] for m in c.end_to_end}
    assert "setup_s" in {m["name"] for m in c.end_to_end}
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        assert cell in moved.get("workloads", [cell])
    shapes = c.reference.param_shapes(c.config, c.config["num_classes"])
    assert shapes and set(c.limits)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_plain_path(tiny, cell):
    result, lines = _run(tiny, cell)
    assert result["correct"], lines
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for name, m in result["metrics"].items():
        assert set(m) == {"value", "unit"} and m["value"] > 0, name
    assert set(result["checks"]) == set(resolve(tiny, cell).limits)


def test_trace_run_reports_per_layer_metrics_only(tiny):
    result, _ = _run(tiny, "rtstgcn9.stream", trace=True)
    assert result["correct"]
    # the CPU has no device trace: every reader finds nothing to read
    assert result["metrics"] == {}


def test_dropped_metric_file_is_found(tmp_path):
    root = tiny_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "frames_traced.train", "unit": "frames", "better": "higher",
                               "source": "program_counter", "layer": "model step",
                               "moves": "train_frames_per_s", "workloads": ["rtstgcn9.train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "benchmark" / "metrics" / "frames_traced.train.py").write_text(textwrap.dedent("""
        def read(ctx):
            return float(ctx.counts.get("frames", 0))
    """))
    result, _ = _run(root, "rtstgcn9.train", trace=True)
    assert result["metrics"]["frames_traced.train"]["value"] > 0


# fault: the cell it is planted in (benchmark/harness/faults.py)
FAULT_CELLS = {"state_unchanged": "rtstgcn9.train", "half_batch": "costgcn9.train",
               "stream_half_batch": "rtstgcn9.stream", "stream_logit_altered": "rtstgcn9.stream",
               "label_altered": "costgcn9.offline"}


def test_every_fault_is_tested():
    assert set(FAULT_CELLS) == set(FAULTS)


@pytest.mark.parametrize("fault", sorted(FAULT_CELLS))
def test_fault_in_the_timed_path_is_not_correct(tiny, monkeypatch, fault):
    plant(fault, monkeypatch.setattr)
    result, lines = _run(tiny, FAULT_CELLS[fault])
    assert not result["correct"], lines


def test_frozen_macs_equal_the_programs():
    from stgx_torch.utils.flops import costgcn_macs_per_frame, rt_stgcn_macs_per_frame

    rt = resolve(ROOT, "rtstgcn9.train").config
    co = resolve(ROOT, "costgcn9.train").config
    assert yardstick.macs_per_frame(rt, 52) == rt_stgcn_macs_per_frame()
    assert yardstick.macs_per_frame(co, 52) == costgcn_macs_per_frame()


@pytest.mark.parametrize("rows,cin,cout", [(1, 3, 64), (4096, 64, 128), (5003, 256, 256)])
def test_frozen_traffic_equals_the_programs(rows, cin, cout):
    from stgx_torch.bench.traffic_audit import kernel_traffic

    def meta(*shape):
        return torch.empty(shape, device="meta")

    x, g = meta(rows, 25, cin), meta(rows, 25, cout)
    A, W = meta(3, 25, 25), meta(3, cin, cout)
    assert yardstick.gcn_core_traffic(rows, 25, 3, cin, cout) == kernel_traffic("gcn_core", x, A, W)
    assert (yardstick.gcn_grads_traffic(rows, 25, 3, cin, cout)
            == kernel_traffic("gcn_grads", x, g, A, W))
    for taps, stride in [(9, 1), (4, 2), (1, 1)]:
        assert (yardstick.window_sum_traffic(1, rows, 25 * cout, taps, stride)
                == kernel_traffic("window_sum", meta(1, rows, 25, cout), taps, stride))


def _fresh(code: str) -> dict:
    done = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


def test_harness_loads_no_jax_module(tmp_path):
    found = _fresh(f"""
        import json, sys, time
        sys.path[:0] = [{str(ROOT)!r}, {str(Path(__file__).parent)!r}]
        from pathlib import Path
        from tiny import tiny_root
        from benchmark.harness.core import forbidden_modules, run_cell
        from benchmark.harness.spec import resolve
        root = tiny_root(Path({str(tmp_path)!r}))
        for cell in {CELLS!r}:
            run_cell(resolve(root, cell), 5, 0.2, True, "cpu", time.time(), out=lambda s: None)
        print(json.dumps({{"bad": forbidden_modules(),
                          "port": "stgx_torch" in sys.modules}}))
    """)
    assert found == {"bad": [], "port": True}


def test_reference_loads_nothing_of_the_program():
    found = _fresh(f"""
        import json, sys
        sys.path.insert(0, {str(ROOT)!r})
        import benchmark.reference.common, benchmark.reference.rt_st_gcn
        import benchmark.reference.co_st_gcn
        print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}}
                                & {{"stgx_torch", "stgx", "jax", "jaxlib", "flax"}})))
    """)
    assert found == []


def test_run_without_a_card_prints_no_result():
    done = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "rtstgcn9.train",
                           "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=600,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert done.returncode == 2 and done.stdout.strip() == "", done.stderr[-2000:]
