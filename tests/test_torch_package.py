"""The port's package rules, its kernel build and its chip smoke script,
checked on a CPU-only machine.

* ``stgx_torch`` imports no ``jax``, ``flax`` or ``stgx`` module (checked in
  a fresh interpreter, since this test process imports JAX itself), and
  importing every module, the host tools' included, loads no matplotlib;
* an entry point given no device on a machine without CUDA raises instead
  of running on the CPU;
* the nvcc build compiles every source of ``stgx_torch/csrc`` for sm_90a,
  one process per source, and links one library (driven by a stand-in
  compiler here);
* ``chip_smoke.py`` fails, printing no result, where there is no card.
"""

import os
import pkgutil
import shutil
import stat
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import stgx_torch
from stgx_torch import default_device
from stgx_torch.config import build_model, load_config
from stgx_torch.graph import load_skeleton
from stgx_torch.kernels import build
from stgx_torch.models.rtstgcn import RtStgcn
from stgx_torch.ops.temporal import init_accumulator_state

ROOT = Path(__file__).resolve().parent.parent
CONFIG = str(ROOT / "configs/pku-mmd/as_is/rtstgcn.json")


def _python(code: str, cwd=ROOT):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=120)


def test_port_imports_nothing_of_jax_or_stgx():
    modules = sorted(m.name for m in pkgutil.walk_packages(stgx_torch.__path__,
                                                          "stgx_torch."))
    assert "stgx_torch.bench.serving" in modules and "stgx_torch.weights" in modules
    assert {"stgx_torch.parallel.loop", "stgx_torch.ops.gcn_grads",
            "stgx_torch.bench.train_throughput", "stgx_torch.data.synth",
            "stgx_torch.utils.loss", "stgx_torch.cli", "stgx_torch.bench.headline",
            "stgx_torch.utils.metrics", "stgx_torch.utils.checkpoint",
            "stgx_torch.utils.torch_import", "stgx_torch.utils.notify",
            "stgx_torch.data.prefetch", "stgx_torch.models._remat",
            "stgx_torch.models.stgcn", "stgx_torch.models.aagcn", "stgx_torch.models.mstcn",
            "stgx_torch.models.msgcn", "stgx_torch.parallel.segments",
            "stgx_torch.bench.ablate", "stgx_torch.data.prep", "stgx_torch.utils.visualize",
            "stgx_torch.native", "stgx_torch.bench.traffic_audit",
            "stgx_torch.bench.switch_probe", "stgx_torch.bench.quant_probe"} <= set(modules)
    code = "\n".join([
        "import importlib, sys",
        *(f"importlib.import_module({m!r})" for m in modules),
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax', 'orbax', 'stgx')",
        "             or m.startswith(('jax.', 'flax.', 'jaxlib', 'orbax.', 'stgx.')))",
        "print(bad)",
        "print('matplotlib' in sys.modules)",  # visualize imports it only to plot
    ])
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]", "False"]


@pytest.mark.parametrize("entry", ["default_device", "build_model", "RtStgcn",
                                   "init_accumulator_state"])
def test_entry_points_without_a_device_refuse_a_cudaless_machine(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "default_device": lambda: default_device(),
        "build_model": lambda: build_model(load_config(CONFIG), 52),
        "RtStgcn": lambda: RtStgcn(5, 3, load_skeleton("pku-mmd"), in_ch=(8,),
                                   out_ch=(8,), stride=(1,), residual=(1,),
                                   dropout=(0.0,)),
        "init_accumulator_state": lambda: init_accumulator_state(1, 25, 8, 9, 1),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
    assert default_device("cpu") == torch.device("cpu")


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in nvcc that logs its arguments and writes its ``-o`` file."""
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    log = tmp_path / "calls.log"
    nvcc = bindir / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> {log}\n'
        'while [ $# -gt 0 ]; do if [ "$1" = -o ]; then touch "$2"; fi; shift; done\n'
    )
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    return log


def test_build_compiles_each_source_for_sm90a_and_links_one_library(fake_nvcc):
    lib = build.build()
    assert lib == build.BUILD_DIR / build.source_hash() / build.LIB_NAME
    assert lib.is_file()
    calls = fake_nvcc.read_text().splitlines()
    sources = sorted(p.name for p in build.CSRC.glob("*.cu"))
    assert sources == ["gcn_core.cu", "gcn_grads.cu", "int8_gemm.cu", "int8_gemm_tma_bf16.cu",
                       "int8_gemm_tma_f32.cu", "int8_gemm_tma_i8.cu", "rt_fused.cu",
                       "rt_fused_bwd.cu", "temporal_shift.cu", "w8_gemm_tma_bf16.cu",
                       "w8_gemm_tma_f32.cu", "window_sum.cu"]
    compiles = [c for c in calls if " -c " in c]
    assert sorted(Path(c.split(" -c ")[1].split()[0]).name for c in compiles) == sources
    assert all("arch=compute_90a,code=sm_90a" in c and "-fPIC" in c for c in compiles)
    links = [c for c in calls if "-shared" in c]
    assert len(links) == 1 and links[0].count(".o") == len(sources)
    assert build.build() == lib  # a built hash is reused, not rebuilt
    assert len(fake_nvcc.read_text().splitlines()) == len(calls)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "NVCC_DEFAULT", tmp_path / "no-nvcc")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()


def test_kernel_sources_are_plain_c_with_their_notes():
    for src in sorted(build.CSRC.glob("*.cu")):
        text = src.read_text()
        assert "torch/extension.h" not in text
        assert 'extern "C"' in text
        # the int8 products replace XLA products of the quantized cells (the
        # int8 one at :199, the w8 one at :194), the other sources the TPU
        # kernels under stgx/ops
        replaces = ("Replaces stgx/bench/quant.py:199" if src.name.startswith("int8_gemm")
                    else "Replaces stgx/bench/quant.py:194" if src.name.startswith("w8_gemm")
                    else "Replaces stgx/ops/")
        assert replaces in text and "Bound on the H100" in text


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, where):
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
