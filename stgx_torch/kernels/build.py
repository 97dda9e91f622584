"""Build ``stgx_torch/csrc/*.cu`` with nvcc and bind it with ctypes.

The sources expose a plain C interface (no PyTorch headers), so each file
compiles in seconds. :func:`load` compiles them at first use, one ``nvcc``
process per source, all started together, links the objects into one shared
library under ``stgx_torch/_build/<hash of the sources>/``, and loads it. A
later call, or a later process with the same sources, reuses the library.
Nothing runs at import: the CPU code paths never need ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["load", "build", "check", "source_hash", "nvcc_path"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_NAME = "libstgx_kernels.so"
NVCC_DEFAULT = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's own location

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
build_log = ""  # the compiler's output of the build this process ran, if any


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    """Hash of every source and header and of the flags: the build's key."""
    h = hashlib.sha256(" ".join(ARCH_FLAGS + COMPILE_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on the PATH, or
    the toolkit's default location; raises if there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(NVCC_DEFAULT)
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (CUDA_HOME, PATH, /usr/local/cuda): the port's "
        "kernels are built from stgx_torch/csrc at first use on a CUDA machine"
    )


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands concurrently; raise with the output of any that fail."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for c in cmds
    ]
    outs, failed = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        outs.append(out)
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return "".join(outs)


def build() -> Path:
    """Compile and link the kernels unless this hash is built; return the
    library's path."""
    global build_log
    out_dir = BUILD_DIR / source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.is_file():
        return lib_path
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        srcs = sorted(CSRC.glob("*.cu"))
        objs = [Path(tmp) / (src.stem + ".o") for src in srcs]
        compile_cmds = [
            [nvcc, *ARCH_FLAGS, *COMPILE_FLAGS, "-I", str(CSRC), "-c", str(src),
             "-o", str(obj)]
            for src, obj in zip(srcs, objs)
        ]
        log = _run_all(compile_cmds)
        tmp_lib = Path(tmp) / LIB_NAME
        log += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
                          *map(str, objs)]])
        out_dir.mkdir(parents=True, exist_ok=True)
        os.replace(tmp_lib, lib_path)  # atomic: a concurrent loader sees all or nothing
    build_log = log
    return lib_path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.stgx_gcn_core.argtypes = [p, p, p, p, ll, i, i, i, i, i, p]
    lib.stgx_gcn_core.restype = i
    lib.stgx_window_sum.argtypes = [p, p, ll, i, ll, i, i, i, i, p]
    lib.stgx_window_sum.restype = i
    lib.stgx_rt_fused.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
    lib.stgx_rt_fused.restype = i
    lib.stgx_gcn_grads.argtypes = [p, p, p, p, p, p, p, p, ll, i, i, i, i, i, i,
                                   i, p]
    lib.stgx_gcn_grads.restype = i
    lib.stgx_rt_fused_bwd.argtypes = [p, p, p, p, p, p, p, p, p, p, p, p, p, i, i,
                                      i, i, i, i, i, i, i, i, i, p]
    lib.stgx_rt_fused_bwd.restype = i
    lib.stgx_temporal_shift.argtypes = [p, p, p, ll, i, i, i, i, i, i, p]
    lib.stgx_temporal_shift.restype = i
    lib.stgx_error_string.argtypes = [i]
    lib.stgx_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """The bound kernel library, built on the first call in this process."""
    global _lib
    if _lib is None:
        _lib = _bind(ctypes.CDLL(str(build())))
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if rc != 0:
        msg = load().stgx_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
