"""Native (C++) host components, bound with ctypes — the port of
``stgx/native``.

The threaded ``.npy`` loader (``npy_loader.cpp``, a copy of the JAX
package's): it parses ``.npy`` files (format 1.0 / 2.0, little-endian
``<f4``, ``<f8``, ``<i4``, ``<i8``, C order) to float32, and decodes a list
of them on background threads in order (:class:`Prefetcher`), so that host
IO overlaps the device's work. :class:`stgx_torch.data.SkeletonDirDataset`
reads its trials through :func:`load_npy_f32`.

The library is built with ``g++`` at first use into
``stgx_torch/_build/native-<hash of the source>/`` (git-ignored; never
beside the source) and reused by later processes. A failed build raises
with ``g++``'s output: there is no silent numpy path that would hide a
broken build. A file the parser does not take (another type or byte order,
Fortran order, not a ``.npy``) is read with ``np.load`` and cast to
float32, as in the JAX package; a missing file raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

__all__ = ["available", "load_npy_f32", "Prefetcher", "native_lib", "library_path"]

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "npy_loader.cpp"
BUILD_DIR = _HERE.parent / "_build"
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
MAX_DIMS = 8  # the shape buffer's length

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """Where the built library lives: keyed by the source and the flags."""
    h = hashlib.sha256(" ".join(FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"native-{h}" / "libstgx_npy.so"


def _build(path: Path) -> None:
    """Compile the source into ``path`` (atomically: concurrent processes
    each write their own file and rename it into place)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
    os.close(fd)
    try:
        try:
            proc = subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", tmp],
                                  capture_output=True, text=True, timeout=300)
        except FileNotFoundError as e:
            raise RuntimeError("g++ not found: the native .npy loader is built with it at "
                               "first use") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE.name} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def native_lib():
    """The loaded library, built first if it is not there; raises
    ``RuntimeError`` with the compiler's output if the build fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        lib.stgx_npy_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
                                      ctypes.POINTER(ctypes.c_int)]
        lib.stgx_npy_read_f32.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                          ctypes.c_long]
        lib.stgx_prefetch_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int]
        lib.stgx_prefetch_open.restype = ctypes.c_void_p
        lib.stgx_prefetch_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                                           ctypes.c_long, ctypes.POINTER(ctypes.c_long),
                                           ctypes.POINTER(ctypes.c_int)]
        lib.stgx_prefetch_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library is built and loaded (building it if need be; a
    failed build raises)."""
    return native_lib() is not None


def _float_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def load_npy_f32(path: str) -> np.ndarray:
    """A ``.npy`` file as float32: the native parser's, or ``np.load``'s
    cast for a file the parser does not take; a missing file raises
    ``FileNotFoundError``."""
    lib = native_lib()
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    shape = (ctypes.c_long * MAX_DIMS)()
    ndim = ctypes.c_int()
    if lib.stgx_npy_info(os.fsencode(path), shape, ctypes.byref(ndim)) != 0:
        return np.load(path).astype(np.float32)
    shp = tuple(shape[i] for i in range(ndim.value))
    out = np.empty(int(np.prod(shp)), dtype=np.float32)
    if lib.stgx_npy_read_f32(os.fsencode(path), _float_ptr(out), out.size) < 0:
        return np.load(path).astype(np.float32)
    return out.reshape(shp)


class Prefetcher:
    """Ordered background decoding of a list of ``.npy`` files.

    Usage::

        with Prefetcher(paths, ahead=4) as pf:
            for arr in pf:
                ...

    ``ahead`` files are decoded ahead of the consumer on ``threads``
    threads; a file larger than ``max_elems`` values, or one the parser does
    not take, is read with ``np.load`` in its turn.
    """

    def __init__(self, paths: list[str], ahead: int = 4, threads: int = 2,
                 max_elems: int = 64 << 20):
        self.paths = list(paths)
        self.ahead = ahead
        self.threads = threads
        self.max_elems = max_elems
        self._h = None

    def __enter__(self):
        lib = native_lib()
        arr = (ctypes.c_char_p * len(self.paths))(*[os.fsencode(p) for p in self.paths])
        self._h = lib.stgx_prefetch_open(arr, len(self.paths), self.ahead, self.threads)
        self._idx = 0
        return self

    def __exit__(self, *exc):
        if self._h is not None:
            native_lib().stgx_prefetch_close(self._h)
            self._h = None

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._idx >= len(self.paths):
            raise StopIteration
        path = self.paths[self._idx]
        self._idx += 1
        out = np.empty(self.max_elems, dtype=np.float32)
        shape = (ctypes.c_long * MAX_DIMS)()
        ndim = ctypes.c_int()
        if native_lib().stgx_prefetch_next(self._h, _float_ptr(out), out.size, shape,
                                           ctypes.byref(ndim)) != 0:
            return np.load(path).astype(np.float32)
        shp = tuple(shape[i] for i in range(ndim.value))
        return out[: int(np.prod(shp))].reshape(shp).copy()
