"""The hand-written CUDA kernels: build, binding and the checks every
wrapper makes before it launches one (see :mod:`stgx_torch.kernels.build`)."""

from __future__ import annotations

import torch

from stgx_torch.kernels.build import check, load

__all__ = ["load", "check", "validate", "stream_handle", "DTYPE_CODES"]

# element types the kernels take, by the code their C entry points expect
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def validate(name: str, x: torch.Tensor, *others: torch.Tensor) -> int:
    """Check that ``x`` and ``others`` suit kernel ``name``: CUDA tensors on
    the current device, one type the kernels take, contiguous. Returns the
    type's code; raises on anything the kernel does not take."""
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: takes float32 or bfloat16, got {x.dtype}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(
            f"{name}: input is on {x.device}, the current device is "
            f"cuda:{torch.cuda.current_device()}"
        )
    for t in (x, *others):
        if t.device != x.device:
            raise ValueError(f"{name}: inputs on {t.device} and {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: inputs of {t.dtype} and {x.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: takes contiguous tensors only")
    return DTYPE_CODES[x.dtype]


def stream_handle() -> int:
    """PyTorch's current CUDA stream, as the handle a C entry point takes."""
    return torch.cuda.current_stream().cuda_stream
