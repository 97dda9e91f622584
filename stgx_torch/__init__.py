"""stgx_torch — the PyTorch/CUDA port of stgx for one NVIDIA H100.

A second package beside the JAX one (``stgx``), which stays the reference the
port is tested against. The port keeps stgx's channels-last ``(N, L, V, C)``
layout and its parameter shapes, so JAX parameters load by renaming alone
(:mod:`stgx_torch.weights`). It imports ``torch`` and ``numpy``, never
``jax``, ``flax`` or ``stgx``.

Layout:
  stgx_torch.graph     skeleton graph builder (its own copy of stgx.graph)
  stgx_torch.kernels   nvcc build of ``csrc/*.cu`` and the ctypes binding
  stgx_torch.ops       norms, graph conv, window-sum, the fused RT-layer core,
                       Shift-GCN's temporal and spatial shifts, and their
                       gradients (autograd Functions)
  stgx_torch.models    RT-ST-GCN (batch form and streaming cell) and
                       Shift-GCN (window classifier)
  stgx_torch.weights   JAX parameter tree -> the port's ``state_dict``
  stgx_torch.config    config loading and the model builder
  stgx_torch.utils     loss, top-k statistics, MACs and byte counters
  stgx_torch.data      the directory dataset and the synthetic generator
  stgx_torch.parallel  length buckets, per-frame windows and the one-device
                       Trainer (frame and window kinds)
  stgx_torch.bench     streaming latency (RT FIFO cell and window cell), the
                       B-stream serving cell and train-step throughput

Every op that has a hand-written kernel launches it for a CUDA tensor and
uses its plain PyTorch version only for a CPU tensor; its backward does the
same with the backward kernels where the JAX package had one (the temporal
shift's backward is PyTorch ops on either device, as the JAX package's is
XLA code). Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

__all__ = ["default_device"]


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else ``cuda``.

    Raises ``RuntimeError`` when no device was given and CUDA is absent: the
    port never carries on on the CPU unless the caller asked for it.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "stgx_torch runs on a CUDA device; none is available. Pass "
            "device='cpu' to run the plain PyTorch versions on the CPU."
        )
    return torch.device("cuda", torch.cuda.current_device())
