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
                       gradients (autograd Functions); the temporal conv
  stgx_torch.models    RT-ST-GCN and CoST-GCN (batch form and streaming
                       cell each) and Shift-GCN (window classifier)
  stgx_torch.weights   JAX parameter tree <-> the port's ``state_dict``
  stgx_torch.config    config loading, the command-line parser and
                       ``build_model``
  stgx_torch.cli       ``python -m stgx_torch.cli {train|test|benchmark}``
  stgx_torch.utils     loss, top-k statistics, segmental metrics, MACs and
                       byte counters, checkpoints, reference-checkpoint
                       import and export, mail and result backup
  stgx_torch.data      the file and directory datasets, prefetching and the
                       synthetic generator
  stgx_torch.parallel  length buckets, per-frame windows and the one-device
                       Trainer (frame and window kinds)
  stgx_torch.bench     streaming latency (the FIFO cells and the window
                       cell) and the CLI's benchmark, the B-stream serving
                       cells and their drift check,
                       train-step throughput and the headline (``bench.py``'s
                       counterpart)

Every op that has a hand-written kernel launches it for a CUDA tensor and
uses its plain PyTorch version only for a CPU tensor; its backward does the
same with the backward kernels where the JAX package had one, and with the
temporal shift's backward kernel. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"`` (the CLI: ``job.platform: "cpu"``), after
:func:`strict_numerics`.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

__all__ = ["default_device", "strict_numerics"]


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


def strict_numerics() -> None:
    """What every entry point sets before it runs, process-wide: TF32 off
    for matmuls and cuDNN convolutions (``torch.backends.cudnn.allow_tf32``
    defaults to on), so fp32 work stays fp32 as the JAX package's parity
    runs hold it; and cuDNN's deterministic algorithms, so a training run
    repeats bit for bit and a run resumed from a checkpoint equals the
    unbroken one (its default backward convolutions add with atomics)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
