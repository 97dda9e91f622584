"""Fused RT-ST-GCN layer core ``window_sum(gcn(x, A, W) + beff)``.

Replaces the TPU kernel ``stgx/ops/rt_fused.py:_fwd_kernel`` (launched by
``_fwd_call``) with the hand-written CUDA kernel ``csrc/rt_fused.cu``; the
pre-window-sum activation never reaches device memory.

Bound on the H100: operations, as for :mod:`stgx_torch.ops.gcn_core`; the
kernel reads x and writes y and nothing else of size. The design answer,
in the source's note: the TPU kernel carried a ``(K−1)·s``-frame halo from
one time tile to the next in a sequential grid, which blocks running in no
order cannot do, so each block recomputes the graph conv for the halo
frames before its tile (8 extra frames per 32 at Γ=9, s=1) and stays
independent.

Numerics: the bias enters before the window-sum (frames before t=0 stay
zero, the empty-FIFO edge), and the window sums in fp32 before the one cast
to x's type, as the TPU kernel did.

:func:`rt_fused_gcn_acc` keeps the JAX package's dispatch rule
(``stgx/ops/rt_fused.py:398-405``): when the halo exceeds the TPU kernel's
smallest time tile, the unfused chain runs instead, which on the card is
the gcn_core and window_sum kernels.
"""

from __future__ import annotations

import torch

from stgx_torch import kernels
from stgx_torch.ops.gcn_core import gcn_core_plain
from stgx_torch.ops.graph_conv import partitioned_gcn
from stgx_torch.ops.temporal import causal_accumulate
from stgx_torch.ops.window_sum import window_sum_plain

__all__ = [
    "rt_fused_gcn_acc",
    "rt_fused_core",
    "rt_fused_plain",
    "set_rt_fused",
    "rt_fused_enabled",
]

_ENABLED = False


def set_rt_fused(on: bool) -> None:
    """Select the fused layer core for RtLayer (read at each forward)."""
    global _ENABLED
    _ENABLED = bool(on)


def rt_fused_enabled() -> bool:
    return _ENABLED


def _tile_t(cin: int, cout: int, fwd: bool) -> int:
    """The JAX kernel's time tile, which its dispatch rule compares the halo
    with (``stgx/ops/rt_fused.py:_tile_t``)."""
    c = max(cin, cout)
    if fwd:
        return 128 if c <= 128 else 64
    return 64 if c <= 128 else 32


def rt_fused_plain(x, A, W, beff, gamma: int, stride: int):
    """The plain PyTorch version: graph conv and bias in fp32, window-sum in
    fp32, one cast to x's type."""
    n, l, v, cin = x.shape
    z = gcn_core_plain(x.float().reshape(n * l, v, cin), A.to(x.dtype),
                       W.to(x.dtype))
    z = z.reshape(n, l, v, -1) + beff.to(x.dtype).float()
    return window_sum_plain(z, gamma, stride).to(x.dtype)


def rt_fused_core(x, A, W, beff, gamma: int, stride: int):
    """``window_sum(gcn(x, A, W) + beff)`` over ``(N, L, V, C_in)``.

    ``beff`` is the ``(V, C_out)`` effective bias. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel.
    """
    if x.dim() != 4:
        raise ValueError(f"rt_fused: x must be (N, L, V, C), got {tuple(x.shape)}")
    n, l, v, cin = x.shape
    p, _, cout = W.shape
    if A.shape != (p, v, v) or W.shape[1] != cin or beff.shape != (v, cout):
        raise ValueError(
            f"rt_fused: shapes x {tuple(x.shape)}, A {tuple(A.shape)}, "
            f"W {tuple(W.shape)}, beff {tuple(beff.shape)} do not agree"
        )
    if x.device.type == "cpu":
        return rt_fused_plain(x, A, W, beff, gamma, stride)
    if x.device.type != "cuda":
        raise ValueError(f"rt_fused: no kernel for device {x.device}")
    if v > 32 or p > 4 or n > 65535:
        raise ValueError(
            f"rt_fused: the kernel takes V <= 32, P <= 4, N <= 65535 "
            f"(got {v}, {p}, {n})"
        )
    A = A.to(x.dtype).contiguous()
    W = W.to(x.dtype).contiguous()
    beff = beff.to(x.dtype).contiguous()
    code = kernels.validate("rt_fused", x, A, W, beff)
    y = torch.empty((n, l, v, cout), dtype=x.dtype, device=x.device)
    if n * l == 0:
        return y
    taps = max(1, gamma // stride)
    rc = kernels.load().stgx_rt_fused(
        x.data_ptr(), A.data_ptr(), W.data_ptr(), beff.data_ptr(), y.data_ptr(),
        n, l, v, p, cin, cout, taps, stride, code, kernels.stream_handle(),
    )
    kernels.check(rc, "rt_fused")
    rt_fused_core.launches += 1
    return y


rt_fused_core.launches = 0


def rt_fused_gcn_acc(x, A, W, b, gamma: int, stride: int):
    """Fused ``causal_accumulate(partitioned_gcn(x, A, W, b), Γ, s)``."""
    taps = max(1, gamma // stride)
    halo = max(stride, (taps - 1) * stride)
    cin, cout = x.shape[-1], W.shape[-1]
    if halo > min(_tile_t(cin, cout, fwd=True), _tile_t(cin, cout, fwd=False)):
        return causal_accumulate(partitioned_gcn(x, A, W, b), gamma, stride)
    if b is not None:
        beff = torch.einsum("pvw,pd->wd", A.float(), b.float())
    else:
        beff = torch.zeros((A.shape[-1], cout), dtype=torch.float32,
                           device=x.device)
    return rt_fused_core(x, A, W, beff, gamma, stride)
