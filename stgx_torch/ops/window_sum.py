"""Causal window-sum ``y[t] = Σ_{j<K} x[t − j·s]``, ``K = Γ // s``.

Replaces the TPU kernel ``stgx/ops/pallas_acc.py:_kernel`` (launched by
``_call``, in both directions) with the hand-written CUDA kernel
``csrc/window_sum.cu``. Frames before ``t = 0`` are zero (the empty FIFO);
with ``reverse=True`` it is the anti-causal sum ``Σ_j x[t + j·s]``, the
forward's vector-Jacobian product, with frames past the end zero.

Bound on the H100: bytes. ``K ≤ 9`` adds per element against one read and
one write of the ``(N, L, V·C)`` activation. The design answer, in the
source's note: threads run over the contiguous ``V·C`` axis so every load
coalesces, and a row's re-reads by later frames come from cache. Unlike the
TPU kernel there is no limit on ``(K − 1)·s``.

Numerics: the taps sum in fp32 in the order ``j = 0, 1, …`` and the result
is cast once to x's type.

Gradient: :func:`window_sum` is a ``torch.autograd.Function``, the port of
the JAX ``custom_vjp`` (``_acc_fwd``/``_acc_bwd``): its backward is the same
kernel in the other direction. ``K ≤ 1`` stays the identity, with the
identity as its gradient.
"""

from __future__ import annotations

import torch

from stgx_torch import kernels

__all__ = ["window_sum", "window_sum_plain"]


def window_sum_plain(x, kernel_size: int, stride: int, reverse: bool = False):
    """The plain PyTorch version: K shifted adds over the time axis in fp32
    (fp64 for fp64 input)."""
    k = kernel_size // stride
    if k <= 1:
        return x
    l = x.shape[1]
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    y = xf.clone()
    for j in range(1, k):
        o = j * stride
        if o >= l:
            break
        if reverse:
            y[:, : l - o] += xf[:, o:]
        else:
            y[:, o:] += xf[:, : l - o]
    return y.to(x.dtype)


def _window(x, k: int, stride: int, reverse: bool):
    """The window-sum on its device: the plain version for a CPU tensor, the
    kernel for a CUDA tensor (K > 1)."""
    if x.device.type == "cpu":
        return window_sum_plain(x, k * stride, stride, reverse)
    code = kernels.validate("window_sum", x)
    n, l, v, c = x.shape
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    rc = kernels.load().stgx_window_sum(
        x.data_ptr(), y.data_ptr(), n, l, v * c, k, stride, int(reverse), code,
        kernels.stream_handle(),
    )
    kernels.check(rc, "window_sum")
    window_sum.launches += 1
    return y


class _WindowSum(torch.autograd.Function):
    """``custom_vjp`` of the window-sum: the VJP of one direction is the
    other direction."""

    @staticmethod
    def forward(ctx, x, k, stride, reverse):
        ctx.args = (k, stride, reverse)
        return _window(x, k, stride, reverse)

    @staticmethod
    def backward(ctx, g):
        k, stride, reverse = ctx.args
        return _window(g.contiguous(), k, stride, not reverse), None, None, None


def window_sum(x, kernel_size: int, stride: int, reverse: bool = False):
    """Window-sum of ``(N, L, V, C)`` over L with ``Γ // s`` taps ``s`` apart,
    differentiable.

    ``K ≤ 1`` returns x itself. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel.
    """
    if x.dim() != 4:
        raise ValueError(f"window_sum: x must be (N, L, V, C), got {tuple(x.shape)}")
    k = kernel_size // stride
    if k <= 1:
        return x
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"window_sum: no kernel for device {x.device}")
    return _WindowSum.apply(x, k, stride, bool(reverse))


window_sum.launches = 0
