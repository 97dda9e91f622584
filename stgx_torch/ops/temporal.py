"""The RT-ST-GCN causal accumulator, batch and streaming, and the temporal
convolution of CoST-GCN — the port of ``stgx/ops/temporal.py``.

``y[t] = Σ_{i<K} x[t − i·s]`` with ``K = Γ // s`` taps spaced ``s`` frames
apart; frames before the start are zero (the empty FIFO). Time is never
downsampled: ``s`` only widens the tap spacing.

* Batch form: :func:`causal_accumulate`, the window-sum kernel for a CUDA
  tensor (:mod:`stgx_torch.ops.window_sum`), its plain version for a CPU
  one.
* Streaming form: :func:`causal_accumulate_step`, an O(1)-per-frame shift
  FIFO of the last ``(K−1)·s + 1`` frames, in plain tensor ops (the JAX
  package ran it without a Pallas kernel too).
* :func:`temporal_conv`: a Γ-tap convolution over the frame axis, which the
  JAX package runs through XLA's convolution and the port as one matrix
  product a tap (cuBLAS on the card) or, where it is faster, through cuDNN.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stgx_torch import default_device
from stgx_torch.ops.window_sum import window_sum

__all__ = [
    "causal_accumulate",
    "init_accumulator_state",
    "causal_accumulate_step",
    "temporal_conv",
    "conv_route",
    "conv_product",
    "ACC_STEP_IMPLS",
]

ACC_STEP_IMPLS = ("auto", "taps", "fifo_sum")


def causal_accumulate(x, kernel_size: int, stride: int):
    """Batch form of the RT-ST-GCN FIFO over ``(N, L, V, C)``; same length out."""
    return window_sum(x, kernel_size, stride)


def init_accumulator_state(batch, num_joints, channels, kernel_size, stride,
                           dtype=torch.float32, device=None):
    """Zero carry for the streaming accumulator: a shift FIFO of the last
    ``(K−1)·s + 1`` frames, newest at slot ``depth − 1``, in ``dtype``:
    float32 or bfloat16 for the plain cells, and also int8 for the int8
    cell, whose FIFO holds each frame's codes under a calibrated scale
    (``stgx_torch.bench.quant._quant_acc_step``)."""
    k = kernel_size // stride
    depth = (k - 1) * stride + 1
    return {
        "fifo": torch.zeros((depth, batch, num_joints, channels), dtype=dtype,
                            device=default_device(device)),
    }


def causal_accumulate_step(state, x_t, kernel_size: int, stride: int,
                           impl: str = "auto"):
    """One streaming step of the accumulator.

    Args:
        state: carry from :func:`init_accumulator_state`.
        x_t: ``(B, V, C)`` the current frame.
        impl: ``"taps"`` sums the K−1 static FIFO slots; ``"fifo_sum"`` is
            one reduction over the FIFO's tap slots (every s-th); ``"auto"`` picks ``fifo_sum`` iff K ≥ 16 and B ≥ 8, the
            JAX package's rule (``stgx/ops/temporal.py:338-343``).

    Returns ``(y_t, new_state)``, ``y_t`` equal to frame t of
    :func:`causal_accumulate` up to the order of the fp adds.
    """
    if impl not in ACC_STEP_IMPLS:
        raise ValueError(f"unknown acc step impl: {impl!r}")
    k = kernel_size // stride
    if k == 1:
        return x_t, state
    if impl == "auto":
        impl = "fifo_sum" if (k >= 16 and x_t.shape[0] >= 8) else "taps"
    fifo = torch.cat([state["fifo"][1:], x_t[None]], dim=0)
    depth = fifo.shape[0]
    if impl == "fifo_sum":
        # the tap slots depth − 1 − i·s are every s-th slot from
        # (depth − 1) mod s: a strided view, no mask (a mask built from a host
        # list would be a host-to-device copy, which a CUDA graph cannot capture)
        return fifo[(depth - 1) % stride::stride].sum(dim=0), {"fifo": fifo}
    # frame (t − i·s) sits at static slot depth − 1 − i·s
    taps = [fifo[depth - 1 - i * stride] for i in range(1, k)]
    y_t = x_t + torch.stack(taps).sum(dim=0)
    return y_t, {"fifo": fifo}


def temporal_conv(x, W, b=None, stride: int = 1, dilation: int = 1,
                  padding: str | int = "same"):
    """Temporal convolution over the frame axis of ``(N, L, V, C)``.

    Args:
        x: ``(N, L, V, C_in)``.
        W: ``(Γ, C_in, C_out)`` temporal kernel (no joint mixing).
        b: optional ``(C_out,)``.
        stride: temporal stride.
        dilation: temporal dilation.
        padding: ``"same"`` (``(Γ−1)·dilation // 2`` frames on both sides),
            ``"causal"`` (``(Γ−1)·dilation`` frames on the left only), an
            int for that many frames on both sides, or ``"valid"``.

    Returns ``(N, L', V, C_out)`` in x's type, ``y[t] = Σ_j W[j]·x[t·stride
    − pad + j·dilation]`` (a cross-correlation, as XLA's): for ``"same"``
    ``L' = ceil(L / stride)`` where Γ is odd, shorter for ``"valid"``. W and
    b are cast to x's type; the bias is added after the product in that
    type, as the JAX function does.

    The product takes one of two routes (:func:`conv_route`): cuDNN's
    convolution (``F.conv2d``), or Γ matrix products, one a tap
    (:class:`_TapConv`), summed in fp32 (fp64 for fp64 input) and rounded to
    x's type once. Both give the same bits run to run (cuDNN with its
    deterministic algorithms, :func:`stgx_torch.strict_numerics`), so a
    resumed training run equals the unbroken one.
    """
    gamma = W.shape[0]
    eff = (gamma - 1) * dilation
    if padding == "same":
        pad = (eff // 2, eff // 2)
    elif padding == "causal":
        pad = (eff, 0)
    elif padding == "valid":
        pad = (0, 0)
    else:
        pad = (padding, padding)
    if pad != (0, 0):
        x = F.pad(x, (0, 0, 0, 0, *pad))
    route = conv_route(x.device.type, x.dtype, gamma, dilation)
    y = conv_product(x, W.to(x.dtype), stride, dilation, route)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def conv_product(x, W, stride: int, dilation: int, route: str):
    """The product of :func:`temporal_conv` over an already padded ``x``
    ``(N, L, V, C_in)`` and ``W`` ``(Γ, C_in, C_out)`` in x's type, by
    ``route``: ``"cudnn"`` (``F.conv2d``) or ``"taps"`` (:class:`_TapConv`)."""
    if route == "cudnn":
        # (N, L, V, C) is the channels_last layout of (N, C, L, V): V is a
        # second spatial axis with a kernel of 1
        return F.conv2d(x.permute(0, 3, 1, 2), W.permute(2, 1, 0)[..., None],
                        stride=(stride, 1), dilation=(dilation, 1)).permute(0, 2, 3, 1)
    length = max((x.shape[1] - (W.shape[0] - 1) * dilation - 1) // stride + 1, 0)
    return _TapConv.apply(x, W, dilation, stride, length)


def conv_route(device_type: str, dtype, gamma: int, dilation: int) -> str:
    """``"cudnn"`` where cuDNN's convolution was the faster route on the
    H100: a 16-bit type on the card and a dilated span ``(Γ−1)·dilation + 1``
    of at most 17 frames (one CoST-GCN layer of 256 channels, 8 x 1024
    frames, forward and backward in bf16: 2.0 against 7.5 ms at Γ = 9).
    ``"taps"`` elsewhere: in fp32 the taps were as fast or faster at every Γ
    from 9 to 69, and past a span of 17 cuDNN's heuristics leave its
    implicit-GEMM kernels for direct ones, 0.96 s at Γ = 9 with dilation 4
    in bf16 and 3.9 s at Γ = 69 in fp32, where the taps take 7.5 and 150 ms
    (``python -m stgx_torch.bench.temporal_conv``, ``PERF.md``). The CPU
    takes the taps."""
    if (device_type == "cuda" and dtype in (torch.bfloat16, torch.float16)
            and (gamma - 1) * dilation + 1 <= 17):
        return "cudnn"
    return "taps"


def _tap(t, j, dilation, stride, length):
    """The frames tap j of every output reads: ``t[:, j·d + i·s]`` for the
    outputs i, a strided view ``(N, length, V, C)``."""
    start = j * dilation
    return t[:, start: start + (length - 1) * stride + 1: stride]


def _tap_mm(acc, a, w):
    """``acc += a @ w`` over ``(N, L, V, ·)`` tensors, ``acc`` in the
    accumulation type: batched matrix products over views where (L, V)
    merge into one row axis (stride 1), a generic product otherwise."""
    n, l, v, c = a.shape
    if a.stride(1) == v * a.stride(2) and acc.stride(1) == v * acc.stride(2):
        a3, acc3 = a.view(n, l * v, c), acc.view(n, l * v, acc.shape[3])
        wb = w.expand(n, *w.shape)
        if acc.dtype == a.dtype:
            acc3.baddbmm_(a3, wb)
        else:  # bf16 products summed in fp32
            acc3.add_(torch.bmm(a3, wb))
    else:
        acc.add_(torch.matmul(a, w))


def _tap_grad_w(a, g, acc):
    """``Σ_{n,l,v} a[n,l,v,:]ᵀ g[n,l,v,:]`` in the accumulation type."""
    n, l, v, c = a.shape
    if a.stride(1) == v * a.stride(2):
        part = torch.bmm(a.view(n, l * v, c).transpose(1, 2), g.view(n, l * v, g.shape[3]))
        return part.sum(dim=0, dtype=acc)
    return torch.einsum("nlvc,nlvd->cd", a.to(acc), g.to(acc))


class _TapConv(torch.autograd.Function):
    """``y[:, i] = Σ_j x[:, j·d + i·s] @ W[j]`` over an already padded x,
    forward and backward as one matrix product a tap, summed in fp32 (or
    fp64), with no atomics."""

    @staticmethod
    def forward(ctx, x, W, dilation, stride, length):
        ctx.save_for_backward(x, W)
        ctx.geometry = (dilation, stride, length)
        n, _, v, _ = x.shape
        acc = torch.promote_types(x.dtype, torch.float32)
        y = torch.zeros((n, length, v, W.shape[2]), dtype=acc, device=x.device)
        for j in range(W.shape[0] if length else 0):
            _tap_mm(y, _tap(x, j, dilation, stride, length), W[j])
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, W = ctx.saved_tensors
        dilation, stride, length = ctx.geometry
        g = g.contiguous()
        acc = torch.promote_types(x.dtype, torch.float32)
        gx = gW = None
        if ctx.needs_input_grad[0]:
            gx = torch.zeros(x.shape, dtype=acc, device=x.device)
            for j in range(W.shape[0] if length else 0):
                _tap_mm(_tap(gx, j, dilation, stride, length), g, W[j].t())
            gx = gx.to(x.dtype)
        if ctx.needs_input_grad[1]:
            gW = torch.stack([_tap_grad_w(_tap(x, j, dilation, stride, length), g, acc)
                              for j in range(W.shape[0])]).to(W.dtype)
        return gx, gW, None, None, None
