"""Fused RT-ST-GCN layer core ``window_sum(gcn(x, A, W) + beff)``.

Replaces the TPU kernel ``stgx/ops/rt_fused.py:_fwd_kernel`` (launched by
``_fwd_call``) with the hand-written CUDA kernel ``csrc/rt_fused.cu``; the
pre-window-sum activation never reaches device memory.

Bound on the H100: operations, as for :mod:`stgx_torch.ops.gcn_core`; the
kernel reads x and writes y and nothing else of size. The design answer,
in the source's note: gcn_core's tile code at gcn_core's tiles
(:func:`core_tile`) writes ``z = gcn(x) + beff`` once, in fp32, to a
workspace, and one window pass sums its taps and writes y; the unfused
chain's separate bias pass and its bf16 round trips go. A ring of z in
shared memory (the TPU kernel's carried halo) and the window moved onto
the input were built first and measured; the source's note says why each
gave way.

Numerics: the window sums z in fp32 in the order ``j = 0, 1, …`` (frames
before t=0 are zero, the empty-FIFO edge) and casts once to x's type. In
fp32 y has the unfused chain's bits (gcn_core, the bias add, window_sum);
bf16 runs gcn_core's tensor-core route with z and the window in fp32.

Gradient: :func:`rt_fused_core` is a ``torch.autograd.Function``, the port
of the JAX ``custom_vjp`` (``_rt_fwd``/``_rt_bwd``). Its backward is
:func:`rt_fused_bwd`, the hand-written CUDA kernels of
``csrc/rt_fused_bwd.cu`` that replace ``stgx/ops/rt_fused.py:_bwd_kernel``
(launched by ``_bwd_call``). It returns ``(gx, gA, gW, gbe)``: the
anti-causal window sum ``gy`` of the upstream gradient is formed once into
a workspace (fp32, or bf16 hi + lo), ``gA`` and ``gW`` are ``gcn_grads``'
tensor-core kernels on ``(x, gy)`` with its row splits (in fp32 the
unfused chain's bits), ``gx = Σ_p A_p·U_p`` comes from the
``U_p = gy·W_pᵀ`` tile the gA kernel forms anyway, and ``gbe = Σ gy``; the
fp32 sums are split partials added in a fixed order (no atomics). Bound on the H100: operations,
``2·P·V·(2·C_in·C_out + 3·V·C_in)`` flops a frame for ``(gx, gA, gW)``
against x and g read and gx written. ``beff`` is formed outside the
Function, so autograd routes ``gbe`` to A and b, as in JAX.

:func:`rt_fused_gcn_acc` keeps the JAX package's dispatch rule
(``stgx/ops/rt_fused.py:398-405``): when the halo exceeds the TPU kernel's
smallest time tile, the unfused chain runs instead, which on the card is
the gcn_core and window_sum kernels.
"""

from __future__ import annotations

import torch

from stgx_torch import kernels
from stgx_torch.ops.gcn_core import core_tile, gcn_core_plain
from stgx_torch.ops.gcn_grads import gcn_grads_plain, gcn_grads_splits
from stgx_torch.ops.graph_conv import partitioned_gcn
from stgx_torch.ops.temporal import causal_accumulate
from stgx_torch.ops.window_sum import window_plan, window_sum_plain

__all__ = [
    "rt_fused_gcn_acc",
    "rt_fused_core",
    "rt_fused_plain",
    "rt_fused_bwd",
    "rt_fused_bwd_plain",
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


def workspace_floats(n: int) -> int:
    """fp32 elements of the workspace for n values of gy: n in fp32, or bf16
    hi and lo, the lo part 16 bytes aligned (``csrc/window.cuh``:
    lo_offset)."""
    return -(-n // 8) * 8


def rt_fused_plain(x, A, W, beff, gamma: int, stride: int):
    """The plain PyTorch version: graph conv and bias in fp32, window-sum in
    fp32, one cast to x's type."""
    n, l, v, cin = x.shape
    z = gcn_core_plain(x.float().reshape(n * l, v, cin), A.to(x.dtype),
                       W.to(x.dtype))
    z = z.reshape(n, l, v, -1) + beff.to(x.dtype).float()
    return window_sum_plain(z, gamma, stride).to(x.dtype)


def _fwd(x, A, W, beff, gamma: int, stride: int):
    """The forward on its device: the plain version for a CPU tensor, the
    kernel for a CUDA tensor (A and W already in x's type)."""
    if x.device.type == "cpu":
        return rt_fused_plain(x, A, W, beff, gamma, stride)
    n, l, v, cin = x.shape
    p, _, cout = W.shape
    A = A.contiguous()
    W = W.contiguous()
    beff = beff.to(x.dtype).contiguous()
    code = kernels.validate("rt_fused", x, A, W, beff)
    y = torch.empty((n, l, v, cout), dtype=x.dtype, device=x.device)
    if n * l == 0:
        return y
    taps = max(1, gamma // stride)
    z = torch.empty(n * l * v * cout, dtype=torch.float32, device=x.device)
    rc = kernels.load().stgx_rt_fused(
        x.data_ptr(), A.data_ptr(), W.data_ptr(), beff.data_ptr(), y.data_ptr(), z.data_ptr(),
        n, l, v, p, cin, cout, taps, stride, code | core_tile(n * l, cout) << 8,
        window_plan(stride), kernels.stream_handle(),
    )
    kernels.check(rc, "rt_fused")
    rt_fused_core.launches += 1
    return y


def rt_fused_bwd_plain(x, g, A, W, gamma: int, stride: int):
    """The plain PyTorch version of the backward: the anti-causal window-sum
    of g in fp32, the graph conv of it on the transposes, the two parameter
    gradients, and its sum for ``gbe``. Returns ``(gx, gA, gW, gbe)``."""
    dt = x.dtype
    n, l, v, cin = x.shape
    cout = W.shape[-1]
    gy = window_sum_plain(g.float(), gamma, stride, reverse=True)
    rows = gy.reshape(n * l, v, cout)
    gx = gcn_core_plain(rows, A.to(dt).transpose(1, 2), W.to(dt).transpose(1, 2))
    gA, gW = gcn_grads_plain(x.reshape(n * l, v, cin), rows, A, W)
    return gx.reshape(n, l, v, cin).to(dt), gA, gW, gy.sum(dim=(0, 1))


def rt_fused_bwd(x, g, A, W, gamma: int, stride: int, need_gx: bool = True):
    """``(gx, gA, gW, gbe)`` of :func:`rt_fused_core` for the upstream
    gradient ``g (N, L, V, C_out)``: gx in x's type (None unless
    ``need_gx``), the rest fp32.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    n, l, v, cin = x.shape
    p, _, cout = W.shape
    if g.shape != (n, l, v, cout) or A.shape != (p, v, v) or W.shape[1] != cin:
        raise ValueError(
            f"rt_fused_bwd: shapes x {tuple(x.shape)}, g {tuple(g.shape)}, "
            f"A {tuple(A.shape)}, W {tuple(W.shape)} do not agree"
        )
    if x.device.type == "cpu":
        gx, gA, gW, gbe = rt_fused_bwd_plain(x, g, A, W, gamma, stride)
        return (gx if need_gx else None), gA, gW, gbe
    if x.device.type != "cuda":
        raise ValueError(f"rt_fused_bwd: no kernel for device {x.device}")
    if v > 32 or p > 4:
        raise ValueError(f"rt_fused_bwd: the kernel takes V <= 32, P <= 4 (got {v}, {p})")
    g = g.to(x.dtype).contiguous()
    A = A.to(x.dtype).contiguous()
    W = W.to(x.dtype).contiguous()
    code = kernels.validate("rt_fused_bwd", x, g, A, W)
    rows = n * l
    f32 = dict(dtype=torch.float32, device=x.device)
    if rows == 0:
        return ((torch.empty_like(x) if need_gx else None),
                torch.zeros((p, v, v), **f32), torch.zeros((p, cin, cout), **f32),
                torch.zeros((v, cout), **f32))
    gx = torch.empty_like(x) if need_gx else None
    gA = torch.empty((p, v, v), **f32)
    gW = torch.empty((p, cin, cout), **f32)
    gbe = torch.empty((v, cout), **f32)
    # fp32 workspaces, as csrc/rt_fused_bwd.cu lays them out: gy (fp32, or
    # bf16 hi then lo), the split partials, and gx's partition-group slices
    # where there are two groups or two windows of C_out
    splits_w, splits_a = gcn_grads_splits(rows, p, cin, cout)
    ws_g = torch.empty(workspace_floats(rows * v * cout), **f32)
    ws_w = torch.empty(splits_w * p * cin * cout, **f32)
    ws_a = torch.empty(splits_a * -(-cin // 32) * p * v * v, **f32)
    ws_be = torch.empty(splits_w * v * cout, **f32)
    ws_gx = (torch.empty(-(-p // 3) * rows * v * cin, **f32)
             if need_gx and (p > 3 or cout > 256) else None)
    taps = max(1, gamma // stride)
    rc = kernels.load().stgx_rt_fused_bwd(
        x.data_ptr(), g.data_ptr(), A.data_ptr(), W.data_ptr(),
        gx.data_ptr() if need_gx else None, gA.data_ptr(), gW.data_ptr(),
        gbe.data_ptr(), ws_g.data_ptr(), ws_w.data_ptr(), ws_a.data_ptr(),
        ws_be.data_ptr(), ws_gx.data_ptr() if ws_gx is not None else None,
        n, l, v, p, cin, cout, taps, stride, splits_w, splits_a, code,
        window_plan(stride), window_plan(1), kernels.stream_handle(),
    )
    kernels.check(rc, "rt_fused_bwd")
    rt_fused_bwd.launches += 1
    return gx, gA, gW, gbe


rt_fused_bwd.launches = 0


class _RtCore(torch.autograd.Function):
    """``custom_vjp`` of the fused core: forward and backward kernels."""

    @staticmethod
    def forward(ctx, x, A, W, beff, gamma, stride):
        ctx.save_for_backward(x, A, W)
        ctx.args = (gamma, stride, beff.dtype)
        return _fwd(x, A, W, beff, gamma, stride)

    @staticmethod
    def backward(ctx, g):
        x, A, W = ctx.saved_tensors
        gamma, stride, be_dtype = ctx.args
        gx, gA, gW, gbe = rt_fused_bwd(x, g, A, W, gamma, stride,
                                       need_gx=ctx.needs_input_grad[0])
        return gx, gA.to(A.dtype), gW.to(W.dtype), gbe.to(be_dtype), None, None


def rt_fused_core(x, A, W, beff, gamma: int, stride: int):
    """``window_sum(gcn(x, A, W) + beff)`` over ``(N, L, V, C_in)``,
    differentiable.

    ``beff`` is the ``(V, C_out)`` effective bias. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel, and its backward the
    backward kernel.
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
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rt_fused: no kernel for device {x.device}")
    if x.device.type == "cuda" and (v > 32 or p > 4):
        raise ValueError(f"rt_fused: the kernel takes V <= 32, P <= 4 (got {v}, {p})")
    return _RtCore.apply(x, A.to(x.dtype), W.to(x.dtype), beff, gamma, stride)


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
