"""Graph-conv core ``y[r,w,d] = Σ_{p,v,c} x[r,v,c]·A[p,v,w]·W[p,c,d]``.

Replaces the TPU kernel ``stgx/ops/pallas_gcn.py:_kernel`` (launched by
``_core_fwd_impl``) with the hand-written CUDA kernels of
``csrc/gcn_core.cu``.

Bound on the H100: operations. A row costs ``2·V·P·C_in·(V + C_out)`` flops
against ``(C_in + C_out)·V`` values read and written, 65–210 flops a byte
in fp32 at the main path's widths, above the card's 20 for fp32 FMAs; in
bf16 near the tensor cores' ~300. The design answer, in the source's note:
the aggregate ``x·A_p`` first, formed once per block for up to 256 output
columns in shared memory, then the channel mix into registers; copies are
asynchronous and double buffered; device memory sees only x, W and y.

Routes and numerics: A and W are taken in x's type, as the TPU kernel took
them. fp32 runs both products on the CUDA cores in fp32 FMAs (8 × 8
outputs a thread), in the plain tile's order of sums, so it gives the bits
of the fused core's graph conv; three TF32 passes on the tensor cores were
measured and left the first-step gradients of RT-ST-GCN too far from
float64 (``PERF.md``). bf16 runs both products on the tensor cores
(``mma.sync``) and rounds the aggregate to bf16 before the channel mix, as
the TPU kernel's second ``dot_general`` did under default precision. Sums
are fp32; y is written in x's type. The conv bias stays outside (see
:func:`stgx_torch.ops.graph_conv.partitioned_gcn`). :func:`core_tile`
picks the kernel's tile on the host.

Gradient: :func:`gcn_core` is a ``torch.autograd.Function``, the port of
the JAX ``custom_vjp`` (``_core_fwd``/``_core_bwd``). Its backward runs the
same kernel on ``(g, Aᵀ, Wᵀ)`` for ``gx`` (skipped where x needs no
gradient) and :func:`stgx_torch.ops.gcn_grads.gcn_grads` for ``(gA, gW)``;
on the CPU both take their plain versions, so the CPU tests run the
backward decomposition the card runs. A and W are cast to x's type before
the Function, so autograd carries their gradients back through the cast.
"""

from __future__ import annotations

import torch

from stgx_torch import kernels
from stgx_torch.ops.gcn_grads import gcn_grads

__all__ = ["gcn_core", "gcn_core_plain", "core_tile", "CORE_TILES"]

SMS = 132  # the H100's streaming multiprocessors
# The tiles of csrc/gcn_core.cu by index: (input rows NR, output columns BN)
# a block of the bf16 route takes, 32 rows m for each input row (joints
# padded to 32). The fp32 route's tiles take the same BN and 32·NR rows m,
# dense (the narrow one 64).
CORE_TILES = ((2, 256), (4, 128), (4, 64), (1, 64))


def core_tile(rows: int, cout: int) -> int:
    """The tile the kernel takes for ``rows`` input rows and ``cout`` output
    columns: the wide tile whose BN covers C_out (up to 256), so that one
    block forms the aggregate once for all its columns; or the narrow one,
    64 columns wide, where the wide tiles would give the card fewer blocks
    than it has SMs (the streaming cell, R = B streams)."""
    wide = 0 if cout > 128 else 1 if cout > 64 else 2
    nr, bn = CORE_TILES[wide]
    return wide if -(-rows // nr) * -(-cout // bn) >= SMS else len(CORE_TILES) - 1


def gcn_core_plain(x, A, W):
    """The plain PyTorch version: the same function in two fp32 einsums
    (fp64 ones for fp64 input)."""
    dt = x.dtype
    acc = torch.promote_types(dt, torch.float32)
    t = torch.einsum("rvc,pvw->rwpc", x.to(acc), A.to(dt).to(acc))
    return torch.einsum("rwpc,pcd->rwd", t, W.to(dt).to(acc)).to(dt)


def _core(x, A, W):
    """The forward on its device: the plain version for a CPU tensor, the
    kernel for a CUDA tensor (A and W already in x's type)."""
    if x.device.type == "cpu":
        return gcn_core_plain(x, A, W)
    r, v, _ = x.shape
    p, _, cout = W.shape
    if v > 32 or p > 4:
        raise ValueError(f"gcn_core: the kernel takes V <= 32, P <= 4 (got {v}, {p})")
    A = A.contiguous()
    W = W.contiguous()
    code = kernels.validate("gcn_core", x, A, W)
    y = torch.empty((r, v, cout), dtype=x.dtype, device=x.device)
    if r == 0:
        return y
    mode = code | core_tile(r, cout) << 8  # the C entry point's type and tile
    rc = kernels.load().stgx_gcn_core(
        x.data_ptr(), A.data_ptr(), W.data_ptr(), y.data_ptr(),
        r, v, p, x.shape[2], cout, mode, kernels.stream_handle(),
    )
    kernels.check(rc, "gcn_core")
    gcn_core.launches += 1
    return y


class _GcnCore(torch.autograd.Function):
    """``custom_vjp`` of the core: forward and both backward halves on the
    kernels (or, on the CPU, their plain versions)."""

    @staticmethod
    def forward(ctx, x, A, W):
        ctx.save_for_backward(x, A, W)
        return _core(x, A, W)

    @staticmethod
    def backward(ctx, g):
        x, A, W = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        gx = gA = gW = None
        if ctx.needs_input_grad[0]:
            # gx[r,v,c] = Σ_{p,w,d} g[r,w,d]·A[p,v,w]·W[p,c,d]: the core on
            # the transposed operands
            gx = _core(g, A.transpose(1, 2).contiguous(),
                       W.transpose(1, 2).contiguous())
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            ga, gw = gcn_grads(x, g, A, W)
            gA, gW = ga.to(A.dtype), gw.to(W.dtype)
        return gx, gA, gW


def gcn_core(x, A, W):
    """Fused partitioned graph-conv core, differentiable.

    Args:
        x: ``(R, V, C_in)`` rows (R = N·L in the batch form, B streams in
            the streaming cell).
        A: ``(P, V, V)``, indexed ``A[p, v, w]`` (edge importance applied).
        W: ``(P, C_in, C_out)``.

    Returns ``(R, V, C_out)`` in x's type. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel. ``gcn_core.launches``
    counts the kernel's launches, the backward's ``gx`` ones included.
    """
    if x.dim() != 3 or A.dim() != 3 or W.dim() != 3:
        raise ValueError("gcn_core: x (R,V,C_in), A (P,V,V), W (P,C_in,C_out)")
    r, v, cin = x.shape
    p, _, cout = W.shape
    if A.shape != (p, v, v) or W.shape[1] != cin:
        raise ValueError(
            f"gcn_core: shapes x {tuple(x.shape)}, A {tuple(A.shape)}, "
            f"W {tuple(W.shape)} do not agree"
        )
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gcn_core: no kernel for device {x.device}")
    return _GcnCore.apply(x, A.to(x.dtype), W.to(x.dtype))


gcn_core.launches = 0
