"""Graph-conv core ``y[r,w,d] = Σ_{p,v,c} x[r,v,c]·A[p,v,w]·W[p,c,d]``.

Replaces the TPU kernel ``stgx/ops/pallas_gcn.py:_kernel`` (launched by
``_core_fwd_impl``) with the hand-written CUDA kernel ``csrc/gcn_core.cu``.

Bound on the H100: operations. A row costs ``2·V·P·C_in·(V + C_out)`` flops
against ``(C_in + C_out)·V`` values read and written, 65–210 flops a byte
in fp32 at the main path's widths, above the card's 20 (67 TFLOP/s fp32
over 3.35 TB/s). The design answer, in the source's note: the aggregate
``xᵀ·A_p`` is formed in shared memory per channel chunk and multiplied into
a register tile at once, so device memory sees only x, W and y.

Numerics: A and W are taken in x's type, as the TPU kernel took them; the
aggregate stays fp32 into the channel product and everything sums in fp32;
y is written in x's type. The conv bias stays outside (see
:func:`stgx_torch.ops.graph_conv.partitioned_gcn`).
"""

from __future__ import annotations

import torch

from stgx_torch import kernels

__all__ = ["gcn_core", "gcn_core_plain"]


def gcn_core_plain(x, A, W):
    """The plain PyTorch version: the same function in two fp32 einsums."""
    dt = x.dtype
    t = torch.einsum("rvc,pvw->rwpc", x.float(), A.to(dt).float())
    return torch.einsum("rwpc,pcd->rwd", t, W.to(dt).float()).to(dt)


def gcn_core(x, A, W):
    """Fused partitioned graph-conv core.

    Args:
        x: ``(R, V, C_in)`` rows (R = N·L in the batch form, B streams in
            the streaming cell).
        A: ``(P, V, V)``, indexed ``A[p, v, w]`` (edge importance applied).
        W: ``(P, C_in, C_out)``.

    Returns ``(R, V, C_out)`` in x's type. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel.
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
    if x.device.type == "cpu":
        return gcn_core_plain(x, A, W)
    if x.device.type != "cuda":
        raise ValueError(f"gcn_core: no kernel for device {x.device}")
    if v > 32 or p > 4:
        raise ValueError(f"gcn_core: the kernel takes V <= 32, P <= 4 (got {v}, {p})")
    A = A.to(x.dtype).contiguous()
    W = W.to(x.dtype).contiguous()
    code = kernels.validate("gcn_core", x, A, W)
    y = torch.empty((r, v, cout), dtype=x.dtype, device=x.device)
    if r == 0:
        return y
    rc = kernels.load().stgx_gcn_core(
        x.data_ptr(), A.data_ptr(), W.data_ptr(), y.data_ptr(),
        r, v, p, cin, cout, code, kernels.stream_handle(),
    )
    kernels.check(rc, "gcn_core")
    gcn_core.launches += 1
    return y


gcn_core.launches = 0
