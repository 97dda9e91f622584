"""K-partitioned spatial graph convolution — the port of
``stgx/ops/graph_conv.py``.

    y[n,l,w,d] = Σ_p Σ_v Σ_c x[n,l,v,c] · A[p,v,w] · W[p,c,d]  (+ bias term)

``partitioned_gcn`` flattens ``(N, L)`` into rows and runs the core through
:func:`stgx_torch.ops.gcn_core.gcn_core`: the CUDA kernel for a CUDA
tensor, its plain version for a CPU one.
"""

from __future__ import annotations

import torch

from stgx_torch.ops.gcn_core import gcn_core

__all__ = ["gcn_aggregate", "partitioned_gcn"]


def gcn_aggregate(x, A):
    """Neighborhood aggregation per partition: ``(N, L, V, C)`` →
    ``(N, L, V, P, C)`` with ``y[n,l,w,p,c] = Σ_v x[n,l,v,c]·A[p,v,w]``,
    summed in fp32 and cast to x's type (partition axis inside V, as in
    stgx)."""
    y = torch.einsum("nlvc,pvw->nlwpc", x.float(), A.float())
    return y.to(x.dtype)


def partitioned_gcn(x, A, W, b=None):
    """Full partitioned graph convolution.

    Args:
        x: ``(N, L, V, C_in)``.
        A: ``(P, V, V)`` (edge importance already applied).
        W: ``(P, C_in, C_out)``.
        b: optional ``(P, C_out)``. The reference adds the 1×1-conv bias
            *before* the adjacency product, so the additive term is
            ``Σ_p colsum(A)[p, w] · b[p, d]``; it depends on the
            edge-importance-weighted A and stays a small op outside the
            kernel.

    Returns ``(N, L, V, C_out)``.
    """
    n, l, v, c = x.shape
    y = gcn_core(x.reshape(n * l, v, c), A, W).reshape(n, l, v, W.shape[-1])
    if b is not None:
        y = y + torch.einsum("pvw,pd->wd", A, b).to(y.dtype)
    return y
