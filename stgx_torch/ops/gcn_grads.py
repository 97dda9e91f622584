"""Parameter gradients of the graph-conv core, summed over all rows:

    gA[p,v,w] = Σ_{r,c,d} x[r,v,c]·g[r,w,d]·W[p,c,d]      (P, V, V)
    gW[p,c,d] = Σ_{r,v,w} x[r,v,c]·A[p,v,w]·g[r,w,d]      (P, C_in, C_out)

Replaces the TPU kernel ``stgx/ops/pallas_gcn.py:_grads_kernel`` (launched
by ``_grads_impl``) with the hand-written CUDA kernels of
``csrc/gcn_grads.cu``.

Bound on the H100: operations. A row costs ``4·P·V·C_in·(V + C_out)``
flops, twice the forward's, against ``(C_in + C_out)·V`` values read; the
outputs are small. Almost all of it is two products of size R·V × C_in ×
C_out a partition, ``gW_p = T_pᵀ·g`` (T_p the aggregate ``x·A_p``) and
``gA_p = Σ x·U_p`` with ``U_p = g·W_pᵀ``. The design answer, in the
source's note: every product on the tensor cores; the gW kernel forms T_p
once a step for all its partitions and a 64- or 128-wide C_out tile; the gA
kernel keeps its W_p columns in shared memory while it walks its rows. The
TPU kernel carried both sums in VMEM across a sequential row grid; here
each block sums one split of the rows into an fp32 partial in a workspace
this wrapper allocates (:func:`gcn_grads_splits` sizes them), and a last
pass adds the partials in split order, so the result is the same from run
to run (no atomics).

Routes and numerics: A and W are taken in x's type, as the TPU kernel took
them; every sum is fp32 and both gradients come back in fp32. fp32 runs the
three-pass TF32 split on every product; bf16 runs one pass on the products
of the inputs and splits the fp32 intermediates T_p and U_p into bf16
``hi + lo`` for the second products, so neither route rounds an
intermediate to 16 bits.

The kernels live in ``csrc/gcn_grads.cuh``, which ``rt_fused_bwd`` shares:
it runs them on the window-sum of its upstream gradient, with the same row
splits.
"""

from __future__ import annotations

import torch

from stgx_torch import kernels

__all__ = ["gcn_grads", "gcn_grads_plain", "gcn_grads_splits"]

SMS = 132  # the H100's streaming multiprocessors
# gcn_grads.cuh: the C_in tiles of its gW and gA kernels (kWC, kAC), its
# gW kernel's C_out tile (64 up to 64 columns, else 128), and the partitions
# a block takes (kPB)
GW_TILE_C, GA_TILE_C, PART_GROUP = 64, 32, 3


def gcn_grads_splits(rows: int, p: int, cin: int, cout: int):
    """``(splits_w, splits_a)``: how many row splits the gW and the gA
    kernels of ``csrc/gcn_grads.cu`` take. Each of them fills most of an
    SM's shared memory, so one block runs on each SM; each kernel launches
    at most one block for each of the 132 SMs (one round, every block
    walking an equal share of the rows), never more splits than rows."""
    groups = -(-p // PART_GROUP)
    tile_d = 64 if cout <= 64 else 128
    tiles_w = groups * -(-cin // GW_TILE_C) * -(-cout // tile_d)
    tiles_a = groups * -(-cin // GA_TILE_C)
    return tuple(max(1, min(rows, SMS // tiles, 65535)) for tiles in (tiles_w, tiles_a))


def gcn_grads_plain(x, g, A, W):
    """The plain PyTorch version: two fp32 einsums, A and W rounded to x's
    type first (g is taken as it comes)."""
    dt = x.dtype
    xf, gf = x.float(), g.float()
    Af, Wf = A.to(dt).float(), W.to(dt).float()
    gW = torch.einsum("rvc,pvw,rwd->pcd", xf, Af, gf)
    gA = torch.einsum("rvc,rwd,pcd->pvw", xf, gf, Wf)
    return gA, gW


def gcn_grads(x, g, A, W):
    """``(gA, gW)`` in fp32 for ``x (R, V, C_in)``, ``g (R, V, C_out)``,
    ``A (P, V, V)``, ``W (P, C_in, C_out)``.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    if x.dim() != 3 or g.dim() != 3 or A.dim() != 3 or W.dim() != 3:
        raise ValueError("gcn_grads: x (R,V,C_in), g (R,V,C_out), A (P,V,V), "
                         "W (P,C_in,C_out)")
    r, v, cin = x.shape
    p, _, cout = W.shape
    if A.shape != (p, v, v) or W.shape[1] != cin or g.shape != (r, v, cout):
        raise ValueError(
            f"gcn_grads: shapes x {tuple(x.shape)}, g {tuple(g.shape)}, "
            f"A {tuple(A.shape)}, W {tuple(W.shape)} do not agree"
        )
    if x.device.type == "cpu":
        return gcn_grads_plain(x, g, A, W)
    if x.device.type != "cuda":
        raise ValueError(f"gcn_grads: no kernel for device {x.device}")
    if v > 32 or p > 4:
        raise ValueError(f"gcn_grads: the kernel takes V <= 32, P <= 4 (got {v}, {p})")
    g = g.to(x.dtype).contiguous()
    A = A.to(x.dtype).contiguous()
    W = W.to(x.dtype).contiguous()
    code = kernels.validate("gcn_grads", x, g, A, W)
    if r == 0:
        return (torch.zeros((p, v, v), dtype=torch.float32, device=x.device),
                torch.zeros((p, cin, cout), dtype=torch.float32, device=x.device))
    f32 = dict(dtype=torch.float32, device=x.device)
    gA = torch.empty((p, v, v), **f32)
    gW = torch.empty((p, cin, cout), **f32)
    # fp32 partials, as csrc/gcn_grads.cu lays them out
    splits_w, splits_a = gcn_grads_splits(r, p, cin, cout)
    ws_w = torch.empty(splits_w * p * cin * cout, **f32)
    ws_a = torch.empty(splits_a * -(-cin // GA_TILE_C) * p * v * v, **f32)
    rc = kernels.load().stgx_gcn_grads(
        x.data_ptr(), g.data_ptr(), A.data_ptr(), W.data_ptr(), gA.data_ptr(),
        gW.data_ptr(), ws_w.data_ptr(), ws_a.data_ptr(), r, v, p, cin, cout,
        splits_w, splits_a, code, kernels.stream_handle(),
    )
    kernels.check(rc, "gcn_grads")
    gcn_grads.launches += 1
    return gA, gW


gcn_grads.launches = 0
