"""The int8 products of the quantized streaming cells.

* :func:`int8_gemm`: ``C = float(a_q @ b_q) · (s_a · s_b) (+ bias)``, int8
  operands summed in int32; replaces the int8 ``dot_general`` of
  ``stgx/bench/quant.py:199`` (``:189`` for an input stored in int8).
* :func:`w8_gemm`: ``C = (x @ float(b_q)) · s_b (+ bias)``, fp32 x against
  the int8 weight widened in registers; replaces the w8 ``dot_general`` of
  ``stgx/bench/quant.py:194``.

Neither JAX product is a Pallas kernel (XLA runs them on the MXU); the
port's are the hand-written CUDA kernels of ``csrc/int8_gemm.cu``, since
PyTorch has no int8 product behind ``torch.matmul`` on the card and
``torch._int_mm`` refuses the cells' shapes (M ≤ 16, K = 3, N = 52).

Bound on the H100 (the source's note): at B = 1 the weight's bytes; at
large B bytes for int8 and operations for w8. Design: ``mma.sync`` m16n8k32
on int8 tiles staged with ``cp.async``; fp32 FMAs for w8 with the weight
widened as it is staged; K split over blocks where the output has few tiles
(:func:`gemm_plan`), the partial sums added by a second kernel in a fixed
order.

Layouts: ``b_q`` is the ``(K, N)`` weight in the kernel layout
(:func:`weight_layout`: column-major, each output column's K codes
contiguous), made once by ``quantize_*``; ``a_q`` / ``x`` are ``(M, K)``
with unit column stride and any row stride. ``s_a`` is a one-element fp32
tensor on the operands' device, read by the kernel from device memory, so
no call reads a value to the host.

Numerics: the int8 sum is exact (``|sum| ≤ K · 127² < 2³¹``); the epilogue
rounds ``s_a · s_b[n]`` in fp32, then its product with ``float(acc)``, then
``+ bias``, as the plain version does, so the kernel gives the plain
version's bits. w8 sums in fp32 in another order than the plain version's
``torch.matmul``. A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises. ``int8_gemm.launches`` and
``w8_gemm.launches`` count the kernels' launches (one a call).
"""

from __future__ import annotations

import torch

from stgx_torch import kernels

__all__ = ["int8_gemm", "w8_gemm", "int8_gemm_plain", "w8_gemm_plain", "weight_layout",
           "gemm_plan", "INT8_TILE", "W8_TILE"]

SMS = 132  # the H100's streaming multiprocessors
INT8_TILE = (64, 64, 64)  # (rows, columns, k) a block of int8_gemm_kernel takes
W8_TILE = (64, 64, 32)  # the same for w8_gemm_kernel


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def weight_layout(w_q: torch.Tensor) -> torch.Tensor:
    """The ``(K, N)`` weight ``w_q`` in the kernels' layout: the same values,
    stored column-major (each output column's K codes contiguous), as the
    B fragment of ``mma.sync`` wants them."""
    return w_q.t().contiguous().t()


def gemm_plan(m: int, n: int, k: int, tile) -> tuple[int, int]:
    """``(splits, k tiles a split)`` of a product: K split over blocks where
    the output's tiles would leave most of the card's SMs idle (the
    streaming cell at small B, the classifier at M = B), each split taking
    at least two k tiles; otherwise one split of every k tile."""
    bm, bn, bk = tile
    tiles, ktiles = _cdiv(m, bm) * _cdiv(n, bn), _cdiv(k, bk)
    if tiles >= SMS or ktiles < 4:
        return 1, ktiles
    kper = _cdiv(ktiles, min(ktiles // 2, _cdiv(SMS, tiles)))
    return _cdiv(ktiles, kper), kper


def int8_gemm_plain(a_q, b_q, s_a, s_b, bias=None):
    """The plain PyTorch version: the int32 sum through a float64 product
    (exact: every partial sum is an integer below 2⁵³; the card has no int32
    matmul), then the kernel's epilogue."""
    acc = (a_q.double() @ b_q.double()).to(torch.int32)
    y = acc.float() * (s_a.reshape(()) * s_b)
    return y if bias is None else y + bias


def w8_gemm_plain(x, b_q, s_b, bias=None):
    """The plain PyTorch version: ``x`` against the weight widened to fp32,
    then ``· s_b`` (and ``+ bias``)."""
    y = (x @ b_q.float()) * s_b
    return y if bias is None else y + bias


def _check(name, a, a_dtype, b_q, s_b, bias):
    if a.dim() != 2 or b_q.dim() != 2 or a.shape[1] != b_q.shape[0]:
        raise ValueError(f"{name}: operands {tuple(a.shape)} and {tuple(b_q.shape)} "
                         "are not (M, K) and (K, N)")
    if a.dtype != a_dtype or b_q.dtype != torch.int8:
        raise TypeError(f"{name}: takes {a_dtype} and int8 operands, got {a.dtype} "
                        f"and {b_q.dtype}")
    if a.shape[1] > 1 and a.stride(1) != 1:
        raise ValueError(f"{name}: the left operand needs unit column stride")
    if not b_q.t().is_contiguous():
        raise ValueError(f"{name}: the weight must be in the kernel layout "
                         "(ops.int8_gemm.weight_layout)")
    n = b_q.shape[1]
    for what, t in (("s_b", s_b), ("bias", bias)):
        if t is None:
            continue
        if t.shape != (n,) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous float32 ({n},)")
        if t.device != a.device:
            raise ValueError(f"{name}: {what} on {t.device}, operands on {a.device}")
    if b_q.device != a.device:
        raise ValueError(f"{name}: weight on {b_q.device}, operands on {a.device}")
    if a.device.type == "cuda" and a.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: operands on {a.device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {a.device}")


def _geometry(a, b_q):
    m, k = a.shape
    n = b_q.shape[1]
    lda = a.stride(0) if m > 1 else k
    ldb = b_q.stride(1) if n > 1 else k
    return m, n, k, lda, ldb


def int8_gemm(a_q, b_q, s_a, s_b, bias=None):
    """``float(a_q @ b_q) · (s_a · s_b) (+ bias)`` → ``(M, N)`` float32.

    Args:
        a_q: ``(M, K)`` int8, unit column stride (a row-strided view is
            taken as it is).
        b_q: ``(K, N)`` int8 in :func:`weight_layout`.
        s_a: one-element float32 tensor, the scale of ``a_q``.
        s_b: ``(N,)`` float32, the weight's per-column scales.
        bias: optional ``(N,)`` float32, added after the scale.
    """
    _check("int8_gemm", a_q, torch.int8, b_q, s_b, bias)
    if (not torch.is_tensor(s_a) or s_a.numel() != 1 or s_a.dtype != torch.float32
            or s_a.device != a_q.device):
        raise ValueError("int8_gemm: s_a must be a one-element float32 tensor on the "
                         "operands' device")
    if a_q.device.type == "cpu":
        return int8_gemm_plain(a_q, b_q, s_a, s_b, bias)
    m, n, k, lda, ldb = _geometry(a_q, b_q)
    c = torch.empty((m, n), dtype=torch.float32, device=a_q.device)
    if m == 0 or n == 0:
        return c
    splits, kper = gemm_plan(m, n, k, INT8_TILE)
    ws = (torch.empty((splits, m, n), dtype=torch.int32, device=a_q.device)
          if splits > 1 else None)
    rc = kernels.load().stgx_int8_gemm(
        a_q.data_ptr(), lda, b_q.data_ptr(), ldb, s_a.data_ptr(), s_b.data_ptr(),
        None if bias is None else bias.data_ptr(), c.data_ptr(),
        None if ws is None else ws.data_ptr(), m, n, k, splits, kper, kernels.stream_handle())
    kernels.check(rc, "int8_gemm")
    int8_gemm.launches += 1
    return c


def w8_gemm(x, b_q, s_b, bias=None):
    """``(x @ float(b_q)) · s_b (+ bias)`` → ``(M, N)`` float32: ``x`` ``(M,
    K)`` float32 with unit column stride, ``b_q`` ``(K, N)`` int8 in
    :func:`weight_layout`, ``s_b`` and ``bias`` as :func:`int8_gemm`'s."""
    _check("w8_gemm", x, torch.float32, b_q, s_b, bias)
    if x.device.type == "cpu":
        return w8_gemm_plain(x, b_q, s_b, bias)
    m, n, k, ldx, ldb = _geometry(x, b_q)
    c = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return c
    splits, kper = gemm_plan(m, n, k, W8_TILE)
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    rc = kernels.load().stgx_w8_gemm(
        x.data_ptr(), ldx, b_q.data_ptr(), ldb, s_b.data_ptr(),
        None if bias is None else bias.data_ptr(), c.data_ptr(),
        None if ws is None else ws.data_ptr(), m, n, k, splits, kper, kernels.stream_handle())
    kernels.check(rc, "w8_gemm")
    w8_gemm.launches += 1
    return c


int8_gemm.launches = 0
w8_gemm.launches = 0
