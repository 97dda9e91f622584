"""The int8 products of the quantized streaming cells.

* :func:`int8_gemm`: ``C = float(q(a) @ b_q) · (s_a · s_b) (+ bias)``, int8
  operands summed in int32; replaces the int8 ``dot_general`` of
  ``stgx/bench/quant.py:199`` (``:189`` for an input stored in int8).
* :func:`w8_gemm`: ``C = (x @ float(b_q)) · s_b (+ bias)``, the int8 weight
  widened inside the product; replaces the w8 ``dot_general`` of
  ``stgx/bench/quant.py:194``.

Neither JAX product is a Pallas kernel (XLA runs them on the MXU); the
port's are hand-written CUDA kernels, since PyTorch has no int8 product
behind ``torch.matmul`` on the card and ``torch._int_mm`` refuses the
cells' shapes (M ≤ 16, K = 3, N = 52).

**The left operand comes in three forms**, read by the kernel in the form
the cell holds it:

* (a) int8 codes (``int8_gemm`` only): int8 FIFO state, an input already
  quantized;
* (b) fp32 or bf16: ``int8_gemm`` quantizes it on the way into its tile
  under ``s_a`` (:func:`quantize_codes`: ``clip(round(x / s_a), ±127)``,
  half to even), so the cell runs no quantize pass; ``w8_gemm`` takes it as
  it is (bf16 widened exactly);
* (c) ``taps=(gamma, d)``: ``a`` is a FIFO ``(depth, *rows, C)`` and the
  operand its taps, column ``k = tap·C + c`` of a row read from slot
  ``depth − 1 − tap·d`` (CoST-GCN's temporal conv, without the stack the
  plain version builds), in form (a) or (b) by the FIFO's type.

**Two routes**, chosen by shape (:func:`gemm_plan`, :func:`tma_ok`), each a
kernel: ``"tma"`` (``csrc/int8_gemm_tma.cuh``, one entry a form in
``csrc/{int8,w8}_gemm_tma_*.cu``: ``wgmma`` tiles fed by TMA, K
split over the blocks in the same launch where the output has few tiles)
for every operand whose rows TMA can address (16-byte aligned base and row
stride, N a multiple of 4), and ``"staged"`` (``csrc/int8_gemm.cu``:
``mma.sync`` for int8, fp32 FMAs for w8, operands staged through registers)
for the rest, forms (a) and (b) in fp32 (the cells' ``fcn_in`` at K = 3,
ragged shapes). Form (c) and a bf16 operand need the tma route and are
refused off it (the cells hand bf16 only to CoST-GCN's temporal convs, as
taps).

Layouts: ``b_q`` is the ``(K, N)`` weight in the kernel layout
(:func:`weight_layout`: column-major, each output column's K codes
contiguous, K-major as both kernels' B operand wants it), made once by
``quantize_*``; ``a`` is ``(M, K)`` with unit column stride and any row
stride. ``s_a`` is a one-element fp32 tensor on the operands' device, read
by the kernel from device memory, so no call reads a value to the host.

Numerics: the int8 sum is exact (``|sum| ≤ K · 127² < 2³¹``); the epilogue
rounds ``s_a · s_b[n]`` in fp32, then its product with ``float(acc)``, then
``+ bias``, as the plain version does, so every route and form gives the
plain version's bits. w8 sums in fp32 in another order than the plain
version's ``torch.matmul`` (the tma route on TF32 tensor cores with x split
into two TF32 halves). A CPU tensor takes the plain version; a CUDA tensor
launches a kernel or raises. ``int8_gemm.launches`` and ``w8_gemm.launches``
count the launches (one a call), ``.route_launches`` the same by route.
"""

from __future__ import annotations

from collections import namedtuple

import torch

from stgx_torch import kernels

__all__ = ["int8_gemm", "w8_gemm", "int8_gemm_plain", "w8_gemm_plain", "weight_layout",
           "quantize_codes", "tap_operand", "gemm_plan", "tma_ok", "route", "Plan", "KSTAGE",
           "STAGED_TILE"]

SMS = 132  # the H100's streaming multiprocessors
MAX_SPLITS = 16  # K splits of a tile: the last block reads every partial back
SPLIT_STAGES = 8  # k stages a split takes at least
SPLIT_STAGES_QUANTIZED = 4  # the same where the operand is quantized inside: dearer stages
KSTAGE = {"int8": 64, "w8": 32}  # k a stage of the tma route
STAGED_TILE = {"int8": (64, 64, 64), "w8": (64, 64, 32)}  # (rows, columns, k) of a block
_A_TYPES = {torch.int8: 0, torch.float32: 1}  # a's type on the staged int8 route
_TMA_FORMS = {torch.int8: "i8", torch.float32: "f32", torch.bfloat16: "bf16"}  # tma entries

Plan = namedtuple("Plan", "route bn nc splits kper")
Plan.__doc__ = """A product's launch: ``route`` ("tma" or "staged"), the
output tile's width ``bn`` and its rows ``64 · nc`` (tma: ``nc`` consumer
warpgroups), and K split into ``splits`` ranges of ``kper`` k stages."""


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def weight_layout(w_q: torch.Tensor) -> torch.Tensor:
    """The ``(K, N)`` weight ``w_q`` in the kernels' layout: the same values,
    stored column-major (each output column's K codes contiguous)."""
    return w_q.t().contiguous().t()


def quantize_codes(x, scale) -> torch.Tensor:
    """``clip(round(x / scale), -127, 127)`` as int8 (round half to even;
    ``x`` taken in fp32, ``scale`` a tensor: a division, never a product
    with the reciprocal)."""
    return torch.round(x.float() / scale).clamp_(-127, 127).to(torch.int8)


def gemm_plan(m: int, n: int, k: int, op: str = "int8", tma: bool = True,
              codes: bool = True) -> Plan:
    """The launch of an ``(m, k) @ (k, n)`` product of ``op`` ("int8" or
    "w8") on the tma route (``tma``, see :func:`tma_ok`) or the staged one;
    ``codes``: an int8 product's left operand is int8 codes (else fp32 or
    bf16, quantized inside the product).

    tma: the output tile is the whole width up to 256 columns (64, 128 or
    256, N past 256 in several tiles), narrowed to 128 or 64 while the tiles
    would leave SMs idle (the streaming cell at B ≤ 64) unless the operand
    is quantized inside the product, which a narrower tile would quantize
    again for each of its column tiles, 64 rows a consumer
    warpgroup (two where the card still gets a tile an SM); K is split over
    blocks where the output's tiles would leave most of the 132 SMs idle and
    K is deep (CoST at Γ = 69's temporal convs at small B), each split taking
    at least ``SPLIT_STAGES`` k stages (``SPLIT_STAGES_QUANTIZED`` for an
    operand quantized inside), at most ``MAX_SPLITS`` splits: the block that
    finishes a tile reads every split's partial back, which costs more than
    a short walk over K. staged: 64 x 64 tiles, K whole."""
    if not tma:
        return Plan("staged", STAGED_TILE[op][1], 1, 1, _cdiv(k, STAGED_TILE[op][2]))
    bn = 64 if n <= 64 else 128 if n <= 128 else 256
    while (codes or op == "w8") and bn > 64 and _cdiv(m, 64) * _cdiv(n, bn) < SMS:
        bn //= 2
    n_tiles = _cdiv(n, bn)
    nc = 2 if _cdiv(m, 128) * n_tiles >= SMS else 1
    tiles, ktiles = _cdiv(m, 64 * nc) * n_tiles, _cdiv(k, KSTAGE[op])
    floor = SPLIT_STAGES if codes or op == "w8" else SPLIT_STAGES_QUANTIZED
    splits = min(_cdiv(SMS, tiles), ktiles // floor, MAX_SPLITS)
    if tiles >= SMS or splits < 2:
        return Plan("tma", bn, nc, 1, ktiles)
    kper = _cdiv(ktiles, splits)
    return Plan("tma", bn, nc, _cdiv(ktiles, kper), kper)


def tma_ok(a, b_q, n: int) -> bool:
    """Whether TMA can address both operands and the output: 16-byte
    aligned bases and row strides (of ``a`` and of the weight's columns), K
    rows of at least 16 bytes, N a multiple of 4 (16-byte output rows)."""
    es = a.element_size()
    k = a.shape[-1]
    lda = a.stride(-2) if a.dim() > 1 and a.shape[-2] > 1 else k
    ldb = b_q.stride(1) if b_q.shape[1] > 1 else b_q.shape[0]
    return (a.data_ptr() % 16 == 0 and (lda * es) % 16 == 0 and k * es >= 16
            and b_q.data_ptr() % 16 == 0 and ldb % 16 == 0 and n % 4 == 0)


def tap_operand(fifo, gamma: int, dilation: int) -> torch.Tensor:
    """The stacked taps of form (c): ``(rows, gamma·C)``, row ``r`` the
    slots ``depth − 1 − tap·d`` of the FIFO at ``r``, newest first (what
    CoST-GCN's cell built with ``torch.stack``; the plain version)."""
    depth, c = fifo.shape[0], fifo.shape[-1]
    u = torch.stack([fifo[depth - 1 - t * dilation] for t in range(gamma)], dim=-2)
    return u.reshape(-1, gamma * c)


def _epilogue(acc, s_a, s_b, bias):
    y = acc.float() * (s_a.reshape(()) * s_b)
    return y if bias is None else y + bias


def int8_gemm_plain(a, b_q, s_a, s_b, bias=None, taps=None):
    """The plain PyTorch version: the taps stacked (form (c)), an fp32 or
    bf16 operand quantized (form (b)), then the int32 sum through a float64
    product (exact: every partial sum is an integer below 2⁵³; the card has
    no int32 matmul), then the kernel's epilogue."""
    if taps is not None:
        a = tap_operand(a, *taps)
    if a.dtype != torch.int8:
        a = quantize_codes(a, s_a)
    acc = (a.double() @ b_q.double()).to(torch.int32)
    return _epilogue(acc, s_a, s_b, bias)


def w8_gemm_plain(x, b_q, s_b, bias=None, taps=None):
    """The plain PyTorch version: the taps stacked (form (c)), ``x`` in
    fp32 against the weight widened to fp32, then ``· s_b`` (and
    ``+ bias``)."""
    if taps is not None:
        x = tap_operand(x, *taps)
    y = (x.float() @ b_q.float()) * s_b
    return y if bias is None else y + bias


def _check(name, a, a_types, b_q, s_b, bias, taps):
    if b_q.dim() != 2:
        raise ValueError(f"{name}: the weight {tuple(b_q.shape)} is not (K, N)")
    if taps is None:
        if a.dim() != 2 or a.shape[1] != b_q.shape[0]:
            raise ValueError(f"{name}: operands {tuple(a.shape)} and {tuple(b_q.shape)} "
                             "are not (M, K) and (K, N)")
    else:
        gamma, d = taps
        depth = a.shape[0] if a.dim() >= 3 else 0
        if (a.dim() < 3 or gamma < 1 or d < 1 or (gamma - 1) * d + 1 > depth
                or gamma * a.shape[-1] != b_q.shape[0]):
            raise ValueError(f"{name}: taps (gamma={gamma}, d={d}) of a FIFO "
                             f"{tuple(a.shape)} against a weight of {b_q.shape[0]} rows: "
                             "need (depth, rows..., C) with depth >= (gamma - 1) d + 1 "
                             "and K = gamma C")
    if a.dtype not in a_types or b_q.dtype != torch.int8:
        raise TypeError(f"{name}: takes a {' / '.join(map(str, a_types))} left operand and "
                        f"an int8 weight, got {a.dtype} and {b_q.dtype}")
    if a.shape[-1] > 1 and a.stride(-1) != 1:
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


def route(name, op, a, b_q, taps=None) -> str:
    """The route of a product on any device ("tma" where TMA can read the
    operands, else "staged"); raises for what no route takes: a tap operand
    off the tma route (a FIFO that is not contiguous, C not a multiple of
    the k stage, rows or slots off 16 bytes, N off a multiple of 4) and a
    bf16 operand off it."""
    n = b_q.shape[1]
    if taps is not None:
        c = a.shape[-1]
        if not (a.is_contiguous() and c % KSTAGE[op] == 0 and tma_ok(a, b_q, n)):
            raise ValueError(
                f"{name}: no kernel reads the taps of a FIFO {tuple(a.shape)} (strides "
                f"{a.stride()}, {a.dtype}) into a width of {n}: the tma route needs a "
                f"contiguous FIFO, C a multiple of {KSTAGE[op]}, 16-byte aligned rows and "
                "slots and N a multiple of 4")
        return "tma"
    if tma_ok(a, b_q, n):
        return "tma"
    if a.dtype == torch.bfloat16:
        raise ValueError(
            f"{name}: no kernel reads a bf16 operand {tuple(a.shape)} (strides {a.stride()}) "
            f"into a width of {n}: the tma route needs 16-byte aligned rows of at least 16 "
            "bytes and N a multiple of 4")
    return "staged"


_COUNTERS = {}  # device -> int32 counters of the split tiles, zero between calls


def _counters(device) -> torch.Tensor:
    t = _COUNTERS.get(device)
    if t is None:
        t = _COUNTERS[device] = torch.zeros(4 * SMS, dtype=torch.int32, device=device)
    return t


def _launch(name, op, a, b_q, s_a, s_b, bias, taps, path):
    """Launch the product of ``op`` on route ``path``; returns C."""
    n, k = b_q.shape[1], b_q.shape[0]
    if taps is not None:  # (depth, rows, C) read as slots of rows of C
        ctap = a.shape[-1]
        m = a[0].numel() // ctap
        lda, slot, depth, top, dil = ctap, m * ctap, a.shape[0], a.shape[0] - 1, taps[1]
    else:
        m = a.shape[0]
        lda = a.stride(0) if m > 1 else k
        slot, depth, top, ctap, dil = m * lda, 1, 0, k, 0
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    plan = gemm_plan(m, n, k, op, path == "tma", a.dtype == torch.int8)
    if m == 0 or n == 0:
        return c
    ldb = b_q.stride(1) if n > 1 else k
    lib = kernels.load()
    if plan.route == "staged":
        if op == "int8":
            rc = lib.stgx_int8_gemm(_A_TYPES[a.dtype], a.data_ptr(), lda, b_q.data_ptr(), ldb,
                                    s_a.data_ptr(), s_b.data_ptr(),
                                    None if bias is None else bias.data_ptr(), c.data_ptr(),
                                    m, n, k, kernels.stream_handle())
        else:
            rc = lib.stgx_w8_gemm(a.data_ptr(), lda, b_q.data_ptr(), ldb, s_b.data_ptr(),
                                  None if bias is None else bias.data_ptr(), c.data_ptr(),
                                  m, n, k, kernels.stream_handle())
    else:
        ws = counters = None
        if plan.splits > 1:
            ws = torch.empty((plan.splits, m, n), device=a.device,
                             dtype=torch.int32 if op == "int8" else torch.float32)
            counters = _counters(a.device)
            if _cdiv(m, 64 * plan.nc) * _cdiv(n, plan.bn) > counters.numel():
                raise ValueError(f"{name}: {m} x {n} has more split tiles than counters")
        entry = getattr(lib, f"stgx_{op}_gemm_tma_{_TMA_FORMS[a.dtype]}")
        rc = entry(a.data_ptr(), lda, slot, depth, top, ctap, dil, b_q.data_ptr(), ldb,
                   None if s_a is None else s_a.data_ptr(), s_b.data_ptr(),
                   None if bias is None else bias.data_ptr(), c.data_ptr(),
                   None if ws is None else ws.data_ptr(),
                   None if counters is None else counters.data_ptr(), m, n, k, plan.bn,
                   plan.nc, plan.splits, plan.kper, kernels.stream_handle())
    kernels.check(rc, name)
    return c


def int8_gemm(a, b_q, s_a, s_b, bias=None, taps=None):
    """``float(q(a) @ b_q) · (s_a · s_b) (+ bias)`` → ``(M, N)`` float32.

    Args:
        a: ``(M, K)`` int8 codes (form (a)) or fp32 / bf16 quantized under
            ``s_a`` inside the product (form (b)), unit column stride (a
            row-strided view is taken as it is); with ``taps`` a FIFO
            ``(depth, *rows, C)`` (form (c)), M the product of ``rows``.
        b_q: ``(K, N)`` int8 in :func:`weight_layout`.
        s_a: one-element float32 tensor, the scale of the codes.
        s_b: ``(N,)`` float32, the weight's per-column scales.
        bias: optional ``(N,)`` float32, added after the scale.
        taps: ``(gamma, dilation)`` for form (c), K = gamma · C.
    """
    _check("int8_gemm", a, tuple(_TMA_FORMS), b_q, s_b, bias, taps)
    if (not torch.is_tensor(s_a) or s_a.numel() != 1 or s_a.dtype != torch.float32
            or s_a.device != a.device):
        raise ValueError("int8_gemm: s_a must be a one-element float32 tensor on the "
                         "operands' device")
    if a.device.type == "cpu":
        return int8_gemm_plain(a, b_q, s_a, s_b, bias, taps)
    path = route("int8_gemm", "int8", a, b_q, taps)
    c = _launch("int8_gemm", "int8", a, b_q, s_a, s_b, bias, taps, path)
    int8_gemm.launches += 1
    int8_gemm.route_launches[path] += 1
    return c


def w8_gemm(x, b_q, s_b, bias=None, taps=None):
    """``(x @ float(b_q)) · s_b (+ bias)`` → ``(M, N)`` float32: ``x`` ``(M,
    K)`` float32 or bfloat16 with unit column stride (or with ``taps`` a
    FIFO, as :func:`int8_gemm`'s), ``b_q`` ``(K, N)`` int8 in
    :func:`weight_layout`, ``s_b`` and ``bias`` as :func:`int8_gemm`'s."""
    _check("w8_gemm", x, (torch.float32, torch.bfloat16), b_q, s_b, bias, taps)
    if x.device.type == "cpu":
        return w8_gemm_plain(x, b_q, s_b, bias, taps)
    path = route("w8_gemm", "w8", x, b_q, taps)
    c = _launch("w8_gemm", "w8", x, b_q, None, s_b, bias, taps, path)
    w8_gemm.launches += 1
    w8_gemm.route_launches[path] += 1
    return c


int8_gemm.launches = 0
w8_gemm.launches = 0
int8_gemm.route_launches = {"tma": 0, "staged": 0}
w8_gemm.route_launches = {"tma": 0, "staged": 0}
