"""Shift-GCN's shifts — the port of ``stgx/ops/shift.py``.

* :func:`temporal_shift`: the learnable per-channel temporal shift,
  ``y[t, c] = (1 − a)·x[t·s + ⌊s_c⌋, c] + a·x[t·s + ⌊s_c⌋ + 1, c]`` with
  ``s_c`` clipped to ``[−K, K]`` (``K = MAX_SHIFT``), ``a = s_c − ⌊s_c⌋``,
  frames outside the sequence zero and ``ceil(L / s)`` output frames.
  Replaces the TPU kernel ``stgx/ops/shift.py:_shift_kernel`` (launched by
  ``_temporal_shift_pallas_fwd_impl``) with the hand-written CUDA kernel
  ``csrc/temporal_shift.cu``.
* :func:`spatial_shift`: the fixed joint-circular channel rotation, a
  gather over V (no kernel, as in the JAX package).

Bound on the H100: bytes. Each input frame feeds at most two outputs: the
least traffic is one read of x and one write of y. The design answer, in
the source's note: the two-tap interpolation (2 products and an add an
output, not the TPU's 18-tap band), the rows a block needs staged in shared
memory so the loads coalesce although neighbouring channels shift by
different frames, and only the kept frames formed.

Numerics: the shift is taken in x's type, as the JAX op takes it
(``shift_band_weights(shift.astype(x.dtype))``). The kernel forms ``1 − a``
and the two products in fp32, rounded separately as the banded sum rounds
them, and rounds the result once to x's type: in fp32 it gives the plain
version's bits.

Gradient: :func:`temporal_shift` is a ``torch.autograd.Function``, the
port of the JAX ``custom_vjp`` (``_ts_fwd``/``_ts_bwd``), whose backward is
the VJP of the banded form in closed form rather than through the 18-tap
band: ``gx`` is the transposed two-tap scatter, ``g_shift[c] = Σ_{n,t,v}
g·(x[t·s+f+1] − x[t·s+f])``, zero where the clip is active (half at exactly
±K, as JAX's clip gives). The JAX VJP is XLA, not Pallas; here a CUDA tensor
runs it in the hand-written kernel of :func:`temporal_shift_bwd`
(``csrc/temporal_shift.cu``), the forward's layout with ``g_shift`` summed
as per-block partials added in a fixed order; its plain version is
:func:`temporal_shift_vjp_plain`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stgx_torch import kernels

__all__ = [
    "MAX_SHIFT",
    "shift_band_weights",
    "shift_bwd_tile",
    "temporal_shift",
    "temporal_shift_bwd",
    "temporal_shift_plain",
    "temporal_shift_vjp_plain",
    "spatial_shift",
    "spatial_shift_index",
]

MAX_SHIFT = 8  # the band's half-width K; shifts clip to [-K, K]
SLAB_ROWS = 160  # frames a block of csrc/temporal_shift.cu stages (kSlabRows)
SHIFT_SPAN = 256  # partials of g_shift the first reduction pass adds a block (kSpan)


def shift_band_weights(shift, max_shift: int = MAX_SHIFT):
    """``(2K+2, C)`` interpolation weights of the banded form, in shift's
    type: ``w_k = (1 − a)·[k = f] + a·[k = f + 1]`` for ``k ∈ [−K, K+1]``."""
    s = torch.clamp(shift, -max_shift, max_shift)
    f = torch.floor(s)
    a = s - f
    k = torch.arange(-max_shift, max_shift + 2, dtype=shift.dtype,
                     device=shift.device)[:, None]
    return (1.0 - a) * (k == f) + a * (k == f + 1.0)


def temporal_shift_plain(x, shift, stride: int = 1, max_shift: int = MAX_SHIFT):
    """The plain PyTorch version: the banded blend exactly as the JAX
    ``temporal_shift`` forms it, in x's type, differentiable by autograd.

    Args:
        x: ``(N, L, V, C)``.
        shift: ``(C,)`` per-channel shift in frames (any real value).
        stride: temporal downsampling of the output grid.

    Returns ``(N, ceil(L / stride), V, C)``.
    """
    n, l, v, c = x.shape
    out_l = -(-l // stride)
    w = shift_band_weights(shift.to(x.dtype), max_shift)
    xp = F.pad(x, (0, 0, 0, 0, max_shift, max_shift + 1 + stride))
    y = torch.zeros((n, out_l, v, c), dtype=x.dtype, device=x.device)
    for i, k in enumerate(range(-max_shift, max_shift + 2)):
        start = max_shift + k
        y = y + w[i] * xp[:, start: start + out_l * stride: stride]
    return y


def _taps(shift, max_shift: int):
    """``(f, a)`` per channel: the first tap's offset (int64) and the second
    tap's weight, in shift's type."""
    s = torch.clamp(shift, -max_shift, max_shift)
    f = torch.floor(s)
    return f.long(), s - f


def _shift(x, shift, stride: int, max_shift: int):
    """The forward on its device: the plain version for a CPU tensor, the
    kernel for a CUDA tensor (shift already in x's type)."""
    if x.device.type == "cpu":
        return temporal_shift_plain(x, shift, stride, max_shift)
    shift = shift.contiguous()
    code = kernels.validate("temporal_shift", x, shift)
    n, l, v, c = x.shape
    y = torch.empty((n, -(-l // stride), v, c), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    rc = kernels.load().stgx_temporal_shift(
        x.data_ptr(), shift.data_ptr(), y.data_ptr(), n, l, v, c, stride,
        max_shift, code, kernels.stream_handle(),
    )
    kernels.check(rc, "temporal_shift")
    temporal_shift.launches += 1
    return y


def temporal_shift_vjp_plain(x, shift, g, stride: int = 1, max_shift: int = MAX_SHIFT):
    """The plain PyTorch version of the backward: ``(gx, g_shift)`` of the
    shift in closed form, summed in fp32 (fp64 for fp64 input) and returned
    in the types of x and shift."""
    acc = torch.promote_types(x.dtype, torch.float32)
    n, l, v, c = x.shape
    out_l = g.shape[1]
    k = max_shift
    f, a = _taps(shift.to(acc), k)
    xf, gf = x.to(acc), g.to(acc)
    # g on the input grid: output t sits at input frame t·s; frames past it
    # (and between the kept ones) are zero; K + 1 zero frames pad each side
    span = out_l * stride
    gs = torch.zeros((n, span + 2 * k + 2, v, c), dtype=acc, device=x.device)
    gs[:, k + 1: k + 1 + span: stride] = gf
    # gx[i] = (1 − a)·G[i − f] + a·G[i − f − 1]
    t = torch.arange(l, device=x.device)[:, None]
    idx0 = (t - f[None, :] + k + 1)[None, :, None, :].expand(n, l, v, c)
    g0 = torch.gather(gs, 1, idx0)
    g1 = torch.gather(gs, 1, idx0 - 1)
    gx = (1.0 - a) * g0 + a * g1
    # the taps each output read: x[t·s + f] and x[t·s + f + 1]
    xp = F.pad(xf, (0, 0, 0, 0, k, k + 1 + stride))
    to = torch.arange(out_l, device=x.device)[:, None] * stride
    jdx0 = (to + f[None, :] + k)[None, :, None, :].expand(n, out_l, v, c)
    dx = torch.gather(xp, 1, jdx0 + 1) - torch.gather(xp, 1, jdx0)
    s = shift.to(acc)
    inside = torch.where(s.abs() < k, 1.0, torch.where(s.abs() == k, 0.5, 0.0))
    gsh = (gf * dx).sum(dim=(0, 1, 2)) * inside.to(acc)
    return gx.to(x.dtype), gsh.to(shift.dtype)


def shift_bwd_tile(l: int, stride: int, max_shift: int = MAX_SHIFT) -> int:
    """Output frames a block of the backward kernel takes: as many as the
    staged rows of g on the input grid (``tile·s + 2K + 1``) and of x
    (``(tile − 1)·s + 2K + 2``) allow, at most the whole sequence."""
    tile = min((SLAB_ROWS - 2 * max_shift - 1) // stride, -(-l // stride))
    if tile < 1:
        raise ValueError(f"temporal_shift: no kernel for max_shift {max_shift} at stride "
                         f"{stride} ({SLAB_ROWS} staged frames a block)")
    return tile


def temporal_shift_bwd(x, shift, g, stride: int = 1, max_shift: int = MAX_SHIFT):
    """``(gx, g_shift)`` of the shift for the upstream gradient ``g``: the
    plain version for a CPU tensor, the kernel for a CUDA tensor (shift in
    x's type). ``temporal_shift_bwd.launches`` counts the launches."""
    if x.device.type == "cpu":
        return temporal_shift_vjp_plain(x, shift, g, stride, max_shift)
    shift, g = shift.contiguous(), g.contiguous()
    code = kernels.validate("temporal_shift_bwd", x, shift, g)
    n, l, v, c = x.shape
    gx, gsh = torch.empty_like(x), torch.empty_like(shift)
    if x.numel() == 0:
        return gx.zero_(), gsh.zero_()
    tile = shift_bwd_tile(l, stride, max_shift)
    partials = n * v * -(-g.shape[1] // tile)
    ws = torch.empty((partials + -(-partials // SHIFT_SPAN)) * c, dtype=torch.float32,
                     device=x.device)
    rc = kernels.load().stgx_temporal_shift_bwd(
        x.data_ptr(), shift.data_ptr(), g.data_ptr(), gx.data_ptr(), gsh.data_ptr(),
        ws.data_ptr(), n, l, v, c, stride, max_shift, tile, code, kernels.stream_handle(),
    )
    kernels.check(rc, "temporal_shift_bwd")
    temporal_shift_bwd.launches += 1
    return gx, gsh


temporal_shift_bwd.launches = 0


class _TemporalShift(torch.autograd.Function):
    """``custom_vjp`` of the shift: the forward kernel and the backward
    kernel (their plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, x, shift, stride, max_shift):
        ctx.save_for_backward(x, shift)
        ctx.args = (stride, max_shift)
        return _shift(x, shift, stride, max_shift)

    @staticmethod
    def backward(ctx, g):
        x, shift = ctx.saved_tensors
        gx, gs = temporal_shift_bwd(x, shift, g, *ctx.args)
        return gx, gs, None, None


def temporal_shift(x, shift, stride: int = 1, max_shift: int = MAX_SHIFT):
    """Learnable temporal shift of ``(N, L, V, C)`` by ``shift (C,)``,
    differentiable in both; ``(N, ceil(L / stride), V, C)`` out.

    The shift is cast to x's type first (autograd carries its gradient back
    through the cast). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel, and its backward :func:`temporal_shift_bwd`'s
    kernel. ``temporal_shift.launches`` counts the forward's launches.
    """
    if x.dim() != 4 or shift.shape != (x.shape[3],):
        raise ValueError(f"temporal_shift: x (N, L, V, C) and shift (C,), got "
                         f"{tuple(x.shape)} and {tuple(shift.shape)}")
    if stride < 1 or max_shift < 0:
        raise ValueError(f"temporal_shift: stride {stride}, max_shift {max_shift}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"temporal_shift: no kernel for device {x.device}")
    return _TemporalShift.apply(x, shift.to(x.dtype), int(stride), int(max_shift))


temporal_shift.launches = 0


def spatial_shift_index(num_joints: int, channels: int, reverse: bool = False,
                        device=None):
    """``(V, C)`` source joints of the rotation: ``(i + j) mod V`` for joint
    i and channel j, ``(i − j) mod V`` when ``reverse``."""
    joints = torch.arange(num_joints, device=device)[:, None]
    chans = torch.arange(channels, device=device)[None, :]
    return torch.remainder(joints + (-chans if reverse else chans), num_joints)


def spatial_shift(x, reverse: bool = False, index=None):
    """Fixed joint-circular channel rotation ``y[..., i, j] = x[..., (i ± j)
    mod V, j]`` of ``(N, L, V, C)``. ``index`` is its
    :func:`spatial_shift_index` for x's ``(V, C)``, made here if None (the
    model's blocks keep theirs as buffers)."""
    n, l, v, c = x.shape
    if index is None:
        index = spatial_shift_index(v, c, reverse, x.device)
    return torch.gather(x, 2, index[None, None].expand(n, l, v, c))
