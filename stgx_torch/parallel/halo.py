"""Sequence parallelism: the halo exchange over the ``seq`` ranks and the
frame-axis ops built on it — the port of ``stgx/parallel/halo.py``, and
of what GSPMD inserts for the JAX package's window and multi-stage models
when their frames are split over ``seq``.

A sequence's frames are split over the ranks of a group in contiguous
blocks, which may differ in length: a :class:`~stgx_torch.parallel.mesh.Split`
carries the blocks' global bounds (after a stride-``s`` layer the block
``[a, b)`` holds the outputs ``[⌈a/s⌉, ⌈b/s⌉)``), and without bounds the
blocks are equal. An op that looks back (or ahead) over the frame axis
needs the frames next to its block: each rank gets the ``left`` frames
before its block and the ``right`` after it from every rank that holds
some of them, however many blocks the halo spans
(``torch.distributed.batch_isend_irecv``, one message a pair of ranks),
runs the op on its halo-extended block and drops the halo. Frames beyond
the sequence's ends are zeros, the zero padding of the whole sequence.

* :func:`halo_exchange` is differentiable: its backward sends each halo
  frame's gradient back to the rank that owns the frame, which adds it in.
* :func:`sp_causal_accumulate`: RT-ST-GCN's causal window sum
  (``window_sum`` on the card) on a block extended by ``(Γ//s − 1)·s``
  past frames.
* :func:`sp_temporal_conv`: the padding's frames as halos, then a
  ``valid`` conv (:func:`stgx_torch.ops.temporal.temporal_conv`) on the
  extended block from the block's first output on the stride's grid (its
  phase taken from the block's global start).
* :func:`sp_temporal_shift`: Shift-GCN's temporal shift
  (``temporal_shift`` and ``temporal_shift_bwd`` on the card) launched on
  the block extended by K frames back and K + 1 ahead (``K =
  MAX_SHIFT``), the outputs of the block kept.
* :func:`sp_avg_pool`: the mean of each ``k`` frames, a pair that straddles
  two blocks completed from the next one.
* :func:`decimate`, :func:`frame_mean`: ``x[:, ::s]`` at the global
  phase, and a mean over the frames of every block (differentiable: the
  backward sums the gradients over the group).

:func:`frame_split` gives the frame split of the step being run (the
layout of :func:`~stgx_torch.parallel.mesh.use_shards`); with one part, or
none, every op here is its one-process form.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from stgx_torch.ops.shift import MAX_SHIFT, temporal_shift
from stgx_torch.ops.temporal import causal_accumulate, temporal_conv
from stgx_torch.parallel.mesh import Split, current_shards, sum_parts

__all__ = [
    "frame_split",
    "halo_exchange",
    "sp_causal_accumulate",
    "sp_temporal_conv",
    "sp_temporal_shift",
    "sp_avg_pool",
    "decimate",
    "frame_mean",
]


def frame_split(shards=None) -> Split | None:
    """The frame split of ``shards`` (the current layout if None), if the
    frames are in several parts."""
    shards = current_shards() if shards is None else shards
    return shards.l if shards is not None and shards.l.size > 1 else None


def _exchange(sends, recvs, group):
    """Post every ``(tensor, group rank)`` send and receive at once; wait."""
    ops = [dist.P2POp(dist.isend, t, dist.get_global_rank(group, r), group)
           for t, r in sends]
    ops += [dist.P2POp(dist.irecv, t, dist.get_global_rank(group, r), group)
            for t, r in recvs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def _overlaps(edges, left, right, needer, owner):
    """The global frames ``[s, e)`` that rank ``needer`` reads beyond its
    block (``left`` before it, ``right`` after it, within the sequence) and
    rank ``owner`` holds; None if there are none."""
    a, b, length = edges[needer], edges[needer + 1], edges[-1]
    if owner < needer:
        s, e = max(a - left, 0), a
    elif owner > needer:
        s, e = b, min(b + right, length)
    else:
        return None
    s, e = max(s, edges[owner]), min(e, edges[owner + 1])
    return (s, e) if s < e else None


class _HaloExchange(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, left, right, group, edges):
        size, idx = dist.get_world_size(group), dist.get_rank(group)
        a = edges[idx]
        lo = a - left  # the extended block's first global frame
        ext = x.new_zeros((x.shape[0], left + x.shape[1] + right, *x.shape[2:]))
        ext[:, left: left + x.shape[1]] = x
        sends, recvs, places = [], [], []
        for j in range(size):
            mine = _overlaps(edges, left, right, j, idx)  # what j reads of my block
            if mine is not None:
                sends.append((x[:, mine[0] - a: mine[1] - a].contiguous(), j))
            theirs = _overlaps(edges, left, right, idx, j)  # what I read of j's
            if theirs is not None:
                buf = x.new_empty((x.shape[0], theirs[1] - theirs[0], *x.shape[2:]))
                recvs.append((buf, j))
                places.append(theirs[0] - lo)
        _exchange(sends, recvs, group)
        for off, (buf, _) in zip(places, recvs):
            ext[:, off: off + buf.shape[1]] = buf
        ctx.geometry = (left, right, group, edges, size, idx)
        return ext

    @staticmethod
    def backward(ctx, g):
        left, right, group, edges, size, idx = ctx.geometry
        a, b = edges[idx], edges[idx + 1]
        lo = a - left
        g = g.contiguous()
        gx = g[:, left: left + b - a].clone()
        sends, recvs, places = [], [], []
        for j in range(size):
            theirs = _overlaps(edges, left, right, idx, j)  # their frames' gradients go back
            if theirs is not None:
                sends.append((g[:, theirs[0] - lo: theirs[1] - lo].contiguous(), j))
            mine = _overlaps(edges, left, right, j, idx)  # my frames' gradients come home
            if mine is not None:
                recvs.append((g.new_empty((g.shape[0], mine[1] - mine[0], *g.shape[2:])), j))
                places.append(mine[0] - a)
        _exchange(sends, recvs, group)
        for off, (buf, _) in zip(places, recvs):
            gx[:, off: off + buf.shape[1]] += buf
        return gx, None, None, None, None


def halo_exchange(x, left: int, right: int, group, bounds=None):
    """Extend each rank's frame block with the frames next to it.

    Args:
        x: this rank's block ``(N, L_loc, ...)``.
        left: frames of past halo, the ``left`` frames before the block.
        right: frames of future halo, the ``right`` frames after it.
        group: the process group the frames are split over.
        bounds: the global edges of every rank's block (``size + 1``
            numbers, :attr:`Split.bounds`); None for equal blocks of
            ``L_loc``.

    Returns ``(N, left + L_loc + right, ...)``. A halo may span several
    blocks: it gathers from every rank it reaches. Frames before the
    sequence's start and past its end are zeros.
    """
    if left < 0 or right < 0:
        raise ValueError(f"halo_exchange: halos of {left} and {right} frames")
    size = dist.get_world_size(group)
    edges = (tuple(int(e) for e in bounds) if bounds is not None
             else tuple(i * x.shape[1] for i in range(size + 1)))
    if len(edges) != size + 1 or edges[dist.get_rank(group) + 1] - edges[
            dist.get_rank(group)] != x.shape[1]:
        raise ValueError(f"halo_exchange: a block of {x.shape[1]} frames is not the "
                         f"bounds' {edges}")
    return _HaloExchange.apply(x, int(left), int(right), group, edges)


def _halo(x, left, right, frames: Split | None, phase: int = 0):
    """``x`` extended by ``left`` / ``right`` frames (the same on every
    rank): exchanged over ``frames``, or zeros without a split; its first
    ``phase`` frames dropped."""
    if frames is None:
        ext = F.pad(x, (0,) * (2 * (x.dim() - 2)) + (left, right))
    else:
        ext = halo_exchange(x, left, right, frames.group, frames.bounds)
    return ext[:, phase:]


def _grid(frames: Split | None, local: int, stride: int):
    """``(phase, count)`` of a block of ``local`` frames for a stride-``s``
    output grid: its first frame on the grid, and the outputs it keeps
    (``⌈b/s⌉ − ⌈a/s⌉`` of the block ``[a, b)``)."""
    if frames is None:
        return 0, -(-local // stride)
    edges = frames.edges(local)
    a, b = edges[frames.index], edges[frames.index + 1]
    return (-a) % stride, -(-b // stride) - -(-a // stride)


def sp_causal_accumulate(x, kernel_size: int, stride: int, group):
    """Sequence-parallel RT accumulation: a halo of ``(Γ//s − 1)·s`` past
    frames, the causal window sum on the extended block, the halo dropped.
    Equals :func:`stgx_torch.ops.temporal.causal_accumulate` on the whole
    sequence."""
    left = (kernel_size // stride - 1) * stride
    ext = halo_exchange(x, left, 0, group)
    return causal_accumulate(ext, kernel_size, stride)[:, left:]


def sp_temporal_conv(x, W, b=None, stride: int = 1, dilation: int = 1,
                     padding: str | int = "same", group=None, extended=None,
                     frames: Split | None = None):
    """Sequence-parallel temporal conv: the padding's frames as halos, then
    a ``valid`` conv on the extended block. Equals
    :func:`stgx_torch.ops.temporal.temporal_conv` on the whole sequence,
    its output split as the strided split of the input
    (:meth:`Split.strided`). ``padding`` is ``"same"``, ``"causal"`` or an
    int (that many frames on both sides; the length is kept where the
    dilated span is twice it). ``extended``, if given, maps the
    halo-extended block before the conv (a tensor-parallel layer gathers
    its channel blocks there, so the halos travel in blocks).

    ``frames`` is the input's split (its bounds give the block's stride
    phase); without it, ``group`` splits the frames in equal blocks whose
    length must be a multiple of the stride."""
    eff = (W.shape[0] - 1) * dilation
    if padding == "same":
        left, right = eff // 2, eff // 2
    elif padding == "causal":
        left, right = eff, 0
    elif isinstance(padding, int) and not isinstance(padding, bool):
        left, right = padding, padding
    else:
        raise ValueError("sp_temporal_conv supports 'same', 'causal' or an int")
    if frames is None:
        if x.shape[1] % stride:
            # every rank's first output must sit on stride phase 0: then a valid
            # strided conv of the extended block taps the frames the whole
            # sequence's conv taps for those outputs
            raise ValueError(
                f"sequence-parallel strided conv needs the per-rank length ({x.shape[1]}) "
                f"to be a multiple of stride={stride}; pass frames= for any phase")
        frames = Split(dist.get_world_size(group), dist.get_rank(group), group)
    phase, count = _grid(frames, x.shape[1], stride)
    # the extended block from the first output's first tap
    ext = _halo(x, left, right, frames, phase)
    if extended is not None:
        ext = extended(ext)
    y = temporal_conv(ext, W, b, stride=stride, dilation=dilation, padding="valid")
    return y[:, :count]


def sp_temporal_shift(x, shift, stride: int = 1, frames: Split | None = None,
                      max_shift: int = MAX_SHIFT):
    """:func:`stgx_torch.ops.shift.temporal_shift` of this rank's block of
    frames ``frames``: output ``j`` reads frames ``j·s − K … j·s + K + 1``,
    so the kernel is launched on the block extended by ``K'`` frames back
    (``K`` rounded up to the stride, less the block's phase) and ``K + 1``
    ahead; of its outputs the block's ``⌈b/s⌉ − ⌈a/s⌉`` are kept, from the
    ``K'/s``-th. Equals the shift of the whole sequence, split as
    ``frames.strided(stride)``. Without a split it is the shift itself."""
    if frames is None:
        return temporal_shift(x, shift, stride, max_shift)
    phase, count = _grid(frames, x.shape[1], stride)
    back = -(-max_shift // stride) * stride
    ext = _halo(x, back, max_shift + 1, frames, phase)
    first = back // stride
    return temporal_shift(ext, shift, stride, max_shift)[:, first: first + count]


def sp_avg_pool(x, k: int = 2, frames: Split | None = None):
    """The mean of each ``k`` frames (output ``j`` of frames ``kj … kj + k −
    1``), the sequence's last ``L mod k`` frames dropped; under ``frames``
    this rank's outputs ``[⌈a/k⌉, ⌈b/k⌉)`` (within ``L // k``), a group that
    straddles two blocks completed from the next block's first frames."""
    if frames is None:
        n, l = x.shape[:2]
        lt = (l // k) * k
        return x[:, :lt].reshape(n, lt // k, k, *x.shape[2:]).mean(dim=2)
    edges = frames.edges(x.shape[1])
    a, b = edges[frames.index], edges[frames.index + 1]
    first, stop = -(-a // k), min(-(-b // k), edges[-1] // k)
    count = max(stop - first, 0)
    ext = _halo(x, 0, k - 1, frames)[:, first * k - a: (first + count) * k - a]
    return ext.reshape(x.shape[0], count, k, *x.shape[2:]).mean(dim=2)


def decimate(t, stride: int, frames: Split | None = None):
    """``t[:, ::stride]`` of the whole sequence, on this rank's block: the
    block's frames on the stride's grid (``None`` stays None)."""
    if t is None or stride == 1:
        return t
    phase, _ = _grid(frames, t.shape[1], stride)
    return t[:, phase::stride]


def frame_mean(x, dims=(1, 2), frames: Split | None = None):
    """``x.mean(dim=dims)`` (``dims`` holding axis 1, the frames) of the
    whole sequence, its frames split as ``frames``: the blocks' sums added
    over the split's group (differentiable; the backward adds every rank's
    gradient)."""
    if frames is None:
        return x.mean(dim=dims)
    count = frames.edges(x.shape[1])[-1] * math.prod(x.shape[d] for d in dims if d != 1)
    return sum_parts(x.sum(dim=dims), frames.group) / count
