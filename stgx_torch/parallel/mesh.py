"""The ``(data, seq, model)`` mesh over the processes of
``torch.distributed`` — the port of ``stgx/parallel/mesh.py``.

One process drives one device. The JAX package lays a batch over a GSPMD
mesh and lets XLA insert the collectives; the port runs the same step on
every process, each on its block of the batch, and makes the collectives
itself:

* :func:`init_distributed` starts the default process group with the
  device's backend: NCCL for ``cuda:LOCAL_RANK``, gloo for the CPU. A CUDA
  run without NCCL raises; it never drops to gloo.
* :func:`make_mesh` lays the processes out as a ``(data, seq, model)``
  grid (``torch.distributed.device_mesh.init_device_mesh``, row-major:
  world rank ``(d · seq + s) · model + m``), trials (or windows) over
  ``data``, frames over ``seq``, and over ``model`` the output channels of
  the tensor-parallel layers (:mod:`stgx_torch.parallel.tp`), the experts
  of Shift-GCN++'s student (:mod:`stgx_torch.parallel.ep`) or the
  refinement stages of the pipelined MS-TCN
  (:mod:`stgx_torch.parallel.pipeline`).
* A step whose batch is split runs under :func:`use_shards` with the
  :class:`Shards` of its layout: which of its axes 0 (trials or windows)
  and 1 (frames: a trial's, or a window's W) are split, over which group,
  and the group of every rank that holds a different part. The frame
  split carries its blocks' global bounds, which a strided layer maps
  (:meth:`Split.strided`, :func:`strided_layout`), so that blocks may
  differ in length. The ops that reduce over those axes read it
  (:func:`current_shards`): the masked batch statistics
  (:func:`stgx_torch.ops.norms.batch_norm`), the frame-axis ops of the
  models under ``seq`` (:mod:`stgx_torch.parallel.halo`), dropout (the
  single-process mask, sliced) and the loss (:mod:`stgx_torch.utils.loss`,
  given the layout explicitly). Without a layout, or with one part only,
  every op is exactly its one-process form.

Each sum over the mesh names its group. The parts of a step's batch are
summed over :attr:`Shards.group`: the ranks that share this rank's
``model`` position and hold other trials or frames (the whole world when
``model`` is 1, as before the axis existed). The ``model`` group
(:meth:`Mesh.split`) sums what is partial there: LayerNorm's moments over
the channel blocks, and the gradients of the parameters every model rank
holds whole but sees only a share of (the adjacency's edge importance under
TP, the stages under the pipeline). Replicas, ranks whose work is the same,
are summed over nothing. With ``model`` 1 every op is exactly its
``(data, seq)`` form.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from dataclasses import dataclass, field, replace
from typing import Any

import torch
import torch.distributed as dist

__all__ = [
    "init_distributed",
    "make_mesh",
    "Mesh",
    "Split",
    "Shards",
    "equal_split",
    "shard_batch",
    "replicate",
    "use_shards",
    "strided_layout",
    "current_shards",
    "sum_parts",
    "reduce_scalars",
    "gather_blocks",
    "is_primary",
    "barrier",
]


def backend_for(device) -> str:
    """``"nccl"`` for a CUDA device, ``"gloo"`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(device=None, init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None) -> torch.device:
    """Start the default process group for ``device`` and return the device
    this process drives.

    ``device`` None is ``cuda:LOCAL_RANK`` (torchrun's variable, 0 if
    unset); a CUDA device becomes the current one. ``init_method``,
    ``world_size`` and ``rank`` go to ``init_process_group`` (None:
    ``env://``, torchrun's ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
    ``MASTER_PORT``)."""
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    device = torch.device(device)
    backend = backend_for(device)
    if backend == "nccl":
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA run needs the NCCL backend, which this PyTorch "
                               "lacks; stgx_torch never runs CUDA collectives over gloo")
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)
    return device


@dataclass(frozen=True)
class Split:
    """One axis of a step's batch: split in ``size`` parts over ``group``,
    this rank's part ``index``; or whole (size 1, no group).

    ``bounds``, where set, are the global edges of every part along the
    axis (``size + 1`` numbers, part ``i`` the frames ``[bounds[i],
    bounds[i + 1])``), so that parts may differ in length: a frame split
    after a stride-``s`` layer (:meth:`strided`). None: equal parts."""

    size: int = 1
    index: int = 0
    group: Any = None
    bounds: tuple | None = None

    def edges(self, local: int) -> tuple:
        """The parts' global edges: ``bounds``, or equal parts of ``local``."""
        if self.bounds is not None:
            return self.bounds
        return tuple(i * local for i in range(self.size + 1))

    @property
    def start(self) -> int:
        """This part's first global frame (``bounds`` must be set)."""
        return self.bounds[self.index]

    @property
    def stop(self) -> int:
        return self.bounds[self.index + 1]

    @property
    def length(self) -> int:
        """The global length of the axis (``bounds`` must be set)."""
        return self.bounds[-1]

    def strided(self, stride: int) -> "Split":
        """The split of a stride-``stride`` layer's output: part ``[a, b)``
        keeps the outputs ``[⌈a/s⌉, ⌈b/s⌉)`` of the ``⌈L/s⌉`` (an output
        belongs to the rank of the frame its window is centred on, as the
        JAX package's ``ceil(L/s)`` outputs fall to the ranks)."""
        if stride == 1 or self.size == 1:
            return self
        return replace(self, bounds=tuple(-(-e // stride) for e in self.bounds))

    def part(self, t: torch.Tensor, axis: int) -> torch.Tensor:
        """This rank's part of ``t`` along ``axis``."""
        if self.size == 1:
            return t
        n = t.shape[axis]
        if self.bounds is not None:
            if n != self.length:
                raise ValueError(f"axis {axis} of {n} is not the split's {self.length}")
            return t.narrow(axis, self.start, self.stop - self.start)
        if n % self.size:
            raise ValueError(f"axis {axis} of {n} does not split in {self.size} parts")
        step = n // self.size
        return t.narrow(axis, self.index * step, step)


def equal_split(split: Split, length: int) -> Split:
    """``split`` with the bounds of ``length`` frames in equal parts."""
    step = length // split.size
    return replace(split, bounds=tuple(i * step for i in range(split.size + 1)))


@dataclass(frozen=True)
class Shards:
    """The layout of one step's batch over the mesh: axis 0 (trials or
    windows) split as ``n``, axis 1 (frames) as ``l``; ``group`` holds every
    rank with a different part (``parts`` of them; None when nothing is
    split), over which gradients and statistics are summed. ``device`` is
    where the collectives' scalars live. The frame split may carry its
    parts' bounds, which :meth:`strided` follows through a strided layer."""

    n: Split
    l: Split
    group: Any
    parts: int
    device: torch.device

    def local(self, t: torch.Tensor, axes: int = 2) -> torch.Tensor:
        """This rank's block of a global ``t`` (its first ``axes`` axes
        split as ``n`` and ``l``)."""
        t = self.n.part(t, 0)
        return self.l.part(t, 1) if axes > 1 else t

    def strided(self, stride: int) -> "Shards":
        """The layout after a stride-``stride`` layer (:meth:`Split.strided`)."""
        return replace(self, l=self.l.strided(stride))

    def _frames(self, local: int) -> tuple:
        """``(start, stop, global length)`` of this rank's frames."""
        edges = self.l.edges(local)
        return edges[self.l.index], edges[self.l.index + 1], edges[-1]

    def global_shape(self, shape) -> tuple:
        shape = list(shape)
        shape[0] *= self.n.size
        if len(shape) > 1:
            shape[1] = self._frames(shape[1])[2]
        return tuple(shape)

    def block(self, shape) -> tuple:
        """Slices of this rank's block within the global shape of a local
        ``shape``."""
        sl = [slice(self.n.index * shape[0], (self.n.index + 1) * shape[0])]
        if len(shape) > 1:
            sl.append(slice(*self._frames(shape[1])[:2]))
        return tuple(sl)


AXES = ("data", "seq", "model")


@dataclass
class Mesh:
    """A ``(data, seq, model)`` grid of the processes; ``shape`` as the JAX
    mesh's (``{"data": d, "seq": s, "model": m}``), ``device`` this
    process's device, ``parts_group`` the ranks of this rank's ``model``
    position (None when ``model`` is 1: the whole world)."""

    device_mesh: Any
    device: torch.device
    shape: dict = field(default_factory=dict)
    parts_group: Any = None

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["seq"] * self.shape["model"]

    @property
    def coordinate(self) -> tuple:
        """This process's ``(data, seq, model)`` position."""
        return tuple(self.device_mesh.get_coordinate())

    def split(self, axis: str) -> Split:
        """``axis`` as a :class:`Split`: its size, this rank's index along
        it and the group of the ranks that differ from this one only there."""
        return Split(self.shape[axis], self.coordinate[AXES.index(axis)],
                     self.device_mesh.get_group(axis))

    def shards(self, split_n: bool, split_l: bool, length: int | None = None) -> Shards:
        """The layout of a batch with axis 0 split over ``data`` if
        ``split_n`` and axis 1 over ``seq`` if ``split_l`` (its ``length``
        frames, where given, in equal parts with their bounds); its parts
        are summed over the ranks of this rank's ``model`` position."""
        n = self.split("data") if split_n else Split()
        l = self.split("seq") if split_l else Split()
        if length is not None and l.size > 1:
            l = equal_split(l, length)
        if split_n and split_l:
            group = dist.group.WORLD if self.parts_group is None else self.parts_group
        elif split_n or split_l:
            group = (n if split_n else l).group
        else:
            group = None
        return Shards(n, l, group, n.size * l.size, self.device)


def make_mesh(data: int | None = None, seq: int = 1, model: int = 1, device=None) -> Mesh:
    """The ``(data, seq, model)`` mesh over every process of the
    initialised default group (:func:`init_distributed`). ``data`` defaults
    to ``world // (seq · model)``; a product other than the world size
    raises, as does a device whose backend is not the group's."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised "
                           "(stgx_torch.parallel.mesh.init_distributed)")
    world = dist.get_world_size()
    if data is None:
        data = world // (seq * model)
    if data < 1 or seq < 1 or model < 1 or data * seq * model != world:
        raise ValueError(f"mesh (data={data}, seq={seq}, model={model}) does not match the "
                         f"world size {world}")
    backend = dist.get_backend()
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device()) if backend == "nccl"
                  else torch.device("cpu"))
    device = torch.device(device)
    if backend_for(device) != backend:
        raise RuntimeError(f"a mesh on {device} needs the {backend_for(device)} backend; "
                           f"the process group runs {backend}")
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(device.type, (data, seq, model), mesh_dim_names=AXES)
    parts = None
    if model > 1:  # one group of the (data, seq) ranks for each model position
        for m in range(model):
            group = dist.new_group(list(range(m, world, model)))
            if dist.get_rank() % model == m:
                parts = group
    return Mesh(dm, device, {"data": data, "seq": seq, "model": model}, parts)


def shard_batch(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This process's block of a ``(N, L, ...)`` batch: N over ``data``, L
    over ``seq`` (each must divide)."""
    split_l = x.dim() > 1 and mesh.shape["seq"] > 1
    return mesh.shards(True, split_l, x.shape[1] if split_l else None).local(x)


def replicate(mesh: Mesh, tensors) -> None:
    """Broadcast a module's parameters and buffers (or an iterable of
    tensors) from rank 0 to every process, in place: one broadcast of the
    tensors of each type and device, flattened together."""
    if isinstance(tensors, torch.nn.Module):
        tensors = [*tensors.parameters(), *tensors.buffers()]
    groups = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    with torch.no_grad():
        for ts in groups.values():
            flat = torch.cat([t.data.reshape(-1) for t in ts])
            dist.broadcast(flat, src=0)
            for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                t.data.copy_(part.view_as(t))


_SHARDS: contextvars.ContextVar = contextvars.ContextVar("stgx_torch_shards", default=None)


@contextlib.contextmanager
def use_shards(shards: Shards | None):
    """Run the ops inside on the layout ``shards`` (None: one process)."""
    token = _SHARDS.set(shards if shards is not None and shards.parts > 1 else None)
    try:
        yield
    finally:
        _SHARDS.reset(token)


def strided_layout(stride: int):
    """A context that runs the ops inside on the current layout after a
    stride-``stride`` layer (:meth:`Shards.strided`): the frame split's
    bounds follow the decimated frames. Nothing changes without a layout."""
    shards = _SHARDS.get()
    if shards is None or stride == 1:
        return contextlib.nullcontext()
    return use_shards(shards.strided(stride))


def current_shards() -> Shards | None:
    """The layout of the step being run, if its batch has several parts."""
    return _SHARDS.get()


class _SumParts(torch.autograd.Function):
    """An all-reduce whose backward all-reduces the gradient too (what
    ``torch.distributed.nn.functional.all_reduce`` does, without the
    functional-collectives stack that module imports on first use)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.contiguous().clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sum_parts(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``, differentiable (the backward sums the
    gradients over the group too: every part's loss reads the sum)."""
    return _SumParts.apply(t, group)


def reduce_scalars(values, group, device, op=dist.ReduceOp.SUM) -> list:
    """Python numbers reduced over ``group`` (float64 on ``device``)."""
    t = torch.tensor([float(v.detach()) if torch.is_tensor(v) else float(v) for v in values],
                     dtype=torch.float64, device=device)
    dist.all_reduce(t, op=op, group=group)
    return t.tolist()


def gather_blocks(t: torch.Tensor, shards: Shards) -> torch.Tensor:
    """The global tensor of every part's block ``t`` (axes 0 and 1 split as
    ``shards`` says), on every rank; not differentiable."""
    if shards is None or shards.group is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(shards.parts)]
    dist.all_gather(parts, t, group=shards.group)
    rows = []
    for i in range(shards.n.size):
        row = parts[i * shards.l.size: (i + 1) * shards.l.size]
        rows.append(torch.cat(row, dim=1) if len(row) > 1 else row[0])
    return torch.cat(rows, dim=0) if len(rows) > 1 else rows[0]


def is_primary() -> bool:
    """Whether this process writes the run's files: rank 0, or the only
    process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every process (nothing to wait for in one process)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
