"""Device meshes and their collectives (port of
``ganleaks_tpu.parallel.mesh``).

torch has no ``Mesh``. Here a :class:`Mesh` is a 1-D row of the ranks of
one ``torch.distributed`` process group, one process per device as under
``torchrun``: the group, this rank, the world size, this rank's device and
the axis name. ``knn_shard``, ``ops/fid`` and ``multihost`` take it.

The collectives below stage through host memory where the group's backend
cannot carry the tensor: ``gloo`` with CUDA tensors (it carries them for
broadcast and all-reduce only, and several ranks on one card cannot share
an NCCL communicator). The choice is made from the backend, never by
catching an error. NCCL takes device tensors as they are. Each mesh counts
its collectives, the seconds spent in them and in the host copies, and the
bytes staged (``Mesh.stats``).
"""

from __future__ import annotations

import socket
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch
import torch.distributed as dist


@dataclass(eq=False)
class Mesh:
    """One rank's view of a 1-D mesh: ``size`` ranks of ``group`` (None:
    the default group), this process being ``rank`` on ``device``.
    ``share``: the ranks whose device is this rank's card (itself
    included), which split that card's memory budget."""

    rank: int
    size: int
    device: torch.device
    group: Any = None
    axis: str = "syn"
    share: int = 1
    stats: dict = field(default_factory=lambda: {
        "collectives": 0, "collective_s": 0.0, "staging_s": 0.0,
        "staged_bytes": 0})

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.group))

    @property
    def host_staged(self) -> bool:
        """Whether collectives copy CUDA tensors through host memory."""
        return self.device.type == "cuda" and self.backend == "gloo"

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def peer(self, rank: int) -> int:
        """The global rank of the group's ``rank``."""
        if self.group is None:
            return rank
        return dist.get_global_rank(self.group, rank)


def mesh_of(device: torch.device | str, group=None,
            axis: str = "syn") -> Mesh:
    """The mesh of the live process group ``group`` (any size, 1
    included), this process on ``device``. Collective: every rank of the
    group calls it (the ranks learn which of them share a card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    where = (socket.gethostname(), str(device))
    places = [None] * dist.get_world_size(group)
    dist.all_gather_object(places, where, group=group)
    return Mesh(rank=dist.get_rank(group), size=dist.get_world_size(group),
                device=device, group=group, axis=axis,
                share=sum(p == where for p in places))


def data_parallel_mesh(shape: tuple[int, ...] = (1,),
                       axis_names: tuple[str, ...] = ("data",),
                       device: torch.device | str | None = None
                       ) -> Mesh | None:
    """A mesh over ``prod(shape)`` ranks: None for one device (no
    collectives at all), else the live default group, which must hold
    exactly that many ranks (one per device). ``device``: this rank's
    (default: the current CUDA device where CUDA is up, else the CPU)."""
    n = int(np.prod(shape))
    if n <= 1:
        return None
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs {n} ranks, one per "
                         f"device; this process group has {world}")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    return mesh_of(device, axis=axis_names[0])


def shard_rows(n: int, mesh: Mesh, block: int = 1) -> tuple[int, int, int]:
    """This rank's contiguous rows of ``n``: ``(start, stop, per)``. Every
    rank's share is ``per`` rows, ``ceil(n / size)`` rounded up to whole
    ``block`` s (at most the share itself), padded to equal size; the last
    shards may hold fewer real rows, or none. Whole blocks keep each
    rank's blocks at the global block boundaries of a single-device walk
    of the set."""
    per = -(-n // mesh.size)
    block = max(1, min(block, per))
    per = -(-per // block) * block
    start = min(n, mesh.rank * per)
    return start, min(n, start + per), per


def shard_batch(batch, mesh: Mesh):
    """This rank's contiguous rows of ``batch`` (:func:`shard_rows`)."""
    start, stop, _ = shard_rows(len(batch), mesh)
    return batch[start:stop]


def _timed(mesh: Mesh, key: str, fn):
    t0 = time.perf_counter()
    out = fn()
    mesh.stats[key] += time.perf_counter() - t0
    return out


def _to_wire(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` as the backend carries it: a host copy on a staged mesh."""
    t = t.contiguous()
    if not (mesh.host_staged and t.is_cuda):
        return t
    # the copy waits for the work that produces t anyway: synchronise
    # first, so the staging seconds count the copy alone
    torch.cuda.current_stream(t.device).synchronize()
    mesh.stats["staged_bytes"] += t.numel() * t.element_size()
    return _timed(mesh, "staging_s", t.cpu)


def _from_wire(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    if mesh.host_staged and not t.is_cuda:
        mesh.stats["staged_bytes"] += t.numel() * t.element_size()
        return _timed(mesh, "staging_s", lambda: t.to(mesh.device))
    return t


def _collective(mesh: Mesh, fn):
    mesh.stats["collectives"] += 1
    return _timed(mesh, "collective_s", fn)


class RowGather:
    """An all-gather of equal shapes in two steps, so that a caller can
    agree on out-of-memory errors before the collective: construction
    stages ``x`` and allocates the gathered buffer (the only steps that
    allocate); :meth:`run` makes the collective and returns every rank's
    ``x`` stacked in rank order, ``(size, *x.shape)``, as the backend
    carries it (host memory on a staged mesh); :meth:`into` makes it and
    copies the rows into device memory the caller holds. ``len``: the
    rows gathered."""

    def __init__(self, x: torch.Tensor, mesh: Mesh):
        self.mesh, self.rows = mesh, mesh.size * x.shape[0]
        self.wire = _to_wire(mesh, x)
        if mesh.backend == "nccl":
            self.out = self.wire.new_empty((mesh.size,)
                                           + tuple(self.wire.shape))
        else:
            self.out = [torch.empty_like(self.wire)
                        for _ in range(mesh.size)]

    def run(self) -> torch.Tensor:
        mesh = self.mesh
        if mesh.backend == "nccl":
            _collective(mesh, lambda: dist.all_gather_into_tensor(
                self.out, self.wire, group=mesh.group))
            return self.out
        _collective(mesh, lambda: dist.all_gather(self.out, self.wire,
                                                  group=mesh.group))
        return torch.stack(self.out)

    def __len__(self) -> int:
        return self.rows

    def into(self, dst: torch.Tensor) -> None:
        """The collective, then the first ``len(dst)`` gathered rows (rank
        order) copied into ``dst``: no device allocation; on a staged
        mesh, a host-to-device copy counted as staging."""
        rows = self.run().flatten(0, 1)[:dst.shape[0]]
        if not self.mesh.host_staged:
            dst.copy_(rows)
            return
        self.mesh.stats["staged_bytes"] += rows.numel() * rows.element_size()
        _timed(self.mesh, "staging_s", lambda: dst.copy_(rows))


def gather_stack(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes on all ranks) stacked in rank
    order: ``(size, *x.shape)``."""
    return _from_wire(mesh, RowGather(x, mesh).run())


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's rows of ``x`` (equal shapes, padded where a share is
    short) concatenated on axis 0 in rank order."""
    out = gather_stack(x, mesh)
    return out.reshape((-1,) + tuple(x.shape[1:]))


def gather_state(d: torch.Tensor, i: torch.Tensor, mesh: Mesh
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The (distance, index) states of every rank, each ``(size,
    *shape)``."""
    return gather_stack(d, mesh), gather_stack(i, mesh)


def _scalar_device(mesh: Mesh) -> torch.device:
    return mesh.device if mesh.backend == "nccl" else torch.device("cpu")


def reduce_scalar(value: float, mesh: Mesh, op: str) -> float:
    """``value`` reduced over the ranks by ``op`` ('min', 'max', 'sum')."""
    ops = {"min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX,
           "sum": dist.ReduceOp.SUM}
    t = torch.tensor([value], dtype=torch.float64,
                     device=_scalar_device(mesh))
    _collective(mesh, lambda: dist.all_reduce(t, ops[op], group=mesh.group))
    return float(t.item())


def any_rank(flag: bool, mesh: Mesh) -> bool:
    """Whether ``flag`` is true on any rank (every rank gets the answer)."""
    return reduce_scalar(float(bool(flag)), mesh, "max") > 0


def _all_reduce(x: torch.Tensor, mesh: Mesh, op) -> torch.Tensor:
    """A new tensor: ``x`` reduced elementwise over the ranks by ``op``."""
    w = _to_wire(mesh, x)
    if w.data_ptr() == x.data_ptr():  # not staged: reduce a copy
        w = w.clone()
    _collective(mesh, lambda: dist.all_reduce(w, op, group=mesh.group))
    return _from_wire(mesh, w)


def reduce_max_tensor(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Elementwise maximum of ``x`` over the ranks."""
    return _all_reduce(x, mesh, dist.ReduceOp.MAX)


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Elementwise sum of ``x`` over the ranks (a new tensor, outside
    autograd)."""
    return _all_reduce(x, mesh, dist.ReduceOp.SUM)


class AllReduceSum(torch.autograd.Function):
    """``AllReduceSum.apply(x, mesh)``: ``x`` summed over the ranks,
    differentiable (counted in ``mesh.stats``, staged like the other
    collectives). The gradient of every rank's copy of the sum flows back
    to every rank's ``x``, so the backward is the same sum of the
    gradients — written with this Function, so the backward can itself be
    differentiated (a gradient penalty through a statistic over the
    batch)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        ctx.mesh = mesh
        return all_reduce_sum(x, mesh)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return AllReduceSum.apply(grad, ctx.mesh), None


def replicate(tree, mesh: Mesh):
    """Rank 0's values of a tensor, a module's parameters and buffers, or
    a dict / list / tuple of them, copied in place onto every rank
    (a broadcast from rank 0); returns ``tree``."""
    if isinstance(tree, torch.nn.Module):
        replicate(list(tree.parameters()) + list(tree.buffers()), mesh)
    elif isinstance(tree, dict):
        replicate(list(tree.values()), mesh)
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            replicate(t, mesh)
    elif isinstance(tree, torch.Tensor):
        w = _to_wire(mesh, tree.detach())
        _collective(mesh, lambda: dist.broadcast(w, mesh.peer(0),
                                                 group=mesh.group))
        if w.data_ptr() != tree.data_ptr():  # a staged or packed copy
            with torch.no_grad():
                tree.copy_(_from_wire(mesh, w))
    return tree


def gather_objects(obj, mesh: Mesh) -> list:
    """Every rank's picklable ``obj``, in rank order."""
    out = [None] * mesh.size
    _collective(mesh, lambda: dist.all_gather_object(out, obj,
                                                     group=mesh.group))
    return out


class RingTransfer:
    """A paired exchange around the ring in steps, so that a caller can
    agree on out-of-memory errors before each collective: construction
    stages ``tensors`` for the next rank and allocates the buffers for
    the previous rank's (same shapes; on an NCCL mesh, device memory);
    :meth:`start` posts the paired ``batch_isend_irecv`` (blocking sends
    around a ring deadlock under ``gloo``), which allocates no device
    memory; :meth:`finish` waits for it; :meth:`land` returns the received
    tensors on this rank's device (on a staged mesh, a device copy)."""

    def __init__(self, tensors: list[torch.Tensor], mesh: Mesh):
        self.mesh, self.works = mesh, []
        if mesh.size == 1:  # the ring of one: the tensors come back
            self.out = self.received = list(tensors)
            return
        self.out = [_to_wire(mesh, t) for t in tensors]
        self.received = [torch.empty_like(w) for w in self.out]

    def start(self) -> "RingTransfer":
        mesh = self.mesh
        if mesh.size == 1:
            return self
        nxt = mesh.peer((mesh.rank + 1) % mesh.size)
        prv = mesh.peer((mesh.rank - 1) % mesh.size)
        ops = []
        for tag, (w, r) in enumerate(zip(self.out, self.received)):
            ops.append(dist.P2POp(dist.isend, w, nxt, mesh.group, tag))
            ops.append(dist.P2POp(dist.irecv, r, prv, mesh.group, tag))
        self.works = _collective(mesh, lambda: dist.batch_isend_irecv(ops))
        return self

    def finish(self) -> None:
        _collective(self.mesh, lambda: [w.wait() for w in self.works])
        self.works = []

    def land(self) -> list[torch.Tensor]:
        return [_from_wire(self.mesh, t) for t in self.received]

    def wait(self) -> list[torch.Tensor]:
        """:meth:`finish`, then :meth:`land`."""
        self.finish()
        return self.land()


def ring_shift(tensors: list[torch.Tensor], mesh: Mesh) -> RingTransfer:
    """Send ``tensors`` to the next rank and receive the previous rank's
    (same shapes): a started :class:`RingTransfer`, which runs while this
    rank computes, until :meth:`RingTransfer.wait`."""
    return RingTransfer(tensors, mesh).start()
