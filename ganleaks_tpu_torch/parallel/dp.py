"""Data-parallel training over ``torch.distributed`` (the part of ``pjit``
the JAX trainers get for free: ``ganleaks_tpu/train/*.py`` put the batch
on a ``P("data")`` sharding and XLA inserts the all-reduces).

One process per device, each holding the whole state; one copy of each
step function. A data-parallel step computes what one device computes on
the global batch:

* **Shares.** Each rank takes a contiguous share of each global batch,
  the shares differing by at most one row (``np.array_split``'s), so a
  last batch the ranks do not divide still trains (the JAX ``device_put``
  of such a batch raises). A batch with fewer rows than ranks raises.
* **Statistics.** Inside :meth:`DataParallel.run` the batch axis is on
  (``ops/nn.batch_axis``): BatchNorm, the minibatch std and medGAN's
  minibatch average take the global batch's statistics through
  :class:`parallel.mesh.AllReduceSum`, whose backward sums the gradient
  over the ranks too (and is itself differentiable, for PGGAN's gradient
  penalty).
* **Losses as shares, gradients summed.** Every mean over the batch is
  the rank's share of the global mean (``ops/nn.batch_mean``), so the
  global loss is the sum of the ranks' losses and its gradient the sum of
  their gradients: one flattened all-reduce (SUM) per optimizer step, as
  a step pre-hook on each optimizer. Averaging each rank's local-mean
  gradient instead is exact only for equal shares: with global
  statistics, the statistics' backward already sums every rank's
  unweighted gradient into each rank.
* **Draws.** Every draw with a row per image is drawn global-shaped from
  the same seeded generator on every rank and sliced to the rank's rows
  (``ops/nn.batch_draw``), so a run on n ranks consumes one process's
  random stream and can be compared with it.

Parameters start replicated (:func:`parallel.mesh.replicate` from rank
0, for loaded checkpoints too) and stay bit-identical: every rank applies
the same summed gradient with the same optimizer.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ganleaks_tpu_torch.ops.nn import batch_axis
from ganleaks_tpu_torch.parallel.mesh import (AllReduceSum, Mesh,
                                              all_reduce_sum, replicate)


def share_bounds(n: int, size: int) -> list[tuple[int, int]]:
    """Each rank's ``(start, stop)`` rows of ``n``: contiguous, the first
    ``n % size`` ranks one row more (``np.array_split``). Raises
    ``ValueError`` when ``n < size``: a rank would hold no row."""
    if n < size:
        raise ValueError(f"a batch of {n} rows cannot be shared by {size} "
                         f"ranks: every rank needs at least one row")
    per, extra = divmod(n, size)
    stops = np.cumsum([per + (r < extra) for r in range(size)])
    return [(int(b - per - (r < extra)), int(b))
            for r, b in enumerate(stops)]


def reduce_gradients(params, mesh: Mesh, scale: float = 1.0) -> None:
    """Sum the gradients of ``params`` over the ranks in place (times
    ``scale``): one flattened all-reduce per dtype; parameters without a
    gradient are left out (the same ones on every rank)."""
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]),
                              mesh)
        if scale != 1.0:
            flat.mul_(scale)
        at = 0
        for g in grads:
            g.copy_(flat[at:at + g.numel()].view_as(g))
            at += g.numel()


class DataParallel:
    """A data-parallel trainer's collectives on ``mesh``: ``modules``
    replicated from rank 0 at construction, each of ``optimizers``
    summing its gradients over the ranks before it steps."""

    def __init__(self, mesh: Mesh, modules, optimizers):
        self.mesh = mesh
        replicate(list(modules), mesh)
        self._hooks = [opt.register_step_pre_hook(self._pre_step)
                       for opt in optimizers]

    def _pre_step(self, opt, args, kwargs) -> None:
        reduce_gradients((p for g in opt.param_groups for p in g["params"]),
                         self.mesh)

    def rows(self, n: int) -> tuple[int, int]:
        """This rank's ``(start, stop)`` of an ``n``-row global batch."""
        return share_bounds(n, self.mesh.size)[self.mesh.rank]

    def shard(self, batch: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global batch."""
        start, stop = self.rows(len(batch))
        return batch[start:stop]

    def run(self, step_fn, state, batches, *args, **kwargs):
        """``step_fn(state, *shares, *args, **kwargs)`` on this rank's
        shares of the global ``batches`` (a sequence of equal row counts)
        with the batch axis on: what one device's ``step_fn(state,
        *batches, *args, **kwargs)`` computes, but each loss a rank's
        share (:meth:`metrics` sums them)."""
        n = len(batches[0])
        if any(len(b) != n for b in batches):
            raise ValueError(f"batches of {[len(b) for b in batches]} rows: "
                             f"a step's batches share one row count")
        start, _ = self.rows(n)
        with batch_axis(lambda t: AllReduceSum.apply(t, self.mesh), n,
                        start):
            return step_fn(state, *(self.shard(b) for b in batches), *args,
                           **kwargs)

    def metrics(self, metrics: dict) -> dict:
        """A step's metrics (each rank's share of a loss) summed over the
        ranks: the global batch's values, on every rank (one
        all-reduce)."""
        if not metrics:
            return metrics
        keys = list(metrics)
        vals = torch.stack([torch.as_tensor(metrics[k]).detach().float()
                            .reshape(()) for k in keys])
        total = all_reduce_sum(vals, self.mesh)
        return dict(zip(keys, total.unbind()))

    def barrier(self) -> None:
        dist.barrier(group=self.mesh.group)

    def close(self) -> None:
        for h in self._hooks:
            h.remove()
        self._hooks = []


def data_parallel(mesh: Mesh | None, modules, optimizers
                  ) -> DataParallel | None:
    """:class:`DataParallel` on ``mesh``; None without one (one device:
    the plain single-device loop)."""
    return None if mesh is None else DataParallel(mesh, modules, optimizers)


def is_main(dp: DataParallel | None) -> bool:
    """Whether this process logs and writes: rank 0, or the only one."""
    return dp is None or dp.mesh.is_main
