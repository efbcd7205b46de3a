"""The ``jax.lax`` collectives the MoE block uses, over mesh rank groups.

The reference's sharded MoE body runs inside ``shard_map`` and speaks in
``jax.lax`` collectives over mesh axis names.  The port runs the same body
in every rank's process; these functions give each collective the same
meaning over the process group of the named axes (``launch.mesh.Mesh``):

  all_to_all(x, mesh, axes)              split_axis=0, concat_axis=0,
                                         tiled=False: x's dim 0 has one
                                         entry per group rank; entry i goes
                                         to group rank i, and the result's
                                         entry i came from it
  all_gather(x, mesh, axes, axis=)       tiled: the group's blocks
                                         concatenated along ``axis`` in
                                         group-rank order
  psum / pmax / pmean(x, mesh, axes)     all-reduce (sum, max, mean)
  psum_scatter(x, mesh, axes, scatter_dimension=)
                                         tiled reduce-scatter: the sum,
                                         cut along that dim, group rank i
                                         keeps block i
  axis_index / axis_size(mesh, axes)     row-major index and size

The dim-0 gather and reduce-scatter (``all_gather_into_tensor``,
``reduce_scatter_tensor``) work on dim 0, so
another dimension is moved to the front, made contiguous, and moved back.

Every call counts one in ``counters[(kind, axes)]`` (kind ``all_to_all``,
``all_gather``, ``reduce_scatter`` or ``all_reduce``), on an axis group of
size 1 too, as the reference's traced program holds it; only a group of
more than one rank communicates.  A collective that fails raises.

Tensors go to the backend as they are: NCCL with one card per rank,
gloo for ranks that share a card or run on the CPU (gloo takes CUDA tensors
for all four ops and moves them through host memory itself).
``async_op=True`` returns a ``Pending`` whose ``wait()`` gives the result.
"""

from __future__ import annotations

import collections
from typing import Callable

import torch
import torch.distributed as dist

counters: collections.Counter = collections.Counter()

# newer torch renames the dim-0 gather / reduce-scatter (same arguments)
_gather_dim0 = getattr(dist, "all_gather_single",
                       dist.all_gather_into_tensor)
_scatter_dim0 = getattr(dist, "reduce_scatter_single",
                        dist.reduce_scatter_tensor)


def reset_counters() -> None:
    counters.clear()


def axis_size(mesh, axes) -> int:
    return mesh.axis_size(axes) if axes else 1


def axis_index(mesh, axes) -> int:
    return mesh.axis_index(axes) if axes else 0


class Pending:
    """An issued collective; ``wait()`` returns its result once it is done
    (NCCL: once the current stream is ordered after it)."""

    def __init__(self, work, finish: Callable[[], torch.Tensor]):
        self._work, self._finish = work, finish

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
        return self._finish()


def _issue(kind: str, mesh, axes, inp: torch.Tensor, out_shape, run,
           post=lambda t: t, *, async_op: bool = False):
    """Count the call, then run ``run(out, inp, group, async_op)`` on the
    group of ``axes``; ``post`` maps the raw output to the result.  A
    one-rank group returns ``post`` of ``inp`` reshaped, with no exchange."""
    axes = mesh.axes(axes)
    counters[(kind, axes)] += 1
    if mesh.axis_size(axes) == 1:
        res = post(inp.reshape(out_shape))
        return Pending(None, lambda: res) if async_op else res
    out = torch.empty(out_shape, dtype=inp.dtype, device=inp.device)
    work = run(out, inp.contiguous(), mesh.group(axes), async_op)
    pend = Pending(work if async_op else None, lambda: post(out))
    return pend if async_op else pend.wait()


def all_to_all(x, mesh, axes, *, async_op: bool = False):
    """``jax.lax.all_to_all(x, axes, 0, 0, tiled=False)``: x (n, ...) with
    n the group size -> (n, ...), entry i from group rank i."""
    n = axis_size(mesh, axes)
    if x.shape[0] != n:
        raise ValueError(f"all_to_all over {axes}: dim 0 is {x.shape[0]}, "
                         f"the group has {n} ranks")

    def run(out, inp, group, a):
        return dist.all_to_all_single(out, inp, group=group, async_op=a)
    return _issue("all_to_all", mesh, axes, x, x.shape, run,
                  async_op=async_op)


def all_gather(x, mesh, axes, *, axis: int, async_op: bool = False):
    """``jax.lax.all_gather(x, axes, axis=axis, tiled=True)``."""
    n = axis_size(mesh, axes)
    axis = axis % x.dim()
    front = x.movedim(axis, 0)
    shape = (n * front.shape[0],) + tuple(front.shape[1:])

    def run(out, inp, group, a):
        return _gather_dim0(out, inp, group=group, async_op=a)
    return _issue("all_gather", mesh, axes, front, shape, run,
                  lambda t: t.movedim(0, axis).contiguous(),
                  async_op=async_op)


def psum_scatter(x, mesh, axes, *, scatter_dimension: int):
    """``jax.lax.psum_scatter(x, axes, scatter_dimension=d, tiled=True)``:
    the group's sum, cut into n blocks along d; group rank i keeps block
    i."""
    n = axis_size(mesh, axes)
    d = scatter_dimension % x.dim()
    if x.shape[d] % n:
        raise ValueError(f"psum_scatter over {axes}: dim {d} of size "
                         f"{x.shape[d]} does not split into {n}")
    front = x.movedim(d, 0)
    shape = (front.shape[0] // n,) + tuple(front.shape[1:])

    def run(out, inp, group, a):
        return _scatter_dim0(out, inp, op=dist.ReduceOp.SUM, group=group,
                             async_op=a)
    return _issue("reduce_scatter", mesh, axes, front, shape, run,
                  lambda t: t.movedim(0, d).contiguous())


def _all_reduce(x, mesh, axes, op, async_op=False):
    def run(out, inp, group, a):
        out.copy_(inp)
        return dist.all_reduce(out, op=op, group=group, async_op=a)
    return _issue("all_reduce", mesh, axes, x, x.shape, run,
                  async_op=async_op)


def psum(x, mesh, axes):
    return _all_reduce(x, mesh, axes, dist.ReduceOp.SUM)


def pmax(x, mesh, axes, *, async_op: bool = False):
    return _all_reduce(x, mesh, axes, dist.ReduceOp.MAX, async_op)


def pmean(x, mesh, axes):
    return psum(x, mesh, axes) / axis_size(mesh, axes)


__all__ = ["all_to_all", "all_gather", "psum", "psum_scatter", "pmax",
           "pmean", "axis_index", "axis_size", "counters",
           "reset_counters", "Pending"]
