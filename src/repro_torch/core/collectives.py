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

A call whose group has more than one rank also adds its result's bytes
(elements x item size) to ``byte_counters`` under the same key: the bytes
that reach this rank over the wire, as the reference's
``launch/hlo_analysis.py`` sums the result shapes of the post-SPMD
program's collectives.  The port issues every collective itself, so this
count takes the place of that HLO parse: there is no program text to
read and no loop trip count to recover.  Both counters run on every
device, so a dry run and a real run of one step can be compared;
``reset_counters()`` clears both.

The dry run (``launch/dryrun.py``).  An input on the meta device is
counted exactly as above and returns a meta result of the collective's
shape: no process group is asked for (a ``launch.mesh.Mesh`` built with
``connect=False`` has none) and nothing is exchanged.  A CPU or CUDA
input on a mesh without process groups still raises.

Tensors go to the backend as they are: NCCL with one card per rank,
gloo for ranks that share a card or run on the CPU (gloo takes CUDA tensors
for all four ops and moves them through host memory itself).
``async_op=True`` returns a ``Pending`` whose ``wait()`` gives the result.

Autograd.  Each kind is one ``torch.autograd.Function`` whose backward is
its transpose: all_gather <-> psum_scatter along the same dim, all_to_all
<-> the same exchange of the gradient, psum and pmean as the rule below
fixes.  A backward's collective counts under ``(kind, axes, "backward")``;
with grad off nothing runs but the forward, so a serving step's census is
unchanged.  pmax (and the int32 count exchanges of ``models.moe``) carry
no gradient.  An ``async_op=True`` all_to_all or all_gather of a tensor
that requires grad is issued exactly as with grad off (the dropless EP
exchange keeps its schedule); its ``Pending.wait()`` hands back the
received buffer as the output of the send tensor (``_Received``), whose
backward is the same transpose, run synchronously when the engine reaches
it.  A received buffer that never enters the loss (the dropless body's
overflowed first attempt) gets no backward on any rank.  Every rank builds
the same graph, so the engine runs the backward's collectives in one order
on every rank.

The replicated-value rule (Megatron's conjugate pair).  The port runs
SPMD with no replication tracking, so every value a group of ranks holds
alike states how its gradient is held: WHOLE (each rank holds the true
gradient) or in SHARES (the true gradient is the ranks' sum).  The
residual stream, a row-parallel sum and every loss are held WHOLE; the
inputs of TP-parallel products are held in SHARES, since each rank's
product sees only its block.  The conversions, and where they stand:

  copy_in      identity, backward psum: a value held WHOLE entering
               column-parallel products with the stream whole (``sp``
               off): each sub-layer's entry ``ShardingPlan.gather_seq``
               (partitioner.py:318-339; the QKV inputs, layers.py:459,
               590, model.py:360, 446; ``w_in``, layers.py:674; RWKV6
               time-mix and the RG-LRU, ssm.py:137, 258; the channel-mix
               its ``xk`` alone, ssm.py:199), the MoE entry ``x_loc``
               (moe.py:776), the LM head's ``x`` (model.py:777), the
               whisper encoder's and its cross-attention's inputs
               (model.py:467, 604, 609).  With the stream cut along seq
               the same entries are all_gathers, whose psum_scatter
               backward sums the shares (partitioner.py:328-330).
  psum         ``grad="whole"`` (the default): a sum every rank uses
               alike passes the gradient to each summand as it is:
               ``reduce_out`` (partitioner.py:341-351), the embedding's
               (model.py:553), the MoE's TP sums (moe.py:462, 520, 601, 683).
               ``grad="sum"`` where each rank uses the sum on its block
               only: RWKV6's ``ln_x`` (ssm.py:118).
  all_gather   ``grad="sum"`` (the default) where column-parallel
               products consume the result (the entries above, the fused
               MoE's widening, moe.py:503, 644); ``grad="whole"`` where every
               rank uses it alike: the logits over TP and over the batch
               axes, whose backward takes the rank's block and does not
               sum it (model.py:574, 577: every rank computes the same
               whole-batch loss), the MoE's epilogue gathers (moe.py:458,
               527, 605, 734).
  scatter      this rank's block of a value held WHOLE, backward an
               all_gather: ``cut_seq`` (partitioner.py:353-366) after the
               embedding (model.py:727), after replicated heads and at
               the MoE's exit; ``cut_seq(grad="sum")``, a plain slice,
               where the value is held in SHARES (ssm.py:202).
  share        identity, backward the whole gradient on group rank 0 and
               zero elsewhere: the router's weights where the combine
               runs on the whole width (moe.py:490, 589), so they join the
               router input's shares.
  pmean        the router aux on a mesh is the mean of every rank's
               (moe.py:441); its gradient follows that definition, 1/n
               to each rank's aux.

A leaf replicated over ranks that saw different rows gets one psum of its
gradient over them after the backward (``train_step.reduce_grads``,
``ShardingPlan.grad_sum_axes``, partitioner.py:368-386): over the batch
axes it is not stored cut over, and over the TP axes where each TP rank
holds only a share of its gradient.  The leaf's declaration says where
(``models.param.P.tp_share``, beside the code that applies it): "tp" for
the MoE's norm and router, "heads" for MLA's down-projections and their
norms and RWKV6's mixes, decay LoRA and ``ln_x`` (with the heads split),
"seq" for every norm applied to the rank's seq block with the stream cut
along seq (and the channel-mix's mixes and receptance).  An FSDP leaf's
data axes are summed by its gather's reduce-scatter
(``ShardingPlan.unshard``) instead.
"""

from __future__ import annotations

import collections
from typing import Callable

import torch
import torch.distributed as dist

counters: collections.Counter = collections.Counter()
byte_counters: collections.Counter = collections.Counter()

# newer torch renames the dim-0 gather / reduce-scatter (same arguments)
_gather_dim0 = getattr(dist, "all_gather_single",
                       dist.all_gather_into_tensor)
_scatter_dim0 = getattr(dist, "reduce_scatter_single",
                        dist.reduce_scatter_tensor)

BACKWARD = "backward"


def reset_counters() -> None:
    counters.clear()
    byte_counters.clear()


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
           post=lambda t: t, *, async_op: bool = False,
           backward: bool = False):
    """Count the call, then run ``run(out, inp, group, async_op)`` on the
    group of ``axes``; ``post`` maps the raw output to the result.  A
    one-rank group returns ``post`` of ``inp`` reshaped, with no exchange.
    A backward's call counts under ``(kind, axes, "backward")``; a group
    of more than one rank adds the result's bytes to ``byte_counters``.
    A meta input returns ``post`` of a meta result, with no group."""
    axes = mesh.axes(axes)
    key = (kind, axes, BACKWARD) if backward else (kind, axes)
    counters[key] += 1
    if mesh.axis_size(axes) == 1:
        res = post(inp.reshape(out_shape))
        return Pending(None, lambda: res) if async_op else res
    out = torch.empty(out_shape, dtype=inp.dtype, device=inp.device)
    byte_counters[key] += out.numel() * out.element_size()
    inp = inp.contiguous()
    if out.device.type == "meta":
        res = post(out)
        return Pending(None, lambda: res) if async_op else res
    work = run(out, inp, mesh.group(axes), async_op)
    pend = Pending(work if async_op else None, lambda: post(out))
    return pend if async_op else pend.wait()


# ---------------------------------------------------------------------------
# the exchanges themselves (no autograd)
# ---------------------------------------------------------------------------

def _a2a(x, mesh, axes, async_op=False, backward=False):
    def run(out, inp, group, a):
        return dist.all_to_all_single(out, inp, group=group, async_op=a)
    return _issue("all_to_all", mesh, axes, x, x.shape, run,
                  async_op=async_op, backward=backward)


def _ag(x, mesh, axes, axis, async_op=False, backward=False):
    n = axis_size(mesh, axes)
    axis = axis % x.dim()
    front = x.movedim(axis, 0)
    shape = (n * front.shape[0],) + tuple(front.shape[1:])

    def run(out, inp, group, a):
        return _gather_dim0(out, inp, group=group, async_op=a)
    return _issue("all_gather", mesh, axes, front, shape, run,
                  lambda t: t.movedim(0, axis).contiguous(),
                  async_op=async_op, backward=backward)


def _rs(x, mesh, axes, d, backward=False):
    n = axis_size(mesh, axes)
    d = d % x.dim()
    if x.shape[d] % n:
        raise ValueError(f"psum_scatter over {axes}: dim {d} of size "
                         f"{x.shape[d]} does not split into {n}")
    front = x.movedim(d, 0)
    shape = (front.shape[0] // n,) + tuple(front.shape[1:])

    def run(out, inp, group, a):
        return _scatter_dim0(out, inp, op=dist.ReduceOp.SUM, group=group,
                             async_op=a)
    return _issue("reduce_scatter", mesh, axes, front, shape, run,
                  lambda t: t.movedim(0, d).contiguous(), backward=backward)


def _ar(x, mesh, axes, op=dist.ReduceOp.SUM, async_op=False,
        backward=False):
    def run(out, inp, group, a):
        out.copy_(inp)
        return dist.all_reduce(out, op=op, group=group, async_op=a)
    return _issue("all_reduce", mesh, axes, x, x.shape, run,
                  async_op=async_op, backward=backward)


def _block(x, mesh, axes, axis):
    """This rank's block of ``x`` cut into the group's blocks along
    ``axis`` (a view)."""
    n = x.shape[axis] // axis_size(mesh, axes)
    j = axis_index(mesh, axes)
    return x.narrow(axis, j * n, n)


# ---------------------------------------------------------------------------
# autograd: one Function per kind, the backward the transpose under the
# module docstring's convention
# ---------------------------------------------------------------------------

def _a2a_transpose(g, mesh, axes):
    # entry i went to group rank i: its gradient comes back from there
    return _a2a(g, mesh, axes, backward=True)


def _ag_transpose(g, mesh, axes, axis, grad):
    if grad == "whole":               # every rank holds the whole gradient
        return _block(g, mesh, axes, axis)
    return _rs(g, mesh, axes, axis, backward=True)   # shares: sum, cut


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _a2a(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _a2a_transpose(g, ctx.mesh, ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, axis, grad):
        ctx.mesh, ctx.axes, ctx.axis, ctx.grad = mesh, axes, axis, grad
        return _ag(x, mesh, axes, axis)

    @staticmethod
    def backward(ctx, g):
        return _ag_transpose(g, ctx.mesh, ctx.axes, ctx.axis, ctx.grad), \
            None, None, None, None


class _Received(torch.autograd.Function):
    """The buffer an issued collective filled, as the output of its send
    tensor ``x``; the backward runs ``transpose`` of the gradient at
    once."""

    @staticmethod
    def forward(ctx, x, buf, transpose):
        ctx.transpose = transpose
        return buf

    @staticmethod
    def backward(ctx, g):
        return ctx.transpose(g), None, None


def _issued(x, issue, transpose) -> Pending:
    """Issue ``issue(x.detach())`` (a ``Pending``) as with grad off; its
    ``wait()`` attaches the received buffer to ``x``'s graph."""
    pend = issue(x.detach())
    return Pending(None, lambda: _Received.apply(x, pend.wait(), transpose))


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, d):
        ctx.mesh, ctx.axes, ctx.d = mesh, axes, d
        return _rs(x, mesh, axes, d)

    @staticmethod
    def backward(ctx, g):
        return _ag(g, ctx.mesh, ctx.axes, ctx.d, backward=True), None, \
            None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, grad):
        ctx.mesh, ctx.axes, ctx.grad = mesh, axes, grad
        return _ar(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "whole":
            return g, None, None, None
        return _ar(g, ctx.mesh, ctx.axes, backward=True), None, None, None


class _CopyIn(torch.autograd.Function):
    """Identity forward; the backward sums the ranks' shares (psum)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _ar(g, ctx.mesh, ctx.axes, backward=True), None, None


class _Scatter(torch.autograd.Function):
    """This rank's block along ``axis``; the backward gathers the ranks'
    blocks of the gradient, whole on every rank."""

    @staticmethod
    def forward(ctx, x, mesh, axes, axis):
        ctx.mesh, ctx.axes, ctx.axis = mesh, axes, axis
        return _block(x, mesh, axes, axis)

    @staticmethod
    def backward(ctx, g):
        return _ag(g, ctx.mesh, ctx.axes, ctx.axis, backward=True), None, \
            None, None


class _Share(torch.autograd.Function):
    """Identity forward; the backward keeps the whole gradient on group
    rank 0 and zero elsewhere: one exact share of it per rank."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.keep = axis_index(mesh, axes) == 0
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.keep else torch.zeros_like(g)), None, None


def _tracked(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


_GRADS = ("sum", "whole")


def _check_grad(grad):
    if grad not in _GRADS:
        raise ValueError(f"grad={grad!r}: want one of {_GRADS}")


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

def all_to_all(x, mesh, axes, *, async_op: bool = False):
    """``jax.lax.all_to_all(x, axes, 0, 0, tiled=False)``: x (n, ...) with
    n the group size -> (n, ...), entry i from group rank i.  Backward: the
    same exchange of the gradient."""
    n = axis_size(mesh, axes)
    if x.shape[0] != n:
        raise ValueError(f"all_to_all over {axes}: dim 0 is {x.shape[0]}, "
                         f"the group has {n} ranks")
    if not _tracked(x):
        return _a2a(x, mesh, axes, async_op)
    if async_op:
        return _issued(x, lambda d: _a2a(d, mesh, axes, True),
                       lambda g: _a2a_transpose(g, mesh, axes))
    return _AllToAll.apply(x, mesh, axes)


def all_gather(x, mesh, axes, *, axis: int, async_op: bool = False,
               grad: str = "sum"):
    """``jax.lax.all_gather(x, axes, axis=axis, tiled=True)``.  Backward:
    ``grad="sum"`` (each rank's gradient of the result is a share, as where
    a column-parallel product consumes it) reduce-scatters it along
    ``axis``; ``grad="whole"`` (every rank's gradient is the whole one, as
    where every rank uses the result identically) takes this rank's block,
    no collective."""
    _check_grad(grad)
    if not _tracked(x):
        return _ag(x, mesh, axes, axis, async_op)
    axis = axis % x.dim()
    if async_op:
        return _issued(x, lambda d: _ag(d, mesh, axes, axis, True),
                       lambda g: _ag_transpose(g, mesh, axes, axis, grad))
    return _AllGather.apply(x, mesh, axes, axis, grad)


def psum_scatter(x, mesh, axes, *, scatter_dimension: int):
    """``jax.lax.psum_scatter(x, axes, scatter_dimension=d, tiled=True)``:
    the group's sum, cut into n blocks along d; group rank i keeps block
    i.  Backward: an all_gather of the gradient along d."""
    if not _tracked(x):
        return _rs(x, mesh, axes, scatter_dimension)
    return _PsumScatter.apply(x, mesh, axes, scatter_dimension % x.dim())


def psum(x, mesh, axes, *, grad: str = "whole"):
    """The group's sum, on every rank.  Backward: ``grad="whole"`` (every
    rank uses the sum identically, so holds its whole gradient) passes the
    gradient to every summand as it is; ``grad="sum"`` (each rank holds a
    share of it) sums the shares first."""
    _check_grad(grad)
    if not _tracked(x):
        return _ar(x, mesh, axes)
    return _Psum.apply(x, mesh, axes, grad)


def pmax(x, mesh, axes, *, async_op: bool = False):
    """The group's max; it carries no gradient."""
    return _ar(x.detach(), mesh, axes, dist.ReduceOp.MAX, async_op)


def pmean(x, mesh, axes):
    """The group's mean: ``psum`` (its ``grad="whole"`` backward), then 1/n,
    so each rank's summand gets 1/n of the mean's gradient."""
    return psum(x, mesh, axes) / axis_size(mesh, axes)


def psum_grads(ts, mesh, axes) -> list:
    """Gradients summed over the group after the backward: one all_reduce
    of their float32 concatenation, counted as a backward's; each comes
    back in its own dtype."""
    flat = torch.cat([t.float().reshape(-1) for t in ts])
    flat = _ar(flat, mesh, axes, backward=True)
    out, i = [], 0
    for t in ts:
        out.append(flat[i:i + t.numel()].reshape(t.shape).to(t.dtype))
        i += t.numel()
    return out


def copy_in(x, mesh, axes):
    """Identity forward; the backward psums the gradient over the group
    (Megatron's ``f``): a value every rank holds whole, entering products
    whose gradient each rank holds only a share of."""
    if not _tracked(x):
        return x
    return _CopyIn.apply(x, mesh, axes)


def scatter(x, mesh, axes, *, axis: int):
    """This rank's block along ``axis`` of a value every rank holds whole,
    no collective; the backward all_gathers the blocks' gradients, so the
    whole value's gradient is whole on every rank (Megatron-SP's scatter
    to the sequence-parallel region)."""
    if not _tracked(x):
        return _block(x, mesh, axes, axis % x.dim())
    return _Scatter.apply(x, mesh, axes, axis % x.dim())


def share(x, mesh, axes):
    """Identity forward; the backward leaves the gradient, whole on every
    rank, on group rank 0 and zero on the others: a value whose gradient
    must join shares of another (the router's weights, see above)."""
    if not _tracked(x):
        return x
    return _Share.apply(x, mesh, axes)


__all__ = ["all_to_all", "all_gather", "psum", "psum_scatter", "pmax",
           "pmean", "psum_grads", "copy_in", "scatter", "share", "axis_index",
           "axis_size", "counters", "byte_counters", "reset_counters",
           "Pending", "BACKWARD"]
