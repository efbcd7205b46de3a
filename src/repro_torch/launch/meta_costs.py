"""The costs of one step run on the meta device: FLOPs, bytes accessed,
and the bytes each rank's program keeps live.

``MetaCosts`` is one ``TorchDispatchMode``.  Inside it every aten op of the
step (forward, autograd's backward, the optimizer) runs on meta tensors,
which hold shapes and no data, and the mode adds up:

* ``flops``: the op's count from ``torch.utils.flop_counter``'s formulas
  (the same registry, skip list and decompositions ``FlopCounterMode``
  uses, so the two count one program alike); the hand-written kernels'
  counts come from ``kernels.ops.meta_flops``, which the dry run adds;
* ``bytes_accessed``: each op's input and output bytes (elements x item
  size), the eager program's own traffic; views and allocations move
  none;
* ``live`` / ``peak``: the bytes held by the storages the step allocates,
  each as PyTorch's CUDA caching allocator rounds a request (up to a
  multiple of ``ALLOC_ROUND``), so ``peak`` predicts
  ``torch.cuda.max_memory_allocated()`` less what was allocated before the
  step.  A storage is keyed by ``untyped_storage()._cdata`` and lives
  while any tensor object on it does (a weakref callback on each): a view
  keeps its base's storage alive, and a tensor autograd saves stays alive
  with the graph.  The storages of the step's arguments (``external``)
  and any output that aliases an input (an in-place op, a view) are not
  allocations.

Speed.  A meta kernel is a Python function of its inputs' shapes, strides
and dtypes, ~0.3-0.6 ms an op; the recurrent families' per-token loops
repeat a few ops of one shape hundreds of thousands of times.  So a
functional op (no argument or result aliases another: no view, no in-place
write, no ``out=``; and none seen returning its input's storage, as
``_unsafe_view`` does without saying so) is run once for each distinct
(op, input metadata, other arguments) and afterwards answered from that
first run: fresh meta tensors of the outputs' shapes, strides and dtypes
(``empty_strided``), its FLOPs and bytes.  That is what the meta kernel
would return, since it reads nothing else; every other op runs each
time.

What the meta device cannot see: temporaries a CUDA op allocates inside
itself (cuBLAS and sort workspaces) and the allocator's block splitting.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten
from torch.utils.flop_counter import flop_registry

ALLOC_ROUND = 512      # kMinBlockSize of c10/cuda/CUDACachingAllocator.cpp
LARGE_ALLOC = 1 << 20  # kSmallSize: larger requests come from the large pool

_ATEN = torch.ops.aten
_PRIM_DEVICE = torch.ops.prim.device.default
# shape queries FlopCounterMode hands back untouched (its own list)
_QUERIES = {_ATEN.sym_is_contiguous.default, _ATEN.is_contiguous.default,
            _ATEN.is_contiguous.memory_format,
            _ATEN.is_strides_like_format.default,
            _ATEN.is_non_overlapping_and_dense.default, _ATEN.size.default,
            _ATEN.sym_size.default, _ATEN.stride.default,
            _ATEN.sym_stride.default, _ATEN.storage_offset.default,
            _ATEN.sym_storage_offset.default, _ATEN.numel.default,
            _ATEN.sym_numel.default, _ATEN.dim.default,
            torch.ops.prim.layout.default}
# allocations that write nothing
_FRESH = {_ATEN.empty.memory_format, _ATEN.empty_strided.default,
          _ATEN.empty_like.default, _ATEN.new_empty.default,
          _ATEN.new_empty_strided.default}


class _Meta(NamedTuple):
    """A memoized output tensor's metadata."""
    shape: tuple
    stride: tuple
    dtype: torch.dtype


def _functional(func) -> bool:
    """No argument or result of ``func``'s schema aliases another."""
    sch = func._schema
    return all(a.alias_info is None for a in sch.arguments) \
        and all(r.alias_info is None for r in sch.returns)


def _tensors(x, out: list) -> list:
    """The tensors among an op's arguments or results (nested tuples,
    lists and dicts), in order."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


def _sig(x, out: list) -> bool:
    """Append the metadata of ``x``'s leaves to ``out``: shape, strides
    and dtype of a tensor, the value of anything else; False where a value
    cannot key a dict or a tensor is not on the meta device."""
    if isinstance(x, torch.Tensor):
        out.append((x.shape, x.stride(), x.dtype, x.device.type))
        return x.device.type == "meta"
    if isinstance(x, (list, tuple)):
        out.append(len(x))
        for v in x:
            if not _sig(v, out):
                return False
        return True
    try:
        hash(x)
    except TypeError:
        return False
    out.append(x)
    return True


def alloc_bytes(nbytes: int) -> int:
    """What the CUDA caching allocator counts for a request of ``nbytes``:
    nothing for none, else rounded up to a multiple of ``ALLOC_ROUND``."""
    return -(-nbytes // ALLOC_ROUND) * ALLOC_ROUND


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class MetaCosts(TorchDispatchMode):
    """Count a step's FLOPs, bytes accessed and live storage (module
    docstring).  ``external``: tensors that exist before the step (its
    arguments); their storages are never counted as allocations."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # no torch.compile runs under this mode: keep its dispatch free of
        # the dynamo-disabling wrapper (a few µs an op)
        return False

    def __init__(self, external=()):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.live = 0
        self.peak = 0
        self.live_storages_at_peak = 0
        self.large_storages_at_peak = 0
        self._large = 0            # live storages past LARGE_ALLOC
        self._external = {_key(t) for t in external}
        self._size: dict = {}      # storage key -> counted bytes
        self._refs: dict = {}      # storage key -> live tensor objects
        self._weak: dict = {}      # id(weakref) -> weakref (kept alive)
        self._memo: dict = {}      # a functional call's key -> its result
        self._whole: set = set()   # ops seen to have no decomposition
        self._pure: dict = {}      # op -> whether it may be memoized

    # -- storage lifetime --------------------------------------------------
    def _release(self, key: int, ref) -> None:
        self._weak.pop(id(ref), None)
        self._refs[key] -= 1
        if not self._refs[key]:
            del self._refs[key]
            size = self._size.pop(key)
            self.live -= size
            self._large -= size > LARGE_ALLOC

    def _hold(self, t: torch.Tensor, key: int) -> None:
        self._refs[key] += 1
        ref = weakref.ref(t, lambda r, k=key: self._release(k, r))
        self._weak[id(ref)] = ref

    def _new(self, t: torch.Tensor, key: int) -> None:
        """``t`` is the first tensor on a storage the step allocated."""
        size = self._size[key] = alloc_bytes(t.untyped_storage().nbytes())
        self._refs[key] = 0
        self._hold(t, key)
        self.live += size
        self._large += size > LARGE_ALLOC
        if self.live > self.peak:
            self.peak = self.live
            self.live_storages_at_peak = len(self._size)
            self.large_storages_at_peak = self._large

    def _track(self, outs, ins) -> None:
        in_ids = {id(t) for t in ins}
        in_keys = None
        for t in outs:
            if id(t) in in_ids:            # an in-place op returns its input
                continue
            key = _key(t)
            if key in self._refs:          # another view of a live storage
                self._hold(t, key)
                continue
            if key in self._external:
                continue
            if in_keys is None:
                in_keys = {_key(x) for x in ins}
            if key not in in_keys:         # else a view of an untracked one
                self._new(t, key)

    # -- dispatch ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _QUERIES:
            return NotImplemented
        if func not in self._whole and func is not _PRIM_DEVICE:
            # as FlopCounterMode: an op with a decomposition runs as it
            # (whether it has one depends on the op alone)
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
            self._whole.add(func)
        key = None
        if func not in self._pure:
            self._pure[func] = _functional(func)
        if self._pure[func]:
            sig: list = [func]
            if _sig(args, sig) and _sig(tuple(kwargs.items()), sig):
                key = tuple(sig)
                if key in self._memo:
                    return self._replay(*self._memo[key])
        out = func(*args, **kwargs)
        flops = 0
        packet = func._overloadpacket
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
        outs = _tensors(out, [])
        ins = _tensors(kwargs, _tensors(args, []))
        moved = 0
        if not func.is_view and func not in _FRESH:
            moved = sum(tensor_bytes(t) for t in ins) \
                + sum(tensor_bytes(t) for t in outs)
        if key is not None and any(t.device.type != "meta" for t in outs):
            key = None                   # a factory op making real tensors
        if key is not None and {_key(t) for t in outs} \
                & {_key(t) for t in ins}:
            # a result that aliases an input its schema does not declare
            # (``_unsafe_view``): never answered from memory
            self._pure[func] = False
            key = None
        if key is not None:
            leaves, spec = tree_flatten(out)
            self._memo[key] = (spec, [
                _Meta(tuple(t.shape), t.stride(), t.dtype)
                if isinstance(t, torch.Tensor) else t for t in leaves],
                flops, moved)
        self.flops += flops
        self.bytes_accessed += moved
        self._track(outs, ins)
        return out

    def _replay(self, spec, metas, flops, moved):
        """A memoized call's result: fresh meta outputs, and its costs."""
        leaves = [torch.empty_strided(m.shape, m.stride, dtype=m.dtype,
                                      device="meta")
                  if isinstance(m, _Meta) else m for m in metas]
        self.flops += flops
        self.bytes_accessed += moved
        for t in leaves:
            if isinstance(t, torch.Tensor):
                self._new(t, _key(t))
        return tree_unflatten(leaves, spec)


__all__ = ["MetaCosts", "alloc_bytes", "tensor_bytes", "ALLOC_ROUND"]
