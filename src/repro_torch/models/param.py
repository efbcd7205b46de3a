"""Minimal parameter-declaration system.

A model declares its parameters as a nested dict of ``P`` objects;
``init_tree`` materializes tensors and ``axes_tree`` yields the matching tree
of logical axis names.  The port keeps each layer's parameters apart
(``stack`` repeats a per-layer spec into a list) because the forward pass
loops over layers instead of scanning stacked arrays.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class P:
    """Declaration of one parameter tensor."""

    shape: tuple
    axes: tuple  # logical axis names (or None), len == len(shape)
    init: str = "normal"     # normal | zeros | ones
    scale: Optional[float] = None  # stddev; default 1/sqrt(fan_in)
    # on a mesh, when each TP rank's gradient of this leaf (replicated over
    # the TP axes) is only a share, to be summed after the backward:
    # "tp" always, "heads" when the heads split over TP (the leaf feeds
    # head-split products), "seq" when the residual stream is cut along
    # seq (the leaf is applied to the rank's seq block)
    tp_share: Optional[str] = None

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")
        if self.tp_share not in (None, "tp", "heads", "seq"):
            raise ValueError(f"tp_share {self.tp_share!r}")


def _init_one(gen: torch.Generator, p: P, dtype, device):
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=device)
    fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
    scale = p.scale if p.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.randn(p.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return x.mul_(scale).to(dtype)


def is_p(x) -> bool:
    return isinstance(x, P)


def _map(fn, tree):
    """Map ``fn`` over the P leaves of a nested dict/list (sorted keys)."""
    if is_p(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    raise TypeError(f"unexpected spec node {type(tree).__name__}")


def _leaves(tree) -> list:
    out = []
    _map(out.append, tree)
    return out


def init_tree(gen: torch.Generator, spec, dtype=torch.bfloat16,
              device="cuda", keep=None):
    """Materialize a spec tree into tensors on ``device``.  Every draw is
    float32 from ``gen`` (a generator on that device), then cast.

    ``keep(path, p)`` (path: the tuple of keys and list indices down to the
    leaf) may return a tuple of slices: only that block of the leaf is
    kept, copied out of the whole float32 draw, so the generator makes the
    same draws as for the whole tree and the block equals the same block
    of the whole tree.  The peak is one whole leaf."""
    def one(path, p):
        sl = keep(path, p) if keep is not None else None
        if sl is None:
            return _init_one(gen, p, dtype, device)
        whole = _init_one(gen, p, torch.float32, device)
        block = torch.empty(whole[sl].shape, dtype=dtype, device=device)
        return block.copy_(whole[sl])

    def walk(path, tree):
        if is_p(tree):
            return one(path, tree)
        if isinstance(tree, dict):
            return {k: walk(path + (k,), tree[k]) for k in sorted(tree)}
        if isinstance(tree, (list, tuple)):
            return [walk(path + (i,), v) for i, v in enumerate(tree)]
        raise TypeError(f"unexpected spec node {type(tree).__name__}")
    return walk((), spec)


def axes_tree(spec):
    """The tree of logical-axis tuples matching ``init_tree``'s output."""
    return _map(lambda p: p.axes, spec)


def param_count(spec) -> int:
    return sum(math.prod(p.shape) for p in _leaves(spec))


def stack(spec, n: int) -> list:
    """``n`` copies of a per-layer spec — one entry per layer."""
    return [spec for _ in range(n)]


__all__ = ["P", "init_tree", "axes_tree", "param_count", "stack", "is_p"]
