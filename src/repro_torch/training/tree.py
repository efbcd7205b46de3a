"""Walks of the port's nested trees (dicts, lists, named tuples) in the
reference's flatten order: dict keys sorted, list items and named-tuple
fields in order."""

from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def flatten_with_paths(tree, path: tuple = ()) -> list:
    """[(path, leaf)]: ``path`` holds a dict key, a list index or a
    named tuple's field name (as ``.name``, the reference's key) a level."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in flatten_with_paths(tree[k], path + (k,))]
    if _is_namedtuple(tree):
        return [item for f in tree._fields
                for item in flatten_with_paths(getattr(tree, f),
                                               path + (f".{f}",))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in flatten_with_paths(v, path + (i,))]
    return [(path, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); the structure is kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


__all__ = ["flatten_with_paths", "leaves", "tree_map"]
