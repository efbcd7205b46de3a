"""Walks of the port's nested trees (dicts, lists, named tuples) in the
reference's flatten order: dict keys sorted, list items and named-tuple
fields in order; and each leaf's declaration and storage on a mesh."""

from __future__ import annotations

from typing import Any, Callable

from repro_torch.models.model import model_spec
from repro_torch.models.param import is_p


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


def leaf_decls(cfg, tree) -> list:
    """The ``models.param.P`` declaring each leaf of ``tree`` (the params,
    or a state holding them, such as ``{"params": ..., "opt":
    AdamWState}``), in flatten order: the parameter whose path ends the
    leaf's (the params' own, or after a prefix such as ``params`` or
    ``opt/.m``); None for any other leaf (a step counter)."""
    table = {}

    def walk(path, node):
        if is_p(node):
            table[path] = node
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(path + (k,), v)
        else:
            for i, v in enumerate(node):
                walk(path + (i,), v)
    walk((), model_spec(cfg))

    def find(path):
        for i in range(len(path)):
            if path[i:] in table:
                return table[path[i:]]
        return None
    return [find(p) for p, _ in flatten_with_paths(tree)]


def store_specs(cfg, plan, tree) -> list:
    """Each leaf's ``plan.store_spec`` (the mesh axes each dim is stored
    cut over), in flatten order; None for a leaf no parameter declares,
    and for every leaf with no mesh."""
    return [plan.store_spec(cfg, d) if d is not None and plan.enabled
            else None for d in leaf_decls(cfg, tree)]


__all__ = ["flatten_with_paths", "leaves", "tree_map", "leaf_decls",
           "store_specs"]
