"""Flat-npz checkpoints of a tree of tensors, in the reference's format.

Each leaf is one ``.npy`` member of an uncompressed zip, keyed by its path:
dict keys and list indices joined by '/', a named tuple's field written as
``.name`` (an ``AdamWState``'s moments are ``opt/.m/...``), in the
reference's flatten order.  A bfloat16 leaf is written as the reference
writes one, its raw 2-byte words under the descr ``<V2``, and restored by
viewing those words as bfloat16 (the reference's own ``restore`` cannot
cast them back).  ``restore`` rebuilds the structure of ``like``, checks
every shape and casts to ``like``'s dtypes on ``like``'s devices.

On a mesh (``plan=``, ``cfg=``) each rank holds its blocks of the
parameters and their moments (``training.tree.store_specs``): ``save``
gathers every leaf whole, one at a time, and rank 0 alone writes the file
the single-device state gives, byte for byte; ``restore`` gives each rank
its block of every leaf.
"""

from __future__ import annotations

import os
import zipfile
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import collectives as C
from repro_torch.training.tree import flatten_with_paths, store_specs, tree_map


def _key(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _write_member(fid, t: torch.Tensor) -> None:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        words = t.view(torch.int16).numpy()
        np.lib.format.write_array_header_1_0(
            fid, {"descr": "<V2", "fortran_order": False,
                  "shape": tuple(words.shape)})
        fid.write(words.tobytes())
    else:
        np.lib.format.write_array(fid, t.numpy())


def _whole(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole leaf of this rank's block ``t`` stored by ``spec``: one
    all_gather along each cut dim."""
    for i, m in enumerate(spec or ()):
        if m is not None:
            t = C.all_gather(t, mesh, m, axis=i)
    return t


def save(path: str, tree: Any, *, plan=None, cfg=None) -> None:
    """Write ``tree`` to ``path`` through ``<path>.tmp`` and a rename.  On
    a mesh every rank calls it: each leaf is gathered whole in turn, rank
    0 writes, and every rank returns once the file is in place."""
    leaves_ = flatten_with_paths(tree)
    mesh = None if plan is None or not plan.enabled else plan.mesh
    specs = store_specs(cfg, plan, tree) if mesh is not None \
        else [None] * len(leaves_)
    writer = mesh is None or mesh.rank == 0
    tmp = path + ".tmp"
    zf = zipfile.ZipFile(tmp, "w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) if writer else None
    try:
        for (p, leaf), spec in zip(leaves_, specs):
            whole = torch.as_tensor(leaf) if mesh is None \
                else _whole(torch.as_tensor(leaf), spec, mesh)
            if writer:
                with zf.open(_key(p) + ".npy", "w",
                             force_zip64=True) as fid:
                    _write_member(fid, whole)
    finally:
        if zf is not None:
            zf.close()
    if writer:
        os.replace(tmp, path)
    if mesh is not None:
        dist.barrier()


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """A member ``np.load`` read (a fresh, writable, C-ordered array) as a
    tensor on the host, without a copy."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:     # bfloat16
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(path: str, like: Any, *, plan=None, cfg=None) -> Any:
    """The tree of ``like`` read from ``path``, a member at a time.  On a
    mesh ``like`` holds this rank's blocks, and so does the result: each
    member is read whole and cut to the rank's block (``plan.block``)."""
    paths = iter(flatten_with_paths(like))
    mesh_on = plan is not None and plan.enabled
    specs = iter(store_specs(cfg, plan, like) if mesh_on else ())

    def one(ref):
        key = _key(next(paths)[0])
        t = _tensor(data[key + ".npy"])
        spec = next(specs) if mesh_on else None
        if spec is not None:
            t = t[plan.block(tuple(t.shape), spec)].contiguous()
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: shape {tuple(t.shape)} != "
                             f"{tuple(ref.shape)}")
        return t.to(device=ref.device, dtype=ref.dtype)
    with np.load(path) as data:
        return tree_map(one, like)


__all__ = ["save", "restore"]
