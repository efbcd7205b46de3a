"""Flat-npz checkpoints of a tree of tensors, in the reference's format.

Each leaf is one ``.npy`` member of an uncompressed zip, keyed by its path:
dict keys and list indices joined by '/', a named tuple's field written as
``.name`` (an ``AdamWState``'s moments are ``opt/.m/...``), in the
reference's flatten order.  A bfloat16 leaf is written as the reference
writes one, its raw 2-byte words under the descr ``<V2``, and restored by
viewing those words as bfloat16 (the reference's own ``restore`` cannot
cast them back).  ``restore`` rebuilds the structure of ``like``, checks
every shape and casts to ``like``'s dtypes on ``like``'s devices.
"""

from __future__ import annotations

import os
import zipfile
from typing import Any

import numpy as np
import torch

from repro_torch.training.tree import flatten_with_paths, tree_map


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


def save(path: str, tree: Any) -> None:
    """Write ``tree`` to ``path`` through ``<path>.tmp`` and a rename."""
    tmp = path + ".tmp"
    with zipfile.ZipFile(tmp, "w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for p, leaf in flatten_with_paths(tree):
            with zf.open(_key(p) + ".npy", "w", force_zip64=True) as fid:
                _write_member(fid, torch.as_tensor(leaf))
    os.replace(tmp, path)


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """A member ``np.load`` read (a fresh, writable, C-ordered array) as a
    tensor on the host, without a copy."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:     # bfloat16
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(path: str, like: Any) -> Any:
    """The tree of ``like`` read from ``path``, a member at a time."""
    paths = iter(flatten_with_paths(like))

    def one(ref):
        key = _key(next(paths)[0])
        arr = data[key + ".npy"]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: shape {arr.shape} != "
                             f"{tuple(ref.shape)}")
        return _tensor(arr).to(device=ref.device, dtype=ref.dtype)
    with np.load(path) as data:
        return tree_map(one, like)


__all__ = ["save", "restore"]
