"""Carry the reference package's parameters into the port.

``from_reference`` takes the JAX reference's params tree as numpy arrays
(``jax.tree.map(np.asarray, params)`` on the reference side) and returns the
port's tree: the same names and layouts (``wq (h, nq, hd)``,
``wo (nq, hd, h)``, ``w_in (E, h, de)``, ``lm_head (h, padded_vocab)``), with
each layer group's leading ``count`` axis unstacked into one dict per layer.
Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import layer_plan


def _tensor(a, device, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(device=device,
                                                        dtype=dtype)


def _unstack(tree, i: int, device, dtype):
    if isinstance(tree, dict):
        return {k: _unstack(v, i, device, dtype) for k, v in tree.items()}
    return _tensor(np.asarray(tree)[i], device, dtype)


def from_reference(params_np: dict, cfg: ModelConfig, device="cpu",
                   dtype=torch.float32) -> dict:
    """The port's parameter tree from the reference's numpy tree."""
    out = {}
    for name, leaf in params_np.items():
        if name == "groups":
            groups = []
            for g, tree in zip(layer_plan(cfg), leaf):
                groups.append([_unstack(tree, i, device, dtype)
                               for i in range(g.count)])
            out["groups"] = groups
        elif isinstance(leaf, dict):
            raise NotImplementedError(
                f"reference subtree {name!r} has no port counterpart yet")
        else:
            out[name] = _tensor(leaf, device, dtype)
    return out


__all__ = ["from_reference"]
