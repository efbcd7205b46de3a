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
from repro_torch.core.partitioner import NULL_PLAN, ShardingPlan
from repro_torch.models.model import layer_plan, model_spec


def _tensor(a, device, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(device=device,
                                                        dtype=dtype)


def _unstack(tree, spec, i, keep, device, dtype):
    if isinstance(tree, dict):
        return {k: _unstack(v, spec[k], i, keep, device, dtype)
                for k, v in tree.items()}
    a = np.asarray(tree)[i]
    if keep is not None:
        a = a[keep(spec)]
    return _tensor(a, device, dtype)


def from_reference(params_np: dict, cfg: ModelConfig, device="cpu",
                   dtype=torch.float32,
                   plan: ShardingPlan = NULL_PLAN) -> dict:
    """The port's parameter tree from the reference's numpy tree.  With a
    mesh plan the MoE weights are cut to this rank's slice, as
    ``models.model.init_params`` keeps them."""
    out = {}
    specs = model_spec(cfg)["groups"]
    for name, leaf in params_np.items():
        if name == "groups":
            groups = []
            for g, tree, spec in zip(layer_plan(cfg), leaf, specs):
                layers = []
                for i in range(g.count):
                    layer = {}
                    for sub, sub_tree in tree.items():
                        keep = (lambda p: plan.local_slices(p.shape, p.axes)) \
                            if sub == "moe" and plan.enabled else None
                        layer[sub] = _unstack(sub_tree, spec[i][sub], i, keep,
                                              device, dtype)
                    layers.append(layer)
                groups.append(layers)
            out["groups"] = groups
        elif isinstance(leaf, dict):
            raise NotImplementedError(
                f"reference subtree {name!r} has no port counterpart yet")
        else:
            out[name] = _tensor(leaf, device, dtype)
    return out


__all__ = ["from_reference"]
