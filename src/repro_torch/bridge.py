"""Carry the reference package's parameters into the port.

``from_reference`` takes the JAX reference's params tree as numpy arrays
(``jax.tree.map(np.asarray, params)`` on the reference side) and returns the
port's tree: the same names and layouts (``wq (h, nq, hd)``,
``wo (nq, hd, h)``, ``w_in (E, h, de)``, ``lm_head (h, padded_vocab)``), with
each layer group's leading ``count`` axis (and whisper's encoder layers')
unstacked into one dict per layer.
Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.partitioner import NULL_PLAN, ShardingPlan
from repro_torch.models.model import layer_plan, model_spec


def _tensor(a, device, dtype):
    # through float32 (which holds a bfloat16 leaf exactly); a float64 leaf,
    # such as a float64 gradient, keeps its precision
    a = np.asarray(a)
    wide = np.float64 if a.dtype == np.float64 else np.float32
    return torch.from_numpy(np.array(a, wide)).to(device=device, dtype=dtype)


def _cut(a, keep, path, spec):
    """This rank's block of the numpy leaf ``a`` (``keep`` None: whole)."""
    sl = keep(path, spec) if keep is not None else None
    return a if sl is None else a[sl]


def _unstack(tree, spec, i, keep, path, device, dtype):
    if isinstance(tree, dict):
        return {k: _unstack(v, spec[k], i, keep, path + (k,), device, dtype)
                for k, v in tree.items()}
    return _tensor(_cut(np.asarray(tree)[i], keep, path, spec), device,
                   dtype)


def from_reference(params_np: dict, cfg: ModelConfig, device="cpu",
                   dtype=torch.float32,
                   plan: ShardingPlan = NULL_PLAN) -> dict:
    """The port's parameter tree from the reference's numpy tree.  With a
    mesh plan every leaf is cut to this rank's block
    (``plan.keep_hook``), as ``models.model.init_params`` keeps it."""
    keep = plan.keep_hook(cfg)
    spec = model_spec(cfg)
    out = {}
    for name, leaf in params_np.items():
        if name == "groups":
            groups = []
            for gi, (g, tree) in enumerate(zip(layer_plan(cfg), leaf)):
                groups.append([
                    {sub: _unstack(sub_tree, spec["groups"][gi][i][sub], i,
                                   keep, ("groups", gi, i, sub), device,
                                   dtype)
                     for sub, sub_tree in tree.items()}
                    for i in range(g.count)])
            out["groups"] = groups
        elif name == "enc":       # whisper: its stacked layers unstacked
            sp = spec["enc"]
            out["enc"] = {k: [_unstack(v, sp[k][i], i, keep,
                                       ("enc", k, i), device, dtype)
                              for i in range(cfg.encoder.n_layers)]
                          if k == "layers" else
                          _tensor(_cut(np.asarray(v), keep, ("enc", k),
                                       sp[k]), device, dtype)
                          for k, v in leaf.items()}
        elif isinstance(leaf, dict):
            raise NotImplementedError(
                f"reference subtree {name!r} has no port counterpart")
        else:
            out[name] = _tensor(_cut(np.asarray(leaf), keep, (name,),
                                     spec[name]), device, dtype)
    return out


def opt_state_from_reference(state, cfg: ModelConfig, device="cpu"):
    """The port's ``AdamWState`` from the reference's (its ``step``, ``m``
    and ``v`` as numpy, as ``jax.tree.map(np.asarray, state)`` gives
    them): the moments unstacked as ``from_reference`` unstacks the
    parameters, whose layout they share, in the reference's moment dtype."""
    from repro_torch.training.optimizer import AdamWState
    from repro_torch.training.tree import leaves
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[
        str(leaves(state.m)[0].dtype)]
    return AdamWState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                          device=device),
        m=from_reference(state.m, cfg, device, dtype),
        v=from_reference(state.v, cfg, device, dtype))


__all__ = ["from_reference", "opt_state_from_reference"]
