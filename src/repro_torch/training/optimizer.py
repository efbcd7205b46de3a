"""AdamW with a cosine schedule, as the reference computes it.

The state is a step counter and the first and second moments ``m`` / ``v``,
trees shaped like the parameters (``init_opt_state``).  The schedule and the
bias corrections are float32 tensor arithmetic on the int32 step; each
leaf's update runs in float32 and is cast back to the parameter's dtype, and
the moments are stored in the dtype they were made in (float32 by default,
bfloat16 honoured).  Leaves are walked in the reference's flatten order
(dict keys sorted), so the float32 sum of squares behind the clip groups as
the reference's does, leaf by leaf; the reference sums a stacked layer
group as one leaf, the port a layer at a time.

``adamw_update`` writes the new parameters and moments INTO the given
tensors, one leaf after the other: the peak is one leaf's float32 working
set, and the old and new state never coexist (the reference's compiled step
gets the same from its buffers).  Callers that keep the old values clone
them first.

On a mesh each rank holds its blocks of the parameters, the gradients and
the moments; the update is elementwise on each block, and ``global_norm``
sums every distinct block once (``cuts``), so the clip is the
single-device one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.core import collectives as C
from repro_torch.training.tree import leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32
    m: dict                  # tree like params
    v: dict                  # tree like params


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    grad_clip: float = 1.0
    # the moments' storage dtype where a caller builds the state from the
    # config (init_opt_state(params, dtype) takes it); the update math runs
    # in float32 whatever it is
    moment_dtype: str = "float32"


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def cosine_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up to ``cfg.lr``, then a cosine decay to
    ``min_lr_ratio * lr`` at ``total_steps``: a () float32 tensor."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    warm, prog = _f32(warm), _f32(prog)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_opt_state(params, dtype=torch.float32) -> AdamWState:
    """Zero moments in ``dtype`` beside every leaf, step 0 on the leaves'
    device."""
    first = leaves(params)[0]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        m=tree_map(lambda p: torch.zeros(p.shape, dtype=dtype,
                                         device=p.device), params),
        v=tree_map(lambda p: torch.zeros(p.shape, dtype=dtype,
                                         device=p.device), params))


def global_norm(tree, cuts=None, mesh=None) -> torch.Tensor:
    """sqrt of the float32 sum of every leaf's sum of squares, summed leaf
    by leaf in flatten order.

    On a mesh ``cuts`` gives each leaf (flatten order) the mesh axes its
    block is cut over: the leaves cut alike are summed on each rank, then
    psummed over those axes, so each block counts once and a replicated
    leaf (cut over none) once."""
    xs = leaves(tree)
    parts: dict = {}
    for x, axes in zip(xs, cuts if cuts is not None else [()] * len(xs)):
        s = torch.sum(torch.square(x.float()))
        parts[axes] = s if axes not in parts else parts[axes] + s
    sq = None
    for axes, s in parts.items():
        if axes:
            s = C.psum(s, mesh, tuple(a for a in mesh.axis_names
                                      if a in axes))
        sq = s if sq is None else sq + s
    return torch.sqrt(sq)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state: AdamWState, params, *,
                 cuts=None, mesh=None):
    """One AdamW step.  Returns (params, new_state, stats) with ``params``
    and the state's moments updated in place (the same tensors).  On a
    mesh ``cuts`` and ``mesh`` go to ``global_norm``."""
    gnorm = global_norm(grads, cuts, mesh)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.grad_clip > 0 else 1.0
    step = state.step + 1
    lr = cosine_lr(cfg, step)
    stepf = step.float()
    b1c = 1 - torch.pow(_f32(cfg.beta1, stepf.device), stepf)
    b2c = 1 - torch.pow(_f32(cfg.beta2, stepf.device), stepf)
    for g, m, v, p in zip(leaves(grads), leaves(state.m), leaves(state.v),
                          leaves(params)):
        g = g.float() * scale
        m32 = cfg.beta1 * m.float() + (1 - cfg.beta1) * g
        v32 = cfg.beta2 * v.float() + (1 - cfg.beta2) * torch.square(g)
        u = (m32 / b1c) / (torch.sqrt(v32 / b2c) + cfg.eps)
        u = u + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * u)
        m.copy_(m32)
        v.copy_(v32)
    stats = {"lr": lr, "grad_norm": gnorm}
    return params, AdamWState(step=step, m=state.m, v=state.v), stats


__all__ = ["AdamWConfig", "AdamWState", "init_opt_state", "adamw_update",
           "cosine_lr", "global_norm"]
