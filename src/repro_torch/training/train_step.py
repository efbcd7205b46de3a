"""The training step: cross-entropy (+ the MoE router's aux loss), its
gradients by autograd, and an AdamW step, on one device.

The step runs the stateless forward with the plan's kernel policy; the
hand-written kernels have no backward (nor have the reference's), so a plan
with kernels on raises at the first kernel the forward reaches
(``kernels.ops``).  ``remat=True`` recomputes each layer in the backward
instead of keeping its activations (``forward(remat=)``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.partitioner import NULL_PLAN, ShardingPlan
from repro_torch.models.model import forward
from repro_torch.training.optimizer import AdamWConfig, adamw_update
from repro_torch.training.tree import flatten_with_paths, leaves, tree_map


def cross_entropy(logits, labels, mask=None):
    """logits (b, s, v), integer labels (b, s) -> the mean negative log
    likelihood in float32 (over ``mask``'s weight when given).  The gold
    logit is a one-hot masked sum, as the reference takes it."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    v = logits.shape[-1]
    onehot = labels[..., None] == torch.arange(v, device=logits.device)
    gold = torch.sum(torch.where(onehot, logits, 0.0), dim=-1)
    nll = lse - gold
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def loss_fn(params, batch, cfg: ModelConfig, plan: ShardingPlan = NULL_PLAN,
            *, remat: bool = True):
    """batch: {tokens, labels[, mask, embeds, frames]} -> (loss, {ce, aux}).

    Training pins the MoE capacity dispatch, as the reference does: a plan
    whose ``dispatch_mode`` is "auto" (dropless when serving) trains on the
    fixed (E, C, h) buffers; an explicit "dropless" is honoured."""
    if plan.dispatch_mode == "auto":
        plan = dataclasses.replace(plan, dispatch_mode="capacity")
    out = forward(params, cfg, plan, tokens=batch["tokens"],
                  embeds=batch.get("embeds"), frames=batch.get("frames"),
                  remat=remat)
    ce = cross_entropy(out.logits, batch["labels"], batch.get("mask"))
    loss = ce + cfg.router_aux_coef * out.aux
    return loss, {"ce": ce, "aux": out.aux}


def value_and_grad(params, batch, cfg: ModelConfig,
                   plan: ShardingPlan = NULL_PLAN, *, remat: bool = True):
    """((loss, {ce, aux}), grads): grads a tree like ``params``, in each
    leaf's dtype.  The leaves are taken as views that require grad, so the
    caller's tensors need not."""
    paths = flatten_with_paths(params)
    live = [p.detach().requires_grad_() for _, p in paths]
    it = iter(live)
    tree = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        loss, parts = loss_fn(tree, batch, cfg, plan, remat=remat)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for g, p in zip(grads, live))
    parts = {k: v.detach() for k, v in parts.items()}
    return (loss.detach(), parts), tree_map(lambda _: next(it), params)


def train_step(params, opt_state, batch, *, cfg: ModelConfig,
               plan: ShardingPlan = NULL_PLAN,
               opt_cfg: Optional[AdamWConfig] = None, remat: bool = True,
               microbatches: int = 1, accum_dtype=torch.float32):
    """One optimizer step: (params, opt_state, metrics), the parameters and
    moments updated in place (``adamw_update``).

    ``microbatches > 1`` splits the batch into that many slices along its
    first axis and accumulates their gradients in ``accum_dtype`` (each sum
    rounded once from float32), then scales them by 1/M in float32."""
    opt_cfg = opt_cfg or AdamWConfig()
    if microbatches <= 1:
        (loss, parts), grads = value_and_grad(params, batch, cfg, plan,
                                              remat=remat)
    else:
        gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                              device=p.device), params)
        loss = ce = aux = torch.zeros((), dtype=torch.float32,
                                      device=leaves(params)[0].device)
        n = next(iter(batch.values())).shape[0] // microbatches
        for i in range(microbatches):
            mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            (l_i, p_i), g = value_and_grad(params, mb, cfg, plan,
                                           remat=remat)
            for a, b in zip(leaves(gsum), leaves(g)):
                a.copy_(a.float() + b.float())
            del g
            loss, ce, aux = loss + l_i, ce + p_i["ce"], aux + p_i["aux"]
        inv = 1.0 / microbatches
        grads = tree_map(lambda g: g.float().mul_(inv), gsum)
        loss, parts = loss * inv, {"ce": ce * inv, "aux": aux * inv}
    params, opt_state, stats = adamw_update(opt_cfg, grads, opt_state,
                                            params)
    return params, opt_state, {"loss": loss, **parts, **stats}


def make_train_step(cfg: ModelConfig, plan: ShardingPlan = NULL_PLAN,
                    opt_cfg: Optional[AdamWConfig] = None,
                    remat: bool = True, microbatches: int = 1,
                    accum_dtype=torch.float32):
    return functools.partial(train_step, cfg=cfg, plan=plan, opt_cfg=opt_cfg,
                             remat=remat, microbatches=microbatches,
                             accum_dtype=accum_dtype)


__all__ = ["cross_entropy", "loss_fn", "value_and_grad", "train_step",
           "make_train_step"]
