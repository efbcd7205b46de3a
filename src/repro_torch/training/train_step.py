"""The training step: cross-entropy (+ the MoE router's aux loss), its
gradients by autograd, and an AdamW step, on one device or on a mesh.

The step runs the stateless forward with the plan's kernel policy; the
hand-written kernels have no backward (nor have the reference's), so a plan
with kernels on raises at the first kernel the forward reaches
(``kernels.ops``).  ``remat=True`` recomputes each layer in the backward
instead of keeping its activations (``forward(remat=)``).

On a mesh (``plan.enabled``) every rank is handed the whole batch; the
forward takes the rank's rows (``plan.rows``) and returns its block of the
logits (its rows, its vocab columns), and the loss is vocab-parallel
(``sharded_cross_entropy``), so every rank computes the same loss, the
whole batch's mean cross-entropy, plus the coefficient times the mesh's
router aux (the mean of every rank's, ``models.moe``), and no rank holds
the whole logits.  Each rank's gradients are those of its
stored blocks after ``core.collectives``' reductions, the same blocks of
the single-device step's.  The batch axes must divide the batch, and
``microbatches`` the rank's rows: microbatch i holds the batch's i-th
contiguous slice, its rows split over the batch ranks, as on one device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives as C
from repro_torch.core.partitioner import NULL_PLAN, ShardingPlan
from repro_torch.models.model import forward
from repro_torch.training.optimizer import AdamWConfig, adamw_update
from repro_torch.training.tree import (leaf_decls, leaves, store_specs,
                                       tree_map)


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


def sharded_cross_entropy(logits, labels, plan: ShardingPlan, mask=None):
    """``cross_entropy`` of the whole batch from this rank's block of the
    logits: ``logits`` (b_loc, s, v_loc) its rows (``plan.rows``) and
    vocab columns, ``labels`` (and ``mask``) of the whole batch.  The
    log-sum-exp and the gold logit are summed over the TP axes (each
    rank's block against the max over them, which carries no gradient),
    the negative log likelihood over the batch axes; every rank gets the
    same loss and, through the sums' ``grad="whole"`` backward, the
    gradient of its own block.  float32 throughout."""
    mesh, b = plan.mesh, labels.shape[0]
    rows = plan.rows(b)
    labels = labels[rows]
    logits = logits.float()
    v_loc = logits.shape[-1]
    top = logits.amax(-1, keepdim=True).detach()
    v0 = 0
    if plan.tp > 1:
        top = C.pmax(top, mesh, plan.tp_axes)
        v0 = C.axis_index(mesh, plan.tp_axes) * v_loc
    sumexp = torch.exp(logits - top).sum(-1)
    onehot = labels[..., None] == torch.arange(v0, v0 + v_loc,
                                               device=logits.device)
    gold = torch.sum(torch.where(onehot, logits, 0.0), dim=-1)
    if plan.tp > 1:
        sumexp = C.psum(sumexp, mesh, plan.tp_axes)
        gold = C.psum(gold, mesh, plan.tp_axes)
    nll = top[..., 0] + torch.log(sumexp) - gold
    if mask is not None:
        mask = mask[rows]
        num, den = (nll * mask).sum(), mask.sum()
    else:
        num = nll.sum()
        den = torch.tensor(float(b * nll.shape[1]), device=nll.device)
    if plan.batch_sharded(b):
        num = C.psum(num, mesh, plan.dp_axes)
        if mask is not None:
            den = C.psum(den, mesh, plan.dp_axes)
    return num / torch.clamp(den, min=1.0)


def loss_fn(params, batch, cfg: ModelConfig, plan: ShardingPlan = NULL_PLAN,
            *, remat: bool = True):
    """batch: {tokens, labels[, mask, embeds, frames]} -> (loss, {ce, aux}).

    Training pins the MoE capacity dispatch, as the reference does: a plan
    whose ``dispatch_mode`` is "auto" (dropless when serving) trains on the
    fixed (E, C, h) buffers; an explicit "dropless" is honoured, on a mesh
    too."""
    if plan.dispatch_mode == "auto":
        plan = dataclasses.replace(plan, dispatch_mode="capacity")
    out = forward(params, cfg, plan, tokens=batch["tokens"],
                  embeds=batch.get("embeds"), frames=batch.get("frames"),
                  remat=remat, local_logits=plan.enabled)
    if plan.enabled:
        ce = sharded_cross_entropy(
            out.logits, batch["labels"],
            plan.for_batch(batch["labels"].shape[0]), batch.get("mask"))
    else:
        ce = cross_entropy(out.logits, batch["labels"], batch.get("mask"))
    loss = ce + cfg.router_aux_coef * out.aux
    return loss, {"ce": ce, "aux": out.aux}


def _seq_len(batch) -> int:
    """The rows of the residual stream: the vlm patch stub, then the
    tokens."""
    emb = batch.get("embeds")
    return batch["tokens"].shape[1] + (0 if emb is None else emb.shape[1])


def reduce_grads(grads: list, decls: list, specs: list, cfg: ModelConfig,
                 plan: ShardingPlan, seq_sharded: bool) -> list:
    """Each leaf's gradient summed over ``plan.grad_sum_axes`` (``decls``:
    each leaf's ``models.param.P``, ``specs``: its ``store_spec``): one
    all_reduce per distinct tuple of axes and dtype, in flatten order."""
    groups: dict = {}
    for i, (decl, spec) in enumerate(zip(decls, specs)):
        axes = plan.grad_sum_axes(cfg, decl, spec, seq_sharded)
        if axes:
            groups.setdefault((axes, grads[i].dtype), []).append(i)
    out = list(grads)
    for (axes, _), idx in groups.items():
        for i, g in zip(idx, C.psum_grads([grads[i] for i in idx],
                                          plan.mesh, axes)):
            out[i] = g
    return out


def _local_grads(params, batch, cfg: ModelConfig, plan: ShardingPlan,
                 remat: bool):
    """((loss, {ce, aux}), [grad]): this rank's gradient of each leaf, in
    flatten order, before the reductions after the backward."""
    live = [p.detach().requires_grad_() for p in leaves(params)]
    it = iter(live)
    tree = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        loss, parts = loss_fn(tree, batch, cfg, plan, remat=remat)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, live)]
    parts = {k: v.detach() for k, v in parts.items()}
    return (loss.detach(), parts), grads


def _reduce(grads: list, params, batch, cfg: ModelConfig,
            plan: ShardingPlan) -> list:
    if not plan.enabled:
        return grads
    return reduce_grads(grads, leaf_decls(cfg, params),
                        store_specs(cfg, plan, params), cfg, plan,
                        plan.seq_sharded(_seq_len(batch)))


def value_and_grad(params, batch, cfg: ModelConfig,
                   plan: ShardingPlan = NULL_PLAN, *, remat: bool = True):
    """((loss, {ce, aux}), grads): grads a tree like ``params``, in each
    leaf's dtype.  The leaves are taken as views that require grad, so the
    caller's tensors need not.  On a mesh ``params`` are the rank's blocks
    and so are the grads, reduced over the ranks that share a block
    (``reduce_grads``)."""
    out, grads = _local_grads(params, batch, cfg, plan, remat)
    it = iter(_reduce(grads, params, batch, cfg, plan))
    return out, tree_map(lambda _: next(it), params)


def check_microbatches(b: int, microbatches: int,
                       plan: ShardingPlan = NULL_PLAN) -> int:
    """The rows of one microbatch: refuses (before any forward) a batch
    the batch axes do not divide, or rows per rank that ``microbatches``
    does not divide, as the reference's reshape does (on a mesh each
    microbatch's rows split over the batch ranks)."""
    if plan.enabled and plan.dp > 1 and b % plan.dp:
        raise ValueError(f"a batch of {b} rows does not split over the "
                         f"{plan.dp} batch ranks")
    rows = b // plan.dp if plan.enabled else b
    microbatches = max(microbatches, 1)
    if rows % microbatches:
        where = f"{rows} rows a batch rank" if plan.enabled and plan.dp > 1 \
            else f"a batch of {rows} rows"
        raise ValueError(f"microbatches={microbatches} does not divide "
                         f"{where}")
    return b // microbatches


def train_step(params, opt_state, batch, *, cfg: ModelConfig,
               plan: ShardingPlan = NULL_PLAN,
               opt_cfg: Optional[AdamWConfig] = None, remat: bool = True,
               microbatches: int = 1, accum_dtype=torch.float32):
    """One optimizer step: (params, opt_state, metrics), the parameters and
    moments updated in place (``adamw_update``).

    ``microbatches > 1`` splits the batch into that many contiguous slices
    along its first axis (on a mesh, each slice's rows split over the
    batch ranks, as the reference's reshape does) and accumulates their
    gradients in ``accum_dtype`` (each sum rounded once from float32),
    then scales them by 1/M in float32 and reduces them over the ranks
    once.  A batch (on a mesh: the rank's rows) that ``microbatches``
    does not divide raises ``ValueError`` before any forward."""
    opt_cfg = opt_cfg or AdamWConfig()
    n = check_microbatches(next(iter(batch.values())).shape[0],
                           microbatches, plan)
    if microbatches <= 1:
        (loss, parts), grads = value_and_grad(params, batch, cfg, plan,
                                              remat=remat)
    else:
        gsum = [torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
                for p in leaves(params)]
        loss = ce = aux = torch.zeros((), dtype=torch.float32,
                                      device=gsum[0].device)
        for i in range(microbatches):
            mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            (l_i, p_i), g = _local_grads(params, mb, cfg, plan, remat)
            for a, b in zip(gsum, g):
                a.copy_(a.float() + b.float())
            del g
            loss, ce, aux = loss + l_i, ce + p_i["ce"], aux + p_i["aux"]
        inv = 1.0 / microbatches
        it = iter(_reduce([g.float().mul_(inv) for g in gsum], params,
                          batch, cfg, plan))
        grads = tree_map(lambda _: next(it), params)
        loss, parts = loss * inv, {"ce": ce * inv, "aux": aux * inv}
    cuts = None
    if plan.enabled:
        cuts = [tuple(a for m in spec if m is not None for a in m)
                for spec in store_specs(cfg, plan, params)]
    params, opt_state, stats = adamw_update(opt_cfg, grads, opt_state,
                                            params, cuts=cuts,
                                            mesh=plan.mesh)
    return params, opt_state, {"loss": loss, **parts, **stats}


def make_train_step(cfg: ModelConfig, plan: ShardingPlan = NULL_PLAN,
                    opt_cfg: Optional[AdamWConfig] = None,
                    remat: bool = True, microbatches: int = 1,
                    accum_dtype=torch.float32):
    return functools.partial(train_step, cfg=cfg, plan=plan, opt_cfg=opt_cfg,
                             remat=remat, microbatches=microbatches,
                             accum_dtype=accum_dtype)


__all__ = ["cross_entropy", "sharded_cross_entropy", "loss_fn",
           "value_and_grad", "reduce_grads", "check_microbatches",
           "train_step", "make_train_step"]
