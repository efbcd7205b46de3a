"""MoE block — the local (single-device) dropless path.

Dropless dispatch sorts the (token, k) slots by expert into a ragged
``(T*k, h)`` buffer with an ``offsets`` (E+1,) prefix sum and runs the
expert FFN as a grouped GEMM over the segments.  No capacity, no drops: a
token's output depends only on its own row and its experts, so MoE outputs
do not change with batch composition (pad rows of the unified step's
``(B, chunk)`` buffer ride through too, which is what keeps routing
count-independent).

Kernels (``KernelPolicy`` on the plan): ``topk_gate`` runs the router's
softmax + top-k as one kernel, ``moe_gemm`` the three grouped GEMMs
(``w_in``, ``w_gate``, ``w_out``), ``fused_permute`` the gather into expert
order (``permute_tokens``) and the weighted combine (``unpermute_tokens``).
Capacity dispatch and the multi-device EP paths are later slices (ROADMAP
A8, A9).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.partitioner import NULL_PLAN, ShardingPlan
from repro_torch.kernels import ref as _kref
from repro_torch.kernels.policy import NULL_POLICY, KernelPolicy
from repro_torch.models.layers import activate, rms_norm
from repro_torch.models.param import P


# ---------------------------------------------------------------------------
# Spec
# ---------------------------------------------------------------------------

def moe_spec(cfg: ModelConfig) -> dict:
    h, e, de = cfg.d_model, cfg.n_experts, cfg.d_expert
    gated = cfg.activation in ("swiglu", "geglu")
    spec = {
        "norm": P((h,), ("embed",), init="zeros"),
        "router": P((h, e), ("embed", None), scale=0.02),
        "w_in": P((e, h, de), ("expert", "embed", "expert_ffn")),
        "w_out": P((e, de, h), ("expert", "expert_ffn", "embed")),
    }
    if gated:
        spec["w_gate"] = P((e, h, de), ("expert", "embed", "expert_ffn"))
    if cfg.n_shared_experts:
        ds = cfg.d_expert * cfg.n_shared_experts
        spec["shared_in"] = P((h, ds), ("embed", "ffn"))
        spec["shared_out"] = P((ds, h), ("ffn", "embed"))
        if gated:
            spec["shared_gate"] = P((h, ds), ("embed", "ffn"))
    return spec


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

def route_topk(logits, k: int, renorm: bool = True,
               use_kernel: bool = False):
    """logits: (T, E) -> (idx (T,k), weights (T,k), aux_loss scalar).

    ``use_kernel=True`` routes through the fused softmax + top-k kernel.
    Both paths pick ties by the lowest expert id and cast the weights to
    the logits' dtype."""
    probs = torch.softmax(logits.float(), dim=-1)
    if use_kernel:
        from repro_torch.kernels import ops as _kops
        top_p, top_i = _kops.topk_gate(logits, k, renorm=renorm)
    else:
        top_p, top_i = _kref.top_k_first(probs, k)
        if renorm:
            top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    top_p = top_p.to(logits.dtype)
    # Switch-Transformer load-balance loss: E * sum_e f_e * P_e
    e = logits.shape[-1]
    f = torch.zeros(e, dtype=torch.float32, device=logits.device)
    f.index_add_(0, top_i.reshape(-1).long(),
                 torch.ones(top_i.numel(), device=logits.device))
    f = f / max(top_i.numel(), 1)
    aux = e * torch.sum(f * probs.mean(0))
    return top_i, top_p, aux


def resolve_dispatch(mode: Optional[str]) -> str:
    """"auto"/None -> "dropless"; "capacity" is not ported yet."""
    if mode in (None, "auto", "dropless"):
        return "dropless"
    if mode == "capacity":
        raise NotImplementedError(
            "capacity dispatch is not ported yet (ROADMAP A9)")
    raise ValueError(f"unknown dispatch mode {mode!r} "
                     "(want 'auto' | 'capacity' | 'dropless')")


@dataclasses.dataclass
class DroplessInfo:
    """Sorted-slot dispatch."""
    order: torch.Tensor    # (T*k,) slot id of sorted row i (by expert, stable)
    inv: torch.Tensor      # (T*k,) sorted row of slot f (inverse of order)
    counts: torch.Tensor   # (E,) tokens routed to each expert
    offsets: torch.Tensor  # (E+1,) prefix-sum: expert e owns rows [e, e+1)
    weights: torch.Tensor  # (T*k,) routing weights per slot


def make_dropless(idx, weights, n_experts: int) -> DroplessInfo:
    flat_e = idx.reshape(-1)
    n = flat_e.shape[0]
    order = torch.sort(flat_e, stable=True).indices.to(torch.int32)
    counts = torch.bincount(flat_e.long(), minlength=n_experts) \
        .to(torch.int32)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int32,
                                     device=idx.device),
                         torch.cumsum(counts, 0).to(torch.int32)])
    inv = torch.empty(n, dtype=torch.int32, device=idx.device)
    inv[order.long()] = torch.arange(n, dtype=torch.int32, device=idx.device)
    return DroplessInfo(order=order, inv=inv, counts=counts, offsets=offsets,
                        weights=weights.reshape(-1))


def gather_rows(x, src, use_kernel: bool = False):
    """x (M, h), src (N,) int32 -> (N, h); src < 0 yields a 0 row."""
    if use_kernel:
        from repro_torch.kernels import ops as _kops
        return _kops.permute_tokens(x, src)
    return _kref.permute_tokens_ref(x, src)


def combine_rows(buf, src_slot, weights, use_kernel: bool = False):
    """buf (M, h), src_slot (T, k), weights (T, k) -> (T, h) weighted sum,
    accumulated in float32."""
    if use_kernel:
        from repro_torch.kernels import ops as _kops
        return _kops.unpermute_tokens(buf, src_slot, weights)
    return _kref.unpermute_tokens_ref(buf, src_slot, weights)


def grouped_ffn(p, xs, offsets, cfg: ModelConfig, use_kernel: bool = False):
    """Expert FFN over a ragged buffer.  xs (N, h) sorted by expert,
    offsets (E+1,) -> (N, h)."""
    if use_kernel:
        from repro_torch.kernels import ops as _kops
        gg = _kops.grouped_gemm
    else:
        gg = _kref.grouped_gemm_ref
    up = gg(xs, p["w_in"], offsets)
    if "w_gate" in p:
        mid = activate(gg(xs, p["w_gate"], offsets), up, cfg.activation)
    else:
        mid = activate(up, up, cfg.activation)
    return gg(mid, p["w_out"], offsets)


def shared_expert_ffn(p, x, cfg: ModelConfig):
    """Shared experts on every token."""
    up = x @ p["shared_in"]
    if "shared_gate" in p:
        mid = activate(x @ p["shared_gate"], up, cfg.activation)
    else:
        mid = activate(up, up, cfg.activation)
    return mid @ p["shared_out"]


# ---------------------------------------------------------------------------
# Local (single-device) block
# ---------------------------------------------------------------------------

def moe_local(p, x, cfg: ModelConfig, policy: Optional[KernelPolicy] = None,
              dispatch: Optional[str] = None, with_stats: bool = False):
    """x: (b, s, h).  Returns (out, aux_loss)
    [+ per-expert routed counts (E,) int32 when ``with_stats``]."""
    policy = NULL_POLICY if policy is None else policy
    resolve_dispatch(dispatch)
    b, s, h = x.shape
    tok = rms_norm(x, p["norm"], cfg.norm_eps).reshape(-1, h)
    t, k = tok.shape[0], cfg.top_k
    idx, w, aux = route_topk(tok @ p["router"], k,
                             use_kernel=policy.topk_gate)
    dl = make_dropless(idx, w, cfg.n_experts)
    xs = gather_rows(tok, torch.div(dl.order, k, rounding_mode="floor"),
                     use_kernel=policy.fused_permute)      # (T*k, h) sorted
    ys = grouped_ffn(p, xs, dl.offsets, cfg, use_kernel=policy.moe_gemm)
    out = combine_rows(ys, dl.inv.reshape(t, k), w.reshape(t, k),
                       use_kernel=policy.fused_permute)
    if cfg.n_shared_experts:
        out = out + shared_expert_ffn(p, tok, cfg)
    out = out.reshape(b, s, h).to(x.dtype)
    if with_stats:
        return out, aux, dl.counts
    return out, aux


def moe_block(p, x, cfg: ModelConfig, plan: ShardingPlan = NULL_PLAN, *,
              dispatch: Optional[str] = None, with_stats: bool = False):
    """The MoE block on one device.  x: (b, s, h) -> (out, aux_loss)
    [+ per-expert routed counts (E,) int32 when ``with_stats``]."""
    mode = dispatch if dispatch is not None \
        else getattr(plan, "dispatch_mode", None)
    if plan.enabled:
        raise NotImplementedError(
            "multi-device MoE is not ported yet (ROADMAP A8)")
    return moe_local(p, x, cfg, policy=plan.kernels, dispatch=mode,
                     with_stats=with_stats)


__all__ = ["moe_spec", "moe_block", "moe_local", "route_topk",
           "resolve_dispatch", "DroplessInfo", "make_dropless", "gather_rows",
           "combine_rows", "grouped_ffn", "shared_expert_ffn"]
