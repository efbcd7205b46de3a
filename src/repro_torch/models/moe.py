"""MoE block — the local (single-device) paths, dropless and capacity.

Two dispatch modes (``ShardingPlan.dispatch_mode`` / the ``dispatch``
argument; "auto" resolves to dropless, the inference default):

  dropless   sort the (token, k) slots by expert into a ragged ``(T*k, h)``
             buffer with an ``offsets`` (E+1,) prefix sum and run the expert
             FFN as a grouped GEMM over the segments.  No capacity, no
             drops: a token's output depends only on its own row and its
             experts, so MoE outputs do not change with batch composition
             (pad rows of the unified step's ``(B, chunk)`` buffer ride
             through too, which is what keeps routing count-independent).
  capacity   fixed ``(E, C, h)`` buffers, ``C = capacity_for(T, k, E, cf)``
             with ``cf = cfg.capacity_factor``; a slot ranked past C within
             its expert is dropped.  C depends on the TOTAL row count (pad
             rows included), so a token's output can change with batch
             composition.  Served only where the user asks for it
             (``ServeSpec(dispatch="capacity")``).

Kernels (``KernelPolicy`` on the plan): ``topk_gate`` runs the router's
softmax + top-k as one kernel, ``moe_gemm`` the three expert GEMMs
(``w_in``, ``w_gate``, ``w_out``: ``grouped_gemm`` when dropless,
``moe_gemm`` on capacity buffers), ``fused_permute`` the gather into expert
order (``permute_tokens``) and the weighted combine (``unpermute_tokens``).
The multi-device EP paths are a later slice (ROADMAP A8).
"""

from __future__ import annotations

import dataclasses
import math
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


# ---------------------------------------------------------------------------
# Capacity dispatch (fixed (E, C, h) buffers)
# ---------------------------------------------------------------------------

def positions_in_expert(flat_e, n_experts: int):
    """Rank of each (token, k) slot within its expert, by a stable sort: a
    slot's rank counts the earlier slots routed to the same expert."""
    n = flat_e.shape[0]
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    ar = torch.arange(n, dtype=torch.int32, device=flat_e.device)
    new_seg = torch.ones(n, dtype=torch.bool, device=flat_e.device)
    new_seg[1:] = sorted_e[1:] != sorted_e[:-1]
    seg_start = torch.cummax(torch.where(new_seg, ar, 0), 0).values
    pos = torch.zeros(n, dtype=torch.int32, device=flat_e.device)
    pos[order] = ar - seg_start
    return pos


def capacity_for(tokens: int, k: int, n_experts: int, cf: float) -> int:
    """Per-expert buffer capacity: ceil(T * k * cf / E), at least 1, and
    rounded up to a multiple of 8 only once past 8 (the reference's rule;
    it decides which slots drop, so it is kept exactly)."""
    c = int(math.ceil(tokens * k * cf / max(n_experts, 1)))
    if c <= 8:
        return max(1, c)
    return -(-c // 8) * 8


@dataclasses.dataclass
class DispatchInfo:
    flat_e: torch.Tensor   # (T*k,) expert id per slot
    pos: torch.Tensor      # (T*k,) clipped position within expert buffer
    keep: torch.Tensor     # (T*k,) bool, False => dropped (over capacity)
    weights: torch.Tensor  # (T*k,)
    capacity: int


def make_dispatch(idx, weights, n_experts: int, capacity: int) \
        -> DispatchInfo:
    flat_e = idx.reshape(-1)
    pos = positions_in_expert(flat_e, n_experts)
    return DispatchInfo(flat_e=flat_e, pos=pos.clamp_max(capacity - 1),
                        keep=pos < capacity, weights=weights.reshape(-1),
                        capacity=capacity)


def dispatch_src_tok(d: DispatchInfo, n_experts: int, t: int):
    """(E*C,) int32: the source token of flat buffer cell (e, c), or -1.

    Kept slots occupy distinct cells, so a plain indexed write inverts the
    map exactly.  Every dropped slot is parked on one extra cell, which is
    sliced off: which of them wins that write does not matter."""
    k = d.flat_e.shape[0] // t
    cells = d.flat_e.long() * d.capacity + d.pos.long()
    cells = torch.where(d.keep, cells, n_experts * d.capacity)
    inv = torch.full((n_experts * d.capacity + 1,), -1, dtype=torch.int32,
                     device=cells.device)
    inv[cells] = torch.div(torch.arange(d.flat_e.shape[0], dtype=torch.int32,
                                        device=cells.device),
                           k, rounding_mode="floor")
    return inv[:-1]


def dispatch_src_slot(d: DispatchInfo, t: int):
    """(T, k) int32 flat buffer cell of each token's slots (-1 = dropped),
    and the matching (T, k) weights."""
    k = d.flat_e.shape[0] // t
    cell = d.flat_e.long() * d.capacity + d.pos.long()
    cell = torch.where(d.keep, cell, -1).reshape(t, k).to(torch.int32)
    return cell, d.weights.reshape(t, k)


def scatter_to_buffers(x, d: DispatchInfo, n_experts: int,
                       use_kernel: bool = False):
    """x (T, h) -> (E, C, h) capacity buffers; dropped slots contribute 0.

    ``use_kernel=True`` is one gather through the permute kernel over the
    int32 inverse map, instead of the (T*k, h) repeat and scatter-add."""
    t, h = x.shape
    if use_kernel:
        src = dispatch_src_tok(d, n_experts, t)
        return gather_rows(x, src, use_kernel=True) \
            .reshape(n_experts, d.capacity, h)
    k = d.flat_e.shape[0] // t
    vals = x.repeat_interleave(k, 0) * d.keep[:, None].to(x.dtype)
    buf = torch.zeros(n_experts, d.capacity, h, dtype=x.dtype,
                      device=x.device)
    # dropped slots add their zero row onto a clipped (real) cell
    return buf.index_put_((d.flat_e.long(), d.pos.long()), vals,
                          accumulate=True)


def gather_from_buffers(buf, d: DispatchInfo, t: int,
                        use_kernel: bool = False):
    """buf (E, C, h) -> (T, h) weighted combine.  The plain body sums in the
    buffer's dtype; the unpermute kernel accumulates in float32 and rounds
    once."""
    if use_kernel:
        slot, w = dispatch_src_slot(d, t)
        return combine_rows(buf.reshape(-1, buf.shape[-1]), slot, w,
                            use_kernel=True)
    vals = buf[d.flat_e.long(), d.pos.long()]
    vals = vals * (d.weights * d.keep.to(d.weights.dtype))[:, None]
    k = d.flat_e.shape[0] // t
    return vals.reshape(t, k, -1).sum(1)


# ---------------------------------------------------------------------------
# Dropless (ragged, count-independent) dispatch
# ---------------------------------------------------------------------------

def resolve_dispatch(mode: Optional[str]) -> str:
    """"auto"/None -> "dropless" (the inference default); validates the
    others."""
    if mode in (None, "auto"):
        return "dropless"
    if mode not in ("capacity", "dropless"):
        raise ValueError(f"unknown dispatch mode {mode!r} "
                         "(want 'auto' | 'capacity' | 'dropless')")
    return mode


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


def expert_ffn(p, buf, cfg: ModelConfig, use_kernel: bool = False):
    """Expert FFN on capacity buffers.  buf (E, C, h) -> (E, C, h).

    ``use_kernel=True`` runs the three GEMMs through the ``moe_gemm``
    kernel; the plain body is an einsum in the buffer's dtype."""
    if use_kernel:
        from repro_torch.kernels import ops as _kops
        mm = _kops.moe_gemm
    else:
        def mm(a, b):
            return torch.einsum("ech,ehd->ecd", a, b)
    up = mm(buf, p["w_in"])
    if "w_gate" in p:
        mid = activate(mm(buf, p["w_gate"]), up, cfg.activation)
    else:
        mid = activate(up, up, cfg.activation)
    return mm(mid, p["w_out"])


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

def moe_local(p, x, cfg: ModelConfig,
              policy: Optional[KernelPolicy] = None,
              dispatch: Optional[str] = None, with_stats: bool = False):
    """x: (b, s, h).  Returns (out, aux_loss)
    [+ per-expert routed counts (E,) int32, before any drop, when
    ``with_stats``].  ``dispatch`` ("auto" -> dropless) picks the buffer
    scheme; capacity mode sizes its buffers by ``cfg.capacity_factor``
    (0.0 is a real, degenerate factor: C = 1)."""
    policy = NULL_POLICY if policy is None else policy
    dispatch = resolve_dispatch(dispatch)
    b, s, h = x.shape
    tok = rms_norm(x, p["norm"], cfg.norm_eps).reshape(-1, h)
    t, k = tok.shape[0], cfg.top_k
    idx, w, aux = route_topk(tok @ p["router"], k,
                             use_kernel=policy.topk_gate)
    if dispatch == "dropless":
        dl = make_dropless(idx, w, cfg.n_experts)
        xs = gather_rows(tok, torch.div(dl.order, k, rounding_mode="floor"),
                         use_kernel=policy.fused_permute)  # (T*k, h) sorted
        ys = grouped_ffn(p, xs, dl.offsets, cfg, use_kernel=policy.moe_gemm)
        out = combine_rows(ys, dl.inv.reshape(t, k), w.reshape(t, k),
                           use_kernel=policy.fused_permute)
        counts = dl.counts
    else:
        cap = capacity_for(t, k, cfg.n_experts, cfg.capacity_factor)
        d = make_dispatch(idx, w, cfg.n_experts, cap)
        buf = scatter_to_buffers(tok, d, cfg.n_experts,
                                 use_kernel=policy.fused_permute)
        out_buf = expert_ffn(p, buf, cfg, use_kernel=policy.moe_gemm)
        out = gather_from_buffers(out_buf, d, t,
                                  use_kernel=policy.fused_permute)
        counts = torch.bincount(idx.reshape(-1).long(),
                                minlength=cfg.n_experts).to(torch.int32) \
            if with_stats else None
    if cfg.n_shared_experts:
        out = out + shared_expert_ffn(p, tok, cfg)
    out = out.reshape(b, s, h).to(x.dtype)
    if with_stats:
        return out, aux, counts
    return out, aux


def moe_block(p, x, cfg: ModelConfig, plan: ShardingPlan = NULL_PLAN, *,
              dispatch: Optional[str] = None, with_stats: bool = False):
    """The MoE block on one device.  x: (b, s, h) -> (out, aux_loss)
    [+ per-expert routed counts (E,) int32 when ``with_stats``].
    ``dispatch`` overrides ``plan.dispatch_mode``."""
    mode = dispatch if dispatch is not None \
        else getattr(plan, "dispatch_mode", None)
    if plan.enabled:
        raise NotImplementedError(
            "multi-device MoE is not ported yet (ROADMAP A8)")
    return moe_local(p, x, cfg, policy=plan.kernels, dispatch=mode,
                     with_stats=with_stats)


__all__ = ["moe_spec", "moe_block", "moe_local", "route_topk",
           "make_dispatch", "scatter_to_buffers", "gather_from_buffers",
           "expert_ffn", "capacity_for", "positions_in_expert",
           "DispatchInfo", "dispatch_src_tok", "dispatch_src_slot",
           "resolve_dispatch", "DroplessInfo", "make_dropless", "gather_rows",
           "combine_rows", "grouped_ffn", "shared_expert_ffn"]
