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
order (``permute_tokens``; ``permute_tokens_ragged`` on the EP exchange's
segmented buffers) and the weighted combine (``unpermute_tokens``).

With a mesh (``plan.enabled``) the block runs MixServe's layouts SPMD, one
process per rank, as the reference's ``shard_map`` body does
(``core.collectives`` stands in for ``jax.lax``):

  mixserve   experts over the EP axis ("data"), the expert FFN over the TP
             axis ("model").  comm_algo "fused"/"sync": the paper's
             RS-A2A-AG, the A2A carries 1/tp-wide hidden states;
             "unfused": full-width A2A plus an all-reduce
  dp_ep      experts over data x model, tokens sliced over "model"
  pure_tp    every rank holds all experts, TP-sharded; all-reduce only

The model's forward calls ``moe_rank`` on its rank's batch rows (and its
seq block of the residual stream, gathered along seq on entry and cut back
on exit); ``moe_block`` is the whole-batch wrapper: it slices the batch
over the plan's batch axes, runs ``moe_rank`` and all-gathers the batch
back.  Every rank holds only its slice of the expert weights.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives as C
from repro_torch.core.cost_model import EP_OVERLAP_OFF, EpOverlap, cap_rows_for
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
        "norm": P((h,), ("embed",), init="zeros", tp_share="tp"),
        "router": P((h, e), ("embed", None), scale=0.02, tp_share="tp"),
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


def expert_counts(idx, n_experts: int):
    """(E,) int32 slots routed to each expert, from expert ids ``idx`` of
    any shape: a scatter-add of ones over zeros, the integers
    ``torch.bincount`` gives, and it runs on the meta device too (bincount
    has no meta kernel)."""
    flat = idx.reshape(-1).long()
    counts = torch.zeros(n_experts, dtype=torch.int32, device=idx.device)
    return counts.scatter_add_(0, flat, torch.ones(flat.shape,
                                                   dtype=torch.int32,
                                                   device=idx.device))


def make_dropless(idx, weights, n_experts: int) -> DroplessInfo:
    flat_e = idx.reshape(-1)
    n = flat_e.shape[0]
    order = torch.sort(flat_e, stable=True).indices.to(torch.int32)
    counts = expert_counts(flat_e, n_experts)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int32,
                                     device=idx.device),
                         torch.cumsum(counts, 0).to(torch.int32)])
    inv = torch.empty(n, dtype=torch.int32, device=idx.device)
    inv[order.long()] = torch.arange(n, dtype=torch.int32, device=idx.device)
    return DroplessInfo(order=order, inv=inv, counts=counts, offsets=offsets,
                        weights=weights.reshape(-1))


def gather_rows(x, src, use_kernel: bool = False, total=None,
                seg_stride: Optional[int] = None):
    """x (M, h), src (N,) int32 -> (N, h); src < 0 yields a 0 row.

    ``total`` (int32 on the device): valid-prefix row counts, a () scalar
    over the whole buffer or a (n_seg,) vector of segments ``seg_stride``
    rows apart (the EP send layout).  With the kernel on it routes to the
    segment-aware ragged permute, which skips empty tiles; validity still
    rides in ``src`` (-1 outside the prefixes)."""
    if use_kernel:
        from repro_torch.kernels import ops as _kops
        if total is not None:
            return _kops.permute_tokens_ragged(x, src, total,
                                               seg_stride=seg_stride)
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
        counts = expert_counts(idx, cfg.n_experts) if with_stats else None
    if cfg.n_shared_experts:
        out = out + shared_expert_ffn(p, tok, cfg)
    out = out.reshape(b, s, h).to(x.dtype)
    if with_stats:
        return out, aux, counts
    return out, aux


# ---------------------------------------------------------------------------
# Distributed paths (one process per rank)
# ---------------------------------------------------------------------------

# EP-exchange chunks run by the dropless body in this process, and how many
# of them overflowed their row cap and ran again at the worst-case extent
# (each run launches the exchange's kernels once more).
exchange_counts: collections.Counter = collections.Counter()


def _in_mesh_order(mesh, axes) -> tuple:
    axes = set(axes)
    return tuple(a for a in mesh.axis_names if a in axes)


def _routed_counts_stat(idx, e_global: int, mesh, mesh_axes: tuple,
                        tp_axes: tuple, token_sliced: bool):
    """(E,) int32 global routed-slot counts, replicated.  Tokens are
    sharded over the non-TP mesh axes (and over TP too when token-sliced);
    sum those partials, keep the TP replication."""
    c = expert_counts(idx, e_global)
    cnt_axes = [a for a in mesh_axes if a not in tp_axes]
    if token_sliced:
        cnt_axes += [a for a in tp_axes if a not in cnt_axes]
    if cnt_axes:
        c = C.psum(c, mesh, _in_mesh_order(mesh, cnt_axes))
    return c


def _local_tokens(x, p, cfg, mesh, tp_axes, tp, token_sliced):
    """(tok_full, tok): the normed tokens, and this rank's token slice
    (dp_ep slices the TP group's replicated tokens along the token axis,
    padded to a multiple of tp)."""
    h = x.shape[-1]
    tok_full = rms_norm(x, p["norm"], cfg.norm_eps).reshape(-1, h)
    if not (token_sliced and tp > 1):
        return tok_full, tok_full
    pad = (-tok_full.shape[0]) % tp
    if pad:
        tok_full = torch.cat([tok_full, tok_full.new_zeros(pad, h)])
    t_loc = tok_full.shape[0] // tp
    i = C.axis_index(mesh, tp_axes)
    return tok_full, tok_full[i * t_loc:(i + 1) * t_loc]


def _tp_shard(t, mesh, tp_axes, tp):
    """This rank's 1/tp column block of t (the fused path's payload)."""
    hs = t.shape[-1] // tp
    j = C.axis_index(mesh, tp_axes)
    return t[:, j * hs:(j + 1) * hs].contiguous()


def _finish(out_tok, x, aux, idx, *, cfg, mesh, mesh_axes, tp_axes,
            token_sliced, with_stats):
    out = out_tok.reshape(x.shape).to(x.dtype)
    if mesh_axes:
        aux = C.pmean(aux, mesh, mesh_axes)   # replicated, like P()
    if with_stats:
        return out, aux, _routed_counts_stat(idx, cfg.n_experts, mesh,
                                             mesh_axes, tp_axes, token_sliced)
    return out, aux


def _shared_epilogue(out_tok, p, tok_full, tok, cfg, mesh, tp_axes, tp,
                     token_sliced, fused):
    """Add the shared experts.  Fused: RS the TP partials to 1/tp width
    and add before the single epilogue AG; otherwise psum them (computed
    on the whole replicated token set when token-sliced)."""
    if fused:
        if cfg.n_shared_experts:
            sp = shared_expert_ffn(p, tok, cfg)
            out_tok = out_tok + C.psum_scatter(sp, mesh, tp_axes,
                                               scatter_dimension=1)
        return C.all_gather(out_tok, mesh, tp_axes, axis=-1, grad="whole")
    if cfg.n_shared_experts:
        sp = shared_expert_ffn(p, tok_full if token_sliced else tok, cfg)
        if tp > 1:             # shared FFN weights are TP-sharded partials
            sp = C.psum(sp, mesh, tp_axes)
        out_tok = out_tok + sp[:out_tok.shape[0]]
    return out_tok


def _moe_shard_fn(p, x, *, cfg: ModelConfig, mesh, tp_axes, ep_axes,
                  comm_algo, token_sliced: bool, mesh_axes: tuple,
                  policy: KernelPolicy = NULL_POLICY,
                  with_stats: bool = False):
    """Per-rank capacity body.  x (b_loc, s, h), replicated across the TP
    axes; ``p`` holds this rank's expert slice.  Returns (out (b_loc, s, h)
    replicated across TP, aux) [+ (E,) counts].  Buffers are
    ``(E, C, h)`` with C from the LOCAL token count and
    ``cfg.capacity_factor``."""
    h = x.shape[-1]
    tp, ep = C.axis_size(mesh, tp_axes), C.axis_size(mesh, ep_axes)
    e_global = cfg.n_experts
    e_local = e_global // ep
    tok_full, tok = _local_tokens(x, p, cfg, mesh, tp_axes, tp, token_sliced)
    t_real, t = x.shape[0] * x.shape[1], tok.shape[0]
    idx, w, aux = route_topk(tok @ p["router"], cfg.top_k,
                             use_kernel=policy.topk_gate)
    fused = comm_algo in ("fused", "sync") and tp > 1 and ep > 1 \
        and not token_sliced
    if tp > 1 and not fused and not token_sliced:
        # the combine below runs on the whole width: every TP rank's
        # gradient of w is whole, but the router's inputs hold theirs in
        # shares (core.collectives)
        w = C.share(w, mesh, tp_axes)
    cap = capacity_for(t, cfg.top_k, e_global, cfg.capacity_factor)
    d = make_dispatch(idx, w, e_global, cap)

    # ---- dispatch: fused scatters only this rank's 1/tp hidden shard, so
    # the A2A moves 1/tp of the volume and an AG restores full width ----
    payload = _tp_shard(tok, mesh, tp_axes, tp) if fused else tok
    buf = scatter_to_buffers(payload, d, e_global,
                             use_kernel=policy.fused_permute)  # (E, C, h')
    buf = buf.reshape(ep, e_local, cap, -1)
    if ep > 1:
        buf = C.all_to_all(buf, mesh, ep_axes)   # dim 0: the source rank
    if fused:
        buf = C.all_gather(buf, mesh, tp_axes, axis=-1)
    # (ep, e_local, C, h) -> (e_local, ep*C, h): one batch per local expert
    comp = buf.transpose(0, 1).reshape(e_local, ep * cap, h).contiguous()
    out_buf = expert_ffn(p, comp, cfg,      # partial over tp when sharded
                         use_kernel=policy.moe_gemm)
    out_buf = out_buf.reshape(e_local, ep, cap, h).transpose(0, 1)

    # ---- combine ----
    if fused:
        # fused RS-Combine: RS the TP partials to 1/tp width, A2A back at
        # 1/tp volume, weighted combine, one epilogue AG (in the shared
        # epilogue below)
        out_buf = C.psum_scatter(out_buf, mesh, tp_axes,
                                 scatter_dimension=3)   # (ep, eL, C, h/tp)
        out_buf = C.all_to_all(out_buf, mesh, ep_axes)
    else:
        if tp > 1 and not token_sliced:
            out_buf = C.psum(out_buf, mesh, tp_axes)   # AR (unfused)
        if ep > 1:
            out_buf = C.all_to_all(out_buf.contiguous(), mesh, ep_axes)
    out_buf = out_buf.reshape(e_global, cap, -1)
    out_tok = gather_from_buffers(out_buf, d, t,
                                  use_kernel=policy.fused_permute)
    if token_sliced and tp > 1:     # undo the token slice, drop its pad
        out_tok = C.all_gather(out_tok, mesh, tp_axes, axis=0,
                               grad="whole")[:t_real]
    out_tok = _shared_epilogue(out_tok, p, tok_full, tok, cfg, mesh,
                               tp_axes, tp, token_sliced, fused)
    return _finish(out_tok, x, aux, idx, cfg=cfg, mesh=mesh,
                   mesh_axes=mesh_axes, tp_axes=tp_axes,
                   token_sliced=token_sliced, with_stats=with_stats)


def _i32(t):
    return t.to(torch.int32)


def _moe_shard_dropless_fn(p, x, *, cfg: ModelConfig, mesh, tp_axes,
                           ep_axes, comm_algo, token_sliced: bool,
                           mesh_axes: tuple,
                           policy: KernelPolicy = NULL_POLICY,
                           ep_overlap: Optional[EpOverlap] = None,
                           with_stats: bool = False):
    """Per-rank dropless body.  x (b_loc, s, h), replicated across the TP
    axes.  Returns (out (b_loc, s, h), aux) [+ (E,) counts].

    The EP exchange runs without capacity padding: ranks first exchange
    their per-expert slot counts (an (ep, e_local) int32 A2A), then ragged
    token buffers.  The fused path keeps the paper's order: the dispatch
    A2A on 1/tp-wide rows, an AG to full width before the expert GEMMs, an
    RS back to 1/tp before the return A2A and one epilogue AG.

    ``ep_overlap`` picks the schedule; values never change:

    * ``None`` / ``EP_OVERLAP_OFF``: one exchange at the worst-case extent
      ``S = t*k`` rows per destination.
    * otherwise C micro-chunks (``C = gcd(chunks, t)``).  Every chunk's
      counts and dispatch A2As are issued (``async_op``) before any chunk's
      expert GEMM, so chunk i's dispatch can ride the wire under chunk
      i-1's compute; the fused AG, which consumes the A2A's rows, is issued
      when its chunk starts.  Each exchange is count-bounded at
      ``S = cap_rows_for(...)`` rows per destination; when any (source,
      destination) segment of the collective group overflows S (a pmax over
      the EP and TP axes, so every rank takes the same host branch) the
      chunk runs again at the worst-case extent, so the result equals the
      monolithic schedule's bit for bit.

    Under autograd the schedule and the collectives are the same.  Each
    branch holds ``core.collectives``' replicated-value rule as
    ``_moe_shard_fn`` does; an issued A2A joins the graph when it is
    waited on.  An overflowed chunk's rerun replaces its first attempt,
    which never enters the loss, so no rank runs that attempt's backward
    (the branch is rank-uniform)."""
    h = x.shape[-1]
    tp, ep = C.axis_size(mesh, tp_axes), C.axis_size(mesh, ep_axes)
    e_global = cfg.n_experts
    e_local = e_global // ep
    k = cfg.top_k
    tok_full, tok = _local_tokens(x, p, cfg, mesh, tp_axes, tp, token_sliced)
    t_real, t = x.shape[0] * x.shape[1], tok.shape[0]
    idx, w, aux = route_topk(tok @ p["router"], k,
                             use_kernel=policy.topk_gate)
    fused = comm_algo in ("fused", "sync") and tp > 1 and ep > 1 \
        and not token_sliced
    if tp > 1 and not fused and not token_sliced:
        # the combine runs on the whole width, as in _moe_shard_fn
        w = C.share(w, mesh, tp_axes)
    fin = dict(cfg=cfg, mesh=mesh, mesh_axes=mesh_axes, tp_axes=tp_axes,
               token_sliced=token_sliced, with_stats=with_stats)
    dev = x.device

    if ep == 1:
        # no EP exchange: the local pipeline plus the TP partial-sum psum
        dl = make_dropless(idx, w, e_global)
        xs = gather_rows(tok, torch.div(dl.order, k, rounding_mode="floor"),
                         use_kernel=policy.fused_permute)
        ys = grouped_ffn(p, xs, dl.offsets, cfg, use_kernel=policy.moe_gemm)
        if tp > 1 and not token_sliced:
            ys = C.psum(ys, mesh, tp_axes)
        out_tok = combine_rows(ys, dl.inv.reshape(t, k), w.reshape(t, k),
                               use_kernel=policy.fused_permute)
        if token_sliced and tp > 1:
            out_tok = C.all_gather(out_tok, mesh, tp_axes, axis=0,
                                   grad="whole")[:t_real]
        out_tok = _shared_epilogue(out_tok, p, tok_full, tok, cfg, mesh,
                                   tp_axes, tp, token_sliced, False)
        return _finish(out_tok, x, aux, idx, **fin)

    ovl = ep_overlap if ep_overlap is not None else EP_OVERLAP_OFF
    n_chunks = math.gcd(ovl.chunks, t) if ovl.chunks > 1 else 1
    t_c = t // n_chunks
    n_c = t_c * k                   # worst-case rows per rank, one chunk
    cap = cap_rows_for(n_c, ep, ovl)
    payload = _tp_shard(tok, mesh, tp_axes, tp) if fused else tok
    # every axis of this block's collectives takes the same branch; counts
    # are TP-replicated, so the pmax is uniform
    ovf_axes = _in_mesh_order(mesh, tuple(ep_axes) + tuple(tp_axes))

    def send_recv(tok_c, dl, S, async_op=False):
        """Count-bounded dispatch A2A of one chunk at extent S: rank r's
        rows are the sorted segment [offsets[r*e_local],
        offsets[(r+1)*e_local]) cut to its first S rows."""
        rank_off = dl.offsets[::e_local].long()           # (ep+1,)
        rank_eff = (rank_off[1:] - rank_off[:-1]).clamp_max(S)   # (ep,)
        i_in = torch.arange(S, device=dev)[None, :]       # (1, S)
        p_sorted = (rank_off[:-1, None] + i_in).clamp_max(n_c - 1)
        src = torch.where(i_in < rank_eff[:, None],
                          torch.div(dl.order.long()[p_sorted], k,
                                    rounding_mode="floor"), -1)
        # destination r's rows live at [r*S, r*S + rank_eff[r]): the
        # (ep,) prefix vector with stride S tells the kernel which tiles
        # are empty
        send = gather_rows(tok_c, _i32(src.reshape(-1)),
                           use_kernel=policy.fused_permute,
                           total=_i32(rank_eff), seg_stride=S)
        return C.all_to_all(send.reshape(ep, S, -1), mesh, ep_axes,
                            async_op=async_op)

    def widen(recv):
        """(ep, S, h') -> (ep*S, h): the fused path's AG to full width."""
        if fused:
            recv = C.all_gather(recv, mesh, tp_axes, axis=-1)
        return recv.reshape(ep * recv.shape[1], -1)

    def expert_phase(recv, recv_counts, S):
        """Regroup the received rows by local expert (closed form from the
        count prefix sums, no sort), grouped FFN, TP reduction, combine
        A2A.  Row (s, i) goes to comb row off_local[le] + rows of expert le
        from earlier sources + its rank in source s's le segment."""
        rc = recv_counts.long()
        i_in = torch.arange(S, device=dev)[None, :]       # (1, S)
        # each sender cut its expert-sorted segment at S rows: the
        # effective per-(source, expert) counts are the prefix sums clipped
        # at S, re-differenced
        csum_eff = torch.cumsum(rc, 1).clamp_max(S)       # (ep, e_local)
        cnt_eff = csum_eff - torch.cat(
            [csum_eff.new_zeros(ep, 1), csum_eff[:, :-1]], 1)
        tot_src = csum_eff[:, -1]                          # (ep,)
        le = (csum_eff[:, :, None] <= i_in[:, None, :]).sum(1)   # (ep, S)
        valid = (i_in < tot_src[:, None]).reshape(-1)      # (ep*S,)
        off_local = torch.cat([csum_eff.new_zeros(1),
                               torch.cumsum(cnt_eff.sum(0), 0)])
        le_c = le.clamp_max(e_local - 1)
        start_in_src = torch.gather(csum_eff - cnt_eff, 1, le_c)
        from_earlier = torch.gather(torch.cumsum(cnt_eff, 0) - cnt_eff, 1,
                                    le_c)
        pos = (off_local[le_c] + from_earlier + (i_in - start_in_src)) \
            .reshape(-1)
        park = torch.where(valid, pos, ep * S)
        comb_src = torch.full((ep * S + 1,), -1, dtype=torch.int32,
                              device=dev)
        comb_src[park] = torch.arange(ep * S, dtype=torch.int32, device=dev)
        comb = gather_rows(recv, comb_src[:-1],
                           use_kernel=policy.fused_permute,
                           total=_i32(tot_src.sum()))
        ys = grouped_ffn(p, comb, _i32(off_local), cfg,   # partial over tp
                         use_kernel=policy.moe_gemm)
        if fused:
            ys = C.psum_scatter(ys, mesh, tp_axes, scatter_dimension=1)
        elif tp > 1 and not token_sliced:
            ys = C.psum(ys, mesh, tp_axes)
        out_recv = gather_rows(ys, _i32(torch.where(valid, pos, -1)),
                               use_kernel=policy.fused_permute)
        out_send = C.all_to_all(out_recv.reshape(ep, S, -1), mesh, ep_axes)
        return out_send.reshape(ep * S, -1)

    def combine_phase(out_send, dl, w_c, S):
        """Weighted k-way combine.  Slot f sits at sorted position
        p = inv[f]; its rank r is the segment holding p, its exchange row
        r*S + (p - rank_off[r])."""
        rank_off = dl.offsets[::e_local].long()
        p_pos = dl.inv.long()
        r_of = (rank_off[None, 1:] <= p_pos[:, None]).sum(1)
        row = r_of * S + (p_pos - rank_off[r_of]).clamp_max(S - 1)
        return combine_rows(out_send, _i32(row).reshape(t_c, k),
                            w_c.reshape(t_c, k),
                            use_kernel=policy.fused_permute)

    # ---- stage 1: every chunk's routing metadata, counts A2A, dispatch
    # A2A and overflow pmax, issued before any chunk's expert GEMM ----
    stage = []
    for i in range(n_chunks):
        sl = slice(i * t_c, (i + 1) * t_c)
        dl = make_dropless(idx[sl], w[sl], e_global)
        counts = C.all_to_all(dl.counts.reshape(ep, e_local), mesh, ep_axes,
                              async_op=True)
        recv = send_recv(payload[sl], dl, cap, async_op=True)
        ovf = None
        if cap < n_c:
            rank_off = dl.offsets[::e_local]
            seg_max = (rank_off[1:] - rank_off[:-1]).max()
            ovf = C.pmax(seg_max, mesh, ovf_axes, async_op=True)
        stage.append((dl, counts, recv, ovf, w[sl], payload[sl]))

    # ---- stage 2: per chunk, grouped FFN and combine A2A ----
    outs = []
    for dl, counts, recv, ovf, w_c, tok_c in stage:
        counts = counts.wait()
        out_c = combine_phase(expert_phase(widen(recv.wait()), counts, cap),
                              dl, w_c, cap)
        exchange_counts["chunks"] += 1
        # the overflow rerun's branch: a pmax over the EP and TP ranks, so
        # every rank reads the same value and takes the same branch
        if ovf is not None and int(ovf.wait()) > cap:  # repro-lint: disable=R2
            # rare: redo dispatch -> FFN -> combine at the worst-case
            # extent (the counts need no second exchange)
            exchange_counts["overflow"] += 1
            out_c = combine_phase(
                expert_phase(widen(send_recv(tok_c, dl, n_c)), counts, n_c),
                dl, w_c, n_c)
        outs.append(out_c)
    out_tok = outs[0] if n_chunks == 1 else torch.cat(outs)
    if token_sliced and tp > 1:     # undo the token slice, drop its pad
        out_tok = C.all_gather(out_tok, mesh, tp_axes, axis=0,
                               grad="whole")[:t_real]
    out_tok = _shared_epilogue(out_tok, p, tok_full, tok, cfg, mesh,
                               tp_axes, tp, token_sliced, fused)
    return _finish(out_tok, x, aux, idx, **fin)


def moe_rank(p, x, cfg: ModelConfig, plan: ShardingPlan = NULL_PLAN, *,
             dispatch: Optional[str] = None, with_stats: bool = False,
             seq_sharded: bool = False):
    """The MoE block on this rank's batch rows: x (b_loc, s, h) -> (out,
    aux_loss) [+ per-expert routed counts (E,) int32, replicated, when
    ``with_stats``].  ``dispatch`` overrides ``plan.dispatch_mode``.

    ``p`` is this rank's slice of the block's weights
    (``ShardingPlan.keep_hook``).  With ``seq_sharded`` x is this rank's
    seq block of the residual stream: the rows are all-gathered along seq
    over the TP axes first, so the body sees the rows it sees on a whole
    stream, and the output is cut back to the seq block (no collective).
    With no mesh this is ``moe_local``."""
    mode = resolve_dispatch(dispatch if dispatch is not None
                            else getattr(plan, "dispatch_mode", None))
    if not plan.enabled:
        return moe_local(p, x, cfg, policy=plan.kernels, dispatch=mode,
                         with_stats=with_stats)
    mesh = plan.mesh
    token_sliced = plan.token_sliced
    ep = plan.ep
    if ep > 1 and cfg.n_experts % ep:
        raise ValueError(
            f"{cfg.name}: n_experts={cfg.n_experts} not divisible by EP "
            f"degree {ep} — pick a different plan (analyzer enforces this)")
    want = p["w_in"].shape[0], cfg.n_experts // ep
    if want[0] != want[1]:
        raise ValueError(f"moe_block on a mesh takes this rank's slice of "
                         f"the expert weights: w_in holds {want[0]} experts, "
                         f"the plan gives each rank {want[1]}")
    kw = dict(cfg=cfg, mesh=mesh, tp_axes=plan.tp_axes,
              ep_axes=plan.ep_axes,
              comm_algo="unfused" if token_sliced else plan.comm_algo,
              token_sliced=token_sliced, mesh_axes=mesh.axis_names,
              policy=plan.kernels, with_stats=with_stats)
    x_loc = plan.gather_seq(x, seq_sharded).contiguous()
    if mode == "dropless":
        r = _moe_shard_dropless_fn(p, x_loc, ep_overlap=plan.ep_overlap,
                                   **kw)
    else:
        r = _moe_shard_fn(p, x_loc, **kw)
    return (plan.cut_seq(r[0], seq_sharded),) + tuple(r[1:])


def moe_block(p, x, cfg: ModelConfig, plan: ShardingPlan = NULL_PLAN, *,
              dispatch: Optional[str] = None, with_stats: bool = False):
    """The MoE block on the whole batch: x (b, s, h) -> (out, aux_loss)
    [+ counts], as ``moe_rank``.

    With a mesh, ``x`` is the whole batch on every rank and ``p`` this
    rank's slice of the block's weights; the batch is sliced over the
    plan's batch axes, ``moe_rank`` runs, and the output is gathered back,
    so every rank returns the whole (b, s, h)."""
    if not plan.enabled:
        return moe_rank(p, x, cfg, plan, dispatch=dispatch,
                        with_stats=with_stats)
    x_axes = ("batch", "seq", "embed")
    r = moe_rank(p, plan.shard(x, x_axes), cfg, plan, dispatch=dispatch,
                 with_stats=with_stats)
    batch_axes = (plan.spec(x_axes) or (None,))[0]
    if batch_axes is None:
        return r
    batch_axes = batch_axes if isinstance(batch_axes, tuple) \
        else (batch_axes,)
    return (C.all_gather(r[0], plan.mesh, batch_axes, axis=0),) \
        + tuple(r[1:])


__all__ = ["moe_spec", "moe_block", "moe_rank", "moe_local", "route_topk",
           "make_dispatch", "scatter_to_buffers", "gather_from_buffers",
           "expert_ffn", "capacity_for", "positions_in_expert",
           "DispatchInfo", "dispatch_src_tok", "dispatch_src_slot",
           "resolve_dispatch", "DroplessInfo", "make_dropless",
           "expert_counts", "gather_rows", "combine_rows", "grouped_ffn",
           "shared_expert_ffn",
           "exchange_counts"]
