"""Transformer layer substrate: norms, RoPE, attention (GQA and MLA), MLP.

The cache-backed attention here is the paged unified step: slot ``i``
contributes its first ``q_lens[i]`` query rows at cache offset
``length[i]``, its new cache rows are written into the page pools through
its block table, and attention reads the pools through the same table.

* GQA (``gqa_attention``): with ``KernelPolicy.flash_chunk`` via the
  hand-written ``flash_chunk_paged`` kernel, otherwise via the plain
  ``chunked_attention`` / ``decode_attention`` bodies on a gathered
  slot-major view (the reference's kernels-off routing, kept so the two
  packages compare like for like).
* MLA (``mla_attention``): the latent pools ``(P, page, r)`` and
  ``(P, page, rd)`` are gathered into a slot-major view, as the reference
  does, and attention runs on it through ``chunked_attention`` (policy
  ``flash_chunk``: the dense ``flash_chunk`` kernel) or, for a width-1 step
  in the absorbed regime, ``decode_attention`` (policy ``flash_decode``).

Layouts follow the reference at every public function: activations
``(b, s, ...)``, ``wq (h, nq, hd)``, ``wo (nq, hd, h)``, pools
``(P, page, nkv, hd)``.

On a mesh (``plan.enabled``) each rank runs these on its batch rows with
its block of the weights (``ShardingPlan.keep_hook``): attention on its
1/tp of the heads when ``plan.heads_sharded(cfg)`` (``wq``/``wk``/``wv``
and MLA's ``w_uq``/``w_uk``/``w_uv`` column-parallel, ``wo`` row-parallel),
the MLP on its 1/tp of ``d_ff``.  ``seq_sharded`` says that ``x`` holds
this rank's seq block of the residual stream: the normed rows are
all-gathered along seq on entry, and a row-parallel output leaves through
``plan.reduce_out`` (psum_scatter along seq, else psum).  The cache's
``length`` / block tables / ``q_lens`` cover every slot; every rank holds
every page (the reference's replicated pools), so the new cache rows of
all batch ranks are gathered before the write.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives as C
from repro_torch.core.partitioner import NULL_PLAN, ShardingPlan
from repro_torch.kernels.policy import KernelPolicy
from repro_torch.models.param import P

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms & activations
# ---------------------------------------------------------------------------

def rms_norm(x, weight, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + weight.float())).to(dtype)


def activate(x_gate, x_up, kind: str):
    if kind == "swiglu":
        return F.silu(x_gate) * x_up
    if kind == "geglu":
        return F.gelu(x_gate, approximate="tanh") * x_up
    return F.gelu(x_gate, approximate="tanh")  # plain gelu: x_up unused


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / head_dim))


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., s, n, hd); positions: broadcastable to (..., s)."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)
    ang = positions[..., None].float() * inv              # (..., s, hd/2)
    cos, sin = ang.cos()[..., None, :], ang.sin()[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def positions_from(idx, s: int):
    """(b, s) absolute positions from a (b,) offset tensor."""
    return idx[:, None].long() + torch.arange(s, device=idx.device)[None]


# ---------------------------------------------------------------------------
# Plain attention bodies (the kernels-off path)
# ---------------------------------------------------------------------------

def _masked_softmax_av(q, k, v, mask, scale):
    """Scores, mask, softmax and the value product — the reference's
    online-softmax arithmetic in one block.  q (b, sq, nq, hd); k/v
    (b, skv, nkv, hd|hdv); mask (b, sq, skv).  A row with no visible key
    yields finite garbage (callers discard it), as in the reference."""
    b, sq, nq, hd = q.shape
    nkv = k.shape[2]
    g = nq // nkv
    qg = (q * scale).reshape(b, sq, nkv, g, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    s = s.masked_fill(~mask[:, None, None], NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1)
    pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float())
    out = pv / l.clamp_min(1e-20)[..., None]              # (b,nkv,g,sq,hdv)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, nq, v.shape[-1]) \
        .to(q.dtype)


def chunked_attention(q, k, v, *, q_offset, kv_len, causal: bool = True,
                      scale: Optional[float] = None,
                      policy: Optional[KernelPolicy] = None):
    """q (b, sq, nq, hd); k, v (b, skv, nkv, hd[v]); ``q_offset``/``kv_len``
    (b,) per-slot vectors (the unified mixed step).  Row r of slot i sits at
    position ``q_offset[i] + r`` and sees keys ``pos < kv_len[i]`` (and
    ``pos <= q_offset[i] + r`` when causal).

    ``policy.flash_chunk`` routes the causal case through the dense
    ``flash_chunk`` kernel with ``q_len = kv_len - q_offset``; its rows
    past ``q_len`` come back as exact zeros instead of finite garbage."""
    b, sq, _, hd = q.shape
    skv = k.shape[1]
    scale = scale if scale is not None else hd ** -0.5
    if policy is not None and policy.flash_chunk and causal:
        from repro_torch.kernels import ops as _kops
        off = q_offset.to(torch.int32).contiguous()
        lens = kv_len.to(torch.int32).contiguous()
        return _kops.flash_chunk(q.contiguous(), k.contiguous(),
                                 v.contiguous(), off, lens - off, lens,
                                 scale=float(scale))
    q_pos = q_offset[:, None].long() + torch.arange(sq, device=q.device)
    k_pos = torch.arange(skv, device=q.device)
    mask = (k_pos[None, None, :] < kv_len[:, None, None].long()) \
        .expand(b, sq, skv)
    if causal:
        mask = mask & (k_pos[None, None, :] <= q_pos[:, :, None])
    return _masked_softmax_av(q, k, v, mask, scale)


def decode_attention(q, k, v, *, kv_len, q_positions,
                     scale: Optional[float] = None,
                     policy: Optional[KernelPolicy] = None):
    """One-step attention: q (b, 1, nq, hd) vs cache k/v (b, S, nkv, hd[v]);
    ``kv_len`` (b,) masks slots >= length, ``q_positions`` (b, 1) gives the
    query's absolute position.

    ``policy.flash_decode`` routes through ``ops.flash_decode`` (the dense
    ``flash_chunk`` kernel at one row), whose length mask assumes the
    decode invariant ``q_position == kv_len - 1`` that the callers keep; a
    slot with ``kv_len == 0`` comes back as an exact-zero row."""
    skv = k.shape[1]
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if policy is not None and policy.flash_decode and q.shape[1] == 1:
        from repro_torch.kernels import ops as _kops
        return _kops.flash_decode(
            q[:, 0].contiguous(), k.contiguous(), v.contiguous(),
            kv_len.to(torch.int32).contiguous(), scale=float(scale))[:, None]
    k_pos = torch.arange(skv, device=q.device)
    mask = (k_pos[None, None, :] < kv_len[:, None, None].long()) \
        & (k_pos[None, None, :] <= q_positions[:, :, None])
    return _masked_softmax_av(q, k, v, mask, scale)


# ---------------------------------------------------------------------------
# Paged cache
# ---------------------------------------------------------------------------

def write_cache_paged(pool, new, idx, block_table, valid_len):
    """Write ``new`` (b, s, ...) into the paged pool (P, page, ...) IN PLACE
    at the slots' logical offsets ``idx`` (b,), routed through
    ``block_table`` (b, max_blocks).  Returns ``pool``.

    Rows past ``valid_len[i]`` and rows whose logical block is unallocated
    (table entry < 0) are filtered out before the write, so an idle slot —
    or a slot whose pages the host allocator withheld — never touches the
    pool.  Shared prefix pages are never written: the host hands a slot a
    cache offset past its shared full blocks.
    """
    ps = pool.shape[1]
    b, s = new.shape[:2]
    nb = block_table.shape[1]
    pos = idx[:, None].long() + torch.arange(s, device=new.device)[None]
    blk = (pos // ps).clamp(0, nb - 1)
    page = torch.gather(block_table.long(), 1, blk)              # (b, s)
    ok = (page >= 0) & (torch.arange(s, device=new.device)[None]
                        < valid_len[:, None].long())
    pool.index_put_((page[ok], (pos % ps)[ok]), new[ok].to(pool.dtype))
    return pool


def gather_pages(pool, block_table):
    """A slot-major dense view (b, max_blocks*page, ...) of the paged pool
    through the block tables; unallocated blocks read page 0, whose rows
    sit past the slot's length and are masked by ``kv_len``."""
    n_pages, ps = pool.shape[0], pool.shape[1]
    b, nb = block_table.shape
    pages = pool[block_table.long().clamp(0, n_pages - 1)]
    return pages.reshape(b, nb * ps, *pool.shape[2:])


def _local_rows(plan: ShardingPlan, *ts):
    """This rank's batch rows of per-slot tensors (views)."""
    return tuple(plan.shard(t, ("batch",)) for t in ts)


def _write_pools(plan: ShardingPlan, pools, news, idx, block_table,
                 valid_len):
    """Write this rank's new cache rows ``news`` (b_loc, s, ...) into
    ``pools`` at every slot's offset.  Every rank holds every page, so with
    the batch cut over the plan's batch axes the rows of all of them are
    gathered first, in one all_gather; ``idx`` / ``block_table`` /
    ``valid_len`` cover every slot."""
    if plan.dp > 1:
        b, s = news[0].shape[:2]
        flat = [n.reshape(b, s, -1) for n in news]
        rows = C.all_gather(torch.cat(flat, -1), plan.mesh, plan.dp_axes,
                            axis=0)
        news = [r.reshape((rows.shape[0],) + tuple(n.shape[1:])) for r, n
                in zip(rows.split([f.shape[-1] for f in flat], -1), news)]
    return tuple(write_cache_paged(pool, n, idx, block_table, valid_len)
                 for pool, n in zip(pools, news))


def _attn_out(plan: ShardingPlan, cfg: ModelConfig, out, seq_sharded):
    """The ``wo`` product into the residual layout: a TP partial sum when
    the heads are sharded, else whole on every rank."""
    if plan.heads_sharded(cfg):
        return plan.reduce_out(out, seq_sharded)
    return plan.cut_seq(out, seq_sharded)


# ---------------------------------------------------------------------------
# GQA attention block (paged unified step)
# ---------------------------------------------------------------------------

def gqa_spec(cfg: ModelConfig) -> dict:
    h, nq, nkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": P((h, nq, hd), ("embed", "heads", "head_dim")),
        "wk": P((h, nkv, hd), ("embed", "kv_heads", "kv_head_dim")),
        "wv": P((h, nkv, hd), ("embed", "kv_heads", "kv_head_dim")),
        "wo": P((nq, hd, h), ("heads", "head_dim", "embed")),
        "norm": P((h,), ("embed",), init="zeros"),
    }


@dataclasses.dataclass
class KVView:
    """A paged cache to read and update: k/v are POOLS (P, page, nkv, hd),
    ``length`` (b,) the per-slot cache offsets, ``block_table``
    (b, max_blocks) the logical-block -> page map (on a mesh, of every
    slot: each rank takes its batch rows)."""
    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor
    block_table: torch.Tensor


def _proj_heads(xn, w):
    """(b, s, h) @ (h, n, d) -> (b, s, n, d)."""
    b, s, h = xn.shape
    return (xn.reshape(b * s, h) @ w.reshape(h, -1)).reshape(
        b, s, *w.shape[1:])


def gqa_attention(p, x, cfg: ModelConfig, plan: ShardingPlan = NULL_PLAN, *,
                  cache: KVView, q_lens, positions=None,
                  seq_sharded: bool = False):
    """The paged unified step.  x (b, s, h); slot i contributes the first
    q_lens[i] of its s rows at cache offset ``cache.length[i]``.  Returns
    (out (b, s, h), (k_pool, v_pool)) — the pools are updated in place.
    On a mesh x is this rank's rows (seq block when ``seq_sharded``) and
    so is the output; ``positions`` (b, s) are this rank's rows too."""
    if cache is None or cache.block_table is None or q_lens is None:
        raise NotImplementedError(
            "the port's attention serves the paged unified step only "
            "(cache with block tables + q_lens)")
    xn = plan.gather_seq(rms_norm(x, p["norm"], cfg.norm_eps), seq_sharded)
    b, s, h = xn.shape
    q = _proj_heads(xn, p["wq"])
    k = _proj_heads(xn, p["wk"])
    v = _proj_heads(xn, p["wv"])
    idx, bt, ql = _local_rows(plan, cache.length, cache.block_table, q_lens)
    if positions is None:
        positions = positions_from(idx, s)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    kc, vc = _write_pools(plan, (cache.k, cache.v), (k, v), cache.length,
                          cache.block_table, q_lens)
    kv_len = idx + ql
    pol = plan.kernels
    if pol is not None and pol.flash_chunk:
        from repro_torch.kernels import ops as _kops
        out = _kops.flash_chunk_paged(q, kc, vc, bt, idx, ql, kv_len,
                                      scale=float(q.shape[-1] ** -0.5))
    else:
        kd, vd = gather_pages(kc, bt), gather_pages(vc, bt)
        if s == 1:
            out = decode_attention(q, kd, vd, kv_len=kv_len,
                                   q_positions=positions_from(idx, s),
                                   policy=pol)
        else:
            out = chunked_attention(q, kd, vd, q_offset=idx, kv_len=kv_len,
                                    causal=True)
    nq, hd = out.shape[2], out.shape[3]
    out = (out.reshape(b * s, nq * hd) @ p["wo"].reshape(nq * hd, h)) \
        .reshape(b, s, h)
    return _attn_out(plan, cfg, out, seq_sharded), (kc, vc)


# ---------------------------------------------------------------------------
# MLA (Multi-head Latent Attention) — DeepSeek-V2 / MiniCPM3, paged latent
# ---------------------------------------------------------------------------

def mla_spec(cfg: ModelConfig) -> dict:
    h, nh, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    r, qr, rd, vd = (cfg.kv_lora_rank, cfg.q_lora_rank or cfg.d_model,
                     cfg.rope_head_dim, cfg.v_head_dim)
    return {
        "w_dq": P((h, qr), ("embed", "qk")),
        "q_norm": P((qr,), ("qk",), init="zeros"),
        "w_uq": P((qr, nh, hd + rd), ("qk", "heads", "head_dim")),
        "w_dkv": P((h, r), ("embed", "qk")),
        "kv_norm": P((r,), ("qk",), init="zeros"),
        "w_kr": P((h, rd), ("embed", None)),
        "w_uk": P((r, nh, hd), ("qk", "heads", "head_dim")),
        "w_uv": P((r, nh, vd), ("qk", "heads", "head_dim")),
        "wo": P((nh, vd, h), ("heads", "head_dim", "embed")),
        "norm": P((h,), ("embed",), init="zeros"),
    }


def _mla_qkr(p, xn, cfg: ModelConfig, positions):
    """Shared query path + rope'd latent key from the normed rows xn:
    (q_nope (b, s, nh, hd), q_rope (b, s, nh, rd), latent c (b, s, r),
    k_rope (b, s, rd)); nh is this rank's heads."""
    ql = rms_norm(xn @ p["w_dq"], p["q_norm"], cfg.norm_eps)
    q = _proj_heads(ql, p["w_uq"])
    q_nope, q_rope = q[..., :cfg.head_dim], q[..., cfg.head_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c = rms_norm(xn @ p["w_dkv"], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope((xn @ p["w_kr"])[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, c, k_rope


def mla_attention(p, x, cfg: ModelConfig, plan: ShardingPlan = NULL_PLAN, *,
                  cache, q_lens, block_table, positions=None,
                  absorb: Optional[bool] = None, seq_sharded: bool = False):
    """MLA attention on the paged unified step.  x (b, s, h); ``cache`` =
    (c_pool (P, page, r), kr_pool (P, page, rd), length (b,)); slot i
    contributes the first q_lens[i] of its s rows at offset ``length[i]``.
    Returns (out (b, s, h), (c_pool, kr_pool)) — the pools are updated in
    place.

    The latent pools are gathered into a slot-major view through
    ``block_table`` (the latent is rank-r compressed, so the gather is
    cheap).  ``absorb=None`` auto-selects the regime, as the reference does:
      s > 1   expanded — K/V up-projected per head from the whole latent
              view, standard attention (hd + rd keys, vd values per head)
      s == 1  absorbed — w_uk folded into q and w_uv into the output, so
              attention runs in the latent space: one kv head of r + rd
              key dims and r value dims shared by every query head.
    Both regimes use scale ``(hd + rd) ** -0.5``.

    On a mesh the down-projections and their norms run whole on every
    rank and the up-projections on its heads; the latent pools have no
    head axis and stay whole."""
    if cache is None or block_table is None or q_lens is None:
        raise NotImplementedError(
            "the port's MLA serves the paged unified step only (latent "
            "pools with block tables + q_lens)")
    xn = plan.gather_seq(rms_norm(x, p["norm"], cfg.norm_eps), seq_sharded)
    b, s, h = xn.shape
    nh, hd, rd = p["w_uk"].shape[1], cfg.head_dim, cfg.rope_head_dim
    if absorb is None:
        absorb = s == 1
    c_pool, kr_pool, length = cache
    idx, bt, ql = _local_rows(plan, length, block_table, q_lens)
    if positions is None:
        positions = positions_from(idx, s)
    q_nope, q_rope, c, k_rope = _mla_qkr(p, xn, cfg, positions)
    cc, krc = _write_pools(plan, (c_pool, kr_pool), (c, k_rope), length,
                           block_table, q_lens)
    src_c = gather_pages(cc, bt)                   # (b, skv, r)
    src_kr = gather_pages(krc, bt)                 # (b, skv, rd)
    skv = src_c.shape[1]
    kv_len = idx + ql
    scale = (hd + rd) ** -0.5
    pol = plan.kernels
    if not absorb:
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([_proj_heads(src_c, p["w_uk"]),
                       src_kr[:, :, None].expand(b, skv, nh, rd)], dim=-1)
        v = _proj_heads(src_c, p["w_uv"])
        out = chunked_attention(q, k, v, q_offset=idx, kv_len=kv_len,
                                causal=True, scale=scale, policy=pol)
    else:
        q_lat = torch.einsum("bsnd,rnd->bsnr", q_nope, p["w_uk"])
        q_full = torch.cat([q_lat, q_rope], dim=-1)      # (b, s, nh, r+rd)
        # latent "keys" = [c ; k_rope], latent "values" = c (one kv head)
        k_lat = torch.cat([src_c, src_kr], dim=-1)[:, :, None]
        v_lat = src_c[:, :, None]
        if s == 1:
            o_lat = decode_attention(q_full, k_lat, v_lat, kv_len=kv_len,
                                     q_positions=positions_from(idx, s),
                                     scale=scale, policy=pol)
        else:
            o_lat = chunked_attention(q_full, k_lat, v_lat, q_offset=idx,
                                      kv_len=kv_len, causal=True,
                                      scale=scale, policy=pol)
        out = torch.einsum("bsnr,rnd->bsnd", o_lat, p["w_uv"])
    nv = out.shape[2] * out.shape[3]
    out = (out.reshape(b * s, nv) @ p["wo"].reshape(nv, h)).reshape(b, s, h)
    return _attn_out(plan, cfg, out, seq_sharded), (cc, krc)


# ---------------------------------------------------------------------------
# Dense MLP (SwiGLU / GeGLU / GELU)
# ---------------------------------------------------------------------------

def mlp_spec(cfg: ModelConfig, d_ff: Optional[int] = None) -> dict:
    h, f = cfg.d_model, d_ff or cfg.d_ff
    gated = cfg.activation in ("swiglu", "geglu")
    spec = {
        "w_in": P((h, f), ("embed", "ffn")),
        "w_out": P((f, h), ("ffn", "embed")),
        "norm": P((h,), ("embed",), init="zeros"),
    }
    if gated:
        spec["w_gate"] = P((h, f), ("embed", "ffn"))
    return spec


def mlp(p, x, cfg: ModelConfig, plan: ShardingPlan = NULL_PLAN, *,
        seq_sharded: bool = False):
    """On a mesh ``w_in``/``w_gate`` are column-parallel and ``w_out``
    row-parallel over the TP axes."""
    xn = plan.gather_seq(rms_norm(x, p["norm"], cfg.norm_eps), seq_sharded)
    up = xn @ p["w_in"]
    gate = xn @ p["w_gate"] if "w_gate" in p else up
    hmid = activate(gate, up, cfg.activation)
    return plan.reduce_out(hmid @ p["w_out"], seq_sharded)


__all__ = [
    "rms_norm", "activate", "rope_freqs", "apply_rope", "positions_from",
    "chunked_attention", "decode_attention", "write_cache_paged",
    "gather_pages", "KVView", "gqa_spec", "gqa_attention", "mla_spec",
    "mla_attention", "mlp_spec", "mlp", "NEG_INF",
]
