"""Transformer layer substrate (GQA subset): norms, RoPE, attention, MLP.

The cache-backed attention here is the paged unified step: slot ``i``
contributes its first ``q_lens[i]`` query rows at cache offset
``length[i]``, its K/V rows are written into the page pools through its
block table, and attention reads the pools through the same table — with
``KernelPolicy.flash_chunk`` via the hand-written ``flash_chunk_paged``
kernel, otherwise via the plain ``chunked_attention`` /
``decode_attention`` bodies on a gathered slot-major view (the reference's
kernels-off routing, kept so the two packages compare like for like).

Layouts follow the reference at every public function: activations
``(b, s, ...)``, ``wq (h, nq, hd)``, ``wo (nq, hd, h)``, pools
``(P, page, nkv, hd)``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
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
                      scale: Optional[float] = None):
    """q (b, sq, nq, hd); k, v (b, skv, nkv, hd[v]); ``q_offset``/``kv_len``
    (b,) per-slot vectors (the unified mixed step).  Row r of slot i sits at
    position ``q_offset[i] + r`` and sees keys ``pos < kv_len[i]`` (and
    ``pos <= q_offset[i] + r`` when causal)."""
    b, sq, _, hd = q.shape
    skv = k.shape[1]
    scale = scale if scale is not None else hd ** -0.5
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
    query's absolute position.  ``policy.flash_decode`` has no Hopper port
    yet: on CUDA it raises instead of running a stand-in."""
    if policy is not None and policy.flash_decode and q.is_cuda:
        raise NotImplementedError(
            "flash_decode has no Hopper port yet: ROADMAP B2")
    skv = k.shape[1]
    scale = scale if scale is not None else q.shape[-1] ** -0.5
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
    (b, max_blocks) the logical-block -> page map."""
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
                  cache: KVView, q_lens, positions=None):
    """The paged unified step.  x (b, s, h); slot i contributes the first
    q_lens[i] of its s rows at cache offset ``cache.length[i]``.  Returns
    (out (b, s, h), (k_pool, v_pool)) — the pools are updated in place."""
    if cache is None or cache.block_table is None or q_lens is None:
        raise NotImplementedError(
            "the port's attention serves the paged unified step only "
            "(cache with block tables + q_lens)")
    b, s, h = x.shape
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    q = _proj_heads(xn, p["wq"])
    k = _proj_heads(xn, p["wk"])
    v = _proj_heads(xn, p["wv"])
    idx = cache.length
    if positions is None:
        positions = positions_from(idx, s)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    bt = cache.block_table
    kc = write_cache_paged(cache.k, k, idx, bt, q_lens)
    vc = write_cache_paged(cache.v, v, idx, bt, q_lens)
    kv_len = idx + q_lens
    pol = plan.kernels
    if pol is not None and pol.flash_chunk:
        from repro_torch.kernels import ops as _kops
        out = _kops.flash_chunk_paged(q, kc, vc, bt, idx, q_lens, kv_len,
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
    return plan.constrain(out, "batch", "seq_resid", "embed"), (kc, vc)


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


def mlp(p, x, cfg: ModelConfig, plan: ShardingPlan = NULL_PLAN):
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    up = xn @ p["w_in"]
    gate = xn @ p["w_gate"] if "w_gate" in p else up
    hmid = activate(gate, up, cfg.activation)
    return plan.constrain(hmid @ p["w_out"], "batch", "seq_resid", "embed")


__all__ = [
    "rms_norm", "activate", "rope_freqs", "apply_rope", "positions_from",
    "chunked_attention", "decode_attention", "write_cache_paged",
    "gather_pages", "KVView", "gqa_spec", "gqa_attention", "mlp_spec", "mlp",
    "NEG_INF",
]
