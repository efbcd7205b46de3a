"""Transformer layer substrate: norms, RoPE, attention (GQA and MLA), MLP.

The attention blocks run in the reference's modes:

* the paged unified step: slot ``i`` contributes its first ``q_lens[i]``
  query rows at cache offset ``length[i]``, its new cache rows are written
  into the page pools through its block table, and attention reads the
  pools through the same table;
* the dense per-slot cache ``(b, max_len, ...)``: the same unified step
  (``q_lens`` given; ``length`` the per-slot offsets), or a uniform prefill
  / decode at one offset for every slot; the new rows go in by
  ``write_cache``;
* stateless (``cache=None``): fresh K/V, causal attention over the rows
  themselves, always on the plain body (the reference routes to a kernel
  only when a cache length is given).

* GQA (``gqa_attention``): on the paged cache with
  ``KernelPolicy.flash_chunk`` via the hand-written ``flash_chunk_paged``
  kernel; on the dense cache via ``chunked_attention`` (policy
  ``flash_chunk``: the dense ``flash_chunk`` kernel) or, for a width-1
  step, ``decode_attention`` (policy ``flash_decode``); otherwise via those
  plain bodies (on a gathered slot-major view of the pools when paged: the
  reference's kernels-off routing, kept so the two packages compare like
  for like).
* MLA (``mla_attention``): the latent ``c`` and ``k_rope`` rows, paged
  ``(P, page, r)`` / ``(P, page, rd)`` pools gathered into a slot-major
  view as the reference does, or dense per-slot buffers; attention runs
  through ``chunked_attention`` or, for a width-1 step in the absorbed
  regime, ``decode_attention``.

Layouts follow the reference at every public function: activations
``(b, s, ...)``, ``wq (h, nq, hd)``, ``wo (nq, hd, h)``, pools
``(P, page, nkv, hd)``, dense buffers ``(b, max_len, nkv, hd)``.

On a mesh (``plan.enabled``) each rank runs these on its batch rows with
its block of the weights (``ShardingPlan.keep_hook``): attention on its
1/tp of the heads when ``plan.heads_sharded(cfg)`` (``wq``/``wk``/``wv``
and MLA's ``w_uq``/``w_uk``/``w_uv`` column-parallel, ``wo`` row-parallel),
the MLP on its 1/tp of ``d_ff``.  ``seq_sharded`` says that ``x`` holds
this rank's seq block of the residual stream: the normed rows are
all-gathered along seq on entry, and a row-parallel output leaves through
``plan.reduce_out`` (psum_scatter along seq, else psum).  The cache's
``length`` / block tables / ``q_lens`` cover every slot and each rank
takes its rows of them (``_local_rows``).  Every rank holds every page
(the reference's replicated pools), so the new cache rows of all batch
ranks are gathered before a paged write; a dense buffer holds only this
rank's rows (``(b / dp, max_len, nkv / tp, hd)``: the reference cuts
``kv_seq`` over TP instead), so its write needs no collective.  The
stateless path runs on the rank's rows and heads.
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
    ar = torch.arange(0, head_dim, 2, device=device).float()
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


def mrope_pairs(sections, n_pairs: int) -> list:
    """The position stream (0 = t, 1 = h, 2 = w) driving each of the
    ``n_pairs`` frequency pairs: stream i repeated ``sections[i]`` times,
    cut or padded with the last stream to ``n_pairs``, as the reference's
    ``jnp.repeat(..., total_repeat_length=)``."""
    ids = [i for i, n in enumerate(sections) for _ in range(n)]
    return (ids + ids[-1:] * n_pairs)[:n_pairs]


def apply_mrope(x, positions3, sections, theta: float = 10000.0):
    """Qwen2-VL multimodal RoPE: three position streams (t, h, w) drive
    disjoint frequency sections.  x (b, s, n, hd); positions3 (b, 3, s);
    ``sections``: the frequency pairs of each stream (summing to hd/2).
    The reference's f32 steps: positions as f32, one position a pair,
    angles by ``einsum("bfs,f->bsf")``, then cos and sin."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    pairs = mrope_pairs(sections, hd // 2)
    p3 = positions3.float().expand(x.shape[0], -1, -1)
    # each pair's stream, as runs of one stream: no index tensor to copy
    pos = torch.cat([p3[:, i:i + 1].expand(-1, pairs.count(i), -1)
                     for i in sorted(set(pairs))], dim=1)  # (b, hd/2, s)
    ang = torch.einsum("bfs,f->bsf", pos, inv)            # (b, s, hd/2)
    cos, sin = ang.cos()[:, :, None, :], ang.sin()[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def positions_from(idx, s: int, device=None):
    """(b, s) absolute positions from a (b,) offset tensor, or (1, s) from
    a scalar offset (an int or a 0-d tensor: the uniform batch)."""
    if torch.is_tensor(idx):
        base = idx.long().reshape(-1)[:, None]
        return base + torch.arange(s, device=idx.device)[None]
    return idx + torch.arange(s, device=device)[None]


def _per_slot(v, b: int, device):
    """A per-slot quantity as a contiguous (b,) int32 tensor: a (b,) int32
    vector passes through as it is (no device op), a scalar or 0-d tensor
    is broadcast."""
    if not torch.is_tensor(v):
        return torch.full((b,), int(v), dtype=torch.int32, device=device)
    v = v.to(torch.int32)
    return v.contiguous() if v.dim() == 1 else v.reshape(1).expand(b) \
        .contiguous()


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


def _key_mask(q_pos, k_pos, base, causal: bool, window: int):
    """(b, sq, skv) visibility: ``base`` (1|b, skv) valid keys, then the
    causal and sliding-window tests on absolute positions ``q_pos``
    (b, sq) and ``k_pos`` (1|b, skv)."""
    mask = base[:, None, :].expand(q_pos.shape[0], q_pos.shape[1], -1)
    if causal:
        mask = mask & (k_pos[:, None, :] <= q_pos[:, :, None])
    if window > 0:
        mask = mask & (k_pos[:, None, :] > q_pos[:, :, None] - window)
    return mask


def _abs_keys(k_positions, kv_len, b: int, skv: int, device):
    """(k_pos (1|b, skv), valid (1|b, skv)): explicit ring positions
    (negative = invalid) replace the slot index; otherwise the slot index
    with the ``kv_len`` tail masked (``kv_len=None``: every key)."""
    if k_positions is not None:
        k_pos = k_positions.long().reshape(-1, skv)
        return k_pos, k_pos >= 0
    k_pos = torch.arange(skv, device=device)[None]
    if kv_len is None:
        return k_pos, torch.ones(1, skv, dtype=torch.bool, device=device)
    return k_pos, k_pos < _per_slot(kv_len, b, device)[:, None]


def chunked_attention(q, k, v, *, q_offset=0, kv_len=None,
                      causal: bool = True, window: int = 0,
                      scale: Optional[float] = None, k_positions=None,
                      policy: Optional[KernelPolicy] = None):
    """q (b, sq, nq, hd); k, v (b, skv, nkv, hd[v]).  ``q_offset`` and
    ``kv_len`` are scalars (a uniform batch) or (b,) per-slot vectors (the
    unified mixed step); ``kv_len=None`` (the stateless path) masks no key
    tail.  Row r of slot i sits at position ``q_offset[i] + r`` and sees
    keys ``pos < kv_len[i]`` (and ``pos <= q_offset[i] + r`` when causal).
    ``window`` > 0 adds the sliding-window test ``pos > q_pos - window``;
    ``k_positions`` ((skv,) or (b, skv)) gives each key's absolute position
    for a ring-buffer cache (negative = invalid; ``kv_len`` is then
    ignored).

    ``policy.flash_chunk`` routes the cache-backed causal case (``kv_len``
    given, no window, slot-indexed keys) through the dense ``flash_chunk``
    kernel with ``q_len = kv_len - q_offset``; its rows past ``q_len`` come
    back as exact zeros instead of finite garbage.  The stateless case, a
    window and a ring keep the plain body, as in the reference."""
    b, sq, _, hd = q.shape
    skv = k.shape[1]
    scale = scale if scale is not None else hd ** -0.5
    if (policy is not None and policy.flash_chunk and causal
            and window == 0 and k_positions is None and kv_len is not None):
        from repro_torch.kernels import ops as _kops
        off = _per_slot(q_offset, b, q.device)
        lens = _per_slot(kv_len, b, q.device)
        return _kops.flash_chunk(q.contiguous(), k.contiguous(),
                                 v.contiguous(), off, lens - off, lens,
                                 scale=float(scale))
    q_pos = _per_slot(q_offset, b, q.device)[:, None].long() \
        + torch.arange(sq, device=q.device)
    k_pos, base = _abs_keys(k_positions, kv_len, b, skv, q.device)
    return _masked_softmax_av(q, k, v,
                              _key_mask(q_pos, k_pos, base, causal, window),
                              scale)


def decode_attention(q, k, v, *, kv_len=None, q_positions,
                     window: int = 0, k_positions=None,
                     scale: Optional[float] = None,
                     policy: Optional[KernelPolicy] = None):
    """One-step attention: q (b, sq, nq, hd) vs cache k/v (b, S, nkv,
    hd[v]); ``kv_len`` (scalar or (b,)) masks slots >= length,
    ``q_positions`` ((1|b, sq)) gives the queries' absolute positions;
    ``window`` and ``k_positions`` as in ``chunked_attention`` (the ring
    buffer's decode).

    ``policy.flash_decode`` routes the slot-indexed, window-free one-row
    case through ``ops.flash_decode`` (the dense ``flash_chunk`` kernel at
    one row), whose length mask assumes the decode invariant
    ``q_position == kv_len - 1`` that the callers keep; a slot with
    ``kv_len == 0`` comes back as an exact-zero row."""
    b, skv = q.shape[0], k.shape[1]
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if (policy is not None and policy.flash_decode and q.shape[1] == 1
            and window == 0 and k_positions is None and kv_len is not None):
        from repro_torch.kernels import ops as _kops
        return _kops.flash_decode(
            q[:, 0].contiguous(), k.contiguous(), v.contiguous(),
            _per_slot(kv_len, b, q.device), scale=float(scale))[:, None]
    k_pos, base = _abs_keys(k_positions, kv_len, b, skv, q.device)
    q_pos = q_positions.long().reshape(-1, q.shape[1]).expand(b, -1)
    return _masked_softmax_av(q, k, v,
                              _key_mask(q_pos, k_pos, base, True, window),
                              scale)


# ---------------------------------------------------------------------------
# Dense per-slot cache
# ---------------------------------------------------------------------------

def write_cache(buf, new, idx, valid_len=None):
    """Write ``new`` (b, s, ...) into the dense buffer ``buf`` (b, S, ...)
    IN PLACE at offset ``idx``; returns ``buf``.

    scalar idx  -> one slice for every slot (a uniform batch); the start is
                   clamped so the slice fits, as ``dynamic_update_slice``
    (b,) idx    -> per-slot rows ``idx[i] + r``; ``valid_len`` (b,) keeps
                   only the first ``valid_len[i]`` rows of slot i (the
                   unified step's ragged tail), and rows past ``S`` are
                   dropped, so an idle slot never touches its buffer; with
                   s == 1 and no ``valid_len``, the one-row decode write

    No branch reads a value on the host or takes a shape from the data, so
    every one runs on the meta device (as the dry run's steps do) and
    none synchronizes with the card: the slice is an ``index_copy_`` at the
    clamped rows, and the per-slot rows (the one-row decode write too) are
    one ``_drop_scatter`` of every row, the JAX package's ``mode="drop"``
    scatter.
    """
    b, skv = buf.shape[:2]
    s = new.shape[1]
    new = new.to(buf.dtype)
    if not torch.is_tensor(idx):
        start = min(max(int(idx), 0), skv - s)
        buf[:, start:start + s] = new
        return buf
    if idx.dim() == 0:
        rows = idx.long().clamp(0, skv - s) \
            + torch.arange(s, device=buf.device)
        return buf.index_copy_(1, rows, new)
    r = torch.arange(s, device=buf.device)[None]
    rows = idx.long()[:, None] + r                               # (b, s)
    ok = (rows >= 0) & (rows < skv)
    if valid_len is not None:
        ok = ok & (r < valid_len.long()[:, None])
    bi = torch.arange(b, device=buf.device)[:, None].expand(b, s)
    return _drop_scatter(buf, (bi, rows), new, ok)


def _drop_scatter(dst, index, val, ok):
    """``dst[index] = val`` for the rows where ``ok``, IN PLACE, as the JAX
    package's ``mode="drop"`` scatter of rows parked out of bounds; returns
    ``dst``.

    ``index`` is a tuple of (b, s) integer tensors addressing ``dst``'s
    leading dims, ``val`` (b, s, ...) and ``ok`` (b, s) bool.  One
    ``index_put_`` writes every row, at shapes fixed by (b, s), so nothing
    is read on the host: a dropped row is parked on the first valid row's
    cell with that row's own value, or, where no row is valid, on cell 0
    with cell 0's current value.  Every write to a shared cell then carries
    the same bits, so the order of the duplicates cannot matter.
    """
    ok = ok.reshape(-1)
    index = tuple(i.reshape(-1) for i in index)
    val = val.reshape((-1,) + tuple(val.shape[2:]))
    j = ok.to(torch.uint8).argmax().reshape(1)     # first valid row, else 0
    some = ok.any()
    park = tuple(torch.where(some, i.index_select(0, j), 0) for i in index)
    cell0 = dst[(0,) * len(index)][None]
    park_val = torch.where(some, val.index_select(0, j), cell0)
    keep = ok.reshape((-1,) + (1,) * (val.dim() - 1))
    return dst.index_put_(
        tuple(torch.where(ok, i, p) for i, p in zip(index, park)),
        torch.where(keep, val, park_val))


# ---------------------------------------------------------------------------
# Paged cache
# ---------------------------------------------------------------------------

def write_cache_paged(pool, new, idx, block_table, valid_len):
    """Write ``new`` (b, s, ...) into the paged pool (P, page, ...) IN PLACE
    at the slots' logical offsets ``idx`` (b,), routed through
    ``block_table`` (b, max_blocks).  Returns ``pool``.

    Rows past ``valid_len[i]`` and rows whose logical block is unallocated
    (table entry < 0) are dropped by the write (``_drop_scatter``, at
    shapes fixed by ``(b, s)``, with no host sync), so an idle slot — or a
    slot whose pages the host allocator withheld — never touches the
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
    return _drop_scatter(pool, (page, pos % ps), new.to(pool.dtype), ok)


def gather_pages(pool, block_table):
    """A slot-major dense view (b, max_blocks*page, ...) of the paged pool
    through the block tables; unallocated blocks read page 0, whose rows
    sit past the slot's length and are masked by ``kv_len``."""
    n_pages, ps = pool.shape[0], pool.shape[1]
    b, nb = block_table.shape
    pages = pool[block_table.long().clamp(0, n_pages - 1)]
    return pages.reshape(b, nb * ps, *pool.shape[2:])


def _local_rows(plan: ShardingPlan, *ts):
    """This rank's batch rows of per-slot tensors (views); None and a 0-d
    offset (one for every slot) pass through."""
    return tuple(t if t is None or t.dim() == 0
                 else plan.shard(t, ("batch",)) for t in ts)


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
# GQA attention block
# ---------------------------------------------------------------------------

def gqa_spec(cfg: ModelConfig) -> dict:
    h, nq, nkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": P((h, nq, hd), ("embed", "heads", "head_dim")),
        "wk": P((h, nkv, hd), ("embed", "kv_heads", "kv_head_dim")),
        "wv": P((h, nkv, hd), ("embed", "kv_heads", "kv_head_dim")),
        "wo": P((nq, hd, h), ("heads", "head_dim", "embed")),
        "norm": P((h,), ("embed",), init="zeros", tp_share="seq"),
    }


@dataclasses.dataclass
class KVView:
    """A cache to read and update.  With ``block_table`` (b, max_blocks)
    k/v are paged POOLS (P, page, nkv, hd) and the table maps each slot's
    logical blocks to pages (on a mesh, of every slot: each rank takes its
    batch rows); without it they are dense per-slot buffers
    (b, max_len, nkv, hd).  ``length`` holds the cache offsets: (b,) per
    slot, or a 0-d tensor for a uniform dense batch."""
    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor
    block_table: Optional[torch.Tensor] = None


def _promoted(x, w):
    """x and w in their common dtype, as ``jnp`` promotes a product (bf16
    rows on f32 weights: both f32); no copy when they already agree."""
    if x.dtype == w.dtype:
        return x, w
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt), w.to(dt)


def _proj_heads(xn, w):
    """(b, s, h) @ (h, n, d) -> (b, s, n, d), in the promoted dtype."""
    b, s, h = xn.shape
    xn, w = _promoted(xn, w)
    return (xn.reshape(b * s, h) @ w.reshape(h, -1)).reshape(
        b, s, *w.shape[1:])


def _heads_out(out, w):
    """(b, s, n, d) @ (n, d, h) -> (b, s, h), in the promoted dtype."""
    b, s, n, d = out.shape
    out, w = _promoted(out, w)
    return (out.reshape(b * s, n * d) @ w.reshape(n * d, -1)).reshape(
        b, s, -1)


def gqa_attention(p, x, cfg: ModelConfig, plan: ShardingPlan = NULL_PLAN, *,
                  cache: Optional[KVView] = None, q_lens=None,
                  positions=None, seq_sharded: bool = False):
    """Returns (out (b, s, h), new K/V).  x (b, s, h).  Four modes, as in
    the reference:

      cache is None             stateless: fresh K/V, causal attention
                                over the rows (plain body); returns (k, v)
      cache + q_lens (b,)       unified mixed step: slot i contributes the
                                first q_lens[i] of its s rows at offset
                                ``cache.length[i]``; paged or dense
      dense cache, s > 1        uniform prefill into the buffers
      dense cache, s == 1       decode, one token a slot

    A cache is updated in place and returned.  On a mesh x is this rank's
    rows (seq block when ``seq_sharded``) and so is the output;
    ``positions`` (b, s) are this rank's rows too, and so are a dense
    cache's buffers (``cache.length`` and ``q_lens`` cover every slot)."""
    paged = cache is not None and cache.block_table is not None
    if paged and q_lens is None:
        raise NotImplementedError(
            "paged KV cache requires the unified mixed step (q_lens)")
    xn = plan.gather_seq(rms_norm(x, p["norm"], cfg.norm_eps), seq_sharded,
                         parallel=plan.heads_sharded(cfg))
    b, s, h = xn.shape
    q = _proj_heads(xn, p["wq"])
    k = _proj_heads(xn, p["wk"])
    v = _proj_heads(xn, p["wv"])
    if paged:
        idx, bt, ql = _local_rows(plan, cache.length, cache.block_table,
                                  q_lens)
    elif cache is not None:
        idx, ql = _local_rows(plan, cache.length, q_lens)
    else:
        idx = 0
    if positions is None:
        positions = positions_from(idx, s, x.device)
    if cfg.mrope:         # (b, 3, s) streams; plain positions drive all three
        if positions.dim() == 2:
            positions = positions[:, None].expand(b, 3, s)
        q = apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_theta)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    pol = plan.kernels
    if cache is None:
        out = chunked_attention(q, k, v, causal=True)
        new_kv = (k, v)
    elif paged:
        kc, vc = _write_pools(plan, (cache.k, cache.v), (k, v), cache.length,
                              cache.block_table, q_lens)
        kv_len = idx + ql
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
                out = chunked_attention(q, kd, vd, q_offset=idx,
                                        kv_len=kv_len, causal=True)
        new_kv = (kc, vc)
    else:                 # dense: this rank's rows, no collective
        kc = write_cache(cache.k, k, idx, valid_len=ql)
        vc = write_cache(cache.v, v, idx, valid_len=ql)
        kv_len = idx + (s if ql is None else ql)
        if s == 1:            # decode-shaped: flash_decode eligible
            out = decode_attention(q, kc, vc, kv_len=kv_len,
                                   q_positions=positions_from(idx, s,
                                                              x.device),
                                   policy=pol)
        else:
            out = chunked_attention(q, kc, vc, q_offset=idx, kv_len=kv_len,
                                    causal=True, policy=pol)
        new_kv = (kc, vc)
    return _attn_out(plan, cfg, _heads_out(out, p["wo"]), seq_sharded), \
        new_kv


# ---------------------------------------------------------------------------
# MLA (Multi-head Latent Attention) — DeepSeek-V2 / MiniCPM3
# ---------------------------------------------------------------------------

def mla_spec(cfg: ModelConfig) -> dict:
    h, nh, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    r, qr, rd, vd = (cfg.kv_lora_rank, cfg.q_lora_rank or cfg.d_model,
                     cfg.rope_head_dim, cfg.v_head_dim)
    return {
        "w_dq": P((h, qr), ("embed", "qk"), tp_share="heads"),
        "q_norm": P((qr,), ("qk",), init="zeros", tp_share="heads"),
        "w_uq": P((qr, nh, hd + rd), ("qk", "heads", "head_dim")),
        "w_dkv": P((h, r), ("embed", "qk"), tp_share="heads"),
        "kv_norm": P((r,), ("qk",), init="zeros", tp_share="heads"),
        "w_kr": P((h, rd), ("embed", None), tp_share="heads"),
        "w_uk": P((r, nh, hd), ("qk", "heads", "head_dim")),
        "w_uv": P((r, nh, vd), ("qk", "heads", "head_dim")),
        "wo": P((nh, vd, h), ("heads", "head_dim", "embed")),
        "norm": P((h,), ("embed",), init="zeros", tp_share="seq"),
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
                  cache=None, q_lens=None, block_table=None, positions=None,
                  absorb: Optional[bool] = None, seq_sharded: bool = False):
    """MLA attention.  x (b, s, h); ``cache`` = (c, kr, length): with
    ``block_table`` the latent pools (P, page, r) / (P, page, rd) and the
    unified step's per-slot offsets (``q_lens`` required); without it dense
    per-slot buffers (b, max_len, r) / (b, max_len, rd) at per-slot or
    uniform offsets (``q_lens`` optional, as in ``gqa_attention``);
    ``cache=None`` is the stateless path.  Returns (out (b, s, h), the
    latent pair): a cache is updated in place and returned; stateless, the
    fresh (c, k_rope).

    A paged latent pool is gathered into a slot-major view through
    ``block_table`` (the latent is rank-r compressed, so the gather is
    cheap).  ``absorb=None`` auto-selects the regime, as the reference does:
      expanded (no cache, or s > 1) — K/V up-projected per head from the
              whole latent view, standard attention (hd + rd keys, vd
              values per head)
      absorbed (a cache and s == 1) — w_uk folded into q and w_uv into the
              output, so attention runs in the latent space: one kv head
              of r + rd key dims and r value dims shared by every query
              head.
    Both regimes use scale ``(hd + rd) ** -0.5``.

    On a mesh the down-projections and their norms run whole on every
    rank and the up-projections on its heads; the latent pools and dense
    buffers have no head axis and stay whole (a dense buffer: this rank's
    rows)."""
    paged = cache is not None and block_table is not None
    if paged and q_lens is None:
        raise NotImplementedError(
            "paged KV cache requires the unified mixed step (q_lens)")
    xn = plan.gather_seq(rms_norm(x, p["norm"], cfg.norm_eps), seq_sharded,
                         parallel=plan.heads_sharded(cfg))
    b, s, h = xn.shape
    nh, hd, rd = p["w_uk"].shape[1], cfg.head_dim, cfg.rope_head_dim
    if absorb is None:
        absorb = cache is not None and s == 1
    if paged:
        c_pool, kr_pool, length = cache
        idx, bt, ql = _local_rows(plan, length, block_table, q_lens)
    elif cache is not None:
        idx, ql = _local_rows(plan, cache[2], q_lens)
    else:
        idx = 0
    if positions is None:
        positions = positions_from(idx, s, x.device)
    q_nope, q_rope, c, k_rope = _mla_qkr(p, xn, cfg, positions)
    if cache is None:
        src_c, src_kr, kv_len = c, k_rope, None
        new_cache = (c, k_rope)
    elif paged:
        cc, krc = _write_pools(plan, (c_pool, kr_pool), (c, k_rope), length,
                               block_table, q_lens)
        src_c = gather_pages(cc, bt)               # (b, skv, r)
        src_kr = gather_pages(krc, bt)             # (b, skv, rd)
        kv_len = idx + ql
        new_cache = (cc, krc)
    else:                 # dense: this rank's rows, no collective
        cc = write_cache(cache[0], c, idx, valid_len=ql)
        krc = write_cache(cache[1], k_rope, idx, valid_len=ql)
        src_c, src_kr = cc, krc
        kv_len = idx + (s if ql is None else ql)
        new_cache = (cc, krc)
    skv = src_c.shape[1]
    scale = (hd + rd) ** -0.5
    pol = plan.kernels
    if not absorb:
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([_proj_heads(src_c, p["w_uk"]),
                       src_kr[:, :, None].expand(b, skv, nh, rd)], dim=-1)
        v = _proj_heads(src_c, p["w_uv"])
        # kv_len is None on the stateless path: the plain body, no kernel
        out = chunked_attention(q, k, v, q_offset=idx, kv_len=kv_len,
                                causal=True, scale=scale, policy=pol)
    else:
        q_lat = torch.einsum("bsnd,rnd->bsnr", q_nope, p["w_uk"])
        q_full = torch.cat([q_lat, q_rope], dim=-1)      # (b, s, nh, r+rd)
        # latent "keys" = [c ; k_rope], latent "values" = c (one kv head)
        k_lat = torch.cat([src_c, src_kr], dim=-1)[:, :, None]
        v_lat = src_c[:, :, None]
        if cache is not None and s == 1:
            o_lat = decode_attention(q_full, k_lat, v_lat, kv_len=kv_len,
                                     q_positions=positions_from(idx, s,
                                                                x.device),
                                     scale=scale, policy=pol)
        else:
            o_lat = chunked_attention(q_full, k_lat, v_lat, q_offset=idx,
                                      kv_len=kv_len, causal=True,
                                      scale=scale, policy=pol)
        out = torch.einsum("bsnr,rnd->bsnd", o_lat, p["w_uv"])
    return _attn_out(plan, cfg, _heads_out(out, p["wo"]), seq_sharded), \
        new_cache


# ---------------------------------------------------------------------------
# Dense MLP (SwiGLU / GeGLU / GELU)
# ---------------------------------------------------------------------------

def mlp_spec(cfg: ModelConfig, d_ff: Optional[int] = None) -> dict:
    h, f = cfg.d_model, d_ff or cfg.d_ff
    gated = cfg.activation in ("swiglu", "geglu")
    spec = {
        "w_in": P((h, f), ("embed", "ffn")),
        "w_out": P((f, h), ("ffn", "embed")),
        "norm": P((h,), ("embed",), init="zeros", tp_share="seq"),
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
    "rms_norm", "activate", "rope_freqs", "apply_rope", "mrope_pairs",
    "apply_mrope", "positions_from",
    "chunked_attention", "decode_attention", "write_cache",
    "write_cache_paged",
    "gather_pages", "KVView", "gqa_spec", "gqa_attention", "mla_spec",
    "mla_attention", "mlp_spec", "mlp", "NEG_INF",
]
