"""Decoder for the families the port serves.

One ``ModelConfig`` + this module = a runnable model for:
  dense   GQA|MLA attention + dense MLP  (smollm-360m, gemma-2b,
                                          minitron-8b, minicpm3-4b, ...)
  moe     attention + dropless MoE       (phi3.5-moe-42b, deepseek-v2-236b)
  ssm     RWKV6 time-mix + channel-mix   (rwkv6-1.6b)
  hybrid  (rec, rec, attn) Griffin pattern: RG-LRU blocks and sliding-
          window attention over a ring buffer (recurrentgemma-9b)
  vlm     GQA + dense MLP with M-RoPE (three position streams t/h/w on
          disjoint frequency sections) and a patch-embedding stub: the
          ``embeds`` prepended to the token rows (qwen2-vl-7b)
  audio   whisper enc-dec: a bidirectional encoder over a frame-embedding
          stub (``frames``), decoder layers with cross-attention over its
          output (whisper-tiny)

The reference stacks each homogeneous layer group on a leading axis and
scans it; the port keeps one parameter dict per layer (per repeat of a
pattern group: one dict per sub-layer ``l0``, ``l1``, ...) and loops, in
the reference's order (within a repeat l0, l1, l2).  Two caches, as in the
reference, each per group with a leading ``count`` axis:
  paged (``init_paged_cache``)  pools ``(count, pool_pages, page, ...)`` —
          K/V ``(..., nkv, hd)`` for GQA, the latent ``c (..., r)`` and
          ``kr (..., rope_head_dim)`` for MLA — plus per-slot ``length``
          and ``block_tables``;
  dense (``init_cache``)        per-slot buffers ``(count, batch, max_len,
          ...)`` and a ``length`` (0-d: one offset for the batch; the
          serving backend makes it per slot); the recurrent kinds hold
          their carried state instead (RWKV6's f32 wkv memory and token-
          shift rows, the RG-LRU's f32 state and conv tail) and the local
          attention a ring of the last ``window`` keys with their absolute
          positions ``kpos`` (-1 = empty).  The recurrent families run on
          the dense cache only (the engine's legacy path).
``forward`` runs the unified mixed prefill/decode step on either, a
uniform prefill or decode on the dense cache, or the stateless forward
(``cache=None``), and updates a cache's buffers and ``length`` IN PLACE.

On a mesh (``plan.enabled``, one process per rank) ``forward`` realises
the reference's GSPMD layout with explicit collectives, on either cache
and with none: each rank takes its batch rows (the plan's batch axes; a
batch they do not divide, such as the legacy batch-1 prefill, runs whole
on every batch rank, as the reference's ``spec_for_shape`` replicates
it), looks up its vocab block of the embedding (summed over the TP axes),
runs every layer on its rows, its heads and its ``d_ff`` / expert /
recurrent-channel slices, carries the residual stream cut along seq when
``plan.seq_sharded``, and gathers the logits of its vocab block and batch
rows back, so every rank returns the whole logits.  A dense cache
(``init_cache(plan=)``) holds this rank's rows and heads.  Under autograd
the collectives' backwards follow ``core.collectives``' rule, and with
``plan.fsdp`` each layer gathers its FSDP-cut weights on use, inside what
``remat`` recomputes.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives as C
from repro_torch.core.partitioner import NULL_PLAN, ShardingPlan, rwkv_heads
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as S
from repro_torch.models.param import P, init_tree, stack


# ---------------------------------------------------------------------------
# Layer grouping
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Group:
    kind: str            # dense | moe | rwkv | rec | attn | xdec | pattern
    count: int           # layers (pattern: repeats) in the group
    sub: tuple = ()      # pattern: the sub-layer kinds of one repeat


def layer_plan(cfg: ModelConfig) -> tuple[Group, ...]:
    if cfg.family == "moe":
        g = []
        if cfg.first_dense_layers:
            g.append(Group("dense", cfg.first_dense_layers))
        g.append(Group("moe", cfg.n_layers - cfg.first_dense_layers))
        return tuple(g)
    if cfg.family == "ssm":
        return (Group("rwkv", cfg.n_layers),)
    if cfg.family == "hybrid":
        pat = cfg.block_pattern
        reps, rem = divmod(cfg.n_layers, len(pat))
        g = [Group("pattern", reps, pat)] if reps else []
        # remainder layers continue the pattern prefix, grouped by equal kind
        i = 0
        while i < rem:
            j = i
            while j < rem and pat[j] == pat[i]:
                j += 1
            g.append(Group(pat[i], j - i))
            i = j
        return tuple(g)
    if cfg.family == "audio":
        return (Group("xdec", cfg.n_layers),)
    return (Group("dense", cfg.n_layers),)   # dense / vlm


def _sub_groups(g: Group) -> list:
    """(key, kind) of each sub-layer of one entry of the group: the
    pattern's ``l0``, ``l1``, ... or the group's own kind (key None)."""
    if g.kind == "pattern":
        return [(f"l{i}", k) for i, k in enumerate(g.sub)]
    return [(None, g.kind)]


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def xattn_spec(cfg: ModelConfig) -> dict:
    """Cross-attention (whisper decoder -> encoder output)."""
    h, nq, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    return {
        "wq": P((h, nq, hd), ("embed", "heads", "head_dim")),
        "wk": P((h, nq, hd), ("embed", "heads", "head_dim")),
        "wv": P((h, nq, hd), ("embed", "heads", "head_dim")),
        "wo": P((nq, hd, h), ("heads", "head_dim", "embed")),
        "norm": P((h,), ("embed",), init="zeros", tp_share="seq"),
    }


def sublayer_spec(cfg: ModelConfig, kind: str) -> dict:
    if kind in ("dense", "moe"):
        attn = L.mla_spec(cfg) if cfg.attention == "mla" else L.gqa_spec(cfg)
        if kind == "dense":
            return {"attn": attn, "mlp": L.mlp_spec(cfg)}
        return {"attn": attn, "moe": MOE.moe_spec(cfg)}
    if kind == "rwkv":
        return {"tm": S.rwkv6_spec(cfg), "cm": S.rwkv6_channel_mix_spec(cfg)}
    if kind == "rec":
        return {"rglru": S.rglru_spec(cfg), "mlp": L.mlp_spec(cfg)}
    if kind == "attn":
        return {"attn": L.gqa_spec(cfg), "mlp": L.mlp_spec(cfg)}
    if kind == "xdec":
        return {"attn": L.gqa_spec(cfg), "xattn": xattn_spec(cfg),
                "mlp": L.mlp_spec(cfg)}
    raise KeyError(kind)


def group_spec(cfg: ModelConfig, g: Group) -> list:
    """One spec a layer (a pattern: a repeat of ``{"l0": ..., ...}``)."""
    if g.kind == "pattern":
        return stack({key: sublayer_spec(cfg, k)
                      for key, k in _sub_groups(g)}, g.count)
    return stack(sublayer_spec(cfg, g.kind), g.count)


def enc_layer_spec(cfg: ModelConfig) -> dict:
    """One layer of the whisper encoder."""
    e = cfg.encoder
    d, nh, f = e.d_model, e.n_heads, e.d_ff
    hd = d // nh
    return {
        "wq": P((d, nh, hd), ("embed", "heads", "head_dim")),
        "wk": P((d, nh, hd), ("embed", "heads", "head_dim")),
        "wv": P((d, nh, hd), ("embed", "heads", "head_dim")),
        "wo": P((nh, hd, d), ("heads", "head_dim", "embed")),
        "norm": P((d,), ("embed",), init="zeros"),
        "mlp_in": P((d, f), ("embed", "ffn")),
        "mlp_out": P((f, d), ("ffn", "embed")),
        "mlp_norm": P((d,), ("embed",), init="zeros"),
    }


def model_spec(cfg: ModelConfig) -> dict:
    """The parameter tree; whisper adds ``enc``: the frames' positional
    table ``pos`` (n_frames, d_enc), one dict a layer under ``layers``
    and its ``final_norm``."""
    h, v = cfg.d_model, cfg.padded_vocab
    spec: dict[str, Any] = {
        "embed": P((v, h), ("vocab", "embed"), scale=0.02),
        "final_norm": P((h,), ("embed",), init="zeros", tp_share="seq"),
        "groups": [group_spec(cfg, g) for g in layer_plan(cfg)],
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = P((h, v), ("embed", "vocab"))
    if cfg.family == "audio":
        e = cfg.encoder
        spec["enc"] = {
            "pos": P((e.n_frames, e.d_model), (None, "embed"), scale=0.02),
            "layers": stack(enc_layer_spec(cfg), e.n_layers),
            "final_norm": P((e.d_model,), ("embed",), init="zeros"),
        }
    return spec


def init_params(gen: torch.Generator, cfg: ModelConfig,
                dtype=torch.bfloat16, device="cuda",
                plan: ShardingPlan = NULL_PLAN):
    """Random weights drawn from ``gen`` (a generator on ``device``).  With
    a mesh plan each rank holds its block of the weights
    (``plan.keep_hook``), equal to the same block of the whole tree the
    same seed gives."""
    return init_tree(gen, model_spec(cfg), dtype, device,
                     keep=plan.keep_hook(cfg))


def count_params(cfg: ModelConfig) -> int:
    from repro_torch.models.param import param_count
    return param_count(model_spec(cfg))


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------

def init_paged_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                     page_size: int, pool_pages: int, dtype=torch.bfloat16,
                     device="cuda", plan: ShardingPlan = NULL_PLAN):
    """Paged KV cache: per-group *pools* + per-slot block tables.

    Pools are ``k``/``v`` ``(count, pool_pages, page_size, nkv, hd)`` for
    GQA, the latent ``c`` ``(count, pool_pages, page_size, kv_lora_rank)``
    and ``kr`` ``(..., rope_head_dim)`` for MLA; ``block_tables``
    (batch, max_len // page_size) int32 maps a slot's logical block to its
    physical page (-1 = unallocated); ``length`` (batch,) int32 holds the
    per-slot cache offsets.  The host allocator
    (``serving.kv_cache.PagedKVCache``) owns the tables.  On a mesh whose
    TP axes shard the heads (``plan.heads_sharded``) the GQA pools hold
    this rank's ``nkv / tp`` heads; every rank holds every page and
    tracks every slot."""
    for g in layer_plan(cfg):
        if g.kind not in ("dense", "moe"):
            raise NotImplementedError(
                f"paged KV cache unsupported for layer kind {g.kind!r} — "
                "this family serves through the dense legacy path")
    if max_len % page_size:
        raise ValueError(f"page_size {page_size} must divide "
                         f"max_len {max_len}")
    if cfg.attention == "mla":
        tails = {"c": (cfg.kv_lora_rank,), "kr": (cfg.rope_head_dim,)}
    else:
        nkv = cfg.n_kv_heads // (plan.tp if plan.heads_sharded(cfg) else 1)
        tails = {n: (nkv, cfg.head_dim) for n in ("k", "v")}
    groups = [{n: torch.zeros((g.count, pool_pages, page_size) + tail,
                              dtype=dtype, device=device)
               for n, tail in tails.items()} for g in layer_plan(cfg)]
    return {"groups": groups,
            "length": torch.zeros(batch, dtype=torch.int32, device=device),
            "block_tables": torch.full((batch, max_len // page_size), -1,
                                       dtype=torch.int32, device=device)}


def _cache_for(cfg: ModelConfig, kind: str, count: int, batch: int,
               max_len: int, dtype, device,
               plan: ShardingPlan = NULL_PLAN) -> dict:
    """One layer group's dense per-slot buffers (a recurrent kind: its
    carried state; the local attention: its ring; whisper's decoder also
    the cross-attention's K/V ``xk``/``xv`` over the encoder's frames).
    On a mesh: this rank's rows, its heads when they split, its ``ffn``
    block of the RG-LRU's width."""
    h = cfg.d_model
    f32 = torch.float32
    cut = plan.tp if plan.heads_sharded(cfg) else 1
    if kind in ("dense", "moe", "xdec"):
        if cfg.attention == "mla":
            tails = {"c": (cfg.kv_lora_rank,), "kr": (cfg.rope_head_dim,)}
        else:
            tails = {n: (cfg.n_kv_heads // cut, cfg.head_dim)
                     for n in ("k", "v")}
        shapes = {n: ((max_len,) + t, dtype) for n, t in tails.items()}
        if kind == "xdec":
            x = (cfg.encoder.n_frames, cfg.n_heads // cut, cfg.head_dim)
            shapes.update(xk=(x, dtype), xv=(x, dtype))
    elif kind == "rwkv":
        nh = rwkv_heads(cfg)
        hd = h // nh
        shapes = {"state": ((nh // cut, hd, hd), f32),
                  "x_tm": ((1, h), dtype), "x_cm": ((1, h), dtype)}
    elif kind == "rec":
        w, cw = cfg.lru_width // plan.tp, cfg.conv1d_width
        shapes = {"lru": ((w,), f32), "conv": ((cw - 1, w), dtype)}
    elif kind == "attn":
        W = min(cfg.window_size, max_len) if cfg.window_size else max_len
        kv = (W, cfg.n_kv_heads // cut, cfg.head_dim)
        shapes = {"k": (kv, dtype), "v": (kv, dtype),
                  "kpos": ((W,), torch.int32)}
    else:
        raise KeyError(kind)
    # ring positions start invalid (-1); everything else at zero
    rows = plan.rows(batch)
    return {n: torch.full((count, rows.stop - rows.start) + shape,
                          -1 if dt == torch.int32 else 0, dtype=dt,
                          device=device)
            for n, (shape, dt) in shapes.items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda",
               plan: ShardingPlan = NULL_PLAN):
    """Dense cache: per group ``k``/``v`` ``(count, batch, max_len, nkv,
    hd)`` for GQA (MLA: ``c`` / ``kr``; whisper's decoder also ``xk`` /
    ``xv`` ``(count, batch, n_frames, nq, hd)``; the recurrent kinds their
    state, the local attention its ring; a pattern group one such dict a
    sub-layer, under ``l0``, ``l1``, ...), and a 0-d int32 ``length`` —
    one offset for the whole batch (``serving.kv_cache.make_batched_cache``
    makes it a per-slot vector).  On a mesh each rank holds its block:
    its ``batch / dp`` rows (every row when the batch axes do not divide
    ``batch``), its ``nkv / tp`` (and ``nq / tp``, RWKV6's ``nh / tp``)
    heads when ``plan.heads_sharded``, the RG-LRU's ``lru_width / tp``
    channels; MLA's latent has no head axis and stays whole.  ``length``
    covers every slot."""
    groups = []
    for g in layer_plan(cfg):
        subs = {key: _cache_for(cfg, k, g.count, batch, max_len, dtype,
                                device, plan) for key, k in _sub_groups(g)}
        groups.append(subs if g.kind == "pattern" else subs[None])
    return {"groups": groups,
            "length": torch.zeros((), dtype=torch.int32, device=device)}


# ---------------------------------------------------------------------------
# Sub-layer application
# ---------------------------------------------------------------------------

def _ring_from_prefill(k, v, W: int, s: int):
    """A ring-buffer cache holding the last W of the s fresh rows (slot =
    position % W, chunk-local positions; empty slots -1)."""
    b = k.shape[0]
    if s >= W:
        kc = torch.roll(k[:, s - W:], shifts=s % W, dims=1)
        vc = torch.roll(v[:, s - W:], shifts=s % W, dims=1)
        kpos = torch.roll(torch.arange(s - W, s, dtype=torch.int32,
                                       device=k.device), shifts=s % W)
    else:
        pad = W - s
        kc = torch.cat([k, k.new_zeros(b, pad, *k.shape[2:])], 1)
        vc = torch.cat([v, v.new_zeros(b, pad, *v.shape[2:])], 1)
        kpos = torch.cat([torch.arange(s, dtype=torch.int32,
                                       device=k.device),
                          torch.full((pad,), -1, dtype=torch.int32,
                                     device=k.device)])
    return kc, vc, kpos.expand(b, W)


def _local_attn(p, x, cfg: ModelConfig, c, length,
                plan: ShardingPlan = NULL_PLAN, seq_sharded: bool = False):
    """Sliding-window GQA layer (recurrentgemma) over a ring-buffer cache
    ``c`` (k/v (b, W, nkv, hd), kpos (b, W)), updated in place; None on
    the stateless path.  A prefill (s > 1, one offset for the batch)
    attends over [ring ; fresh rows] with explicit positions, then rebuilds
    the ring from the fresh rows; a decode writes its row at slot
    ``position % W``.  On a mesh the ring holds this rank's rows (and
    heads, when they split)."""
    W = c["k"].shape[1] if c is not None else cfg.window_size
    xn = plan.gather_seq(L.rms_norm(x, p["norm"], cfg.norm_eps),
                         seq_sharded, parallel=plan.heads_sharded(cfg))
    b, s, h = xn.shape
    q = L._proj_heads(xn, p["wq"])
    k = L._proj_heads(xn, p["wk"])
    v = L._proj_heads(xn, p["wv"])
    idx = 0 if c is None else L._local_rows(plan, length)[0]
    positions = L.positions_from(idx, s, x.device)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)

    if c is None:
        out = L.chunked_attention(q, k, v, causal=True,
                                  window=cfg.window_size)
    elif s > 1:      # (chunked) prefill into the ring: one offset
        if not (s >= W or cfg.window_size >= W):
            raise ValueError("chunked prefill requires chunk >= window "
                             "(ring rebuild)")
        # chunk i > 0 must see the previous chunk's ring tail: attend over
        # [ring slots ; fresh chunk] with explicit positions
        kpos_old = c["kpos"][0] if c["kpos"].dim() == 2 else c["kpos"]
        pos_cat = torch.cat([kpos_old, torch.arange(
            s, dtype=torch.int32, device=x.device) + idx])
        out = L.chunked_attention(
            q, torch.cat([c["k"], k.to(c["k"].dtype)], 1),
            torch.cat([c["v"], v.to(c["v"].dtype)], 1), q_offset=idx,
            causal=True, window=cfg.window_size, k_positions=pos_cat)
        kc, vc, kpos = _ring_from_prefill(k, v, W, s)
        # positions are chunk-local in _ring_from_prefill; shift by idx
        c["k"].copy_(kc)
        c["v"].copy_(vc)
        c["kpos"].copy_(torch.where(kpos >= 0, kpos + idx, kpos))
    else:            # decode against the ring (slot = position % W)
        idx_vec = L._per_slot(idx, b, x.device)
        slot = idx % W
        L.write_cache(c["k"], k, slot)
        L.write_cache(c["v"], v, slot)
        L.write_cache(c["kpos"][..., None], idx_vec[:, None, None], slot)
        out = L.decode_attention(q, c["k"], c["v"],
                                 q_positions=L.positions_from(idx, s,
                                                              x.device),
                                 window=cfg.window_size,
                                 k_positions=c["kpos"])
    return L._attn_out(plan, cfg, L._heads_out(out, p["wo"]), seq_sharded)


def _apply_recurrent(kind: str, p, x, c, cfg: ModelConfig, length,
                     plan: ShardingPlan = NULL_PLAN,
                     seq_sharded: bool = False):
    """One residual layer of the recurrent families (rwkv, rec, attn);
    its carried state in ``c`` is updated in place."""
    kw = dict(seq_sharded=seq_sharded)
    if kind == "rwkv":
        t_out, (state, x_tm) = S.rwkv6_time_mix(
            p["tm"], x, cfg, plan, state=None if c is None else c["state"],
            x_prev=None if c is None else c["x_tm"], **kw)
        x = x + t_out
        c_out, x_cm = S.rwkv6_channel_mix(
            p["cm"], x, cfg, plan, x_prev=None if c is None else c["x_cm"],
            **kw)
        x = x + c_out
        new = {"state": state, "x_tm": x_tm, "x_cm": x_cm}
    elif kind == "rec":
        r_out, (lru, conv) = S.rglru_block(
            p["rglru"], x, cfg, plan, state=None if c is None else c["lru"],
            conv_state=None if c is None else c["conv"], **kw)
        x = x + r_out
        x = x + L.mlp(p["mlp"], x, cfg, plan, **kw)
        new = {"lru": lru, "conv": conv}
    elif kind == "attn":
        x = x + _local_attn(p["attn"], x, cfg, c, length, plan, **kw)
        return x + L.mlp(p["mlp"], x, cfg, plan, **kw)
    else:
        raise KeyError(kind)
    if c is not None:
        for n, t in new.items():
            c[n].copy_(t)
    return x


def _cross_attn(p, x, cfg: ModelConfig, xk, xv,
                plan: ShardingPlan = NULL_PLAN, seq_sharded: bool = False):
    """Whisper decoder cross-attention over the encoder's K/V ``xk`` /
    ``xv`` (b, n_frames, nq, hd): bidirectional, the plain body (the
    reference routes it to no kernel).  On a mesh: this rank's rows and
    heads."""
    xn = plan.gather_seq(L.rms_norm(x, p["norm"], cfg.norm_eps),
                         seq_sharded, parallel=plan.heads_sharded(cfg))
    out = L.chunked_attention(L._proj_heads(xn, p["wq"]), xk, xv,
                              causal=False)
    return L._attn_out(plan, cfg, L._heads_out(out, p["wo"]), seq_sharded)


def _apply_xattn(p, x, c, cfg: ModelConfig, enc_out,
                 plan: ShardingPlan = NULL_PLAN, seq_sharded: bool = False):
    """The cross-attention residual of an ``xdec`` layer.  With a cache and
    no ``enc_out`` (a decode) it reads the cached ``xk`` / ``xv``;
    otherwise it projects ``enc_out`` and, with a cache (a prefill),
    copies the fresh K/V into the cache's buffers (the reference returns
    them as the new cache)."""
    if c is not None and enc_out is None:
        xk, xv = c["xk"], c["xv"]
    else:
        if enc_out is None:
            raise ValueError("whisper's stateless forward needs frames "
                             "(forward(frames=...))")
        if plan.heads_sharded(cfg):     # column-parallel on enc_out
            enc_out = plan.copy_in(enc_out)
        xk = L._proj_heads(enc_out, p["wk"])
        xv = L._proj_heads(enc_out, p["wv"])
        if c is not None:
            c["xk"].copy_(xk)
            c["xv"].copy_(xv)
    return x + _cross_attn(p, x, cfg, xk, xv, plan, seq_sharded)


def apply_sublayer(kind: str, p, x, c, *, cfg: ModelConfig,
                   plan: ShardingPlan, positions, length, q_lens,
                   block_tables, with_stats: bool = False,
                   seq_sharded: bool = False, enc_out=None, spec=None):
    """One residual layer.  ``c`` holds this layer's cache buffers (K/V,
    or MLA's latent c/kr; pools when ``block_tables`` is given; a
    recurrent kind's state, the local attention's ring; whisper's
    cross-attention K/V), or None on the stateless path.  ``enc_out``
    (b, n_frames, d) is the encoder's output for an ``xdec`` layer (None:
    read the cached cross K/V).  Returns (x, aux, counts): ``counts`` is
    the per-expert routed-slot vector (zeros for non-MoE layers) when
    ``with_stats``, else None.  The recurrent kinds advance their state by
    every row, so they cannot mask a ragged tail: the unified step
    (``q_lens``) refuses them, as in the reference.  With ``plan.fsdp``
    the layer first gathers its FSDP-cut weights (``spec``: their
    ``models.param.P`` tree; ``ShardingPlan.unshard``)."""
    p = plan.unshard(cfg, p, spec)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    counts = torch.zeros(max(cfg.n_experts, 1), dtype=torch.int32,
                         device=x.device) if with_stats else None
    if q_lens is not None and kind not in ("dense", "moe"):
        raise NotImplementedError(
            f"unified mixed step (q_lens) unsupported for layer kind "
            f"{kind!r} — serve this family through the legacy engine path")
    if kind not in ("dense", "moe", "xdec"):
        return _apply_recurrent(kind, p, x, c, cfg, length, plan,
                                seq_sharded), aux, counts
    if cfg.attention == "mla":
        a_out, _ = L.mla_attention(
            p["attn"], x, cfg, plan,
            cache=None if c is None else (c["c"], c["kr"], length),
            q_lens=q_lens, block_table=block_tables, positions=positions,
            seq_sharded=seq_sharded)
    else:
        kv = None if c is None else L.KVView(c["k"], c["v"], length,
                                             block_tables)
        a_out, _ = L.gqa_attention(p["attn"], x, cfg, plan, cache=kv,
                                   q_lens=q_lens, positions=positions,
                                   seq_sharded=seq_sharded)
    x = x + a_out
    if kind == "xdec":
        x = _apply_xattn(p["xattn"], x, c, cfg, enc_out, plan, seq_sharded)
    if kind == "moe":
        r = MOE.moe_rank(p["moe"], x, cfg, plan, with_stats=with_stats,
                         seq_sharded=seq_sharded)
        m_out, aux = r[0], r[1]
        if with_stats:
            counts = r[2]
        x = x + m_out
    else:
        x = x + L.mlp(p["mlp"], x, cfg, plan, seq_sharded=seq_sharded)
    return x, aux, counts


def _vocab_start(plan: ShardingPlan, n_local: int) -> int:
    """The first vocab row of this rank's block (0 with no TP)."""
    return C.axis_index(plan.mesh, plan.tp_axes) * n_local \
        if plan.tp > 1 else 0


def embed_tokens(table, tokens, cfg: ModelConfig,
                 plan: ShardingPlan = NULL_PLAN):
    """The embedding lookup.  With TP the table is this rank's vocab block:
    rows outside it read zero and the blocks are summed over the TP axes,
    a sum of one row and zeros, so bitwise the whole table's lookup.  The
    tied-embedding scale follows the sum."""
    ids = tokens.long()
    if plan.tp > 1:
        n = table.shape[0]
        if n * plan.tp != cfg.padded_vocab:
            raise ValueError(f"the embedding holds {n} rows; the plan gives "
                             f"each of {plan.tp} TP ranks "
                             f"{cfg.padded_vocab // plan.tp}")
        loc = ids - _vocab_start(plan, n)
        hit = (loc >= 0) & (loc < n)
        x = torch.where(hit[..., None], table[loc.clamp(0, n - 1)],
                        table.new_zeros(()))
        x = C.psum(x, plan.mesh, plan.tp_axes)
    else:
        x = table[ids]
    if cfg.tie_embeddings:
        x = x * math.sqrt(cfg.d_model)
    return x


def lm_head(x, head, cfg: ModelConfig, plan: ShardingPlan = NULL_PLAN, *,
            gather: bool = True):
    """Logits (b, s, padded_vocab) of this rank's rows x (b, s, h).  With
    TP ``head`` is this rank's vocab block; its padding columns are masked
    at their global index, and the blocks are gathered along vocab over
    the TP axes and along batch over the batch axes, so every rank
    returns every row's logits.  ``gather=False`` returns the rank's
    block itself, its rows and vocab columns (the vocab-parallel loss of
    ``training.train_step`` reads it)."""
    logits = x @ head
    v0 = _vocab_start(plan, head.shape[1])
    if cfg.padded_vocab != cfg.vocab_size:   # mask padding columns
        logits[..., max(0, cfg.vocab_size - v0):] = L.NEG_INF
    return gather_logits(logits, plan) if gather else logits


def gather_logits(logits, plan: ShardingPlan = NULL_PLAN):
    """This rank's block of the logits (its rows, its vocab columns)
    gathered whole: along vocab over the TP axes, along batch over the
    batch axes.  Every rank uses the whole logits alike, so its gradient
    of them is whole, and each block's is its own."""
    if plan.tp > 1:
        logits = C.all_gather(logits, plan.mesh, plan.tp_axes, axis=-1,
                              grad="whole")
    if plan.dp > 1:
        logits = C.all_gather(logits, plan.mesh, plan.dp_axes, axis=0,
                              grad="whole")
    return logits


# ---------------------------------------------------------------------------
# Encoder (whisper)
# ---------------------------------------------------------------------------

def encode_audio(params, frames, cfg: ModelConfig,
                 plan: ShardingPlan = NULL_PLAN):
    """frames (b, n_frames, d_enc): the precomputed conv/mel stub
    embeddings.  ``frames + pos``, then per layer: RMS norm,
    bidirectional MHA (the plain body, no kernel, as in the reference),
    the ``wo`` residual, RMS norm, the tanh-GELU MLP residual; then the
    final norm.  The reference's promotion holds: f32 frames on bf16
    weights run the whole encoder in f32 (each weight cast at its use).
    On a mesh: this rank's rows of ``frames``, its heads (when they split)
    and its ``d_ff`` block, each row-parallel product summed over TP; the
    residual stays whole along the frames."""
    p_enc = params["enc"]
    if plan.fsdp:
        p_enc = plan.unshard(cfg, p_enc, model_spec(cfg)["enc"])
    x = frames + p_enc["pos"][None]
    for p in p_enc["layers"]:
        xn = L.rms_norm(x, p["norm"], cfg.norm_eps)
        if plan.heads_sharded(cfg):        # column-parallel heads
            xn = plan.copy_in(xn)
        a = L.chunked_attention(L._proj_heads(xn, p["wq"]),
                                L._proj_heads(xn, p["wk"]),
                                L._proj_heads(xn, p["wv"]), causal=False)
        x = x + L._attn_out(plan, cfg, L._heads_out(a, p["wo"]), False)
        xn = plan.copy_in(L.rms_norm(x, p["mlp_norm"], cfg.norm_eps))
        up = F.gelu(torch.matmul(*L._promoted(xn, p["mlp_in"])),
                    approximate="tanh")
        x = x + plan.reduce_out(torch.matmul(*L._promoted(up,
                                                          p["mlp_out"])),
                                False)
    return L.rms_norm(x, p_enc["final_norm"], cfg.norm_eps)


def _embed_input(params, cfg: ModelConfig, plan: ShardingPlan, tokens,
                 embeds):
    """The input rows: ``embeds`` (the vlm patch stub) rounded to bf16 when
    the config's dtype is bf16, as the reference rounds them, in the
    weights' dtype, then the token embeddings after them."""
    parts = []
    if embeds is not None:
        e = embeds.to(torch.bfloat16) if cfg.dtype == "bfloat16" else embeds
        parts.append(e.to(params["embed"].dtype))
    if tokens is not None:
        parts.append(embed_tokens(params["embed"], tokens, cfg, plan))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Output:
    logits: torch.Tensor
    cache: Optional[dict]
    aux: torch.Tensor          # router load-balance loss (0 for non-MoE)
    # per-expert routed-slot counts summed over MoE layers, (n_experts,)
    # int32 — only populated by forward(expert_stats=True), else None
    expert_counts: Optional[torch.Tensor] = None


def forward(params, cfg: ModelConfig, plan: ShardingPlan = NULL_PLAN, *,
            tokens=None, embeds=None, frames=None, positions=None,
            cache=None, q_lens=None, last_only: bool = False,
            logit_rows=None, expert_stats: bool = False,
            remat: bool = False, local_logits: bool = False) -> Output:
    """The forward pass, in the reference's modes.

    tokens  (b, s_text) int  — None for a pure-embedding input
    embeds  (b, s_front, h)  — the vlm patch-embedding stub, prepended to
                            the token rows (rounded to bf16 when
                            ``cfg.dtype`` is bf16, as the reference does)
    frames  (b, n_frames, d) — the audio frame-embedding stub: whisper runs
                            its encoder on them (a decode without them
                            reads the cached cross-attention K/V)
    positions (b, s) or (b, 3, s) — the rows' positions (default: the
                            cache offset onward; M-RoPE broadcasts them
                            to its three streams)
    cache                 — None: the stateless forward (every row sees the
                            rows before it; returns no cache);
                            ``init_paged_cache``: the unified step (q_lens
                            required);
                            ``init_cache`` / ``make_batched_cache``: the
                            dense per-slot buffers, a uniform prefill or
                            decode at ``length``, or with q_lens the
                            unified step.
                            Its buffers and ``length`` (advanced by q_lens
                            per slot, else by s) are updated IN PLACE and
                            the same dict is returned
    q_lens  (b,) int32    — the unified mixed step: slot i's valid rows are
                            tokens[i, :q_lens[i]] (a prefill chunk, one
                            decode token, or 0 = idle) at its cache offset
                            ``cache["length"][i]``; rows past q_lens[i] are
                            inert padding whose cache writes are dropped
                            (they still flow through the MoE, which keeps
                            routing count-independent)
    last_only             with q_lens: apply the LM head only to each
                          slot's last valid row (q_lens[i] - 1), returning
                          (b, 1, v) logits
    logit_rows  (b, n) int  with last_only: the rows the LM head is applied
                          to instead of q_lens[i] - 1, returning (b, n, v)
                          logits (speculative verify scores one row per
                          draft position this way)
    expert_stats          sum per-expert routed-slot counts over the MoE
                          layers into ``Output.expert_counts``
    remat                 the stateless forward keeps no activations of a
                          decoder layer for the backward but its input, and
                          recomputes the layer there (the reference's
                          ``jax.checkpoint`` of its scanned layer body); the
                          recompute's outputs are discarded, so nothing the
                          forward returns is counted twice
    local_logits          on a mesh, return this rank's block of the
                          logits (its batch rows, its vocab columns) instead
                          of gathering them whole on every rank
                          (``lm_head(gather=False)``)
    """
    if q_lens is not None and cache is None:
        raise ValueError("q_lens (unified mixed step) requires a cache")
    if last_only and q_lens is None:
        raise ValueError("last_only requires q_lens (the unified mixed step)")
    if logit_rows is not None and not last_only:
        raise ValueError("logit_rows requires last_only (it overrides the "
                         "per-slot head-row selection)")
    length = None if cache is None else cache["length"]
    block_tables = None if cache is None else cache.get("block_tables")
    if block_tables is not None and q_lens is None:
        raise ValueError("a paged cache (block_tables) requires the unified "
                         "mixed step (q_lens)")
    # on a mesh: this rank's batch rows of every per-row input (a batch
    # the batch axes do not divide runs whole on every batch rank)
    if tokens is None and embeds is None:
        raise ValueError("forward needs tokens or embeds")
    b_all = (tokens if tokens is not None else embeds).shape[0]
    plan = plan.for_batch(b_all)
    tokens, embeds, frames, len_loc, q_loc, rows_loc = L._local_rows(
        plan, tokens, embeds, frames, length, q_lens, logit_rows)
    if positions is not None and positions.shape[0] == b_all:
        positions = L._local_rows(plan, positions)[0]   # else (1, ...)
    specs = model_spec(cfg) if plan.fsdp else None
    if specs is not None:      # the FSDP-cut leaves outside the layers
        top = [k for k in ("embed", "final_norm", "lm_head") if k in params]
        params = dict(params, **plan.unshard(
            cfg, {k: params[k] for k in top}, {k: specs[k] for k in top}))
    x = _embed_input(params, cfg, plan, tokens, embeds)
    b, s = x.shape[:2]
    seq_sharded = plan.seq_sharded(s)
    x = plan.cut_seq(x, seq_sharded)
    if positions is None:
        positions = L.positions_from(0 if cache is None else len_loc, s,
                                     x.device)
        if cfg.mrope:
            positions = positions[:, None].expand(b, 3, s)
    enc_out = encode_audio(params, frames, cfg, plan) \
        if cfg.family == "audio" and frames is not None else None

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    counts_total = torch.zeros(max(cfg.n_experts, 1), dtype=torch.int32,
                               device=x.device) if expert_stats else None
    for gi, g in enumerate(layer_plan(cfg)):
        bufs = None if cache is None else cache["groups"][gi]
        for li, p_l in enumerate(params["groups"][gi]):
            for key, kind in _sub_groups(g):    # a pattern: l0, l1, ...
                p_k = p_l if key is None else p_l[key]
                b_k = bufs if key is None or bufs is None else bufs[key]
                c_l = None if b_k is None else {n: t[li]
                                                for n, t in b_k.items()}
                spec = None
                if specs is not None:
                    spec = specs["groups"][gi][li]
                    spec = spec if key is None else spec[key]
                layer = functools.partial(
                    apply_sublayer, kind, p_k, cfg=cfg, plan=plan,
                    positions=positions, length=length, q_lens=q_lens,
                    block_tables=block_tables, with_stats=expert_stats,
                    seq_sharded=seq_sharded, enc_out=enc_out, spec=spec)
                if remat and cache is None:
                    # the forward draws no random numbers: no RNG state
                    x, a, cnt = torch.utils.checkpoint.checkpoint(
                        layer, x, None, use_reentrant=False,
                        preserve_rng_state=False)
                else:
                    x, a, cnt = layer(x, c_l)
                aux_total = aux_total + a
                if expert_stats:
                    counts_total = counts_total + cnt

    # the LM head's entry: with the stream cut the gather's backward sums
    # the ranks' shares of the gradient, else copy_in after the norm
    x = plan.gather_seq(x, seq_sharded, parallel=seq_sharded)
    if last_only and rows_loc is not None:   # the rows asked for
        x = x[torch.arange(b, device=x.device)[:, None], rows_loc.long()]
    elif last_only:   # per-slot last valid row; norm/head are per-token ops
        rows = (q_loc.long() - 1).clamp_min(0)
        x = x[torch.arange(b, device=x.device), rows][:, None]
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if not seq_sharded:
        x = plan.copy_in(x)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = lm_head(x, head, cfg, plan, gather=not local_logits)
    if cache is not None:
        length.add_(s if q_lens is None else q_lens)
    return Output(logits=logits, cache=cache, aux=aux_total,
                  expert_counts=counts_total)


__all__ = ["Group", "layer_plan", "model_spec", "sublayer_spec",
           "group_spec", "xattn_spec", "enc_layer_spec", "encode_audio",
           "init_params", "count_params", "init_cache",
           "init_paged_cache", "apply_sublayer", "embed_tokens", "lm_head",
           "gather_logits",
           "forward", "Output"]
