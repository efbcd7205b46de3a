"""Decoder for the dense and MoE families (the serving main path).

One ``ModelConfig`` + this module = a runnable model for the families the
port serves so far, each with GQA or MLA attention:
  dense   attention + dense MLP          (smollm-360m, gemma-2b,
                                          minitron-8b, minicpm3-4b, ...)
  moe     attention + dropless MoE       (phi3.5-moe-42b, deepseek-v2-236b)

The reference stacks each homogeneous layer group on a leading axis and
scans it; the port keeps one parameter dict per layer and loops.  Two
caches, as in the reference, each per group with a leading ``count`` axis:
  paged (``init_paged_cache``)  pools ``(count, pool_pages, page, ...)`` —
          K/V ``(..., nkv, hd)`` for GQA, the latent ``c (..., r)`` and
          ``kr (..., rope_head_dim)`` for MLA — plus per-slot ``length``
          and ``block_tables``;
  dense (``init_cache``)        per-slot buffers ``(count, batch, max_len,
          ...)`` and a ``length`` (0-d: one offset for the batch; the
          serving backend makes it per slot).
``forward`` runs the unified mixed prefill/decode step on either, a
uniform prefill or decode on the dense cache, or the stateless forward
(``cache=None``), and updates a cache's buffers and ``length`` IN PLACE.

On a mesh (``plan.enabled``, one process per rank) ``forward`` realises
the reference's GSPMD layout with explicit collectives on the paged cache:
each rank takes its batch rows (the plan's batch axes), looks up its vocab
block of the embedding (summed over the TP axes), runs every layer on its
rows, its heads and its ``d_ff`` / expert slices, carries the residual
stream cut along seq when ``plan.seq_sharded``, and gathers the logits of
its vocab block and batch rows back, so every rank returns the whole
logits.  The dense cache and the stateless forward raise there (ROADMAP
A12).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives as C
from repro_torch.core.partitioner import NULL_PLAN, ShardingPlan
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.param import P, init_tree, stack


# ---------------------------------------------------------------------------
# Layer grouping
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Group:
    kind: str            # dense | moe
    count: int           # layers in the group


_FAMILIES = ("dense", "vlm", "moe")


def layer_plan(cfg: ModelConfig) -> tuple[Group, ...]:
    if cfg.family == "moe":
        g = []
        if cfg.first_dense_layers:
            g.append(Group("dense", cfg.first_dense_layers))
        g.append(Group("moe", cfg.n_layers - cfg.first_dense_layers))
        return tuple(g)
    if cfg.family in _FAMILIES:
        return (Group("dense", cfg.n_layers),)
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet (ROADMAP A10)")


def _check_supported(cfg: ModelConfig) -> None:
    layer_plan(cfg)
    if cfg.attention not in ("gqa", "mla"):
        raise NotImplementedError(
            f"{cfg.attention} attention is not ported yet (ROADMAP A10)")
    if cfg.frontend or cfg.mrope:
        raise NotImplementedError(
            "frontend / M-RoPE models are not ported yet (ROADMAP A10)")


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def sublayer_spec(cfg: ModelConfig, kind: str) -> dict:
    attn = L.mla_spec(cfg) if cfg.attention == "mla" else L.gqa_spec(cfg)
    if kind == "dense":
        return {"attn": attn, "mlp": L.mlp_spec(cfg)}
    if kind == "moe":
        return {"attn": attn, "moe": MOE.moe_spec(cfg)}
    raise KeyError(kind)


def model_spec(cfg: ModelConfig) -> dict:
    _check_supported(cfg)
    h, v = cfg.d_model, cfg.padded_vocab
    spec: dict[str, Any] = {
        "embed": P((v, h), ("vocab", "embed"), scale=0.02),
        "final_norm": P((h,), ("embed",), init="zeros"),
        "groups": [stack(sublayer_spec(cfg, g.kind), g.count)
                   for g in layer_plan(cfg)],
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = P((h, v), ("embed", "vocab"))
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
    _check_supported(cfg)
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
               max_len: int, dtype, device) -> dict:
    """One layer group's dense per-slot buffers."""
    if kind not in ("dense", "moe"):
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported yet (ROADMAP A10)")
    if cfg.attention == "mla":
        tails = {"c": (cfg.kv_lora_rank,), "kr": (cfg.rope_head_dim,)}
    else:
        tails = {n: (cfg.n_kv_heads, cfg.head_dim) for n in ("k", "v")}
    return {n: torch.zeros((count, batch, max_len) + tail, dtype=dtype,
                           device=device) for n, tail in tails.items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda"):
    """Dense KV cache: per group ``k``/``v`` ``(count, batch, max_len, nkv,
    hd)`` for GQA (MLA: ``c`` / ``kr``), and a 0-d int32 ``length`` — one
    offset for the whole batch (``serving.kv_cache.make_batched_cache``
    makes it a per-slot vector)."""
    _check_supported(cfg)
    return {"groups": [_cache_for(cfg, g.kind, g.count, batch, max_len,
                                  dtype, device) for g in layer_plan(cfg)],
            "length": torch.zeros((), dtype=torch.int32, device=device)}


# ---------------------------------------------------------------------------
# Sub-layer application
# ---------------------------------------------------------------------------

def apply_sublayer(kind: str, p, x, c, *, cfg: ModelConfig,
                   plan: ShardingPlan, positions, length, q_lens,
                   block_tables, with_stats: bool = False,
                   seq_sharded: bool = False):
    """One residual layer.  ``c`` holds this layer's cache buffers (K/V,
    or MLA's latent c/kr; pools when ``block_tables`` is given), or None
    on the stateless path.  Returns (x, aux, counts): ``counts`` is the
    per-expert routed-slot vector (zeros for dense layers) when
    ``with_stats``, else None."""
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
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    counts = torch.zeros(max(cfg.n_experts, 1), dtype=torch.int32,
                         device=x.device) if with_stats else None
    if kind == "moe":
        r = MOE.moe_rank(p["moe"], x, cfg, plan, with_stats=with_stats,
                         seq_sharded=seq_sharded)
        m_out, aux = r[0], r[1]
        if with_stats:
            counts = r[2]
        x = x + m_out
    elif kind == "dense":
        x = x + L.mlp(p["mlp"], x, cfg, plan, seq_sharded=seq_sharded)
    else:
        raise KeyError(kind)
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


def lm_head(x, head, cfg: ModelConfig, plan: ShardingPlan = NULL_PLAN):
    """Logits (b, s, padded_vocab) of this rank's rows x (b, s, h).  With
    TP ``head`` is this rank's vocab block; its padding columns are masked
    at their global index, and the blocks are gathered along vocab over
    the TP axes and along batch over the batch axes, so every rank
    returns every row's logits."""
    logits = x @ head
    v0 = _vocab_start(plan, head.shape[1])
    if cfg.padded_vocab != cfg.vocab_size:   # mask padding columns
        logits[..., max(0, cfg.vocab_size - v0):] = L.NEG_INF
    if plan.tp > 1:
        logits = C.all_gather(logits, plan.mesh, plan.tp_axes, axis=-1)
    if plan.dp > 1:
        logits = C.all_gather(logits, plan.mesh, plan.dp_axes, axis=0)
    return logits


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
            tokens, cache=None, q_lens=None, last_only: bool = False,
            logit_rows=None, expert_stats: bool = False) -> Output:
    """The forward pass, in the reference's modes.

    tokens  (b, s) int
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
    if block_tables is None:
        L.single_device(plan, "the forward on a dense cache or none")
        len_loc, q_loc, rows_loc = length, q_lens, logit_rows
    else:
        tokens, len_loc, q_loc = (plan.shard(t, ("batch",))
                                  for t in (tokens, length, q_lens))
        rows_loc = None if logit_rows is None \
            else plan.shard(logit_rows, ("batch",))
    b, s = tokens.shape
    seq_sharded = plan.seq_sharded(s)
    x = plan.cut_seq(embed_tokens(params["embed"], tokens, cfg, plan),
                     seq_sharded)
    positions = L.positions_from(0 if cache is None else len_loc, s,
                                 x.device)

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    counts_total = torch.zeros(max(cfg.n_experts, 1), dtype=torch.int32,
                               device=x.device) if expert_stats else None
    for gi, g in enumerate(layer_plan(cfg)):
        bufs = None if cache is None else cache["groups"][gi]
        for li, p_l in enumerate(params["groups"][gi]):
            c_l = None if bufs is None else {n: t[li]
                                             for n, t in bufs.items()}
            x, a, cnt = apply_sublayer(
                g.kind, p_l, x, c_l, cfg=cfg, plan=plan, positions=positions,
                length=length, q_lens=q_lens, block_tables=block_tables,
                with_stats=expert_stats, seq_sharded=seq_sharded)
            aux_total = aux_total + a
            if expert_stats:
                counts_total = counts_total + cnt

    x = plan.gather_seq(x, seq_sharded)
    if last_only and rows_loc is not None:   # the rows asked for
        x = x[torch.arange(b, device=x.device)[:, None], rows_loc.long()]
    elif last_only:   # per-slot last valid row; norm/head are per-token ops
        rows = (q_loc.long() - 1).clamp_min(0)
        x = x[torch.arange(b, device=x.device), rows][:, None]
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = lm_head(x, head, cfg, plan)
    if cache is not None:
        length.add_(s if q_lens is None else q_lens)
    return Output(logits=logits, cache=cache, aux=aux_total,
                  expert_counts=counts_total)


__all__ = ["Group", "layer_plan", "model_spec", "sublayer_spec",
           "init_params", "count_params", "init_cache", "init_paged_cache",
           "apply_sublayer", "embed_tokens", "lm_head", "forward", "Output"]
