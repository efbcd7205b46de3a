"""Knob resolution for the declarative serving API (ServeSpec "auto" fields).

The paper's headline is *automatic*: model + cluster in, serving system
configured out (§III-A/B).  ``repro_torch.serving.api.ServeSpec`` is the
declarative surface; THIS module is where each ``"auto"`` field becomes a
concrete value, derived from the offline analyzer / theoretical cost model
instead of user homework:

  cluster       explicit ClusterSpec / name (validated against the mesh) or
                the H100 cluster of the mesh's size (``h100x1`` without a
                mesh, ``h100-2x2`` for four ranks, ``h100-<N>`` for N a
                multiple of 8)
  strategy      ``analyzer.select`` on the §III-B1 grammar, mapped to a
                ShardingPlan layout name (hybrid "mixserve" vs pure-EP
                "dp_ep", with the expert-divisibility guard)
  max_batch     largest power-of-two batch the Eq. 8 memory constraint
                admits on the target cluster (capped — engine slots, not
                cluster-wide batch)
  chunk         largest prefill chunk whose co-scheduled cost keeps the
                mixed step's ITL inflation under ``ITL_SLACK`` — Sarathi's
                chunk rule instantiated with the Eq. 4-6 token-time
                estimates (replaces the hardcoded 16)
  token_budget  max_batch decode tokens + one prefill chunk per unified
                iteration (replaces the B*chunk default, which let every
                slot prefill at once and spike ITL)
  max_len       the workload envelope l_in + l_out (+ frontend tokens),
                rounded up to the cache-row granule
  overload      bounded admission queue: cap = a wait-time bound divided by
                the Eq. 4-6 predicted per-request service time, plus the
                shed policy (deadline-infeasible-first) — priced
                *degradation*, not just priced performance
  kv            paged-KV layout; the 16-token page constant, degraded to
                a divisor of max_len
  ep_overlap    micro-chunked dispatch/GEMM/combine pipeline for the MoE
                EP exchange (models.moe): chunk count picked by pricing
                the overlapped schedule (moe_overlap_lambda) per candidate
                C, count-bounded buffers on by default
  speculation   draft length k for speculative decoding on the unified
                step: candidates priced by the Eq. 4-6 verify-step time
                against the expected committed tokens/step at the
                acceptance prior (cost_model.spec_tokens_per_step); the
                engine's measured acceptance EMA gates it at runtime

The ``AUTO_BATCH_CAP`` / ``ITL_SLACK`` / ``KV_PAGE_SIZE`` constants are
the analytic defaults, reported with ``default(...)`` provenance.  The port
has no autotune cache yet, so nothing here reads or writes a file.

Everything here is deterministic: same (spec, model, cluster) in, same
resolved knobs out.  No serving imports — ``serving.api`` composes these
helpers.
"""

from __future__ import annotations

import dataclasses
from typing import Union

from repro_torch.configs.base import ModelConfig
from repro_torch.core import cost_model as cm
from repro_torch.core.topology import (CLUSTERS, H100_2X2, H100_NODE,
                                      H100_X1, ClusterSpec, h100_cluster)

AUTO = "auto"

# auto-chunk: prefill tokens riding a decode step may inflate it by at most
# this fraction (Sarathi's ITL-bounded chunking, priced by the cost model)
ITL_SLACK = 0.5
CHUNK_CANDIDATES = (4, 8, 16, 32, 64)
# auto max_batch: engine slots on ONE host; Eq. 8 bounds it from above,
# this caps it from sanity (a CPU dev host is not a pod)
AUTO_BATCH_CAP = 8
# max_len is allocated in cache-row granules
LEN_GRANULE = 64
# auto overload: the bounded admission queue holds at most this many
# seconds of predicted work (queue cap = bound / est. per-request service
# time) — generous so light traffic never sheds, finite so overload
# degrades to bounded latency instead of unbounded queueing
OVERLOAD_WAIT_BOUND_S = 30.0
_SHED_POLICIES = ("reject-newest", "deadline-first")


# ---------------------------------------------------------------------------
# Resolver constants (analytic defaults; the port has no autotune cache)
# ---------------------------------------------------------------------------

def resolved_batch_cap() -> tuple[int, str]:
    """(engine-slot sanity cap, provenance): the ``AUTO_BATCH_CAP``
    analytic default."""
    return AUTO_BATCH_CAP, f"default({AUTO_BATCH_CAP})"


def resolved_itl_slack() -> tuple[float, str]:
    """(auto-chunk ITL-inflation bound, provenance): the ``ITL_SLACK``
    analytic default."""
    return ITL_SLACK, f"default({ITL_SLACK:.0%})"


def resolve_cluster(cluster: Union[str, ClusterSpec, None] = None, *,
                    mesh=None) -> tuple[ClusterSpec, str]:
    """(ClusterSpec, provenance).  Explicit name/spec wins, validated
    against ``mesh.size`` when a mesh is given; ``auto``/None is the H100
    cluster of the mesh's size: ``h100x1`` with no mesh or one rank,
    ``h100-2x2`` for four ranks, ``h100-<N>`` (``topology.h100_cluster``,
    nodes of 8 cards) for N ranks, N a multiple of 8."""
    if cluster is None or cluster == AUTO:
        if mesh is None:
            return H100_X1, "auto:default(h100x1)"
        for spec in (H100_X1, H100_2X2):
            if spec.n_devices == mesh.size:
                return spec, f"auto:mesh({mesh.size} ranks)"
        if mesh.size % H100_NODE == 0:
            return h100_cluster(mesh.size), f"auto:mesh({mesh.size} ranks)"
        raise ValueError(f"no H100 cluster of {mesh.size} devices is "
                         "defined (1, 4 or a multiple of 8); pass a "
                         "ClusterSpec of the mesh's size")
    if isinstance(cluster, str):
        if cluster not in CLUSTERS:
            raise KeyError(f"unknown cluster {cluster!r} "
                           f"(have {sorted(CLUSTERS)})")
        spec = CLUSTERS[cluster]
    else:
        spec = cluster
    if mesh is not None and spec.n_devices != mesh.size:
        raise ValueError(
            f"cluster {spec.name!r} has {spec.n_devices} devices but the "
            f"mesh has {mesh.size} — pass a matching ClusterSpec")
    return spec, "explicit"


def plan_name_for(cfg: ModelConfig, strat: cm.Strategy,
                  n_devices: int) -> str:
    """Map an analyzer Strategy onto a ShardingPlan layout name.

    The winning strategy maps to the hybrid ("mixserve") layout when its
    MoE block uses TP > 1, else to pure-EP — with a divisibility guard:
    pure-EP needs n_experts % n_devices == 0, otherwise the hybrid layout
    is the only implementable choice on this mesh (the deepseek-v2 case:
    160 experts on 256 chips).
    """
    name = "mixserve" if strat.moe_tp > 1 or not cfg.is_moe else "dp_ep"
    if name == "dp_ep" and cfg.n_experts % max(n_devices, 1) != 0:
        name = "mixserve"
    return name


def auto_max_batch(cfg: ModelConfig, strat: cm.Strategy,
                   cluster: ClusterSpec, *, l_in: int, l_out: int,
                   cap: Union[int, None] = None) -> tuple[int, str]:
    """Largest power-of-two batch under the Eq. 8 memory constraint.

    The sanity cap defaults to the measured per-host calibration
    (``resolved_batch_cap``), falling back to ``AUTO_BATCH_CAP``."""
    if cap is None:
        cap, cap_src = resolved_batch_cap()
    else:
        cap_src = "explicit"
    b = 1
    while b * 2 <= cap and cm.memory_per_device(
            cfg, strat, batch=b * 2, seq_len=l_in + l_out) < cluster.hbm_bytes:
        b *= 2
    return b, (f"auto:cost-model(Eq. 8 memory on {cluster.name}, "
               f"cap {cap} [{cap_src}])")


def token_times(cfg: ModelConfig, strat: cm.Strategy, cluster: ClusterSpec,
                *, batch: int, l_in: int, l_out: int) -> tuple[float, float]:
    """(per-prefill-token latency, decode-step latency) — Eq. 4-6."""
    prf = cm.service_latency(
        cfg, strat, cm.Workload(batch=batch, seq_len=l_in), cluster)
    dec = cm.service_latency(
        cfg, strat, cm.Workload(batch=batch, seq_len=1, kv_len=l_in + l_out),
        cluster)
    return prf / max(batch * l_in, 1), dec


def auto_chunk(cfg: ModelConfig, strat: cm.Strategy, cluster: ClusterSpec, *,
               batch: int, l_in: int, l_out: int,
               slack: Union[float, None] = None) -> tuple[int, str]:
    """Largest chunk whose prefill tokens inflate a decode step <= slack.

    A prefill chunk of c tokens co-scheduled with the decode batch adds
    ~``c * t_prefill_token`` to the unified step; Sarathi's rule bounds the
    resulting ITL inflation.  Candidates above the workload's prompt length
    are pointless (the (B, chunk) buffer is static) and skipped.  The slack
    bound defaults to the measured per-host calibration
    (``resolved_itl_slack``), falling back to ``ITL_SLACK``.
    """
    if slack is None:
        slack, slack_src = resolved_itl_slack()
    else:
        slack_src = "explicit"
    t_tok, t_dec = token_times(cfg, strat, cluster, batch=batch,
                               l_in=l_in, l_out=l_out)
    chunk = CHUNK_CANDIDATES[0]
    for c in CHUNK_CANDIDATES:
        if c > max(l_in, CHUNK_CANDIDATES[0]):
            break
        if c * t_tok <= slack * t_dec:
            chunk = c
    return chunk, (f"auto:cost-model({chunk} prefill tok <= "
                   f"{slack:.0%} [{slack_src}] of a "
                   f"{t_dec*1e3:.2f}ms decode step)")


def auto_token_budget(max_batch: int, chunk: int,
                      spec_k: int = 0) -> tuple[int, str]:
    """Decode-first budget: every slot's decode token + ONE prefill chunk
    per unified iteration (the cost-model-bounded prefill rate), replacing
    the B*chunk default that let every slot prefill at once.  With
    speculative decoding each decode slot may ride k extra draft rows, so
    the budget grows to ``max_batch * (1 + k)`` decode-side rows — the
    prefill chunk stays funded even when every slot speculates."""
    per_slot = 1 + max(int(spec_k), 0)
    budget = max_batch * per_slot + chunk
    if spec_k <= 0:
        return budget, (f"auto:cost-model({max_batch} decode tokens "
                        f"+ one {chunk}-token prefill chunk)")
    return budget, (f"auto:cost-model({max_batch} slots x (1+k={spec_k}) "
                    f"verify rows + one {chunk}-token prefill chunk)")


@dataclasses.dataclass(frozen=True)
class OverloadPolicy:
    """Bounded-admission policy: how the scheduler degrades under pressure.

    ``queue_cap`` bounds the admission queue; on overflow ``shed`` picks
    the victim — "reject-newest" drops the incoming request,
    "deadline-first" prefers a queued request whose deadline is already
    infeasible against ``est_request_s`` (the cost model's Eq. 4-6
    prediction of one request's service time), falling back to
    reject-newest when every queued deadline is still feasible.
    """

    queue_cap: int
    shed: str = "reject-newest"
    est_request_s: float = 0.0        # predicted per-request service time

    def __post_init__(self):
        if self.queue_cap < 1:
            raise ValueError(f"queue_cap must be >= 1, got {self.queue_cap}")
        if self.shed not in _SHED_POLICIES:
            raise ValueError(f"shed must be one of {_SHED_POLICIES}, "
                             f"got {self.shed!r}")

    def describe(self) -> str:
        est = f", est {self.est_request_s*1e3:.1f}ms/req" \
            if self.est_request_s else ""
        return f"queue_cap={self.queue_cap} shed={self.shed}{est}"


def auto_overload(cfg: ModelConfig, strat: cm.Strategy, cluster: ClusterSpec,
                  *, batch: int, l_in: int, l_out: int,
                  wait_bound_s: float = OVERLOAD_WAIT_BOUND_S
                  ) -> tuple[OverloadPolicy, str]:
    """Queue cap from the Eq. 4-6 token-time estimates: admit at most
    ``wait_bound_s`` seconds of predicted work, so worst-case queue wait is
    bounded by construction.  Shed policy is deadline-first — requests that
    cannot meet their SLO anyway are the cheapest work to drop."""
    t_tok, t_dec = token_times(cfg, strat, cluster, batch=batch,
                               l_in=l_in, l_out=l_out)
    # one request ~ its prefill + its decode steps, amortized over the batch
    est = (l_in * t_tok * batch + l_out * t_dec) / max(batch, 1)
    cap = max(2 * batch, int(wait_bound_s / max(est, 1e-6)))
    cap = min(cap, 100_000)           # finite even for microscopic models
    policy = OverloadPolicy(queue_cap=cap, shed="deadline-first",
                            est_request_s=est)
    return policy, (f"auto:cost-model({wait_bound_s:.0f}s wait bound / "
                    f"{est*1e3:.2f}ms predicted per request)")


def auto_max_len(l_in: int, l_out: int, front: int = 0,
                 granule: int = LEN_GRANULE) -> tuple[int, str]:
    """Cache rows for the workload envelope, rounded to the granule."""
    need = max(front + l_in + l_out, 1)
    n = -(-need // granule) * granule
    return n, (f"auto:workload({front} frontend + {l_in} prompt + "
               f"{l_out} new tokens, {granule}-row granule)")


# paged KV: tokens per fixed-size cache page (the block-table granule).
# Must divide max_len; auto_kv degrades to the largest power-of-two divisor.
KV_PAGE_SIZE = 16
_KV_BACKENDS = ("dense", "paged")


@dataclasses.dataclass(frozen=True)
class KVConfig:
    """KV-cache layout policy: how the engine stores per-slot KV state.

    ``dense`` is the per-slot ``(B, max_len, ...)`` buffer; ``paged`` is
    block/page indirection — fixed ``page_size``-token pages in a global
    ``pool_pages``-page pool, a per-slot block table, and (when
    ``prefix_cache``) a radix index that lets requests sharing a prompt
    prefix reference the same pages (docs/kv_cache.md).  ``pool_pages == 0``
    means "auto": the resolver sizes the pool from the Eq. 8 workload
    envelope instead of the dense worst case.
    """

    backend: str = "paged"
    page_size: int = KV_PAGE_SIZE
    pool_pages: int = 0               # 0 = auto (resolver fills from Eq. 8)
    prefix_cache: bool = True

    def __post_init__(self):
        if self.backend not in _KV_BACKENDS:
            raise ValueError(f"kv backend must be one of {_KV_BACKENDS}, "
                             f"got {self.backend!r}")
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.pool_pages < 0:
            raise ValueError(f"pool_pages must be >= 0, got {self.pool_pages}")

    def describe(self) -> str:
        if self.backend == "dense":
            return "dense"
        pc = "on" if self.prefix_cache else "off"
        return (f"paged(page={self.page_size}, pool={self.pool_pages}p, "
                f"prefix_cache={pc})")


def kv_bytes_per_token(cfg: ModelConfig, dtype_bytes: int = 2) -> int:
    """KV bytes one cached token costs across all layers (the Eq. 8
    per-token memory term): MLA caches the compressed latent + rope key,
    GQA caches k/v heads."""
    if getattr(cfg, "attention", "gqa") == "mla":
        per = cfg.kv_lora_rank + cfg.rope_head_dim
    else:
        per = 2 * cfg.n_kv_heads * cfg.head_dim
    return cfg.n_layers * per * dtype_bytes


def auto_kv(cfg: ModelConfig, *, max_batch: int, max_len: int, l_in: int,
            l_out: int, front: int = 0, paged_ok: bool = True,
            backend: Union[str, None] = None, page_size: Union[int, None] = None,
            pool_pages: int = 0, prefix_cache: Union[bool, None] = None
            ) -> tuple[KVConfig, str]:
    """Resolve the ``kv`` knob: backend, page size, pool size, prefix cache.

    Explicit values (``backend``/``page_size``/``pool_pages``/
    ``prefix_cache``) pass through; auto fills the rest.  The pool is sized
    from the Eq. 8 memory bound instantiated on the workload envelope —
    ``max_batch`` concurrent requests each holding ``front + l_in + l_out``
    tokens of KV — instead of the dense worst case ``max_batch * max_len``,
    which is what makes paging a capacity lever (pages the envelope does
    not need stay free for more slots or longer prompts; exhaustion
    degrades to cache-preserving preemption, not OOM).
    """
    if backend is None and not paged_ok:
        return (KVConfig(backend="dense"),
                "auto:family(legacy blocking path keeps the dense cache)")
    if backend == "dense":
        return KVConfig(backend="dense"), "explicit"
    # page size: explicit > analytic constant — then degraded to divide
    # max_len (block tables address max_len//page rows, so a non-dividing
    # page would orphan the tail)
    if page_size:
        ps, ps_src = page_size, "explicit"
    else:
        ps, ps_src = KV_PAGE_SIZE, f"default({KV_PAGE_SIZE})"
    while ps > 1 and max_len % ps:
        ps //= 2
    dense_pages = max_batch * (max_len // ps)
    if pool_pages:
        pool = pool_pages
    else:
        envelope = max(front + l_in + l_out, 1)
        per_slot = -(-envelope // ps)
        # floor: one slot must always be able to reach max_len
        pool = max(max_batch * per_slot, max_len // ps)
        pool = min(pool, dense_pages)
    pc = True if prefix_cache is None else prefix_cache
    kv = KVConfig(backend="paged", page_size=ps, pool_pages=pool,
                  prefix_cache=pc)
    src = "explicit" if backend == "paged" else "auto"
    bpt = kv_bytes_per_token(cfg)
    return kv, (f"{src}:cost-model(Eq. 8 envelope {front}+{l_in}+{l_out} tok "
                f"x {max_batch} slots @ {bpt}B/tok -> {pool} pages vs "
                f"{dense_pages} dense; page {ps} from {ps_src})")


# auto speculation: candidate draft lengths priced by the Eq. 4-6 verify
# step (seq_len = 1+k) against the expected committed tokens/step at the
# acceptance prior; the draft's own cost is modeled as a fraction of a
# decode step per proposed token (an n-gram draft is ~free, a reduced-model
# draft is not — the fraction is deliberately conservative).
SPEC_K_CANDIDATES = (0, 1, 2, 4)
SPEC_ACCEPT_PRIOR = 0.7
SPEC_DRAFT_COST_FRAC = 0.05
_DRAFT_SOURCES = ("ngram", "self", "mtp")


@dataclasses.dataclass(frozen=True)
class SpeculationConfig:
    """Speculative-decoding policy: how many tokens to draft and from what.

    ``k`` draft tokens ride each speculating slot's verify row block
    (q_len = k+1 on the unified step).  ``draft`` names the source:
    "ngram" (prompt-suffix matching, free), "self" (the serving model
    drafts for itself — an acceptance-1.0 oracle for tests), "mtp" (the
    DeepSeek-style multi-token-prediction head stub), or any config name
    from ``repro_torch.configs`` run reduced as a draft model.  The engine
    pauses speculation when its measured acceptance EMA (smoothing
    ``ema_alpha``) falls below ``min_accept``, re-probing every
    ``probe_every`` steps so a workload shift can re-enable it.
    """

    k: int
    draft: str = "ngram"
    ngram: int = 3                    # n-gram draft: match length + 1
    min_accept: float = 0.25          # EMA gate: below this, stop drafting
    ema_alpha: float = 0.1            # acceptance EMA smoothing
    probe_every: int = 16             # re-probe cadence while gated off

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"speculation k must be >= 1, got {self.k}")
        if self.ngram < 2:
            raise ValueError(f"ngram must be >= 2, got {self.ngram}")
        if not 0.0 <= self.min_accept <= 1.0:
            raise ValueError(f"min_accept must be in [0, 1], "
                             f"got {self.min_accept}")
        if not 0.0 < self.ema_alpha <= 1.0:
            raise ValueError(f"ema_alpha must be in (0, 1], "
                             f"got {self.ema_alpha}")
        if self.probe_every < 1:
            raise ValueError(f"probe_every must be >= 1, "
                             f"got {self.probe_every}")

    def describe(self) -> str:
        return (f"k={self.k} draft={self.draft} "
                f"gate>={self.min_accept:g}(ema a={self.ema_alpha:g})")


def auto_speculation(cfg: ModelConfig, strat: cm.Strategy,
                     cluster: ClusterSpec, *, batch: int, l_in: int,
                     l_out: int, chunk: int, temperature: float = 0.0,
                     unified_ok: bool = True,
                     value: Union[str, int, SpeculationConfig, None] = AUTO,
                     accept_ema: Union[float, None] = None,
                     ) -> tuple[Union[SpeculationConfig, None], str]:
    """Resolve the ``speculation`` knob: (SpeculationConfig or None, why).

    ``"off"``/None disables drafting.  An int pins k (clamped to chunk-1 —
    the verify rows must fit one slot's chunk).  A SpeculationConfig passes
    through (k clamped the same way).  ``"auto"`` prices each candidate k:
    the verify step costs the Eq. 4-6 latency of a seq_len = 1+k step plus
    k draft proposals at ``SPEC_DRAFT_COST_FRAC`` of a decode step, and
    commits ``cm.spec_tokens_per_step(k, a)`` tokens in expectation at
    acceptance ``a`` (the engine's measured EMA when given, else the
    ``SPEC_ACCEPT_PRIOR``).  Greedy-only: sampling (temperature > 0) and
    the legacy blocking path resolve to off — or raise when speculation
    was explicitly requested.
    """
    if value is None or value == "off":
        return None, "explicit:off(non-speculative decode)"
    explicit = value != AUTO
    if temperature > 0.0:
        if explicit:
            raise ValueError("speculation requires greedy decoding "
                             f"(temperature=0), got {temperature}")
        return None, "auto:off(sampling — greedy verify only)"
    if not unified_ok:
        if explicit:
            raise ValueError("speculation requires the unified ragged step "
                             "(model family unsupported)")
        return None, "auto:off(legacy blocking path has no ragged verify)"
    k_cap = max(int(chunk) - 1, 0)
    if k_cap < 1:
        if explicit:
            raise ValueError(f"speculation needs chunk >= 2 for k+1 verify "
                             f"rows, got chunk={chunk}")
        return None, f"auto:off(chunk={chunk} leaves no draft rows)"
    if isinstance(value, SpeculationConfig):
        sc = value if value.k <= k_cap else dataclasses.replace(
            value, k=k_cap)
        note = "" if value.k <= k_cap else f", k clamped to chunk-1={k_cap}"
        return sc, f"explicit({sc.describe()}{note})"
    if explicit:
        k = int(value)
        if k < 1:
            raise ValueError(f"speculation k must be >= 1, got {k}")
        sc = SpeculationConfig(k=min(k, k_cap))
        note = "" if k <= k_cap else f", clamped to chunk-1={k_cap}"
        return sc, f"explicit(k={sc.k}{note})"

    a = accept_ema if accept_ema is not None else SPEC_ACCEPT_PRIOR
    kv = l_in + l_out

    def itl_eff(k: int) -> float:
        t_ver = cm.service_latency(
            cfg, strat, cm.Workload(batch=batch, seq_len=1 + k, kv_len=kv),
            cluster)
        t_dec = cm.service_latency(
            cfg, strat, cm.Workload(batch=batch, seq_len=1, kv_len=kv),
            cluster)
        return cm.speculation_itl(t_ver, SPEC_DRAFT_COST_FRAC * t_dec, k, a)

    best_k, best_t = 0, None
    for k in SPEC_K_CANDIDATES:
        if k > k_cap:
            continue
        t = itl_eff(k)
        if best_t is None or t < best_t:
            best_k, best_t = k, t
    base_t = itl_eff(0)
    if best_k < 1:
        return None, (f"auto:cost-model(k=0 wins at accept={a:.2f} — the "
                      f"1+k verify step outprices the amortized exchange "
                      f"on {cluster.name})")
    sc = SpeculationConfig(k=best_k)
    exp_tok = cm.spec_tokens_per_step(best_k, a)
    return sc, (f"auto:cost-model(k={best_k}: E[{exp_tok:.2f} tok/step] at "
                f"accept={a:.2f} -> {base_t / best_t:.2f}x ITL vs k=0 on "
                f"{cluster.name}; draft={sc.draft})")


# auto ep_overlap: candidate micro-chunk counts priced by the overlapped
# schedule estimate (per-chunk alpha overhead bounds the useful C)
EP_OVERLAP_CANDIDATES = (1, 2, 4, 8)


def auto_ep_overlap(cfg: ModelConfig, strat: cm.Strategy,
                    cluster: ClusterSpec, *, batch: int, l_in: int,
                    l_out: int,
                    value: Union[str, int, cm.EpOverlap, None] = AUTO
                    ) -> tuple[Union[cm.EpOverlap, None], str]:
    """Resolve the ``ep_overlap`` knob: (EpOverlap or None, provenance).

    ``"off"``/None keeps the monolithic worst-case-extent exchange (plan
    field stays None).  An int pins the chunk count (auto cap).  An
    EpOverlap passes through.  ``"auto"`` prices each candidate chunk count
    with the overlapped-schedule comm estimate (``cm.moe_overlap_lambda``
    via ``cm.service_latency``) on the workload envelope and keeps the
    cheapest — including C=1, where count-bounding alone still shrinks the
    exchange extent.  Dense models and EP-free strategies resolve to off:
    there is no EP exchange to hide.
    """
    if value is None or value == "off":
        return None, "explicit:off(monolithic worst-case exchange)"
    if isinstance(value, cm.EpOverlap):
        return value, f"explicit({value.describe()})"
    if not cfg.is_moe or strat.moe_ep <= 1:
        return None, ("auto:strategy(ep=1 — no EP exchange to hide)"
                      if cfg.is_moe else
                      "auto:model(dense — no EP exchange)")
    if value != AUTO:
        c = int(value)
        if c < 1:
            raise ValueError(f"ep_overlap chunks must be >= 1, got {c}")
        return cm.EpOverlap(chunks=c), f"explicit(C={c}, auto cap)"

    def step_s(ovl: cm.EpOverlap) -> float:
        prf = cm.service_latency(
            cfg, strat, cm.Workload(batch=batch, seq_len=l_in), cluster,
            ep_overlap=ovl)
        dec = cm.service_latency(
            cfg, strat,
            cm.Workload(batch=batch, seq_len=1, kv_len=l_in + l_out),
            cluster, ep_overlap=ovl)
        return prf + l_out * dec

    best_c, best_t = 1, None
    for c in EP_OVERLAP_CANDIDATES:
        t = step_s(cm.EpOverlap(chunks=c))
        if best_t is None or t < best_t:
            best_c, best_t = c, t
    base_t = step_s(cm.EpOverlap(chunks=1))
    hidden_ms = max(base_t - best_t, 0.0) * 1e3
    ovl = cm.EpOverlap(chunks=best_c)
    return ovl, (f"auto:cost-model(C={best_c} hides {hidden_ms:.2f}ms of EP "
                 f"A2A per request on {cluster.name}; cap="
                 f"mean+{ovl.cap_sigma:g}sigma rows/rank)")


__all__ = ["AUTO", "ITL_SLACK", "CHUNK_CANDIDATES", "AUTO_BATCH_CAP",
           "LEN_GRANULE", "OVERLOAD_WAIT_BOUND_S", "KV_PAGE_SIZE",
           "EP_OVERLAP_CANDIDATES", "SPEC_K_CANDIDATES", "SPEC_ACCEPT_PRIOR",
           "SPEC_DRAFT_COST_FRAC", "OverloadPolicy", "KVConfig",
           "SpeculationConfig", "kv_bytes_per_token",
           "auto_kv", "auto_ep_overlap", "auto_speculation",
           "resolve_cluster", "plan_name_for", "auto_max_batch",
           "token_times", "auto_chunk", "auto_token_budget", "auto_overload",
           "auto_max_len", "resolved_batch_cap",
           "resolved_itl_slack"]
