"""Theoretical communication / computation cost model (paper §III-B).

Implements Eqs. (1)-(13):

  Eq. 1-2   AR(size, d) = RS + AG, each moving O(size/d) per round
  Eq. 3     A2A(size, d) = (size/d) * (d-1) rounds  (Pairwise)
  Eq. 4     compute latency  tau ∝ activated-params * tokens / chips
  Eq. 5     per-layer comm latency lambda with the DP/EP trade-off
  Eq. 6     Delta t_svc = l*(tau + lambda) + (d_PP - 1) * P2P
  Eq. 7     M/M/1 queuing delay W_q
  Eq. 8     memory constraint (weights + KV cache < HBM)
  Eq. 9-11  TTFT / ITL / throughput estimators
  Eq. 12    lambda_EP   (pure-EP MoE block; DeepSeek-V3 deployment)
  Eq. 13    lambda_mix  (MixServe hybrid TP-EP, RS-A2A-AG)

All sizes are bytes, all times seconds.  The model is intentionally
alpha-beta style: ``time = latency_rounds * alpha + bytes_on_wire / bw``.

Divergence from the paper (documented in DESIGN.md §2): Eq. 4 is stated as a
proportionality; we instantiate it with the standard 2*N_active*D FLOP count
plus the attention O(s^2) term, which preserves the paper's scaling in
(d_TP, d_EP, d_DP) while giving absolute seconds for the roofline.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

from repro_torch.configs.base import ModelConfig
from repro_torch.core.topology import ClusterSpec

BYTES = 2  # bf16 activations/weights on the wire


# ---------------------------------------------------------------------------
# Collective primitives (Eqs. 1-3, Table I)
# ---------------------------------------------------------------------------

def rs_cost(size: float, degree: int, bw: float, alpha: float) -> float:
    """Reduce-scatter of a ``size``-byte tensor over ``degree`` ranks.

    Table I: communication per round O(size/d), Broadcast algorithm, one
    full-duplex round per peer -> (d-1) rounds of size/d on the wire.
    """
    if degree <= 1:
        return 0.0
    return alpha * (degree - 1) + (size / degree) * (degree - 1) / bw


def ag_cost(size: float, degree: int, bw: float, alpha: float) -> float:
    """All-gather; symmetric to RS (Eq. 1: RS == AG)."""
    return rs_cost(size, degree, bw, alpha)


def ar_cost(size: float, degree: int, bw: float, alpha: float) -> float:
    """All-reduce decomposed as RS + AG (Eq. 2)."""
    return rs_cost(size, degree, bw, alpha) + ag_cost(size, degree, bw, alpha)


def a2a_cost(size: float, degree: int, bw: float, alpha: float) -> float:
    """Pairwise all-to-all (Eq. 3): d-1 rounds, size/d bytes per round.

    ``size`` is the full per-rank payload (what one rank holds before the
    exchange); each of the d-1 remote peers receives size/d of it.
    """
    if degree <= 1:
        return 0.0
    return alpha * (degree - 1) + (size / degree) * (degree - 1) / bw


def p2p_cost(size: float, bw: float, alpha: float) -> float:
    """Point-to-point transfer (PP stage handoff, Eq. 6)."""
    return alpha + size / bw


def tp_link(cluster: ClusterSpec, degree: int) -> tuple[float, float]:
    """(bw, alpha) for a TP collective of the given degree.

    A TP group wider than one node is bottlenecked by the inter-node links —
    this is the Fig. 3 observation that AR-based TP 'generally fails to scale
    effectively across multiple nodes' (TP worse than EP at d=32).
    """
    inter = degree > cluster.n_proc
    return cluster.bw(inter), cluster.latency(inter)


# ---------------------------------------------------------------------------
# Parallel strategy
# ---------------------------------------------------------------------------

# "fused"   = RS-A2A-AG with async intra/inter overlap (the paper's Alg. 1-2)
# "sync"    = RS-A2A-AG executed back-to-back (Fig. 12 sync ablation)
# "unfused" = AR at full width, then full-volume A2A (Tutel-style baseline)
CommAlgo = Literal["fused", "sync", "unfused"]


@dataclasses.dataclass(frozen=True)
class Strategy:
    """A per-Decoder-layer parallel strategy (paper §III-B1 grammar).

    grammar:  strategy -> Decoder [| PP=degree]
              Decoder  -> Attention, MoE
              block    -> intra-node + inter-node | parallel
              parallel -> TP | EP (DP) = degree   (degree = 2^k)

    ``attn_tp``/``attn_dp``: attention block TP (intra) x DP (inter) degrees.
    ``moe_tp``/``moe_ep``:   MoE block TP (intra) x EP (inter) degrees.
    Pure strategies are expressed by setting the other degree to 1 (e.g. pure
    EP is moe_tp=1, moe_ep=n_devices).
    """

    attn_tp: int = 1
    attn_dp: int = 1
    moe_tp: int = 1
    moe_ep: int = 1
    d_pp: int = 1
    comm_algo: CommAlgo = "fused"
    # True when the moe_ep groups span nodes (the usual case we optimize).
    ep_inter_node: bool = True

    @property
    def devices_per_pp_stage(self) -> int:
        return self.attn_tp * self.attn_dp

    @property
    def n_devices(self) -> int:
        return self.devices_per_pp_stage * self.d_pp

    def validate(self) -> None:
        if self.attn_tp * self.attn_dp != self.moe_tp * self.moe_ep:
            raise ValueError(
                f"attention degrees ({self.attn_tp}x{self.attn_dp}) and MoE "
                f"degrees ({self.moe_tp}x{self.moe_ep}) must cover the same "
                "device set within a PP stage")
        for d in (self.attn_tp, self.attn_dp, self.moe_tp, self.moe_ep, self.d_pp):
            if d < 1 or (d & (d - 1)):
                raise ValueError(f"degrees must be powers of two, got {self}")

    def describe(self) -> str:
        parts = [f"TP={self.attn_tp} + DP={self.attn_dp}"]
        if self.moe_tp > 1:
            parts.append(f"TP={self.moe_tp} + EP={self.moe_ep}")
        else:
            parts.append(f"EP={self.moe_ep}")
        s = ", ".join(parts)
        if self.d_pp > 1:
            s += f" [PP={self.d_pp}]"
        return s + f" ({self.comm_algo})"


# ---------------------------------------------------------------------------
# EP-exchange overlap (micro-chunked dispatch/GEMM/combine pipeline)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EpOverlap:
    """Micro-chunked EP-exchange schedule for the dropless MoE path.

    The local token batch is split into ``chunks`` micro-chunks; chunk i's
    dispatch A2A is issued before chunk i-1's grouped GEMM so XLA's async
    scheduler can overlap wire and MXU time, and each chunk's exchange
    buffers are **count-bounded**: a soft per-rank row cap instead of the
    worst-case ``T_chunk*k`` extent, with a bit-exact recompute-at-worst-case
    fallback when a chunk overflows the cap (models.moe).

    ``cap_rows``: per-rank rows per chunk.  ``0`` = the statistical rule
    (mean + ``cap_sigma``·std of uniform multinomial routing, rounded up to
    a multiple of 8); ``-1`` = worst-case extent (count-bounding off);
    ``> 0`` = an explicit row cap.
    """

    chunks: int = 1            # C; 1 = monolithic schedule
    cap_rows: int = 0          # 0 = auto rule, -1 = worst case, >0 explicit
    cap_sigma: float = 4.0     # auto-rule margin over the routing mean

    def __post_init__(self):
        if self.chunks < 1:
            raise ValueError(f"chunks must be >= 1, got {self.chunks}")
        if self.cap_rows < -1:
            raise ValueError(f"cap_rows must be >= -1, got {self.cap_rows}")
        if self.cap_sigma <= 0:
            raise ValueError(f"cap_sigma must be > 0, got {self.cap_sigma}")

    @property
    def off(self) -> bool:
        """True for the monolithic worst-case-extent schedule."""
        return self.chunks <= 1 and self.cap_rows == -1

    def describe(self) -> str:
        if self.off:
            return "off (monolithic worst-case exchange)"
        if self.cap_rows == -1:
            cap = "cap=worst-case"
        elif self.cap_rows > 0:
            cap = f"cap={self.cap_rows} rows/rank"
        else:
            cap = f"cap=auto(mean+{self.cap_sigma:g}sigma)"
        return f"C={self.chunks}, {cap}"


# the monolithic schedule (what the pre-overlap exchange always ran)
EP_OVERLAP_OFF = EpOverlap(chunks=1, cap_rows=-1)


def cap_rows_for(n_chunk: int, ep: int, overlap: EpOverlap) -> int:
    """Static per-destination-rank row cap for one micro-chunk.

    ``n_chunk`` is the chunk's slot count (tokens * top_k).  The auto rule
    prices the cap from the routing distribution: near-uniform multinomial
    routing puts mean = n/ep rows on a rank with std sqrt(n/ep * (1-1/ep));
    ``cap_sigma`` standard deviations of headroom make overflow (and the
    worst-case-extent fallback recompute) rare without paying worst case.
    """
    if ep <= 1 or overlap.cap_rows == -1:
        return n_chunk
    if overlap.cap_rows > 0:
        return max(1, min(overlap.cap_rows, n_chunk))
    mean = n_chunk / ep
    cap = mean + overlap.cap_sigma * math.sqrt(mean * (1.0 - 1.0 / ep))
    cap = -(-int(math.ceil(cap)) // 8) * 8          # round up to 8 rows
    return max(1, min(cap, n_chunk))


# ---------------------------------------------------------------------------
# Workload
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Workload:
    batch: int          # global batch (requests in flight)
    seq_len: int        # tokens processed this step per request (prefill: L_in, decode: 1)
    kv_len: int = 0     # KV cache length (decode); 0 -> seq_len
    arrival_rate: float = 0.0  # requests/s for W_q (Eq. 7)

    @property
    def context(self) -> int:
        return self.kv_len or self.seq_len


# ---------------------------------------------------------------------------
# Eq. 4: computation latency per rank
# ---------------------------------------------------------------------------

MFU = 0.5  # assumed achievable fraction of peak in steady state
GEMM_RAMP_TOKENS = 64  # per-expert batch at which expert GEMMs hit 50% eff


def compute_latency(model: ModelConfig, strat: Strategy, work: Workload,
                    cluster: ClusterSpec) -> float:
    """tau(d_TP, d_EP, d_DP): per-rank per-layer compute latency (Eq. 4).

    Matmul FLOPs = 2 * params_active_per_layer * tokens_per_rank, sharded by
    d_TP (attention+shared) and d_TP*d_EP (routed experts); plus the
    attention score/value FLOPs 4 * tokens * ctx * n_heads * head_dim / d_TP.
    """
    tokens_per_rank = work.batch * work.seq_len / strat.attn_dp

    attn_p = model.attn_params_per_layer()
    attn_flops = 2 * attn_p * tokens_per_rank / strat.attn_tp
    if model.attention != "none":
        attn_flops += (4 * tokens_per_rank * work.context
                       * model.n_heads * model.head_dim / strat.attn_tp)

    if model.is_moe:
        # Routed expert FLOPs per chip (Eq. 4): balanced routing spreads the
        # global token*top_k work over ALL chips of the stage regardless of
        # how (moe_tp, moe_ep, replica groups) tile them — replication under
        # d_DP > d_EP copies WEIGHTS, not work; dropping under d_DP < d_EP
        # removes the redundant copies before compute (Fig. 6c).
        global_tokens = work.batch * work.seq_len
        n_stage = strat.attn_tp * strat.attn_dp
        ffn_flops = 2 * model.expert_params() * model.top_k * global_tokens \
            / n_stage
        shared = 2 * model.n_shared_experts * model.expert_params() * tokens_per_rank
        ffn_flops += shared / strat.moe_tp
        # Expert-GEMM efficiency ramps with per-expert-instance batch (the
        # DeepSeek-V3 argument for wide EP: "each expert processes a
        # sufficiently large batch").  Replicating experts (d_DP > d_EP)
        # halves per-instance tokens and costs efficiency.
        instances = max(1, n_stage // (strat.moe_ep * strat.moe_tp))
        tok_per_expert = global_tokens * model.top_k / (
            max(model.n_experts, 1) * instances)
        gemm_eff = tok_per_expert / (tok_per_expert + GEMM_RAMP_TOKENS)
        ffn_flops = ffn_flops / max(gemm_eff, 1e-2)
    else:
        ffn_flops = 2 * model.dense_ffn_params_per_layer() * tokens_per_rank / strat.attn_tp

    t_flops = (attn_flops + ffn_flops) / (cluster.peak_flops * MFU)

    # ---- memory-bound term (dominates decode): weight + KV-cache reads ----
    w_bytes = model.attn_params_per_layer() / strat.attn_tp * BYTES
    if model.is_moe:
        global_tokens = work.batch * work.seq_len
        local_experts = max(1, model.n_experts // strat.moe_ep)
        touched = min(local_experts,
                      max(1.0, global_tokens * model.top_k
                          / (strat.attn_dp * strat.moe_ep)))
        w_bytes += (touched + model.n_shared_experts) \
            * model.expert_params() / strat.moe_tp * BYTES
    else:
        w_bytes += model.dense_ffn_params_per_layer() / strat.attn_tp * BYTES
    kv_bytes = (work.batch / strat.attn_dp) * work.context \
        * model.kv_bytes_per_token_per_layer()
    t_mem = (w_bytes + kv_bytes) / cluster.hbm_bw

    return max(t_flops, t_mem)


# ---------------------------------------------------------------------------
# Eq. 5 / 12 / 13: communication latency per rank per layer
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective the strategy's per-layer program issues.

    ``kind``:  all_reduce | all_gather | reduce_scatter | all_to_all
    ``axis``:  logical axis group — "tp" (the MoE/attention TP group),
               "ep" (the expert-parallel group), "guard" (tp ∪ ep — the
               rank-uniform overflow predicate of the count-bounded
               exchange), "mesh" (all mesh axes — the aux-loss pmean).
    ``count``: issues per Decoder layer (already multiplied by the
               micro-chunk count C where the op runs once per chunk).
    ``phase``: program position — attn | resync | counts | moe_dispatch |
               moe_expert | moe_combine | moe_epilogue | shared | aux |
               overflow_guard.
    ``bytes``/``degree``/``link``: the alpha-beta pricing inputs
               (``bytes`` is the model-priced payload, NOT the padded
               buffer extent the implementation puts on the wire).
    ``priced``: whether ``comm_latency`` charges this entry.  Unpriced
               entries are metadata-sized (the int32 counts header, the
               scalar aux pmean, the overflow pmax) or deliberately
               outside the Eq. 5/12/13 scope (shared-expert epilogue,
               token-unslice AG) — the census still lists them so the
               trace contract can demand the lowered program contain
               EXACTLY these collectives and no others.
    ``traceable``: visible as a collective primitive in the shard_map
               jaxpr of ``models.moe.moe_block``.  Attention-block ARs
               and layout-resync AGs are inserted by GSPMD *after*
               lowering, so they only exist in compiled HLO — the jaxpr
               census must skip them.
    ``conditional``: issued only on the rare count-bound overflow path
               (inside the ``lax.cond`` worst-case-extent fallback).
    """

    kind: str
    axis: str
    count: int
    phase: str
    bytes: float = 0.0
    degree: int = 1
    link: str = "moe_intra"
    priced: bool = True
    traceable: bool = True
    conditional: bool = False
    note: str = ""


@dataclasses.dataclass(frozen=True)
class CommCensus:
    """The (kind, count, axis) collective list for one strategy.

    This is the single source of truth consumed by BOTH
    ``comm_latency`` (which prices the ``priced`` entries) and the
    reference package's ``analysis.trace_contract`` (which demands the
    jaxpr of the lowered MoE block contain exactly the ``traceable``
    entries) — the
    MixServe claim that the analyzer prices the program XLA actually
    runs, made falsifiable.
    """

    strategy: Strategy
    layout: str          # pure_tp | dp_ep | mixserve | dense
    fused: bool
    token_sliced: bool
    chunks: int
    cap_bounded: bool
    entries: tuple[Collective, ...]

    def counts(self, *, traceable_only: bool = True,
               conditional: bool = False) -> dict[tuple[str, str], int]:
        """Aggregate (kind, axis) -> count map for the contract check."""
        out: dict[tuple[str, str], int] = {}
        for e in self.entries:
            if traceable_only and not e.traceable:
                continue
            if bool(e.conditional) != bool(conditional):
                continue
            key = (e.kind, e.axis)
            out[key] = out.get(key, 0) + e.count
        return out

    def select(self, **field_values) -> tuple[Collective, ...]:
        return tuple(e for e in self.entries
                     if all(getattr(e, f) == v for f, v in field_values.items()))


def _moe_census_entries(*, is_moe: bool, n_shared: int, moe_tp: int,
                        moe_ep: int, attn_tp: int, fused: bool,
                        token_sliced: bool, comm_algo: str, ep_degree: int,
                        size: float, size_ep: float, k: int, chunks: int,
                        cap_bounded: bool) -> list[Collective]:
    """MoE-block collectives exactly as ``models.moe`` emits them.

    Mirrors ``_moe_shard_dropless_fn`` (the default dropless dispatch)
    branch-for-branch; the trace contract asserts the mirror never drifts.
    """
    ent: list[Collective] = []
    if not is_moe:
        return ent
    C = max(1, chunks)

    if moe_ep <= 1:
        # ep==1 branch: local dropless pipeline + TP partial-sum reduction.
        if moe_tp > 1 and not token_sliced:
            ent.append(Collective("all_reduce", "tp", 1, "moe_expert",
                                  bytes=size, degree=moe_tp,
                                  note="psum of TP-partial expert outputs"))
        if token_sliced and moe_tp > 1:
            ent.append(Collective("all_gather", "tp", 1, "moe_epilogue",
                                  degree=moe_tp, priced=False,
                                  note="token-axis unslice"))
        if n_shared and moe_tp > 1:
            ent.append(Collective("all_reduce", "tp", 1, "shared",
                                  degree=moe_tp, priced=False,
                                  note="shared-expert TP partials"))
        return ent

    # ---- EP exchange (ep > 1): counts A2A + count-bounded dispatch ----
    ent.append(Collective("all_to_all", "ep", C, "counts",
                          degree=ep_degree, priced=False,
                          note="(ep, e_local) int32 slot counts"))
    if fused:
        # Alg. 1-2 fused RS-A2A-AG: the A2A rides 1/tp-sharded hidden
        # states (Eq. 13), an AG restores full width before the expert
        # GEMMs, the combine reduce-scatters back to 1/tp.
        ent += [
            Collective("all_to_all", "ep", C, "moe_dispatch",
                       bytes=size * k / moe_tp, degree=ep_degree, link="ep",
                       note="dispatch A2A on 1/tp-sharded tokens"),
            Collective("all_gather", "tp", C, "moe_dispatch",
                       bytes=size * k, degree=moe_tp,
                       note="restore full hidden width (Alg. 2)"),
            Collective("reduce_scatter", "tp", C, "moe_combine",
                       bytes=size * k, degree=moe_tp,
                       note="reduce TP-partial expert outputs (Alg. 1)"),
            Collective("all_to_all", "ep", C, "moe_combine",
                       bytes=size * k / moe_tp, degree=ep_degree, link="ep",
                       note="combine A2A on 1/tp-sharded outputs"),
            Collective("all_gather", "tp", 1, "moe_epilogue",
                       bytes=size, degree=moe_tp,
                       note="single epilogue AG of the weighted sum"),
        ]
        if n_shared:
            ent.append(Collective("reduce_scatter", "tp", 1, "shared",
                                  degree=moe_tp, priced=False,
                                  note="shared partials fold into the "
                                       "1/tp-sharded stream pre-epilogue-AG"))
    else:
        ent.append(Collective("all_to_all", "ep", C, "moe_dispatch",
                              bytes=size_ep * k, degree=ep_degree, link="ep",
                              note="full-width dispatch A2A (Eq. 12)"))
        if moe_tp > 1 and not token_sliced:
            ent.append(Collective("all_reduce", "tp", C, "moe_expert",
                                  bytes=size, degree=moe_tp,
                                  note="Tutel-style full-width TP AR"))
        ent.append(Collective("all_to_all", "ep", C, "moe_combine",
                              bytes=size_ep * k, degree=ep_degree, link="ep",
                              note="full-width combine A2A"))
        body_tp = moe_tp if moe_tp > 1 else attn_tp
        if token_sliced and body_tp > 1:
            ent.append(Collective("all_gather", "tp", 1, "moe_epilogue",
                                  degree=body_tp, priced=False,
                                  note="token-axis unslice (dp_ep layout)"))
        if n_shared and body_tp > 1:
            ent.append(Collective("all_reduce", "tp", 1, "shared",
                                  degree=body_tp, priced=False,
                                  note="shared-expert TP partials"))

    if cap_bounded:
        # Count-bounded exchange: rank-uniform overflow predicate, plus the
        # bit-exact worst-case-extent fallback inside lax.cond (the counts
        # A2A is NOT redone — counts are cap-independent).
        ent.append(Collective("all_reduce", "guard", C, "overflow_guard",
                              priced=False,
                              note="pmax of per-segment max over tp ∪ ep"))
        cond = [Collective("all_to_all", "ep", C, "moe_dispatch",
                           priced=False, conditional=True),
                Collective("all_to_all", "ep", C, "moe_combine",
                           priced=False, conditional=True)]
        if fused:
            cond += [Collective("all_gather", "tp", C, "moe_dispatch",
                                priced=False, conditional=True),
                     Collective("reduce_scatter", "tp", C, "moe_combine",
                                priced=False, conditional=True)]
        elif moe_tp > 1 and not token_sliced:
            cond.append(Collective("all_reduce", "tp", C, "moe_expert",
                                   priced=False, conditional=True))
        ent += cond
    return ent


def comm_census(model: ModelConfig, strat: Strategy, work: Workload, *,
                ep_overlap: EpOverlap | None = None,
                tokens_local: int | None = None) -> CommCensus:
    """The per-Decoder-layer collective census for ``strat``.

    Returns every collective the strategy's program issues per layer —
    kind, logical axis, count, phase — with the alpha-beta pricing inputs
    attached to the entries ``comm_latency`` charges.  The structure
    mirrors the dropless ``models.moe`` implementation (the default
    dispatch path) plus the GSPMD-side attention collectives.

    ``ep_overlap`` expands the counts to the micro-chunked count-bounded
    schedule (C issues of the per-chunk collectives, the overflow guard,
    and the conditional worst-case fallback).  ``tokens_local`` — the
    per-EP-rank token count the traced program will see — pins the chunk
    count C = gcd(chunks, tokens_local) and the cap decision exactly;
    without it the census estimates both from ``work``.
    """
    is_moe = model.is_moe
    n_shared = model.n_shared_experts if is_moe else 0
    # Layout resolution mirrors partitioner.make_plan's Strategy mapping:
    # moe_tp>1 & moe_ep>1 -> mixserve; moe_ep>1 -> dp_ep (token-sliced pure
    # EP, comm_algo forced "unfused"); else pure TP.
    if not is_moe:
        layout = "dense"
    elif strat.moe_ep <= 1:
        layout = "pure_tp"
    elif strat.moe_tp <= 1:
        layout = "dp_ep"
    else:
        layout = "mixserve"
    token_sliced = layout == "dp_ep" and strat.attn_tp > 1
    comm_algo = "unfused" if token_sliced else strat.comm_algo
    fused = (comm_algo in ("fused", "sync") and strat.moe_tp > 1
             and strat.moe_ep > 1 and not token_sliced)

    # Pricing sizes (Eq. 5 / 12 / 13 — see comm_latency for the link model).
    tokens = work.batch * work.seq_len / max(strat.attn_dp, strat.moe_ep)
    size = tokens * model.d_model * BYTES
    ep_degree = min(strat.moe_ep, strat.attn_dp) if strat.attn_dp > 1 \
        else strat.moe_ep
    if layout == "dp_ep":
        # pure EP (vLLM DP+EP): every device is its own token group — the
        # A2A runs at degree d_EP on bs/d_EP tokens (no Fig. 6c dropping).
        tok_ep = work.batch * work.seq_len / strat.moe_ep
        size_ep = tok_ep * model.d_model * BYTES
        ep_degree = strat.moe_ep
    else:
        size_ep = size

    # Micro-chunk schedule: C and the cap decision, pinned by tokens_local
    # when the caller knows the traced program's local token count.
    chunks, cap_bounded = 1, False
    if (ep_overlap is not None and strat.moe_ep > 1
            and not (ep_overlap.chunks <= 1 and ep_overlap.cap_rows == -1)):
        if tokens_local is None:
            est = work.batch * work.seq_len / max(strat.moe_ep, 1)
            if token_sliced and strat.attn_tp > 1:
                est /= strat.attn_tp
            tokens_local = max(1, int(est))
        chunks = math.gcd(ep_overlap.chunks, tokens_local) \
            if ep_overlap.chunks > 1 else 1
        n_c = (tokens_local // chunks) * max(1, model.top_k)
        cap_bounded = cap_rows_for(n_c, strat.moe_ep, ep_overlap) < n_c

    entries: list[Collective] = []
    tokens_attn = work.batch * work.seq_len / strat.attn_dp
    size_attn = tokens_attn * model.d_model * BYTES
    if strat.attn_tp > 1:
        # Attention block TP: 2 ARs per layer (attn out + [dense] ffn out
        # share the residual stream; Eq. 5 counts 2 x AR).  GSPMD inserts
        # these during SPMD partitioning -> not visible in the moe jaxpr.
        entries.append(Collective("all_reduce", "tp", 2, "attn",
                                  bytes=size_attn, degree=strat.attn_tp,
                                  link="attn", traceable=False))
    entries += _moe_census_entries(
        is_moe=is_moe, n_shared=n_shared, moe_tp=strat.moe_tp,
        moe_ep=strat.moe_ep, attn_tp=strat.attn_tp, fused=fused,
        token_sliced=token_sliced, comm_algo=comm_algo, ep_degree=ep_degree,
        size=size, size_ep=size_ep, k=max(1, model.top_k), chunks=chunks,
        cap_bounded=cap_bounded)
    if is_moe:
        # aux-loss pmean over every mesh axis (replicated out_spec).
        entries.append(Collective("all_reduce", "mesh", 1, "aux",
                                  priced=False, note="scalar aux-loss pmean"))
        if strat.attn_tp != strat.moe_tp and strat.moe_tp > 1:
            # layout resync between the attention TP group and the MoE TP
            # group (hidden states re-gathered on entry + exit) — GSPMD-side.
            entries.append(Collective(
                "all_gather", "tp", 2, "resync", bytes=size_attn,
                degree=max(strat.attn_tp, strat.moe_tp), link="resync",
                traceable=False))
    return CommCensus(strategy=strat, layout=layout, fused=fused,
                      token_sliced=token_sliced, chunks=chunks,
                      cap_bounded=cap_bounded, entries=tuple(entries))


def _routed_expert_seconds(model: ModelConfig, strat: Strategy,
                           work: Workload, cluster: ClusterSpec) -> float:
    """Per-rank routed-expert GEMM seconds (the Eq. 4 routed term alone).

    This is the compute the micro-chunked pipeline can overlap against the
    EP exchange: same sharding/efficiency model as ``compute_latency``'s
    MoE branch, restricted to the routed experts (shared experts and
    attention run outside the dispatch-FFN-combine window).
    """
    if not model.is_moe or model.top_k < 1:
        return 0.0
    global_tokens = work.batch * work.seq_len
    n_stage = strat.attn_tp * strat.attn_dp
    ffn_flops = 2 * model.expert_params() * model.top_k * global_tokens \
        / n_stage
    instances = max(1, n_stage // (strat.moe_ep * strat.moe_tp))
    tok_per_expert = global_tokens * model.top_k / (
        max(model.n_experts, 1) * instances)
    gemm_eff = tok_per_expert / (tok_per_expert + GEMM_RAMP_TOKENS)
    return ffn_flops / max(gemm_eff, 1e-2) / (cluster.peak_flops * MFU)


def moe_overlap_lambda(lam_moe: float, tau_expert: float, overlap: EpOverlap,
                       chunk_alpha: float = 0.0) -> float:
    """Visible MoE comm under the micro-chunked pipeline.

    With C micro-chunks, chunk i's dispatch A2A runs concurrently with
    chunk i-1's grouped GEMM and chunk i-2's combine A2A, so the pipelined
    makespan is max(lam, tau) + (lam + tau)/C for the fill/drain chunks
    instead of lam + tau.  Expressed as an *effective comm* term (so
    ``service_latency`` keeps adding tau separately):

        lam_eff = lam - (1 - 1/C) * min(lam, tau) + (C - 1) * chunk_alpha

    C=1 reproduces the serial sum; comm-bound (lam > tau) hides tau of
    wire time behind compute; compute-bound hides (almost) all of lam.
    ``chunk_alpha`` is the fixed launch latency each extra chunk's pair of
    A2As pays (the Eq. 3 alpha rounds do not shrink with payload) — it is
    what bounds the useful chunk count from above.
    """
    C = overlap.chunks
    if C <= 1:
        return lam_moe
    return (lam_moe - (1.0 - 1.0 / C) * min(lam_moe, tau_expert)
            + (C - 1) * chunk_alpha)


_COST_FN = {"all_reduce": ar_cost, "all_gather": ag_cost,
            "reduce_scatter": rs_cost, "all_to_all": a2a_cost}


def _census_links(strat: Strategy, cluster: ClusterSpec) -> dict:
    """(bw, alpha) per census link class (Fig. 3 / Fig. 6 link model).

    ``attn``: the attention TP fabric, with contention when several
    attention TP groups share one node.  ``moe_intra``: ditto for the MoE
    TP group.  ``ep``: the EP-exchange links, divided across the
    d_DP/d_EP parallel A2A groups that CONTEND for the same inter-node
    links (Fig. 6b).  ``resync``: the intra-node layout-resync AG.
    """
    bw_attn, a_attn = tp_link(cluster, strat.attn_tp)
    if 1 < strat.attn_tp < cluster.n_proc:
        bw_attn = bw_attn * strat.attn_tp / cluster.n_proc
    bw_moe, a_moe = tp_link(cluster, strat.moe_tp)
    if strat.moe_tp < cluster.n_proc:
        bw_moe = bw_moe * strat.moe_tp / cluster.n_proc
    inter = strat.ep_inter_node
    bw_ep, a_ep = cluster.bw(inter), cluster.latency(inter)
    if inter:
        n_groups = max(1, strat.attn_dp // max(strat.moe_ep, 1))
        bw_ep = bw_ep / n_groups
    return {"attn": (bw_attn, a_attn), "moe_intra": (bw_moe, a_moe),
            "ep": (bw_ep, a_ep), "resync": (cluster.intra_node_bw, a_attn)}


def _price(e: Collective, links: dict) -> float:
    bw, alpha = links["attn" if e.phase == "attn"
                      else "resync" if e.phase == "resync" else e.link]
    return e.count * _COST_FN[e.kind](e.bytes, e.degree, bw, alpha)


def comm_latency(model: ModelConfig, strat: Strategy, work: Workload,
                 cluster: ClusterSpec, *,
                 ep_overlap: EpOverlap | None = None) -> float:
    """lambda(d_TP, d_EP, d_DP): per-rank per-layer comm latency (Eq. 5).

    Prices the ``comm_census`` entry list — the same (kind, count, axis)
    collectives the trace contract checks against the lowered program —
    with the Eq. 1-3 alpha-beta costs and the Eq. 13 schedule:

    unfused:  AR(bsh, tp)  then  2 x A2A(bshk, ep)   at FULL hidden width
    fused:    RS-A2A-AG — the A2A operates on hidden states already sharded
              1/tp, so inter-node volume drops by 1/tp (Eq. 13); with
              ``comm_algo == 'fused'`` intra- and inter-node rounds overlap
              (Fig. 9) so each phase's wall time is max(inter, intra), plus
              the serial epilogue AG.

    ``ep_overlap``: price the micro-chunked dispatch/GEMM/combine pipeline
    (models.moe) instead of the serial sum-of-phases exchange.
    """
    census = comm_census(model, strat, work)   # monolithic (C=1) structure
    links = _census_links(strat, cluster)

    lam = sum(_price(e, links) for e in census.entries
              if e.priced and e.phase in ("attn", "resync"))

    moe = [e for e in census.entries
           if e.priced and e.phase.startswith("moe_")]
    if moe:
        if census.fused and strat.comm_algo == "fused":
            # Fig. 9: pairwise inter-node rounds overlap the intra-node
            # RS/AG rounds; wall time ~ max(inter, intra) per phase +
            # epilogue.
            phase_cost = {"moe_dispatch": 0.0, "moe_combine": 0.0,
                          "moe_epilogue": 0.0}
            for e in moe:
                p = _price(e, links)
                if e.phase == "moe_epilogue":
                    phase_cost[e.phase] += p
                else:
                    phase_cost[e.phase] = max(phase_cost[e.phase], p)
            lam_moe = sum(phase_cost.values())
        else:
            lam_moe = sum(_price(e, links) for e in moe)
        if (ep_overlap is not None and ep_overlap.chunks > 1
                and strat.moe_ep > 1):
            tau_e = _routed_expert_seconds(model, strat, work, cluster)
            # each extra chunk pays the payload-independent alpha rounds of
            # its own dispatch + combine A2A (pairwise: ep_degree - 1 rounds)
            a_ep = cluster.latency(strat.ep_inter_node)
            ep_degree = min(strat.moe_ep, strat.attn_dp) \
                if strat.attn_dp > 1 else strat.moe_ep
            chunk_alpha = 2 * a_ep * max(ep_degree - 1, 1)
            lam_moe = moe_overlap_lambda(lam_moe, tau_e, ep_overlap,
                                         chunk_alpha)
        lam += lam_moe
    return lam


def lambda_pure_ep(model: ModelConfig, strat: Strategy, work: Workload,
                   cluster: ClusterSpec) -> float:
    """Eq. 12: DeepSeek-V3-style deployment, MoE block fully EP."""
    tokens = work.batch * work.seq_len / strat.attn_dp
    size = tokens * model.d_model * BYTES
    k = max(1, model.top_k)
    return (ar_cost(size, strat.attn_tp, cluster.intra_node_bw,
                    cluster.intra_node_latency)
            + 2 * a2a_cost(size * k, strat.moe_ep,
                           cluster.bw(True), cluster.latency(True)))


# ---------------------------------------------------------------------------
# Eqs. 6-11: service latency, queuing, indicators
# ---------------------------------------------------------------------------

def service_latency(model: ModelConfig, strat: Strategy, work: Workload,
                    cluster: ClusterSpec, *,
                    ep_overlap: EpOverlap | None = None) -> float:
    """Delta t_svc (Eq. 6)."""
    tau = compute_latency(model, strat, work, cluster)
    lam = comm_latency(model, strat, work, cluster, ep_overlap=ep_overlap)
    t = model.n_layers * (tau + lam)
    if strat.d_pp > 1:
        tokens = work.batch * work.seq_len / strat.attn_dp
        size = tokens * model.d_model * BYTES
        t += (strat.d_pp - 1) * p2p_cost(size, cluster.bw(True),
                                         cluster.latency(True))
    return t


def queuing_delay(service_time: float, arrival_rate: float) -> float:
    """M/M/1 W_q (Eq. 7).  Returns inf when unstable (rho >= 1)."""
    if arrival_rate <= 0:
        return 0.0
    mu = 1.0 / service_time
    if arrival_rate >= mu:
        return math.inf
    return arrival_rate / (mu * (mu - arrival_rate))


@dataclasses.dataclass(frozen=True)
class Indicators:
    ttft: float
    itl: float
    throughput: float  # tokens/s (Eq. 11)
    w_q: float
    stable: bool


def indicators(model: ModelConfig, strat: Strategy, cluster: ClusterSpec, *,
               batch: int, l_in: int, l_out: int,
               arrival_rate: float = 0.0,
               ep_overlap: EpOverlap | None = None) -> Indicators:
    """TTFT (Eq. 9), ITL (Eq. 10), throughput Theta (Eq. 11).

    The M/M/1 service rate is batch-level: one continuous-batching "wave"
    serves ``batch`` requests in (prefill + l_out decode steps).  When the
    arrival rate exceeds that (rho >= 1) the system runs SATURATED — we then
    report W_q = 0 and the saturation throughput (what a loadgen measures on
    an overdriven server, which is how Fig. 10's throughput is collected),
    flagging ``stable=False``.
    """
    prf = service_latency(model, strat,
                          Workload(batch=batch, seq_len=l_in), cluster,
                          ep_overlap=ep_overlap)
    dec = service_latency(model, strat,
                          Workload(batch=batch, seq_len=1, kv_len=l_in + l_out),
                          cluster, ep_overlap=ep_overlap)
    t_request = (prf + l_out * dec) / max(batch, 1)
    w_q = queuing_delay(t_request, arrival_rate)
    stable = math.isfinite(w_q)
    if not stable:
        w_q = 0.0
    ttft = w_q + prf
    denom = w_q + prf + l_out * dec
    thr = batch * (l_in + l_out) / denom
    return Indicators(ttft=ttft, itl=dec, throughput=thr, w_q=w_q,
                      stable=stable)


# ---------------------------------------------------------------------------
# Speculative decoding: expected committed tokens per verify step
# ---------------------------------------------------------------------------

def spec_tokens_per_step(k: int, accept: float) -> float:
    """E[committed tokens] of one k-draft greedy-verify step.

    Acceptance is modeled i.i.d. per draft position with rate ``accept``:
    the step commits 1 + X tokens where X ~ min(Geometric misses, k), so
    E = sum_{j=0..k} accept^j = (1 - accept^(k+1)) / (1 - accept).  k=0 is
    plain decode (exactly 1 token); accept=1 commits all k+1 rows."""
    if k <= 0:
        return 1.0
    a = min(max(accept, 0.0), 1.0)
    if a >= 1.0:
        return float(k + 1)
    return (1.0 - a ** (k + 1)) / (1.0 - a)


def speculation_itl(t_verify: float, t_draft: float, k: int,
                    accept: float) -> float:
    """Effective inter-token latency of speculative decode: one verify step
    (Eq. 4-6 at seq_len = 1+k) plus k draft proposals, amortized over the
    expected committed tokens.  With k=0 this is just ``t_verify``."""
    return (t_verify + max(k, 0) * t_draft) / spec_tokens_per_step(k, accept)


# ---------------------------------------------------------------------------
# Eq. 8: memory constraint
# ---------------------------------------------------------------------------

def memory_per_device(model: ModelConfig, strat: Strategy, *,
                      batch: int, seq_len: int,
                      bytes_per_el: int = BYTES) -> float:
    """LHS of Eq. 8: weights + KV cache bytes on one chip."""
    attn_total = model.n_layers * model.attn_params_per_layer()
    n_moe_layers = (model.n_layers - model.first_dense_layers) if model.is_moe else 0
    n_dense = model.n_layers - n_moe_layers
    dense_total = n_dense * model.dense_ffn_params_per_layer()
    moe_routed = n_moe_layers * model.n_experts * model.expert_params()
    moe_shared = n_moe_layers * (model.n_shared_experts * model.expert_params()
                                 + model.d_model * model.n_experts)
    embed = model.d_model * model.vocab_size * (1 if model.tie_embeddings else 2)

    w = (attn_total + dense_total + moe_shared) / strat.attn_tp
    w += moe_routed / (strat.moe_ep * strat.moe_tp)
    w += embed / strat.attn_tp
    w /= strat.d_pp

    kv = (batch / strat.attn_dp) * seq_len * model.n_layers \
        * model.kv_bytes_per_token_per_layer(bytes_per_el) / strat.d_pp
    # MQA/GQA KV is replicated when n_kv_heads < attn_tp; approximate by not
    # dividing KV by TP (conservative — vLLM does the same for MQA).
    return (w * bytes_per_el) + kv


def fits_memory(model: ModelConfig, strat: Strategy, cluster: ClusterSpec, *,
                batch: int, seq_len: int) -> bool:
    return memory_per_device(model, strat, batch=batch, seq_len=seq_len) \
        < cluster.hbm_bytes


__all__ = [
    "BYTES", "MFU", "Strategy", "Workload", "Indicators",
    "EpOverlap", "EP_OVERLAP_OFF", "cap_rows_for", "moe_overlap_lambda",
    "rs_cost", "ag_cost", "ar_cost", "a2a_cost", "p2p_cost",
    "Collective", "CommCensus", "comm_census",
    "compute_latency", "comm_latency", "lambda_pure_ep",
    "service_latency", "queuing_delay", "indicators",
    "memory_per_device", "fits_memory",
    "spec_tokens_per_step", "speculation_itl",
]
