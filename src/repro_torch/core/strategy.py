"""Parallel-strategy grammar and enumeration (paper §III-B1).

The paper defines a context-free grammar over per-Decoder-layer strategies:

    strategy  -> Decoder | Decoder [PP = degree]
    Decoder   -> Attention, MoE
    block     -> intra-node + inter-node | parallel
    intra     -> parallel
    inter     -> parallel
    parallel  -> TP | EP (DP) = degree
    degree    -> 2^k

``enumerate_strategies`` produces every sentence of that grammar that covers
the given cluster: attention = TP x DP, MoE = TP x EP, degrees powers of two,
with (attn_tp * attn_dp) == (moe_tp * moe_ep) == devices_per_stage and
stage_count = d_pp.  Named presets reproduce the paper's baselines (Table II).
"""

from __future__ import annotations

from typing import Iterator

from repro_torch.core.cost_model import CommAlgo, Strategy
from repro_torch.core.topology import ClusterSpec, pow2_divisors


def enumerate_strategies(cluster: ClusterSpec, *, model_is_moe: bool,
                         max_pp: int = 8,
                         comm_algos: tuple[CommAlgo, ...] = ("fused",),
                         ) -> Iterator[Strategy]:
    """Yield every grammar sentence covering ``cluster.n_devices`` chips."""
    n = cluster.n_devices
    for d_pp in pow2_divisors(min(n, max_pp)):
        per_stage = n // d_pp
        if per_stage < 1 or n % d_pp:
            continue
        for attn_tp in pow2_divisors(per_stage):
            attn_dp = per_stage // attn_tp
            moe_opts = pow2_divisors(per_stage) if model_is_moe else [attn_tp]
            for moe_tp in moe_opts:
                moe_ep = per_stage // moe_tp
                if model_is_moe and moe_ep < 1:
                    continue
                # EP group spans nodes iff its size exceeds what fits in the
                # TP-complement of one node.
                ep_inter = moe_ep > max(1, cluster.n_proc // moe_tp)
                algos = comm_algos if (model_is_moe and moe_tp > 1 and moe_ep > 1) \
                    else ("fused",)
                for algo in algos:
                    s = Strategy(attn_tp=attn_tp, attn_dp=attn_dp,
                                 moe_tp=moe_tp, moe_ep=moe_ep, d_pp=d_pp,
                                 comm_algo=algo, ep_inter_node=ep_inter)
                    try:
                        s.validate()
                    except ValueError:
                        continue
                    yield s


# ---------------------------------------------------------------------------
# Named presets — the paper's baselines (Table II) and MixServe's choice.
# ---------------------------------------------------------------------------

def preset(name: str, cluster: ClusterSpec) -> Strategy:
    """Baseline presets; names mirror Table II rows."""
    n_proc, n_node = cluster.n_proc, cluster.n_node
    n = cluster.n_devices
    if name == "vllm_tp_pp":          # vLLM TP=n_proc [PP=n_node]
        return Strategy(attn_tp=n_proc, attn_dp=1, moe_tp=n_proc, moe_ep=1,
                        d_pp=n_node, comm_algo="unfused", ep_inter_node=False)
    if name == "vllm_dp_ep":          # vLLM TP=n_proc + DP=n_node, EP=n
        return Strategy(attn_tp=n_proc, attn_dp=n_node, moe_tp=1, moe_ep=n,
                        d_pp=1, comm_algo="unfused", ep_inter_node=True)
    if name == "vllm_dp_ep_tp4":      # vLLM TP=4 + DP=n/4, EP=n
        return Strategy(attn_tp=4, attn_dp=n // 4, moe_tp=1, moe_ep=n,
                        d_pp=1, comm_algo="unfused", ep_inter_node=True)
    if name == "tutel_tp_ep":         # Tutel TP=n_proc + EP=n_node, unfused
        return Strategy(attn_tp=n_proc, attn_dp=n_node,
                        moe_tp=n_proc, moe_ep=n_node,
                        d_pp=1, comm_algo="unfused", ep_inter_node=True)
    if name == "mixserve":            # hybrid TP-EP + fused AR-A2A
        return Strategy(attn_tp=n_proc, attn_dp=n_node,
                        moe_tp=n_proc, moe_ep=n_node,
                        d_pp=1, comm_algo="fused", ep_inter_node=True)
    if name == "mixserve_sync":       # ablation: same layout, no overlap
        return Strategy(attn_tp=n_proc, attn_dp=n_node,
                        moe_tp=n_proc, moe_ep=n_node,
                        d_pp=1, comm_algo="sync", ep_inter_node=True)
    raise KeyError(f"unknown preset {name!r}")


PRESETS = ("vllm_tp_pp", "vllm_dp_ep", "vllm_dp_ep_tp4", "tutel_tp_ep",
           "mixserve", "mixserve_sync")

__all__ = ["enumerate_strategies", "preset", "PRESETS"]
