"""Automatic analyzer (paper §III-A offline stage, §III-B).

Consumes model hyperparameters + cluster spec (+ workload), enumerates the
strategy grammar, scores every feasible candidate with the theoretical cost
model, applies the Eq. 8 memory constraint, and returns the ranked list.

This is the "offline stage" of MixServe: its output feeds the partitioner
(weight sharding specs) and the launcher (mesh/axis layout).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core import cost_model as cm
from repro_torch.core.strategy import enumerate_strategies
from repro_torch.core.topology import ClusterSpec

Objective = Literal["ttft", "itl", "throughput", "balanced"]


@dataclasses.dataclass(frozen=True)
class Candidate:
    strategy: cm.Strategy
    ind: cm.Indicators
    mem_bytes: float
    feasible: bool

    def score(self, objective: Objective) -> float:
        """Lower is better.  Saturated-but-feasible candidates compete on
        their saturation indicators (stable=False only zeroes W_q)."""
        if not self.feasible:
            return math.inf
        if objective == "ttft":
            return self.ind.ttft
        if objective == "itl":
            return self.ind.itl
        if objective == "throughput":
            return -self.ind.throughput
        # balanced: normalized geometric blend, the default serving objective
        return self.ind.ttft * self.ind.itl / max(self.ind.throughput, 1e-9)


@dataclasses.dataclass(frozen=True)
class AnalyzerReport:
    best: Candidate
    ranked: tuple[Candidate, ...]
    objective: Objective

    def describe(self, top: int = 5) -> str:
        lines = [f"objective={self.objective}  candidates={len(self.ranked)}"]
        for c in self.ranked[:top]:
            lines.append(
                f"  {c.strategy.describe():<44s} ttft={c.ind.ttft*1e3:8.2f}ms "
                f"itl={c.ind.itl*1e3:7.2f}ms thr={c.ind.throughput:9.1f}tok/s "
                f"mem={c.mem_bytes/1e9:6.1f}GB {'OK' if c.feasible else 'OOM'}")
        return "\n".join(lines)


def evaluate(model: ModelConfig, strat: cm.Strategy, cluster: ClusterSpec, *,
             batch: int, l_in: int, l_out: int,
             arrival_rate: float = 0.0,
             ep_overlap: Optional[cm.EpOverlap] = None) -> Candidate:
    ind = cm.indicators(model, strat, cluster, batch=batch, l_in=l_in,
                        l_out=l_out, arrival_rate=arrival_rate,
                        ep_overlap=ep_overlap)
    mem = cm.memory_per_device(model, strat, batch=batch, seq_len=l_in + l_out)
    # MoE experts must be integrally assignable to EP ranks.
    feasible = mem < cluster.hbm_bytes
    if model.is_moe and strat.moe_ep > model.n_experts:
        feasible = False
    if model.n_heads and strat.attn_tp > max(model.n_heads, 1):
        feasible = False
    if strat.attn_dp > batch:      # DP ranks beyond in-flight requests idle
        feasible = False
    return Candidate(strategy=strat, ind=ind, mem_bytes=mem, feasible=feasible)


def select(model: ModelConfig, cluster: ClusterSpec, *,
           batch: int = 16, l_in: int = 1024, l_out: int = 256,
           arrival_rate: float = 0.0, objective: Objective = "balanced",
           max_pp: int = 8,
           comm_algos: tuple[cm.CommAlgo, ...] = ("fused", "unfused"),
           ep_overlap: Optional[cm.EpOverlap] = None,
           ) -> AnalyzerReport:
    """The automatic analyzer: enumerate, score, rank, pick.

    ``ep_overlap``: price every candidate's MoE exchange with the
    micro-chunked pipeline estimate (stops penalizing EP degrees whose
    A2A the overlapped schedule can hide behind expert compute).
    """
    cands = []
    for strat in enumerate_strategies(cluster, model_is_moe=model.is_moe,
                                      max_pp=max_pp, comm_algos=comm_algos):
        cands.append(evaluate(model, strat, cluster, batch=batch, l_in=l_in,
                              l_out=l_out, arrival_rate=arrival_rate,
                              ep_overlap=ep_overlap))
    if not cands:
        raise RuntimeError("strategy grammar produced no candidates")
    ranked = tuple(sorted(cands, key=lambda c: c.score(objective)))
    return AnalyzerReport(best=ranked[0], ranked=ranked, objective=objective)


def select_strategy(model: ModelConfig, cluster: ClusterSpec,
                    **kw) -> cm.Strategy:
    return select(model, cluster, **kw).best.strategy


__all__ = ["Candidate", "AnalyzerReport", "evaluate", "select",
           "select_strategy", "Objective"]
