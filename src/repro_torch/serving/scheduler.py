"""Token-budget request scheduler: priority admission + Sarathi-style mixed
continuous batching, with bounded-latency degradation under pressure.

Implements the serving-side of the paper's §III-B4 latency model: requests
arrive stochastically (arrival_rate), queue (the W_q term), are admitted into
engine slots, and per-request TTFT / ITL / throughput are measured — the same
indicators Eqs. 9-11 estimate theoretically.  ``summarize`` reports both so
benchmarks can compare measured vs modeled.

Each iteration of ``run``:

1. **deadline enforcement** — RUNNING slots whose deadline passed are freed
   mid-decode (state CANCELLED, counted as deadline misses); queued
   requests whose deadline already expired are shed before wasting a slot.
2. **admission** — due arrivals are admitted highest-priority-first (FIFO
   within a priority).  The queue is *bounded* by the resolved
   ``ServeSpec.overload`` policy (queue cap + shed rule priced by the cost
   model's Eq. 4-6 token-time estimates): when it overflows, the engine
   degrades to bounded-latency shedding instead of unbounded queueing.
   When a due request outranks every free slot, the lowest-priority slot
   is **preempted** (recompute-on-resume: its generated tokens become a
   prompt suffix and it re-queues — ``Engine.preempt``).
3. **one engine step** under the resolved token budget (decode-first).

A **no-progress watchdog** turns silent busy-spins (an un-admittable
request, an engine returning empty q_lens forever) into a diagnosable
``StalledEngineError`` instead of looping to ``max_steps``.  Injected
faults (``ServeSpec.faults``) surface here too: admission faults shed
exactly the targeted request, clock-skew faults shift this scheduler's
clock, latency spikes ride the engine step.

``run(max_steps=...)`` never drops in-flight work silently: requests still
queued or mid-generation at exit are counted in
``ServeMetrics.n_incomplete``, and ``metrics()`` is well-defined with zero
finished requests.  ``ServeMetrics`` carries the robustness counters
(shed/preempt/cancel/deadline-miss/fault) surfaced in ``row()`` and the
``BENCH_serve_mixed`` meta.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Iterable, Optional

import numpy as np

from repro_torch.core.resolve import OverloadPolicy
from repro_torch.serving.engine import Engine, Request, RequestState
from repro_torch.serving.faults import InjectedFault

# pure-host iterations with zero progress before the watchdog trips — far
# above anything a healthy loop produces, cheap to reach when truly stuck
WATCHDOG_STALL_STEPS = 256


class StalledEngineError(RuntimeError):
    """The serving loop made no progress for WATCHDOG_STALL_STEPS
    iterations: nothing admitted, no tokens processed, nothing retired."""


@dataclasses.dataclass
class ServeMetrics:
    n_requests: int
    ttft_mean: float
    ttft_p99: float
    itl_mean: float
    itl_p99: float
    throughput_tok_s: float      # total tokens (in+out) / wall time
    queue_wait_mean: float
    wall_time: float
    n_incomplete: int = 0        # admitted-or-queued but unfinished at exit
    # robustness counters (graceful-degradation bookkeeping)
    n_shed: int = 0              # rejected by the bounded admission queue
    n_preempted: int = 0         # priority evictions (recompute-on-resume)
    n_cancelled: int = 0         # user cancellations
    n_deadline_miss: int = 0     # deadline-expired kills (queued + running)
    n_faults: int = 0            # NaN/Inf-quarantined slots
    deadline_miss_p99: float = 0.0   # p99 lateness of deadline-carrying
    #                                  requests (0 = every deadline met)
    # KV-cache efficiency (docs/kv_cache.md; dense backend: hits stay 0)
    kv_occupancy: float = 0.0    # PEAK fraction of KV capacity in use
    n_prefix_hits: int = 0       # admissions that reused shared pages
    prefix_hit_tokens: int = 0   # prompt tokens served from shared pages
    n_evictions: int = 0         # prefix-index pages evicted under pressure
    # expert-load skew + EP-exchange ledger (MoE only; docs/dispatch.md).
    # max/mean is the skew the count-bounded A2A buffers must absorb; the
    # byte ledger compares the resolved micro-chunked extent against the
    # monolithic worst case (Engine.ep_load_stats)
    ep_rank_max_tokens: int = 0      # routed slots on the hottest EP rank
    ep_rank_mean_tokens: float = 0.0  # routed slots per EP rank, mean
    a2a_bytes_moved: int = 0         # priced bytes under the resolved extent
    a2a_bytes_worst: int = 0         # priced bytes at worst-case extent
    # speculative decoding (Engine.spec_stats; zero when speculation off)
    n_spec_steps: int = 0            # slot-steps that carried draft rows
    n_spec_drafted: int = 0          # draft tokens proposed to the verifier
    n_spec_accepted: int = 0         # draft tokens accepted
    spec_accept_rate: float = 0.0    # accepted / drafted
    spec_tokens_per_step: float = 0.0  # committed tokens per verify step

    def row(self) -> str:
        r = (f"n={self.n_requests} ttft={self.ttft_mean*1e3:.1f}ms "
             f"(p99 {self.ttft_p99*1e3:.1f}) itl={self.itl_mean*1e3:.2f}ms "
             f"(p99 {self.itl_p99*1e3:.2f}) thr={self.throughput_tok_s:.1f}tok/s "
             f"wq={self.queue_wait_mean*1e3:.1f}ms "
             f"shed={self.n_shed} preempt={self.n_preempted} "
             f"cancel={self.n_cancelled} dmiss={self.n_deadline_miss} "
             f"fault={self.n_faults} "
             f"kv={self.kv_occupancy*100:.0f}% "
             f"pfxhit={self.n_prefix_hits}({self.prefix_hit_tokens}tok) "
             f"evict={self.n_evictions}")
        if self.ep_rank_mean_tokens > 0:
            skew = self.ep_rank_max_tokens / self.ep_rank_mean_tokens
            saved = 1.0 - self.a2a_bytes_moved / max(self.a2a_bytes_worst, 1)
            r += (f" epskew={skew:.2f} "
                  f"a2a={self.a2a_bytes_moved}/{self.a2a_bytes_worst}B "
                  f"(-{saved*100:.0f}%)")
        if self.n_spec_steps:
            r += (f" spec={self.spec_tokens_per_step:.2f}tok/step"
                  f"(acc {self.spec_accept_rate*100:.0f}%)")
        if self.n_incomplete:
            r += f" INCOMPLETE={self.n_incomplete}"
        return r

    def robustness(self) -> dict:
        """The degradation counters as a JSON-able block (bench meta)."""
        return {"n_shed": self.n_shed, "n_preempted": self.n_preempted,
                "n_cancelled": self.n_cancelled,
                "n_deadline_miss": self.n_deadline_miss,
                "n_faults": self.n_faults,
                "deadline_miss_p99": self.deadline_miss_p99,
                "kv_occupancy": self.kv_occupancy,
                "n_prefix_hits": self.n_prefix_hits,
                "prefix_hit_tokens": self.prefix_hit_tokens,
                "n_evictions": self.n_evictions,
                "ep_rank_max_tokens": self.ep_rank_max_tokens,
                "ep_rank_mean_tokens": self.ep_rank_mean_tokens,
                "a2a_bytes_moved": self.a2a_bytes_moved,
                "a2a_bytes_worst": self.a2a_bytes_worst,
                "n_spec_steps": self.n_spec_steps,
                "n_spec_drafted": self.n_spec_drafted,
                "n_spec_accepted": self.n_spec_accepted,
                "spec_accept_rate": self.spec_accept_rate,
                "spec_tokens_per_step": self.spec_tokens_per_step}


class Scheduler:
    def __init__(self, engine: Engine, *,
                 watchdog_steps: int = WATCHDOG_STALL_STEPS):
        self.engine = engine
        # budget + overload policy ride the engine's resolved spec (the
        # deprecated Scheduler(token_budget=) kwarg was removed after its
        # one-release window)
        self.token_budget = engine.spec.token_budget
        self.overload: OverloadPolicy = engine.spec.overload
        self.watchdog_steps = int(watchdog_steps)
        self.waiting: deque[Request] = deque()
        self.finished: list[Request] = []
        self.shed: list[Request] = []
        self.failed: list[Request] = []
        self.cancelled: list[Request] = []
        self.wall = 0.0
        self.n_incomplete = 0
        self.kv_peak = 0.0           # peak KV occupancy over the run

    # -- admission-side bookkeeping --------------------------------------
    def _shed_req(self, req: Request, error: str) -> None:
        req.state = RequestState.SHED
        req.error = error
        req.t_done = time.perf_counter()
        self.shed.append(req)

    def submit(self, req: Request) -> bool:
        """Queue a request; returns False when the bounded admission queue
        sheds one instead (``req`` itself under reject-newest, possibly a
        queued deadline-infeasible victim under deadline-first).

        Raises ``PromptTooLongError`` early for never-admittable prompts.
        """
        self.engine.validate(req)
        req.state = RequestState.QUEUED
        if len(self.waiting) >= self.overload.queue_cap:
            victim = self._shed_victim(req)
            if victim is req:
                self._shed_req(req, f"admission queue full "
                               f"(cap {self.overload.queue_cap})")
                return False
            self.waiting.remove(victim)
            self._shed_req(victim, "shed for an infeasible deadline "
                           f"(queue cap {self.overload.queue_cap})")
            self.engine.events["deadline_miss"] += 1
        self.waiting.append(req)
        return True

    def _shed_victim(self, incoming: Request) -> Request:
        """Overflow victim.  deadline-first: the queued request whose
        deadline is least feasible (most negative slack against the
        resolver's predicted per-request service time) — degrade by
        dropping work that cannot meet its SLO anyway; falls back to
        reject-newest when no queued deadline is infeasible."""
        if self.overload.shed == "deadline-first":
            now = time.perf_counter()
            est = self.overload.est_request_s
            worst, worst_slack = None, 0.0
            for r in self.waiting:
                if r.deadline_s is None:
                    continue
                slack = r.deadline - (now + est)
                if slack < worst_slack:
                    worst, worst_slack = r, slack
            if worst is not None:
                return worst
        return incoming

    def cancel(self, rid: int) -> Optional[Request]:
        """Cancel a queued or running request by id."""
        for r in self.waiting:
            if r.rid == rid:
                self.waiting.remove(r)
                r.state = RequestState.CANCELLED
                r.error = "cancelled"
                r.t_done = time.perf_counter()
                self.engine.events["cancel"] += 1
                self.cancelled.append(r)
                return r
        req = self.engine.cancel(rid)
        if req is not None:
            self.cancelled.append(req)
        return req

    # -- the serving loop ------------------------------------------------
    def _now(self) -> float:
        skew = self.engine.faults.advance_clock(self.engine._step_idx) \
            if self.engine.faults else 0.0
        return time.perf_counter() + skew

    def _enforce_deadlines(self, now: float) -> int:
        """Free deadline-expired RUNNING slots mid-decode; shed queued
        requests whose deadline already passed.  Returns #released."""
        released = 0
        for i, r in enumerate(self.engine.slots):
            if r is not None and not r.done and now > r.deadline:
                self.engine.release(i, RequestState.CANCELLED,
                                    error="deadline expired mid-flight",
                                    reason="deadline_miss")
                self.cancelled.append(r)
                released += 1
        for r in [r for r in self.waiting if now > r.deadline]:
            self.waiting.remove(r)
            self._shed_req(r, "deadline expired in queue")
            self.engine.events["deadline_miss"] += 1
            released += 1
        return released

    def _admit_due(self, now: float) -> int:
        """Admit due requests highest-priority-first; preempt the
        lowest-priority slot when a due request strictly outranks it."""
        admitted = 0
        while self.waiting:
            due = [r for r in self.waiting if r.arrival <= now]
            if not due:
                break
            req = min(due, key=lambda r: (-r.priority, r.arrival, r.rid))
            if not self.engine.free_slots():
                victim_slot = self.engine.victim_slot(req.priority)
                if victim_slot is None:
                    break                  # nothing outranked — wait
                victim = self.engine.preempt(victim_slot)
                # recompute-on-resume: generated tokens ride back as a
                # prompt suffix; re-queued at its original arrival so it
                # re-admits as soon as capacity frees
                self.waiting.append(victim)
            try:
                if not self.engine.admit(req):
                    break
            except InjectedFault as e:
                self.waiting.remove(req)
                self._shed_req(req, str(e))
                continue
            self.waiting.remove(req)
            admitted += 1
        return admitted

    def run(self, *, max_steps: int = 100000) -> list:
        """Drain the queue: admit when slots free, step otherwise.

        Request ``arrival`` fields are *relative* offsets (seconds from run
        start) — an open-loop Poisson workload replays in real time.
        Raises ``StalledEngineError`` when the loop stops making progress
        (the watchdog) instead of spinning silently to ``max_steps``.
        """
        t0 = time.perf_counter()
        for r in self.waiting:                 # rebase to absolute wall time
            r.arrival += t0
        steps = 0
        stall = 0
        while (self.waiting or self.engine.n_active) and steps < max_steps:
            now = self._now()
            progress = self._enforce_deadlines(now) > 0
            progress |= self._admit_due(now) > 0
            if self.engine.n_active:
                self.kv_peak = max(self.kv_peak, self.engine.kv.occupancy())
                retired = self.engine.step(self.token_budget)
                self._classify(retired)
                progress |= bool(retired) or self.engine.last_step_tokens > 0
            elif self.waiting:
                next_arrival = min(r.arrival for r in self.waiting)
                if next_arrival > now:         # idle: wait for next arrival
                    time.sleep(max(0.0, min(next_arrival - now, 1e-3)))
                    progress = True
            stall = 0 if progress else stall + 1
            if stall >= self.watchdog_steps:
                head = min(self.waiting, key=lambda r: r.arrival) \
                    if self.waiting else None
                raise StalledEngineError(
                    f"no progress for {stall} iterations: "
                    f"{self.engine.n_active} active slots, "
                    f"{len(self.waiting)} queued"
                    + (f" (head rid={head.rid} prompt={len(head.prompt)} "
                       f"state={head.state})" if head else "")
                    + f", free={len(self.engine.free_slots())}, "
                    f"last_step_tokens={self.engine.last_step_tokens} — "
                    "the engine cannot admit or advance any request")
            steps += 1
        self.wall = time.perf_counter() - t0
        # max_steps can exit with work in flight — surface it, don't drop it
        self.n_incomplete = self.engine.n_active + len(self.waiting)
        return self.finished

    def _classify(self, retired: list) -> None:
        for r in retired:
            if r.state == RequestState.DONE:
                self.finished.append(r)
            elif r.state == RequestState.FAILED:
                self.failed.append(r)
            elif r.state == RequestState.PREEMPTED:
                # pool-pressure eviction from Engine.step: recompute-on-
                # resume — back into the queue at its original arrival
                self.waiting.append(r)
            elif r not in self.cancelled:
                self.cancelled.append(r)

    def metrics(self) -> ServeMetrics:
        rs = self.finished
        ttfts = np.array([r.ttft for r in rs])
        itls = np.array([r.itl for r in rs if len(r.out_tokens) > 1])
        waits = np.array([r.t_admitted - r.arrival for r in rs])
        total_toks = sum(len(r.prompt) + len(r.out_tokens) for r in rs)
        ev = self.engine.events
        # deadline lateness over every terminal deadline-carrying request:
        # finished late, killed mid-flight, or shed in the queue
        late = [max(0.0, r.t_done - r.deadline)
                for pool in (rs, self.cancelled, self.shed, self.failed)
                for r in pool if r.deadline_s is not None and r.t_done]
        return ServeMetrics(
            n_requests=len(rs),
            ttft_mean=float(ttfts.mean()) if len(rs) else 0.0,
            ttft_p99=float(np.percentile(ttfts, 99)) if len(rs) else 0.0,
            itl_mean=float(itls.mean()) if len(itls) else 0.0,
            itl_p99=float(np.percentile(itls, 99)) if len(itls) else 0.0,
            throughput_tok_s=total_toks / max(self.wall, 1e-9),
            queue_wait_mean=float(waits.mean()) if len(rs) else 0.0,
            wall_time=self.wall,
            n_incomplete=self.n_incomplete,
            n_shed=len(self.shed),
            n_preempted=ev.get("preempt", 0),
            n_cancelled=ev.get("cancel", 0),
            n_deadline_miss=ev.get("deadline_miss", 0),
            n_faults=ev.get("fault", 0),
            deadline_miss_p99=float(np.percentile(late, 99)) if late else 0.0,
            kv_occupancy=self.kv_peak,
            n_prefix_hits=self.engine.kv.stats.n_prefix_hits,
            prefix_hit_tokens=self.engine.kv.stats.prefix_hit_tokens,
            n_evictions=self.engine.kv.stats.n_evictions,
            **self.engine.ep_load_stats(),
            **self.engine.spec_stats(),
        )


def synthetic_workload(n_requests: int, *, prompt_len: int = 64,
                       max_new_tokens: int = 16, vocab: int = 256,
                       arrival_rate: float = 0.0, seed: int = 0,
                       priority: int = 0, deadline_s: Optional[float] = None
                       ) -> Iterable[Request]:
    """Deterministic ShareGPT-stand-in workload (seeded, poisson arrivals)."""
    rng = np.random.default_rng(seed)
    t = 0.0
    for rid in range(n_requests):
        if arrival_rate > 0:
            t += rng.exponential(1.0 / arrival_rate)
        s = max(4, int(rng.integers(prompt_len // 2, prompt_len + 1)))
        yield Request(rid=rid,
                      prompt=rng.integers(0, vocab, size=s).astype(np.int32),
                      max_new_tokens=max_new_tokens, arrival=t,
                      priority=priority, deadline_s=deadline_s)


def mixed_workload(n_short: int = 8, *, short_len: int = 12,
                   n_long: int = 2, long_len: int = 96,
                   max_new_tokens: int = 8, vocab: int = 256,
                   arrival_rate: float = 16.0, seed: int = 0
                   ) -> Iterable[Request]:
    """Short decode-heavy stream with long prompts landing mid-decode — the
    workload where blocking prefill spikes every active slot's ITL and
    queued TTFTs, and the unified mixed step should not."""
    rng = np.random.default_rng(seed)
    reqs, t = [], 0.0
    for rid in range(n_short):
        t += rng.exponential(1.0 / arrival_rate)
        s = max(4, int(rng.integers(short_len // 2, short_len + 1)))
        reqs.append(Request(
            rid=rid, prompt=rng.integers(0, vocab, size=s).astype(np.int32),
            max_new_tokens=max_new_tokens, arrival=t))
    # long prompts arrive in the thick of the short stream
    mid = reqs[n_short // 3].arrival if reqs else 0.0
    for j in range(n_long):
        reqs.append(Request(
            rid=n_short + j,
            prompt=rng.integers(0, vocab, size=long_len).astype(np.int32),
            max_new_tokens=max_new_tokens,
            arrival=mid + 1e-3 * j))
    return sorted(reqs, key=lambda r: r.arrival)


def tiered_workload(n_requests: int, *, prompt_len: int = 24,
                    max_new_tokens: int = 8, vocab: int = 256,
                    arrival_rate: float = 16.0, seed: int = 0,
                    hi_every: int = 3, hi_priority: int = 10,
                    hi_deadline_s: Optional[float] = 2.0,
                    system: Optional[np.ndarray] = None
                    ) -> Iterable[Request]:
    """Two-tier traffic: every ``hi_every``-th request is a high-priority,
    deadline-bound "interactive" request riding a best-effort background
    stream — the mix where priority preemption + deadline enforcement earn
    their keep (examples/serve_moe.py, chaos tests).

    ``system`` prepends a shared system prompt to every request — the
    paged KV backend serves it once and re-matches its full pages from
    the prefix index on every later admission (docs/kv_cache.md)."""
    rng = np.random.default_rng(seed)
    t = 0.0
    for rid in range(n_requests):
        if arrival_rate > 0:
            t += rng.exponential(1.0 / arrival_rate)
        s = max(4, int(rng.integers(prompt_len // 2, prompt_len + 1)))
        hi = hi_every > 0 and rid % hi_every == 0
        tail = rng.integers(0, vocab, size=s).astype(np.int32)
        prompt = (tail if system is None
                  else np.concatenate([np.asarray(system, np.int32), tail]))
        yield Request(rid=rid, prompt=prompt,
                      max_new_tokens=max_new_tokens, arrival=t,
                      priority=hi_priority if hi else 0,
                      deadline_s=hi_deadline_s if hi else None)


__all__ = ["Scheduler", "ServeMetrics", "StalledEngineError",
           "WATCHDOG_STALL_STEPS", "synthetic_workload", "mixed_workload",
           "tiered_workload"]
