"""Deterministic fault injection for the serving tier (chaos harness).

Production serving survives stragglers, bad numerics and bad requests by
*isolating* them; this module makes those failures reproducible so the
isolation machinery (engine NaN quarantine, scheduler shedding, the
no-progress watchdog) can be tested bit-for-bit.  A ``Fault`` is a frozen,
declarative description of WHEN (explicit step indices, a period, or a
seeded per-step probability) and WHAT fires:

  kind="latency"     sleep ``ms`` milliseconds inside the engine step —
                     a straggler / GC-pause / preemption spike
  kind="nan"         corrupt the sampled-logits row of one slot (by request
                     id, slot index, or any live slot) — the bad-numerics
                     case the engine's NaN/Inf guard must quarantine to
                     exactly that request
  kind="admit"       admission of the targeted request raises
                     ``InjectedFault`` — an un-admittable request the
                     scheduler must shed instead of spinning on
  kind="clock_skew"  shift the scheduler's wall clock by ``ms`` (cumulative)
                     — arrival/deadline bookkeeping under a jumping clock

Probabilistic faults are keyed by ``(seed, fault index, step)`` through a
counter-based RNG, so a replay with the same ``ServeSpec.faults`` and seed
fires on exactly the same steps — no hidden global RNG state.  Every
firing is appended to ``FaultInjector.log`` for assertions and postmortems.

Wiring: ``ServeSpec(faults=(...), seed=...)`` -> the engine builds one
``FaultInjector`` and consults it per unified step; the scheduler reads the
same injector for clock skew.  See docs/serving.md "Robustness &
degradation".
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

FAULT_KINDS = ("latency", "nan", "admit", "clock_skew")


class InjectedFault(RuntimeError):
    """Raised by an injected admission failure (kind="admit")."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One declarative failure source.

    Firing predicate (first match wins): explicit ``at`` engine-step
    indices; else ``every`` N steps; else per-step probability ``p`` (seeded
    — deterministic).  ``n_max`` caps total firings (0 = unlimited).
    ``rid``/``slot`` target a specific request / engine slot for "nan" and
    "admit" faults (-1 = any live slot / every request).
    """

    kind: str
    at: tuple = ()
    every: int = 0
    p: float = 0.0
    n_max: int = 0
    rid: int = -1
    slot: int = -1
    ms: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"fault kind must be one of {FAULT_KINDS}, got {self.kind!r}")
        if not (self.at or self.every or self.p):
            raise ValueError(
                f"fault {self.kind!r} never fires: set at=, every= or p=")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"fault p must be in [0, 1], got {self.p}")

    def describe(self) -> str:
        when = (f"at={list(self.at)}" if self.at
                else f"every={self.every}" if self.every else f"p={self.p}")
        tgt = (f" rid={self.rid}" if self.rid >= 0
               else f" slot={self.slot}" if self.slot >= 0 else "")
        mag = f" ms={self.ms:g}" if self.ms else ""
        return f"{self.kind}({when}{tgt}{mag})"


class FaultInjector:
    """Evaluates a tuple of ``Fault``s against the engine step counter.

    Deterministic: probabilistic faults draw from an RNG keyed by
    ``(seed, fault index, step)``, so the same (faults, seed) replays the
    same firing sequence regardless of wall time or call interleaving.
    """

    def __init__(self, faults: tuple = (), seed: int = 0):
        self.faults = tuple(faults)
        self.seed = int(seed)
        self._fired = [0] * len(self.faults)
        self.skew_s = 0.0                  # cumulative clock skew (seconds)
        self._skewed_steps: set[int] = set()
        self.log: list[tuple[int, str, str]] = []   # (step, kind, detail)

    def __bool__(self) -> bool:
        return bool(self.faults)

    def _fires(self, idx: int, f: Fault, step: int) -> bool:
        if f.n_max and self._fired[idx] >= f.n_max:
            return False
        if f.at:
            hit = step in f.at
        elif f.every:
            hit = step % f.every == 0
        else:
            hit = bool(np.random.default_rng(
                [self.seed, idx, step]).random() < f.p)
        if hit:
            self._fired[idx] += 1
        return hit

    def _record(self, step: int, f: Fault, detail: str = "") -> None:
        self.log.append((step, f.kind, detail or f.describe()))

    # -- per-kind queries (each evaluated once per engine step) ----------
    def step_latency_s(self, step: int) -> float:
        """Seconds of injected straggler latency for this engine step."""
        total = 0.0
        for i, f in enumerate(self.faults):
            if f.kind == "latency" and self._fires(i, f, step):
                total += f.ms / 1e3
                self._record(step, f)
        return total

    def admit_blocked(self, step: int, rid: int) -> Optional[Fault]:
        """The admit fault hitting request ``rid`` at this step, if any."""
        for i, f in enumerate(self.faults):
            if f.kind == "admit" and (f.rid < 0 or f.rid == rid) \
                    and self._fires(i, f, step):
                self._record(step, f, f"rid={rid}")
                return f
        return None

    def nan_slots(self, step: int, slot_rids: dict) -> set:
        """Slots whose sampled-logits row is corrupted this step.

        ``slot_rids`` maps live slot index -> request id (only slots with
        scheduled tokens this step).
        """
        bad = set()
        for i, f in enumerate(self.faults):
            if f.kind != "nan":
                continue
            if f.rid >= 0:
                hits = [s for s, r in slot_rids.items() if r == f.rid]
            elif f.slot >= 0:
                hits = [f.slot] if f.slot in slot_rids else []
            else:
                hits = sorted(slot_rids)
            if hits and self._fires(i, f, step):
                bad.update(hits)
                self._record(step, f, f"slots={hits}")
        return bad

    def advance_clock(self, step: int) -> float:
        """Apply clock-skew faults once per step; returns cumulative skew
        in seconds (added to the scheduler's wall-clock reads)."""
        if step not in self._skewed_steps:
            self._skewed_steps.add(step)
            for i, f in enumerate(self.faults):
                if f.kind == "clock_skew" and self._fires(i, f, step):
                    self.skew_s += f.ms / 1e3
                    self._record(step, f, f"skew={self.skew_s:g}s")
        return self.skew_s


__all__ = ["FAULT_KINDS", "Fault", "FaultInjector", "InjectedFault"]
