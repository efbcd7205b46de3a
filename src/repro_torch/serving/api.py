"""ServeSpec — ONE resolvable serving API (the automatic loop, closed).

MixServe's claim is *automatic*: model + cluster in, best strategy out,
serving system configured end-to-end.  ``ServeSpec`` is the single public
surface for that: every knob that used to ride on ``Engine`` / ``Scheduler``
kwargs and ``launch/serve.py`` flags is a declarative field defaulting to
``"auto"``, and ``ServeSpec.resolve(cfg, cluster/mesh)`` fills every auto
field from the offline analyzer / cost model (``core.resolve``), returning
a fully-concrete frozen ``ResolvedServeSpec`` whose ``describe()`` prints a
provenance report — which value came from where.

On top sits the ``LLM`` facade, which owns Engine + Scheduler construction:

    spec = ServeSpec(arch="phi3.5-moe-42b")          # everything "auto"
    llm = LLM.from_spec(spec)                        # resolve + build
    print(llm.spec.describe())                       # provenance report
    outs = llm.generate(prompts, max_new_tokens=16)  # blocking
    rid = llm.submit(prompt)                         # or streaming:
    for rid, tok in llm.stream(): ...

``Engine(cfg, params, spec=resolved)`` consumes the resolved spec directly.
Resolution always analyses the FULL config (the offline stage prices the
real model on the real cluster); ``reduced`` only selects which weights the
local engine loads.  ``device=`` (``from_spec`` / ``LLM``) picks the card the
engine runs on: CUDA by default, the CPU only when the caller asks for it —
an entry point never falls back to the CPU by itself.  Robustness knobs ride the same surface: ``overload``
("auto" -> a cost-model-priced bounded admission queue) and ``faults`` (a
tuple of deterministic fault injections for chaos testing — docs/serving.md
"Robustness & degradation").
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Iterator, Optional, Union

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import analyzer
from repro_torch.core import cost_model as cm
from repro_torch.core import resolve as R
from repro_torch.core.partitioner import NULL_PLAN, ShardingPlan, make_plan
from repro_torch.core.resolve import (AUTO, KVConfig, OverloadPolicy,
                                SpeculationConfig)
from repro_torch.core.topology import ClusterSpec
from repro_torch.kernels.policy import KernelPolicy
from repro_torch.serving.engine import (Engine, Request, RequestState,
                                      resolve_device, unified_supported)
from repro_torch.serving.faults import Fault, InjectedFault
from repro_torch.serving.scheduler import Scheduler

_DISPATCH_MODES = (AUTO, "dropless", "capacity")
_STRATEGY_NAMES = (AUTO, "mixserve", "dp_ep", "pure_ep", "pure_tp")


def _concrete(v) -> bool:
    return v != AUTO


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """Declarative serving configuration; ``"auto"`` fields are filled by
    ``resolve`` from the analyzer / cost model."""

    # which model: a registry id (repro_torch.configs.ARCH_IDS); ``reduced``
    # selects the reduced local variant for the online engine (resolution
    # always analyses the full config)
    arch: Optional[str] = None
    reduced: bool = True
    # offline stage: target cluster (name / ClusterSpec / "auto")
    cluster: Union[str, ClusterSpec] = AUTO
    # parallel strategy: "auto" (analyzer) | plan name | analyzer Strategy
    strategy: Union[str, cm.Strategy] = AUTO
    # Hopper kernels: "auto"|"on"|"off" | explicit KernelPolicy
    kernels: Union[str, KernelPolicy] = AUTO
    # MoE dispatch buffers: "auto" (-> dropless) | "dropless" | "capacity"
    dispatch: str = AUTO
    # unified-step knobs ("auto" -> cost model)
    chunk: Union[int, str] = AUTO
    token_budget: Union[int, str] = AUTO
    max_batch: Union[int, str] = AUTO
    max_len: Union[int, str] = AUTO
    # workload hints — the analyzer's offline-stage inputs (Eqs. 9-11)
    prompt_len: int = 128
    max_new_tokens: int = 32
    arrival_rate: float = 0.0
    objective: str = "balanced"
    # robustness: bounded admission ("auto" -> cost-model queue cap +
    # deadline-first shedding) and the deterministic chaos-fault plan
    overload: Union[str, OverloadPolicy] = AUTO
    faults: tuple = ()
    # KV cache backend: "auto" (-> paged from the Eq. 8 envelope for
    # unified families, dense for legacy) | "dense" | "paged" | a KVConfig
    kv: Union[str, KVConfig] = AUTO
    # EP-exchange overlap: "auto" (cost model picks the micro-chunk count;
    # count-bounded buffers on) | "off" (monolithic worst-case exchange) |
    # an int chunk count | an explicit cm.EpOverlap
    ep_overlap: Union[str, int, cm.EpOverlap] = AUTO
    # speculative decoding: "off" (default) | "auto" (cost model prices
    # draft length k against the verify step) | an int k | an explicit
    # R.SpeculationConfig.  Greedy-only (temperature must stay 0).
    speculation: Union[str, int, R.SpeculationConfig] = "off"
    # sampling / debug
    temperature: float = 0.0
    seed: int = 0
    debug_logits: bool = False

    def __post_init__(self):
        if self.dispatch not in _DISPATCH_MODES:
            raise ValueError(f"dispatch must be one of {_DISPATCH_MODES}, "
                             f"got {self.dispatch!r}")
        if isinstance(self.strategy, str) \
                and self.strategy not in _STRATEGY_NAMES:
            raise ValueError(f"strategy must be one of {_STRATEGY_NAMES} "
                             f"or a Strategy, got {self.strategy!r}")
        for f in ("chunk", "token_budget", "max_batch", "max_len"):
            v = getattr(self, f)
            if isinstance(v, str) and v != AUTO:
                raise ValueError(f"{f} must be an int or 'auto', got {v!r}")
        if not isinstance(self.overload, OverloadPolicy) \
                and self.overload != AUTO:
            raise ValueError("overload must be 'auto' or an OverloadPolicy, "
                             f"got {self.overload!r}")
        if not isinstance(self.kv, KVConfig) \
                and self.kv not in (AUTO, "dense", "paged"):
            raise ValueError("kv must be 'auto'|'dense'|'paged' or a "
                             f"KVConfig, got {self.kv!r}")
        eo = self.ep_overlap
        if not isinstance(eo, cm.EpOverlap):
            if isinstance(eo, bool) or not (
                    eo in (AUTO, "off")
                    or (isinstance(eo, int) and eo >= 1)):
                raise ValueError(
                    "ep_overlap must be 'auto'|'off', a chunk count >= 1 "
                    f"or an EpOverlap, got {eo!r}")
        sp = self.speculation
        if not isinstance(sp, R.SpeculationConfig):
            if isinstance(sp, bool) or not (
                    sp in (AUTO, "off")
                    or (isinstance(sp, int) and sp >= 1)):
                raise ValueError(
                    "speculation must be 'auto'|'off', a draft length >= 1 "
                    f"or a SpeculationConfig, got {sp!r}")
        object.__setattr__(self, "faults", tuple(self.faults))
        for f in self.faults:
            if not isinstance(f, Fault):
                raise ValueError(
                    f"faults must be serving.faults.Fault instances, "
                    f"got {f!r}")

    # ------------------------------------------------------------------
    def resolve(self, cfg: Optional[ModelConfig] = None,
                cluster: Union[str, ClusterSpec, None] = None, *,
                mesh=None, device="cuda", fsdp: bool = False,
                sp: bool = True) -> "ResolvedServeSpec":
        """Fill every ``"auto"`` field from the analyzer / cost model.

        ``cfg`` defaults to the FULL config of ``arch`` (the offline stage
        prices the real model); ``cluster`` overrides the spec's field;
        ``mesh`` (a ``launch.mesh.Mesh`` over the ranks) makes the plan a
        sharded layout on it and prices the cluster of its size with the
        strategy that layout realises (its degrees, not the analyzer
        best's).
        ``device`` is where the engine will run: ``kernels="auto"`` turns
        the Hopper kernels on exactly when it is CUDA.
        ``sp=False`` keeps the residual stream whole on every TP rank (no
        Megatron-SP cut along seq; ``partitioner.make_plan``).
        ``fsdp=True`` (training only) stores the weights' ``embed`` axis
        cut over "data", gathered on use (``partitioner.make_plan``).
        Deterministic: same inputs, same resolved spec.
        """
        import torch

        import repro_torch.configs as C

        if cfg is None:
            if self.arch is None:
                raise ValueError(
                    "ServeSpec.resolve needs a ModelConfig or spec.arch")
            cfg = C.get(self.arch)
        arch = self.arch or cfg.name
        prov: dict[str, str] = {}

        cl = self.cluster if cluster is None else cluster
        cluster_spec, prov["cluster"] = R.resolve_cluster(cl, mesh=mesh)
        n_devices = mesh.size if mesh is not None \
            else cluster_spec.n_devices

        # ---- offline stage: the analyzer runs regardless of strategy
        # being explicit — its cost estimates price chunk/budget/batch ----
        l_in, l_out = self.prompt_len, self.max_new_tokens
        analysis_batch = self.max_batch if _concrete(self.max_batch) \
            else R.resolved_batch_cap()[0]
        # pricing hint: when the overlapped exchange is not disabled, the
        # analyzer prices every candidate with the micro-chunked schedule —
        # strategies whose A2A hides behind expert compute stop losing
        if self.ep_overlap == "off":
            price_ovl = None
        elif isinstance(self.ep_overlap, cm.EpOverlap):
            price_ovl = self.ep_overlap
        elif isinstance(self.ep_overlap, int):
            price_ovl = cm.EpOverlap(chunks=self.ep_overlap)
        else:                         # "auto": a representative chunk count
            price_ovl = cm.EpOverlap(chunks=4)
        report = analyzer.select(
            cfg, cluster_spec, batch=int(analysis_batch),
            l_in=min(l_in, 8192), l_out=l_out,
            arrival_rate=self.arrival_rate, objective=self.objective,
            ep_overlap=price_ovl)
        best = report.best.strategy

        # ---- strategy -> plan layout name ----
        if isinstance(self.strategy, cm.Strategy):
            cost_strat = self.strategy
            name = R.plan_name_for(cfg, cost_strat, n_devices)
            comm_algo = cost_strat.comm_algo
            prov["strategy"] = "explicit:Strategy"
        elif _concrete(self.strategy):
            # a bare layout name has no degrees, so the analyzer's best
            # strategy still prices chunk/budget/batch; when the name is
            # the very layout the best maps to, keep its comm algorithm
            # too instead of pinning "fused"
            cost_strat, name = best, self.strategy
            same = R.plan_name_for(cfg, best, n_devices) == name
            comm_algo = best.comm_algo if same else "fused"
            prov["strategy"] = ("explicit (cost estimates from the "
                                f"analyzer best: {best.describe()})")
        else:
            cost_strat = best
            name = R.plan_name_for(cfg, best, n_devices)
            comm_algo = best.comm_algo
            prov["strategy"] = (f"auto:analyzer({self.objective} on "
                                f"{cluster_spec.name}: {best.describe()})")
        if mesh is not None:
            # on a mesh the layout fixes the degrees: every estimate below
            # prices the strategy the plan realises there
            cost_strat = make_plan(name, mesh, comm_algo).strategy()
            how = "auto:analyzer" if not _concrete(self.strategy) \
                else "explicit"
            prov["strategy"] = (f"{how}; priced as the mesh runs it: "
                                f"{cost_strat.describe()}")

        # ---- kernels (the policy participates in resolution) ----
        if isinstance(self.kernels, KernelPolicy):
            kernels, prov["kernels"] = self.kernels, "explicit"
        elif _concrete(self.kernels):
            kernels = KernelPolicy.parse(self.kernels, device)
            prov["kernels"] = "explicit"
        else:
            kernels = KernelPolicy.auto(device)
            prov["kernels"] = f"auto:device({torch.device(device).type})"

        # ---- dispatch ----
        if _concrete(self.dispatch):
            dispatch, prov["dispatch"] = self.dispatch, "explicit"
        else:
            dispatch = "dropless"
            prov["dispatch"] = ("auto:inference(count-independent ragged "
                                "buffers; docs/dispatch.md)")

        # ---- engine envelope from the cost model ----
        if _concrete(self.max_batch):
            max_batch, prov["max_batch"] = int(self.max_batch), "explicit"
        else:
            max_batch, prov["max_batch"] = R.auto_max_batch(
                cfg, cost_strat, cluster_spec, l_in=l_in, l_out=l_out)

        front = cfg.n_frontend_tokens if cfg.frontend == "vision_stub" else 0
        if _concrete(self.max_len):
            max_len, prov["max_len"] = int(self.max_len), "explicit"
        else:
            max_len, prov["max_len"] = R.auto_max_len(l_in, l_out, front)

        if _concrete(self.chunk):
            chunk, prov["chunk"] = int(self.chunk), "explicit"
        else:
            chunk, prov["chunk"] = R.auto_chunk(
                cfg, cost_strat, cluster_spec, batch=max_batch,
                l_in=l_in, l_out=l_out)
        chunk = max(1, min(chunk, max_len))

        # ---- speculation: draft length priced against the verify step ----
        speculation, prov["speculation"] = R.auto_speculation(
            cfg, cost_strat, cluster_spec, batch=max_batch, l_in=l_in,
            l_out=l_out, chunk=chunk, temperature=self.temperature,
            unified_ok=unified_supported(cfg), value=self.speculation)

        if _concrete(self.token_budget) and int(self.token_budget) > 0:
            token_budget = int(self.token_budget)
            prov["token_budget"] = "explicit"
        else:
            token_budget, prov["token_budget"] = R.auto_token_budget(
                max_batch, chunk,
                spec_k=speculation.k if speculation else 0)

        # ---- overload: priced degradation (bounded admission queue) ----
        if isinstance(self.overload, OverloadPolicy):
            overload, prov["overload"] = self.overload, "explicit"
        else:
            overload, prov["overload"] = R.auto_overload(
                cfg, cost_strat, cluster_spec, batch=max_batch,
                l_in=l_in, l_out=l_out)

        # ---- KV cache: Eq. 8 memory envelope -> paged pool sizing ----
        paged_ok = unified_supported(cfg)
        if isinstance(self.kv, KVConfig):
            if self.kv.backend == "paged" and not paged_ok:
                raise ValueError(
                    f"kv backend 'paged' needs the unified step, which "
                    f"cannot serve {cfg.name} (family {cfg.family}) — use "
                    "kv='dense' or kv='auto'")
            kv, prov["kv"] = self.kv, "explicit"
        else:
            backend = None if self.kv == AUTO else self.kv
            if backend == "paged" and not paged_ok:
                raise ValueError(
                    f"kv='paged' needs the unified step, which cannot "
                    f"serve {cfg.name} (family {cfg.family}) — use "
                    "kv='dense' or kv='auto'")
            kv, prov["kv"] = R.auto_kv(
                cfg, max_batch=max_batch, max_len=max_len, l_in=l_in,
                l_out=l_out, front=front, paged_ok=paged_ok,
                backend=backend)

        # ---- EP-exchange overlap: micro-chunk count + row cap ----
        ep_ovl, prov["ep_overlap"] = R.auto_ep_overlap(
            cfg, cost_strat, cluster_spec, batch=max_batch, l_in=l_in,
            l_out=l_out, value=self.ep_overlap)

        plan = make_plan(name, mesh, comm_algo=comm_algo, fsdp=fsdp, sp=sp,
                         kernels=kernels, dispatch=dispatch,
                         ep_overlap=ep_ovl)

        return ResolvedServeSpec(
            arch=arch, reduced=self.reduced, cluster=cluster_spec.name,
            strategy=name, strategy_detail=cost_strat.describe(),
            kernels=kernels, dispatch=dispatch, chunk=chunk,
            token_budget=token_budget, max_batch=max_batch, max_len=max_len,
            prompt_len=l_in, max_new_tokens=l_out,
            arrival_rate=self.arrival_rate, objective=self.objective,
            overload=overload, faults=self.faults, kv=kv,
            ep_overlap=ep_ovl, speculation=speculation,
            moe_ep=cost_strat.moe_ep if cfg.is_moe else 1,
            moe_tp=cost_strat.moe_tp if cfg.is_moe else 1,
            temperature=self.temperature, seed=self.seed,
            debug_logits=self.debug_logits, plan=plan, report=report,
            provenance=prov)


@dataclasses.dataclass(frozen=True)
class ResolvedServeSpec:
    """A ServeSpec with every field concrete, plus where each came from.

    Round-trips through ``dataclasses.replace`` (all fields are init
    fields); ``report`` is analysis payload, excluded from equality so
    resolution determinism is a value property.
    """

    arch: Optional[str]
    reduced: bool
    cluster: str                      # cluster NAME
    strategy: str                     # plan layout name
    strategy_detail: str              # analyzer Strategy.describe()
    kernels: KernelPolicy
    dispatch: str
    chunk: int
    token_budget: int
    max_batch: int
    max_len: int
    prompt_len: int
    max_new_tokens: int
    arrival_rate: float
    objective: str
    overload: OverloadPolicy
    temperature: float
    seed: int
    debug_logits: bool
    faults: tuple = ()
    kv: KVConfig = dataclasses.field(default_factory=KVConfig)
    ep_overlap: Optional[cm.EpOverlap] = None   # None = monolithic exchange
    speculation: Optional[R.SpeculationConfig] = None   # None = off
    # the priced strategy's MoE degrees (the engine's expert-load / A2A
    # observability buckets measured counts by them): on a mesh those of
    # the layout that runs; without one the single-device engine runs the
    # NULL_PLAN layout and they price the analyzer's pick
    moe_ep: int = 1
    moe_tp: int = 1
    plan: ShardingPlan = NULL_PLAN
    report: Optional[analyzer.AnalyzerReport] = dataclasses.field(
        default=None, compare=False, repr=False)
    provenance: dict = dataclasses.field(default_factory=dict)

    _KNOBS = ("strategy", "kernels", "dispatch", "chunk", "token_budget",
              "max_batch", "max_len", "cluster", "overload", "kv",
              "ep_overlap", "speculation")

    def describe(self) -> str:
        """The provenance report: every knob, its value, and its source."""
        head = (f"ResolvedServeSpec: {self.arch or '?'}"
                f"{' (reduced engine)' if self.reduced else ''} "
                f"on {self.cluster}  "
                f"[workload b<={self.max_batch} l_in={self.prompt_len} "
                f"l_out={self.max_new_tokens} "
                f"objective={self.objective}]")
        rows = []
        for f in self._KNOBS:
            v = getattr(self, f)
            if f == "strategy" and self.strategy_detail:
                v = f"{v} ({self.strategy_detail})"
            elif isinstance(v, (KernelPolicy, OverloadPolicy, KVConfig,
                                cm.EpOverlap, R.SpeculationConfig)):
                v = v.describe()
            elif v is None and f in ("ep_overlap", "speculation"):
                v = "off"
            rows.append((f, str(v), self.provenance.get(f, "?")))
        w0 = max(len(r[0]) for r in rows)
        w1 = max(len(r[1]) for r in rows)
        lines = [head] + [f"  {f:<{w0}}  {v:<{w1}}  <- {src}"
                          for f, v, src in rows]
        return "\n".join(lines)

    def as_meta(self) -> dict:
        """JSON-able provenance block (benchmark artifacts / logs)."""
        resolved = {}
        for f in self._KNOBS:
            v = getattr(self, f)
            if isinstance(v, (KernelPolicy, OverloadPolicy, KVConfig,
                              cm.EpOverlap, R.SpeculationConfig)):
                v = v.describe()
            elif v is None and f in ("ep_overlap", "speculation"):
                v = "off"
            resolved[f] = v
        return {
            "resolved": resolved,
            "provenance": dict(self.provenance),
            "faults": [f.describe() for f in self.faults],
        }


class LLM:
    """The facade over Engine + Scheduler: one resolvable spec in, a
    serving endpoint out.

    ``generate`` is the blocking API; ``submit``/``stream`` the streaming
    one (tokens yielded as the unified steps produce them); ``serve``
    replays a timed Request workload through the Scheduler and returns it
    (for metrics).
    """

    def __init__(self, cfg: ModelConfig, params, spec: ResolvedServeSpec, *,
                 embeds_fn=None, dtype=None, device=None):
        import torch
        dtype = torch.float32 if dtype is None else dtype
        dev = resolve_device(device)
        if embeds_fn is None and cfg.frontend == "audio_stub":
            e = cfg.encoder

            def embeds_fn(b):
                return {"frames": torch.full((b, e.n_frames, e.d_model),
                                             0.01, dtype=torch.float32,
                                             device=dev)}
        self.cfg, self.params, self.spec = cfg, params, spec
        self.engine = Engine(cfg, params, spec=spec, embeds_fn=embeds_fn,
                             dtype=dtype, device=dev)
        self._queue: deque[Request] = deque()
        self._next_rid = 0

    @classmethod
    def from_spec(cls, spec: Union[ServeSpec, ResolvedServeSpec], *,
                  cfg: Optional[ModelConfig] = None, params=None,
                  cluster=None, mesh=None, embeds_fn=None, dtype=None,
                  device=None) -> "LLM":
        """Resolve (if needed), load/init weights, build Engine+Scheduler.

        ``cfg``/``params`` override the registry lookup (custom configs,
        pre-initialized weights); with a plain ``ServeSpec`` the FULL
        config is analysed and the reduced/full engine config follows
        ``spec.reduced``.  ``device`` defaults to CUDA and raises when no
        card is present; pass ``device="cpu"`` for the plain CPU path.
        Random weights are drawn from a generator on ``device`` seeded
        with ``spec.seed``.

        ``embeds_fn(batch)`` gives the stub frontend's inputs for one
        blocking prefill, as ``forward`` keyword arguments: qwen2-vl's
        ``{"embeds": (batch, n_frontend_tokens, d_model)}``, whisper's
        ``{"frames": (batch, n_frames, d_enc)}``.  Whisper defaults to
        frames of 0.01 in f32, as the reference does; qwen2-vl has no
        default (it then serves with its patch positions unwritten, as
        the reference does).

        ``mesh``: serve SPMD on a ``launch.mesh.Mesh`` — every rank calls
        this and then ``generate`` with the same arguments.  Each rank
        keeps its slice of the weights (``ShardingPlan.keep_hook``;
        ``params``, when given, must already be that slice) and of the KV
        pool's heads; the scheduler, page allocator and sampler run
        identically on every rank.
        """
        import torch

        import repro_torch.configs as C
        from repro_torch.models.model import init_params

        dev = resolve_device(device)
        if isinstance(spec, ServeSpec):
            full = cfg if (cfg is not None and spec.arch is None) else None
            resolved = spec.resolve(full, cluster, mesh=mesh, device=dev)
        else:
            resolved = spec
        if cfg is None:
            if resolved.arch is None:
                raise ValueError("pass cfg= for a spec without .arch")
            cfg = (C.get_reduced(resolved.arch) if resolved.reduced
                   else C.get(resolved.arch))
        dtype = torch.float32 if dtype is None else dtype
        if params is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(resolved.seed)
            params = init_params(gen, cfg, dtype, dev, plan=resolved.plan)
        return cls(cfg, params, resolved, embeds_fn=embeds_fn, dtype=dtype,
                   device=dev)

    # -- streaming -------------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None, *,
               priority: int = 0,
               deadline_s: Optional[float] = None) -> int:
        """Queue a prompt; returns its request id.  Validates eagerly
        (``PromptTooLongError`` raised here never corrupts already-queued
        requests).  ``priority`` orders nothing in the plain stream() loop
        but rides into Scheduler-driven serving; ``deadline_s`` is seconds
        from NOW — an expired request is cancelled mid-flight."""
        if max_new_tokens is None:
            max_new_tokens = self.spec.max_new_tokens or 32
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=max_new_tokens,
                      arrival=time.perf_counter(),
                      priority=priority, deadline_s=deadline_s)
        self.engine.validate(req)
        self._queue.append(req)
        return rid

    def cancel(self, rid: int) -> bool:
        """Cancel a queued or running request.  Frees its engine slot
        immediately; a ``stream()`` in progress simply stops yielding its
        tokens.  Returns False for unknown/already-finished rids."""
        for req in self._queue:
            if req.rid == rid:
                self._queue.remove(req)
                req.state = RequestState.CANCELLED
                req.error = "cancelled"
                req.t_done = time.perf_counter()
                self.engine.events["cancel"] += 1
                return True
        return self.engine.cancel(rid) is not None

    def stream(self) -> Iterator[tuple[int, int]]:
        """Drive unified steps, yielding (rid, token) as tokens land.

        Lifecycle-aware: cancelled/failed/deadline-expired requests stop
        yielding and free their slots; injected admission faults shed
        exactly the targeted request; later rids keep completing.
        """
        emitted: dict[int, int] = {}
        live: dict[int, Request] = {}
        while self._queue or self.engine.n_active:
            while self._queue and self.engine.free_slots():
                req = self._queue[0]
                try:
                    if not self.engine.admit(req):
                        break
                except InjectedFault as e:
                    self._queue.popleft()
                    req.state = RequestState.SHED
                    req.error = str(e)
                    req.t_done = time.perf_counter()
                    continue
                self._queue.popleft()
                live[req.rid] = req
            now = time.perf_counter()
            for req in list(live.values()):
                if not req.terminal and not req.done and now > req.deadline:
                    slot = self.engine.slot_of(req.rid)
                    if slot is not None:
                        self.engine.release(
                            slot, RequestState.CANCELLED,
                            error="deadline expired mid-flight",
                            reason="deadline_miss")
            retired = self.engine.step(self.spec.token_budget)
            for req in retired:
                # pool-pressure preemption: back to the head of the queue
                # (recompute-on-resume; prefix index keeps its full pages)
                if req is not None and req.state == RequestState.PREEMPTED:
                    self._queue.appendleft(req)
            for req in list(live.values()):
                if req.terminal and req.state != RequestState.DONE:
                    del live[req.rid]       # cancelled / failed / shed
                    continue
                n0 = emitted.get(req.rid, 0)
                for tok in req.out_tokens[n0:]:
                    yield req.rid, int(tok)
                emitted[req.rid] = len(req.out_tokens)
                if req.done:
                    del live[req.rid]

    # -- blocking --------------------------------------------------------
    def generate(self, prompts,
                 max_new_tokens: Optional[int] = None) -> list[list[int]]:
        """Serve a batch of prompts to completion; outputs in input order.

        Drains the whole queue — requests from earlier ``submit()`` calls
        complete too (their tokens are not in this call's return value;
        interleave with ``stream()`` to observe them).
        """
        rids = [self.submit(p, max_new_tokens) for p in prompts]
        outs: dict[int, list[int]] = {r: [] for r in rids}
        for rid, tok in self.stream():
            outs.setdefault(rid, []).append(tok)
        return [outs[r] for r in rids]

    def serve(self, requests, *, max_steps: int = 100000) -> Scheduler:
        """Replay a timed Request workload (arrival offsets honored) and
        return the Scheduler for ``metrics()`` / ``finished``."""
        sched = Scheduler(self.engine)
        for r in requests:
            sched.submit(r)
        sched.run(max_steps=max_steps)
        return sched


__all__ = ["AUTO", "ServeSpec", "ResolvedServeSpec", "OverloadPolicy",
           "KVConfig", "SpeculationConfig", "Fault", "LLM"]
