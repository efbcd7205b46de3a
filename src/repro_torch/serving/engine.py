"""Serving engine: token-budget continuous batching over a KV cache.

Every iteration runs ONE unified mixed prefill/decode step:

  forward(params, tokens(B, chunk), q_lens(B,), cache) -> logits (B, n, V)

(n = 1 + speculation k).  Each slot contributes ``q_lens[i] ∈ {0, 1, …,
chunk}`` tokens against the fixed (B, chunk) buffer: a decoding slot its 1
sampled token — or, when speculating, 1 + k rows whose draft tail is
greedy-verified in the same pass (``v_lens`` marks the verify slots) — a
prefilling slot the next chunk of its pending tokens, an idle slot 0.
Admission is bookkeeping (the slot's pending buffer is ``prompt + tokens
generated so far`` — the recompute-on-resume suffix that makes preemption
exact); a long prompt never stalls the decode slots.

Robustness: every ``Request`` carries a lifecycle ``state``; ``release`` /
``cancel`` / ``preempt`` free a slot mid-flight; a NaN/Inf guard on the
sampled-logits rows quarantines exactly the offending slot (state FAILED);
a ``FaultInjector`` (``ServeSpec.faults``) injects latency spikes, NaN
rows, admit failures and clock skew deterministically.

The KV cache is the backend ``spec.kv`` resolves to (``serving.kv_cache``):
the paged pool, whose host allocator owns the block tables and may grant a
slot fewer tokens than asked (then the deadlock breaker in ``step``
preempts a victim), or the dense per-slot buffers, which grant every
request, keep no host tables and never preempt; both run the same step.

The engine runs on one device (``device=``, default CUDA).  On a mesh
(``spec.plan.enabled``) every rank runs its own engine on the same requests:
the scheduler, page allocator and sampler are identical on each rank and
see the whole batch's logits, while the model runs in MixServe's layout
(``models.model.forward``): each rank computes its batch rows' attention on
its heads, its vocab block of the embedding and LM head, its slice of the
dense MLP and the MoE blocks, and holds its heads' slice of every KV page
(the dense backend: its rows and heads of the per-slot buffers); so the
greedy streams agree across ranks.

Speculative decoding (``spec.speculation``, greedy only): a draft source
(``serving.draft``) proposes up to k tokens a decoding slot, the planner
prices them as budget rows before prefill, the step verifies them, and the
rejected tail rolls back (the device length inside the step, the paged
pages through ``kv.rollback``).  On a mesh a self draft runs sharded as
the serve, a foreign draft whole on every rank.

Legacy path — the reference's pre-unified two-program engine (bucket-padded
blocking prefill in ``admit`` + a separate decode step) serves the families
the unified step cannot (``unified_supported`` False: the recurrent state
of rwkv6 and the ring buffers of recurrentgemma advance by every row, so a
ragged tail cannot be masked; the frontend families take their stub
inputs at prefill).  It pins the dense cache and never speculates.  On a
mesh the batch-1 prefill does not split over the batch axes: every batch
rank runs it whole on its heads and channels, the logits come back
gathered over TP only, and the rank whose rows hold the slot inserts the
cache; the decode step splits its (max_batch, 1) rows as usual.  It keeps
the reference's
semantics, faults included: the prompt is padded to its bucket with id 0
and the whole bucket runs through the prefill, so the recurrent state and
the ring come from the last bucket row, not the last real one (only the
first token reads the real row); a resumed request re-prefills its prompt
alone, not the tokens it had generated.  The prefill passes
``embeds_fn(1)`` to the forward (one result an admission: whisper's
``frames``, qwen2-vl's patch ``embeds``); a vision stub holds
``n_frontend_tokens`` positions ahead of the prompt whether or not an
``embeds_fn`` gives them, so without one the first token's row is read
past the prompt (clamped to the last row, as JAX clamps) and the decode
attends over the rows never written.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import Counter
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cost_model import cap_rows_for
from repro_torch.core.resolve import KVConfig
from repro_torch.models.model import forward, init_cache
from repro_torch.serving.draft import make_draft
from repro_torch.serving.faults import FaultInjector, InjectedFault
from repro_torch.serving.kv_cache import insert_slot, make_kv_cache


class PromptTooLongError(ValueError):
    """Prompt + generation budget cannot fit the cache."""


class RequestState:
    """Request lifecycle.  Terminal states never transition again;
    PREEMPTED requests re-enter RUNNING when re-admitted (recompute)."""

    QUEUED = "QUEUED"
    RUNNING = "RUNNING"
    DONE = "DONE"
    CANCELLED = "CANCELLED"
    SHED = "SHED"
    FAILED = "FAILED"
    PREEMPTED = "PREEMPTED"

    TERMINAL = frozenset({DONE, CANCELLED, SHED, FAILED})


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (s,) int32 token ids
    max_new_tokens: int = 32
    arrival: float = 0.0
    priority: int = 0                   # higher = more important
    deadline_s: Optional[float] = None  # seconds after arrival; None = none
    # filled by the engine / scheduler:
    state: str = RequestState.QUEUED
    error: str = ""
    n_preempted: int = 0
    out_tokens: list = dataclasses.field(default_factory=list)
    t_admitted: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0

    @property
    def done(self) -> bool:
        return len(self.out_tokens) >= self.max_new_tokens

    @property
    def terminal(self) -> bool:
        return self.state in RequestState.TERMINAL

    @property
    def deadline(self) -> float:
        """Absolute deadline (same clock as ``arrival``); +inf if none."""
        if self.deadline_s is None:
            return float("inf")
        return self.arrival + self.deadline_s

    @property
    def ttft(self) -> float:
        return self.t_first_token - self.arrival

    @property
    def itl(self) -> float:
        n = len(self.out_tokens)
        if n <= 1:
            return 0.0
        return (self.t_done - self.t_first_token) / (n - 1)


def _bucket(n: int,
            buckets=(32, 64, 128, 256, 512, 1024, 2048, 4096)) -> int:
    """The legacy prefill's padded length for an n-token prompt."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


MAX_BUCKET = 4096      # largest legacy prefill bucket — hard prompt cap


def unified_supported(cfg: ModelConfig) -> bool:
    """Whether the unified mixed step can serve this config (attention-
    cached text families only)."""
    return cfg.family in ("dense", "moe", "vlm") and not cfg.frontend \
        and not cfg.mrope


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


class Engine:
    def __init__(self, cfg: ModelConfig, params, spec=None, *,
                 embeds_fn=None, dtype=torch.float32, device=None):
        # ``spec`` (a serving.api.ResolvedServeSpec) is THE configuration
        # surface: plan, kernels, dispatch, chunk, token budget, the slot
        # envelope, overload policy and fault plan all ride on it.
        if spec is None:
            raise TypeError("Engine needs a resolved spec: Engine(cfg, "
                            "params, ServeSpec(...).resolve(cfg))")
        # the blocking-prefill path serves the families the unified step
        # cannot (recurrent state, ring buffers); it keeps the dense cache
        self.legacy = not unified_supported(cfg)
        self.device = resolve_device(device)
        self.spec = spec
        # the vlm / audio stub frontend: embeds_fn(batch) -> forward kwargs
        self.embeds_fn = embeds_fn
        self.cfg, self.params, self.plan = cfg, params, spec.plan
        self.max_batch, self.max_len = spec.max_batch, spec.max_len
        if self.max_batch % self.plan.dp:
            raise ValueError(
                f"max_batch={self.max_batch} does not split over the "
                f"plan's {self.plan.dp} batch ranks {self.plan.dp_axes}")
        self.temperature = spec.temperature
        # sampling noise: a device generator seeded from the spec (greedy
        # decoding never draws from it)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(spec.seed)
        self.chunk = max(1, min(int(spec.chunk), spec.max_len))
        # debug/oracle mode: keep every row's logits (B, chunk, V) per step
        self.debug_logits = bool(spec.debug_logits)

        # expert-load observability (MoE only): per-expert routed-slot
        # counts summed over layers/steps plus the EP-exchange byte ledger
        self.expert_counts = np.zeros((max(cfg.n_experts, 1),), np.int64)
        self.a2a_bytes_moved = 0
        self.a2a_bytes_worst = 0

        self.faults = FaultInjector(getattr(spec, "faults", ()),
                                    seed=spec.seed)
        self.events: Counter = Counter()
        kvcfg = getattr(spec, "kv", None)
        if self.legacy:          # insert_slot fills dense per-slot buffers
            kvcfg = KVConfig(backend="dense")
        self.kv = make_kv_cache(cfg, kvcfg, self.max_batch, self.max_len,
                                dtype, self.device, plan=self.plan)

        # speculative decoding (resolved ``spec.speculation`` or None): a
        # speculating slot contributes 1 + k rows to the same unified step,
        # greedy verify accepts the longest matching draft prefix plus one
        # bonus token, and the rejected tail rolls back.  Greedy only; the
        # resolver enforces it, this re-checks.
        sc = getattr(spec, "speculation", None)
        self.spec_cfg = self.draft = None
        self.spec_k = 0
        if sc is not None and not self.legacy and self.temperature == 0:
            k = min(int(sc.k), self.chunk - 1)
            if k >= 1:
                self.spec_cfg = sc if sc.k == k \
                    else dataclasses.replace(sc, k=k)
                self.spec_k = k
                self.draft = make_draft(self.spec_cfg, cfg, params,
                                        plan=self.plan,
                                        max_batch=self.max_batch,
                                        max_len=self.max_len, dtype=dtype,
                                        device=self.device)
        self.n_logits = self.spec_k + 1   # logit rows a slot a step
        # per-slot draft tokens planned for the next unified step
        self._drafts: list[Optional[np.ndarray]] = [None] * self.max_batch
        # acceptance accounting: slot-steps that drafted, tokens proposed /
        # accepted, and the EMA that gates drafting (optimistic start, so
        # the first steps always probe)
        self.spec_steps = self.spec_drafted = self.spec_accepted = 0
        self.accept_ema = 1.0

        self.slots: list[Optional[Request]] = [None] * self.max_batch
        # legacy path: each slot's next decode input, kept on the device
        self.cur_tokens = torch.zeros((self.max_batch, 1), dtype=torch.int32,
                                      device=self.device)
        self._pending = [None] * self.max_batch   # tokens to prefill
        self._prompt_pos = [0] * self.max_batch   # pending tokens written
        self._last_tok = [0] * self.max_batch     # last sampled token
        self._admit_seq = [0] * self.max_batch    # admission (prefill FIFO)
        self._seq = 0
        self._step_idx = 0                # engine step counter (fault keys)
        self.n_forward = 0                # steps that ran the model
        self.n_prefill = 0                # legacy blocking prefills
        self.last_step_tokens = 0         # the watchdog's progress signal
        self.last_logits = None                # (B, V) of the last step
        self.step_logits = None                # (B, chunk, V), debug_logits
        self.dtype = dtype

    # -- KV state --------------------------------------------------------
    @property
    def cache(self):
        """The live device KV dict (owned by ``self.kv``)."""
        return self.kv.cache

    # -- validation ------------------------------------------------------
    def validate(self, req: Request) -> None:
        """Reject a request whose prompt + generation can never fit."""
        s = len(req.prompt) + self._front_len()
        need = s + max(0, req.max_new_tokens - 1)
        if self.legacy:
            # the blocking prefill writes a whole bucket-padded buffer into
            # the cache, so the BUCKET must fit, not just the prompt
            need = max(need, _bucket(len(req.prompt)) + self._front_len())
        if len(req.prompt) > MAX_BUCKET or need > self.max_len:
            raise PromptTooLongError(
                f"request {req.rid}: prompt of {len(req.prompt)} tokens "
                f"(+{self._front_len()} frontend, +{req.max_new_tokens} new) "
                f"needs {need} cache positions but max_len={self.max_len} "
                f"(prompt cap {MAX_BUCKET}) — raise max_len, shorten the "
                "prompt, or lower max_new_tokens")
        if self.kv.pool_tokens is not None and need > self.kv.pool_tokens:
            raise PromptTooLongError(
                f"request {req.rid}: needs {need} cache positions but the "
                f"paged KV pool holds {self.kv.pool_tokens} tokens — raise "
                "ServeSpec.kv pool_pages (or leave kv='auto')")

    # -- the step program --------------------------------------------------
    def _unified_impl(self, tokens, q_lens, v_lens):
        """One mixed token-budget iteration.

        tokens (B, chunk), q_lens (B,) int32 on the device; ``v_lens[i] >
        0`` marks a decode slot whose rows are [last committed token, its
        drafts] (None when not speculating).  Returns (tokens (B, n),
        n_emit (B,), last logits (B, V), step_logits, bad (B,),
        expert_counts) with n = 1 + spec_k: slot
        i's committed tokens are ``tokens[i, :n_emit[i]]``; ``bad[i]``
        flags a non-finite sampled-logits row on a scheduled slot.  With
        spec_k == 0 this is the non-speculative program."""
        if self.n_logits > 1:
            return self._verify_impl(tokens, q_lens, v_lens)
        out = forward(self.params, self.cfg, self.plan, tokens=tokens,
                      cache=self.cache, q_lens=q_lens,
                      last_only=not self.debug_logits,
                      expert_stats=self.cfg.is_moe)
        if self.debug_logits:
            rows = (q_lens.long() - 1).clamp_min(0)
            last = out.logits[torch.arange(tokens.shape[0],
                                           device=tokens.device), rows]
            step_logits = out.logits
        else:
            last = out.logits[:, 0]
            step_logits = None
        bad = (q_lens > 0) & ~torch.isfinite(last).all(-1)
        nxt = self._sample(last)
        emit = (q_lens > 0).to(torch.int32)
        return (nxt.to(torch.int32)[:, None], emit, last, step_logits, bad,
                out.expert_counts)

    def _sample(self, last):
        """The next token of each row of ``last`` (B, V): argmax, or a draw
        from the engine's generator at ``temperature > 0``."""
        if self.temperature > 0:
            probs = torch.softmax(last.float() / self.temperature, -1)
            probs = torch.nan_to_num(probs, nan=0.0).clamp_min(0)
            probs[probs.sum(-1) == 0] = 1.0       # quarantined rows
            return torch.multinomial(probs, 1, generator=self.gen)[:, 0]
        return torch.argmax(last, -1)

    def _verify_impl(self, tokens, q_lens, v_lens):
        """The speculative step: one logit row per draft position.  Row j
        is the prediction after rows 0..j (attention is causal per row),
        so draft j+1 is accepted iff it equals row j's argmax; the first
        rejected position's argmax is the bonus token, and the streams are
        the non-speculative greedy ones by construction.  Non-verify slots
        (prefill, v = 0) pin every row to their last valid row.  The
        rejected tail is subtracted from ``cache["length"]`` in place."""
        n = self.n_logits
        dev = tokens.device
        last_row = (q_lens.long() - 1).clamp_min(0)
        j = torch.arange(n, device=dev)
        rows = torch.where((v_lens > 0)[:, None],
                           torch.minimum(j[None, :], last_row[:, None]),
                           last_row[:, None])                  # (B, n)
        out = forward(self.params, self.cfg, self.plan, tokens=tokens,
                      cache=self.cache, q_lens=q_lens,
                      last_only=not self.debug_logits,
                      logit_rows=None if self.debug_logits else rows,
                      expert_stats=self.cfg.is_moe)
        if self.debug_logits:
            sel = out.logits[torch.arange(tokens.shape[0],
                                          device=dev)[:, None], rows]
            step_logits = out.logits
        else:
            sel = out.logits                                   # (B, n, V)
            step_logits = None
        bad = (q_lens > 0) & ~torch.isfinite(sel).all(-1).all(-1)
        greedy = torch.argmax(sel, -1).to(torch.int32)         # (B, n)
        s = (v_lens - 1).clamp_min(0)                          # drafted
        ok = (tokens[:, 1:n] == greedy[:, :n - 1]) \
            & (j[None, :n - 1] < s[:, None])
        # accepted = the longest matching prefix
        acc = torch.cumprod(ok.to(torch.int32), 1).sum(1).to(torch.int32)
        emit = torch.where(q_lens > 0,
                           torch.where(v_lens > 0, acc + 1, 1),
                           0).to(torch.int32)
        rollback = torch.where(v_lens > 0, s - acc, 0).to(torch.int32)
        self.cache["length"].sub_(rollback)
        return (greedy, emit, sel[:, 0], step_logits, bad,
                out.expert_counts)

    def _prefill_impl(self, tokens, real_len: int):
        """The legacy blocking prefill of one bucket-padded prompt (1,
        bucket) into a fresh batch-1 dense cache: the logits of the last
        REAL row and the cache, its length the real length.  On a mesh
        the batch of 1 runs whole on every batch rank (``for_batch``)."""
        cache = init_cache(self.cfg, 1, self.max_len, self.dtype, self.device,
                           self.plan)
        kw = self.embeds_fn(1) if self.embeds_fn is not None else {}
        out = forward(self.params, self.cfg, self.plan, tokens=tokens,
                      cache=cache, **kw)
        # the last real row, clamped to the last row as JAX clamps a traced
        # index (a vision stub served without its embeds reads past the
        # prompt)
        row = min(real_len - 1 + self._front_len(), out.logits.shape[1] - 1)
        last = out.logits[:, row]
        cache["length"] = torch.full((1,), real_len + self._front_len(),
                                     dtype=torch.int32, device=self.device)
        return last, cache

    def _front_len(self) -> int:
        """Frontend positions a request holds ahead of its prompt: the
        vision stub's patch embeddings (whisper's frames feed its encoder
        and take no decoder position)."""
        if self.cfg.frontend == "vision_stub":
            return self.cfg.n_frontend_tokens
        return 0

    def _decode_impl(self, tokens, active):
        """One legacy decode step of every slot: idle slots' states advance
        too, only the active slots' lengths do."""
        length = self.cache["length"]
        before = length.clone()
        out = forward(self.params, self.cfg, self.plan, tokens=tokens,
                      cache=self.cache)
        length.copy_(torch.where(active, length, before))
        return self._sample(out.logits[:, 0]).to(torch.int32)

    # -- slot management -------------------------------------------------
    def free_slots(self) -> list:
        return [i for i, r in enumerate(self.slots) if r is None]

    def slot_of(self, rid: int) -> Optional[int]:
        for i, r in enumerate(self.slots):
            if r is not None and r.rid == rid:
                return i
        return None

    def admit(self, req: Request) -> bool:
        """Admit into a free slot: pure bookkeeping — the slot's pending
        buffer becomes ``prompt + out_tokens`` and the KV cache matches it
        against the prefix index.  Raises ``InjectedFault`` when an
        "admit" fault targets this request (the scheduler sheds it)."""
        self.validate(req)
        fault = self.faults.admit_blocked(self._step_idx, req.rid) \
            if self.faults else None
        if fault is not None:
            raise InjectedFault(
                f"request {req.rid}: injected admission failure "
                f"({fault.describe()})")
        free = self.free_slots()
        if not free:
            return False
        slot = free[0]
        if self.legacy:
            return self._admit_legacy(req, slot)
        self.slots[slot] = req
        # resume replays generated-so-far tokens as a prompt suffix
        self._pending[slot] = np.concatenate(
            [np.asarray(req.prompt, np.int32),
             np.asarray(req.out_tokens, np.int32)]) \
            if req.out_tokens else np.asarray(req.prompt, np.int32)
        # prefix reuse: prefill starts past the cached leading tokens
        self._prompt_pos[slot] = self.kv.begin(slot, self._pending[slot])
        self._last_tok[slot] = 0
        if self.draft is not None:
            self.draft.begin(slot, self._pending[slot])
        self._admit_seq[slot] = self._seq
        self._seq += 1
        if req.t_admitted == 0.0:
            req.t_admitted = time.perf_counter()
        req.state = RequestState.RUNNING
        return True

    def _admit_legacy(self, req: Request, slot: int) -> bool:
        """The blocking prefill: the prompt (not a resumed request's
        generated tokens) padded with id 0 to its bucket, its first token
        the argmax of the last real row, its cache inserted into ``slot``."""
        s = len(req.prompt)
        toks = np.zeros((1, _bucket(s)), np.int32)
        toks[0, :s] = req.prompt
        last_logits, cache1 = self._prefill_impl(
            torch.from_numpy(toks).to(self.device), s)
        self.n_prefill += 1
        first = int(torch.argmax(last_logits[0]))
        insert_slot(self.cache, cache1, slot, self.plan)
        self.cur_tokens[slot, 0] = first
        req.out_tokens.append(first)
        req.t_admitted = req.t_first_token = time.perf_counter()
        req.state = RequestState.RUNNING
        self.slots[slot] = req
        return True

    def release(self, slot: int, state: str, error: str = "",
                reason: str = "") -> Optional[Request]:
        """Free a slot mid-flight: deadline kill, cancel, fault quarantine.
        ``reason`` increments the engine's event counter."""
        req = self.slots[slot]
        if req is None:
            return None
        self.slots[slot] = None
        self._pending[slot] = None
        self._free_draft(slot)
        # a quarantined slot's pages may hold the very NaNs we are
        # quarantining, so they never enter the prefix index
        self.kv.free(slot, keep_prefix=state != RequestState.FAILED)
        req.state = state
        if error:
            req.error = error
        if state in RequestState.TERMINAL:
            req.t_done = time.perf_counter()
        if reason:
            self.events[reason] += 1
        return req

    def cancel(self, rid: int) -> Optional[Request]:
        """Cancel a RUNNING request; frees its slot immediately."""
        slot = self.slot_of(rid)
        if slot is None:
            return None
        return self.release(slot, RequestState.CANCELLED, error="cancelled",
                            reason="cancel")

    def preempt(self, slot: int) -> Optional[Request]:
        """Evict a slot (recompute-on-resume).  ``kv.free`` parks the
        victim's computed full pages in the prefix index, so the resume's
        ``begin`` re-matches them and only the uncached tail is
        recomputed; the resumed stream matches an uninterrupted run."""
        req = self.release(slot, RequestState.PREEMPTED, reason="preempt")
        if req is not None:
            req.n_preempted += 1
        return req

    def victim_slot(self, below_priority: int) -> Optional[int]:
        """Lowest-priority occupied slot strictly below ``below_priority``
        (youngest admission breaks ties)."""
        best = None
        for i, r in enumerate(self.slots):
            if r is None or r.priority >= below_priority:
                continue
            key = (r.priority, -self._admit_seq[i])
            if best is None or key < best[0]:
                best = (key, i)
        return None if best is None else best[1]

    # -- token-budget planning (Sarathi-style, decode-first) -------------
    def plan_q_lens(self, token_budget: Optional[int] = None) -> np.ndarray:
        """Per-slot token counts for the next unified step: decode slots
        get their 1 token first, the remaining budget (default
        ``max_batch * chunk``) goes to prefill chunks in admission order,
        each capped at ``chunk`` and at what ``kv.reserve`` grants.  When
        speculating, draft rows are priced after the decode rows and
        before prefill (``_plan_drafts``)."""
        budget = int(token_budget) if token_budget else \
            self.max_batch * self.chunk
        q = np.zeros((self.max_batch,), np.int32)
        prefilling, decoding = [], []
        for i, r in enumerate(self.slots):
            if r is None or r.terminal:
                continue
            if self._prompt_pos[i] < len(self._pending[i]):
                prefilling.append(i)
            elif not r.done:
                q[i] = self.kv.reserve(i, 1)
                decoding.append(i)
        budget -= int(q.sum())
        if self.draft is not None:
            # a speculating slot costs 1 + k rows; the auto budget
            # max_batch * (1 + k) + chunk keeps the prefill chunk funded
            budget = self._plan_drafts(decoding, q, budget)
        for i in sorted(prefilling, key=lambda j: self._admit_seq[j]):
            if budget <= 0:
                break
            n = min(self.chunk, len(self._pending[i])
                    - self._prompt_pos[i], budget)
            n = self.kv.reserve(i, n)
            q[i] = n
            budget -= n
        return q

    def _plan_drafts(self, decoding: list, q: np.ndarray,
                     budget: int) -> int:
        """Extend decode slots with draft rows, priced against the budget.

        A slot's grant grows from 1 to 1 + k rows, k <= spec_k trimmed by
        the request's remaining generation room, the budget, what the KV
        pool can reserve, and the first proposed id outside the verifier's
        vocabulary (the embedding lookup would fail on it; a draft model
        with a smaller vocabulary never proposes one).  Drafting pauses
        while the acceptance EMA is under the gate, re-probing every
        ``probe_every`` steps.  Returns the remaining budget."""
        self._drafts = [None] * self.max_batch
        sc = self.spec_cfg
        if not decoding or budget <= 0:
            return budget
        if self.accept_ema < sc.min_accept \
                and self._step_idx % sc.probe_every != 0:
            return budget                  # gated off; periodic re-probe
        want, ctx = {}, {}
        for i in decoding:
            if q[i] < 1:
                continue                   # the pool could not extend by 1
            r = self.slots[i]
            # full acceptance commits k + 1 tokens; keep <= max_new_tokens
            room = r.max_new_tokens - len(r.out_tokens) - 1
            k = min(self.spec_k, room, budget)
            if k < 1:
                continue
            ctx[i] = np.concatenate([np.asarray(r.prompt, np.int64),
                                     np.asarray(r.out_tokens, np.int64)])
            want[i] = k
        if not want:
            return budget
        props = self.draft.propose(ctx, want)
        for i in sorted(props, key=lambda jj: self._admit_seq[jj]):
            if budget <= 0:
                break
            d = np.asarray(props[i], np.int64)[:want[i]][:budget]
            bad = np.flatnonzero((d < 0) | (d >= self.cfg.vocab_size))
            if bad.size:
                d = d[:bad[0]]
            if d.size == 0:
                continue
            # the decode row already reserved 1; extend to 1 + k rows (an
            # exhausted pool grants fewer: trim the draft to fit)
            grant = self.kv.reserve(i, 1 + int(d.size))
            d = d[:max(0, grant - 1)]
            if d.size == 0:
                continue
            self._drafts[i] = d
            q[i] += int(d.size)
            budget -= int(d.size)
        return budget

    # -- stepping --------------------------------------------------------
    def step(self, token_budget: Optional[int] = None) -> list:
        """One engine iteration.  Returns retired requests (state DONE, or
        FAILED for NaN-quarantined slots, or PREEMPTED).  Legacy: one
        decode step of every active (prefilled) slot."""
        if self.legacy:
            return self._step_legacy()
        q = self.plan_q_lens(token_budget)
        preempted = []
        # paged-pool deadlock breaker: live slots exist but the pool could
        # not extend ANY of them — free a victim's pages and replan.  Never
        # fires on dense (reserve always grants)
        while (not q.any()
               and any(r is not None and not r.terminal and not r.done
                       for r in self.slots)
               and self.n_active > 1):
            victim = self.victim_slot(1 << 30)
            if victim is None:
                break
            preempted.append(self.preempt(victim))
            q = self.plan_q_lens(token_budget)
        return preempted + self.unified_step(q)

    def _reap(self) -> list:
        """Sweep slots already retired (terminal state set by cancel/
        release) or trivially complete (max_new_tokens satisfied)."""
        retired = []
        for i, r in enumerate(self.slots):
            if r is None:
                continue
            if r.terminal:
                retired.append(r)
            elif r.done:
                r.state = RequestState.DONE
                r.t_done = r.t_done or time.perf_counter()
                retired.append(r)
            else:
                continue
            self.slots[i] = None
            self._pending[i] = None
            self.kv.free(i)
            self._free_draft(i)
        return retired

    def _free_draft(self, slot: int) -> None:
        self._drafts[slot] = None
        if self.draft is not None:
            self.draft.release(slot)

    def unified_step(self, q_lens) -> list:
        """Run the unified step with an explicit per-slot plan."""
        step_idx = self._step_idx
        self._step_idx += 1
        retired = self._reap()
        q_lens = np.asarray(q_lens, np.int32)
        self.last_step_tokens = int(q_lens.sum())
        if self.faults:
            spike = self.faults.step_latency_s(step_idx)
            if spike > 0:
                time.sleep(spike)            # injected straggler
        if not q_lens.any():
            return retired
        toks = np.zeros((self.max_batch, self.chunk), np.int32)
        v_lens = np.zeros((self.max_batch,), np.int32)
        for i, r in enumerate(self.slots):
            n = int(q_lens[i])
            if r is None or n == 0:
                continue
            pos = self._prompt_pos[i]
            if pos < len(self._pending[i]):
                toks[i, :n] = self._pending[i][pos:pos + n]
            else:
                toks[i, 0] = self._last_tok[i]
                d = self._drafts[i]
                if d is not None and n == 1 + len(d):
                    toks[i, 1:n] = d          # verify rows: [t0, d1..dk]
                    v_lens[i] = n
                else:
                    v_lens[i] = min(n, 1)     # plain decode
        self.kv.flush()          # push dirty block tables to device
        self.n_forward += 1
        dev = self.device
        (nxt, emit, self.last_logits, self.step_logits, bad,
         ecnt) = self._unified_impl(
            torch.from_numpy(toks).to(dev), torch.from_numpy(q_lens).to(dev),
            torch.from_numpy(v_lens).to(dev) if self.spec_k else None)
        if ecnt is not None:
            self.expert_counts += ecnt.cpu().numpy().astype(np.int64)
            self._account_a2a(int(q_lens.sum()))
        self.kv.advance(q_lens)  # host length mirror follows the device
        # one (B, n) host read per step, for request bookkeeping
        nxt_host = nxt.cpu().numpy()
        emit_host = emit.cpu().numpy()
        bad_host = bad.cpu().numpy().copy()   # fault injection writes here
        if self.faults:
            live = {i: r.rid for i, r in enumerate(self.slots)
                    if r is not None and q_lens[i] > 0}
            for i in self.faults.nan_slots(step_idx, live):
                bad_host[i] = True           # injected NaN-logits row
                self.last_logits[i] = float("nan")
        now = time.perf_counter()
        for i, r in enumerate(self.slots):
            n = int(q_lens[i])
            if r is None or n == 0:
                continue
            if bad_host[i]:
                # quarantine exactly this slot: non-finite logits never
                # produce a token, never touch a neighbour
                retired.append(self.release(
                    i, RequestState.FAILED, error="non-finite logits",
                    reason="fault"))
                continue
            pos = self._prompt_pos[i]
            if pos < len(self._pending[i]):            # prefill chunk
                self._prompt_pos[i] = pos + n
                if self._prompt_pos[i] < len(self._pending[i]):
                    continue                           # still prefilling
                if r.t_first_token == 0.0:
                    r.t_first_token = now              # prompt done: TTFT
            if r.done:                                 # zero-token budget:
                continue                               # reaped next sweep
            m = int(emit_host[i])                      # accepted + bonus
            s_i = max(int(v_lens[i]) - 1, 0)           # draft rows fed
            if s_i:
                # free the rejected tail's pages (the step already rolled
                # the device length back); counters and the EMA that
                # gates the next plan's drafting
                a_i = m - 1
                self.kv.rollback(i, s_i - a_i)
                self.spec_steps += 1
                self.spec_drafted += s_i
                self.spec_accepted += a_i
                al = self.spec_cfg.ema_alpha
                self.accept_ema = ((1 - al) * self.accept_ema
                                   + al * (a_i / s_i))
            m = min(m, r.max_new_tokens - len(r.out_tokens))
            if m <= 0:
                continue
            committed = [int(t) for t in nxt_host[i, :m]]
            r.out_tokens.extend(committed)
            self._last_tok[i] = committed[-1]
            if self.draft is not None:
                self.draft.observe(i, np.asarray(committed, np.int64))
            r.t_done = now
            if r.done:
                r.state = RequestState.DONE
                retired.append(r)
                self.slots[i] = None
                self._pending[i] = None
                self.kv.free(i)
                self._free_draft(i)
        self._drafts = [None] * self.max_batch    # drafts are one-shot
        return retired

    def spec_stats(self) -> dict:
        """Speculation counters for ServeMetrics."""
        steps, drafted = self.spec_steps, self.spec_drafted
        return {
            "n_spec_steps": int(steps),
            "n_spec_drafted": int(drafted),
            "n_spec_accepted": int(self.spec_accepted),
            "spec_accept_rate":
                float(self.spec_accepted / drafted) if drafted else 0.0,
            "spec_tokens_per_step":
                float((self.spec_accepted + steps) / steps) if steps else 0.0,
        }

    # -- expert-load / EP-exchange observability -------------------------
    def _account_a2a(self, step_tokens: int) -> None:
        """Price the step's EP exchange into the byte ledger: what the
        RESOLVED deployment would move (``moved`` under the count-bounded
        micro-chunked extent, ``worst`` under monolithic worst-case
        buffers), dispatch + combine over every MoE layer."""
        cfg, spec = self.cfg, self.spec
        ep = int(getattr(spec, "moe_ep", 1) or 1)
        if not cfg.is_moe or step_tokens <= 0 or ep <= 1:
            return
        n_moe_layers = cfg.n_layers - cfg.first_dense_layers
        n_rows = step_tokens * cfg.top_k     # routed slots per MoE layer
        ovl = getattr(spec, "ep_overlap", None)
        if ovl is None or getattr(ovl, "chunks", 1) <= 1:
            rows_moved = ep * n_rows         # monolithic worst-case extent
        else:
            chunks = max(1, math.gcd(int(ovl.chunks), step_tokens))
            n_chunk_rows = (step_tokens // chunks) * cfg.top_k
            cap = cap_rows_for(n_chunk_rows, ep, ovl)
            rows_moved = ep * chunks * cap   # count-bounded extent
        # the fused RS-A2A-AG ("fused" / "sync") ships the TP shard
        # (h / moe_tp); the unfused ladder moves full-width rows
        moe_tp = int(getattr(spec, "moe_tp", 1) or 1)
        width = cfg.d_model
        if getattr(spec.plan, "comm_algo", "") in ("fused", "sync"):
            width = cfg.d_model // max(moe_tp, 1)
        elem = torch.empty((), dtype=self.dtype).element_size()
        per_row = width * elem * 2 * n_moe_layers      # dispatch + combine
        self.a2a_bytes_moved += rows_moved * per_row
        self.a2a_bytes_worst += ep * n_rows * per_row

    def ep_load_stats(self) -> dict:
        """Expert-load skew bucketed by resolved EP rank + the A2A ledger."""
        counts = self.expert_counts
        ep = int(getattr(self.spec, "moe_ep", 1) or 1)
        if not self.cfg.is_moe or counts.sum() == 0:
            return {"ep_rank_max_tokens": 0, "ep_rank_mean_tokens": 0.0,
                    "a2a_bytes_moved": int(self.a2a_bytes_moved),
                    "a2a_bytes_worst": int(self.a2a_bytes_worst)}
        if ep <= 1 or counts.shape[0] % ep:
            ep = 1                      # degenerate bucketing: one rank
        per_rank = counts.reshape(ep, counts.shape[0] // ep).sum(axis=1)
        return {"ep_rank_max_tokens": int(per_rank.max()),
                "ep_rank_mean_tokens": float(per_rank.mean()),
                "a2a_bytes_moved": int(self.a2a_bytes_moved),
                "a2a_bytes_worst": int(self.a2a_bytes_worst)}

    def _step_legacy(self) -> list:
        step_idx = self._step_idx
        self._step_idx += 1
        if self.faults:
            spike = self.faults.step_latency_s(step_idx)
            if spike > 0:
                time.sleep(spike)            # injected straggler
        # reap requests already complete or externally released: the
        # blocking prefill emits the first token inside admit, so a
        # max_new_tokens == 1 request is done before its first decode step
        finished = self._reap()
        occupied = [r is not None for r in self.slots]
        self.last_step_tokens = sum(occupied)
        if not any(occupied):
            return finished
        self.n_forward += 1
        nxt = self._decode_impl(self.cur_tokens, torch.tensor(
            occupied, device=self.device))
        # the next step's inputs stay on the device; the host reads the
        # tokens once, for request bookkeeping
        self.cur_tokens = nxt[:, None]
        now = time.perf_counter()
        nxt_host = nxt.cpu().numpy()
        for i, r in enumerate(self.slots):
            if r is None:
                continue
            r.out_tokens.append(int(nxt_host[i]))
            r.t_done = now
            if r.done:
                r.state = RequestState.DONE
                finished.append(r)
                self.slots[i] = None
        return finished

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self.slots)


__all__ = ["Engine", "Request", "RequestState", "PromptTooLongError",
           "unified_supported", "resolve_device", "MAX_BUCKET"]
