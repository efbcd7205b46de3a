"""Draft sources for speculative decoding on the unified ragged step.

The verify side is the engine's existing ``(B, chunk)`` step: a
speculating slot contributes ``q_len = 1 + k`` rows (its last committed
token, then k draft tokens) instead of 1, and ``model.forward(logit_rows=)``
scores every draft position in the same pass.  This module is the draft
side: where the k proposed tokens come from.

``NGramDraft``
    suffix matching: the context's trailing (n-1)-gram is searched
    backwards through the context, and on a match the tokens that followed
    it are proposed.  No compute, no state.

``ModelDraft``
    a model proposing greedily on its own dense per-slot KV cache, fed in
    ``DRAFT_CHUNK``-row unified steps, with host mirrors of what each slot
    has consumed.  ``draft="self"`` reuses the serving model's own cfg and
    params object (greedy self-drafts are always accepted; on a mesh it
    runs under the serving plan, on a dense cache of the rank's rows and
    heads); any other config name runs that config reduced, with random
    weights, whole on every rank.

``MTPDraft``
    the interface stub of a DeepSeek-V3-style multi-token-prediction head:
    no trained MTP weights ship with this repo, so it raises.

Proposals are hints: the engine trims them against the token budget, the
KV pool and the verifier's vocabulary, and only the verify step commits
tokens, so a wrong draft never changes a greedy stream.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

import repro_torch.configs as C
from repro_torch.configs.base import ModelConfig
from repro_torch.core.partitioner import NULL_PLAN, ShardingPlan
from repro_torch.core.resolve import SpeculationConfig
from repro_torch.models.model import forward, init_params
from repro_torch.serving.kv_cache import make_batched_cache

# a model draft's catch-up feeds context in steps of this many rows
DRAFT_CHUNK = 16


class DraftSource:
    """Per-engine draft proposer (one instance, all slots)."""

    name = "none"
    n_forward = 0          # draft-model forwards run (0 without a model)

    def begin(self, slot: int, tokens: np.ndarray) -> None:
        """A request was admitted to ``slot`` with ``tokens`` context."""

    def observe(self, slot: int, committed: np.ndarray) -> None:
        """The verify step committed ``committed`` tokens for ``slot``."""

    def release(self, slot: int) -> None:
        """The slot was freed (done / failed / preempted)."""

    def propose(self, ctx: dict[int, np.ndarray],
                want: dict[int, int]) -> dict[int, np.ndarray]:
        """slot -> up to ``want[slot]`` proposed next tokens, given each
        slot's committed context (prompt + outputs).  May return fewer (or
        no) tokens for a slot, never more."""
        raise NotImplementedError


class NGramDraft(DraftSource):
    """Propose the continuation of the most recent earlier occurrence of
    the context's trailing (n-1)-gram."""

    name = "ngram"

    def __init__(self, ngram: int = 3):
        self.g = max(int(ngram) - 1, 1)

    def propose(self, ctx, want):
        out = {}
        for slot, k in want.items():
            toks, g = ctx[slot], self.g
            if k < 1 or len(toks) < g + 1:
                continue
            pat = toks[-g:]
            for st in range(len(toks) - g - 1, -1, -1):   # newest first
                if np.array_equal(toks[st:st + g], pat):
                    prop = toks[st + g:st + g + k]
                    if prop.size:
                        out[slot] = prop.astype(np.int64)
                    break
        return out


class ModelDraft(DraftSource):
    """A model drafting greedily on its own dense per-slot KV cache.

    ``_len[slot]`` (host) counts the tokens the draft model has consumed
    and is authoritative: the forward advances ``cache["length"]`` in
    place, so ``_run`` writes the host mirror into that tensor before
    every call, and rows the draft wrote past a rejection become inert
    ragged-tail rows.  When the committed stream departs from what the
    draft consumed, the slot replays from scratch on its next propose.
    A context id outside the draft's vocabulary (a foreign draft with a
    smaller one) is read as its last id, the clamp the reference's
    docstring gives ``jnp.take``.

    On a mesh every rank runs the same host logic on the same contexts:
    under a mesh plan the forward returns every slot's whole logits on
    every rank (all-gathered), so the argmax, and with it the proposals,
    agree across ranks.
    """

    name = "model"

    def __init__(self, cfg: ModelConfig, params, *,
                 plan: ShardingPlan = NULL_PLAN, max_batch: int = 8,
                 max_len: int = 512, dtype=torch.bfloat16, device="cuda"):
        self.cfg, self.params, self.plan = cfg, params, plan
        self.max_len = max_len
        self.device = torch.device(device)
        self.cache = make_batched_cache(cfg, max_batch, max_len, dtype,
                                        self.device, plan)
        self._len = np.zeros(max_batch, np.int64)    # tokens consumed
        self._fed: list[Optional[np.ndarray]] = [None] * max_batch
        self.n_forward = 0

    def _run(self, toks: np.ndarray, q: np.ndarray) -> np.ndarray:
        """One draft step: feed ``toks`` rows per ``q`` lengths at the host
        mirror's offsets; return each slot's greedy next token."""
        self.cache["length"].copy_(torch.from_numpy(
            self._len.astype(np.int32)))
        dev = self.device
        toks = np.minimum(toks, self.cfg.vocab_size - 1)
        out = forward(self.params, self.cfg, self.plan,
                      tokens=torch.from_numpy(toks).to(dev),
                      cache=self.cache,
                      q_lens=torch.from_numpy(q.astype(np.int32)).to(dev),
                      last_only=True)
        self.n_forward += 1
        self._len += q.astype(np.int64)
        return torch.argmax(out.logits[:, 0], -1).cpu().numpy()

    def release(self, slot: int) -> None:
        self._len[slot] = 0
        self._fed[slot] = None

    def observe(self, slot: int, committed: np.ndarray) -> None:
        fed = self._fed[slot]
        if fed is None:
            return
        # a departure (rejected drafts) is found lazily in propose: the
        # engine's context is the truth, _fed what the draft consumed
        self._fed[slot] = np.concatenate(
            [fed, np.asarray(committed, fed.dtype)])

    def _sync(self, slot: int, ctx: np.ndarray) -> bool:
        """Catch the slot's draft cache up to ``ctx[:-1]`` (the propose
        loop feeds the last token).  False when the context does not fit
        the draft cache."""
        if len(ctx) > self.max_len - 1:
            return False
        fed = self._fed[slot]
        n_ok = int(self._len[slot])
        if fed is None or n_ok > len(ctx) \
                or not np.array_equal(fed[:n_ok], ctx[:n_ok]):
            n_ok = 0                   # departed: replay from scratch
            self._len[slot] = 0
        self._fed[slot] = ctx
        b = len(self._len)
        pos = n_ok
        while pos < len(ctx) - 1:      # one slot, DRAFT_CHUNK rows a step
            n = min(DRAFT_CHUNK, len(ctx) - 1 - pos)
            toks = np.zeros((b, DRAFT_CHUNK), np.int32)
            q = np.zeros(b, np.int32)
            toks[slot, :n] = ctx[pos:pos + n]
            q[slot] = n
            self._run(toks, q)
            pos += n
        return True

    def propose(self, ctx, want):
        live = {}
        for slot, k in want.items():
            if k >= 1 and self._sync(slot, np.asarray(ctx[slot], np.int32)):
                live[slot] = k
        if not live:
            return {}
        b = len(self._len)
        props = {slot: [] for slot in live}
        # round 0 feeds each slot's last committed token -> d_1; round j
        # feeds d_j -> d_{j+1}
        cur = {slot: int(ctx[slot][-1]) for slot in live}
        for j in range(max(live.values())):
            toks = np.zeros((b, DRAFT_CHUNK), np.int32)
            q = np.zeros(b, np.int32)
            for slot, k in live.items():
                if j < k:
                    toks[slot, 0] = cur[slot]
                    q[slot] = 1
            nxt = self._run(toks, q)
            for slot, k in live.items():
                if j < k:
                    cur[slot] = int(nxt[slot])
                    props[slot].append(cur[slot])
        # the mirrors return to the committed context: the rows fed for
        # the proposals are stale from here on
        for slot in live:
            self._len[slot] = len(ctx[slot])
            self._fed[slot] = np.asarray(ctx[slot], np.int32)
        return {slot: np.asarray(p, np.int64)
                for slot, p in props.items() if p}


class MTPDraft(DraftSource):
    """DeepSeek-V3-style multi-token-prediction head (interface stub).

    Contract (Megatron-Core MTP shape): k extra transformer blocks, block j
    consuming [the backbone's hidden state at t; the embedding of token
    t+j] through a projection to predict position t+j+1.  It needs
    trained MTP weights beside the serving checkpoint; none ship with this
    repo, so construction raises.
    """

    name = "mtp"

    def __init__(self, *_, **__):
        raise NotImplementedError(
            "MTP drafting needs trained multi-token-prediction head "
            "weights (DeepSeek-V3 / Megatron-Core MTP shape); none ship "
            "with this repo — use draft='ngram', 'self', or a config name")


def make_draft(sc: SpeculationConfig, cfg: ModelConfig, params, *,
               plan: ShardingPlan = NULL_PLAN, max_batch: int = 8,
               max_len: int = 512, dtype=torch.bfloat16,
               device="cuda") -> DraftSource:
    """The draft source a resolved ``SpeculationConfig`` names.

    "ngram" -> NGramDraft; "self" -> ModelDraft on the serving model's own
    cfg and params object under the serving plan (on a mesh: sharded as
    the serve); "mtp" -> the stub (raises); any other name -> that config
    reduced, with weights drawn from a generator seeded 0 on ``device``,
    run unsharded with the serving plan's kernel policy: on a mesh every
    rank draws the same weights and runs the whole draft, as the
    reference runs a foreign draft replicated under ``NULL_PLAN``.
    """
    if sc.draft == "ngram":
        return NGramDraft(ngram=sc.ngram)
    if sc.draft == "mtp":
        return MTPDraft()
    kw = dict(max_batch=max_batch, max_len=max_len, dtype=dtype,
              device=device)
    if sc.draft == "self":
        return ModelDraft(cfg, params, plan=plan, **kw)
    dcfg = C.get_reduced(sc.draft)     # raises KeyError on unknown arch
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    dparams = init_params(gen, dcfg, dtype, device)
    return ModelDraft(dcfg, dparams,
                      plan=ShardingPlan(kernels=plan.kernels), **kw)


__all__ = ["DraftSource", "NGramDraft", "ModelDraft", "MTPDraft",
           "make_draft", "DRAFT_CHUNK"]
