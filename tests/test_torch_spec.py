"""The port's speculative decoding against the reference's
(tests/test_spec_decode.py's properties, on both packages).

Greedy streams with speculation on must be bit-identical to the
non-speculative run and to the reference's speculated run on the same
weights (carried across through numpy) and the same seeded prompts: the
self draft (every draft accepted), the n-gram draft, and a foreign reduced
model whose random weights propose near-garbage (every step rejects and
rolls back).  The acceptance counters (``n_spec_steps / drafted /
accepted``) must equal the reference's exactly.  Planner, rollback and
draft-source units are held against the reference's code on the same
state.  Float32 on the CPU; kernels resolve to off there (``auto``).
"""


import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _engine_helpers import make_engine as r_make_engine  # noqa: E402
from _torch_helpers import both_params, jj, tt  # noqa: E402
from repro.core.partitioner import make_plan as r_make_plan  # noqa: E402
from repro.core.resolve import SpeculationConfig as RSC  # noqa: E402
from repro.models import model as RMOD  # noqa: E402
from repro.serving import kv_cache as RKV  # noqa: E402
from repro.serving.draft import NGramDraft as RNGram  # noqa: E402
from repro.serving.engine import Request as RRequest  # noqa: E402
from repro.serving.scheduler import Scheduler as RScheduler  # noqa: E402
from repro.serving.scheduler import synthetic_workload as r_workload  # noqa
from repro_torch.bridge import from_reference  # noqa: E402
from repro_torch.core.partitioner import make_plan as t_make_plan  # noqa
from repro_torch.core.resolve import AUTO  # noqa: E402
from repro_torch.core.resolve import SpeculationConfig as TSC  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import model as TMOD  # noqa: E402
from repro_torch.serving import kv_cache as TKV  # noqa: E402
from repro_torch.serving.api import LLM, ServeSpec  # noqa: E402
from repro_torch.serving.draft import (DRAFT_CHUNK, DraftSource,  # noqa
                                       ModelDraft, MTPDraft, NGramDraft,
                                       make_draft)
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from repro_torch.serving.scheduler import Scheduler  # noqa: E402
from repro_torch.serving.scheduler import mixed_workload  # noqa: E402
from repro_torch.serving.scheduler import synthetic_workload  # noqa: E402

ARCHS = {"gqa": "smollm-360m", "moe": "phi3.5-moe-42b",
         "mla": "minicpm3-4b"}


@pytest.fixture(scope="module")
def models():
    return {k: both_params(a) for k, a in ARCHS.items()}


def _t_spec(cfg, *, max_batch=8, max_len=512, chunk=16, token_budget=0,
            **kw):
    """The port's twin of tests/_engine_helpers.make_spec."""
    return ServeSpec(max_batch=max_batch, max_len=max_len, chunk=chunk,
                     token_budget=token_budget
                     or max_batch * min(chunk, max_len),
                     kernels=AUTO, dispatch=AUTO, temperature=0.0, seed=0,
                     **kw).resolve(cfg, device="cpu")


def t_engine(cfg, params, **knobs):
    return Engine(cfg, params, spec=_t_spec(cfg, **knobs), device="cpu")


def _ref_sc(sc):
    """The reference's SpeculationConfig of a port one ("off" passes)."""
    if isinstance(sc, TSC):
        return RSC(k=sc.k, draft=sc.draft, ngram=sc.ngram,
                   min_accept=sc.min_accept, ema_alpha=sc.ema_alpha,
                   probe_every=sc.probe_every)
    return sc


def _serve(make, sched_cls, workload, cfg, params, speculation, *,
           kv="dense", n=4, prompt_len=10, out=8, batch=2, max_len=64,
           chunk=8, swap=None, **kw):
    eng = make(cfg, params, max_batch=batch, max_len=max_len, chunk=chunk,
               kv=kv, prompt_len=prompt_len, max_new_tokens=out,
               speculation=speculation, **kw)
    if swap is not None:
        eng.draft = swap(eng)
    sched = sched_cls(eng)
    for r in workload(n, prompt_len=prompt_len, max_new_tokens=out,
                      vocab=cfg.vocab_size):
        sched.submit(r)
    done = sched.run()
    assert len(done) == n
    assert all(len(r.out_tokens) == r.max_new_tokens for r in done)
    return {r.rid: list(r.out_tokens) for r in done}, eng, sched


def both_serves(model, speculation, **kw):
    """(port streams, port engine, reference streams, reference engine)
    on the same weights and workload."""
    rcfg, rp, tcfg, tp = model
    t_out, t_eng, _ = _serve(t_engine, Scheduler, synthetic_workload, tcfg,
                             tp, speculation, **kw)
    r_out, r_eng, _ = _serve(r_make_engine, RScheduler, r_workload, rcfg,
                             rp, _ref_sc(speculation), **kw)
    return t_out, t_eng, r_out, r_eng


def port_off(model, **kw):
    _, _, tcfg, tp = model
    return _serve(t_engine, Scheduler, synthetic_workload, tcfg, tp, "off",
                  **kw)[0]


# ---------------------------------------------------------------------------
# streams: bit-identical to non-speculative decoding and to the reference
# ---------------------------------------------------------------------------

# (model, k, kv, workload size): smollm at k 1, 2, 4 on the dense backend
# and k 4 paged; the MoE (count-independent dropless dispatch) and the
# MLA model (latent cache) on both backends
SELF_CASES = ([("gqa", k, "dense", 4, 8) for k in (1, 2, 4)]
              + [("gqa", 4, "auto", 4, 8)]
              + [(m, 2, kv, 3, 6) for m in ("moe", "mla")
                 for kv in ("dense", "auto")])


@pytest.mark.parametrize("case", SELF_CASES, ids=lambda c: "-".join(
    map(str, c[:3])))
def test_self_draft_streams_equal_off_and_reference(models, case):
    name, k, kv, n, out = case
    model = models[name]
    t_out, eng, r_out, r_eng = both_serves(
        model, TSC(k=k, draft="self"), kv=kv, n=n, out=out)
    assert eng.kv.backend == ("dense" if kv == "dense" else "paged")
    assert t_out == port_off(model, kv=kv, n=n, out=out)
    assert t_out == r_out
    st = eng.spec_stats()
    assert st == r_eng.spec_stats()
    assert st["n_spec_steps"] > 0
    assert st["spec_accept_rate"] == 1.0
    assert st["spec_tokens_per_step"] > 1.0
    # self draft: the serving model's own params object, its forwards
    # counted; the draft's dense cache is the model's per-slot layout
    assert isinstance(eng.draft, ModelDraft)
    assert eng.draft.params is eng.params and eng.draft.n_forward > 0
    assert eng.draft.cache["length"].shape == (eng.max_batch,)


def reference_draft(r_eng):
    """A swap for ``_serve``: the port engine's foreign draft rebuilt on
    the reference engine's draft weights (drawn with JAX's generator)."""
    import jax

    def swap(eng):
        dcfg = eng.draft.cfg
        assert dcfg.name == r_eng.draft.cfg.name != eng.cfg.name
        return ModelDraft(dcfg, from_reference(
            jax.tree.map(np.asarray, r_eng.draft.params), dcfg),
            plan=eng.draft.plan, max_batch=eng.max_batch,
            max_len=eng.max_len, dtype=torch.float32, device="cpu")
    return swap


@pytest.mark.parametrize("draft", ["self", "ngram", "gemma-2b"])
def test_acceptance_counters_equal_reference(models, draft):
    """Streams equal and the counters equal the reference's exactly, for
    the self draft, the n-gram draft and a foreign reduced gemma-2b draft
    on the reference's own draft weights (paged KV: rejected tails free
    their pages)."""
    rcfg, rp, tcfg, tp = models["gqa"]
    kw = dict(kv="auto", n=4, out=10)
    sc = TSC(k=4, draft=draft, min_accept=0.0)
    if draft == "ngram":
        # bigram matches over 24-token prompts: a random model's output
        # seldom repeats a longer suffix
        kw.update(n=3, prompt_len=24, out=16)
        sc = TSC(k=3, draft=draft, ngram=2, min_accept=0.0)
    r_out, r_eng, _ = _serve(r_make_engine, RScheduler, r_workload, rcfg,
                             rp, _ref_sc(sc), **kw)
    t_out, eng, _ = _serve(t_engine, Scheduler, synthetic_workload, tcfg,
                           tp, sc, swap=reference_draft(r_eng)
                           if draft == "gemma-2b" else None, **kw)
    assert t_out == port_off(models["gqa"], **kw)
    if draft == "ngram":
        assert isinstance(eng.draft, NGramDraft)
        assert eng.draft.n_forward == 0
    assert t_out == r_out
    st = eng.spec_stats()
    assert st == r_eng.spec_stats()
    assert st["n_spec_drafted"] > 0
    if draft == "gemma-2b":
        assert st["n_spec_accepted"] < st["n_spec_drafted"]  # rollbacks


def test_foreign_draft_from_make_draft_keeps_streams(models):
    """``make_draft``'s own foreign draft (weights from a seeded torch
    generator): low acceptance, every stream still the non-speculative
    one, and the verifier's vocabulary never exceeded."""
    _, _, tcfg, tp = models["gqa"]
    sc = TSC(k=4, draft="gemma-2b", min_accept=0.0)
    out, eng, sched = _serve(t_engine, Scheduler, synthetic_workload, tcfg,
                             tp, sc, kv="auto")
    assert out == port_off(models["gqa"], kv="auto")
    assert eng.draft.cfg.name != tcfg.name
    assert eng.draft.plan.kernels == eng.plan.kernels
    assert not eng.draft.plan.enabled
    m = sched.metrics()
    assert m.n_spec_drafted > 0 and m.n_spec_accepted < m.n_spec_drafted


def test_debug_logits_verify_streams(models):
    """The debug-logits verify (every row's logits, rows gathered after
    the head) commits the same streams as the logit_rows hot path."""
    model = models["gqa"]
    sc = TSC(k=2, draft="self")
    hot, eng, _ = _serve(t_engine, Scheduler, synthetic_workload,
                         model[2], model[3], sc)
    dbg, deng, _ = _serve(t_engine, Scheduler, synthetic_workload,
                          model[2], model[3], sc, debug_logits=True)
    assert dbg == hot == port_off(model)
    assert deng.step_logits.shape == (2, 8, model[2].padded_vocab)
    assert deng.spec_stats() == eng.spec_stats()


def test_speculation_off_never_runs_the_verify_program(models,
                                                      monkeypatch):
    """speculation="off": no draft, n = 1 logit row, and the step never
    enters the verify program nor uploads a v_lens vector."""
    model = models["gqa"]
    monkeypatch.setattr(Engine, "_verify_impl", None)   # a call raises
    seen = []
    orig = Engine._unified_impl

    def spy(self, tokens, q_lens, v_lens):
        seen.append(v_lens)
        return orig(self, tokens, q_lens, v_lens)
    monkeypatch.setattr(Engine, "_unified_impl", spy)
    _, eng, _ = _serve(t_engine, Scheduler, synthetic_workload, model[2],
                       model[3], "off")
    assert eng.draft is None and eng.spec_k == 0 and eng.n_logits == 1
    assert seen and all(v is None for v in seen)


# ---------------------------------------------------------------------------
# model.forward(logit_rows=)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(ARCHS))
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_forward_logit_rows_match_reference(models, name, paged):
    """A mixed step (a 4-row verify block, a prefill chunk, a 1-row
    decode, an idle slot) with logit_rows: (b, n, V) logits equal to the
    reference's and to every row's logits gathered at those rows."""
    rcfg, rp, tcfg, tp = models[name]
    b, s, max_len, n = 4, 8, 16, 4
    q = np.array([4, 8, 1, 0], np.int32)
    rows = np.array([[0, 1, 2, 3], [7, 7, 7, 7], [0, 0, 0, 0],
                     [0, 0, 0, 0]], np.int32)
    toks = np.random.default_rng(3).integers(
        0, rcfg.vocab_size, (b, s)).astype(np.int32)
    r_plan, t_plan = r_make_plan("mixserve", None), t_make_plan("mixserve")

    def caches():
        if paged:
            bt = np.arange(b * (max_len // 4), dtype=np.int32).reshape(b, -1)
            r = RMOD.init_paged_cache(rcfg, b, max_len, page_size=4,
                                      pool_pages=bt.size, dtype=np.float32)
            t = TMOD.init_paged_cache(tcfg, b, max_len, page_size=4,
                                      pool_pages=bt.size,
                                      dtype=torch.float32, device="cpu")
            t["block_tables"].copy_(tt(bt))
            return {**r, "block_tables": jj(bt)}, t
        return (RKV.make_batched_cache(rcfg, b, max_len, np.float32),
                TKV.make_batched_cache(tcfg, b, max_len, torch.float32,
                                       "cpu"))
    r_cache, t_cache = caches()
    want = np.asarray(RMOD.forward(
        rp, rcfg, r_plan, tokens=jj(toks), cache=r_cache, q_lens=jj(q),
        last_only=True, logit_rows=jj(rows)).logits)
    got = TMOD.forward(tp, tcfg, t_plan, tokens=tt(toks), cache=t_cache,
                       q_lens=tt(q), last_only=True, logit_rows=tt(rows))
    assert got.logits.shape == (b, n, tcfg.padded_vocab)
    assert t_cache["length"].tolist() == q.tolist()
    live = q > 0
    np.testing.assert_allclose(got.logits.numpy()[live], want[live],
                               rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))
    _, t_full = caches()
    full = TMOD.forward(tp, tcfg, t_plan, tokens=tt(toks), cache=t_full,
                        q_lens=tt(q)).logits
    np.testing.assert_array_equal(
        got.logits.numpy()[live],
        full.numpy()[np.arange(b)[:, None], rows][live])
    with pytest.raises(ValueError, match="logit_rows requires last_only"):
        TMOD.forward(tp, tcfg, t_plan, tokens=tt(toks), cache=caches()[1],
                     q_lens=tt(q), logit_rows=tt(rows))


# ---------------------------------------------------------------------------
# KV rollback
# ---------------------------------------------------------------------------

# (prefix tokens cached, grants and advances, rollback n): a rollback
# inside the last page, one across a page boundary, one back onto the
# shared prefix boundary, and n = 0
ROLLBACK_CASES = [(0, (9, 5), 3), (0, (9, 5), 6), (8, (3, 5), 8),
                  (0, (4,), 0)]


@pytest.mark.parametrize("case", ROLLBACK_CASES, ids=str)
def test_paged_rollback_frees_exactly_the_tail_pages(models, case):
    """The port's PagedKVCache against the reference's on the same
    calls: freed pages, block tables, refcounts, the free list and the
    host lengths equal; only pages past ceil(new_len / page) are freed,
    and an indexed prefix page never reaches the free list."""
    prefix, steps, n = case
    rcfg, _, tcfg, _ = models["gqa"]
    kw = dict(page_size=4, pool_pages=16, prefix_cache=True)
    r = RKV.PagedKVCache(rcfg, 2, 32, dtype=np.float32, **kw)
    t = TKV.PagedKVCache(tcfg, 2, 32, dtype=torch.float32, device="cpu",
                         **kw)
    toks = np.arange(1, 21, dtype=np.int32)
    for kv in (r, t):
        if prefix:       # a finished request parks its prompt's pages
            kv.begin(1, toks[:prefix + 1])
            kv.reserve(1, prefix + 1)
            kv.advance(np.array([0, prefix + 1]))
            kv.free(1)
        assert kv.begin(0, toks) == prefix
        for g in steps:
            kv.reserve(0, g)
            kv.advance(np.array([g, 0]))
    before = int(t.n_blocks[0])
    got, want = t.rollback(0, n), r.rollback(0, n)
    assert got == want
    for a in ("bt", "ref", "n_blocks", "lengths"):
        np.testing.assert_array_equal(getattr(t, a), getattr(r, a))
    assert t._free == r._free
    new_len = prefix + sum(steps) - n
    assert int(t.lengths[0]) == new_len
    assert int(t.n_blocks[0]) == -(-new_len // 4)
    assert got == before - int(t.n_blocks[0])
    assert all(p not in t._free for p in t._node_of_page)
    dense = TKV.DenseKVCache(tcfg, 2, 32, torch.float32, "cpu")
    dense.cache["length"][0] = 9
    assert dense.rollback(0, 3) == 0
    assert dense.cache["length"].tolist() == [9, 0]   # the step's job


def test_shared_prefix_pages_unchanged_through_speculation(models):
    """A speculating request decoding on top of indexed prefix pages,
    with a foreign draft whose rejections roll its tail back toward the
    prefix boundary: the shared pages' bytes never change."""
    _, _, tcfg, tp = models["gqa"]
    prompt = np.random.default_rng(9).integers(
        0, tcfg.vocab_size, 40).astype(np.int32)
    eng = t_engine(tcfg, tp, max_batch=2, max_len=128, chunk=8, kv="auto",
                   prompt_len=40, max_new_tokens=8,
                   speculation=TSC(k=4, draft="gemma-2b", min_accept=0.0))
    sched = Scheduler(eng)
    sched.submit(Request(rid=0, prompt=prompt, max_new_tokens=4))
    sched.run()                          # the cold run parks its pages
    shared = sorted(eng.kv._node_of_page)
    assert shared
    snap = [{k: v[:, shared].clone() for k, v in g.items()}
            for g in eng.kv.cache["groups"]]
    sched2 = Scheduler(eng)
    sched2.submit(Request(rid=1, prompt=prompt, max_new_tokens=8))
    assert len(sched2.run()) == 1
    assert eng.kv.stats.n_prefix_hits == 1
    assert eng.spec_stats()["n_spec_drafted"] > 0
    for g, s in zip(eng.kv.cache["groups"], snap):
        for name, t in g.items():
            assert torch.equal(t[:, shared], s[name]), name


def test_preempt_resume_with_speculation(models):
    """Preemption mid-speculation and a cache-preserving resume (paged)
    land on the uninterrupted non-speculative stream, the reference's."""
    rcfg, rp, tcfg, tp = models["gqa"]
    prompt = np.random.default_rng(5).integers(
        0, tcfg.vocab_size, 40).astype(np.int32)
    kw = dict(max_batch=1, max_len=128, chunk=8, kv="auto", prompt_len=40,
              max_new_tokens=8)
    outs = []
    for make, req_cls, sc in ((t_engine, Request, TSC(k=2, draft="self")),
                              (r_make_engine, RRequest,
                               RSC(k=2, draft="self"))):
        eng = make(tcfg if make is t_engine else rcfg,
                   tp if make is t_engine else rp, speculation=sc, **kw)
        r = req_cls(rid=0, prompt=prompt, max_new_tokens=8)
        assert eng.admit(r)
        for _ in range(6):               # 5 prefill steps + 1 verify step
            eng.step()
        assert 1 <= len(r.out_tokens) < 8
        assert eng.preempt(0) is r
        assert eng.admit(r)              # resume re-matches prompt pages
        assert eng.kv.stats.n_prefix_hits == 1
        while not r.done:
            eng.step()
        outs.append((list(r.out_tokens), eng.spec_stats()))
    base = t_engine(tcfg, tp, speculation="off", **kw)
    r2 = Request(rid=1, prompt=prompt, max_new_tokens=8)
    assert base.admit(r2)
    while not r2.done:
        base.step()
    assert outs[0] == outs[1]
    assert outs[0][0] == list(r2.out_tokens)


# ---------------------------------------------------------------------------
# the planner: 1 + k rows, decode first, prefill funded, trims, EMA gate
# ---------------------------------------------------------------------------

def _decode_ready(model, *, speculation, n_req=1, **kw):
    """(port engine, reference engine) with ``n_req`` slots past prefill."""
    rcfg, rp, tcfg, tp = model
    engs = []
    for make, cfg, p, req_cls, sc in (
            (t_engine, tcfg, tp, Request, speculation),
            (r_make_engine, rcfg, rp, RRequest, _ref_sc(speculation))):
        eng = make(cfg, p, max_batch=2, max_len=64, chunk=8, prompt_len=10,
                   max_new_tokens=kw.get("max_new_tokens", 8),
                   speculation=sc)
        rng = np.random.default_rng(0)
        for rid in range(n_req):
            pr = rng.integers(0, cfg.vocab_size, 10).astype(np.int32)
            assert eng.admit(req_cls(rid=rid, prompt=pr,
                                     max_new_tokens=kw.get(
                                         "max_new_tokens", 8)))
        while any(eng._prompt_pos[i] < len(eng._pending[i])
                  for i in range(n_req)):
            eng.unified_step(eng.plan_q_lens())
        engs.append(eng)
    return engs


def _admit_both(engs, rid, seed, new=4):
    for eng, cls in zip(engs, (Request, RRequest)):
        p = np.random.default_rng(seed).integers(
            0, eng.cfg.vocab_size, 10).astype(np.int32)
        assert eng.admit(cls(rid=rid, prompt=p, max_new_tokens=new))


def _drafts(eng):
    return [None if d is None else d.tolist() for d in eng._drafts]


# (speculation, requests decoding, an extra prefill admitted, budgets,
# the port's expected plans): a speculating slot costs 1 + k rows after
# every decode row (budget 4: slot 0 takes both spare rows, slot 1 none;
# budget 2: no draft at all); a waiting prefill still gets rows beside a
# k=4 verify block; speculation off is the plain decode-first plan
PLAN_CASES = {
    "k_plus_1_rows": (TSC(k=2, draft="self"), 2, False,
                      (4, 2), ([3, 1], [1, 1])),
    "prefill_funded": (TSC(k=4, draft="self"), 1, True,
                       (8,), ([5, 3],)),
    "off_unchanged": ("off", 1, True, (0, 5), ([1, 8], [1, 4])),
}


@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_planner_prices_draft_rows_like_the_reference(models, name):
    sc, n_req, extra, budgets, want = PLAN_CASES[name]
    engs = _decode_ready(models["gqa"], speculation=sc, n_req=n_req)
    if extra:
        _admit_both(engs, 9, 1)
    for budget, plan in zip(budgets, want):
        t_q = engs[0].plan_q_lens(budget or None)
        r_q = engs[1].plan_q_lens(budget or None)
        assert t_q.tolist() == r_q.tolist() == plan
        assert _drafts(engs[0]) == _drafts(engs[1])
        for i, q in enumerate(plan):
            d = engs[0]._drafts[i]
            decoding = i < n_req
            assert (d is not None) == (decoding and q > 1)
            if d is not None:
                assert len(d) == q - 1
    if sc == "off":
        assert engs[0].draft is None and engs[0].spec_k == 0
        assert engs[0].spec_stats()["n_spec_steps"] == 0


def test_draft_trimmed_by_generation_room(models):
    """Full acceptance commits k + 1 tokens: no drafting past
    max_new_tokens (1 token out, 1 to go: room 0)."""
    engs = _decode_ready(models["gqa"], speculation=TSC(k=4, draft="self"),
                         max_new_tokens=2)
    for eng in engs:
        assert eng.plan_q_lens().tolist() == [1, 0]
        assert eng._drafts[0] is None


class _FixedDraft(DraftSource):
    """Proposes fixed tokens (the planner's vocabulary trim)."""
    name = "fixed"

    def __init__(self, toks):
        self.toks = np.asarray(toks, np.int64)

    def propose(self, ctx, want):
        return {i: self.toks[:k] for i, k in want.items()}


@pytest.mark.parametrize("toks,kept", [([3, 600, 4], [3]),
                                       ([700, 1, 2], None),
                                       ([5, 6, 7], [5, 6, 7])])
def test_planner_trims_ids_outside_the_verifier_vocab(models, toks, kept):
    """A proposal is cut at its first id >= vocab_size (smollm's reduced
    vocabulary is 512), so the verify step never looks one up."""
    engs = _decode_ready(models["gqa"], speculation=TSC(k=4, draft="self"))
    eng = engs[0]
    eng.draft = _FixedDraft(toks)
    q = eng.plan_q_lens()
    assert _drafts(eng)[0] == kept
    assert q[0] == 1 + (len(kept) if kept else 0)
    eng.unified_step(q)                  # the verify step runs on it
    assert eng.slots[0] is not None and len(eng.slots[0].out_tokens) >= 2


def test_acceptance_ema_gates_drafting(models):
    """A draft whose proposals keep being rejected drives the EMA under
    the gate: the planner stops paying for drafts (probes aside); streams
    and counters equal the reference's."""
    sc = TSC(k=4, draft="gemma-2b", min_accept=0.9, ema_alpha=0.5,
             probe_every=1000)
    rcfg, rp, tcfg, tp = models["gqa"]
    kw = dict(n=3, out=12)
    r_out, r_eng, _ = _serve(r_make_engine, RScheduler, r_workload, rcfg,
                             rp, _ref_sc(sc), **kw)
    t_out, eng, _ = _serve(t_engine, Scheduler, synthetic_workload, tcfg,
                           tp, sc, swap=reference_draft(r_eng), **kw)
    assert t_out == r_out == port_off(models["gqa"], **kw)
    assert eng.accept_ema < sc.min_accept
    assert eng.accept_ema == pytest.approx(r_eng.accept_ema, abs=1e-12)
    st = eng.spec_stats()
    assert st == r_eng.spec_stats()
    assert 0 < st["n_spec_drafted"] < 4 * 3 * 12


def test_no_starvation_under_poisson_load_with_spec(models):
    _, _, tcfg, tp = models["gqa"]
    eng = t_engine(tcfg, tp, max_batch=2, max_len=96, chunk=8,
                   prompt_len=48, max_new_tokens=5,
                   speculation=TSC(k=2, draft="self"))
    sched = Scheduler(eng)
    reqs = list(mixed_workload(6, short_len=10, n_long=2, long_len=48,
                               max_new_tokens=5, vocab=tcfg.vocab_size,
                               arrival_rate=32.0, seed=3))
    for r in reqs:
        sched.submit(r)
    done = sched.run()
    assert len(done) == len(reqs)
    assert all(len(r.out_tokens) == r.max_new_tokens for r in done)
    m = sched.metrics()
    assert m.n_incomplete == 0
    assert m.n_spec_steps > 0
    assert m.spec_tokens_per_step > 1.0
    assert "spec=" in m.row()


# ---------------------------------------------------------------------------
# the LLM facade and the resolver
# ---------------------------------------------------------------------------

def test_llm_from_spec_serves_speculation_on_cpu():
    """The public path: ServeSpec(speculation=...) through
    LLM.from_spec(device="cpu"); the auto token budget funds the verify
    rows (max_batch * (1 + k) + chunk)."""
    kw = dict(arch="smollm-360m", max_batch=2, max_len=64, chunk=8,
              token_budget="auto")
    prompts = [np.random.default_rng(i).integers(0, 500, n).astype(
        np.int32) for i, n in enumerate((9, 14, 6))]
    off = LLM.from_spec(ServeSpec(**kw), device="cpu")
    spec = LLM.from_spec(ServeSpec(speculation=TSC(k=4, draft="self"),
                                   **kw), device="cpu")
    assert spec.spec.token_budget == 2 * 5 + 8
    assert spec.engine.spec_k == 4
    assert spec.generate(prompts, 6) == off.generate(prompts, 6)
    assert spec.engine.spec_stats()["n_spec_accepted"] > 0


# ---------------------------------------------------------------------------
# draft sources
# ---------------------------------------------------------------------------

NGRAM_CASES = [([1, 2, 3, 4, 9, 1, 2], 2, [3, 4]),
               ([1, 2, 3, 1, 2, 5, 1, 2], 3, [5, 1, 2]),   # newest match
               (list(range(8)), 2, None), ([1, 2], 2, None)]


@pytest.mark.parametrize("ctx,k,want", NGRAM_CASES, ids=str)
def test_ngram_propose_matches_reference(ctx, k, want):
    c = {0: np.asarray(ctx, np.int64)}
    got = NGramDraft(ngram=3).propose(c, {0: k})
    assert {s: v.tolist() for s, v in got.items()} == \
        {s: v.tolist() for s, v in RNGram(ngram=3).propose(c, {0: k}).items()}
    assert got.get(0, np.zeros(0)).tolist() == (want or [])


def test_make_draft_resolves_sources(models):
    _, _, tcfg, tp = models["gqa"]
    kw = dict(max_batch=2, max_len=32, dtype=torch.float32, device="cpu")
    self_d = make_draft(TSC(k=2, draft="self"), tcfg, tp, **kw)
    assert isinstance(self_d, ModelDraft)
    assert self_d.cfg is tcfg and self_d.params is tp
    assert isinstance(make_draft(TSC(k=2, draft="ngram", ngram=4), tcfg,
                                 tp, **kw), NGramDraft)
    with pytest.raises(NotImplementedError, match="MTP"):
        make_draft(TSC(k=2, draft="mtp"), tcfg, tp, **kw)
    with pytest.raises(NotImplementedError):
        MTPDraft()
    with pytest.raises(KeyError):
        make_draft(TSC(k=2, draft="no-such-arch"), tcfg, tp, **kw)
    foreign = make_draft(TSC(k=2, draft="gemma-2b"), tcfg, tp, **kw)
    again = make_draft(TSC(k=2, draft="gemma-2b"), tcfg, tp, **kw)
    assert foreign.cfg.name != tcfg.name and foreign.cfg.vocab_size == 512
    for a, b in zip(foreign.params["groups"][0], again.params["groups"][0]):
        for k in a["attn"]:
            assert torch.equal(a["attn"][k], b["attn"][k])   # seeded
    # on a mesh (rank 0 of 2x2) every source builds: the self draft under
    # the serving plan on the rank's rows, a foreign one unsharded with
    # the one-device draw's weights; the n-gram one as everywhere
    mesh_plan = t_make_plan("mixserve", Mesh(("data", "model"), (2, 2), 0))
    self_m = make_draft(TSC(k=2, draft="self"), tcfg, tp, plan=mesh_plan,
                        **kw)
    assert isinstance(self_m, ModelDraft) and self_m.plan is mesh_plan
    assert self_m.cache["groups"][0]["k"].shape[1] == 1      # 2 rows / dp 2
    assert self_m.cache["length"].shape == (2,)
    foreign_m = make_draft(TSC(k=2, draft="gemma-2b"), tcfg, tp,
                           plan=mesh_plan, **kw)
    assert not foreign_m.plan.enabled
    assert foreign_m.cache["groups"][0]["k"].shape[1] == 2
    for a, b in zip(foreign_m.params["groups"][0],
                    foreign.params["groups"][0]):
        for k in a["attn"]:
            assert torch.equal(a["attn"][k], b["attn"][k])
    assert isinstance(make_draft(TSC(k=2, draft="ngram"), tcfg, tp,
                                 plan=mesh_plan, **kw), NGramDraft)


def test_model_draft_host_length_is_authoritative(models):
    """_run writes the host mirror into cache["length"] before each
    forward; a proposal leaves the mirror at the committed context, and a
    departed context replays from scratch in DRAFT_CHUNK-row steps."""
    _, _, tcfg, tp = models["gqa"]
    d = ModelDraft(tcfg, tp, max_batch=2, max_len=64, dtype=torch.float32,
                   device="cpu")
    ctx = np.random.default_rng(1).integers(0, 500, 20).astype(np.int64)
    p1 = d.propose({1: ctx}, {1: 3})[1]
    # catch-up: 19 rows in 2 steps of <= 16, then 3 one-row steps
    assert d.n_forward == 2 + 3 and DRAFT_CHUNK == 16
    assert int(d._len[1]) == 20 and int(d._len[0]) == 0
    assert d.cache["length"].tolist() == [0, 22]    # rows fed for d1, d2
    d.observe(1, np.asarray([int(p1[0])]))
    p2 = d.propose({1: np.concatenate([ctx, p1[:1]])}, {1: 2})[1]
    assert d.n_forward == 5 + 2          # no catch-up: the last token
    #                                      is the propose loop's first row
    assert p2.tolist() == p1[1:3].tolist()         # the same greedy path
    fresh = ModelDraft(tcfg, tp, max_batch=2, max_len=64,
                       dtype=torch.float32, device="cpu")
    alt = ctx.copy()
    alt[3] += 1                                    # a departed context
    d.observe(1, np.asarray([7]))
    assert d.propose({1: alt}, {1: 2})[1].tolist() == \
        fresh.propose({1: alt}, {1: 2})[1].tolist()
    d.release(1)
    assert int(d._len[1]) == 0 and d._fed[1] is None
    assert d.propose({1: np.arange(70)}, {1: 2}) == {}   # too long


def test_model_draft_reads_foreign_ids_as_its_last_id(models):
    """A draft with a smaller vocabulary than the verifier's context: ids
    past it are read as its last id (no out-of-range lookup), so the
    proposals are those of the clamped context."""
    import dataclasses

    _, _, tcfg, _ = models["gqa"]
    small = dataclasses.replace(tcfg, vocab_size=100, name="smollm-v100")
    params = TMOD.init_params(torch.Generator().manual_seed(3), small,
                              torch.float32, "cpu")
    ctx = np.random.default_rng(2).integers(0, 500, 21).astype(np.int64)
    kw = dict(max_batch=2, max_len=64, dtype=torch.float32, device="cpu")
    got = ModelDraft(small, params, **kw).propose({0: ctx}, {0: 3})[0]
    want = ModelDraft(small, params, **kw).propose(
        {0: np.minimum(ctx, 99)}, {0: 3})[0]
    assert got.tolist() == want.tolist() and (got < 100).all()
