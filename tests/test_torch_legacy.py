"""The port's legacy blocking engine path against the reference's, on the
CPU, f32, at the reduced rwkv6 and recurrentgemma configs (the families
the unified step cannot serve).

Greedy streams must be EQUAL token for token: prompts of 20, 32 and 70
tokens at ``max_len`` 256 (buckets 32, 32 and 128), staggered admissions
with a cancel, a ``max_new_tokens=1`` request (the reap sweep) and a
latency fault on a legacy step, the bucket rule of ``validate``, and the
resume after a preemption.  Two reference faults are reproduced, not
repaired, and shown here: the bucket padding runs through the recurrent
state (the stream then differs from an unpadded greedy loop from its second
token), and a ring shorter than the bucket keeps the bucket's padded tail
instead of the real keys; a resumed request re-prefills its prompt alone.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_helpers import recurrent_params  # noqa: E402
from repro.serving import engine as RE  # noqa: E402
from repro.serving.api import LLM as RLLM  # noqa: E402
from repro.serving.api import ServeSpec as RSpec  # noqa: E402
from repro.serving.faults import Fault as RFault  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving.api import LLM as TLLM  # noqa: E402
from repro_torch.serving.api import ServeSpec as TSpec  # noqa: E402
from repro_torch.serving.faults import Fault as TFault  # noqa: E402

ARCHS = ["rwkv6-1.6b", "recurrentgemma-9b"]
LENS = (20, 32, 70)
NEW = 8


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return (request.param,) + recurrent_params(request.param)


def _pair(arch, faults=(), **knobs):
    """(reference LLM, port LLM) on the same weights and explicit knobs;
    ``kv="auto"`` resolves to the dense cache on both."""
    name, rcfg, rp, tcfg, tp = arch
    kw = dict(arch=name, kv="auto", max_batch=2, max_len=256, chunk=8)
    kw.update(knobs)
    r = RLLM.from_spec(RSpec(faults=tuple(RFault(**f) for f in faults),
                             **kw), cfg=rcfg, params=rp)
    t = TLLM.from_spec(TSpec(faults=tuple(TFault(**f) for f in faults),
                             **kw), cfg=tcfg, params=tp, device="cpu")
    assert t.engine.legacy and r.engine.legacy
    assert t.engine.kv.backend == "dense" and t.spec.speculation is None
    return r, t


@pytest.fixture(scope="module")
def pair(arch):
    return _pair(arch)


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("lens", [(20,), (32,), (70,), LENS],
                         ids=["20", "32", "70", "staggered"])
def test_streams_equal_reference(arch, pair, lens):
    """Each prompt alone, then all three on 2 slots (the third admitted
    when a slot frees)."""
    r, t = pair
    prompts = _prompts(arch[1].vocab_size, lens)
    want = r.generate(prompts, max_new_tokens=NEW)
    assert t.generate(prompts, max_new_tokens=NEW) == want


def _greedy_unpadded(tcfg, tp, prompt, new):
    """Greedy decode through ``forward(cache=)`` with an unpadded
    prefill."""
    cache = TM.init_cache(tcfg, 1, 256, torch.float32, "cpu")
    out = TM.forward(tp, tcfg, tokens=torch.from_numpy(prompt)[None].long(),
                     cache=cache)
    toks = [int(out.logits[0, -1].argmax())]
    while len(toks) < new:
        out = TM.forward(tp, tcfg, tokens=torch.tensor([[toks[-1]]]),
                         cache=cache)
        toks.append(int(out.logits[0, 0].argmax()))
    return toks


# the reference's own streams at these weights (PRNGKey(0) with the
# recurrent leaves drawn, f32) against the unpadded loop: the padded bucket
# changes the stream from its second token where marked (a 32-token prompt
# is its own bucket)
PADDING_DIFFERS = {20: True, 32: False, 70: True}


def _padding_differs(arch, pair):
    name, rcfg, rp, tcfg, tp = arch
    r, t = pair
    for n, prompt in zip(LENS, _prompts(rcfg.vocab_size, LENS)):
        served = t.generate([prompt], max_new_tokens=NEW)[0]
        assert served == r.generate([prompt], max_new_tokens=NEW)[0]
        loop = _greedy_unpadded(tcfg, tp, prompt, NEW)
        assert served[0] == loop[0]
        assert (served != loop) == PADDING_DIFFERS[n], n


def test_bucket_padding_enters_the_state(arch, pair):
    """The first token reads the last real row, so it always equals the
    unpadded loop's; after it the state (rwkv6: wkv memory and token-shift
    rows; recurrentgemma: LRU and conv state, and a ring that keeps the
    bucket's tail) comes from the last bucket row, so the stream differs
    where the table says, as in the reference."""
    _padding_differs(arch, pair)


def test_padding_through_the_rglru_state_alone():
    """recurrentgemma with a window of 256, past every bucket: the ring
    drops no real key, so only the LRU and conv states carry the padding,
    and the streams still differ where the table says."""
    name = "recurrentgemma-9b"
    arch = (name,) + recurrent_params(name, window_size=256)
    _padding_differs(arch, _pair(arch))


def test_ring_keeps_the_padded_tail():
    """recurrentgemma, 70-token prompt, bucket 128, window 64: after the
    blocking prefill the slot's ring holds positions 64-127, of which
    70-127 are padding; the real positions 7-63 are gone (the reference's
    ``_ring_from_prefill`` on the whole bucket)."""
    t = TLLM.from_spec(TSpec(arch="recurrentgemma-9b", max_batch=2,
                             max_len=256, chunk=8), device="cpu")
    eng = t.engine
    req = TE.Request(rid=0, prompt=_prompts(t.cfg.vocab_size, (70,))[0],
                     max_new_tokens=4)
    assert eng.admit(req) and eng.slot_of(0) == 0
    kpos = eng.cache["groups"][0]["l2"]["kpos"][0, 0]
    assert sorted(kpos.tolist()) == list(range(64, 128))
    assert int(eng.cache["length"][0]) == 70


def _drive(llm, mod, prompts):
    """Staggered admissions, a max_new_tokens=1 request, a cancel; returns
    each step's retired (rid, state) and the final streams."""
    eng = llm.engine
    reqs = [mod.Request(rid=i, prompt=p, max_new_tokens=n) for i, (p, n)
            in enumerate(zip(prompts, (6, 1, 5, 4)))]
    log = []

    def step():
        log.append([(q.rid, q.state) for q in eng.step() if q is not None])
    assert eng.admit(reqs[0])
    step()
    assert eng.admit(reqs[1])          # done at admission: reaped next step
    step()
    step()
    assert eng.admit(reqs[2])
    step()
    assert eng.cancel(0).state == mod.RequestState.CANCELLED
    assert eng.admit(reqs[3])
    while eng.n_active:
        step()
    return log, [list(q.out_tokens) for q in reqs], dict(eng.events)


def test_staggered_cancel_reap_and_latency_fault(arch):
    r, t = _pair(arch, faults=[dict(kind="latency", at=(2,), ms=1.0)])
    prompts = _prompts(arch[1].vocab_size, (20, 9, 33, 40), seed=1)
    want = _drive(r, RE, prompts)
    got = _drive(t, TE, prompts)
    assert got == want
    assert [s for s, kind, _ in t.engine.faults.log] == [2] \
        and t.engine.faults.log[0][1] == "latency"
    assert len(got[1][1]) == 1 and len(got[1][0]) < 6


def test_validate_bucket_rule(arch, pair):
    """A 20-token prompt into max_len 24 needs its 32-token bucket: both
    engines refuse it; max_len 32 takes it."""
    name, rcfg, rp, tcfg, tp = arch
    prompt = _prompts(rcfg.vocab_size, (20,))[0]
    small = _pair(arch, max_len=24, max_batch=1)
    for mod, llm in zip((RE, TE), small):
        with pytest.raises(mod.PromptTooLongError, match="max_len=24"):
            llm.engine.validate(mod.Request(rid=0, prompt=prompt,
                                            max_new_tokens=1))
    fits = TLLM.from_spec(TSpec(arch=name, max_batch=1, max_len=32, chunk=8),
                          cfg=tcfg, params=tp, device="cpu")
    assert fits.generate([prompt], max_new_tokens=1) \
        == pair[0].generate([prompt], max_new_tokens=1)


def _preempt_resume(llm, mod, prompt, before):
    eng = llm.engine
    req = mod.Request(rid=0, prompt=prompt, max_new_tokens=NEW)
    assert eng.admit(req)
    for _ in range(before - 1):
        eng.step()
    assert eng.preempt(eng.slot_of(0)).state == mod.RequestState.PREEMPTED
    assert eng.admit(req)
    while eng.n_active:
        eng.step()
    return list(req.out_tokens), req.n_preempted


def test_resume_after_preempt_replays_the_prompt_only(arch, pair):
    """Preempted after 3 tokens and resumed, the legacy path prefills the
    prompt alone and appends its first token after the 3 it had: the
    stream restarts (tokens 4-6 repeat 1-3) instead of continuing — the
    reference's behaviour, unlike the unified path's replay of prompt +
    generated tokens."""
    prompt = _prompts(arch[1].vocab_size, (20,), seed=2)[0]
    r, t = pair
    want = _preempt_resume(r, RE, prompt, 3)
    got = _preempt_resume(t, TE, prompt, 3)
    assert got == want and got[1] == 1
    toks = got[0]
    assert len(toks) == NEW and toks[3:6] == toks[:3]
    assert toks[:3] == t.generate([prompt], max_new_tokens=3)[0]


def test_from_spec_serves_reduced_with_random_weights(arch):
    """``LLM.from_spec(ServeSpec(arch=...), device="cpu")`` alone: the
    registry's reduced config, weights drawn from the spec's seed, the
    dense cache, no speculation even when asked for "auto"."""
    name = arch[0]
    llm = TLLM.from_spec(TSpec(arch=name, max_batch=2, max_len=128,
                               speculation="auto"), device="cpu")
    eng = llm.engine
    assert eng.legacy and eng.kv.backend == "dense" and eng.draft is None
    assert llm.spec.speculation is None
    outs = llm.generate(_prompts(llm.cfg.vocab_size, (5, 40), seed=3), 4)
    assert [len(o) for o in outs] == [4, 4]
    assert all(0 <= x < llm.cfg.vocab_size for o in outs for x in o)
    assert eng.n_prefill == 2
    with pytest.raises(ValueError, match="unified"):
        TSpec(arch=name, max_batch=2, max_len=128, speculation=2).resolve(
            device="cpu")


def test_sampling_is_seeded(arch):
    """temperature > 0 draws from the engine's generator: the same seed
    gives the same streams."""
    name, rcfg, rp, tcfg, tp = arch
    prompts = _prompts(rcfg.vocab_size, (12, 30), seed=4)
    outs = [TLLM.from_spec(TSpec(arch=name, max_batch=2, max_len=64,
                                 temperature=0.8, seed=5), cfg=tcfg,
                           params=tp, device="cpu").generate(prompts, 6)
            for _ in range(2)]
    assert outs[0] == outs[1]
    assert all(0 <= x < rcfg.vocab_size for o in outs[0] for x in o)
