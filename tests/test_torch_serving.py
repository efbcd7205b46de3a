"""The port's serving stack against the reference's, end to end on the CPU.

Greedy streams must be EQUAL (same weights, same prompts, same explicit
chunk / max_batch / max_len / kv on both sides), including a shared-prefix
run that hits the prefix index and a preempt-resume run; the port's
``ServeSpec.resolve`` must equal the reference's on every knob for the same
cluster numbers, so the copied cost model cannot drift.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_helpers import both_params  # noqa: E402
from repro.core import topology as RT  # noqa: E402
from repro.serving import engine as RE  # noqa: E402
from repro.serving.api import LLM as RLLM  # noqa: E402
from repro.serving.api import ServeSpec as RSpec  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
import repro_torch.configs.paper_models  # noqa: E402,F401
from repro.configs.paper_models import PAPER_MODELS as R_PAPER  # noqa: E402
from repro_torch.core import topology as TT  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving.api import LLM as TLLM  # noqa: E402
from repro_torch.serving.api import ServeSpec as TSpec  # noqa: E402

ARCHS = ["phi3.5-moe-42b", "smollm-360m", "gemma-2b", "minitron-8b"]
# every registered arch and the paper's two models, for the resolver
RESOLVE_ARCHS = list(TC.ARCH_IDS) + sorted(TC.paper_models.PAPER_MODELS)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return (request.param,) + both_params(request.param)


def _pair(arch, **knobs):
    """(reference LLM, port LLM) on the same weights and explicit knobs."""
    name, rcfg, rp, tcfg, tp = arch
    kw = dict(arch=name, kv="paged", max_batch=2, max_len=64, chunk=8)
    kw.update(knobs)
    return (RLLM.from_spec(RSpec(**kw), cfg=rcfg, params=rp),
            TLLM.from_spec(TSpec(**kw), cfg=tcfg, params=tp, device="cpu"))


def _prompts(vocab, lens, seed=0, prefix=None):
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, vocab, n).astype(np.int32) for n in lens]
    if prefix is not None:
        out = [np.concatenate([prefix, p]) for p in out]
    return out


def test_generate_streams_equal_reference(arch):
    r, t = _pair(arch)
    prompts = _prompts(arch[1].vocab_size, (19, 7, 33))
    want = r.generate(prompts, max_new_tokens=6)
    assert t.generate(prompts, max_new_tokens=6) == want
    assert t.engine.kv.stats.n_prefix_hits == 0


def test_shared_prefix_hits_and_streams_equal(arch):
    """One slot, so each request is freed before the next begins: later
    requests find the shared 16-token prefix's pages in the index."""
    r, t = _pair(arch, max_batch=1)
    vocab = arch[1].vocab_size
    prefix = np.random.default_rng(7).integers(0, vocab, 16).astype(np.int32)
    prompts = _prompts(vocab, (5, 9, 3), seed=1, prefix=prefix)
    want = r.generate(prompts, max_new_tokens=4)
    assert t.generate(prompts, max_new_tokens=4) == want
    assert t.engine.kv.stats.n_prefix_hits \
        == r.engine.kv.stats.n_prefix_hits >= 1


def _drive_preempt(llm, mod, prompts):
    """Admit both, step, preempt slot 0 mid-decode, re-admit, finish."""
    eng = llm.engine
    reqs = [mod.Request(rid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(prompts)]
    for q in reqs:
        assert eng.admit(q)
    for _ in range(5):
        eng.step()
    victim = eng.preempt(0)
    assert victim is reqs[0] and victim.n_preempted == 1
    eng.step()
    assert eng.admit(victim)
    while eng.n_active:
        eng.step()
    return [list(q.out_tokens) for q in reqs]


def test_preempt_resume_streams_equal(arch):
    name, rcfg = arch[0], arch[1]
    prompts = _prompts(rcfg.vocab_size, (10, 12), seed=2)
    r, t = _pair(arch, chunk=4)
    want = _drive_preempt(r, RE, prompts)
    got = _drive_preempt(t, TE, prompts)
    assert got == want
    _, t2 = _pair(arch, chunk=4)             # uninterrupted run, same output
    assert t2.generate(prompts, max_new_tokens=6) == got


def test_kernels_on_equals_off_on_cpu(arch):
    """On the CPU every wrapper runs its plain version: the kernels-on path
    must route through them and give the kernels-off streams."""
    _, t_on = _pair(arch, kernels="on")
    _, t_off = _pair(arch, kernels="off")
    prompts = _prompts(arch[1].vocab_size, (11, 4), seed=3)
    assert t_on.spec.kernels.flash_chunk and t_on.spec.kernels.moe_gemm
    assert t_on.generate(prompts, 4) == t_off.generate(prompts, 4)


def _knobs(res):
    return {f: (v.describe() if hasattr(v, "describe") else v)
            for f, v in ((f, getattr(res, f)) for f in (
                "strategy", "strategy_detail", "dispatch", "chunk",
                "token_budget", "max_batch", "max_len", "cluster",
                "overload", "kv", "ep_overlap", "speculation", "moe_ep",
                "moe_tp", "prompt_len", "max_new_tokens"))}


@pytest.mark.parametrize("name", RESOLVE_ARCHS)
@pytest.mark.parametrize("cluster", ["h20x16", "h100x1"])
def test_resolve_equals_reference_on_every_knob(name, cluster, monkeypatch):
    """Every registered arch (the families the port does not serve yet
    resolve all the same) and the paper's models, passed as configs;
    kv="dense" and kv="paged" resolve as the reference does, and "auto"
    stays paged for the unified families."""
    from repro.kernels import autotune
    from repro_torch.kernels import autotune as t_autotune
    monkeypatch.setattr(autotune, "_CACHE", {})          # analytic defaults
    monkeypatch.setattr(autotune, "_persist_loaded", True)
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", "")
    monkeypatch.setattr(t_autotune, "_CACHE", {})
    monkeypatch.setattr(t_autotune, "_ANALYTIC", set())
    monkeypatch.setattr(t_autotune, "_persist_loaded", True)
    t_cl = TT.CLUSTERS[cluster]
    r_cl = RT.CLUSTERS.get(cluster) or RT.ClusterSpec(
        **dataclasses.asdict(t_cl))
    paper = name in R_PAPER
    r_cfg = R_PAPER[name] if paper else None
    t_cfg = TC.paper_models.PAPER_MODELS[name] if paper else None
    for kw in (dict(), dict(prompt_len=1024, max_new_tokens=32,
                            arrival_rate=4.0), dict(max_batch=4, chunk=16),
               dict(kv="dense"), dict(kv="paged", max_batch=4)):
        if kw.get("kv") == "paged" and not TE.unified_supported(
                t_cfg or TC.get(name)):
            for spec, cl in ((RSpec(arch=name, **kw), r_cl),
                             (TSpec(arch=name, **kw), t_cl)):
                with pytest.raises(ValueError, match="unified step"):
                    spec.resolve(cluster=cl)
            continue
        r = RSpec(arch=None if paper else name, **kw).resolve(
            r_cfg, cluster=r_cl)
        t = TSpec(arch=None if paper else name, **kw).resolve(
            t_cfg, cluster=t_cl, device="cpu")
        assert _knobs(t) == _knobs(r)
        assert t.kernels.describe() == r.kernels.describe() == "off"
        if "kv" not in kw:
            assert t.kv.backend == ("paged" if TE.unified_supported(
                t_cfg or TC.get(name)) else "dense")
