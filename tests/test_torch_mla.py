"""The port's MLA (multi-head latent attention) serving path against the
reference's: ``mla_attention`` in both regimes on a paged mixed ragged
step, ``forward`` logits, ``LLM.generate`` greedy streams (with a prefix
hit, and with ``chunk=1``, which serves every step in the absorbed regime),
the weight bridge on an MLA tree, and the resolved envelope of the
depth-cut deepseek-v2-236b on one H100.

Configs: deepseek-v2-reduced (MoE, first layer dense, shared expert) and
minicpm3-reduced (dense).  Tolerances: latent pools 1e-5 (float32,
different summation orders); attention outputs rtol 1e-5 with an absolute
floor of 1e-5 of the largest output (the reference's random init makes
outputs reach ~30, and the output projection sums terms that large, so
float32 rounding reaches ~4e-5 in absolute terms on the small outputs);
logits rtol 1e-4 with an
absolute floor of 1e-4 of the largest logit, as tests/test_torch_model.py
states for its configs; streams and lengths exactly.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_helpers import both_params, jj, paged_tables, tt  # noqa: E402
from repro.core.partitioner import make_plan as r_make_plan  # noqa: E402
from repro.kernels.policy import KernelPolicy as RPolicy  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import model as RMOD  # noqa: E402
from repro.serving.api import LLM as RLLM  # noqa: E402
from repro.serving.api import ServeSpec as RSpec  # noqa: E402
from repro_torch.core.partitioner import make_plan as t_make_plan  # noqa
from repro_torch.kernels.policy import KernelPolicy as TPolicy  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TMOD  # noqa: E402
from repro_torch.serving.api import LLM as TLLM  # noqa: E402
from repro_torch.serving.api import ServeSpec as TSpec  # noqa: E402

ARCHS = ["deepseek-v2-236b", "minicpm3-4b"]
STEPS = ([8, 5, 0], [1, 1, 0], [1, 7, 3])   # prefill, decode, mixed
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return (request.param,) + both_params(request.param)


def _plans(on: bool):
    """(reference plan, port plan) with every kernel on, or none."""
    return (r_make_plan("mixserve", None,
                        kernels=RPolicy.all_on() if on else RPolicy()),
            t_make_plan("mixserve", None,
                        kernels=TPolicy.all_on() if on else TPolicy()))


@pytest.mark.parametrize("kernels", ["off", "on"])
@pytest.mark.parametrize("regime", ["expanded", "absorbed"])
def test_mla_attention_paged_unified_steps(arch, regime, kernels):
    """Prefill, decode (width 1), mixed ragged step on one paged latent
    cache, the regime forced on both sides."""
    _, rcfg, rp, _, tp = arch
    r_p = {k: v[0] for k, v in rp["groups"][0]["attn"].items()}
    t_p = tp["groups"][0][0]["attn"]
    absorb = regime == "absorbed"
    r_plan, t_plan = _plans(kernels == "on")
    b, s, page, nb = 3, 8, 4, 6
    bt, n_pages = paged_tables(b, nb, [6, 5, 6], seed=3)
    r, rd = rcfg.kv_lora_rank, rcfg.rope_head_dim
    r_c = (jj(np.zeros((n_pages, page, r), np.float32)),
           jj(np.zeros((n_pages, page, rd), np.float32)))
    t_c = (torch.zeros(n_pages, page, r), torch.zeros(n_pages, page, rd))
    rng = np.random.default_rng(4)
    length = np.zeros(b, np.int32)
    for q_lens in STEPS:
        q_lens = np.array(q_lens, np.int32)
        sq = s if q_lens.max() > 1 else 1
        x = rng.standard_normal((b, sq, rcfg.d_model)).astype(np.float32)
        r_out, r_c = RL.mla_attention(
            r_p, jj(x), rcfg, r_plan, cache=(*r_c, jj(length)),
            q_lens=jj(q_lens), block_table=jj(bt), absorb=absorb)
        t_out, t_c = TL.mla_attention(
            t_p, tt(x), rcfg, t_plan, cache=(*t_c, tt(length)),
            q_lens=tt(q_lens), block_table=tt(bt), absorb=absorb)
        want = np.asarray(r_out)
        tol = dict(rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))
        for i in range(b):                       # rows past q_len are inert
            np.testing.assert_allclose(t_out[i, :q_lens[i]].numpy(),
                                       want[i, :q_lens[i]], **tol)
        for tc, rc in zip(t_c, r_c):
            np.testing.assert_allclose(tc.numpy(), np.asarray(rc), **TOL)
        length = length + q_lens


@pytest.mark.parametrize("kernels", ["off", "on"])
def test_forward_logits_match_reference(arch, kernels):
    """The unified step through every layer (the regime auto-selected:
    expanded at width 8, absorbed at width 1)."""
    _, rcfg, rp, tcfg, tp = arch
    b, s, page, max_len = 3, 8, 4, 24
    nb = max_len // page
    bt, n_pages = paged_tables(b, nb, [nb] * b, seed=5)
    r_plan, t_plan = _plans(kernels == "on")
    r_cache = RMOD.init_paged_cache(rcfg, b, max_len, page_size=page,
                                    pool_pages=n_pages, dtype=np.float32)
    r_cache = {**r_cache, "block_tables": jj(bt)}
    t_cache = TMOD.init_paged_cache(tcfg, b, max_len, page_size=page,
                                    pool_pages=n_pages, dtype=torch.float32,
                                    device="cpu")
    t_cache["block_tables"].copy_(tt(bt))
    assert {n: tuple(v.shape) for n, v in t_cache["groups"][0].items()} \
        == {n: tuple(v.shape) for n, v in r_cache["groups"][0].items()}
    rng = np.random.default_rng(6)
    for q_lens in STEPS:
        q_lens = np.array(q_lens, np.int32)
        sq = s if q_lens.max() > 1 else 1
        toks = rng.integers(0, rcfg.vocab_size, (b, sq)).astype(np.int32)
        r_out = RMOD.forward(rp, rcfg, r_plan, tokens=jj(toks),
                             cache=r_cache, q_lens=jj(q_lens),
                             expert_stats=rcfg.is_moe)
        t_out = TMOD.forward(tp, tcfg, t_plan, tokens=tt(toks),
                             cache=t_cache, q_lens=tt(q_lens),
                             expert_stats=tcfg.is_moe)
        rl, tl = np.asarray(r_out.logits), t_out.logits.numpy()
        tol = dict(rtol=1e-4, atol=1e-4 * float(np.abs(rl).max()))
        for i in range(b):
            np.testing.assert_allclose(tl[i, :q_lens[i]], rl[i, :q_lens[i]],
                                       **tol)
        if rcfg.is_moe:
            np.testing.assert_array_equal(t_out.expert_counts.numpy(),
                                          np.asarray(r_out.expert_counts))
        r_cache = r_out.cache
        np.testing.assert_array_equal(t_cache["length"].numpy(),
                                      np.asarray(r_cache["length"]))
        for tg, rg in zip(t_cache["groups"], r_cache["groups"]):
            for k in ("c", "kr"):
                want = np.asarray(rg[k])
                np.testing.assert_allclose(
                    tg[k].numpy(), want, rtol=1e-4,
                    atol=1e-5 * float(np.abs(want).max()))


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


@pytest.mark.parametrize("chunk", [8, 1])
def test_generate_streams_equal_reference(arch, chunk):
    """chunk 8 serves prefill and decode in the expanded regime; chunk 1
    serves every step in the absorbed regime."""
    r, t = _pair(arch, chunk=chunk)
    assert t.engine.chunk == chunk
    prompts = _prompts(arch[1].vocab_size, (13, 5, 10))
    want = r.generate(prompts, max_new_tokens=4)
    assert t.generate(prompts, max_new_tokens=4) == want


def test_shared_prefix_hits_and_kernels_on_streams_equal(arch):
    """One slot, so later requests find the shared 16-token prefix's latent
    pages in the index; kernels on (plain versions on the CPU) and off give
    the reference's streams."""
    r, t = _pair(arch, max_batch=1)
    _, t_on = _pair(arch, max_batch=1, kernels="on")
    vocab = arch[1].vocab_size
    prefix = np.random.default_rng(7).integers(0, vocab, 16).astype(np.int32)
    prompts = _prompts(vocab, (5, 9), seed=1, prefix=prefix)
    want = r.generate(prompts, max_new_tokens=3)
    assert t.generate(prompts, max_new_tokens=3) == want
    assert t_on.generate(prompts, max_new_tokens=3) == want
    assert t.engine.kv.stats.n_prefix_hits \
        == r.engine.kv.stats.n_prefix_hits >= 1


def test_from_reference_carries_the_mla_tree(arch):
    """The bridge is name-generic: every MLA weight (and deepseek's first
    dense group) arrives under the reference's name, unstacked per layer,
    equal to the reference's values."""
    _, rcfg, rp, tcfg, tp = arch
    mla = {"w_dq", "q_norm", "w_uq", "w_dkv", "kv_norm", "w_kr", "w_uk",
           "w_uv", "wo", "norm"}
    kinds = [g.kind for g in TMOD.layer_plan(tcfg)]
    assert kinds == (["dense", "moe"] if tcfg.is_moe else ["dense"])
    for gi, group in enumerate(tp["groups"]):
        for li, layer in enumerate(group):
            assert set(layer["attn"]) == mla
            ref_leaves = jax.tree_util.tree_flatten_with_path(
                rp["groups"][gi])[0]
            for path, leaf in ref_leaves:
                node = layer
                for key in path:
                    node = node[key.key]
                np.testing.assert_array_equal(node.numpy(),
                                              np.asarray(leaf)[li])


def test_deepseek_depth_cut_resolves_on_one_h100():
    """The configuration the card serves: deepseek-v2-236b at full width,
    4 layers, on ``h100x1`` — a feasible envelope with every kernel on, and
    an explicit chunk=1 (the absorbed regime) honoured."""
    import repro_torch.configs as C
    full = C.get("deepseek-v2-236b")
    cfg = dataclasses.replace(full, n_layers=4, name="deepseek-v2-236b-4L")
    res = TSpec(kv="paged", reduced=False, max_batch=4, prompt_len=512,
                max_new_tokens=16).resolve(cfg, device="cuda")
    assert res.cluster == "h100x1" and res.kernels == TPolicy.all_on()
    assert res.max_batch == 4 and res.max_len >= 512 + 16
    assert 1 < res.chunk <= res.max_len
    assert res.kv.pool_pages * res.kv.page_size >= 4 * (512 + 16) // 2
    one = TSpec(kv="paged", reduced=False, max_batch=4, prompt_len=24,
                max_new_tokens=4, chunk=1).resolve(cfg, device="cuda")
    assert one.chunk == 1 and one.provenance["chunk"] == "explicit"
