"""The port's capacity-dispatch MoE against the reference's, same inputs.

Capacity sizing, slot ranks, keep masks and the permute / combine index
maps are integers and must be EQUAL.  Float results agree to 1e-5 (float32,
summation order only); greedy streams of ``LLM.generate`` in capacity mode
must be equal, with slots dropped.  The reference runs its Pallas kernels in
interpret mode where a case turns them on; the port's kernels run their
plain versions on the CPU.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_helpers import both_params, jj, tt  # noqa: E402
from repro.kernels import ops as r_ops  # noqa: E402
from repro.kernels import ref as r_ref  # noqa: E402
from repro.kernels.policy import KernelPolicy as RPolicy  # noqa: E402
from repro.models import moe as RM  # noqa: E402
from repro.serving.api import LLM as RLLM  # noqa: E402
from repro.serving.api import ServeSpec as RSpec  # noqa: E402
from repro_torch.configs.base import ModelConfig as TConfig  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from repro_torch.kernels.policy import KernelPolicy as TPolicy  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models.param import init_tree  # noqa: E402
from repro_torch.serving.api import LLM as TLLM  # noqa: E402
from repro_torch.serving.api import ServeSpec as TSpec  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
ALL_ON = dict(topk_gate=True, moe_gemm=True, fused_permute=True)


def _routing(t=30, k=2, e=6, seed=0):
    """(T, k) expert ids with heavy ties (the first third all on experts
    2 and 1, every row's ids distinct) and (T, k) weights."""
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.permutation(e)[:k] for _ in range(t)])
    ids[: t // 3] = [2, 1, 0, 3, 5, 4][:k]
    w = rng.random((t, k)).astype(np.float32)
    return ids.astype(np.int32), w


# ---------------------------------------------------------------------------
# (a) sizing and index maps: exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tokens,k,e,cf", [
    (256, 2, 16, 1.25), (256, 6, 160, 1.25), (4, 6, 160, 1.25),
    (16, 2, 4, 0.0), (16, 2, 4, 1e-9), (16, 2, 4, 8.0), (9, 1, 1, 1.0),
    (100, 2, 8, 0.33), (0, 2, 4, 1.25)])
def test_capacity_for_matches_reference(tokens, k, e, cf):
    assert TM.capacity_for(tokens, k, e, cf) \
        == RM.capacity_for(tokens, k, e, cf)


def test_capacity_for_rounds_past_8_only():
    assert [TM.capacity_for(n, 1, 1, 1.0) for n in (0, 1, 8, 9, 17)] \
        == [1, 1, 8, 16, 24]


def test_positions_in_expert_matches_reference():
    ids, _ = _routing(t=40, k=3, e=7)
    flat = ids.reshape(-1)
    got = TM.positions_in_expert(tt(flat), 7).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(RM.positions_in_expert(jj(flat), 7)))
    # stable: within one expert, ranks follow slot order
    for ex in range(7):
        np.testing.assert_array_equal(got[flat == ex],
                                      np.arange((flat == ex).sum()))


@pytest.mark.parametrize("cap", [1, 8, 9, 40])
def test_dispatch_maps_match_reference(cap):
    ids, w = _routing()
    t, k, e = ids.shape[0], ids.shape[1], 6
    d = TM.make_dispatch(tt(ids), tt(w), e, cap)
    r = RM.make_dispatch(jj(ids), jj(w), e, cap)
    assert d.capacity == r.capacity == cap
    for f in ("flat_e", "pos", "keep", "weights"):
        np.testing.assert_array_equal(getattr(d, f).numpy(),
                                      np.asarray(getattr(r, f)))
    np.testing.assert_array_equal(TM.dispatch_src_tok(d, e, t).numpy(),
                                  np.asarray(RM.dispatch_src_tok(r, e, t)))
    ts, tw = TM.dispatch_src_slot(d, t)
    rs, rw = RM.dispatch_src_slot(r, t)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(rw))
    assert ts.dtype == torch.int32 and ts.shape == (t, k)
    # expert 2 holds 10 tied slots + its share: drops below that capacity
    assert bool((~d.keep).any()) == (cap < 10)


# ---------------------------------------------------------------------------
# (b) the plain moe_gemm against the reference's kernel and oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c", [1, 13])
def test_moe_gemm_ref_matches_reference(c):
    rng = np.random.default_rng(c)
    x = rng.standard_normal((3, c, 40)).astype(np.float32)
    x[1] = 0
    w = rng.standard_normal((3, 40, 24)).astype(np.float32)
    got = t_ref.moe_gemm_ref(tt(x), tt(w))
    assert got.shape == (3, c, 24) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(r_ref.moe_gemm_ref(jj(x), jj(w))),
                               **TOL)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(r_ops.moe_gemm(jj(x), jj(w))),
                               **TOL)
    # the wrapper takes the plain version on the CPU and counts nothing
    t_ops.reset_counters()
    assert torch.equal(t_ops.moe_gemm(tt(x), tt(w)), got)
    assert (got[1] == 0).all() and not t_ops.counters


def test_moe_gemm_wrapper_checks_shapes():
    with pytest.raises(ValueError, match="need x"):
        t_ops.moe_gemm(torch.zeros(2, 3, 4), torch.zeros(2, 5, 6))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        t_ops.moe_gemm(torch.zeros(2, 3, 4, dtype=torch.float64),
                       torch.zeros(2, 4, 6, dtype=torch.float64))


# ---------------------------------------------------------------------------
# (c) scatter / gather / expert FFN, kernels off and on
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def phi():
    return both_params("phi3.5-moe-42b")


@pytest.fixture(scope="module")
def deepseek():
    return both_params("deepseek-v2-236b")


def _moe_params(params):
    rcfg, rp, tcfg, tp = params
    gi = len(rp["groups"]) - 1                  # the MoE group
    return (rcfg, {k: v[0] for k, v in rp["groups"][gi]["moe"].items()},
            tcfg, tp["groups"][gi][0]["moe"])


@pytest.mark.parametrize("use_kernel", [False, True])
def test_buffers_and_expert_ffn_match_reference(phi, use_kernel):
    rcfg, rp, tcfg, tp = _moe_params(phi)
    ids, w = _routing(t=30, k=2, e=rcfg.n_experts)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((30, rcfg.d_model)).astype(np.float32)
    cap = 9                                   # expert 2 overflows: drops
    e = rcfg.n_experts
    d = TM.make_dispatch(tt(ids), tt(w), e, cap)
    r = RM.make_dispatch(jj(ids), jj(w), e, cap)
    assert int((~d.keep).sum()) > 0
    t_buf = TM.scatter_to_buffers(tt(x), d, e, use_kernel=use_kernel)
    r_buf = RM.scatter_to_buffers(jj(x), r, e, use_kernel=use_kernel)
    assert t_buf.shape == (e, cap, rcfg.d_model)
    np.testing.assert_array_equal(t_buf.numpy(), np.asarray(r_buf))
    t_y = TM.expert_ffn(tp, t_buf, tcfg, use_kernel=use_kernel)
    r_y = RM.expert_ffn(rp, r_buf, rcfg, use_kernel=use_kernel)
    np.testing.assert_allclose(t_y.numpy(), np.asarray(r_y), **TOL)
    t_out = TM.gather_from_buffers(t_y, d, 30, use_kernel=use_kernel)
    r_out = RM.gather_from_buffers(r_y, r, 30, use_kernel=use_kernel)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(r_out), **TOL)


# ---------------------------------------------------------------------------
# (d) the block: reduced phi3.5-moe and deepseek-v2, with drops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [0.5, 0.0])
@pytest.mark.parametrize("kernels", ["off", "all-on"])
@pytest.mark.parametrize("arch", ["phi", "deepseek"])
def test_moe_local_capacity_matches_reference(arch, kernels, cf, request):
    rcfg, rp, tcfg, tp = _moe_params(request.getfixturevalue(arch))
    pol = ALL_ON if kernels == "all-on" else {}
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, rcfg.d_model)).astype(np.float32)
    r = RM.moe_local(rp, jj(x), rcfg, cf, policy=RPolicy(**pol),
                     dispatch="capacity", with_stats=True)
    tcfg = dataclasses.replace(tcfg, capacity_factor=cf)
    t = TM.moe_local(tp, tt(x), tcfg, policy=TPolicy(**pol),
                     dispatch="capacity", with_stats=True)
    np.testing.assert_allclose(t[0].numpy(), np.asarray(r[0]), **TOL)
    np.testing.assert_allclose(float(t[1]), float(r[1]), **TOL)
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(r[2]))
    cap = TM.capacity_for(18, tcfg.top_k, tcfg.n_experts, cf)
    assert int((t[2] - cap).clamp_min(0).sum()) > 0        # slots dropped


# ---------------------------------------------------------------------------
# (e) the reference's dispatch-semantics tests, mirrored on the port
# ---------------------------------------------------------------------------

def _cfg(**kw):
    base = dict(name="d-moe", family="moe", n_layers=1, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
                n_experts=8, top_k=2, d_expert=96, n_shared_experts=1,
                capacity_factor=1.0)
    base.update(kw)
    return TConfig(**base)


def _params_x(cfg, t, b=1):
    p = init_tree(torch.Generator().manual_seed(0), TM.moe_spec(cfg),
                  torch.float32, "cpu")
    x = np.random.default_rng(1).standard_normal((b, t, cfg.d_model))
    return p, tt(x.astype(np.float32))


def test_capacity_moe_violates_count_independence():
    """With a uniform router every token ties onto experts 0 and 1, so
    shrinking the batch moves the drop cliff; dropless stays
    subset-invariant (tests/test_dispatch.py's reference test)."""
    cfg = _cfg()
    p, x = _params_x(cfg, 80)
    p = {**p, "router": torch.zeros_like(p["router"])}
    full, _ = TM.moe_local(p, x, cfg, dispatch="capacity")
    sub, _ = TM.moe_local(p, x[:, :16], cfg, dispatch="capacity")
    assert float((sub - full[:, :16]).abs().max()) > 1e-4
    fd, _ = TM.moe_local(p, x, cfg, dispatch="dropless")
    sd, _ = TM.moe_local(p, x[:, :16], cfg, dispatch="dropless")
    assert float((sd - fd[:, :16]).abs().max()) < 1e-6


def test_dropless_matches_capacity_with_ample_headroom():
    """With cf high enough that nothing drops, the two dispatch schemes are
    the same function (different summation trees: allclose)."""
    cfg = _cfg(capacity_factor=8.0)
    p, x = _params_x(cfg, 16, b=2)
    drop, _ = TM.moe_local(p, x, cfg, dispatch="dropless")
    cap, _ = TM.moe_local(p, x, cfg, dispatch="capacity")
    torch.testing.assert_close(drop, cap, atol=2e-5, rtol=0)


# ---------------------------------------------------------------------------
# (f) LLM.generate in capacity mode: streams equal the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch_name,fixture", [
    ("phi3.5-moe-42b", "phi"), ("deepseek-v2-236b", "deepseek")])
def test_generate_capacity_streams_equal_reference(arch_name, fixture,
                                                   request, monkeypatch):
    """One slot, so the second request finds the shared 16-token prefix's
    pages in the index; the default capacity factor drops slots."""
    rcfg, rp, tcfg, tp = request.getfixturevalue(fixture)
    kw = dict(arch=arch_name, kv="paged", max_batch=1, max_len=64, chunk=8,
              dispatch="capacity", kernels="off")
    r = RLLM.from_spec(RSpec(**kw), cfg=rcfg, params=rp)
    t = TLLM.from_spec(TSpec(**kw), cfg=tcfg, params=tp, device="cpu")
    assert t.spec.dispatch == t.engine.plan.dispatch_mode == "capacity"
    dropped = []
    make = TM.make_dispatch

    def counting(*a, **k):
        d = make(*a, **k)
        dropped.append(int((~d.keep).sum()))
        return d
    monkeypatch.setattr(TM, "make_dispatch", counting)
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, rcfg.vocab_size, 16).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(
        0, rcfg.vocab_size, n).astype(np.int32)]) for n in (5, 9)]
    want = r.generate(prompts, max_new_tokens=4)
    assert t.generate(prompts, max_new_tokens=4) == want
    assert sum(dropped) > 0
    assert t.engine.kv.stats.n_prefix_hits \
        == r.engine.kv.stats.n_prefix_hits >= 1


def test_auto_dispatch_stays_dropless(phi):
    _, _, tcfg, tp = phi
    llm = TLLM.from_spec(TSpec(arch="phi3.5-moe-42b", kv="paged",
                               max_batch=1, max_len=32, chunk=8),
                         cfg=tcfg, params=tp, device="cpu")
    assert llm.spec.dispatch == "dropless"
    assert TM.resolve_dispatch(llm.engine.plan.dispatch_mode) == "dropless"
