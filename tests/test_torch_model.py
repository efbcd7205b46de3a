"""The port's forward pass against the reference's on the paged unified
step: a prefill, a decode and a mixed ragged step on one cache, for the
reduced phi3.5-moe (MoE) and smollm (dense, tied embeddings) configs.

Logits agree to rtol 1e-4 with an absolute floor of 1e-4 of the largest
logit (float32, different summation orders; the reference's random init
makes activations large enough that rounding on the mixed step reaches
the 1e-4 level, in the reference's own kernels-on vs kernels-off paths as
well, so a flat 1e-4 would test rounding); the cached
K/V to rtol 1e-4 with an absolute floor of 1e-5 of the pool's largest
magnitude (the second layer's K/V carries the first layer's rounding, and
its entries reach ~25 under the reference's random init); expert counts
and lengths exactly.  The port updates its cache in place and must end with
the same pools and lengths as the reference's returned cache.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_helpers import both_params, jj, paged_tables, tt  # noqa: E402
from repro.core.partitioner import make_plan as r_make_plan  # noqa: E402
from repro.kernels.policy import KernelPolicy as RPolicy  # noqa: E402
from repro.models import model as RMOD  # noqa: E402
from repro_torch.core.partitioner import make_plan as t_make_plan  # noqa
from repro_torch.kernels.policy import KernelPolicy as TPolicy  # noqa: E402
from repro_torch.models import model as TMOD  # noqa: E402

STEPS = ([8, 5, 0], [1, 1, 0], [1, 7, 3])   # prefill, decode, mixed


@pytest.fixture(scope="module", params=["phi3.5-moe-42b", "smollm-360m",
                                        "gemma-2b", "minitron-8b"])
def arch(request):
    return (request.param,) + both_params(request.param)


def test_param_tree_matches_reference_spec(arch):
    name, rcfg, rp, tcfg, tp = arch
    assert TMOD.count_params(tcfg) == RMOD.count_params(rcfg)
    gen = torch.Generator().manual_seed(0)
    fresh = TMOD.init_params(gen, tcfg, torch.float32, "cpu")
    flat_r = jax.tree_util.tree_flatten_with_path(rp)[0]
    n_r = sum(int(np.prod(v.shape)) for _, v in flat_r)

    def count(t):
        if isinstance(t, dict):
            return sum(count(v) for v in t.values())
        if isinstance(t, list):
            return sum(count(v) for v in t)
        return t.numel()
    assert count(fresh) == count(tp) == n_r


@pytest.mark.parametrize("kernels", ["off", "on"])
def test_forward_paged_unified_steps_match_reference(arch, kernels):
    name, rcfg, rp, tcfg, tp = arch
    b, s, page, max_len = 3, 8, 4, 24
    nb = max_len // page
    bt, n_pages = paged_tables(b, nb, [nb] * b, seed=5)
    on = kernels == "on"
    r_plan = r_make_plan("mixserve", None, kernels=RPolicy(
        flash_chunk=on, topk_gate=on, moe_gemm=on))
    t_plan = t_make_plan("mixserve", None, kernels=TPolicy.all_on() if on
                         else TPolicy())
    r_cache = RMOD.init_paged_cache(rcfg, b, max_len, page_size=page,
                                    pool_pages=n_pages, dtype=np.float32)
    r_cache = {**r_cache, "block_tables": jj(bt)}
    t_cache = TMOD.init_paged_cache(tcfg, b, max_len, page_size=page,
                                    pool_pages=n_pages, dtype=torch.float32,
                                    device="cpu")
    t_cache["block_tables"].copy_(tt(bt))
    rng = np.random.default_rng(6)
    for q_lens in STEPS:
        q_lens = np.array(q_lens, np.int32)
        toks = rng.integers(0, rcfg.vocab_size, (b, s)).astype(np.int32)
        for last_only in (False, True):
            if last_only:       # same step again from the same state
                r_in = r_saved
                t_cache["length"].copy_(t_len)
                for g, saved in zip(t_cache["groups"], t_pools):
                    for k in g:
                        g[k].copy_(saved[k])
            else:
                r_saved = r_cache
                t_len = t_cache["length"].clone()
                t_pools = [{k: v.clone() for k, v in g.items()}
                           for g in t_cache["groups"]]
                r_in = r_cache
            r_out = RMOD.forward(rp, rcfg, r_plan, tokens=jj(toks),
                                 cache=r_in, q_lens=jj(q_lens),
                                 last_only=last_only,
                                 expert_stats=rcfg.is_moe)
            t_out = TMOD.forward(tp, tcfg, t_plan, tokens=tt(toks),
                                 cache=t_cache, q_lens=tt(q_lens),
                                 last_only=last_only,
                                 expert_stats=tcfg.is_moe)
            rl, tl = np.asarray(r_out.logits), t_out.logits.numpy()
            tol = dict(rtol=1e-4, atol=1e-4 * float(np.abs(rl).max()))
            if last_only:
                np.testing.assert_allclose(tl[q_lens > 0], rl[q_lens > 0],
                                           **tol)
            else:
                for i in range(b):
                    np.testing.assert_allclose(tl[i, :q_lens[i]],
                                               rl[i, :q_lens[i]], **tol)
            if rcfg.is_moe:
                np.testing.assert_array_equal(
                    t_out.expert_counts.numpy(),
                    np.asarray(r_out.expert_counts))
            np.testing.assert_allclose(float(t_out.aux), float(r_out.aux),
                                       rtol=1e-5, atol=1e-5)
        r_cache = r_out.cache
        np.testing.assert_array_equal(t_cache["length"].numpy(),
                                      np.asarray(r_cache["length"]))
        for tg, rg in zip(t_cache["groups"], r_cache["groups"]):
            for k in ("k", "v"):
                want = np.asarray(rg[k])
                np.testing.assert_allclose(
                    tg[k].numpy(), want, rtol=1e-4,
                    atol=1e-5 * float(np.abs(want).max()))


def test_padded_vocab_columns_masked():
    import dataclasses
    import repro_torch.configs as TC
    cfg = dataclasses.replace(TC.get_reduced("smollm-360m"), vocab_size=500)
    assert cfg.padded_vocab > cfg.vocab_size
    gen = torch.Generator().manual_seed(0)
    params = TMOD.init_params(gen, cfg, torch.float32, "cpu")
    cache = TMOD.init_paged_cache(cfg, 1, 16, page_size=4, pool_pages=4,
                                  dtype=torch.float32, device="cpu")
    cache["block_tables"].copy_(torch.arange(4, dtype=torch.int32)[None])
    out = TMOD.forward(params, cfg, tokens=torch.tensor([[1, 2, 3]]),
                       cache=cache, q_lens=torch.tensor([3],
                                                        dtype=torch.int32),
                       last_only=True)
    assert (out.logits[..., cfg.vocab_size:] == -1e30).all()
    assert cache["length"].tolist() == [3]
