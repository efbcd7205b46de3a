"""The port's dropless MoE against the reference's, same inputs.

Ids, dispatch order and routed counts are exact; weights, aux loss and the
block's output agree to 1e-5 (float32).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_helpers import both_params, jj, tt  # noqa: E402
from repro.kernels.policy import KernelPolicy as RPolicy  # noqa: E402
from repro.models import moe as RM  # noqa: E402
from repro_torch.kernels.policy import KernelPolicy as TPolicy  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def phi():
    return both_params("phi3.5-moe-42b")


def _logits():
    rng = np.random.default_rng(0)
    lg = rng.standard_normal((24, 8)).astype(np.float32)
    lg[0] = 1.0                          # all tied
    lg[1, 4] = lg[1, 1] = 3.0            # tied top pair
    return lg


@pytest.mark.parametrize("use_kernel", [False, True])
def test_route_topk_matches_reference(use_kernel):
    lg = _logits()
    ti, tw, taux = TM.route_topk(tt(lg), 2, use_kernel=use_kernel)
    ri, rw, raux = RM.route_topk(jj(lg), 2, use_kernel=use_kernel)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_allclose(tw.numpy(), np.asarray(rw), **TOL)
    np.testing.assert_allclose(float(taux), float(raux), **TOL)
    assert ti[0].tolist() == [0, 1] and ti[1].tolist() == [1, 4]


def test_make_dropless_order_matches_reference():
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 5, (30, 2)).astype(np.int32)
    idx[:, 1] = np.where(idx[:, 1] == 3, 4, idx[:, 1])
    w = rng.random((30, 2)).astype(np.float32)
    t = TM.make_dropless(tt(idx), tt(w), 6)
    r = RM.make_dropless(jj(idx), jj(w), 6)
    for f in ("order", "inv", "counts", "offsets"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(r, f)))


@pytest.fixture(scope="module")
def deepseek():
    return both_params("deepseek-v2-236b")


POLICIES = {"off": {}, "gate+gemm": dict(topk_gate=True, moe_gemm=True),
            "fused_permute": dict(fused_permute=True),
            "all-on": dict(topk_gate=True, moe_gemm=True,
                           fused_permute=True)}


def _moe_pair(params, kernels, seed=2, shape=(3, 5)):
    rcfg, rp, tcfg, tp = params
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape + (rcfg.d_model,)).astype(np.float32)
    gi = len(rp["groups"]) - 1                  # the MoE group
    r_moe = {k: v[0] for k, v in rp["groups"][gi]["moe"].items()}
    pol = POLICIES[kernels]
    r = RM.moe_local(r_moe, jj(x), rcfg, policy=RPolicy(**pol),
                     dispatch="dropless", with_stats=True)
    t = TM.moe_local(tp["groups"][gi][0]["moe"], tt(x), tcfg,
                     policy=TPolicy(**pol), dispatch="dropless",
                     with_stats=True)
    return r, t


@pytest.mark.parametrize("kernels", sorted(POLICIES))
def test_moe_local_matches_reference(phi, kernels):
    (r_out, r_aux, r_cnt), (t_out, t_aux, t_cnt) = _moe_pair(phi, kernels)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(r_out), **TOL)
    np.testing.assert_allclose(float(t_aux), float(r_aux), **TOL)
    np.testing.assert_array_equal(t_cnt.numpy(), np.asarray(r_cnt))


@pytest.mark.parametrize("kernels", ["off", "all-on"])
def test_moe_local_deepseek_matches_reference(deepseek, kernels):
    """Top-k of more experts plus a shared expert on every token."""
    assert deepseek[0].n_shared_experts and deepseek[0].first_dense_layers
    (r_out, r_aux, r_cnt), (t_out, t_aux, t_cnt) = _moe_pair(
        deepseek, kernels, seed=4, shape=(2, 7))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(r_out), **TOL)
    np.testing.assert_allclose(float(t_aux), float(r_aux), **TOL)
    np.testing.assert_array_equal(t_cnt.numpy(), np.asarray(r_cnt))


def test_moe_count_independent(phi):
    """A token's output does not depend on which other rows share the
    step (dropless: no capacity, so no batch-composition effects)."""
    _, _, tcfg, tp = phi
    p = tp["groups"][0][0]["moe"]
    rng = np.random.default_rng(3)
    x = tt(rng.standard_normal((1, 9, tcfg.d_model)).astype(np.float32))
    full, _ = TM.moe_local(p, x, tcfg)
    part, _ = TM.moe_local(p, x[:, 2:5], tcfg)
    torch.testing.assert_close(part, full[:, 2:5], rtol=1e-6, atol=1e-6)


def test_capacity_and_unported_kernels_raise(phi):
    """Capacity dispatch runs (it is ported) and an unknown mode raises;
    every kernel switch is ported, so ``all_on`` is the reference's,
    switch by switch."""
    _, _, tcfg, tp = phi
    x = torch.zeros(1, 2, tcfg.d_model)
    out, aux = TM.moe_local(tp["groups"][0][0]["moe"], x, tcfg,
                            dispatch="capacity")
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    assert TM.resolve_dispatch("capacity") == "capacity"
    with pytest.raises(ValueError, match="unknown dispatch mode"):
        TM.resolve_dispatch("bogus")
    import dataclasses
    on_t, on_r = TPolicy.all_on(), RPolicy.all_on()
    assert dataclasses.asdict(on_t) == dataclasses.asdict(on_r)
    assert all(dataclasses.asdict(on_t).values())
    assert TPolicy.auto("cuda") == on_t and TPolicy.auto("cpu") == TPolicy()
    assert on_t.describe() == on_r.describe() == "all-on"
