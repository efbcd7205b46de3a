"""The port's recurrent families against the reference, same inputs, f32.

RWKV6 (rwkv6-1.6b) and the Griffin pattern of RG-LRU blocks and sliding-
window attention over a ring buffer (recurrentgemma-9b), at their reduced
configs, weights carried across with ``bridge.from_reference`` after the
recurrent leaves the reference initialises at zero (token-shift mixes,
bonus, decay bias, conv taps, gate biases) are drawn from the seed
(``_torch_helpers.recurrent_params``), so the carried states matter:

* the layers (``rwkv6_time_mix``, ``rwkv6_channel_mix``, ``rglru_block``):
  outputs and carried states, from zero state and from a given state;
* the windowed and explicit-position (ring) attention bodies, and the
  guard that keeps them off the kernels;
* the model: layer plans, parameter counts and cache layouts of the full
  configs, the stateless forward, cached prefill plus decode with the ring
  wrapping (window 8, as the reference's own ring test).

Layer tolerance: 1e-5 relative plus 1e-5 of the largest |value| (the two
frameworks sum in different orders); logits: rtol 1e-4 plus 1e-4 of the
largest |logit|, the bound of ``tests/test_torch_model.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as RC  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from _torch_helpers import jj, recurrent_params, tt  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import ssm as RS  # noqa: E402
from repro_torch.kernels.policy import KernelPolicy  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402

ARCHS = ["rwkv6-1.6b", "recurrentgemma-9b"]


def _close(got, want, rtol=1e-5, scale=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.detach().numpy(), want, rtol=rtol,
        atol=scale * max(1.0, float(np.abs(want).max())))


def _logits_close(got, want):
    _close(got, want, rtol=1e-4, scale=1e-4)


def _params(arch, seed=0, **cfg_kw):
    return recurrent_params(arch, seed, **cfg_kw)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return (request.param,) + _params(request.param)


@pytest.fixture(scope="module")
def rwkv():
    return _params("rwkv6-1.6b")


@pytest.fixture(scope="module")
def griffin():
    return _params("recurrentgemma-9b")


def _layer0(rp, tp, group, key):
    """Layer 0's ``key`` subtree of a group: (reference, port)."""
    return (jax.tree.map(lambda a: a[0], rp["groups"][group][key]),
            tp["groups"][group][0][key])


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("carried", [False, True], ids=["zero", "given"])
def test_rwkv6_time_mix(rwkv, carried):
    rcfg, rp, tcfg, tp = rwkv
    r_p, t_p = _layer0(rp, tp, 0, "tm")
    h = rcfg.d_model
    nh = h // 64
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, h)).astype(np.float32)
    state = x_prev = None
    kw_r, kw_t = {}, {}
    if carried:
        state = (0.1 * rng.standard_normal((2, nh, 64, 64))).astype(
            np.float32)
        x_prev = rng.standard_normal((2, 1, h)).astype(np.float32)
        kw_r = dict(state=jj(state), x_prev=jj(x_prev))
        kw_t = dict(state=tt(state), x_prev=tt(x_prev))
    r_out, (r_state, r_last) = jax.jit(
        lambda x, kw: RS.rwkv6_time_mix(r_p, x, rcfg, **kw))(jj(x), kw_r)
    t_out, (t_state, t_last) = TS.rwkv6_time_mix(t_p, tt(x), tcfg, **kw_t)
    assert t_state.dtype == torch.float32 and t_state.shape == (2, nh, 64,
                                                                64)
    _close(t_out, r_out)
    _close(t_state, r_state)
    _close(t_last, r_last)


@pytest.mark.parametrize("carried", [False, True], ids=["zero", "given"])
def test_rwkv6_channel_mix(rwkv, carried):
    rcfg, rp, tcfg, tp = rwkv
    r_p, t_p = _layer0(rp, tp, 0, "cm")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, rcfg.d_model)).astype(np.float32)
    prev = rng.standard_normal((2, 1, rcfg.d_model)).astype(np.float32) \
        if carried else None
    r_out, r_last = RS.rwkv6_channel_mix(
        r_p, jj(x), rcfg, x_prev=None if prev is None else jj(prev))
    t_out, t_last = TS.rwkv6_channel_mix(
        t_p, tt(x), tcfg, x_prev=None if prev is None else tt(prev))
    _close(t_out, r_out)
    _close(t_last, r_last)


@pytest.mark.parametrize("carried", [False, True], ids=["zero", "given"])
def test_rglru_block(griffin, carried):
    rcfg, rp, tcfg, tp = griffin
    r_p = jax.tree.map(lambda a: a[0], rp["groups"][0]["l0"]["rglru"])
    t_p = tp["groups"][0][0]["l0"]["rglru"]
    rng = np.random.default_rng(3)
    w, cw = rcfg.lru_width, rcfg.conv1d_width
    x = rng.standard_normal((2, 6, rcfg.d_model)).astype(np.float32)
    kw_r, kw_t = {}, {}
    if carried:
        lru = rng.standard_normal((2, w)).astype(np.float32)
        conv = rng.standard_normal((2, cw - 1, w)).astype(np.float32)
        kw_r = dict(state=jj(lru), conv_state=jj(conv))
        kw_t = dict(state=tt(lru), conv_state=tt(conv))
    r_out, (r_lru, r_conv) = jax.jit(
        lambda x, kw: RS.rglru_block(r_p, x, rcfg, **kw))(jj(x), kw_r)
    t_out, (t_lru, t_conv) = TS.rglru_block(t_p, tt(x), tcfg, **kw_t)
    assert t_lru.dtype == torch.float32
    _close(t_out, r_out)
    _close(t_lru, r_lru)
    _close(t_conv, r_conv)


def test_recurrent_layers_keep_f32_state_under_bf16():
    """bf16 activations: the wkv and LRU states come out f32, the conv
    tail and token-shift rows in the serving dtype."""
    cfg = TC.get_reduced("recurrentgemma-9b")
    gen = torch.Generator().manual_seed(0)
    p = TM.init_params(gen, cfg, torch.bfloat16, "cpu")
    x = torch.randn(1, 3, cfg.d_model, generator=gen).bfloat16()
    out, (lru, conv) = TS.rglru_block(p["groups"][0][0]["l0"]["rglru"], x,
                                      cfg)
    assert (out.dtype, lru.dtype, conv.dtype) == (
        torch.bfloat16, torch.float32, torch.bfloat16)
    rcfg = TC.get_reduced("rwkv6-1.6b")
    rp = TM.init_params(gen, rcfg, torch.bfloat16, "cpu")
    x = torch.randn(1, 3, rcfg.d_model, generator=gen).bfloat16()
    out, (state, last) = TS.rwkv6_time_mix(rp["groups"][0][0]["tm"], x,
                                           rcfg)
    assert (out.dtype, state.dtype, last.dtype) == (
        torch.bfloat16, torch.float32, torch.bfloat16)


# ---------------------------------------------------------------------------
# windowed and ring attention
# ---------------------------------------------------------------------------

def _qkv(rng, b, sq, skv, nq=4, nkv=2, hd=16):
    return (rng.standard_normal((b, sq, nq, hd)).astype(np.float32),
            rng.standard_normal((b, skv, nkv, hd)).astype(np.float32),
            rng.standard_normal((b, skv, nkv, hd)).astype(np.float32))


ATTN_CASES = {
    # stateless sliding window (recurrentgemma's cache-free forward)
    "window": dict(sq=12, skv=12, window=4),
    # a window with a key-length mask: the case a flash_chunk policy would
    # take if the guard did not look at the window
    "window_kv_len": dict(sq=6, skv=12, window=4, q_offset=4, kv_len=10),
    # prefill into a ring: [ring slots ; fresh rows] with explicit
    # positions, empty slots -1, at a scalar offset
    "ring_prefill": dict(sq=6, skv=14, window=5, q_offset=5,
                         k_positions=np.r_[[-1, -1, 4, 0, 1, 2, 3, -1],
                                           np.arange(6) + 5]),
    # the same with per-slot positions (b, skv)
    "ring_prefill_per_slot": dict(
        sq=3, skv=7, window=4, q_offset=4,
        k_positions=np.array([[0, 1, 2, 3, 4, 5, 6],
                              [-1, 1, 2, 3, 4, 5, 6]])),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_chunked_attention_window_and_positions(case, monkeypatch):
    """Both bodies agree; a window or a ring never reaches the dense
    kernel, even with the flash_chunk policy on (the reference's guard)."""
    from repro_torch.kernels import ops
    c = dict(ATTN_CASES[case])
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, 2, c.pop("sq"), c.pop("skv"))
    if "k_positions" in c:
        c["k_positions"] = c["k_positions"].astype(np.int32)
    want = RL.chunked_attention(jj(q), jj(k), jj(v), causal=True,
                                **{n: jj(x) if isinstance(x, np.ndarray)
                                   else x for n, x in c.items()})

    def refuse(*a, **kw):
        raise AssertionError("a windowed attention reached flash_chunk")
    monkeypatch.setattr(ops, "flash_chunk", refuse)
    got = TL.chunked_attention(tt(q), tt(k), tt(v), causal=True,
                               policy=KernelPolicy.parse("on"),
                               **{n: tt(x) if isinstance(x, np.ndarray)
                                  else x for n, x in c.items()})
    _close(got, want)


@pytest.mark.parametrize("per_slot", [False, True], ids=["uniform", "slots"])
def test_decode_attention_ring(per_slot, monkeypatch):
    """One-row decode against a ring (W 6) with explicit positions, some
    slots empty, and a window of 4; never the flash_decode kernel."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, 2, 1, 6)
    kpos = np.array([[6, 7, 8, 9, 4, 5], [6, -1, -1, -1, 4, 5]], np.int32)
    qp = np.array([[9], [6]], np.int32) if per_slot \
        else np.array([9], np.int32)
    want = RL.decode_attention(jj(q), jj(k), jj(v), q_positions=jj(qp),
                               window=4, k_positions=jj(kpos))

    def refuse(*a, **kw):
        raise AssertionError("a ring decode reached flash_decode")
    monkeypatch.setattr(ops, "flash_decode", refuse)
    got = TL.decode_attention(tt(q), tt(k), tt(v),
                              q_positions=tt(qp).reshape(-1, 1), window=4,
                              k_positions=tt(kpos),
                              policy=KernelPolicy.parse("on"))
    _close(got, want)


@pytest.mark.parametrize("s", [5, 8, 13], ids=["short", "full", "wraps"])
def test_ring_from_prefill(s):
    rng = np.random.default_rng(6)
    k = rng.standard_normal((2, s, 1, 4)).astype(np.float32)
    v = rng.standard_normal((2, s, 1, 4)).astype(np.float32)
    want = RM._ring_from_prefill(jj(k), jj(v), 8, s)
    got = TM._ring_from_prefill(tt(k), tt(v), 8, s)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_plan_params_and_cache(arch):
    """The full configs' layer plan, parameter count and dense cache
    layout equal the reference's (recurrentgemma-9b: 12 x (rec, rec,
    attn) + a rec group of 2; the states f32 under a bf16 cache; ring
    positions start at -1)."""
    rcfg, tcfg = RC.get(arch), TC.get(arch)
    assert [dataclasses.astuple(g) for g in TM.layer_plan(tcfg)] \
        == [dataclasses.astuple(g) for g in RM.layer_plan(rcfg)]
    assert TM.count_params(tcfg) == RM.count_params(rcfg)
    want = RM.init_cache(rcfg, 2, 4096, jnp.bfloat16, abstract=True)
    meta = torch.device("meta")
    got = TM.init_cache(tcfg, 2, 4096, torch.bfloat16, meta)
    flat_w = jax.tree_util.tree_flatten_with_path(want["groups"])[0]
    flat_g = {jax.tree_util.keystr(p): t for p, t in
              jax.tree_util.tree_flatten_with_path(got["groups"])[0]}
    assert len(flat_g) == len(flat_w)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32}
    for path, leaf in flat_w:
        t = flat_g[jax.tree_util.keystr(path)]
        assert tuple(t.shape) == leaf.shape and t.dtype == dt[
            str(leaf.dtype)], path
    if arch == "recurrentgemma-9b":
        assert TM.layer_plan(tcfg) == (
            TM.Group("pattern", 12, ("rec", "rec", "attn")),
            TM.Group("rec", 2))
        small = TM.init_cache(TC.get_reduced(arch), 1, 16, device="cpu")
        assert (small["groups"][0]["l2"]["kpos"] == -1).all()


def test_stateless_forward(model):
    arch, rcfg, rp, tcfg, tp = model
    toks = np.random.default_rng(7).integers(
        0, rcfg.vocab_size, (2, 21)).astype(np.int32)
    want = RM.forward(rp, rcfg, tokens=jj(toks)).logits
    _logits_close(TM.forward(tp, tcfg, tokens=tt(toks)).logits, want)


def test_pattern_with_remainder_groups():
    """8 layers of the Griffin pattern: 2 repeats and a trailing rec group
    of 2; the bridge unstacks the pattern repeat by repeat, and the
    stateless forward matches (a window shorter than the rows)."""
    rcfg, rp, tcfg, tp = _params("recurrentgemma-9b", seed=1, n_layers=8,
                                 window_size=6)
    assert [g.kind for g in TM.layer_plan(tcfg)] == ["pattern", "rec"]
    assert len(tp["groups"][0]) == 2 and sorted(tp["groups"][0][1]) == [
        "l0", "l1", "l2"]
    np.testing.assert_array_equal(
        tp["groups"][0][1]["l2"]["attn"]["wq"].numpy(),
        np.asarray(rp["groups"][0]["l2"]["attn"]["wq"][1]))
    toks = np.random.default_rng(8).integers(
        0, rcfg.vocab_size, (1, 15)).astype(np.int32)
    _logits_close(TM.forward(tp, tcfg, tokens=tt(toks)).logits,
                  RM.forward(rp, rcfg, tokens=jj(toks)).logits)


@pytest.mark.parametrize("arch", ARCHS)
def test_cached_prefill_and_decode_ring_wraps(arch):
    """A 6-row prefill into the cache, then 12 decode steps (window 8:
    the ring wraps twice): every step's logits match the reference's
    cached run and the stateless forward over the same tokens; the final
    states and ring (positions exactly) match the reference's cache."""
    rcfg, rp, tcfg, tp = _params(arch, seed=2, window_size=8)
    s_pre, n_dec = 6, 12
    toks = np.random.default_rng(9).integers(
        0, rcfg.vocab_size, (2, s_pre + n_dec)).astype(np.int32)
    full = TM.forward(tp, tcfg, tokens=tt(toks)).logits
    r_cache = RM.init_cache(rcfg, 2, 64, jnp.float32)
    t_cache = TM.init_cache(tcfg, 2, 64, torch.float32, "cpu")
    r_fwd = jax.jit(lambda t, c: RM.forward(rp, rcfg, tokens=t, cache=c))
    r = r_fwd(jj(toks[:, :s_pre]), r_cache)
    t = TM.forward(tp, tcfg, tokens=tt(toks[:, :s_pre]), cache=t_cache)
    _logits_close(t.logits, r.logits)
    r_cache = r.cache
    for i in range(s_pre, s_pre + n_dec):
        r = r_fwd(jj(toks[:, i:i + 1]), r_cache)
        t = TM.forward(tp, tcfg, tokens=tt(toks[:, i:i + 1]), cache=t_cache)
        r_cache = r.cache
        _logits_close(t.logits, r.logits)
        _logits_close(t.logits[:, 0], full[:, i].numpy())
    assert int(t_cache["length"]) == int(r_cache["length"]) == s_pre + n_dec
    flat_r = jax.tree_util.tree_flatten_with_path(r_cache["groups"])[0]
    flat_t = {jax.tree_util.keystr(p): v for p, v in
              jax.tree_util.tree_flatten_with_path(t_cache["groups"])[0]}
    for path, want in flat_r:
        got = flat_t[jax.tree_util.keystr(path)]
        if got.dtype == torch.int32:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            _close(got, want, rtol=1e-4, scale=1e-4)


def test_recurrent_kinds_refuse_paged_cache_and_ragged_step(rwkv):
    rcfg, rp, tcfg, tp = rwkv
    with pytest.raises(NotImplementedError, match="legacy"):
        TM.init_paged_cache(tcfg, 2, 64, page_size=16, pool_pages=8,
                            device="cpu")
    cache = TM.init_cache(tcfg, 2, 64, torch.float32, "cpu")
    cache["length"] = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="legacy engine path"):
        TM.forward(tp, tcfg, tokens=torch.zeros(2, 4, dtype=torch.int64),
                   cache=cache, q_lens=torch.tensor([4, 1],
                                                    dtype=torch.int32))
