"""The port's dense per-slot KV cache and stateless forward against the
reference's: ``write_cache`` in its three branches, ``forward`` on the
dense cache (the unified mixed step and the uniform prefill / decode) and
with no cache, and ``LLM.generate`` with ``kv="dense"``.

Configs: the reduced GQA models phi3.5-moe, smollm, gemma (MQA, GeGLU,
tied embedding) and minitron (GELU, no gate), and the reduced MLA models
deepseek-v2 and minicpm3.  Tolerances: ``write_cache`` bitwise (a copy);
logits rtol 1e-4 with an absolute floor of 1e-4 of the largest logit, the
cached buffers rtol 1e-4 with a floor of 1e-5 of their largest magnitude,
as tests/test_torch_model.py states for the paged step (float32, other
summation orders); streams, lengths and expert counts exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_helpers import both_params, jj, tt  # noqa: E402
from repro.core.partitioner import make_plan as r_make_plan  # noqa: E402
from repro.kernels.policy import KernelPolicy as RPolicy  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import model as RMOD  # noqa: E402
from repro.serving import kv_cache as RKV  # noqa: E402
from repro.serving.api import LLM as RLLM  # noqa: E402
from repro.serving.api import ServeSpec as RSpec  # noqa: E402
from repro_torch.core.partitioner import make_plan as t_make_plan  # noqa
from repro_torch.core.resolve import KVConfig  # noqa: E402
from repro_torch.kernels.policy import KernelPolicy as TPolicy  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TMOD  # noqa: E402
from repro_torch.serving import kv_cache as TKV  # noqa: E402
from repro_torch.serving.api import LLM as TLLM  # noqa: E402
from repro_torch.serving.api import ServeSpec as TSpec  # noqa: E402

ARCHS = ["phi3.5-moe-42b", "smollm-360m", "gemma-2b", "minitron-8b",
         "deepseek-v2-236b", "minicpm3-4b"]
STEPS = ([8, 5, 0], [1, 1, 0], [1, 7, 3])   # prefill, decode, mixed


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return (request.param,) + both_params(request.param)


def _plans(on: bool):
    """(reference plan, port plan) with every kernel on, or none: the
    reference's interpret-mode kernels, the port's plain versions on the
    CPU through the kernel routing.  Like for like: the kernels give pad
    rows exact zeros, and pad rows still route through the MoE."""
    return (r_make_plan("mixserve", None,
                        kernels=RPolicy.all_on() if on else RPolicy()),
            t_make_plan("mixserve", None,
                        kernels=TPolicy.all_on() if on else TPolicy()))


def _close(got, want, rel):
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=rel * float(np.abs(want).max()))


def _check_cache(t_cache, r_cache):
    np.testing.assert_array_equal(t_cache["length"].numpy(),
                                  np.asarray(r_cache["length"]))
    for tg, rg in zip(t_cache["groups"], r_cache["groups"]):
        assert set(tg) == set(rg)
        for k in tg:
            assert tuple(tg[k].shape) == tuple(rg[k].shape)
            _close(tg[k].numpy(), np.asarray(rg[k]), 1e-5)


# --- write_cache: bitwise, in all three branches --------------------------

# (branch, idx, valid_len): a uniform batch at offset 3, and at 9, which
# the slice start clamps to 16 - 8; per-slot offsets with a ragged tail, an
# idle slot and a slot whose rows run past the buffer; the one-row decode
# write with a slot past the buffer
WRITE_CASES = {
    "scalar": ((3, 9), None),
    "per_slot": (([2, 12, 5, 0],), [8, 6, 0, 3]),
    "decode": (([0, 15, 7, 16],), None),
}


@pytest.mark.parametrize("tail", [(2, 4), (6,)], ids=["gqa", "latent"])
@pytest.mark.parametrize("branch", sorted(WRITE_CASES))
def test_write_cache_bitwise_reference(branch, tail):
    rng = np.random.default_rng(0)
    b, S = 4, 16
    s = 1 if branch == "decode" else 8
    idxs, valid = WRITE_CASES[branch]
    buf = rng.standard_normal((b, S) + tail).astype(np.float32)
    new = rng.standard_normal((b, s) + tail).astype(np.float32)
    for idx in idxs:
        r_idx = jnp.int32(idx) if branch == "scalar" \
            else jj(np.asarray(idx, np.int32))
        t_idx = idx if branch == "scalar" \
            else tt(np.asarray(idx, np.int32))
        r_vl = None if valid is None else jj(np.asarray(valid, np.int32))
        t_vl = None if valid is None else tt(np.asarray(valid, np.int32))
        want = np.asarray(RL.write_cache(jj(buf), jj(new), r_idx, r_vl))
        t_buf = tt(buf)
        got = TL.write_cache(t_buf, tt(new), t_idx, t_vl)
        assert got is t_buf                       # in place
        np.testing.assert_array_equal(got.numpy(), want)
        assert not np.array_equal(want, buf)
        t0 = tt(buf)                 # a 0-d tensor offset: the same write
        if branch == "scalar":
            TL.write_cache(t0, tt(new), torch.tensor(idx, dtype=torch.int32))
            np.testing.assert_array_equal(t0.numpy(), want)


# --- forward on the dense cache and with none -----------------------------

def _dense_caches(rcfg, tcfg, b, max_len):
    r = RKV.make_batched_cache(rcfg, b, max_len, jnp.float32)
    t = TKV.make_batched_cache(tcfg, b, max_len, torch.float32, "cpu")
    return r, t


@pytest.mark.parametrize("kernels", ["off", "on"])
def test_forward_dense_unified_steps_match_reference(arch, kernels):
    """A prefill, a decode and a mixed ragged step on one dense cache; the
    width-1 step is flash_decode-shaped (MLA: the absorbed regime)."""
    _, rcfg, rp, tcfg, tp = arch
    b, s, max_len = 3, 8, 24
    r_plan, t_plan = _plans(kernels == "on")
    r_cache, t_cache = _dense_caches(rcfg, tcfg, b, max_len)
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
        assert t_out.cache is t_cache
        rl, tl = np.asarray(r_out.logits), t_out.logits.numpy()
        for i in range(b):
            np.testing.assert_allclose(tl[i, :q_lens[i]], rl[i, :q_lens[i]],
                                       rtol=1e-4,
                                       atol=1e-4 * float(np.abs(rl).max()))
        if rcfg.is_moe:
            np.testing.assert_array_equal(t_out.expert_counts.numpy(),
                                          np.asarray(r_out.expert_counts))
        r_cache = r_out.cache
        _check_cache(t_cache, r_cache)


def test_forward_dense_uniform_prefill_then_decode_match_reference(arch):
    """``init_cache``'s 0-d length: a uniform 6-row prefill (one offset for
    every slot), then two one-token decodes."""
    _, rcfg, rp, tcfg, tp = arch
    b, max_len = 2, 16
    r_plan, t_plan = _plans(False)
    r_cache = RMOD.init_cache(rcfg, b, max_len, jnp.float32)
    t_cache = TMOD.init_cache(tcfg, b, max_len, torch.float32, "cpu")
    assert t_cache["length"].shape == ()
    rng = np.random.default_rng(3)
    for s in (6, 1, 1):
        toks = rng.integers(0, rcfg.vocab_size, (b, s)).astype(np.int32)
        r_out = RMOD.forward(rp, rcfg, r_plan, tokens=jj(toks), cache=r_cache)
        t_out = TMOD.forward(tp, tcfg, t_plan, tokens=tt(toks), cache=t_cache)
        _close(t_out.logits.numpy(), np.asarray(r_out.logits), 1e-4)
        r_cache = r_out.cache
        _check_cache(t_cache, r_cache)
    assert int(t_cache["length"]) == 8


@pytest.mark.parametrize("kernels", ["off", "on"])
def test_forward_stateless_matches_reference(arch, kernels, monkeypatch):
    """No cache: every row sees the rows before it; no cache comes back,
    and a unified-step or head-selection argument without a cache is
    refused as in the reference.  With kernels on, attention keeps the
    plain body (the reference routes to its kernel only with a cache
    length); the MoE layers run their kernels' plain versions."""
    from repro_torch.kernels import ops
    _, rcfg, rp, tcfg, tp = arch
    r_plan, t_plan = _plans(kernels == "on")
    for name in ("flash_chunk", "flash_decode", "flash_chunk_paged"):
        monkeypatch.setattr(ops, name, None)     # a call would raise
    toks = np.random.default_rng(4).integers(
        0, rcfg.vocab_size, (2, 10)).astype(np.int32)
    r_out = RMOD.forward(rp, rcfg, r_plan, tokens=jj(toks))
    t_out = TMOD.forward(tp, tcfg, t_plan, tokens=tt(toks))
    assert t_out.cache is None
    _close(t_out.logits.numpy(), np.asarray(r_out.logits), 1e-4)
    if rcfg.is_moe:
        np.testing.assert_allclose(float(t_out.aux), float(r_out.aux),
                                   rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="requires a cache"):
        TMOD.forward(tp, tcfg, t_plan, tokens=tt(toks),
                     q_lens=torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="last_only"):
        TMOD.forward(tp, tcfg, t_plan, tokens=tt(toks), last_only=True)


# --- the serving stack on the dense backend ---------------------------------

def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("chunk", [8, 1])
def test_generate_dense_streams_equal_reference_and_paged(arch, chunk):
    """kv="dense" against the reference's dense serve and the port's own
    paged serve (prefix cache off, the same chunking); kernels on (their
    plain versions on the CPU) give the same streams."""
    name, rcfg, rp, tcfg, tp = arch
    kw = dict(arch=name, max_batch=2, max_len=48, chunk=chunk)
    prompts = _prompts(rcfg.vocab_size, (13, 5, 10))
    want = RLLM.from_spec(RSpec(kv="dense", **kw), cfg=rcfg,
                          params=rp).generate(prompts, 4)
    dense = TLLM.from_spec(TSpec(kv="dense", **kw), cfg=tcfg, params=tp,
                           device="cpu")
    assert dense.engine.kv.backend == "dense"
    assert dense.engine.kv.pool_tokens is None
    assert dense.generate(prompts, 4) == want
    assert dense.engine.kv.stats.n_prefix_hits == 0
    assert dense.engine.kv.occupancy() == 0.0
    on = TLLM.from_spec(TSpec(kv="dense", kernels="on", **kw), cfg=tcfg,
                        params=tp, device="cpu")
    assert on.generate(prompts, 4) == want
    paged = TLLM.from_spec(
        TSpec(kv=KVConfig(backend="paged", page_size=8, prefix_cache=False),
              **kw),
        cfg=tcfg, params=tp, device="cpu")
    assert paged.engine.kv.backend == "paged"
    assert paged.generate(prompts, 4) == want


def test_dense_backend_grants_every_reserve_and_tracks_lengths():
    """The host side: reserve grants all, begin/free zero the slot's
    device length, the device length is authoritative (advance is a
    no-op), occupancy reads it."""
    import repro_torch.configs as TC
    cfg = TC.get_reduced("gemma-2b")
    kv = TKV.make_kv_cache(cfg, KVConfig(backend="dense"), 2, 32,
                           torch.float32, "cpu")
    assert isinstance(kv, TKV.DenseKVCache)
    assert {n: tuple(t.shape) for n, t in kv.cache["groups"][0].items()} \
        == {"k": (2, 2, 32, 1, 64), "v": (2, 2, 32, 1, 64)}
    assert kv.kv_bytes() == 2 * 2 * 2 * 32 * 64 * 4
    assert kv.begin(0, [1, 2, 3]) == 0 and kv.reserve(0, 1000) == 1000
    kv.cache["length"].copy_(torch.tensor([8, 24], dtype=torch.int32))
    kv.advance(np.array([5, 5]))
    assert TKV.batched_lengths(kv.cache).tolist() == [8, 24]
    assert kv.occupancy() == 0.5
    kv.free(1)
    assert kv.cache["length"].tolist() == [8, 0]
    swapped = TKV.with_lengths(kv.cache, torch.zeros(2, dtype=torch.int32))
    assert swapped["groups"] is kv.cache["groups"]
    assert kv.cache["length"].tolist() == [8, 0]
