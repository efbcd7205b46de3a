"""The port's frontend families against the reference, same inputs, f32.

qwen2-vl (M-RoPE over three position streams, a patch-embedding stub
prepended to the tokens) and whisper (a bidirectional encoder over a frame
stub, decoder layers with cross-attention over its output), at their
reduced configs, weights carried across with ``bridge.from_reference``
after every norm weight the reference initialises at zero (the decoder's
attention, cross-attention and MLP norms, the encoder's ``norm`` /
``mlp_norm`` / ``final_norm``, the model's ``final_norm``) is drawn from a
numpy seed, so a swapped norm does not hide behind ``1 + 0``:

* ``apply_mrope`` with distinct t/h/w streams (a 4x4 patch grid at t = 0,
  then text), at head dims 32 and 128;
* ``forward`` with explicit ``(b, 3, s)`` positions, with ``embeds=`` and
  with ``tokens=None``; ``encode_audio``, ``_cross_attn`` and whisper's
  stateless forward on random frames;
* prefill-then-decode against the stateless forward, ``insert_slot``
  carrying the cross-attention K/V, the full configs' plans, parameter
  counts and cache layouts;
* greedy ``LLM.generate`` streams equal to the reference's token for token
  on the legacy path: whisper with the default frames and with a seeded
  ``embeds_fn``, qwen2-vl with a seeded ``embeds_fn`` and without one
  (its first token read at a row past the prompt, clamped to the last
  row, and 16 never-written rows in the decode, as in the reference).

Layer tolerance: 1e-5 relative plus 1e-5 of the largest |value|; logits:
rtol 1e-4 plus 1e-4 of the largest |logit| (``tests/test_torch_model.py``).
Two exceptions, both whisper's encoder on random frames: the reference's
init draws ``wq`` / ``wk`` with the head count as fan-in (std 0.5 here),
so its bidirectional attention over iid frame rows is close to one-hot and
multiplies f32 rounding.  The encoder's output is held to 1e-4 relative
plus 1e-4 of its largest |value|, and the logits of a forward through it
to rtol 1e-4 plus 1e-3 of the largest |logit| (the bound phase 5 of
``chip_smoke.py`` holds the sharded logits to, for the same reason): on
this test's 17 rows the reference's own f32 logits sit 2.3e-4 of the
largest |logit| from an f64 run of the port, the port's f32 logits 2.3e-4
too, and the two 1.7e-4 apart.  The cached forward is held to the port's
stateless forward at 1e-4 (the encoder's output is the same on both).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as RC  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from _torch_helpers import jj, tt  # noqa: E402
from repro.core.partitioner import NULL_PLAN as RNULL  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serving.api import LLM as RLLM  # noqa: E402
from repro.serving.api import ServeSpec as RSpec  # noqa: E402
from repro_torch.bridge import from_reference  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import kv_cache as TK  # noqa: E402
from repro_torch.serving.api import LLM as TLLM  # noqa: E402
from repro_torch.serving.api import ServeSpec as TSpec  # noqa: E402

VL, WH = "qwen2-vl-7b", "whisper-tiny"
LENS = (20, 32, 70)
NEW = 6

# the norm weights the reference initialises at zero, by leaf name
NORMS = ("norm", "mlp_norm", "final_norm")


def _close(got, want, rtol=1e-5, scale=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.detach().numpy(), want, rtol=rtol,
        atol=scale * max(1.0, float(np.abs(want).max())))


def _logits_close(got, want, scale=1e-4):
    _close(got, want, rtol=1e-4, scale=scale)


# of the largest |logit|: whisper on random frames (see the docstring)
REF_LOGITS = {"qwen2-vl-7b": 1e-4, "whisper-tiny": 1e-3}


def draw_norms(rp, seed):
    """The reference's params with every ``NORMS`` leaf drawn from
    N(0, 0.25) (numpy ``seed``), so ``1 + w`` scales each channel."""
    rng = np.random.default_rng(seed)

    def one(path, leaf):
        if getattr(path[-1], "key", None) in NORMS:
            return jnp.asarray(0.5 * rng.standard_normal(leaf.shape),
                               leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(one, rp)


def _params(arch, seed=0):
    rcfg, tcfg = RC.get_reduced(arch), TC.get_reduced(arch)
    rp = draw_norms(RM.init_params(jax.random.PRNGKey(seed), rcfg,
                                   jnp.float32), seed)
    return rcfg, rp, tcfg, from_reference(jax.tree.map(np.asarray, rp),
                                          tcfg)


@pytest.fixture(scope="module")
def vl():
    return _params(VL)


@pytest.fixture(scope="module")
def wh():
    return _params(WH)


def grid_positions(b, n_text, side=4, shift=0):
    """(b, 3, side**2 + n_text) Qwen2-VL positions: a side x side patch
    grid at t = 0 (h = row, w = column), then text from ``side`` on in all
    three streams; row i shifted by ``i * shift``."""
    n = side * side
    grid = np.stack([np.zeros(n), np.arange(n) // side, np.arange(n) % side])
    text = np.broadcast_to(side + np.arange(n_text), (3, n_text))
    p = np.concatenate([grid, text], axis=1).astype(np.int32)
    return np.stack([p + i * shift for i in range(b)])


def _embeds(cfg, b=1, seed=5):
    """Patch embeddings at the embedding table's scale."""
    return (0.02 * np.random.default_rng(seed).standard_normal(
        (b, cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32)


def _frames(cfg, b=1, seed=5):
    e = cfg.encoder
    return np.random.default_rng(seed).standard_normal(
        (b, e.n_frames, e.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd,sections", [(32, (4, 6, 6)),
                                         (128, (16, 24, 24))])
def test_mrope_distinct_streams(hd, sections):
    """Distinct t/h/w streams: the port equals the reference; the same
    rows under plain RoPE (the text stream alone) differ, and the streams
    broadcast from one position equal plain RoPE (so only distinct streams
    test the section map)."""
    rng = np.random.default_rng(1)
    pos3 = grid_positions(2, 9, shift=3)
    x = rng.standard_normal((2, pos3.shape[-1], 3, hd)).astype(np.float32)
    want = RL.apply_mrope(jj(x), jj(pos3), sections, 1e6)
    got = TL.apply_mrope(tt(x), tt(pos3), sections, 1e6)
    _close(got, want)
    plain = TL.apply_rope(tt(x), tt(pos3[:, 0]), 1e6)
    assert float((got - plain).abs().max()) > 1e-2
    same = TL.apply_mrope(tt(x), tt(pos3[:, :1]).expand(2, 3, -1),
                          sections, 1e6)
    torch.testing.assert_close(same, plain, rtol=0, atol=1e-6)


@pytest.mark.parametrize("sections,n", [((1, 2, 2), 7), ((1, 2, 2), 3),
                                        ((16, 24, 24), 64)])
def test_mrope_pairs_repeat_like_the_reference(sections, n):
    want = jnp.repeat(jnp.arange(len(sections)), jnp.asarray(sections),
                      total_repeat_length=n)
    assert TL.mrope_pairs(sections, n) == np.asarray(want).tolist()


# ---------------------------------------------------------------------------
# forward: positions, embeds, frames
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["positions", "embeds", "embeds+positions",
                                  "embeds only"])
def test_vlm_forward(vl, case):
    """The stateless forward with explicit (b, 3, s) positions (a patch
    grid), with patch embeddings before the tokens (rounded to bf16 on both
    sides), and with embeddings alone (tokens=None; at an f32 config dtype,
    since the reference's layer scan refuses bf16-rounded rows on f32
    weights)."""
    rcfg, rp, tcfg, tp = vl
    if case == "embeds only":
        rcfg = dataclasses.replace(rcfg, dtype="float32")
        tcfg = dataclasses.replace(tcfg, dtype="float32")
    b, n_text = 2, 11
    toks = np.random.default_rng(7).integers(
        0, rcfg.vocab_size, (b, n_text)).astype(np.int32)
    front = tcfg.n_frontend_tokens
    kw_r, kw_t = {}, {}
    if case != "embeds only":
        kw_r["tokens"], kw_t["tokens"] = jj(toks), tt(toks)
    if "embeds" in case:
        e = _embeds(tcfg, b)
        kw_r["embeds"], kw_t["embeds"] = jj(e), tt(e)
    if "positions" in case:
        side = int(round(front ** 0.5))
        if case == "positions":     # the grid over the first 16 tokens
            side = int(round(min(front, n_text - 2) ** 0.5))
        s = front * ("embeds" in case) + n_text
        pos = grid_positions(b, s - side * side, side=side, shift=2)
        kw_r["positions"], kw_t["positions"] = jj(pos), tt(pos)
    want = RM.forward(rp, rcfg, **kw_r).logits
    got = TM.forward(tp, tcfg, **kw_t).logits
    _logits_close(got, want)
    if "positions" in case:         # the streams move the logits
        plain = TM.forward(tp, tcfg, **{k: v for k, v in kw_t.items()
                                        if k != "positions"}).logits
        assert float((plain - got).abs().max()) > 1e-3


def test_encode_audio(wh):
    rcfg, rp, tcfg, tp = wh
    fr = _frames(tcfg, 2)
    want = RM.encode_audio(rp, jj(fr), rcfg, RNULL)
    _close(TM.encode_audio(tp, tt(fr), tcfg), want, rtol=1e-4, scale=1e-4)


def test_cross_attn(wh):
    """One layer's cross-attention over the encoder output's K/V."""
    rcfg, rp, tcfg, tp = wh
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, rcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, rcfg.encoder.n_frames, rcfg.d_model)) \
        .astype(np.float32)
    rx = jax.tree.map(lambda a: a[1], rp["groups"][0]["xattn"])
    px = tp["groups"][0][1]["xattn"]
    xk = jnp.einsum("bsh,hnd->bsnd", jj(enc), rx["wk"])
    xv = jnp.einsum("bsh,hnd->bsnd", jj(enc), rx["wv"])
    want = RM._cross_attn(rx, jj(x), rcfg, RNULL, xk, xv)
    got = TM._cross_attn(px, tt(x), tcfg, TL._proj_heads(tt(enc), px["wk"]),
                         TL._proj_heads(tt(enc), px["wv"]))
    _close(got, want)


def test_whisper_stateless_forward(wh):
    rcfg, rp, tcfg, tp = wh
    toks = np.random.default_rng(7).integers(
        0, rcfg.vocab_size, (2, 13)).astype(np.int32)
    fr = _frames(tcfg, 2)
    want = RM.forward(rp, rcfg, tokens=jj(toks), frames=jj(fr)).logits
    _logits_close(TM.forward(tp, tcfg, tokens=tt(toks), frames=tt(fr))
                  .logits, want, REF_LOGITS[WH])
    with pytest.raises(ValueError, match="frames"):
        TM.forward(tp, tcfg, tokens=tt(toks))


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [VL, WH])
def test_prefill_then_decode_matches_stateless(arch, vl, wh):
    """Prefill the stub and a prompt into a batch-1 cache, then one-token
    decode steps (whisper without frames: the cached cross K/V): each
    step's logits match the stateless forward over the same rows, which
    matches the reference's."""
    rcfg, rp, tcfg, tp = vl if arch == VL else wh
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, rcfg.vocab_size, 12).astype(np.int32)
    if arch == VL:
        name, stub = "embeds", _embeds(tcfg)
    else:
        name, stub = "frames", _frames(tcfg)
    cache = TM.init_cache(tcfg, 1, 64, torch.float32, "cpu")
    out = TM.forward(tp, tcfg, tokens=tt(prompt)[None], cache=cache,
                     **{name: tt(stub)})
    rows = [out.logits[0, -1]]
    toks = [int(rows[-1].argmax())]
    for _ in range(5):
        out = TM.forward(tp, tcfg, tokens=torch.tensor([[toks[-1]]]),
                         cache=cache)
        rows.append(out.logits[0, 0])
        toks.append(int(rows[-1].argmax()))
    seq = np.concatenate([prompt, toks[:-1]]).astype(np.int32)[None]
    full = TM.forward(tp, tcfg, tokens=tt(seq), **{name: tt(stub)}).logits
    want = RM.forward(rp, rcfg, tokens=jj(seq), **{name: jj(stub)}).logits
    _logits_close(full, want, REF_LOGITS[arch])
    n = len(prompt) - 1 + (tcfg.n_frontend_tokens if arch == VL else 0)
    _logits_close(torch.stack(rows), full[0, n:].numpy())
    assert int(cache["length"]) == full.shape[1]


def test_insert_slot_carries_cross_kv(wh):
    """A whisper prefill's batch-1 cache holds the fresh cross K/V, and
    ``insert_slot`` copies every buffer, xk / xv included, into its slot
    of the batch cache; the other slot and ``kv_bytes`` account for it."""
    rcfg, rp, tcfg, tp = wh
    small = TM.init_cache(tcfg, 1, 32, torch.float32, "cpu")
    toks = np.arange(7, dtype=np.int32)[None]
    TM.forward(tp, tcfg, tokens=tt(toks), frames=tt(_frames(tcfg)),
               cache=small)
    big = TK.make_batched_cache(tcfg, 2, 32, torch.float32, "cpu")
    TK.insert_slot(big, small, 1)
    for name in ("k", "v", "xk", "xv"):
        s, bg = small["groups"][0][name], big["groups"][0][name]
        assert float(s.abs().max()) > 0, name
        assert torch.equal(bg[:, 1:2], s) and not bg[:, 0].any(), name
    assert big["length"].tolist() == [0, 7]
    kv = TK.DenseKVCache(tcfg, 2, 32, torch.float32, "cpu")
    e, L_ = tcfg.encoder, tcfg.n_layers
    want = 4 * L_ * 2 * (2 * 32 * tcfg.n_kv_heads * tcfg.head_dim
                         + 2 * e.n_frames * tcfg.n_heads * tcfg.head_dim)
    assert kv.kv_bytes() == want


@pytest.mark.parametrize("arch", [VL, WH])
def test_full_config_plan_params_and_cache(arch):
    """The full configs' layer plan, parameter count (whisper's encoder
    included) and dense cache layout (whisper's xk / xv over 1500 frames)
    equal the reference's."""
    rcfg, tcfg = RC.get(arch), TC.get(arch)
    assert [dataclasses.astuple(g) for g in TM.layer_plan(tcfg)] \
        == [dataclasses.astuple(g) for g in RM.layer_plan(rcfg)]
    assert TM.count_params(tcfg) == RM.count_params(rcfg)
    want = RM.init_cache(rcfg, 2, 512, jnp.bfloat16, abstract=True)
    got = TM.init_cache(tcfg, 2, 512, torch.bfloat16, torch.device("meta"))
    flat_w = jax.tree_util.tree_flatten_with_path(want["groups"])[0]
    flat_g = {jax.tree_util.keystr(p): t for p, t in
              jax.tree_util.tree_flatten_with_path(got["groups"])[0]}
    assert len(flat_g) == len(flat_w)
    for path, leaf in flat_w:
        t = flat_g[jax.tree_util.keystr(path)]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.bfloat16
    if arch == WH:
        assert set(got["groups"][0]) == {"k", "v", "xk", "xv"}


# ---------------------------------------------------------------------------
# serving: the legacy path
# ---------------------------------------------------------------------------

def _embeds_fns(arch, cfg, kind):
    """(reference embeds_fn, port embeds_fn) for ``kind``: "default" (none
    given: whisper's constant frames; qwen2-vl no stub at all) or
    "seeded" (one seeded stub, repeated over the batch)."""
    if kind == "default":
        return None, None
    name, stub = ("embeds", _embeds(cfg)) if arch == VL \
        else ("frames", _frames(cfg))
    return (lambda b: {name: jnp.asarray(np.repeat(stub, b, 0))},
            lambda b: {name: torch.from_numpy(np.repeat(stub, b, 0))})


def _pair(arch, params, kind):
    rcfg, rp, tcfg, tp = params
    fr, ft = _embeds_fns(arch, tcfg, kind)
    kw = dict(arch=arch, kv="auto", max_batch=2, max_len=256, chunk=8)
    r = RLLM.from_spec(RSpec(**kw), cfg=rcfg, params=rp, embeds_fn=fr)
    t = TLLM.from_spec(TSpec(**kw), cfg=tcfg, params=tp, device="cpu",
                       embeds_fn=ft)
    assert t.engine.legacy and r.engine.legacy
    assert t.engine.kv.backend == "dense"
    return r, t


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in LENS]


@pytest.mark.parametrize("arch,kind", [(WH, "default"), (WH, "seeded"),
                                       (VL, "seeded"), (VL, "default")])
def test_streams_equal_reference(arch, kind, vl, wh):
    """Prompts of 20, 32 and 70 tokens on 2 slots (the third admitted when
    a slot frees): the greedy streams equal the reference's."""
    params = vl if arch == VL else wh
    r, t = _pair(arch, params, kind)
    prompts = _prompts(params[0].vocab_size)
    want = r.generate(prompts, max_new_tokens=NEW)
    assert t.generate(prompts, max_new_tokens=NEW) == want


def test_vlm_without_embeds_reads_clamped_rows(vl):
    """qwen2-vl served with no embeds_fn keeps 16 frontend positions: the
    first token of a 20-token prompt (bucket 32) is read at row
    20 - 1 + 16 = 35, past the bucket, so at the last row (31), and the
    cache length is 36, 16 rows past what was written.  The streams then
    differ from a serve with the stub."""
    rcfg, rp, tcfg, tp = vl
    t = _pair(VL, vl, "default")[1]
    eng = t.engine
    assert eng._front_len() == 16
    prompt = _prompts(rcfg.vocab_size)[0]
    toks = np.zeros((1, 32), np.int32)
    toks[0, :20] = prompt
    last, cache = eng._prefill_impl(tt(toks), 20)
    full = TM.forward(tp, tcfg, tokens=tt(toks)).logits
    torch.testing.assert_close(last, full[:, 31], rtol=1e-5, atol=1e-5)
    assert cache["length"].tolist() == [36]
    seeded = _pair(VL, vl, "seeded")[1]
    assert seeded.generate([prompt], NEW) != t.generate([prompt], NEW)
