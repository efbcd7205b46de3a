"""The port's recurrent and frontend families on a mesh: 4 gloo ranks on
the CPU against the reference's layers, forward and legacy ``Engine`` on
one device, reduced configs, f32.

The reference's zero-initialised recurrent leaves (``mu``, ``bonus``,
the conv taps, ...; ``tests/_recurrent_leaves.py``) and norm weights are
drawn from numpy seeds on both sides, so that a swapped slice does not
hide behind a zero.  One spawn of 4 ranks
(``tests/_torch_dist_legacy_ranks.py``, which imports no JAX) runs every
case:

* RWKV6's time- and channel-mix and the RG-LRU block on the 2x2 (with the
  8-row input cut along seq over TP 2, and whole) and 4x1 meshes: each
  rank's outputs and carried states (the wkv memory of its heads, the
  LRU state and conv tail of its channels, the token-shift rows) are its
  block of the reference's, within rtol 1e-5 plus 1e-5 of the largest
  magnitude;
* the stateless forward of rwkv6, recurrentgemma, whisper (default
  frames) and qwen2-vl (a seeded patch stub): logits within rtol 1e-4
  plus 1e-4 of the largest logit (tests/test_torch_model.py's bound) of
  the port's unsharded forward and of the reference's; whisper's against
  the reference within 1e-3 of the largest logit, the bound
  tests/test_torch_frontend.py states for it (here, on the default
  frames, the reference's own f32 logits lie 5.9e-4 of the largest logit
  from an f64 run of the port, the port's unsharded f32 logits 2.4e-4
  from the reference's);
* greedy ``LLM.generate`` on the legacy blocking path for prompts of 20,
  32 and 70 tokens, token for token the reference's legacy engine's, so
  its faults (the bucket padding through the state, the ring's lost keys,
  qwen2-vl's clamped row without a stub) are reproduced on a mesh too;
  the batch-1 prefill's cache lands on the rank that holds the slot;
* each rank's tree of the four families (whisper's encoder included) is
  the keep-hook's block of the whole one (no ranks needed).
"""

import concurrent.futures
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist_legacy_ranks as G  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as RC  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from _recurrent_leaves import draw_recurrent_leaves  # noqa: E402
from repro.models import model as RMOD  # noqa: E402
from repro.models import ssm as RS  # noqa: E402
from repro.serving.api import LLM as RLLM  # noqa: E402
from repro.serving.api import ServeSpec as RSpec  # noqa: E402
from repro_torch.bridge import from_reference  # noqa: E402
from repro_torch.core.partitioner import make_plan  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.models.model import model_spec  # noqa: E402
from repro_torch.models.param import P  # noqa: E402

# the norm weights the reference initialises at zero, by leaf name
NORMS = ("norm", "mlp_norm", "final_norm")


def draw_norms(rp, seed):
    """Every ``NORMS`` leaf drawn from N(0, 0.25) (numpy ``seed``)."""
    rng = np.random.default_rng(seed)

    def one(path, leaf):
        if getattr(path[-1], "key", None) in NORMS:
            return jnp.asarray(0.5 * rng.standard_normal(leaf.shape),
                               leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(one, rp)


def reference_params(arch):
    rcfg = RC.get_reduced(arch)
    rp = RMOD.init_params(jax.random.PRNGKey(0), rcfg, jnp.float32)
    return rcfg, draw_norms(draw_recurrent_leaves(rp, 0), 1)


def _layer(rp, kind):
    """Layer 0's params of the reference's stacked tree."""
    g = rp["groups"][0]
    sub = g["tm"] if kind == "tm" else g["cm"] if kind == "cm" \
        else g["l0"]["rglru"]
    return jax.tree.map(lambda a: a[0], sub)


def _reference_layers(models):
    out = {}
    for kind in ("rwkv", "rglru"):
        arch = "rwkv6-1.6b" if kind == "rwkv" else "recurrentgemma-9b"
        rcfg, rp = models[arch]
        inp = G.layer_inputs(TC.get_reduced(arch), kind)
        x = jnp.asarray(inp["x"])
        if kind == "rwkv":
            t_out, (state, x_tm) = RS.rwkv6_time_mix(
                _layer(rp, "tm"), x, rcfg, state=jnp.asarray(inp["state"]),
                x_prev=jnp.asarray(inp["x_tm"]))
            c_out, x_cm = RS.rwkv6_channel_mix(
                _layer(rp, "cm"), x, rcfg, x_prev=jnp.asarray(inp["x_cm"]))
            res = {"t_out": t_out, "c_out": c_out, "state": state,
                   "x_tm": x_tm, "x_cm": x_cm}
        else:
            o, (lru, conv) = RS.rglru_block(
                _layer(rp, "rglru"), x, rcfg, state=jnp.asarray(inp["lru"]),
                conv_state=jnp.asarray(inp["conv"]))
            res = {"out": o, "lru": lru, "conv": conv}
        out[kind] = ({k: np.asarray(v) for k, v in res.items()}, inp)
    return out


def _ref_fwd(rcfg, rp, tcfg):
    kw = {k: jnp.asarray(v) for k, v in G.fwd_kwargs(tcfg, G.FWD_SHAPE[0])
          .items()}
    return np.asarray(RMOD.forward(
        rp, rcfg, tokens=jnp.asarray(G.fwd_tokens(rcfg.vocab_size)),
        **kw).logits)


def _port_fwd(rp, tcfg):
    """The port's unsharded stateless forward on the same inputs."""
    from repro_torch.models import model as TMOD
    params = from_reference(jax.tree.map(np.asarray, rp), tcfg)
    kw = {k: torch.from_numpy(v) for k, v in G.fwd_kwargs(
        tcfg, G.FWD_SHAPE[0]).items()}
    return TMOD.forward(params, tcfg, tokens=torch.from_numpy(
        G.fwd_tokens(tcfg.vocab_size)), **kw).logits.numpy()


# of the largest |logit|, the sharded forward against the reference's:
# whisper's is the bound of tests/test_torch_frontend.py (see above)
REF_LOGITS = {"whisper-tiny": 1e-3}


def _ref_streams(rcfg, rp, arch, kind):
    tcfg = TC.get_reduced(arch)
    efn = None
    if kind == "seeded":
        stub = G.embeds_stub(tcfg)
        efn = lambda b: {"embeds": jnp.asarray(  # noqa: E731
            np.repeat(stub, b, 0))}
    llm = RLLM.from_spec(RSpec(arch=arch, **G.SERVE), cfg=rcfg, params=rp,
                         embeds_fn=efn)
    assert llm.engine.legacy
    return llm.generate(G.prompts(rcfg.vocab_size), G.NEW)


@pytest.fixture(scope="module")
def models():
    return {arch: reference_params(arch) for arch in G.FAMILIES}


@pytest.fixture(scope="module")
def dist(tmp_path_factory, models):
    """The ranks run in a thread beside the reference side."""
    work = tmp_path_factory.mktemp("dist_legacy")
    inputs = {arch: {"params": jax.tree.map(np.asarray, rp)}
              for arch, (_, rp) in models.items()}
    inputs["layers"] = {kind: G.layer_inputs(G._cfg(kind), kind)
                        for kind in ("rwkv", "rglru")}
    (work / "inputs.pkl").write_bytes(pickle.dumps(inputs))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, G.rank_main, 4, (str(work),),
                            workdir=work, device="cpu", threads=1,
                            timeout_s=600)
        layers = _reference_layers(models)
        fwd = {arch: (_ref_fwd(*models[arch], TC.get_reduced(arch)),
                      _port_fwd(models[arch][1], TC.get_reduced(arch)))
               for arch in G.FAMILIES}
        streams = {(arch, kind): _ref_streams(*models[arch], arch, kind)
                   for arch, kind in G.STREAM_KINDS}
        ranks = ranks.result()
    return {"ranks": ranks, "layers": layers, "fwd": fwd,
            "streams": streams}


def _close(got, want, rtol, rel):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rel * max(1.0, float(np.abs(want)
                                                         .max())))


def _rank_block(want, name, got):
    """The block of a reference output or state that a rank holds: its
    batch rows; its seq block when the input was cut along seq; its heads
    (the wkv memory) or channels (the LRU state and conv tail)."""
    want = want[got["rows"]]
    if got["seq"] and name in ("t_out", "c_out", "out"):
        n = want.shape[1] // got["tp"]
        want = want[:, got["tp_index"] * n:(got["tp_index"] + 1) * n]
    axis = {"state": 1, "lru": 1, "conv": 2}.get(name)
    if axis is not None and got["tp"] > 1 and (
            name != "state" or got["heads_sharded"]):
        n = want.shape[axis] // got["tp"]
        j = got["tp_index"]
        want = np.take(want, range(j * n, (j + 1) * n), axis=axis)
    return want


@pytest.mark.parametrize("case", G.LAYER_CASES, ids=lambda c: "-".join(
    f"{v[0]}x{v[1]}" if isinstance(v, tuple) else v for v in c))
def test_recurrent_layers_are_the_reference_block(dist, case):
    kind, m, sp = case
    want, _ = dist["layers"][kind]
    for r in dist["ranks"]:
        got = r["layers"][case]
        assert got["seq"] == (m[1] > 1 and sp == "sp")
        if kind == "rwkv":
            assert got["heads_sharded"] == (m[1] > 1)
        for name, w in want.items():
            blk = _rank_block(w, name, got)
            assert got[name].shape == blk.shape, name
            _close(got[name], blk, 1e-5, 1e-5)
        # RWKV6's ln_x over all heads: one TP psum of the sums of squares
        if kind == "rwkv" and m[1] > 1:
            assert got["census"][("all_reduce", ("model",))] >= 1


@pytest.mark.parametrize("case", G.fwd_cases(), ids=lambda c: "-".join(
    f"{v[0]}x{v[1]}" if isinstance(v, tuple) else v for v in c))
def test_stateless_forward_matches_reference(dist, case):
    want, unsharded = dist["fwd"][case[0]]
    for r in dist["ranks"]:
        got = r["fwd"][case]
        assert got.shape == want.shape
        _close(got, unsharded, 1e-4, 1e-4)
        _close(got, want, 1e-4, REF_LOGITS.get(case[0], 1e-4))
        np.testing.assert_array_equal(got, dist["ranks"][0]["fwd"][case])


@pytest.mark.parametrize("case", G.stream_cases(), ids=lambda c: "-".join(
    f"{v[0]}x{v[1]}" if isinstance(v, tuple) else str(v) for v in c))
def test_legacy_streams_equal_reference(dist, case):
    arch, kind, m = case
    want = dist["streams"][(arch, kind)]
    for r in dist["ranks"]:
        got = r["streams"][case]
        assert got["legacy"] and got["backend"] == "dense"
        assert got["n_prefill"] == len(G.LENS)
        assert got["streams"] == want


@pytest.mark.parametrize("m", G.MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_blocking_prefill_lands_on_the_slots_rank(dist, m):
    """recurrentgemma: three blocking prefills fill slots 0-2; the
    70-token prompt (bucket 128, window 64) leaves positions 64-127 in
    slot 2's ring, on the rank whose rows hold slot 2; every rank holds
    every slot's length (the frontend-free prompt length)."""
    case = ("recurrentgemma-9b", None, m)
    seen = {}
    for r in dist["ranks"]:
        got = r["streams"][case]
        assert got["length"] == [20, 32, 70, 0]
        seen.update(got["kpos"])
    assert sorted(seen) == [0, 1, 2, 3]
    assert seen[2] == list(range(64, 128))
    assert seen[3] == [-1] * 64               # the idle slot's empty ring


def _tree_leaves(tree, spec, path=()):
    if isinstance(spec, P):
        return [(path, tree, spec)]
    keys = spec.keys() if isinstance(spec, dict) else range(len(spec))
    return [x for k in keys
            for x in _tree_leaves(tree[k], spec[k], path + (k,))]


@pytest.mark.parametrize("m", G.MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", G.FAMILIES)
def test_rank_tree_is_the_keep_hook_block(models, arch, m):
    """Every leaf of a rank's ``from_reference(plan=)`` tree is the
    keep-hook's block of the whole tree: the vocab and ``ffn`` (RG-LRU
    width, channel-mix, MLPs, whisper's encoder MLP) cut to 1/tp, the
    heads (RWKV6's wkv heads, whisper's decoder and encoder heads,
    qwen2-vl's) where they split, every other axis whole."""
    cfg = TC.get_reduced(arch)
    params_np = jax.tree.map(np.asarray, models[arch][1])
    whole = from_reference(params_np, cfg)
    spec = model_spec(cfg)
    for rank in range(4):
        plan = make_plan("mixserve", Mesh(("data", "model"), m, rank))
        keep = plan.keep_hook(cfg)
        tp = plan.tp
        heads = plan.heads_sharded(cfg)
        assert heads == (tp > 1 and arch != "recurrentgemma-9b")
        mine = from_reference(params_np, cfg, plan=plan)
        for (path, leaf, p), (_, w, _) in zip(_tree_leaves(mine, spec),
                                              _tree_leaves(whole, spec)):
            sl = keep(path, p) or (slice(None),) * len(p.shape)
            assert torch.equal(leaf, w[sl]), path
            shape = list(p.shape)
            for i, ax in enumerate(p.axes):
                if ax in ("vocab", "ffn") or (
                        ax in ("heads", "kv_heads") and heads):
                    shape[i] //= tp
            assert list(leaf.shape) == shape, path


def test_heads_rule_reads_rwkv_and_encoder_heads():
    """RWKV6 has no attention heads (``n_heads`` 0): its rule reads the
    wkv heads, d_model / 64 (32 at full width), and follows the
    divisibility fallback; whisper-tiny's 6 heads (decoder and encoder)
    split over TP 2, not over TP 4."""
    import dataclasses
    rw, wh = TC.get("rwkv6-1.6b"), TC.get("whisper-tiny")
    for tp, want_rw, want_wh in ((2, True, True), (4, True, False),
                                 (1, False, False)):
        plan = make_plan("mixserve", Mesh(("data", "model"), (4 // tp, tp)))
        assert plan.heads_sharded(rw) == want_rw
        assert plan.heads_sharded(wh) == want_wh
    odd = dataclasses.replace(rw, d_model=192)          # 3 wkv heads
    assert not make_plan("mixserve", Mesh(("data", "model"),
                                          (2, 2))).heads_sharded(odd)
    enc = dataclasses.replace(wh, encoder=dataclasses.replace(
        wh.encoder, n_heads=3))
    assert not make_plan("mixserve", Mesh(("data", "model"),
                                          (2, 2))).heads_sharded(enc)
