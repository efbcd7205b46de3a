"""The port's dense per-slot KV cache, stateless forward and model drafts
on a mesh: 4 gloo ranks on the CPU against the reference's single-device
functions, reduced configs, f32.

One spawn of 4 ranks (``tests/_torch_dist_dense_ranks.py``, which imports
no JAX) runs every case; the module fixture computes the reference side
and the parametrised tests below assert one case each:

* the sharded ``forward`` on the dense cache, for phi3.5-moe, deepseek-v2
  (MLA), smollm (15/5 heads: not split over TP 2) and gemma (MQA), on the
  2x2 and 4x1 (data, model) meshes under mixserve fused and pure_tp: the
  unified steps on ``make_batched_cache``, a uniform prefill then two
  decodes on ``init_cache`` (its 0-d length stays 0-d), and the stateless
  forward, every row's logits against the reference's within rtol 1e-4
  plus 1e-4 of the largest logit (tests/test_torch_model.py's bound);
* each rank's dense buffers are the block of the reference's whole
  buffers of its batch rows and (GQA, heads split) its heads, within rtol
  1e-4 plus 1e-5 of their largest magnitude, and every rank holds the
  whole length vector;
* the collectives of one dense step are the paged rule
  (``test_torch_dist._expected_forward_census``) less the all_gather of
  the new KV rows a layer: each rank owns its rows' buffers;
* ``LLM.generate`` with ``kv="dense"`` gives the reference's dense
  single-device greedy streams and the paged mesh serve's;
* speculative decoding on the mesh with the self draft (on both backends)
  and with a foreign reduced draft on the reference's own draft weights:
  streams, acceptance counters and, on the dense backend, the lengths
  after every verify step (the rejected tail rolled back) equal the
  reference's; ``make_draft``'s own foreign draft holds the same weights
  on every rank and runs unsharded.
"""

import concurrent.futures
import dataclasses
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist_dense_ranks as D  # noqa: E402
import _torch_dist_helpers as H  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _torch_helpers import both_params  # noqa: E402
from test_torch_dist import _expected_forward_census  # noqa: E402
from repro.core.partitioner import make_plan as r_make_plan  # noqa: E402
from repro.core.resolve import SpeculationConfig as RSC  # noqa: E402
from repro.kernels.policy import KernelPolicy as RPolicy  # noqa: E402
from repro.models import model as RMOD  # noqa: E402
from repro.serving import kv_cache as RKV  # noqa: E402
from repro.serving.api import LLM as RLLM  # noqa: E402
from repro.serving.api import ServeSpec as RSpec  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402


def _np_groups(cache):
    return [jax.tree.map(np.asarray, g) for g in cache["groups"]]


def _reference_forwards(rcfg, rp):
    """The reference's single-device dense forwards of every case:
    (unified step logits, buffers, lengths), the same for the uniform
    prefill and decodes, and the stateless logits."""
    plan = r_make_plan("mixserve", None, kernels=RPolicy())
    vocab = rcfg.vocab_size
    cache = RKV.make_batched_cache(rcfg, D.B, D.MAX_LEN, jnp.float32)
    logits = []
    for (q_lens, _), toks in zip(H.FWD_STEPS, D.step_tokens(vocab)):
        o = RMOD.forward(rp, rcfg, plan, tokens=jnp.asarray(toks),
                         cache=cache,
                         q_lens=jnp.asarray(np.array(q_lens, np.int32)),
                         expert_stats=rcfg.is_moe)
        logits.append(np.asarray(o.logits))
        cache = o.cache
    out = {"unified": {"logits": logits, "bufs": _np_groups(cache),
                       "length": np.asarray(cache["length"])}}
    cache = RMOD.init_cache(rcfg, D.B, D.MAX_LEN, jnp.float32)
    logits = []
    for toks in D.uniform_tokens(vocab):
        o = RMOD.forward(rp, rcfg, plan, tokens=jnp.asarray(toks),
                         cache=cache)
        logits.append(np.asarray(o.logits))
        cache = o.cache
    out["uniform"] = {"logits": logits, "bufs": _np_groups(cache),
                      "length": np.asarray(cache["length"])}
    out["stateless"] = np.asarray(RMOD.forward(
        rp, rcfg, plan, tokens=jnp.asarray(D.stateless_tokens(vocab)))
        .logits)
    return out


def _ref_llm(rcfg, rp, arch, kv, speculation=None):
    sc = "off" if speculation is None else RSC(**speculation)
    return RLLM.from_spec(RSpec(arch=arch, kv=kv, speculation=sc,
                                **D.SERVE), cfg=rcfg, params=rp)


def _ref_lengths(eng):
    seen = []
    step = eng.unified_step

    def run(q):
        r = step(q)
        seen.append(np.asarray(eng.cache["length"]).copy())
        return r
    eng.unified_step = run
    return seen


@pytest.fixture(scope="module")
def dist(tmp_path_factory):
    """The ranks run in a thread beside the reference side: they need only
    the reference's params and its foreign drafts' weights, drawn when
    its LLM is built."""
    work = tmp_path_factory.mktemp("dist_dense")
    inputs, fwd, streams, spec = {"drafts": {}}, {}, {}, {}
    models = {arch: both_params(arch) for arch in D.ARCHS}
    for arch, (_, rp, _, _) in models.items():
        inputs[arch] = {"params": jax.tree.map(np.asarray, rp)}
    spec_llms = {}
    for case in D.SPEC_CASES:
        arch, _, kv, draft = case
        rcfg, rp, _, _ = models[arch]
        spec_llms[case] = _ref_llm(rcfg, rp, arch, kv, D.spec_kw(draft))
        if draft != "self":
            inputs["drafts"][case] = jax.tree.map(
                np.asarray, spec_llms[case].engine.draft.params)
    (work / "inputs.pkl").write_bytes(pickle.dumps(inputs))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, D.rank_main, 4, (str(work),),
                            workdir=work, device="cpu", threads=1,
                            timeout_s=600)
        for arch, (rcfg, rp, _, _) in models.items():
            fwd[arch] = _reference_forwards(rcfg, rp)
            llm = _ref_llm(rcfg, rp, arch, "dense")
            streams[arch] = llm.generate(H.prompts(rcfg.vocab_size),
                                         H.NEW_TOKENS)
        for case, llm in spec_llms.items():
            lengths = _ref_lengths(llm.engine)
            got = llm.generate(H.prompts(llm.cfg.vocab_size), D.SPEC_NEW)
            spec[case] = {"streams": got, "stats": llm.engine.spec_stats(),
                          "lengths": lengths}
        ranks = ranks.result()
    return {"ranks": ranks, "fwd": fwd, "streams": streams, "spec": spec}


def _close(got, want, rel, whole=None):
    """rtol 1e-4 plus ``rel`` of the largest magnitude of ``whole`` (by
    default ``want``)."""
    whole = want if whole is None else whole
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=rel * float(np.abs(whole).max()))


def _block(want, name, got_rank, tp):
    """The reference buffer's block this rank holds: its batch rows (axis
    1), and for GQA's k / v with the heads split its heads (axis -2)."""
    want = want[:, got_rank["rows"]]
    if name in ("k", "v") and got_rank["heads_sharded"]:
        n = want.shape[-2] // tp
        j = got_rank["tp_index"]
        want = want[..., j * n:(j + 1) * n, :]
    return want


@pytest.mark.parametrize("case", D.fwd_cases(), ids=H.case_id)
def test_dense_unified_steps_match_reference(dist, case):
    ref = dist["fwd"][case[0]]["unified"]
    ranks = [r["fwd"][case] for r in dist["ranks"]]
    for si, (q_lens, _) in enumerate(H.FWD_STEPS):
        want = ref["logits"][si]
        for got in ranks:
            tl = got["unified"]["logits"][si]
            assert tl.shape == want.shape
            for i, n in enumerate(q_lens):
                _close(tl[i, :n], want[i, :n], 1e-4, whole=want)
            np.testing.assert_array_equal(
                tl, ranks[0]["unified"]["logits"][si])
    for got in ranks:
        np.testing.assert_array_equal(got["unified"]["length"],
                                      ref["length"])


def test_dense_rank_rows_and_heads():
    """``init_cache(plan=)``: a rank's buffers hold its batch rows and,
    when the heads split, its heads; MLA's latent stays whole; a batch the
    batch axes do not divide stays whole on every rank."""
    import repro_torch.configs as TC
    from repro_torch.core.partitioner import make_plan
    from repro_torch.models.model import init_cache
    for arch, want in (("phi3.5-moe-42b", {"k": (2, 2, 16, 1, 32)}),
                       ("smollm-360m", {"k": (2, 2, 16, 5, 16)}),
                       ("deepseek-v2-236b", {"c": (1, 2, 16, 64),
                                             "kr": (1, 2, 16, 16)})):
        cfg = TC.get_reduced(arch)
        plan = make_plan("mixserve", Mesh(("data", "model"), (2, 2), 3))
        c = init_cache(cfg, 4, 16, torch.float32, "meta", plan)
        assert c["length"].shape == ()
        for name, shape in want.items():
            assert tuple(c["groups"][0][name].shape) == shape, (arch, name)
        one = init_cache(cfg, 1, 16, torch.float32, "meta", plan)
        assert next(iter(one["groups"][0].values())).shape[1] == 1
    assert plan.rows(4) == slice(2, 4) and plan.rows(3) == slice(0, 3)


@pytest.mark.parametrize("case", D.fwd_cases(), ids=H.case_id)
def test_dense_uniform_prefill_then_decode_match_reference(dist, case):
    ref = dist["fwd"][case[0]]["uniform"]
    for got in (r["fwd"][case]["uniform"] for r in dist["ranks"]):
        for tl, want in zip(got["logits"], ref["logits"]):
            _close(tl, want, 1e-4)
        assert got["length"].shape == () and int(got["length"]) == 10


@pytest.mark.parametrize("case", D.fwd_cases(), ids=H.case_id)
def test_stateless_forward_matches_reference(dist, case):
    want = dist["fwd"][case[0]]["stateless"]
    for r in dist["ranks"]:
        got, no_cache = r["fwd"][case]["stateless"]
        assert no_cache
        _close(got, want, 1e-4)


@pytest.mark.parametrize("mode", ["unified", "uniform"])
@pytest.mark.parametrize("case", D.fwd_cases(), ids=H.case_id)
def test_dense_buffers_are_the_reference_block(dist, case, mode):
    ref = dist["fwd"][case[0]][mode]
    tp = case[1][1]
    for r in dist["ranks"]:
        got = r["fwd"][case]
        for tg, rg in zip(got[mode]["bufs"], ref["bufs"]):
            assert set(tg) == set(rg)
            for name, want in rg.items():
                want = _block(want, name, got, tp)
                assert tg[name].shape == want.shape, name
                _close(tg[name], want, 1e-5)


@pytest.mark.parametrize("width", [8, 1])
@pytest.mark.parametrize("case", D.fwd_cases(), ids=H.case_id)
def test_dense_step_census_is_paged_less_kv_gathers(dist, case, width):
    want = _expected_forward_census(case, width, kv="dense")
    paged = _expected_forward_census(case, width)
    dp = frozenset(H._plan(Mesh(("data", "model"), case[1]), case[2],
                           case[3], "dropless").dp_axes)
    n_layers = H._cfg(case[0]).n_layers
    if case[1][0] > 1:
        assert paged[("all_gather", dp)] - want[("all_gather", dp)] \
            == n_layers
    for r in dist["ranks"]:
        got = {(kind, frozenset(axes)): n
               for (kind, axes), n in r["census"][case][width].items()}
        assert got == want


@pytest.mark.parametrize("case", D.stream_cases(), ids=H.case_id)
def test_dense_streams_equal_reference_and_paged(dist, case):
    want = dist["streams"][case[0]]
    for r in dist["ranks"]:
        got = r["streams"][case]
        assert got["dense"] == (want, "dense")
        assert got["paged"] == (want, "paged")


@pytest.mark.parametrize("case", D.SPEC_CASES, ids=H.case_id)
def test_speculated_streams_and_counters_equal_reference(dist, case):
    want = dist["spec"][case]
    assert want["stats"]["n_spec_drafted"] > 0
    for r in dist["ranks"]:
        got = r["spec"][case]
        assert got["streams"] == want["streams"]
        assert got["stats"] == want["stats"]
        assert got["draft_forwards"] > 0
        if case[3] == "self":
            assert got["self_params"]
            assert want["stats"]["spec_accept_rate"] == 1.0
            # the self draft's dense cache: the rank's rows of the batch
            assert got["draft_cache_rows"] == 4 // case[1][0]
        else:
            assert got["draft_cache_rows"] == 4      # unsharded draft


@pytest.mark.parametrize("case", [c for c in D.SPEC_CASES
                                  if c[2] == "dense"], ids=H.case_id)
def test_dense_rollback_lengths_equal_reference(dist, case):
    """The verify step subtracts the rejected tail from the whole length
    vector on every rank; after every step it equals the reference's."""
    want = dist["spec"][case]["lengths"]
    for r in dist["ranks"]:
        got = r["spec"][case]["lengths"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    if case[3] != "self":
        assert dist["spec"][case]["stats"]["n_spec_accepted"] \
            < dist["spec"][case]["stats"]["n_spec_drafted"]


@pytest.mark.parametrize("case", [c for c in D.SPEC_CASES
                                  if c[3] != "self"], ids=H.case_id)
def test_foreign_draft_weights_equal_on_every_rank(dist, case):
    """``make_draft`` draws a foreign draft's weights from a generator
    seeded 0 on each rank's device and runs it unsharded: every rank holds
    the same weights, the one-device draw's."""
    from repro_torch.models.model import init_params
    import repro_torch.configs as TC
    owns = [r["spec"][case]["own"] for r in dist["ranks"]]
    assert len({o[0] for o in owns}) == 1
    assert not any(o[1] for o in owns)
    dcfg = TC.get_reduced(case[3])
    assert {o[2] for o in owns} == {dcfg.name}
    gen = torch.Generator().manual_seed(0)
    one = init_params(gen, dcfg, torch.float32, "cpu")
    assert owns[0][0] == D.digest(one)


def test_plan_for_batch_replicates_a_batch_the_axes_do_not_divide():
    from repro_torch.core.partitioner import make_plan
    from repro_torch.launch.mesh import Mesh
    plan = make_plan("mixserve", Mesh(("data", "model"), (2, 2), 1))
    assert plan.for_batch(4) is plan and plan.batch_sharded(4)
    one = plan.for_batch(1)
    assert one.dp == 1 and one.tp == 2 and not one.batch_sharded(1)
    assert one.rules["batch"] is None
    assert dataclasses.replace(one, rules=plan.rules,
                               dp_axes=plan.dp_axes) == plan
