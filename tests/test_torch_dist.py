"""The port's multi-device serving on 4 gloo ranks (CPU) against the
reference.

One spawn of 4 ranks (``tests/_torch_dist_helpers.py``, which imports no
JAX) runs every case; the module fixture gathers what each rank returned
and the parametrised tests below assert one case each:

* ``moe_block`` under mixserve (fused / sync / unfused), dp_ep and pure_tp,
  dropless and capacity (capacity factor 8: nothing drops), on meshes 2x2
  and 4x1 (data x model), equals the reference's single-device
  ``moe_local`` on the same numpy inputs within 1e-4 (float32; summation
  order differs), and is the same on every rank;
* the micro-chunked, count-bounded exchange equals the monolithic one bit
  for bit, with a cap that holds and with one that every chunk overflows
  (both run the plain grouped GEMM one row per product,
  ``H.rowwise_grouped_gemm``, so that the CPU BLAS's one-row path does not
  enter the comparison);
* the collectives one block issues, by kind and axes, are the port's
  ``cost_model.comm_census`` for the plan (the reference's
  ``analysis/trace_contract.py`` check), plus the batch all-gather of the
  block's boundary that the reference's ``shard_map`` does outside its
  body;
* the forward's per-rank MoE entry (``moe_rank``) on a rank's seq block
  gives the same rows of ``moe_block``'s output bit for bit;
* the whole sharded ``forward`` (mixed prefill/decode steps on the paged
  cache, every row's logits and ``last_only``; heads, vocab, dense FFN
  and, with ``sp``, the residual stream's seq cut over TP; the batch over
  the batch axes) under mixserve fused, dp_ep and pure_tp with ``sp`` on
  and off, for phi3.5-moe, deepseek-v2 (MLA, a dense and an MoE layer)
  and smollm (heads that do not split: replicated attention), and under
  mixserve fused on the 2x2 mesh with ``sp`` for gemma (MQA: its one KV
  head does not split, so its attention stays whole) and minitron (GELU
  MLP without a gate, heads split), equals the
  reference's single-device ``forward`` within rtol 1e-4 plus 1e-4 of the
  largest logit (the bound of tests/test_torch_model.py), with each
  rank's pool the reference pool's slice of its heads and equal across
  batch ranks bit for bit;
* the collectives of one forward hold the rule stated in
  ``_expected_forward_census`` against ``comm_census``'s ``attn`` entry;
* ``LLM.generate`` on 4 ranks gives the reference's single-device greedy
  streams on every rank, with a prefix hit (also for smollm, with the
  residual stream whole, and with a prefix written on one batch rank and
  hit on the other), and with the n-gram speculative draft (its
  acceptance counters too).

Checks that need no ranks: the plans' axis rules and specs equal the
reference's with ``sp`` on and off, a rank's index over an axis tuple is
its place in the sorted group (what ``torch.distributed.new_group`` gives
it), and each rank's weights from ``bridge.from_reference(plan=)`` are the
keep-hook's block of the whole tree.
"""

import dataclasses
import itertools
import pickle
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist_helpers as H  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _torch_helpers import both_params, paged_tables  # noqa: E402
from repro.models import model as RMOD  # noqa: E402
from repro.models import moe as RM  # noqa: E402
from repro.core.partitioner import make_plan as r_make_plan  # noqa: E402
from repro.models.param import init_tree as r_init_tree  # noqa: E402
from repro.serving.api import LLM as RLLM  # noqa: E402
from repro.serving.api import ServeSpec as RSpec  # noqa: E402
from repro.core.resolve import SpeculationConfig as RSC  # noqa: E402
from repro_torch.core.cost_model import Workload  # noqa: E402
from repro_torch.core.cost_model import comm_census  # noqa: E402
from repro_torch.bridge import from_reference  # noqa: E402
from repro_torch.core.partitioner import make_plan  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models.model import init_params, layer_plan  # noqa: E402
from repro_torch.models.model import model_spec  # noqa: E402
from repro_torch.models.param import P  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402


def _reference_forward(rcfg, rp, fin):
    """The reference's single-device forward over FWD_STEPS: per step,
    (every row's logits, last_only logits, aux, expert counts), then the
    final pools and lengths."""
    from repro.core.partitioner import make_plan as rmp
    from repro.kernels.policy import KernelPolicy as RPolicy
    plan = rmp("mixserve", None, kernels=RPolicy())
    cache = RMOD.init_paged_cache(rcfg, H.FWD_B, H.FWD_MAX_LEN,
                                  page_size=H.FWD_PAGE,
                                  pool_pages=fin["n_pages"],
                                  dtype=np.float32)
    cache = {**cache, "block_tables": jnp.asarray(fin["bt"])}
    steps = []
    for (q_lens, _), toks in zip(H.FWD_STEPS, fin["tokens"]):
        rec = {}
        for last_only in (False, True):
            o = RMOD.forward(rp, rcfg, plan, tokens=jnp.asarray(toks),
                             cache=cache, q_lens=jnp.asarray(
                                 np.array(q_lens, np.int32)),
                             last_only=last_only, expert_stats=rcfg.is_moe)
            rec[last_only] = (np.asarray(o.logits), float(o.aux),
                              None if o.expert_counts is None
                              else np.asarray(o.expert_counts))
            if not last_only:
                nxt = o.cache
        cache = nxt
        steps.append(rec)
    return {"steps": steps, "length": np.asarray(cache["length"]),
            "pools": [jax.tree.map(np.asarray, g) for g in cache["groups"]]}


def _stream_key(case):
    return case[0], case[4], case[5] if len(case) > 5 else None


@pytest.fixture(scope="module")
def dist(tmp_path_factory):
    work = tmp_path_factory.mktemp("dist")
    inputs, ref_moe, ref_streams, ref_hits = {"fwd": {}}, {}, {}, {}
    ref_fwd = {}
    for arch in H.FWD_ARCHS + H.FWD_DENSE_ARCHS:
        rcfg, rp, _, _ = both_params(arch)
        inputs[arch] = {"params": jax.tree.map(np.asarray, rp)}
        nb = H.FWD_MAX_LEN // H.FWD_PAGE
        bt, n_pages = paged_tables(H.FWD_B, nb, [nb] * H.FWD_B, seed=5)
        rng = np.random.default_rng(6)
        fin = {"bt": bt, "n_pages": n_pages, "tokens": [
            rng.integers(0, rcfg.vocab_size, (H.FWD_B, w)).astype(np.int32)
            for _, w in H.FWD_STEPS]}
        inputs["fwd"][arch] = fin
        ref_fwd[arch] = _reference_forward(rcfg, rp, fin)
    for arch in H.ARCHS:
        rcfg, rp, _, _ = both_params(arch)
        rcfg = dataclasses.replace(rcfg, capacity_factor=H.CF)
        p = r_init_tree(jax.random.PRNGKey(1), RM.moe_spec(rcfg),
                        jnp.float32)
        x = np.random.default_rng(2).standard_normal(
            H.X_SHAPE + (rcfg.d_model,)).astype(np.float32)
        inputs[arch].update({"moe": jax.tree.map(np.asarray, p), "x": x})
        for d in H.DISPATCH:
            ref_moe[(arch, d)] = np.asarray(RM.moe_local(
                p, jnp.asarray(x), rcfg, cf=H.CF, dispatch=d)[0])
    for key in sorted({_stream_key(c) for c in H.stream_cases()},
                      key=str):
        arch, d, kind = key
        rcfg, rp, _, _ = both_params(arch)
        rcfg = dataclasses.replace(rcfg, capacity_factor=H.CF)
        llm = RLLM.from_spec(RSpec(arch=arch, dispatch=d, **H.SERVE),
                             cfg=rcfg, params=rp)
        if kind == "cross_dp":
            ref_streams[key] = H.drain(llm, *H.cross_dp_prompts(
                rcfg.vocab_size))
        else:
            ref_streams[key] = llm.generate(H.prompts(rcfg.vocab_size),
                                            H.NEW_TOKENS)
        ref_hits[key] = llm.engine.kv.stats.n_prefix_hits
    arch, _, _, _, d, _ = H.SPEC_CASE
    rcfg, rp, _, _ = both_params(arch)
    llm = RLLM.from_spec(RSpec(arch=arch, dispatch=d,
                               speculation=RSC(**H.SPEC), **H.SERVE),
                         cfg=dataclasses.replace(rcfg, capacity_factor=H.CF),
                         params=rp)
    ref_spec = (llm.generate(H.prompts(rcfg.vocab_size), H.SPEC_NEW_TOKENS),
                llm.engine.spec_stats())
    (work / "inputs.pkl").write_bytes(pickle.dumps(inputs))
    ranks = run_ranks(H.rank_main, 4, (str(work),), workdir=work,
                      device="cpu", threads=1, timeout_s=600)
    return {"ranks": ranks, "moe": ref_moe, "streams": ref_streams,
            "hits": ref_hits, "fwd": ref_fwd, "spec": ref_spec}


@pytest.mark.parametrize("case", H.moe_cases(), ids=H.case_id)
def test_moe_block_matches_reference_moe_local(dist, case):
    arch, _, _, _, dispatch = case
    outs = [r["moe"][case] for r in dist["ranks"]]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])      # replicated output
    np.testing.assert_allclose(outs[0], dist["moe"][(arch, dispatch)],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", H.overlap_cases(), ids=H.case_id)
def test_micro_chunked_exchange_equals_monolithic_bitwise(dist, case):
    for r in dist["ranks"]:
        mono, chunked, counts = r["overlap"][case]
        np.testing.assert_array_equal(chunked, mono)
        assert counts["chunks"] == 2
        assert counts.get("overflow", 0) == (2 if case[-1] == "overflow"
                                             else 0)


def _expected_census(case):
    """(kind, axes) -> calls the cost model prices for one block, with the
    conditional worst-case fallback added when every chunk overflows, and
    the boundary's batch all-gather."""
    arch, m, lay, algo, kind = case
    cfg = H._cfg(arch)
    plan = H._plan(Mesh(("data", "model"), m), lay, algo, "dropless")
    if kind is not None:
        plan = dataclasses.replace(plan, ep_overlap=H.overlap_for(
            H.tokens_local(plan, *H.X_SHAPE), cfg.top_k, kind))
    census = comm_census(cfg, plan.strategy(),
                         Workload(batch=H.X_SHAPE[0], seq_len=H.X_SHAPE[1]),
                         ep_overlap=plan.ep_overlap,
                         tokens_local=H.tokens_local(plan, *H.X_SHAPE))
    groups = {"tp": frozenset(plan.tp_axes), "ep": frozenset(plan.ep_axes),
              "guard": frozenset(plan.tp_axes) | frozenset(plan.ep_axes),
              "mesh": frozenset(plan.mesh.axis_names)}
    want = Counter()
    for e in census.entries:
        if e.traceable and (not e.conditional or kind == "overflow"):
            want[(e.kind, groups[e.axis])] += e.count
    want[("all_gather", frozenset(plan.dp_axes))] += 1       # boundary
    return dict(want)


@pytest.mark.parametrize("case", H.census_cases(), ids=H.case_id)
def test_collective_census_matches_cost_model(dist, case):
    want = _expected_census(case)
    for r in dist["ranks"]:
        got = {(kind, frozenset(axes)): n
               for (kind, axes), n in r["census"][case].items()}
        assert got == want


@pytest.mark.parametrize("case", H.stream_cases(), ids=H.case_id)
def test_generate_streams_equal_reference(dist, case):
    want = dist["streams"][_stream_key(case)]
    hits = dist["hits"][_stream_key(case)]
    assert hits >= 1
    for r in dist["ranks"]:
        assert r["streams"][case] == want
        assert r["hits"][case] == hits


def test_speculated_streams_equal_reference(dist):
    """The n-gram draft on the 2x2 mixserve mesh (paged): every rank's
    streams and acceptance counters equal the reference's single-device
    speculated serve (whose streams are its non-speculative ones)."""
    want, want_stats = dist["spec"]
    assert want_stats["n_spec_drafted"] > 0
    for r in dist["ranks"]:
        streams, stats, draft = r["spec"]
        assert draft == "NGramDraft"
        assert streams == want
        assert stats == want_stats


@pytest.mark.parametrize("case", H.moe_cases(), ids=H.case_id)
def test_moe_rank_seq_block_equals_moe_block_bitwise(dist, case):
    seq = {r["moe_rank"][case][0] for r in dist["ranks"]}
    assert seq == {case[1][1] > 1}          # cut along seq where TP > 1
    assert all(r["moe_rank"][case][1] for r in dist["ranks"])


def _fwd_tol(ref):
    return dict(rtol=1e-4, atol=1e-4 * float(np.abs(ref).max()))


@pytest.mark.parametrize("case", H.fwd_cases(), ids=H.case_id)
def test_forward_matches_reference(dist, case):
    ref = dist["fwd"][case[0]]
    ranks = [r["fwd"][case] for r in dist["ranks"]]
    for si, ((q_lens, _), want) in enumerate(zip(H.FWD_STEPS,
                                                 ref["steps"])):
        q = np.array(q_lens)
        rl, rl_last = want[False][0], want[True][0]
        for got in ranks:
            step = got["steps"][si]
            tl, tl_last = step[False][0], step[True][0]
            assert tl.shape == rl.shape and tl_last.shape == rl_last.shape
            for i in range(H.FWD_B):
                np.testing.assert_allclose(tl[i, :q[i]], rl[i, :q[i]],
                                           **_fwd_tol(rl))
            np.testing.assert_allclose(tl_last[q > 0], rl_last[q > 0],
                                       **_fwd_tol(rl_last))
            for lo in (False, True):
                # aux is the mean of each rank's router loss on its rows
                # (the reference's shard_map body pmeans it the same way),
                # not the single-device value: held equal across ranks
                assert step[lo][1] == ranks[0]["steps"][si][lo][1]
                assert np.isfinite(step[lo][1])
                if want[lo][2] is not None:
                    np.testing.assert_array_equal(step[lo][2], want[lo][2])
                # every rank returns the same, whole logits
                np.testing.assert_array_equal(
                    step[lo][0], ranks[0]["steps"][si][lo][0])
    for got in ranks:
        np.testing.assert_array_equal(got["length"], ref["length"])


@pytest.mark.parametrize("case", H.fwd_cases(), ids=H.case_id)
def test_forward_pools_are_the_reference_pools_heads(dist, case):
    """Each rank holds its heads of every page (GQA with heads split over
    TP; MLA's latent pools whole), equal to the reference's within the
    bound of tests/test_torch_model.py, and equal bit for bit on the
    ranks of one TP index (every batch rank's rows were written)."""
    ref = dist["fwd"][case[0]]
    ranks = [r["fwd"][case] for r in dist["ranks"]]
    tp = case[1][1]
    for got in ranks:
        for tg, rg in zip(got["pools"], ref["pools"]):
            for k, want in rg.items():
                if k in ("k", "v") and got["heads_sharded"]:
                    n = want.shape[-2] // tp
                    j = got["tp_index"]
                    want = want[..., j * n:(j + 1) * n, :]
                assert tg[k].shape == want.shape
                np.testing.assert_allclose(
                    tg[k], want, rtol=1e-4,
                    atol=1e-5 * float(np.abs(want).max()))
    for a in ranks:
        for b in ranks:
            if a["tp_index"] == b["tp_index"]:
                for ga, gb in zip(a["pools"], b["pools"]):
                    for k in ga:
                        np.testing.assert_array_equal(ga[k], gb[k])


def _expected_forward_census(case, width, kv="paged"):
    """(kind, axes) -> calls in one forward of ``width`` rows on a ``kv``
    cache ("paged" or "dense").

    Rule held instead of the census's 2 TP all-reduces a layer: one TP
    reduction after ``wo`` (heads split) and one after a dense ``w_out``,
    an MoE layer's second being its MoE block's own entries.

    Each reduction is a psum, or with the residual stream cut a
    psum_scatter whose all_gather is the next sub-layer's entry; once a
    forward, an embedding psum and the logits all_gathers (vocab over TP,
    batch over the batch axes); on the paged cache one all_gather of the
    new KV rows a layer over the batch axes (every rank holds every page;
    a dense buffer holds only the rank's rows, so the dense cache has
    none)."""
    arch, m, lay, algo, sp = case
    cfg = H._cfg(arch)
    plan = H._plan(Mesh(("data", "model"), m), lay, algo, "dropless",
                   sp=sp == "sp")
    census = comm_census(cfg, plan.strategy(),
                         Workload(batch=H.FWD_B, seq_len=width),
                         tokens_local=H.tokens_local(plan, H.FWD_B, width))
    tp_g, dp_g = frozenset(plan.tp_axes), frozenset(plan.dp_axes)
    groups = {"tp": tp_g, "ep": frozenset(plan.ep_axes),
              "guard": tp_g | frozenset(plan.ep_axes),
              "mesh": frozenset(plan.mesh.axis_names)}
    n_layers = cfg.n_layers
    n_moe = sum(g.count for g in layer_plan(cfg) if g.kind == "moe")
    want = Counter()
    attn = 0
    for e in census.entries:
        if e.phase == "attn":
            assert (e.kind, e.axis, e.count, e.traceable) \
                == ("all_reduce", "tp", 2, False)
            attn += e.count * n_layers
        elif e.traceable and not e.conditional:
            want[(e.kind, groups[e.axis])] += e.count * n_moe
    if plan.tp > 1:
        red = attn - n_moe - (0 if plan.heads_sharded(cfg) else n_layers)
        if plan.seq_sharded(width):
            want[("reduce_scatter", tp_g)] += red
            want[("all_gather", tp_g)] += 2 * n_layers + 1
        else:
            want[("all_reduce", tp_g)] += red
        want[("all_reduce", tp_g)] += 1             # embedding
        want[("all_gather", tp_g)] += 1             # logits, vocab
    else:
        assert attn == 0
    if plan.dp > 1:                     # KV rows (paged) + logits
        want[("all_gather", dp_g)] += (n_layers if kv == "paged" else 0) + 1
    return dict(want)


@pytest.mark.parametrize("width", [8, 1])
@pytest.mark.parametrize("case", H.fwd_cases(), ids=H.case_id)
def test_forward_census_matches_cost_model(dist, case, width):
    want = _expected_forward_census(case, width)
    for r in dist["ranks"]:
        got = {(kind, frozenset(axes)): n
               for (kind, axes), n in r["fwd_census"][case][width].items()}
        assert got == want


@pytest.mark.parametrize("axes", [("model",), ("data",)], ids=str)
@pytest.mark.parametrize("name", H.COLL_CASES)
def test_collectives_along_seq_and_vocab(dist, name, axes):
    for r in dist["ranks"]:
        equal, contiguous, counts = r["coll"][(name, axes)]
        assert equal and contiguous
        kind = {"all_gather_seq": "all_gather",
                "all_gather_vocab": "all_gather",
                "psum_scatter_seq": "reduce_scatter",
                "psum": "all_reduce"}[name]
        assert counts == {(kind, axes): 1}


class _FakeMesh:
    """The reference plan reads only ``shape`` and ``axis_names``."""

    def __init__(self, names, sizes):
        self.axis_names, self.shape = names, dict(zip(names, sizes))


def _leaves(tree):
    if isinstance(tree, P):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [q for v in items for q in _leaves(v)]


MESH_SHAPES = [(("data", "model"), (2, 2)), (("data", "model"), (4, 1)),
               (("pod", "data", "model"), (2, 2, 2))]


LAYOUTS = ["mixserve", "pure_tp", "pure_ep", "dp_ep"]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("names,sizes", MESH_SHAPES)
def test_plan_specs_match_reference(layout, names, sizes):
    _plans_match(layout, names, sizes, sp=True)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("names,sizes", MESH_SHAPES)
def test_plan_specs_match_reference_with_sp_off(layout, names, sizes):
    _plans_match(layout, names, sizes, sp=False)


def _plans_match(layout, names, sizes, sp):
    """make_plan's rules and specs equal the reference's for ``sp``."""
    import repro_torch.configs as TC
    ref = r_make_plan(layout, _FakeMesh(names, sizes), "sync", sp=sp)
    got = make_plan(layout, Mesh(names, sizes), "sync", sp=sp)
    assert (got.tp_axes, got.ep_axes, got.dp_axes, got.comm_algo) \
        == (ref.tp_axes, ref.ep_axes, ref.dp_axes, ref.comm_algo)
    assert got.rules == ref.rules
    leaves = [q for a in H.FWD_ARCHS for q in _leaves(model_spec(
        TC.get_reduced(a)))]
    leaves.append(P((4, 8, 256), ("batch", "seq", "embed")))
    leaves.append(P((4, 8, 256), ("batch", "seq_resid", "embed")))
    for q in leaves:
        assert got.spec(q.axes) == tuple(ref.spec(q.axes))
        assert got.spec_for_shape(q.shape, q.axes) \
            == tuple(ref.spec_for_shape(q.shape, q.axes))


def _tree_leaves(tree, spec, path=()):
    if isinstance(spec, P):
        return [(path, tree, spec)]
    keys = spec.keys() if isinstance(spec, dict) else range(len(spec))
    return [x for k in keys
            for x in _tree_leaves(tree[k], spec[k], path + (k,))]


@pytest.fixture(scope="module")
def whole_trees():
    out = {}
    for arch in H.FWD_ARCHS:
        _, rp, tcfg, tp = both_params(arch)
        out[arch] = (jax.tree.map(np.asarray, rp), tp)
    return out


@pytest.mark.parametrize("case", H.tree_cases(), ids=H.case_id)
def test_rank_tree_is_the_keep_hook_block(whole_trees, case):
    """Every leaf of a rank's ``from_reference(plan=)`` tree and of its
    ``init_params(plan=)`` tree is the keep-hook's block of the whole
    tree; the attention's heads (when they split), the vocab and the
    FFNs are cut to 1/tp, the rest whole."""
    arch, m, lay = case
    cfg = H._cfg(arch)
    params_np, whole = whole_trees[arch]
    spec = model_spec(cfg)
    gen = torch.Generator()
    fresh = init_params(gen.manual_seed(3), cfg, torch.float32, "cpu")
    for rank in range(4):
        plan = make_plan(lay, Mesh(("data", "model"), m, rank))
        keep = plan.keep_hook(cfg)
        mine = from_reference(params_np, cfg, plan=plan)
        drawn = init_params(gen.manual_seed(3), cfg, torch.float32, "cpu",
                            plan=plan)
        tp = plan.tp
        for (path, leaf, p), (_, w, _), (_, d, _), (_, f, _) in zip(
                _tree_leaves(mine, spec), _tree_leaves(whole, spec),
                _tree_leaves(drawn, spec), _tree_leaves(fresh, spec)):
            sl = keep(path, p) or (slice(None),) * len(p.shape)
            assert torch.equal(leaf, w[sl]), path
            assert torch.equal(d, f[sl]), path
            shape = list(p.shape)
            for i, ax in enumerate(p.axes):
                if ax in ("vocab", "ffn") or (
                        ax in ("heads", "kv_heads")
                        and plan.heads_sharded(cfg)):
                    shape[i] //= tp
            if "moe" not in path:
                assert list(leaf.shape) == shape, path
        assert plan.heads_sharded(cfg) == (tp > 1 and arch != "smollm-360m")


@pytest.mark.parametrize("names,sizes", MESH_SHAPES)
def test_axis_index_is_the_sorted_group_rank(names, sizes):
    n = int(np.prod(sizes))
    for axes in [c for k in range(1, len(names) + 1)
                 for c in itertools.combinations(names, k)]:
        for r in range(n):
            mesh = Mesh(names, sizes, r)
            ranks = mesh.group_ranks(axes)
            assert ranks == sorted(ranks) and r in ranks
            assert ranks.index(r) == mesh.axis_index(axes)
