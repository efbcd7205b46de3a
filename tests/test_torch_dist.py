"""The port's multi-device MoE on 4 gloo ranks (CPU) against the reference.

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
* ``LLM.generate`` on 4 ranks gives the reference's single-device greedy
  streams on every rank, with a prefix hit.

Two checks need no ranks: the plans' axis rules and specs equal the
reference's, and a rank's index over an axis tuple is its place in the
sorted group (what ``torch.distributed.new_group`` gives it).
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
from _torch_helpers import both_params  # noqa: E402
from repro.models import moe as RM  # noqa: E402
from repro.core.partitioner import make_plan as r_make_plan  # noqa: E402
from repro.models.param import init_tree as r_init_tree  # noqa: E402
from repro.serving.api import LLM as RLLM  # noqa: E402
from repro.serving.api import ServeSpec as RSpec  # noqa: E402
from repro_torch.core.cost_model import Workload  # noqa: E402
from repro_torch.core.cost_model import comm_census  # noqa: E402
from repro_torch.core.partitioner import make_plan  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models.model import model_spec  # noqa: E402
from repro_torch.models.param import P  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402


@pytest.fixture(scope="module")
def dist(tmp_path_factory):
    work = tmp_path_factory.mktemp("dist")
    inputs, ref_moe, ref_streams, ref_hits = {}, {}, {}, {}
    for arch in H.ARCHS:
        rcfg, rp, _, _ = both_params(arch)
        rcfg = dataclasses.replace(rcfg, capacity_factor=H.CF)
        p = r_init_tree(jax.random.PRNGKey(1), RM.moe_spec(rcfg),
                        jnp.float32)
        x = np.random.default_rng(2).standard_normal(
            H.X_SHAPE + (rcfg.d_model,)).astype(np.float32)
        inputs[arch] = {"moe": jax.tree.map(np.asarray, p), "x": x,
                        "params": jax.tree.map(np.asarray, rp)}
        for d in H.DISPATCH:
            ref_moe[(arch, d)] = np.asarray(RM.moe_local(
                p, jnp.asarray(x), rcfg, cf=H.CF, dispatch=d)[0])
            llm = RLLM.from_spec(RSpec(arch=arch, dispatch=d, **H.SERVE),
                                 cfg=rcfg, params=rp)
            ref_streams[(arch, d)] = llm.generate(
                H.prompts(rcfg.vocab_size), H.NEW_TOKENS)
            ref_hits[(arch, d)] = llm.engine.kv.stats.n_prefix_hits
    (work / "inputs.pkl").write_bytes(pickle.dumps(inputs))
    ranks = run_ranks(H.rank_main, 4, (str(work),), workdir=work,
                      device="cpu", threads=1, timeout_s=600)
    return {"ranks": ranks, "moe": ref_moe, "streams": ref_streams,
            "hits": ref_hits}


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
    arch, _, _, _, dispatch = case
    want = dist["streams"][(arch, dispatch)]
    hits = dist["hits"][(arch, dispatch)]
    assert hits >= 1
    for r in dist["ranks"]:
        assert r["streams"][case] == want
        assert r["hits"][case] == hits


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


@pytest.mark.parametrize("layout", ["mixserve", "pure_tp", "pure_ep",
                                    "dp_ep"])
@pytest.mark.parametrize("names,sizes", MESH_SHAPES)
def test_plan_specs_match_reference(layout, names, sizes):
    import repro_torch.configs as TC
    ref = r_make_plan(layout, _FakeMesh(names, sizes), "sync")
    got = make_plan(layout, Mesh(names, sizes), "sync")
    assert (got.tp_axes, got.ep_axes, got.dp_axes, got.comm_algo) \
        == (ref.tp_axes, ref.ep_axes, ref.dp_axes, ref.comm_algo)
    assert got.rules == ref.rules
    leaves = [q for a in H.ARCHS for q in _leaves(model_spec(
        TC.get_reduced(a)))]
    leaves.append(P((4, 8, 256), ("batch", "seq", "embed")))
    for q in leaves:
        assert got.spec(q.axes) == tuple(ref.spec(q.axes))
        assert got.spec_for_shape(q.shape, q.axes) \
            == tuple(ref.spec_for_shape(q.shape, q.axes))


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
