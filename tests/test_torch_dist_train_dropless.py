"""Training the dropless MoE on a mesh: 4 gloo ranks on the CPU against
the port's single-device dropless step and the reference's own mesh
gradient, reduced configs, float64.

One spawn of 4 ranks (``tests/_torch_dist_train_dropless_ranks.py``,
which imports no JAX) runs every case while this process draws the
weights and a subprocess (``tests/_torch_ref_mesh_grads.py``) computes the
reference's mesh gradients; the parametrised tests below assert one case
each:

* phi3.5-moe and deepseek-v2 (MLA, a shared expert) under ``mixserve``
  fused and unfused and the token-sliced ``dp_ep`` on 2x2, ``mixserve``
  on 4x1 (EP 4, TP 1), each with the exchange monolithic, in 2 chunks at
  the auto cap and in 2 chunks at a tight cap, and ``pure_tp`` (EP 1);
  then ``sp`` off, ``fsdp`` on, 2 microbatches and 4 chunks: the loss,
  every gradient block, the clip's global norm and the parameters after
  two AdamW steps equal the single-device dropless step's within 1e-8 of
  each leaf's largest magnitude (its router aux by the mesh's rule);
* the tight caps overflowed in the differentiated step (the chunk ran
  again at the worst-case extent), the auto caps did not;
* the reference's ``jax.value_and_grad`` of its ``loss_fn`` under its own
  dropless mesh plan (2x2: fused monolithic, fused 2 chunks at a tight
  cap, ``dp_ep`` 2 chunks at a tight cap): loss and gradient blocks within
  1e-8 of each leaf's largest; both sides take the router aux the mesh's
  way, so the whole objective is compared;
* the block with every token routed to EP rank 0's experts: the tight cap
  overflows and the gradients equal the single-device block's;
* the block's collectives: grad off issues what the grad-on forward
  issues, in the same order; each tracked all_to_all has one backward
  all_to_all, each all_gather one backward reduce-scatter but the
  epilogue's (``grad="whole"``), the count exchange and the overflow pmax
  none, and an overflowed chunk's first attempt none.
"""

import concurrent.futures
import os
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist_train_dropless_ranks as DR  # noqa: E402
import _torch_dist_train_ranks as D  # noqa: E402
import jax  # noqa: E402
from _torch_train_helpers import _ref_params  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.training.tree import store_specs  # noqa: E402

F64_BOUND = 1e-8
HERE = os.path.dirname(os.path.abspath(__file__))


def _start_reference(work):
    """The reference's mesh gradients, in a process with 4 host devices."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [HERE, os.path.join(HERE, "..", "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    log = open(work / "ref.log", "w")
    return subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_ref_mesh_grads.py"),
         str(work), DR.REF_ARCH, *DR.REF_CASES],
        env=env, stdout=log, stderr=subprocess.STDOUT), log


@pytest.fixture(scope="module")
def dist(tmp_path_factory):
    work = tmp_path_factory.mktemp("dist_train_dropless")
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(run_ranks, DR.rank_main, 4, (str(work),),
                          workdir=work, device="cpu", threads=1,
                          timeout_s=600)
        ref = None
        for a in DR.ARCHS:
            D.write_weights(work, a, jax.tree.map(np.asarray,
                                                  _ref_params(a, 0)))
            if a == DR.REF_ARCH:
                ref, log = _start_reference(work)
        try:
            rc = ref.wait(timeout=600)
        finally:
            if ref.poll() is None:
                ref.kill()
            log.close()
        res = ranks.result()
    assert rc == 0, (work / "ref.log").read_text()[-4000:]
    refs = {}
    for cid in DR.REF_CASES:
        with np.load(work / f"ref-{cid}.npz") as z:
            refs[cid] = dict(z)
    return {"ranks": res, "ref": refs}


# ---------------------------------------------------------------------------
# the mesh's step is the single-device dropless step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", DR.f64_cases(), ids=DR.case_id)
def test_dropless_mesh_step_equals_single_device_f64(dist, case):
    for r, res in enumerate(dist["ranks"]):
        got = res["f64"][DR.case_id(case)]
        if case[-1] == 1:
            assert got["loss"] <= F64_BOUND, (r, got["loss"])
            assert got["aux"] <= F64_BOUND, (r, got["aux"])
            assert got["grad"][0] <= F64_BOUND, (r, got["grad"])
        for i, st in enumerate(got["steps"]):
            assert st["loss"] <= F64_BOUND, (r, i, st)
            assert st["grad_norm"] <= F64_BOUND, (r, i, st)
        assert got["params"][0] <= F64_BOUND, (r, got["params"])


@pytest.mark.parametrize("case", [c for c in DR.f64_cases() if c[-1] == 1],
                         ids=DR.case_id)
def test_dropless_global_norm_counts_each_block_once(dist, case):
    for r, res in enumerate(dist["ranks"]):
        assert res["f64"][DR.case_id(case)]["gnorm"] <= 1e-12, r


@pytest.mark.parametrize("case", [c for c in DR.f64_cases()
                                  if c[4] != "off" and c[2] != "pure_tp"],
                         ids=DR.case_id)
def test_tight_cap_reruns_in_the_differentiated_step(dist, case):
    """The step that was differentiated ran every chunk, and a tight cap
    made chunks overflow and run again (every rank counts the same: the
    branch is rank-uniform); the auto cap, priced 4 sigma over the mean,
    never did."""
    chunks = DR.SCHEDULES[case[4]][0]
    seen = [res["f64"][DR.case_id(case)]["exchange"]
            for res in dist["ranks"]]
    assert all(s == seen[0] for s in seen), seen
    ex = seen[0]
    # every chunk of every MoE layer and microbatch, and again where the
    # layer's recomputation (remat) reaches the MoE
    assert ex["chunks"] >= chunks * case[-1], ex
    if case[4].endswith("tight"):
        assert ex.get("overflow", 0) > 0, ex
    else:
        assert ex.get("overflow", 0) == 0, ex


# ---------------------------------------------------------------------------
# the reference's own mesh gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cid", list(DR.REF_CASES))
def test_dropless_mesh_grads_match_reference_mesh_f64(dist, cid):
    want = dist["ref"][cid]
    cfg = D.cfg_for(DR.REF_ARCH)
    for r, res in enumerate(dist["ranks"]):
        got = res["ref"][cid]
        loss = float(want["loss"])
        assert abs(got["loss"] - loss) <= F64_BOUND * abs(loss), \
            (r, got["loss"], loss)
        plan = DR.ref_plan(cid, Mesh(("data", "model"), (2, 2), r), cfg)
        if plan.ep_overlap is not None:      # the tight cap reran
            assert got["exchange"].get("overflow", 0) > 0, got["exchange"]
        whole = {p: torch.from_numpy(w) for p, w in want.items()
                 if p != "loss"}
        assert set(whole) == set(got["grads"])
        tree = {p: whole[p] for p in got["grads"]}
        specs = store_specs(cfg, plan, _nest(tree))
        for (path, w), spec in zip(_flat(_nest(tree)), specs):
            blk = w if spec is None else w[plan.block(tuple(w.shape), spec)]
            g = got["grads"][path]
            assert g.shape == tuple(blk.shape), path
            err = np.abs(g - blk.numpy()).max() / w.abs().max().item()
            assert err <= F64_BOUND, (r, path, err)


def _nest(flat: dict):
    """A tree of the port's layout from its ``a/0/b`` leaf paths."""
    root: dict = {}
    for path, leaf in flat.items():
        node, keys = root, path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf

    def fix(node):
        if not isinstance(node, dict):
            return node
        if all(k.isdigit() for k in node):
            return [fix(node[str(i)]) for i in range(len(node))]
        return {k: fix(v) for k, v in node.items()}
    return fix(root)


def _flat(tree):
    from repro_torch.training.tree import flatten_with_paths
    return [("/".join(map(str, p)), t) for p, t in flatten_with_paths(tree)]


# ---------------------------------------------------------------------------
# the block: skewed routing, and its collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", [f"{a}-{b}" for a, b in DR.SKEW_LAYOUTS])
def test_skewed_routing_overflows_and_keeps_the_gradient(dist, layout):
    for r, res in enumerate(dist["ranks"]):
        got = res["skew"][layout]
        assert got["on_rank0"], r
        assert got["exchange"] == {"chunks": 2, "overflow": 2}, got
        for k, e in got["errs"].items():
            assert e <= F64_BOUND, (r, k, e)


@pytest.mark.parametrize("kind", DR.CENSUS_CASES)
def test_dropless_training_census(dist, kind):
    """The block under 4 chunks: with grad off it issues, in order, what
    the grad-on forward issues; the backward follows the rule."""
    for r, res in enumerate(dist["ranks"]):
        c = res["census"][kind]
        off, on = c["off"], c["on"]
        assert c["same_output"], r
        assert off["exchange"] == on["exchange"]
        assert on["log"][:len(off["log"])] == off["log"]
        assert all(len(k) == 3 for k in on["log"][len(off["log"]):])
        ch = on["exchange"]["chunks"]
        ov = on["exchange"].get("overflow", 0)
        assert ch == 4 and (ov == 0) == (kind == "c4guard"), c
        ep, tp = c["axes"]["ep"], c["axes"]["tp"]
        both = tuple(sorted(ep + tp, key=("data", "model").index))
        fwd = Counter({k: n for k, n in Counter(on["log"]).items()
                       if len(k) == 2})
        bwd = Counter({k[:2]: n for k, n in Counter(on["log"]).items()
                       if len(k) == 3})
        # forward: a count, a dispatch and a return A2A a chunk, the last
        # two again on a rerun; the fused widening AG and RS a chunk and a
        # rerun; the epilogue AG; the overflow pmax a chunk and the aux
        # pmean
        assert fwd == Counter({("all_to_all", ep): 3 * ch + 2 * ov,
                               ("all_gather", tp): ch + ov + 1,
                               ("reduce_scatter", tp): ch + ov,
                               ("all_reduce", both): ch + 1}), fwd
        # backward: the tracked A2As the loss reaches (not the counts, not
        # a discarded first attempt), an RS for each widening AG, an AG
        # for each RS, copy_in's psum of x's shares; no pmax, no epilogue
        assert bwd == Counter({("all_to_all", ep): 2 * ch,
                               ("reduce_scatter", tp): ch,
                               ("all_gather", tp): ch,
                               ("all_reduce", tp): 1}), bwd
