"""Training on a mesh: 4 gloo ranks on the CPU against the port's
single-device step and the reference's, reduced configs.

One spawn of 4 ranks (``tests/_torch_dist_train_ranks.py``, which imports
no JAX) runs every case while this process computes the reference's side;
the parametrised tests below assert one case each:

* float64, every reduced config under ``mixserve`` 2x2 with ``sp`` and
  ``fsdp`` on, and phi3.5-moe, deepseek-v2 (MLA) and smollm (replicated
  attention) under ``mixserve``, ``pure_tp`` and ``dp_ep``, ``sp`` on and
  off, ``fsdp`` on and off, on the 2x2 and 4x1 meshes, and two microbatch
  cases: the mesh's loss, every gradient block, the clip's global norm,
  and the parameters after two AdamW steps equal the port's
  single-device step's same blocks within 1e-8 of each leaf's largest
  magnitude.  The single-device router aux is taken by the mesh's rule
  (the mean of each batch rank's, and of each token slice's under
  dp_ep), which is what the mesh trains;
* float32, every reduced config under ``mixserve`` 2x2: the mesh's loss
  and gradient blocks against the reference's single-device
  ``jax.value_and_grad`` of the same objective (cross-entropy plus the
  coefficient times the mean of the two batch ranks' aux) within
  ``LOSS_RTOL`` and the config's ``GRAD_BOUND``;
* the FSDP storage blocks are the keep-hook's, and its ``embed`` cut
  follows the reference's ``spec_for_shape``;
* a training step's collectives: with grad off the forward issues what
  the grad-on forward issues, every all_to_all has its backward, and
  every FSDP gather its reduce-scatter;
* a mesh state's checkpoint is the single-device file byte for byte, and
  restores to each rank's blocks;
* each collective's backward against finite differences of the global
  objective it stands in for, an issued (``async_op``) all_to_all's and
  all_gather's too;
* the guards: kernels under autograd raise, and so do microbatches that
  do not divide a rank's rows; an explicit dropless plan trains (its
  cases: ``tests/test_torch_dist_train_dropless.py``); ``train_loop``
  runs on the mesh.
"""

import concurrent.futures
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist_train_ranks as D  # noqa: E402
import jax  # noqa: E402
from _torch_train_helpers import (GRAD_BOUND, LOSS_RTOL,  # noqa: E402
                                  LOSS_RTOL_WHISPER, _ref_params, batch_np,
                                  to_ref)
import repro.configs as RC  # noqa: E402
from repro.core.partitioner import make_plan as r_make_plan  # noqa: E402
from repro.kernels.policy import KernelPolicy as RPolicy  # noqa: E402
from repro.models import model as RMOD  # noqa: E402
from repro.training.train_step import loss_fn as ref_loss_fn  # noqa: E402
from repro_torch.bridge import from_reference  # noqa: E402
from repro_torch.core.partitioner import make_plan  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.models.model import model_spec  # noqa: E402
from repro_torch.models.param import is_p  # noqa: E402
from repro_torch.training.tree import (flatten_with_paths,  # noqa: E402
                                       store_specs)

F64_BOUND = 1e-8


def _reference_grads(arch):
    """(loss, whole gradients in the port's layout) of the reference's
    single-device objective under the mesh's aux rule: cross-entropy on
    the whole batch plus the coefficient times the mean of the aux of
    each batch rank's rows (2 on the 2x2 mesh)."""
    rcfg = dataclasses.replace(RC.get_reduced(arch), capacity_factor=D.CF)
    tcfg = D.cfg_for(arch)
    rp = _ref_params(arch, 0)
    b = to_ref(batch_np(tcfg, *D.F32_BATCH[:1],
                        seq=D.seq_for(arch, D.F32_BATCH[1]))[0])
    plan = r_make_plan("mixserve", None, kernels=RPolicy(),
                       dispatch="capacity")
    ce_cfg = dataclasses.replace(rcfg, router_aux_coef=0.0)

    def objective(p, bb):
        ce, _ = ref_loss_fn(p, bb, ce_cfg, plan, remat=False)
        if not rcfg.is_moe:
            return ce
        n = bb["tokens"].shape[0] // 2
        auxs = [RMOD.forward(p, rcfg, plan, remat=False,
                             **{k: bb[k][d * n:(d + 1) * n]
                                for k in ("tokens", "embeds", "frames")
                                if k in bb}).aux for d in range(2)]
        return ce + rcfg.router_aux_coef * (auxs[0] + auxs[1]) / 2
    loss, g = jax.jit(jax.value_and_grad(objective))(rp, b)
    return float(loss), from_reference(jax.tree.map(np.asarray, g), tcfg)


@pytest.fixture(scope="module")
def dist(tmp_path_factory):
    """The ranks start first and take each config's weights as this
    process draws them; then it computes the reference's side."""
    work = tmp_path_factory.mktemp("dist_train")
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(run_ranks, D.rank_main, 4, (str(work),),
                          workdir=work, device="cpu", threads=1,
                          timeout_s=600)
        for a in D.ARCHS:
            D.write_weights(work, a, jax.tree.map(np.asarray,
                                                  _ref_params(a, 0)))
        ref = {a: _reference_grads(a) for a, *_ in D.f32_cases()}
        return {"ranks": ranks.result(), "ref": ref}


def _rank_plan(rank, m, lay, sp, fs):
    return D.plan_for(Mesh(("data", "model"), m, rank), lay, sp, fs)


# ---------------------------------------------------------------------------
# float64: the mesh's step is the single-device step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", D.f64_cases(), ids=D.case_id)
def test_mesh_step_equals_single_device_f64(dist, case):
    for r, res in enumerate(dist["ranks"]):
        got = res["f64"][D.case_id(case)]
        if case[-1] == 1:
            assert got["loss"] <= F64_BOUND, (r, got["loss"])
            assert got["aux"] <= F64_BOUND, (r, got["aux"])
            assert got["grad"][0] <= F64_BOUND, (r, got["grad"])
        for i, st in enumerate(got["steps"]):
            assert st["loss"] <= F64_BOUND, (r, i, st)
            assert st["grad_norm"] <= F64_BOUND, (r, i, st)
        assert got["params"][0] <= F64_BOUND, (r, got["params"])


@pytest.mark.parametrize("case", [c for c in D.f64_cases() if c[-1] == 1],
                         ids=D.case_id)
def test_global_norm_counts_each_block_once(dist, case):
    """``global_norm`` of the rank's gradient blocks, cut by cut, equals
    the whole tree's."""
    for r, res in enumerate(dist["ranks"]):
        assert res["f64"][D.case_id(case)]["gnorm"] <= 1e-12, r


# ---------------------------------------------------------------------------
# float32: against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", D.f32_cases(), ids=D.case_id)
def test_mesh_grads_match_reference_f32(dist, case):
    arch = case[0]
    want_loss, want = dist["ref"][arch]
    rtol = LOSS_RTOL_WHISPER if arch == "whisper-tiny" else LOSS_RTOL
    cfg = D.cfg_for(arch)
    leaves = flatten_with_paths(want)
    for r, res in enumerate(dist["ranks"]):
        got = res["f32"][D.case_id(case)]
        np.testing.assert_allclose(got["loss"], want_loss, rtol=rtol)
        plan = _rank_plan(r, *case[1:5])
        specs = store_specs(cfg, plan, want)
        assert len(got["grads"]) == len(leaves)
        for (path, w), spec in zip(leaves, specs):
            blk = w if spec is None else w[plan.block(tuple(w.shape), spec)]
            g = got["grads"][path]
            assert g.shape == tuple(blk.shape), path
            err = np.abs(g - blk.numpy()).max() / w.abs().max().item()
            assert err <= GRAD_BOUND[arch], (r, path, err)


# ---------------------------------------------------------------------------
# FSDP storage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", D.ARCHS)
def test_fsdp_blocks_are_keep_hook_blocks(dist, arch):
    for res in dist["ranks"]:
        same, n_cut = res["fsdp"][arch]
        assert same and n_cut > 0, (same, n_cut)


def _walk(spec, path=()):
    if is_p(spec):
        yield path, spec
    elif isinstance(spec, dict):
        for k in sorted(spec):
            yield from _walk(spec[k], path + (k,))
    else:
        for i, v in enumerate(spec):
            yield from _walk(v, path + (i,))


@pytest.mark.parametrize("layout", D.LAYOUTS)
def test_fsdp_embed_cut_follows_reference_rule(layout):
    """Every leaf's ``embed`` dim is cut over "data" exactly where the
    reference's ``spec_for_shape`` under ``fsdp`` puts "data" there (the
    lowest priority: an expert axis keeps it), on 2x2 and 4x1; with fsdp
    off it stays whole."""
    n = 0
    for arch in D.ARCHS:
        cfg = D.cfg_for(arch)
        for m in D.MESHES:
            tplan = make_plan(layout, Mesh(("data", "model"), m), fsdp=True)
            off = make_plan(layout, Mesh(("data", "model"), m))
            rplan = r_make_plan(layout, _FakeMesh(m), fsdp=True,
                                kernels=RPolicy())
            for path, p in _walk(model_spec(cfg)):
                if "embed" not in p.axes:
                    continue
                i = p.axes.index("embed")
                rspec = tuple(rplan.spec_for_shape(p.shape, p.axes))
                rspec += (None,) * (len(p.shape) - len(rspec))
                want = rspec[i]
                want = None if want is None else (
                    want if isinstance(want, tuple) else (want,))
                assert tplan.store_spec(cfg, p)[i] == want, (arch, m, path)
                assert off.store_spec(cfg, p)[i] is None
                n += want is not None
    assert n > 0


class _FakeMesh:
    """What the reference's plan reads of a mesh: its axis names and
    sizes."""

    def __init__(self, m):
        self.axis_names = ("data", "model")
        self.shape = dict(zip(self.axis_names, m))
        self.devices = np.empty(m)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def test_training_census(dist):
    """With grad off the forward issues exactly the collectives the
    grad-on forward issues (the serving census does not move); the
    backward's are marked: one all_to_all back for each forward one, one
    reduce-scatter over "data" for each FSDP gather (every all_gather
    over "data": the vocab-parallel loss gathers no logits)."""
    for res in dist["ranks"]:
        off, on = res["census"]["grad_off"], res["census"]["train"]
        fwd = {k: v for k, v in on.items() if len(k) == 2}
        bwd = {k[:2]: v for k, v in on.items() if len(k) == 3}
        assert all(len(k) == 2 for k in off)
        assert fwd == off
        assert bwd[("all_to_all", ("data",))] \
            == fwd[("all_to_all", ("data",))] > 0
        assert bwd[("reduce_scatter", ("data",))] \
            == fwd[("all_gather", ("data",))] > 0
        assert ("all_reduce", ("model",)) in bwd      # TP shares summed


def test_microbatches_reduce_gradients_once(dist):
    """A step of two microbatches sums the replicated leaves' gradients
    over the batch ranks once, after accumulating them, as a whole step
    does; the forward and backward inside the graph run twice."""
    def after(c):
        return {k: v for k, v in c.items()
                if len(k) == 3 and k[0] == "all_reduce" and "data" in k[1]}
    for res in dist["ranks"]:
        one, two = res["census"]["step"][1], res["census"]["step"][2]
        assert after(one) and after(two) == after(one)
        assert two[("all_to_all", ("data",))] \
            == 2 * one[("all_to_all", ("data",))] > 0


@pytest.mark.parametrize("op", ["all_to_all", "all_to_all_issued",
                                "all_gather_issued", "all_gather_sum",
                                "all_gather_whole", "psum_scatter",
                                "psum_whole", "psum_sum", "pmean", "copy_in",
                                "scatter", "share"])
def test_collective_backward_gradcheck(dist, op):
    for r, res in enumerate(dist["ranks"]):
        assert res["gradcheck"][op] <= 1e-7, (r, res["gradcheck"][op])


# ---------------------------------------------------------------------------
# checkpoints, guards, the loop
# ---------------------------------------------------------------------------

def test_mesh_checkpoint_is_single_device_file(dist):
    for r, res in enumerate(dist["ranks"]):
        ck = res["checkpoint"]
        assert ck["restored"], (r, ck)
        assert ck["n_leaves"] == 3 * ck["n_params"] + 1     # params, m, v
        if r == 0:
            assert ck["bytes_equal"], ck


def test_training_guards(dist):
    for res in dist["ranks"]:
        g = res["guards"]
        assert np.isfinite(g["dropless"]), g["dropless"]
        assert g["kernels"] and "no backward" in g["kernels"], g["kernels"]
        assert g["micro_rows"] and "2 rows a batch rank" in g["micro_rows"]
        assert g["batch_rows"] and "does not split" in g["batch_rows"]
        assert g["opt_step"] == 0


def test_train_loop_on_mesh(dist):
    for r, res in enumerate(dist["ranks"]):
        lp = res["loop"]
        assert len(lp["losses"]) == 3 and np.isfinite(lp["losses"]).all()
        assert lp["restored"], r
        assert lp["logged"] == (4 if r == 0 else 0), (r, lp["logged"])
    losses = [res["loop"]["losses"] for res in dist["ranks"]]
    assert all(x == losses[0] for x in losses)       # one loss, every rank


@pytest.mark.parametrize("fsdp", [False, True])
def test_serve_spec_resolve_takes_the_fsdp_switch(fsdp):
    """``ServeSpec.resolve(fsdp=)`` builds the plan with ``embed`` over
    "data" (the reference's switch), and without it leaves it whole."""
    from repro_torch.serving.api import ServeSpec
    mesh = Mesh(("data", "model"), (2, 2), 0)
    res = ServeSpec(arch="phi3.5-moe-42b", max_batch=4, max_len=64,
                    chunk=8).resolve(D.cfg_for("phi3.5-moe-42b"), mesh=mesh,
                                     device="cpu", fsdp=fsdp)
    assert res.plan.fsdp is fsdp
    assert res.plan.rules["embed"] == (("data",) if fsdp else None)
