"""Rank workers for tests/test_torch_dist_train_dropless.py — imports no JAX.

Training an explicitly dropless MoE on a mesh.  The test process starts 4
gloo ranks on the CPU (``run_ranks``), each running ``rank_main`` over
every case below, and writes the reduced configs' weights (the
reference's, their zero leaves drawn) into the work directory as
``_torch_dist_train_ranks.write_weights`` does; it gets back what each
rank measured:

* float64, every layout the dropless body serves, under every exchange
  schedule (``SCHEDULES``): the mesh's ``value_and_grad`` and two
  ``train_step``s against the port's single-device dropless ones on the
  same weights and batches (``_torch_dist_train_ranks``' measures: the
  loss, every gradient block, the clip's norm, the parameters after two
  AdamW steps), and the exchange's chunk and overflow counts in the
  differentiated step;
* float64, the mesh's loss and gradient blocks of ``REF_CASES``, which the
  test holds to the reference's own mesh gradient
  (``tests/_torch_ref_mesh_grads.py``);
* the MoE block alone with every token routed to EP rank 0's experts
  (``skew_case``), so that a tight cap overflows: its gradients against
  the single-device block's;
* the collectives of a block's forward with grad off and of its forward
  and backward with grad on, in the order they were issued
  (``census_case``).
"""

import collections
import contextlib
import dataclasses
import math

import torch

import _torch_dist_train_ranks as D

ARCHS = ("phi3.5-moe-42b", "deepseek-v2-236b")   # deepseek: MLA, shared
# (layout, comm_algo) on the 2x2 mesh; 4x1 runs mixserve alone (EP 4, TP 1)
LAYOUTS = (("mixserve", "fused"), ("mixserve", "unfused"),
           ("dp_ep", "unfused"))
# (chunks, cap_rows) of the EP exchange; "tight" caps each chunk at its
# mean rows a destination (``tight_cap``), so chunks overflow and run again
SCHEDULES = {"off": None, "c2": (2, 0), "c2tight": (2, "tight"),
             "c4tight": (4, "tight")}
# the reference's mesh gradient (2x2, phi3.5): id -> (layout, comm_algo,
# schedule)
REF_ARCH = "phi3.5-moe-42b"
REF_CASES = {"mixserve-fused-off": ("mixserve", "fused", "off"),
             "mixserve-fused-c2tight": ("mixserve", "fused", "c2tight"),
             "dp_ep-c2tight": ("dp_ep", "unfused", "c2tight")}
SKEW_LAYOUTS = (("mixserve", "fused"), ("mixserve", "unfused"))
CENSUS_CASES = ("c4guard", "c4tight")
COEF = 0.01                       # the block objective's aux coefficient


def f64_cases():
    """(arch, mesh, layout, comm_algo, schedule, sp, fsdp, microbatches)."""
    out = []
    for a in ARCHS:
        for lay, algo in LAYOUTS:
            for s in ("off", "c2", "c2tight"):
                out.append((a, (2, 2), lay, algo, s, "sp", "nofsdp", 1))
        for s in ("off", "c2", "c2tight"):
            out.append((a, (4, 1), "mixserve", "fused", s, "sp", "nofsdp",
                        1))
        out.append((a, (2, 2), "pure_tp", "unfused", "off", "sp", "nofsdp",
                    1))
    a = REF_ARCH
    out += [(a, (2, 2), "mixserve", "fused", "c2tight", "nosp", "nofsdp", 1),
            (a, (2, 2), "mixserve", "fused", "c2tight", "sp", "fsdp", 1),
            (a, (2, 2), "mixserve", "fused", "c2tight", "sp", "nofsdp", 2),
            (a, (2, 2), "mixserve", "fused", "c4tight", "sp", "nofsdp", 1)]
    return out


case_id = D.case_id


def tokens_local(plan, rows: int, seq: int) -> int:
    """The tokens one rank's MoE body sees of ``rows`` x ``seq``."""
    t = (rows // plan.dp) * seq
    if plan.token_sliced:
        t = (t + (-t) % plan.tp) // plan.tp
    return t


def tight_cap(plan, cfg, tokens: int, chunks: int) -> int:
    """The mean rows a destination of one chunk: a cap that routing
    around the mean overflows."""
    t_c = tokens // math.gcd(chunks, tokens)
    return max(1, t_c * cfg.top_k // plan.ep)


def plan_for(mesh, lay, algo, sched, sp="sp", fsdp="nofsdp", rows=None,
             cfg=None):
    """The dropless plan of a case; ``rows`` x the batch's seq are the rows
    of one microbatch, which the tight cap is priced from."""
    from repro_torch.core.cost_model import EpOverlap
    from repro_torch.core.partitioner import make_plan
    plan = make_plan(lay, mesh, algo, sp=sp == "sp", fsdp=fsdp == "fsdp",
                     dispatch="dropless")
    s = SCHEDULES[sched]
    if s is None:
        return plan
    chunks, cap = s
    if cap == "tight":
        cap = tight_cap(plan, cfg, tokens_local(plan, rows,
                                                D.F64_BATCH[1]), chunks)
    return dataclasses.replace(plan, ep_overlap=EpOverlap(chunks=chunks,
                                                          cap_rows=cap))


def f64_case(case, weights, meshes):
    arch, m, lay, algo, sched, sp, fs, micro = case
    rows = (D.F64_BATCH if micro == 1 else D.MB_BATCH)[0] // micro
    plan = plan_for(meshes[m], lay, algo, sched, sp, fs, rows=rows,
                    cfg=D.cfg_for(arch))
    return D.f64_run(arch, plan, micro, weights)


def ref_batch(cfg):
    return D.batches(cfg, REF_ARCH, D.F64_BATCH, 1, torch.float64)[0]


def ref_plan(cid, mesh, cfg):
    lay, algo, sched = REF_CASES[cid]
    return plan_for(mesh, lay, algo, sched, rows=D.F64_BATCH[0], cfg=cfg)


def ref_case(cid, weights, meshes):
    """The mesh's float64 loss and gradient blocks of a ``REF_CASES``
    entry, to hold to the reference's mesh gradient."""
    from repro_torch.bridge import from_reference
    from repro_torch.models import moe as M
    from repro_torch.training import train_step as TS
    from repro_torch.training.tree import flatten_with_paths
    cfg = D.cfg_for(REF_ARCH)
    plan = ref_plan(cid, meshes[(2, 2)], cfg)
    with D.float_is_f64():
        local = from_reference(weights[REF_ARCH], cfg, dtype=torch.float64,
                               plan=plan)
        M.exchange_counts.clear()
        (loss, _), g = TS.value_and_grad(local, ref_batch(cfg), cfg, plan)
    return {"loss": float(loss), "exchange": dict(M.exchange_counts),
            "grads": {"/".join(map(str, p)): t.numpy().copy()
                      for p, t in flatten_with_paths(g)}}


# ---------------------------------------------------------------------------
# the MoE block alone: routing skewed onto EP rank 0, and its census
# ---------------------------------------------------------------------------

def _block_inputs(arch, weights, skew):
    """(whole block params, x (4, 8, h), cotangent) in float64: layer 0's
    MoE weights; with ``skew`` the router puts every token on experts 0
    and 1 (EP rank 0's), as the reference's overlap test skews it: its
    columns 0 and 1 positive (4/h and 2/h, small enough that the softmax
    keeps a gradient) and the rest zero, with a zero norm weight and
    positive rows, so that those two logits lead on every token."""
    from repro_torch.bridge import from_reference
    cfg = D.cfg_for(arch)
    whole = from_reference(weights[arch], cfg, dtype=torch.float64)
    p = {k: v.clone() for k, v in whole["groups"][0][0]["moe"].items()}
    g = torch.Generator().manual_seed(21)
    x = torch.randn(4, 8, cfg.d_model, generator=g, dtype=torch.float64)
    if skew:
        x = x.abs() + 0.5
        p["norm"] = torch.zeros_like(p["norm"])
        p["router"] = torch.zeros_like(p["router"])
        h = cfg.d_model
        p["router"][:, 0], p["router"][:, 1] = 4.0 / h, 2.0 / h
    cot = torch.randn(x.shape, generator=g, dtype=torch.float64)
    return cfg, p, x, cot


def _rank_inputs(cfg, p, x, cot, plan):
    """This rank's blocks of the block's weights, and its batch rows of x
    and of the cotangent (all of them with no mesh)."""
    from repro_torch.models import moe as M
    if not plan.enabled:
        return p, x, cot
    spec = M.moe_spec(cfg)
    rows = plan.local_slices(tuple(x.shape), ("batch",))
    return ({k: v[plan.local_slices(tuple(v.shape), spec[k].axes)]
             for k, v in p.items()}, x[rows], cot[rows])


def _block_grads(cfg, p, x, cot, plan, reduce=True):
    """The block objective's gradients on this rank: the rank's rows'
    output against the cotangent plus ``COEF`` x the aux, as every rank
    computes the one loss.  With a mesh the weights are this rank's
    blocks, x's gradient is whole on every rank (``moe_rank``'s entry is
    ``copy_in``), and with ``reduce`` each weight's is summed over
    ``grad_sum_axes`` after the backward."""
    from repro_torch.core import collectives as C
    from repro_torch.models import moe as M
    spec = M.moe_spec(cfg)
    p, x, cot = _rank_inputs(cfg, p, x, cot, plan)
    p = {k: v.clone().requires_grad_() for k, v in p.items()}
    x = x.clone().requires_grad_()
    with torch.enable_grad():
        out, aux = M.moe_rank(p, x, cfg, plan)
        loss = (out * cot).sum() + COEF * aux
        names = sorted(p)
        live = [x] + [p[k] for k in names]
        # an EP rank whose experts receive no row leaves them unused
        gs = [torch.zeros_like(t) if g is None else g for g, t in zip(
            torch.autograd.grad(loss, live, allow_unused=True), live)]
    gx, gp = gs[0], dict(zip(names, gs[1:]))
    if plan.enabled and reduce:
        gp = {k: (C.psum_grads([g], plan.mesh, axes)[0] if axes else g)
              for k, g in gp.items()
              for axes in [plan.grad_sum_axes(
                  cfg, spec[k], plan.store_spec(cfg, spec[k]), False)]}
    return out.detach(), gx, gp


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-300)).item()


def skew_case(lay, algo, weights, meshes):
    """Every token on EP rank 0's experts, C=2 at a tight cap: the block's
    loss gradients on the mesh against the single-device dropless block
    (its aux by the mesh's rule), and the exchange's counts."""
    from repro_torch.core.partitioner import make_plan
    from repro_torch.models import moe as M
    cfg, p, x, cot = _block_inputs(REF_ARCH, weights, skew=True)
    plan = plan_for(meshes[(2, 2)], lay, algo, "c2tight", rows=x.shape[0],
                    cfg=cfg)
    with D.float_is_f64():
        with D.mesh_aux(plan):
            single = _block_grads(cfg, p, x, cot,
                                  make_plan("mixserve", None,
                                            dispatch="dropless"))
        M.exchange_counts.clear()
        _, gx, gp = _block_grads(cfg, p, x, cot, plan)
    spec = M.moe_spec(cfg)
    rows = plan.local_slices(tuple(x.shape), ("batch",))
    errs = {"x": _rel(gx, single[1][rows])}
    for k, g in gp.items():
        want = single[2][k]
        errs[k] = _rel(g, want[plan.local_slices(tuple(want.shape),
                                                 spec[k].axes)])
    # the routing really is skewed: every slot on experts 0 and 1
    idx = M.route_topk(M.rms_norm(x, p["norm"], cfg.norm_eps)
                       .reshape(-1, cfg.d_model) @ p["router"],
                       cfg.top_k)[0]
    return {"errs": errs, "exchange": dict(M.exchange_counts),
            "on_rank0": bool((idx < cfg.n_experts // plan.ep).all())}


class _Log(collections.Counter):
    """A counter that also keeps the order its keys were bumped in."""

    def __init__(self):
        super().__init__()
        self.log = []

    def __setitem__(self, key, value):
        self.log.append(key)
        super().__setitem__(key, value)


@contextlib.contextmanager
def _logged():
    from repro_torch.core import collectives as C
    orig, C.counters = C.counters, _Log()
    try:
        yield C.counters
    finally:
        C.counters = orig


def census_case(kind, weights, meshes):
    """mixserve fused 2x2, 4 chunks: a cap one row short of the chunk's
    worst case (guarded: the overflow pmax runs, nothing overflows) or the
    tight cap (chunks overflow).  The block's collectives in issue order
    with grad off, and with grad on through the backward, with each run's
    exchange counts and whether the two outputs are bitwise equal."""
    from repro_torch.core.cost_model import EpOverlap
    from repro_torch.models import moe as M
    cfg, p, x, cot = _block_inputs(REF_ARCH, weights, skew=False)
    plan = plan_for(meshes[(2, 2)], "mixserve", "fused", "c4tight",
                    rows=x.shape[0], cfg=cfg)
    if kind == "c4guard":
        t_c = tokens_local(plan, x.shape[0], x.shape[1]) // 4
        plan = dataclasses.replace(plan, ep_overlap=EpOverlap(
            chunks=4, cap_rows=t_c * cfg.top_k - 1))
    out = {}
    for grad in (False, True):
        M.exchange_counts.clear()
        with _logged() as log, torch.set_grad_enabled(grad):
            if grad:
                y, _, _ = _block_grads(cfg, p, x, cot, plan, reduce=False)
            else:
                p_r, x_r, _ = _rank_inputs(cfg, p, x, cot, plan)
                y, _ = M.moe_rank(p_r, x_r, cfg, plan)
        out[grad] = {"log": list(log.log), "exchange":
                     dict(M.exchange_counts), "y": y}
    same = torch.equal(out[False]["y"], out[True]["y"])
    return {"off": {k: v for k, v in out[False].items() if k != "y"},
            "on": {k: v for k, v in out[True].items() if k != "y"},
            "same_output": same,
            "axes": {"ep": plan.mesh.axes(plan.ep_axes),
                     "tp": plan.mesh.axes(plan.tp_axes)}}


def rank_main(rank, world, workdir):
    import pathlib
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    weights = D.Weights(pathlib.Path(workdir))
    meshes = {m: make_host_mesh(*m) for m in D.MESHES}
    out = {"f64": {}, "ref": {}, "skew": {}, "census": {}}
    for cid in REF_CASES:
        out["ref"][cid] = ref_case(cid, weights, meshes)
    for case in f64_cases():
        out["f64"][case_id(case)] = f64_case(case, weights, meshes)
    for lay, algo in SKEW_LAYOUTS:
        out["skew"][f"{lay}-{algo}"] = skew_case(lay, algo, weights, meshes)
    for kind in CENSUS_CASES:
        out["census"][kind] = census_case(kind, weights, meshes)
    return out
