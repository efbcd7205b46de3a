"""Rank workers for tests/test_torch_dist_train.py — imports no JAX.

The test process starts 4 gloo ranks on the CPU (``run_ranks``), each
running ``rank_main`` over every case below, and writes every reduced
config's weights (the reference's, its zero leaves drawn) as numpy into
the work directory as it makes them (``write_weights``; the ranks wait for
each config's); it gets back what each rank measured:

* float64: the mesh's ``value_and_grad`` and two ``train_step``s against
  the port's single-device ones on the same weights and batches, the
  single-device router aux taken by the mesh's rule (``mesh_aux``): the
  loss, every gradient block, the clip's norm and the parameters after two
  AdamW steps, each as its largest error relative to the leaf's largest
  magnitude;
* float32: the mesh's loss and gradient blocks, which the test holds to
  the reference's;
* the FSDP storage blocks, the collective census of a training step, a
  checkpoint of a mesh state against the single-device file, the
  collectives' backwards against finite differences of the global
  objective (the issued all_to_all and all_gather too), and the guards
  (kernels under autograd, the microbatch rule on a rank's rows) beside
  an explicit dropless plan, which trains.
"""

import contextlib
import dataclasses
import pathlib
import pickle

import numpy as np
import torch

ARCHS = ("phi3.5-moe-42b", "deepseek-v2-236b", "smollm-360m", "gemma-2b",
         "minicpm3-4b", "minitron-8b", "rwkv6-1.6b", "recurrentgemma-9b",
         "whisper-tiny", "qwen2-vl-7b")
# the configs trained under every layout, sp and fsdp switch, on both meshes
LAYOUT_ARCHS = ("phi3.5-moe-42b", "deepseek-v2-236b", "smollm-360m")
LAYOUTS = ("mixserve", "pure_tp", "dp_ep")
MESHES = ((2, 2), (4, 1))                 # (data, model)
CF = 8.0                                  # capacity factor: nothing drops
F64_BATCH = (4, 8)                        # (batch, seq); qwen2-vl: seq 24
F32_BATCH = (2, 32)                       # GRAD_BOUND's; qwen2-vl: seq 40
MB_BATCH = (8, 8)                         # the microbatch cases
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def seq_for(arch: str, seq: int) -> int:
    """qwen2-vl's rows hold its 16 patch embeddings first."""
    return seq + 16 if arch == "qwen2-vl-7b" else seq


def f64_cases():
    """(arch, mesh, layout, sp, fsdp, microbatches)."""
    out = [(a, (2, 2), "mixserve", "sp", "fsdp", 1) for a in ARCHS]
    for a in LAYOUT_ARCHS:
        for lay in LAYOUTS:
            for sp in ("sp", "nosp"):
                for fs in ("fsdp", "nofsdp"):
                    case = (a, (2, 2), lay, sp, fs, 1)
                    if case not in out:
                        out.append(case)
            for fs in ("fsdp", "nofsdp"):          # TP 1: sp does nothing
                out.append((a, (4, 1), lay, "sp", fs, 1))
    out += [("phi3.5-moe-42b", (2, 2), "mixserve", "sp", "fsdp", 2),
            ("smollm-360m", (4, 1), "dp_ep", "sp", "nofsdp", 2)]
    return out


def f32_cases():
    return [(a, (2, 2), "mixserve", "sp", "fsdp", 1) for a in ARCHS]


def case_id(case) -> str:
    return "-".join(f"{v[0]}x{v[1]}" if isinstance(v, tuple) else str(v)
                    for v in case)


def cfg_for(arch: str):
    import repro_torch.configs as TC
    return dataclasses.replace(TC.get_reduced(arch), capacity_factor=CF)


def plan_for(mesh, layout: str, sp: str, fsdp: str):
    from repro_torch.core.partitioner import make_plan
    return make_plan(layout, mesh, sp=sp == "sp", fsdp=fsdp == "fsdp")


def batches(cfg, arch: str, shape, n: int = 1, dtype=torch.float32):
    """``n`` synthetic batches as tensors, the float inputs in ``dtype``."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    b, s = shape
    out = []
    for bb in SyntheticLM(cfg, DataConfig(batch=b, seq_len=seq_for(arch, s),
                                          seed=0)).batches(n):
        out.append({k: torch.from_numpy(v).to(
            dtype if v.dtype == np.float32 else None)
            for k, v in bb.items()})
    return out


@contextlib.contextmanager
def float_is_f64():
    """``Tensor.float()`` (the port's float32 upcasts) gives float64, so a
    float64 tree runs every step in float64."""
    orig = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: self.to(torch.float64)
    try:
        yield
    finally:
        torch.Tensor.float = orig


def aux_groups(plan, logits):
    """The token groups whose router aux the mesh averages: each batch
    rank's rows, and with dp_ep's token slicing each TP rank's slice of
    them (padded with zero rows, whose logits are zero, as the slice is)."""
    dp, tp = max(plan.dp, 1), plan.tp
    n = logits.shape[0] // dp
    out = []
    for d in range(dp):
        blk = logits[d * n:(d + 1) * n]
        if plan.token_sliced and tp > 1:
            blk = torch.cat([blk, blk.new_zeros((-n) % tp, blk.shape[1])])
            m = blk.shape[0] // tp
            out += [blk[j * m:(j + 1) * m] for j in range(tp)]
        else:
            out.append(blk)
    return out


@contextlib.contextmanager
def mesh_aux(plan):
    """The single-device MoE's router aux taken by the mesh's rule: the
    mean of each group's (``aux_groups``); the routing itself is
    per token, and is unchanged."""
    from repro_torch.models import moe as M
    orig = M.route_topk

    def route(logits, k, renorm=True, use_kernel=False):
        idx, w, _ = orig(logits, k, renorm, use_kernel)
        auxs = [orig(g, k, renorm, use_kernel)[2]
                for g in aux_groups(plan, logits)]
        return idx, w, sum(auxs) / len(auxs)
    M.route_topk = route
    try:
        yield
    finally:
        M.route_topk = orig


def blocks_of(plan, cfg, tree):
    """This rank's blocks of a whole tree (``training.tree.store_specs``)."""
    from repro_torch.training.tree import (flatten_with_paths, store_specs,
                                           tree_map)
    specs = store_specs(cfg, plan, tree)
    it = iter([t if s is None else t[plan.block(tuple(t.shape), s)].clone()
               for (_, t), s in zip(flatten_with_paths(tree), specs)])
    return tree_map(lambda _: next(it), tree)


def tree_err(got, want_whole, plan, cfg):
    """(largest error relative to each leaf's largest magnitude, its path)
    of the blocks ``got`` against the same blocks of ``want_whole``."""
    from repro_torch.training.tree import flatten_with_paths
    want = blocks_of(plan, cfg, want_whole)
    worst = (0.0, None)
    for (p, a), (q, b) in zip(flatten_with_paths(got),
                              flatten_with_paths(want)):
        assert p == q and a.shape == b.shape, (p, q, a.shape, b.shape)
        scale = b.double().abs().max().item()
        e = (a.double() - b.double()).abs().max().item() / max(scale, 1e-300)
        if e >= worst[0]:
            worst = (e, "/".join(map(str, p)))
    return worst


def _update(opt_cfg, grads, opt, params, plan, cfg, loss):
    """``train_step``'s update on gradients already taken."""
    from repro_torch.training import optimizer as O
    from repro_torch.training.tree import store_specs
    cuts = None if plan is None else [
        tuple(a for m in s if m is not None for a in m)
        for s in store_specs(cfg, plan, params)]
    params, opt, stats = O.adamw_update(
        opt_cfg, grads, opt, params, cuts=cuts,
        mesh=None if plan is None else plan.mesh)
    return params, opt, {"loss": loss, **stats}


_SINGLE: dict = {}


def _steps(params, cfg, plan, bs, micro, first):
    """Two steps on ``bs``: the first through ``value_and_grad`` when
    ``first`` (its loss, aux, gradients and the dropless exchange's counts
    kept) and the update, the second ``train_step`` (microbatches
    accumulated in float64, as every other sum of these runs).  ``plan``
    with no mesh: one device (no remat)."""
    from repro_torch.models import moe as M
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_step as TS
    opt_cfg = O.AdamWConfig(**OPT)
    opt = O.init_opt_state(params)
    mesh_plan = plan if plan.enabled else None
    out, metrics = {}, []
    for i, b in enumerate(bs):
        M.exchange_counts.clear()
        if i == 0 and first:
            (loss, parts), g = TS.value_and_grad(params, b, cfg, plan,
                                                 remat=plan.enabled)
            out.update(loss=loss, aux=parts["aux"], grads=g)
            params, opt, m = _update(opt_cfg, g, opt, params, mesh_plan,
                                     cfg, loss)
        else:
            params, opt, m = TS.train_step(
                params, opt, b, cfg=cfg, plan=plan, opt_cfg=opt_cfg,
                remat=plan.enabled, microbatches=micro,
                accum_dtype=torch.float64)
        out.setdefault("exchange", dict(M.exchange_counts))
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    out.update(params=params, metrics=metrics)
    return out


def _single(arch, cfg, plan, weights, bs, micro):
    """The single-device run a mesh case is held to (the plan's dispatch
    mode on one device), shared by the cases with the same aux groups,
    dispatch and microbatches (``mesh_aux``)."""
    from repro_torch.bridge import from_reference
    from repro_torch.core.partitioner import make_plan
    from repro_torch.training import optimizer as O
    key = (arch, plan.dp, plan.tp if plan.token_sliced else 1, micro,
           plan.dispatch_mode)
    if key not in _SINGLE:
        whole = from_reference(weights[arch], cfg, dtype=torch.float64)
        one = make_plan("mixserve", None, dispatch=plan.dispatch_mode)
        with mesh_aux(plan):
            res = _steps(whole, cfg, one, bs, micro, micro == 1)
        if micro == 1:
            res["gnorm"] = float(O.global_norm(res["grads"]))
        _SINGLE[key] = res
    return _SINGLE[key]


def f64_case(case, weights, meshes):
    arch, m, lay, sp, fs, micro = case
    return f64_run(arch, plan_for(meshes[m], lay, sp, fs), micro, weights)


def f64_run(arch, plan, micro, weights):
    """Two float64 steps of ``arch`` under the mesh ``plan`` against the
    same steps on one device: each measure's largest relative error, and
    the exchange counts of the mesh's first step."""
    from repro_torch.bridge import from_reference
    from repro_torch.training import optimizer as O
    from repro_torch.training.tree import store_specs
    cfg = cfg_for(arch)
    shape = F64_BATCH if micro == 1 else MB_BATCH
    bs = batches(cfg, arch, shape, 2, torch.float64)
    with float_is_f64():
        single = _single(arch, cfg, plan, weights, bs, micro)
        local = from_reference(weights[arch], cfg, dtype=torch.float64,
                               plan=plan)
        mesh = _steps(local, cfg, plan, bs, micro, micro == 1)
        out = {"steps": [{k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-300)
                          for k in a}
                         for a, b in zip(mesh["metrics"], single["metrics"])],
               "params": tree_err(mesh["params"], single["params"], plan,
                                  cfg),
               "exchange": mesh["exchange"]}
        if micro == 1:
            ls = float(single["loss"])
            out["loss"] = abs(float(mesh["loss"]) - ls) / abs(ls)
            out["aux"] = abs(float(mesh["aux"]) - float(single["aux"]))
            out["grad"] = tree_err(mesh["grads"], single["grads"], plan,
                                   cfg)
            cuts = [tuple(a for mm in s if mm is not None for a in mm)
                    for s in store_specs(cfg, plan, mesh["grads"])]
            nm = float(O.global_norm(mesh["grads"], cuts, plan.mesh))
            out["gnorm"] = abs(nm - single["gnorm"]) / single["gnorm"]
    return out


def f32_case(case, weights, meshes):
    """The mesh's f32 loss and gradient blocks, to hold to the
    reference's."""
    from repro_torch.bridge import from_reference
    from repro_torch.training import train_step as TS
    from repro_torch.training.tree import flatten_with_paths
    arch, m, lay, sp, fs, _ = case
    cfg = cfg_for(arch)
    plan = plan_for(meshes[m], lay, sp, fs)
    local = from_reference(weights[arch], cfg, plan=plan)
    (loss, parts), g = TS.value_and_grad(
        local, batches(cfg, arch, F32_BATCH)[0], cfg, plan)
    return {"loss": float(loss), "aux": float(parts["aux"]),
            "grads": {p: t.numpy().copy() for p, t in flatten_with_paths(g)}}


def fsdp_blocks(weights, meshes):
    """Every config under fsdp: each stored leaf is the keep-hook's block
    of the whole one, as ``init_params(plan=)`` and
    ``bridge.from_reference(plan=)`` store it, and how many leaves fsdp
    cut along ``embed``."""
    from repro_torch.bridge import from_reference
    from repro_torch.models.model import init_params, model_spec
    from repro_torch.models.param import is_p
    from repro_torch.training.tree import flatten_with_paths
    out = {}
    for arch in ARCHS:
        cfg = cfg_for(arch)
        plan = plan_for(meshes[(2, 2)], "mixserve", "sp", "fsdp")
        keep = plan.keep_hook(cfg)
        whole = init_params(torch.Generator().manual_seed(3), cfg,
                            torch.float32, "cpu")
        mine = init_params(torch.Generator().manual_seed(3), cfg,
                           torch.float32, "cpu", plan=plan)
        bridged = from_reference(weights[arch], cfg, plan=plan)
        ref_whole = from_reference(weights[arch], cfg)
        ps = []

        def walk(path, node):
            if is_p(node):
                ps.append((path, node))
            elif isinstance(node, dict):
                for k in sorted(node):
                    walk(path + (k,), node[k])
            else:
                for i, v in enumerate(node):
                    walk(path + (i,), v)
        walk((), model_spec(cfg))
        ok, cut = True, 0
        for (path, p), (_, a), (_, w), (_, br), (_, rw) in zip(
                ps, flatten_with_paths(mine), flatten_with_paths(whole),
                flatten_with_paths(bridged), flatten_with_paths(ref_whole)):
            sl = keep(path, p)
            sl = (slice(None),) if sl is None else sl
            ok &= torch.equal(a, w[sl]) and torch.equal(br, rw[sl])
            spec = plan.store_spec(cfg, p)
            cut += any(ax == "embed" and mm is not None
                       for ax, mm in zip(p.axes, spec))
        out[arch] = (bool(ok), cut)
    return out


def census(weights, meshes):
    """The collectives of a phi3.5 ``loss_fn`` (its forward and the
    vocab-parallel loss) with grad off, of one ``value_and_grad`` (no
    remat) on the same plan (mixserve 2x2, sp and fsdp on), and of a
    ``train_step`` whole and in two microbatches with fsdp off (the
    replicated leaves' gradients summed over "data")."""
    from repro_torch.bridge import from_reference
    from repro_torch.core import collectives as C
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_step as TS
    arch = "phi3.5-moe-42b"
    cfg = cfg_for(arch)
    plan = dataclasses.replace(
        plan_for(meshes[(2, 2)], "mixserve", "sp", "fsdp"),
        dispatch_mode="capacity")
    local = from_reference(weights[arch], cfg, plan=plan)
    b = batches(cfg, arch, F64_BATCH)[0]
    C.reset_counters()
    with torch.no_grad():
        TS.loss_fn(local, b, cfg, plan, remat=False)
    off = dict(C.counters)
    C.reset_counters()
    TS.value_and_grad(local, b, cfg, plan, remat=False)
    on = dict(C.counters)
    steps = {}
    plan = dataclasses.replace(plan_for(meshes[(2, 2)], "mixserve", "sp",
                                        "nofsdp"), dispatch_mode="capacity")
    for m in (1, 2):             # a whole step, then two microbatches
        params = from_reference(weights[arch], cfg, plan=plan)
        C.reset_counters()
        TS.train_step(params, O.init_opt_state(params), b, cfg=cfg,
                      plan=plan, remat=False, microbatches=m)
        steps[m] = dict(C.counters)
    C.reset_counters()
    return {"grad_off": off, "train": on, "step": steps}


def checkpoint_case(weights, meshes, workdir):
    """A mesh state (bf16 params, f32 moments, a step) saved from its
    blocks against the whole state saved on one device, byte for byte,
    and restored to each rank's blocks bit for bit."""
    from repro_torch.bridge import from_reference
    from repro_torch.training import checkpoint as CK
    from repro_torch.training.optimizer import AdamWState
    from repro_torch.training.tree import flatten_with_paths, tree_map
    arch = "phi3.5-moe-42b"
    cfg = cfg_for(arch)
    plan = plan_for(meshes[(2, 2)], "mixserve", "sp", "fsdp")
    params = from_reference(weights[arch], cfg, dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(5)
    state = AdamWState(step=torch.tensor(2, dtype=torch.int32),
                       m=tree_map(lambda t: torch.randn(
                           t.shape, generator=g), params),
                       v=tree_map(lambda t: torch.rand(
                           t.shape, generator=g), params))
    whole = {"params": params, "opt": state}
    local = blocks_of(plan, cfg, whole)
    mesh_path, whole_path = (str(workdir / "mesh.npz"),
                             str(workdir / "whole.npz"))
    CK.save(mesh_path, local, plan=plan, cfg=cfg)
    if plan.mesh.rank == 0:
        CK.save(whole_path, whole)
    torch.distributed.barrier()
    same = pathlib.Path(mesh_path).read_bytes() \
        == pathlib.Path(whole_path).read_bytes()
    like = tree_map(torch.zeros_like, local)
    back = CK.restore(mesh_path, like, plan=plan, cfg=cfg)
    bits = all(a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
        for (_, a), (_, b) in zip(flatten_with_paths(back),
                                  flatten_with_paths(local)))
    torch.distributed.barrier()
    return {"bytes_equal": same, "restored": bits,
            "n_leaves": len(flatten_with_paths(local)),
            "n_params": len(flatten_with_paths(params))}


def _gradcheck(mesh, op, x_global, local_of, objective, *, whole_out,
               assemble, eps=1e-6):
    """Largest |autograd - finite difference| of a global objective
    through one collective, relative to the gradient's largest magnitude.

    ``x_global`` (float64, the same on every rank) is the objective's
    input: ``local_of(x_global)`` this rank's (its block, or the whole
    value); ``objective(y)`` this rank's term, the global objective the
    ranks' sum (``whole_out``: every rank computes the one objective, so
    it is any rank's).  ``assemble`` reads the global gradient off the
    ranks' backward: "blocks" side by side, "whole" every rank's own,
    "sum" the ranks' shares summed.  Every rank perturbs the same element
    of ``x_global`` in lockstep."""
    from repro_torch.core import collectives as C
    names = mesh.axis_names

    def global_value(xg):
        t = objective(op(local_of(xg))).detach().reshape(1)
        v = float(C._ar(t, mesh, names)[0])
        return v / mesh.size if whole_out else v
    x = local_of(x_global).detach().clone().requires_grad_()
    (g,) = torch.autograd.grad(objective(op(x)), x)
    g = g.reshape(1, -1)
    if assemble == "blocks":
        g = C._ag(g, mesh, names, 0)
    elif assemble == "sum":
        g = C._ar(g.clone(), mesh, names)
    g = g.reshape(-1)
    flat = x_global.reshape(-1)
    fd = torch.empty(flat.numel(), dtype=torch.float64)
    for i in range(flat.numel()):
        xp, xm = flat.clone(), flat.clone()
        xp[i] += eps
        xm[i] -= eps
        fd[i] = (global_value(xp.reshape(x_global.shape))
                 - global_value(xm.reshape(x_global.shape))) / (2 * eps)
    return ((g - fd).abs().max() / fd.abs().max()).item()


def gradchecks(mesh):
    """Each collective's backward on 4 ranks against finite differences of
    the global objective it stands in for: a sum of the ranks' shares, or
    one objective every rank computes alike."""
    from repro_torch.core import collectives as C
    rank, world = mesh.rank, mesh.size
    axes = mesh.axis_names
    g = torch.Generator().manual_seed(11)
    xg = torch.randn(world, world, 3, generator=g, dtype=torch.float64)
    cot = torch.randn(world, 64, generator=g, dtype=torch.float64)

    def mine(x):                    # each rank's own block of xg
        return x[rank]

    def whole(x):                   # one value, the same on every rank
        return x

    def share_term(y):              # this rank's share of the objective
        return (y.reshape(-1) * cot[rank, :y.numel()]).sum()

    def whole_term(y):              # the one objective
        return (y.reshape(-1) * cot[0, :y.numel()]).sum()

    cases = {   # name: (op, input, objective, whole_out, assemble)
        "all_to_all": (lambda x: C.all_to_all(x, mesh, axes), mine,
                       share_term, False, "blocks"),
        # issued (the dropless EP exchange): the received buffer joins the
        # graph at wait()
        "all_to_all_issued": (lambda x: C.all_to_all(
            x, mesh, axes, async_op=True).wait(), mine, share_term, False,
            "blocks"),
        "all_gather_issued": (lambda x: C.all_gather(
            x, mesh, axes, axis=1, async_op=True).wait(), mine, share_term,
            False, "blocks"),
        "all_gather_sum": (lambda x: C.all_gather(x, mesh, axes, axis=1),
                           mine, share_term, False, "blocks"),
        "all_gather_whole": (lambda x: C.all_gather(
            x, mesh, axes, axis=1, grad="whole"), mine, whole_term, True,
            "blocks"),
        "psum_scatter": (lambda x: C.psum_scatter(
            x, mesh, axes, scatter_dimension=0), mine, share_term, False,
            "blocks"),
        "psum_whole": (lambda x: C.psum(x, mesh, axes), mine, whole_term,
                       True, "blocks"),
        "psum_sum": (lambda x: C.psum(x, mesh, axes, grad="sum"), mine,
                     share_term, False, "blocks"),
        "pmean": (lambda x: C.pmean(x, mesh, axes), mine, whole_term, True,
                  "blocks"),
        "copy_in": (lambda x: C.copy_in(x, mesh, axes), whole, share_term,
                    False, "whole"),
        "scatter": (lambda x: C.scatter(x, mesh, axes, axis=0), whole,
                    share_term, False, "whole"),
        "share": (lambda x: C.share(x, mesh, axes), whole, whole_term, True,
                  "sum"),
    }
    out = {}
    for name, (f, local_of, term, whole_out, assemble) in cases.items():
        x0 = xg if local_of is mine else xg[0]
        out[name] = _gradcheck(mesh, f, x0, local_of, term,
                               whole_out=whole_out, assemble=assemble)
    return out


def guards(weights, meshes):
    """What training on a mesh refuses: kernels under autograd,
    microbatches that do not divide a rank's rows, a batch the batch axes
    do not divide; and the loss of an explicit dropless plan, which
    trains."""
    from repro_torch.bridge import from_reference
    from repro_torch.kernels.policy import KernelPolicy
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_step as TS
    arch = "phi3.5-moe-42b"
    cfg = cfg_for(arch)
    plan = plan_for(meshes[(2, 2)], "mixserve", "sp", "nofsdp")
    local = from_reference(weights[arch], cfg, plan=plan)
    b = batches(cfg, arch, F64_BATCH)[0]
    out = {}

    def raised(fn):
        try:
            fn()
        except Exception as e:              # noqa: BLE001 (its message)
            return f"{type(e).__name__}: {e}"
        return None
    out["dropless"] = float(TS.value_and_grad(
        local, b, cfg, dataclasses.replace(plan, dispatch_mode="dropless"))
        [0][0])
    kplan = dataclasses.replace(plan, kernels=KernelPolicy(
        flash_chunk=True, flash_decode=True, moe_gemm=True,
        fused_permute=True, topk_gate=True))
    out["kernels"] = raised(lambda: TS.value_and_grad(local, b, cfg, kplan))
    opt = O.init_opt_state(local)
    out["micro_rows"] = raised(lambda: TS.train_step(
        local, opt, b, cfg=cfg, plan=plan, microbatches=4))
    b3 = {k: v[:3] for k, v in b.items()}
    out["batch_rows"] = raised(lambda: TS.train_step(
        local, opt, b3, cfg=cfg, plan=plan))
    out["opt_step"] = int(opt.step)      # nothing ran
    return out


def loop_case(meshes, workdir):
    """``launch.train.train_loop`` on the mesh: smollm, 3 steps, a
    checkpoint; rank 0 alone logs."""
    import repro_torch.configs as TC
    from repro_torch.core.partitioner import make_plan
    from repro_torch.launch.train import train_loop
    from repro_torch.models.model import init_params
    from repro_torch.training import checkpoint as CK
    from repro_torch.training.tree import leaves
    cfg = TC.get_reduced("smollm-360m")
    plan = make_plan("mixserve", meshes[(2, 2)], fsdp=True)
    logged = []
    path = str(workdir / "loop.npz")
    params, _, hist = train_loop(cfg, plan, "cpu", steps=3, batch=4, seq=16,
                                 lr=2e-3, save=path, log_every=1,
                                 log=logged.append)
    like = {"params": init_params(torch.Generator().manual_seed(9), cfg,
                                  torch.float32, "cpu", plan=plan)}
    back = CK.restore(path, like, plan=plan, cfg=cfg)
    return {"losses": [h["loss"] for h in hist], "logged": len(logged),
            "restored": all(torch.equal(a, b) for a, b in
                            zip(leaves(back["params"]), leaves(params)))}


class Weights(dict):
    """Each config's numpy weights, read from ``weights-<arch>.pkl`` in
    the work directory when first asked for: the test process writes them
    one config at a time while the ranks run (waiting at most 300 s)."""

    def __init__(self, workdir):
        super().__init__()
        self.workdir = pathlib.Path(workdir)

    def __missing__(self, arch):
        import time
        path = self.workdir / f"weights-{arch}.pkl"
        deadline = time.monotonic() + 300
        while not path.exists():
            if time.monotonic() > deadline:
                raise TimeoutError(f"no {path.name}")
            time.sleep(0.05)
        self[arch] = pickle.loads(path.read_bytes())
        return self[arch]


def write_weights(workdir, arch, tree) -> None:
    """Hand ``arch``'s numpy weights to the ranks (written whole, then
    renamed into place)."""
    path = pathlib.Path(workdir) / f"weights-{arch}.pkl"
    tmp = path.with_suffix(".tmp")
    tmp.write_bytes(pickle.dumps(tree))
    tmp.rename(path)


def rank_main(rank, world, workdir):
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    workdir = pathlib.Path(workdir)
    weights = Weights(workdir)
    meshes = {m: make_host_mesh(*m) for m in MESHES}
    out = {"f64": {}, "f32": {}}
    for case in f64_cases():
        out["f64"][case_id(case)] = f64_case(case, weights, meshes)
    for case in f32_cases():
        out["f32"][case_id(case)] = f32_case(case, weights, meshes)
    out["fsdp"] = fsdp_blocks(weights, meshes)
    out["census"] = census(weights, meshes)
    out["checkpoint"] = checkpoint_case(weights, meshes, workdir)
    out["gradcheck"] = gradchecks(meshes[(2, 2)])
    out["guards"] = guards(weights, meshes)
    out["loop"] = loop_case(meshes, workdir)
    return out


# the card's 4-rank parity (tests/test_torch_gpu.py): phi3.5-moe reduced,
# f32, mixserve 2x2 with sp and fsdp on, against the unsharded step on the
# same card; GRAD_BOUND's phi3.5 entry (tests/_torch_train_helpers.py)
CARD_ARCH, CARD_GRAD_BOUND = "phi3.5-moe-42b", 1.5e-3
# Adam's eps above most |g| and no clip, so that the weights' move under a
# gradient difference dg is at most ~2 lr |dg| / eps a step
CARD_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-2,
                grad_clip=0.0)


def card_parity_rank(rank, world):
    """Two f32 steps on a 2x2 mesh over gloo on one card against the
    unsharded steps each rank runs itself on the card: the first step's
    loss (relative) and worst gradient block (of its leaf's largest), and
    the weights after two steps as a share of Adam's move under both
    steps' gradient differences."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import init_params
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_step as TS
    from repro_torch.training.tree import (flatten_with_paths, store_specs,
                                           tree_map)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_host_mesh(2, 2)
    cfg = cfg_for(CARD_ARCH)
    plan = plan_for(mesh, "mixserve", "sp", "fsdp")
    gen = torch.Generator(device="cuda").manual_seed(3)
    whole = init_params(gen, cfg, torch.float32, "cuda")
    whole = tree_map(lambda t: t if t.any() else 0.5 * torch.randn(
        t.shape, generator=gen, device="cuda"), whole)
    local = blocks_of(plan, cfg, whole)
    bs = [{k: v.cuda() for k, v in b.items()}
          for b in batches(cfg, CARD_ARCH, (4, 32), 2)]
    opt_cfg = O.AdamWConfig(**CARD_OPT)
    cuts = [tuple(a for m in s if m is not None for a in m)
            for s in store_specs(cfg, plan, local)]
    om, os_ = O.init_opt_state(local), O.init_opt_state(whole)
    out, dgs = {}, []
    for i, b in enumerate(bs):
        (lm, _), gm = TS.value_and_grad(local, b, cfg, plan)
        with mesh_aux(plan):
            (ls, _), gs = TS.value_and_grad(whole, b, cfg, remat=False)
        want = blocks_of(plan, cfg, gs)
        dg = [(a - w).abs() for (_, a), (_, w) in
              zip(flatten_with_paths(gm), flatten_with_paths(want))]
        if i == 0:
            out["loss"] = abs(float(lm) - float(ls)) / abs(float(ls))
            out["grad"] = max(
                float(d.max()) / float(w.abs().max())
                for d, (_, w) in zip(dg, flatten_with_paths(gs)))
        dgs.append(dg)
        local, om, _ = O.adamw_update(opt_cfg, gm, om, local, cuts=cuts,
                                      mesh=mesh)
        whole, os_, _ = O.adamw_update(opt_cfg, gs, os_, whole)
    ratio = 0.0
    for i, ((_, a), (_, w)) in enumerate(zip(
            flatten_with_paths(local),
            flatten_with_paths(blocks_of(plan, cfg, whole)))):
        allowed = 4 * opt_cfg.lr * (dgs[0][i] + dgs[1][i]) / opt_cfg.eps \
            + 2.0 ** -22 * (w.abs() + 2 * opt_cfg.lr)
        ratio = max(ratio, float(((a - w).abs() / allowed).max()))
    out["ratio"] = ratio
    return out
