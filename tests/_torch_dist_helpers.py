"""Rank workers for tests/test_torch_dist.py — imports no JAX.

The test process (which imports both packages) writes the reference's
inputs as numpy into a work directory; ``run_ranks`` then starts 4 gloo
ranks on the CPU, each running ``rank_main`` over every case, and hands
back what each rank computed.  The cases are named here so that the test
file can parametrise over them before the ranks run.
"""

import dataclasses
import pathlib
import pickle
from unittest import mock

import numpy as np
import torch

ARCHS = ("phi3.5-moe-42b", "deepseek-v2-236b")
MESHES = ((2, 2), (4, 1))           # (data, model)
LAYOUTS = (("mixserve", "fused"), ("mixserve", "sync"),
           ("mixserve", "unfused"), ("dp_ep", "auto"), ("pure_tp", "auto"))
DISPATCH = ("dropless", "capacity")
CF = 8.0                            # capacity factor at which nothing drops
X_SHAPE = (4, 8)                    # (batch, seq) of the moe_block input
# micro-chunked schedules held bitwise against the monolithic one: 2
# chunks with a row cap one short of the worst case (guarded, no
# overflow) and with a cap of one row (every chunk overflows)
OVERLAP_LAYOUTS = (("mixserve", "fused"), ("mixserve", "unfused"),
                   ("dp_ep", "auto"))
OVERLAPS = ("no_overflow", "overflow")
SERVE = dict(kv="paged", max_batch=4, max_len=64, chunk=8)
NEW_TOKENS = 4


def moe_cases():
    return [(a, m, lay, algo, d) for a in ARCHS for m in MESHES
            for lay, algo in LAYOUTS for d in DISPATCH]


def overlap_cases():
    return [(a, m, lay, algo, o) for a in ARCHS for m in MESHES
            for lay, algo in OVERLAP_LAYOUTS for o in OVERLAPS]


def census_cases():
    return [(a, m, lay, algo, o) for a in ARCHS for m in MESHES
            for lay, algo in LAYOUTS for o in (None,) + OVERLAPS
            if o is None or (lay, algo) in OVERLAP_LAYOUTS]


def stream_cases():
    return moe_cases()


def case_id(case) -> str:
    return "-".join(f"{v[0]}x{v[1]}" if isinstance(v, tuple) else str(v)
                    for v in case)


def prompts(vocab: int):
    """A shared-prefix prompt first, three longer ones, its sibling last:
    the sibling is admitted after the first finishes and finds its pages."""
    rng = np.random.default_rng(5)
    pre = rng.integers(0, vocab, 16).astype(np.int32)
    tail = lambda n: rng.integers(0, vocab, n).astype(np.int32)  # noqa
    return ([np.concatenate([pre, tail(3)])]
            + [tail(n) for n in (40, 33, 45)]
            + [np.concatenate([pre, tail(7)])])


def overlap_for(tokens_local: int, k: int, kind: str):
    """The EpOverlap of a schedule kind at this rank's token count."""
    from repro_torch.core.cost_model import EpOverlap
    n_c = (tokens_local // 2) * k
    return EpOverlap(chunks=2, cap_rows=n_c - 1 if kind == "no_overflow"
                     else 1)


def _cfg(arch):
    import repro_torch.configs as TC
    return dataclasses.replace(TC.get_reduced(arch), capacity_factor=CF)


def _plan(mesh, layout, algo, dispatch, ep_overlap=None):
    from repro_torch.core.partitioner import make_plan
    return make_plan(layout, mesh, "fused" if algo == "auto" else algo,
                     dispatch=dispatch, ep_overlap=ep_overlap)


def rowwise_grouped_gemm(x, w, group_offsets):
    """The plain grouped GEMM, one row per product.  The two schedules cut
    the expert segments at different sizes, and the CPU's BLAS sums a
    one-row product (a matrix-vector call) in another order than a
    many-row one; with one call per row, a row's result cannot depend on
    its segment's size, so the bitwise comparison sees only the
    exchange."""
    n = x.shape[0]
    out = torch.zeros(n, w.shape[-1], dtype=x.dtype)
    off = group_offsets.tolist()
    for e in range(w.shape[0]):
        for r in range(off[e], min(off[e + 1], n)):
            out[r] = (x[r:r + 1].float() @ w[e].float())[0].to(x.dtype)
    return out


def tokens_local(plan, batch: int, seq: int) -> int:
    """Tokens one rank's MoE body sees (the reference's
    ``trace_contract.tokens_local_for``)."""
    t = (batch // plan.dp) * seq
    if plan.token_sliced:
        t = (t + (-t) % plan.tp) // plan.tp
    return t


def _moe_params(inputs, arch, plan):
    from repro_torch.models.moe import moe_spec
    spec = moe_spec(_cfg(arch))
    return {k: torch.from_numpy(np.ascontiguousarray(
        v[plan.local_slices(v.shape, spec[k].axes)]))
        for k, v in inputs[arch]["moe"].items()}


def rank_main(rank, world, workdir):
    """Every case on this rank; returns {section: {case: result}}."""
    from repro_torch.bridge import from_reference
    from repro_torch.core import collectives as C
    from repro_torch.kernels import ref as kref
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe as M
    from repro_torch.serving.api import LLM, ServeSpec

    inputs = pickle.loads((pathlib.Path(workdir) / "inputs.pkl")
                          .read_bytes())
    meshes = {m: make_host_mesh(*m) for m in MESHES}
    out = {"moe": {}, "overlap": {}, "census": {}, "streams": {},
           "hits": {}}

    for case in moe_cases():
        arch, m, lay, algo, d = case
        plan = _plan(meshes[m], lay, algo, d)
        y, _ = M.moe_block(_moe_params(inputs, arch, plan),
                           torch.from_numpy(inputs[arch]["x"]), _cfg(arch),
                           plan)
        out["moe"][case] = y.numpy()

    for case in overlap_cases():
        arch, m, lay, algo, kind = case
        cfg, x = _cfg(arch), torch.from_numpy(inputs[arch]["x"])
        plan = _plan(meshes[m], lay, algo, "dropless")
        ovl = overlap_for(tokens_local(plan, *X_SHAPE), cfg.top_k, kind)
        p = _moe_params(inputs, arch, plan)
        with mock.patch.object(kref, "grouped_gemm_ref",
                               rowwise_grouped_gemm):
            mono, _ = M.moe_block(p, x, cfg, plan)
            M.exchange_counts.clear()
            chunked, _ = M.moe_block(p, x, cfg, dataclasses.replace(
                plan, ep_overlap=ovl))
        out["overlap"][case] = (mono.numpy(), chunked.numpy(),
                                dict(M.exchange_counts))

    for case in census_cases():
        arch, m, lay, algo, kind = case
        cfg, x = _cfg(arch), torch.from_numpy(inputs[arch]["x"])
        plan = _plan(meshes[m], lay, algo, "dropless")
        if kind is not None:
            plan = dataclasses.replace(plan, ep_overlap=overlap_for(
                tokens_local(plan, *X_SHAPE), cfg.top_k, kind))
        p = _moe_params(inputs, arch, plan)
        C.reset_counters()
        M.moe_block(p, x, cfg, plan)
        out["census"][case] = dict(C.counters)

    for case in stream_cases():
        arch, m, lay, algo, d = case
        cfg = _cfg(arch)
        spec = ServeSpec(arch=arch, strategy=lay, dispatch=d,
                         kernels="off", **SERVE)
        res = spec.resolve(mesh=meshes[m], device="cpu")
        if algo != "auto":          # the case's mixserve collectives
            res = dataclasses.replace(res, plan=dataclasses.replace(
                res.plan, comm_algo=algo))
        params = from_reference(inputs[arch]["params"], cfg,
                                plan=res.plan)
        llm = LLM.from_spec(res, cfg=cfg, params=params, device="cpu")
        out["streams"][case] = llm.generate(prompts(cfg.vocab_size),
                                            NEW_TOKENS)
        out["hits"][case] = llm.engine.kv.stats.n_prefix_hits
    return out
