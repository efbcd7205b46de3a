"""Rank workers for tests/test_torch_dist.py — imports no JAX.

The test process (which imports both packages) writes the reference's
inputs as numpy into a work directory; ``run_ranks`` then starts 4 gloo
ranks on the CPU, each running ``rank_main`` over every case, and hands
back what each rank computed.  The cases are named here so that the test
file can parametrise over them before the ranks run.

Forward cases run the whole sharded ``forward`` (embedding, attention on
the rank's heads, dense MLP, MoE, LM head; the residual stream cut along
seq with ``sp`` on) over FWD_STEPS on a paged cache, both with every
row's logits and with ``last_only``.
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
# speculative decoding on the mesh: the n-gram draft (a model draft needs
# the dense cache, not ported on a mesh), bigram matches, 12 new tokens
SPEC_CASE = ("phi3.5-moe-42b", (2, 2), "mixserve", "fused", "dropless",
             "ngram")
SPEC = dict(k=2, draft="ngram", ngram=2, min_accept=0.0)
SPEC_NEW_TOKENS = 12
# the whole forward: a GQA MoE model (heads split over TP), an MLA model
# with a dense and an MoE layer, and smollm, whose 15/5 heads do not split
# over TP 2 (replicated attention beside a TP dense MLP, tied embedding)
FWD_ARCHS = ("phi3.5-moe-42b", "deepseek-v2-236b", "smollm-360m")
# the dense GQA models, in one layout: gemma's MQA (one KV head, which
# does not split over TP: its attention whole on every rank, as smollm's)
# and minitron's 8/2 heads (split)
FWD_DENSE_ARCHS = ("gemma-2b", "minitron-8b")
FWD_LAYOUTS = (("mixserve", "fused"), ("dp_ep", "auto"), ("pure_tp", "auto"))
SPS = ("sp", "nosp")
FWD_B, FWD_PAGE, FWD_MAX_LEN = 4, 4, 16
# (q_lens, width): prefill, decode and mixed steps 8 rows wide (the
# residual stream splits over TP 2), then a width-1 step (it does not:
# MLA's absorbed regime, and the attention output all-reduced)
FWD_STEPS = (([8, 5, 0, 3], 8), ([1, 1, 0, 1], 8), ([1, 7, 3, 8], 8),
             ([1, 1, 1, 0], 1))
# a prefix written by a slot of the second batch rank (slot 2) and hit by
# a slot of the first (slot 0): the pool's pages must hold every batch
# rank's rows (prompt lengths; "p<n>" = the shared 16-token prefix + n)
CROSS_DP = (("40", 12), ("40", 12), ("p3", 2), ("40", 12), ("20", 12),
            ("p7", 4))


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
    """The MoE cases, then smollm (replicated-attention fallback), the
    residual stream whole (``nosp``), and a prefix hit across batch
    ranks (``cross_dp``)."""
    return moe_cases() + [
        ("smollm-360m", m, lay, algo, "dropless") for m in MESHES
        for lay, algo in (("mixserve", "fused"), ("pure_tp", "auto"))] + [
        (a, (2, 2), "mixserve", "fused", "dropless", "nosp")
        for a in ARCHS] + [
        (a, (2, 2), lay, algo, "dropless", "cross_dp")
        for a in ("phi3.5-moe-42b", "smollm-360m")
        for lay, algo in (("mixserve", "fused"), ("pure_tp", "auto"))]


def fwd_cases():
    return [(a, m, lay, algo, sp) for a in FWD_ARCHS for m in MESHES
            for lay, algo in FWD_LAYOUTS for sp in SPS] + [
        (a, (2, 2), "mixserve", "fused", "sp") for a in FWD_DENSE_ARCHS]


def tree_cases():
    return [(a, m, lay) for a in FWD_ARCHS for m in MESHES
            for lay, _ in FWD_LAYOUTS]


COLL_CASES = ("all_gather_seq", "all_gather_vocab", "psum_scatter_seq",
              "psum")


def case_id(case) -> str:
    return "-".join(f"{v[0]}x{v[1]}" if isinstance(v, tuple) else str(v)
                    for v in case)


def cross_dp_prompts(vocab: int):
    """CROSS_DP's prompts and their token budgets."""
    rng = np.random.default_rng(5)
    pre = rng.integers(0, vocab, 16).astype(np.int32)
    out = []
    for spec, _ in CROSS_DP:
        if spec.startswith("p"):
            out.append(np.concatenate([
                pre, rng.integers(0, vocab, int(spec[1:])).astype(np.int32)]))
        else:
            out.append(rng.integers(0, vocab, int(spec)).astype(np.int32))
    return out, [n for _, n in CROSS_DP]


def drain(llm, prompts, news):
    """Serve each prompt with its own token budget; outputs in order."""
    rids = [llm.submit(p, n) for p, n in zip(prompts, news)]
    outs = {r: [] for r in rids}
    for rid, tok in llm.stream():
        outs[rid].append(tok)
    return [outs[r] for r in rids]


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


def _plan(mesh, layout, algo, dispatch, ep_overlap=None, sp=True):
    from repro_torch.core.partitioner import make_plan
    return make_plan(layout, mesh, "fused" if algo == "auto" else algo,
                     dispatch=dispatch, ep_overlap=ep_overlap, sp=sp)


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
    from repro_torch.serving.api import LLM, ServeSpec, SpeculationConfig

    inputs = pickle.loads((pathlib.Path(workdir) / "inputs.pkl")
                          .read_bytes())
    meshes = {m: make_host_mesh(*m) for m in MESHES}
    out = {"moe": {}, "moe_rank": {}, "overlap": {}, "census": {},
           "streams": {}, "hits": {}, "fwd": {}, "fwd_census": {},
           "coll": _collectives(meshes[(2, 2)])}

    for case in moe_cases():
        arch, m, lay, algo, d = case
        plan = _plan(meshes[m], lay, algo, d)
        p, x = _moe_params(inputs, arch, plan), \
            torch.from_numpy(inputs[arch]["x"])
        y, _ = M.moe_block(p, x, _cfg(arch), plan)
        out["moe"][case] = y.numpy()
        # the forward's per-rank entry on this rank's seq block of its
        # batch rows: the same rows of the wrapper's output, bit for bit
        seq = plan.seq_sharded(x.shape[1])
        x_loc = plan.cut_seq(plan.shard(x, ("batch",)), seq)
        y_loc, _ = M.moe_rank(p, x_loc, _cfg(arch), plan, seq_sharded=seq)
        want = plan.cut_seq(plan.shard(y, ("batch",)), seq)
        out["moe_rank"][case] = (seq, bool(torch.equal(y_loc, want)))

    for case in fwd_cases():
        out["fwd"][case], out["fwd_census"][case] = _forward_case(
            inputs, meshes, case)

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
        arch, m, lay, algo, d = case[:5]
        kind = case[5] if len(case) > 5 else None
        cfg = _cfg(arch)
        spec = ServeSpec(arch=arch, strategy=lay, dispatch=d,
                         kernels="off", **SERVE)
        res = spec.resolve(mesh=meshes[m], device="cpu",
                           sp=kind != "nosp")
        if algo != "auto":          # the case's mixserve collectives
            res = dataclasses.replace(res, plan=dataclasses.replace(
                res.plan, comm_algo=algo))
        params = from_reference(inputs[arch]["params"], cfg,
                                plan=res.plan)
        llm = LLM.from_spec(res, cfg=cfg, params=params, device="cpu")
        if kind == "cross_dp":
            out["streams"][case] = drain(llm, *cross_dp_prompts(
                cfg.vocab_size))
        else:
            out["streams"][case] = llm.generate(prompts(cfg.vocab_size),
                                                NEW_TOKENS)
        out["hits"][case] = llm.engine.kv.stats.n_prefix_hits

    arch, m, lay, _, d, _ = SPEC_CASE
    cfg = _cfg(arch)
    res = ServeSpec(arch=arch, strategy=lay, dispatch=d, kernels="off",
                    speculation=SpeculationConfig(**SPEC), **SERVE).resolve(
        mesh=meshes[m], device="cpu")
    llm = LLM.from_spec(res, cfg=cfg, params=from_reference(
        inputs[arch]["params"], cfg, plan=res.plan), device="cpu")
    out["spec"] = (llm.generate(prompts(cfg.vocab_size), SPEC_NEW_TOKENS),
                   llm.engine.spec_stats(), type(llm.engine.draft).__name__)
    return out


def _collectives(mesh):
    """The collectives the sharded forward adds, along seq (dim 1) and
    vocab (the last dim), over the TP and the batch axes of a 2x2 mesh:
    (result, the same from every rank's block by hand, contiguous,
    counters)."""
    from repro_torch.core import collectives as C
    out = {}
    n = mesh.size
    # every rank's (2, 4, 6) block, distinct values
    blocks = [torch.arange(48, dtype=torch.float32).reshape(2, 4, 6)
              + 100 * r for r in range(n)]
    me = blocks[mesh.rank]
    for axes in (("model",), ("data",)):
        group = mesh.group_ranks(axes)
        mine = [blocks[r] for r in group]
        for name in COLL_CASES:
            C.reset_counters()
            if name == "all_gather_seq":
                got = C.all_gather(me, mesh, axes, axis=1)
                want = torch.cat(mine, 1)
            elif name == "all_gather_vocab":
                got = C.all_gather(me, mesh, axes, axis=-1)
                want = torch.cat(mine, -1)
            elif name == "psum_scatter_seq":
                got = C.psum_scatter(me, mesh, axes, scatter_dimension=1)
                blk = 4 // len(group)
                j = group.index(mesh.rank)
                want = sum(mine)[:, j * blk:(j + 1) * blk]
            else:
                got = C.psum(me, mesh, axes)
                want = sum(mine)
            out[(name, axes)] = (bool(torch.equal(got, want)),
                                 got.is_contiguous(), dict(C.counters))
    return out


def _forward_case(inputs, meshes, case):
    """One forward case on this rank: FWD_STEPS on two paged caches (every
    row's logits on one, ``last_only`` on the other), then the census of
    one forward at each width on a fresh cache."""
    from repro_torch.bridge import from_reference
    from repro_torch.core import collectives as C
    from repro_torch.models import model as MOD
    arch, m, lay, algo, sp = case
    cfg = _cfg(arch)
    plan = _plan(meshes[m], lay, algo, "dropless", sp=sp == "sp")
    fin = inputs["fwd"][arch]
    params = from_reference(inputs[arch]["params"], cfg, plan=plan)

    def cache():
        c = MOD.init_paged_cache(cfg, FWD_B, FWD_MAX_LEN,
                                 page_size=FWD_PAGE,
                                 pool_pages=fin["n_pages"],
                                 dtype=torch.float32, device="cpu",
                                 plan=plan)
        c["block_tables"].copy_(torch.from_numpy(fin["bt"]))
        return c
    caches = {False: cache(), True: cache()}
    steps = []
    for (q_lens, _), toks in zip(FWD_STEPS, fin["tokens"]):
        rec = {}
        for last_only, c in caches.items():
            o = MOD.forward(params, cfg, plan, tokens=torch.from_numpy(toks),
                            cache=c, q_lens=torch.tensor(q_lens,
                                                         dtype=torch.int32),
                            last_only=last_only, expert_stats=cfg.is_moe)
            rec[last_only] = (o.logits.numpy(), float(o.aux),
                              None if o.expert_counts is None
                              else o.expert_counts.numpy())
        steps.append(rec)
    c = caches[False]
    res = {"steps": steps, "length": c["length"].numpy(),
           "pools": [{k: v.numpy() for k, v in g.items()}
                     for g in c["groups"]],
           "tp_index": plan.mesh.axis_index(plan.tp_axes),
           "dp_index": plan.mesh.axis_index(plan.dp_axes),
           "heads_sharded": plan.heads_sharded(cfg)}
    census = {}
    for q_lens, width in (FWD_STEPS[0], FWD_STEPS[-1]):
        toks = fin["tokens"][0][:, :width]
        C.reset_counters()
        MOD.forward(params, cfg, plan, tokens=torch.from_numpy(toks),
                    cache=cache(), q_lens=torch.tensor(q_lens,
                                                       dtype=torch.int32),
                    last_only=True)
        census[width] = dict(C.counters)
    return res, census


def options_rank(rank, world):
    """tests/test_torch_guard.py's serve options on one rank of the 2x2
    mixserve mesh, at reduced widths: the stateless forward and the
    forward on a dense cache (smollm), a self and a foreign draft's
    proposals, a ``kv="dense"`` serve, and the legacy serves of the four
    families the unified step cannot serve; shapes and greedy streams."""
    from repro_torch.core.partitioner import make_plan
    from repro_torch.core.resolve import SpeculationConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as MOD
    from repro_torch.serving.api import LLM, ServeSpec
    from repro_torch.serving.draft import make_draft
    import repro_torch.configs as TC
    mesh = make_host_mesh(2, 2)
    cfg = TC.get_reduced("smollm-360m")
    plan = make_plan("mixserve", mesh)
    params = MOD.init_params(torch.Generator().manual_seed(0), cfg,
                             torch.float32, "cpu", plan=plan)
    tokens = torch.zeros(4, 8, dtype=torch.int64)
    out = {"stateless": tuple(MOD.forward(params, cfg, plan,
                                          tokens=tokens).logits.shape)}
    cache = MOD.init_cache(cfg, 4, 16, torch.float32, "cpu", plan)
    out["dense"] = tuple(MOD.forward(params, cfg, plan, tokens=tokens,
                                     cache=cache).logits.shape)
    out["dense_length"] = int(cache["length"])
    ctx = {0: np.arange(1, 12), 3: np.arange(5, 9)}
    for draft in ("self", "gemma-2b"):
        d = make_draft(SpeculationConfig(k=2, draft=draft), cfg, params,
                       plan=plan, max_batch=4, max_len=32,
                       dtype=torch.float32, device="cpu")
        out[draft] = {s: p.tolist() for s, p in
                      d.propose(ctx, {0: 2, 3: 2}).items()}
    rng = np.random.default_rng(0)
    out["streams"] = {}
    for arch, kv in (("smollm-360m", "dense"), ("rwkv6-1.6b", "auto"),
                     ("recurrentgemma-9b", "auto"),
                     ("whisper-tiny", "auto"), ("qwen2-vl-7b", "auto")):
        c = TC.get_reduced(arch)
        llm = LLM.from_spec(ServeSpec(arch=arch, max_batch=4, max_len=64,
                                      chunk=8, kv=kv, strategy="mixserve"),
                            mesh=mesh, device="cpu")
        prompts = [rng.integers(0, c.vocab_size, n).astype(np.int32)
                   for n in (5, 9)]
        out["streams"][arch] = (llm.generate(prompts, 2),
                                llm.engine.legacy, llm.engine.kv.backend)
    return out
