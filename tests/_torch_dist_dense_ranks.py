"""Rank workers for tests/test_torch_dist_dense.py — imports no JAX.

The test process writes the reference's params and inputs as numpy into a
work directory; ``run_ranks`` starts 4 gloo ranks on the CPU, each running
``rank_main`` over every case below, and hands back what each computed:

* the sharded forward on the dense per-slot cache (``make_batched_cache``:
  the unified steps of ``_torch_dist_helpers.FWD_STEPS``; ``init_cache``:
  a uniform prefill of 8 rows, then two one-row decodes) and with no cache,
  with each rank's buffers, and the collectives of one dense step;
* ``LLM.generate`` with ``kv="dense"`` and with ``kv="paged"``;
* speculative decoding with the self draft and a foreign reduced draft
  (on the reference's draft weights, and ``make_draft``'s own), with the
  dense lengths after every verify step.
"""

import hashlib
import pathlib
import pickle

import numpy as np
import torch

import _torch_dist_helpers as H

# phi3.5 (GQA heads split, MoE), deepseek-v2 (MLA: a dense and an MoE
# layer), smollm (15/5 heads: not split over TP 2, replicated attention)
# and gemma (MQA: its one KV head does not split either)
ARCHS = ("phi3.5-moe-42b", "deepseek-v2-236b", "smollm-360m", "gemma-2b")
MESHES = H.MESHES                      # (data, model): 2x2 and 4x1
LAYOUTS = (("mixserve", "fused"), ("pure_tp", "auto"))
B, MAX_LEN = 4, 24
# a uniform prefill of 8 rows (cut along seq over TP 2), then two decodes
UNIFORM = (8, 1, 1)
STATELESS = (4, 8)                     # (batch, rows) of the stateless pass
SERVE = dict(max_batch=4, max_len=64, chunk=8)
# speculation: k 2 at chunk 8; (arch, mesh, kv, draft)
SPEC_K = 2
SPEC_NEW = 8
SPEC_CASES = (("phi3.5-moe-42b", (2, 2), "dense", "self"),
              ("phi3.5-moe-42b", (2, 2), "paged", "self"),
              ("smollm-360m", (4, 1), "dense", "self"),
              ("phi3.5-moe-42b", (2, 2), "dense", "smollm-360m"),
              ("phi3.5-moe-42b", (2, 2), "paged", "smollm-360m"),
              ("smollm-360m", (4, 1), "dense", "gemma-2b"))


def fwd_cases():
    return [(a, m, lay, algo, "sp") for a in ARCHS for m in MESHES
            for lay, algo in LAYOUTS]


def stream_cases():
    return [(a, m) for a in ARCHS for m in MESHES]


def spec_kw(draft):
    return dict(k=SPEC_K, draft=draft, min_accept=0.0)


def uniform_tokens(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, (B, s)).astype(np.int32) for s in UNIFORM]


def stateless_tokens(vocab):
    return np.random.default_rng(8).integers(
        0, vocab, STATELESS).astype(np.int32)


def step_tokens(vocab):
    rng = np.random.default_rng(6)
    return [rng.integers(0, vocab, (B, w)).astype(np.int32)
            for _, w in H.FWD_STEPS]


def _bufs(cache):
    return [{k: v.numpy().copy() for k, v in g.items()}
            for g in cache["groups"]]


def digest(tree) -> str:
    """One hash of every tensor of a params tree, in order."""
    h = hashlib.sha1()

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, list):
            for v in t:
                walk(v)
        else:
            h.update(t.detach().cpu().numpy().tobytes())
    walk(tree)
    return h.hexdigest()


def _forward_case(inputs, meshes, case):
    from repro_torch.bridge import from_reference
    from repro_torch.core import collectives as C
    from repro_torch.models import model as MOD
    from repro_torch.serving.kv_cache import make_batched_cache
    arch, m, lay, algo, _ = case
    cfg = H._cfg(arch)
    plan = H._plan(meshes[m], lay, algo, "dropless")
    params = from_reference(inputs[arch]["params"], cfg, plan=plan)
    vocab = cfg.vocab_size
    out = {"tp_index": plan.mesh.axis_index(plan.tp_axes),
           "rows": plan.rows(B), "heads_sharded": plan.heads_sharded(cfg)}

    def dense():
        return make_batched_cache(cfg, B, MAX_LEN, torch.float32, "cpu",
                                  plan)
    cache = dense()
    logits = []
    for (q_lens, _), toks in zip(H.FWD_STEPS, step_tokens(vocab)):
        o = MOD.forward(params, cfg, plan, tokens=torch.from_numpy(toks),
                        cache=cache,
                        q_lens=torch.tensor(q_lens, dtype=torch.int32),
                        expert_stats=cfg.is_moe)
        logits.append(o.logits.numpy())
    out["unified"] = {"logits": logits, "bufs": _bufs(cache),
                      "length": cache["length"].numpy()}
    cache = MOD.init_cache(cfg, B, MAX_LEN, torch.float32, "cpu", plan)
    logits = []
    for toks in uniform_tokens(vocab):
        logits.append(MOD.forward(params, cfg, plan,
                                  tokens=torch.from_numpy(toks),
                                  cache=cache).logits.numpy())
    out["uniform"] = {"logits": logits, "bufs": _bufs(cache),
                      "length": cache["length"].numpy()}
    o = MOD.forward(params, cfg, plan,
                    tokens=torch.from_numpy(stateless_tokens(vocab)))
    out["stateless"] = (o.logits.numpy(), o.cache is None)
    census = {}
    toks0 = step_tokens(vocab)[0]
    for q_lens, width in (H.FWD_STEPS[0], H.FWD_STEPS[-1]):
        C.reset_counters()
        MOD.forward(params, cfg, plan,
                    tokens=torch.from_numpy(toks0[:, :width]),
                    cache=dense(), q_lens=torch.tensor(q_lens,
                                                       dtype=torch.int32),
                    last_only=True)
        census[width] = dict(C.counters)
    return out, census


def _llm(inputs, meshes, arch, m, kv, speculation=None):
    from repro_torch.bridge import from_reference
    from repro_torch.serving.api import LLM, ServeSpec, SpeculationConfig
    cfg = H._cfg(arch)
    sc = "off" if speculation is None \
        else SpeculationConfig(**speculation)
    res = ServeSpec(arch=arch, strategy="mixserve", kernels="off", kv=kv,
                    speculation=sc, **SERVE).resolve(mesh=meshes[m],
                                                     device="cpu")
    return LLM.from_spec(res, cfg=cfg, params=from_reference(
        inputs[arch]["params"], cfg, plan=res.plan), device="cpu")


def _record_lengths(eng):
    """Wrap ``eng.unified_step`` to keep the device lengths after every
    step."""
    seen = []
    step = eng.unified_step

    def run(q):
        r = step(q)
        seen.append(eng.cache["length"].numpy().copy())
        return r
    eng.unified_step = run
    return seen


def _spec_case(inputs, meshes, case):
    from repro_torch.bridge import from_reference
    from repro_torch.serving.draft import ModelDraft
    arch, m, kv, draft = case
    llm = _llm(inputs, meshes, arch, m, kv, spec_kw(draft))
    eng = llm.engine
    own = None
    if draft != "self":      # make_draft's own weights, then the reference's
        d = eng.draft
        own = (digest(d.params), d.plan.enabled, d.cfg.name)
        eng.draft = ModelDraft(d.cfg, from_reference(
            inputs["drafts"][case], d.cfg), plan=d.plan,
            max_batch=eng.max_batch, max_len=eng.max_len,
            dtype=torch.float32, device="cpu")
    lengths = _record_lengths(eng)
    streams = llm.generate(H.prompts(llm.cfg.vocab_size), SPEC_NEW)
    return {"streams": streams, "stats": eng.spec_stats(),
            "lengths": lengths, "own": own,
            "draft_forwards": eng.draft.n_forward,
            "self_params": eng.draft.params is eng.params,
            "draft_cache_rows": int(next(iter(
                eng.draft.cache["groups"][0].values())).shape[1])}


def rank_main(rank, world, workdir):
    from repro_torch.launch.mesh import make_host_mesh
    inputs = pickle.loads((pathlib.Path(workdir) / "inputs.pkl")
                          .read_bytes())
    meshes = {m: make_host_mesh(*m) for m in MESHES}
    out = {"fwd": {}, "census": {}, "streams": {}, "spec": {}}
    for case in fwd_cases():
        out["fwd"][case], out["census"][case] = _forward_case(
            inputs, meshes, case)
    for arch, m in stream_cases():
        got = {}
        for kv in ("dense", "paged"):
            llm = _llm(inputs, meshes, arch, m, kv)
            got[kv] = (llm.generate(H.prompts(llm.cfg.vocab_size),
                                    H.NEW_TOKENS), llm.engine.kv.backend)
        out["streams"][(arch, m)] = got
    for case in SPEC_CASES:
        out["spec"][case] = _spec_case(inputs, meshes, case)
    return out
