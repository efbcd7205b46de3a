"""Rank workers for tests/test_torch_dist_legacy.py — imports no JAX.

The test process writes the reference's params (every zero-initialised
recurrent leaf and norm drawn) and the layer inputs as numpy into a work
directory; ``run_ranks`` starts 4 gloo ranks on the CPU, each running
``rank_main``, and hands back what each computed:

* RWKV6's time- and channel-mix and the RG-LRU block on the rank's rows,
  heads / channels and (with ``sp`` at TP 2) seq block, with their carried
  states;
* the stateless forward of the four legacy families;
* ``LLM.generate`` on the legacy blocking path, and the ring a blocking
  prefill leaves in a slot of the second batch rank.
"""

import pathlib
import pickle

import numpy as np
import torch

import _torch_dist_helpers as H

FAMILIES = ("rwkv6-1.6b", "recurrentgemma-9b", "whisper-tiny",
            "qwen2-vl-7b")
MESHES = H.MESHES                      # (data, model): 2x2 and 4x1
# (layer, mesh, sp): at TP 2 an 8-row input is cut along seq with sp on
LAYER_CASES = tuple((k, m, sp) for k in ("rwkv", "rglru") for m, sp in
                    (((2, 2), "sp"), ((2, 2), "nosp"), ((4, 1), "sp")))
X_SHAPE = (4, 8)                       # (batch, rows) of the layer input
FWD_SHAPE = (4, 8)                     # the stateless forward's tokens
LENS = (20, 32, 70)
NEW = 6
SERVE = dict(kv="auto", max_batch=4, max_len=256, chunk=8)
# (arch, embeds stub): whisper's default frames; qwen2-vl with a seeded
# patch stub and without one
STREAM_KINDS = (("rwkv6-1.6b", None), ("recurrentgemma-9b", None),
                ("whisper-tiny", None), ("qwen2-vl-7b", "seeded"),
                ("qwen2-vl-7b", None))


def stream_cases():
    return [(a, kind, m) for a, kind in STREAM_KINDS for m in MESHES]


def fwd_cases():
    return [(a, m) for a in FAMILIES for m in MESHES]


def prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in LENS]


def fwd_tokens(vocab):
    return np.random.default_rng(9).integers(0, vocab, FWD_SHAPE).astype(
        np.int32)


def embeds_stub(cfg):
    """qwen2-vl's seeded patch stub (1, n_frontend_tokens, d_model)."""
    return (0.02 * np.random.default_rng(3).standard_normal(
        (1, cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32)


def frames(cfg, b):
    """Whisper's default stub: frames of 0.01."""
    e = cfg.encoder
    return np.full((b, e.n_frames, e.d_model), 0.01, np.float32)


def fwd_kwargs(cfg, b):
    """The frontend inputs of a forward of ``b`` rows (numpy)."""
    if cfg.family == "audio":
        return {"frames": frames(cfg, b)}
    if cfg.frontend == "vision_stub":
        return {"embeds": np.repeat(embeds_stub(cfg), b, 0)}
    return {}


def layer_inputs(cfg, kind):
    """x (b, s, h) and the carried states, from numpy seeds."""
    from repro_torch.core.partitioner import rwkv_heads
    rng = np.random.default_rng(11)
    b, s = X_SHAPE
    h = cfg.d_model
    x = rng.standard_normal((b, s, h)).astype(np.float32)
    if kind == "rwkv":
        nh = rwkv_heads(cfg)
        hd = h // nh
        return {"x": x,
                "state": 0.1 * rng.standard_normal((b, nh, hd, hd)).astype(
                    np.float32),
                "x_tm": rng.standard_normal((b, 1, h)).astype(np.float32),
                "x_cm": rng.standard_normal((b, 1, h)).astype(np.float32)}
    w, cw = cfg.lru_width, cfg.conv1d_width
    return {"x": x,
            "lru": rng.standard_normal((b, w)).astype(np.float32),
            "conv": rng.standard_normal((b, cw - 1, w)).astype(np.float32)}


def _cfg(kind):
    import repro_torch.configs as TC
    return TC.get_reduced("rwkv6-1.6b" if kind == "rwkv"
                          else "recurrentgemma-9b")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _layer_case(inputs, meshes, case):
    from repro_torch.bridge import from_reference
    from repro_torch.core import collectives as C
    from repro_torch.models import ssm as S
    kind, m, sp = case
    cfg = _cfg(kind)
    plan = H._plan(meshes[m], "mixserve", "fused", "dropless",
                   sp=sp == "sp")
    arch = "rwkv6-1.6b" if kind == "rwkv" else "recurrentgemma-9b"
    tree = from_reference(inputs[arch]["params"], cfg, plan=plan)
    inp = inputs["layers"][kind]
    b, s = X_SHAPE
    seq = plan.seq_sharded(s)
    rows = plan.rows(b)
    tp, j = plan.tp, C.axis_index(plan.mesh, plan.tp_axes)

    def cut(a, axis, n_all):           # this rank's block of a channel axis
        n = n_all // tp
        return np.take(a, range(j * n, (j + 1) * n), axis=axis)
    x = plan.cut_seq(_t(inp["x"][rows]), seq)
    C.reset_counters()
    if kind == "rwkv":
        heads = plan.heads_sharded(cfg)
        st = inp["state"][rows]
        if heads:
            st = cut(st, 1, st.shape[1])
        p = tree["groups"][0][0]
        t_out, (state, x_tm) = S.rwkv6_time_mix(
            p["tm"], x, cfg, plan, state=_t(st),
            x_prev=_t(inp["x_tm"][rows]), seq_sharded=seq)
        c_out, x_cm = S.rwkv6_channel_mix(
            p["cm"], x, cfg, plan, x_prev=_t(inp["x_cm"][rows]),
            seq_sharded=seq)
        res = {"t_out": t_out.numpy(), "c_out": c_out.numpy(),
               "state": state.numpy(), "x_tm": x_tm.numpy(),
               "x_cm": x_cm.numpy(), "heads_sharded": heads}
    else:
        p = tree["groups"][0][0]["l0"]["rglru"]
        lru, conv = inp["lru"][rows], inp["conv"][rows]
        if tp > 1:
            lru = cut(lru, 1, lru.shape[1])
            conv = cut(conv, 2, conv.shape[2])
        out, (lru, conv) = S.rglru_block(p, x, cfg, plan, state=_t(lru),
                                         conv_state=_t(conv),
                                         seq_sharded=seq)
        res = {"out": out.numpy(), "lru": lru.numpy(), "conv": conv.numpy()}
    res.update(rows=rows, seq=seq, tp=tp, tp_index=j,
               census={(k, tuple(a)): n for (k, a), n in C.counters.items()})
    return res


def _fwd_case(inputs, meshes, case):
    from repro_torch.bridge import from_reference
    from repro_torch.models import model as MOD
    import repro_torch.configs as TC
    arch, m = case
    cfg = TC.get_reduced(arch)
    plan = H._plan(meshes[m], "mixserve", "fused", "dropless")
    params = from_reference(inputs[arch]["params"], cfg, plan=plan)
    kw = {k: _t(v) for k, v in fwd_kwargs(cfg, FWD_SHAPE[0]).items()}
    o = MOD.forward(params, cfg, plan,
                    tokens=_t(fwd_tokens(cfg.vocab_size)), **kw)
    return o.logits.numpy()


def _stream_case(inputs, meshes, case):
    from repro_torch.bridge import from_reference
    from repro_torch.serving.api import LLM, ServeSpec
    import repro_torch.configs as TC
    arch, kind, m = case
    cfg = TC.get_reduced(arch)
    res = ServeSpec(arch=arch, strategy="mixserve", kernels="off",
                    **SERVE).resolve(mesh=meshes[m], device="cpu")
    efn = None
    if kind == "seeded":
        stub = embeds_stub(cfg)
        efn = lambda b: {"embeds": _t(np.repeat(stub, b, 0))}  # noqa: E731
    llm = LLM.from_spec(res, cfg=cfg, params=from_reference(
        inputs[arch]["params"], cfg, plan=res.plan), device="cpu",
        embeds_fn=efn)
    eng = llm.engine
    out = {"streams": llm.generate(prompts(cfg.vocab_size), NEW),
           "legacy": eng.legacy, "backend": eng.kv.backend,
           "n_prefill": eng.n_prefill, "rows": res.plan.rows(
               res.max_batch)}
    if arch == "recurrentgemma-9b":
        # three blocking prefills, the 70-token prompt in slot 2: its ring
        # lies on the rank whose rows hold slot 2
        from repro_torch.serving.engine import Request
        llm2 = LLM.from_spec(res, cfg=cfg, params=llm.params, device="cpu")
        e2 = llm2.engine
        for rid, p in enumerate(prompts(cfg.vocab_size)):
            assert e2.admit(Request(rid=rid, prompt=p, max_new_tokens=4))
        rows = res.plan.rows(res.max_batch)
        kp = e2.cache["groups"][0]["l2"]["kpos"][0]
        out["kpos"] = {slot: sorted(kp[slot - rows.start].tolist())
                       for slot in range(rows.start, rows.stop)}
        out["length"] = e2.cache["length"].tolist()
    return out


def rank_main(rank, world, workdir):
    from repro_torch.launch.mesh import make_host_mesh
    inputs = pickle.loads((pathlib.Path(workdir) / "inputs.pkl")
                          .read_bytes())
    meshes = {m: make_host_mesh(*m) for m in MESHES}
    out = {"layers": {}, "fwd": {}, "streams": {}}
    for case in LAYER_CASES:
        out["layers"][case] = _layer_case(inputs, meshes, case)
    for case in fwd_cases():
        out["fwd"][case] = _fwd_case(inputs, meshes, case)
    for case in stream_cases():
        out["streams"][case] = _stream_case(inputs, meshes, case)
    return out
