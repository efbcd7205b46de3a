#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (one card,
the CUDA toolkit under /usr/local/cuda).  It imports only the port
(``src/repro_torch``), never JAX or the reference package ``repro``, and
exits non-zero, printing no result, when there is no CUDA device or no port
beside it.  Phases, each printing its own lines; any failure ends the run:

  0 card     nvidia-smi name and power limit, torch device name
  1 build    nvcc build of every kernel source (seconds, ptxas summary)
  2 kernels  each hand-written kernel against its plain PyTorch version at
             the main path's full-width phi3.5-moe-42b shapes, bf16 and f32,
             plus its contract cases; CUDA-event times beside the plain
             version and, where one exists, a single PyTorch call
  3 parity   f32, full width, 2 layers: the engine with kernels "on" against
             kernels "off" on the card — first-step logits within tolerance,
             greedy streams equal
  4 serve    bf16, full width, 8 layers (the 32-layer model is ~84 GB, over
             the card's 80 GB): LLM.from_spec(...) submit + stream (what
             LLM.generate runs) over 8 prompts of 64-1024 tokens, 4 sharing
             a 512-token prefix, 32 new tokens each; kernel launch counters
             read from this run only; then a short torch.profiler window
             on the same engine for the device-time breakdown

The line before the last is the ``kernels`` JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
PEAK_BF16 = 989e12      # H100 SXM dense bf16 FLOP/s (data sheet)
PEAK_F32 = 67e12        # H100 SXM float32 outside the tensor cores
HBM_BW = 3.35e12        # H100 SXM HBM3 bytes/s

# (name, source, the TPU kernel it replaces)
KERNELS = [
    ("flash_chunk_paged", "src/repro_torch/kernels/csrc/flash_chunk_paged.cu",
     "src/repro/kernels/flash_chunk.py:200"),
    ("topk_gate", "src/repro_torch/kernels/csrc/topk_gate.cu",
     "src/repro/kernels/topk_gate.py:45"),
    ("grouped_gemm", "src/repro_torch/kernels/csrc/grouped_gemm.cu",
     "src/repro/kernels/moe_gemm.py:151"),
]


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def cuda_ms(torch, fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(torch, a, b):
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def within(torch, got, want, atol, rtol):
    return bool(((got.float() - want.float()).abs()
                 <= atol + rtol * want.float().abs()).all())


# ---------------------------------------------------------------------------
# phase 0 + 1
# ---------------------------------------------------------------------------

def phase_card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    print(line)
    name = torch.cuda.get_device_name(0)
    print(f"[card] nvidia-smi: {line} | torch: {name} | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | devices "
          f"{torch.cuda.device_count()}")
    return line, name


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.load()
    secs = time.perf_counter() - t0
    print(f"[build] {len(build.sources())} sources -> one library in "
          f"{secs:.1f}s ({build.build_info['dir']})")
    for src, report in sorted(build.build_info["ptxas"].items()):
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", report)]
        spill = [int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                           report)]
        smem = [int(x) for x in re.findall(r"(\d+) bytes smem", report)]
        print(f"[build] {src}: {len(regs)} entry points, registers "
              f"max {max(regs, default=0)}, static smem max "
              f"{max(smem, default=0)} B, spill stores max "
              f"{max(spill, default=0)} B")
    return secs


# ---------------------------------------------------------------------------
# phase 2: kernels at the main path's shapes
# ---------------------------------------------------------------------------

def _paged_case(torch, rng, *, b, sq, nq, nkv, hd, page, nb, n_pages,
                q_off, q_len, kv_len, dtype, dev):
    """Random q / pools and block tables with distinct pages per slot;
    blocks past each slot's kv_len are -1."""
    import numpy as np
    bt = np.full((b, nb), -1, np.int32)
    perm = rng.permutation(n_pages)
    used = 0
    for i in range(b):
        need = -(-int(kv_len[i]) // page)
        bt[i, :need] = perm[used:used + need]
        used += need
    t = lambda a, dt=dtype: torch.from_numpy(np.asarray(a)).to(dev, dt)
    q = t(rng.standard_normal((b, sq, nq, hd), np.float32))
    kp = t(rng.standard_normal((n_pages, page, nkv, hd), np.float32))
    vp = t(rng.standard_normal((n_pages, page, nkv, hd), np.float32))
    i32 = torch.int32
    return (q, kp, vp, t(bt, i32), t(np.asarray(q_off, np.int32), i32),
            t(np.asarray(q_len, np.int32), i32),
            t(np.asarray(kv_len, np.int32), i32))


def _routing(rng, n_tok, n_exp, k, empty):
    """(E+1,) expert offsets of the top-k routing of random tokens, with
    expert ``empty`` unused."""
    import numpy as np
    logits = rng.standard_normal((n_tok, n_exp))
    logits[:, empty] = -np.inf
    ids = np.argsort(-logits, axis=1, kind="stable")[:, :k].reshape(-1)
    counts = np.bincount(ids, minlength=n_exp)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def phase_kernels(torch, shapes):
    import numpy as np
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    B, sq = shapes["max_batch"], shapes["chunk"]
    nq, nkv, hd, page = 32, 8, 128, 16
    nb = shapes["max_len"] // page
    n_pages = shapes["pool_pages"]
    E, K, H, D = 16, 2, 4096, 6400
    T = B * sq
    results = {}
    tol = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1.6e-2)}
    # flash_chunk_paged keeps its arithmetic in f32 and rounds once on
    # output, so its bf16 result is also held against the f32 plain version
    # on the same (upcast) inputs: half a bf16 ulp, 2^-9 relative, plus f32
    # summation-order noise
    flash_tol = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (5e-3, 1.6e-2)}
    flash_tol_vs_f32 = (1e-5, 4e-3)

    # -- flash_chunk_paged: a mixed step (prefill chunk mid-prompt, decode
    # deep in the cache, first chunk of a prompt, idle slot) ------------
    q_off = [512, 1000, 0, 0][:B] + [0] * max(0, B - 4)
    q_len = [sq, 1, 37, 0][:B] + [0] * max(0, B - 4)
    kv_len = [o + n for o, n in zip(q_off, q_len)]
    for dtype in (torch.bfloat16, torch.float32):
        args = _paged_case(torch, rng, b=B, sq=sq, nq=nq, nkv=nkv, hd=hd,
                           page=page, nb=nb, n_pages=n_pages, q_off=q_off,
                           q_len=q_len, kv_len=kv_len, dtype=dtype, dev=dev)
        got = ops.flash_chunk_paged(*args)
        want = ref.flash_chunk_paged_ref(*args)
        torch.cuda.synchronize()
        err = max_err(torch, got, want)
        ok = within(torch, got, want, *flash_tol[dtype])
        for i in range(B):   # rows past q_len (and idle slots) exactly 0
            ok &= bool((got[i, q_len[i]:] == 0).all())
        rec = {"dtype": str(dtype).split(".")[1], "max_err": err,
               "tol": list(flash_tol[dtype]), "ok": ok,
               "shape": f"q {tuple(args[0].shape)} pools "
                        f"{tuple(args[1].shape)} q_len {q_len}"}
        if dtype == torch.bfloat16:
            want32 = ref.flash_chunk_paged_ref(*(
                a.float() if a.is_floating_point() else a for a in args))
            ok_32 = within(torch, got, want32, *flash_tol_vs_f32)
            rec.update(max_err_vs_f32=max_err(torch, got, want32),
                       tol_vs_f32=list(flash_tol_vs_f32),
                       ok=ok and ok_32)
            ok = ok and ok_32
            rec["kernel_ms"] = cuda_ms(torch, lambda: ops.flash_chunk_paged(
                *args), 50)
            rec["plain_ms"] = cuda_ms(torch, lambda: ref.flash_chunk_paged_ref(
                *args), 10)
            rec["library_ms"] = None
            flops = sum(min(kv_len[i], q_off[i] + r + 1) * nq * 2 * (2 * hd)
                        for i in range(B) for r in range(q_len[i]))
            item = args[0].element_size()
            # q: only the sum(q_len) real rows are read; out: every row is
            # written (rows past q_len as zeros); K/V: each live slot's
            # prefix up to kv_len; tables and the three (B,) lengths
            bts = (sum(q_len) * nq * hd * item
                   + B * sq * nq * hd * item
                   + sum(kv_len[i] * nkv * 2 * hd * item
                         for i in range(B) if q_len[i] > 0)
                   + 4 * (args[3].numel() + 3 * B))
            rec.update(bytes=bts, flops=flops)
        print(f"[kernels] flash_chunk_paged {json.dumps(rec)}")
        check(ok, f"flash_chunk_paged {rec['dtype']} disagrees with its "
                  f"plain version: max err {err} (vs f32 "
                  f"{rec.get('max_err_vs_f32')})")
        results.setdefault("flash_chunk_paged", {})[rec["dtype"]] = rec
    # contracts: kv_len == 0 with live rows, q_len == 0, -1 tables
    args = _paged_case(torch, rng, b=3, sq=8, nq=nq, nkv=nkv, hd=hd,
                       page=page, nb=4, n_pages=8, q_off=[0, 0, 20],
                       q_len=[3, 0, 5], kv_len=[0, 0, 25],
                       dtype=torch.float32, dev=dev)
    got = ops.flash_chunk_paged(*args)
    want = ref.flash_chunk_paged_ref(*args)
    ok = (bool((got[:2] == 0).all()) and bool((got[2, 5:] == 0).all())
          and within(torch, got, want, 1e-4, 1e-4)
          and bool((args[3] == -1).any()))
    print(f"[kernels] flash_chunk_paged contracts (kv_len=0, q_len=0, "
          f"-1 tables, rows past q_len): ok={ok}")
    check(ok, "flash_chunk_paged contract case failed")

    # -- topk_gate on the router logits of the (B, chunk) step ----------
    for dtype in (torch.bfloat16, torch.float32):
        lg = torch.from_numpy(rng.standard_normal((T, E), np.float32)) \
            .to(dev, dtype)
        lg[0] = 0.5                      # all tied -> ids 0, 1
        lg[1, 5] = lg[1, 3] = 4.0        # tied top pair -> ids 3, 5
        w, i = ops.topk_gate(lg, K)
        w_r, i_r = ref.topk_gate_ref(lg, K)
        torch.cuda.synchronize()
        err = max_err(torch, w, w_r)
        ok = (bool((i == i_r).all()) and err <= 1e-6
              and i[0].tolist() == [0, 1] and i[1].tolist() == [3, 5])
        rec = {"dtype": str(dtype).split(".")[1], "max_err": err,
               "tol": [1e-6, 0.0], "ids_equal": bool((i == i_r).all()),
               "ok": ok, "shape": f"logits {tuple(lg.shape)} k={K}"}
        if dtype == torch.bfloat16:
            rec["kernel_ms"] = cuda_ms(torch, lambda: ops.topk_gate(lg, K),
                                       200)
            rec["plain_ms"] = cuda_ms(torch, lambda: ref.topk_gate_ref(lg, K),
                                      50)
            rec["library_ms"] = None
            rec.update(bytes=lg.numel() * 2 + T * K * 8, flops=5 * T * E)
        print(f"[kernels] topk_gate {json.dumps(rec)}")
        check(ok, f"topk_gate {rec['dtype']} disagrees with its plain "
                  f"version (ids or weights, err {err})")
        results.setdefault("topk_gate", {})[rec["dtype"]] = rec

    # -- grouped_gemm: the w_in / w_gate GEMM of the step (N = T*k rows,
    # H -> D) and the w_out GEMM (D -> H); timed at the first ----------
    n = T * K
    offs = _routing(rng, T, E, K, empty=7)
    cases = [(dtype, h_in, d_out, label)
             for h_in, d_out, label in ((H, D, ""), (D, H, " w_out"))
             for dtype in (torch.bfloat16, torch.float32)]
    for dtype, h_in, d_out, label in cases:
        x = torch.from_numpy(rng.standard_normal((n, h_in), np.float32)) \
            .to(dev, dtype)
        w = (torch.randn(E, h_in, d_out, device=dev) * h_in ** -0.5) \
            .to(dtype)
        off = torch.from_numpy(offs).to(dev)
        got = ops.grouped_gemm(x, w, off)
        want = ref.grouped_gemm_ref(x, w, off)
        torch.cuda.synchronize()
        err = max_err(torch, got, want)
        ok = within(torch, got, want, *tol[dtype])
        rec = {"dtype": str(dtype).split(".")[1] + label, "max_err": err,
               "tol": list(tol[dtype]), "ok": ok,
               "shape": f"x {tuple(x.shape)} w {tuple(w.shape)} "
                        f"empty expert 7"}
        if dtype == torch.bfloat16 and not label:
            rec["kernel_ms"] = cuda_ms(torch, lambda: ops.grouped_gemm(
                x, w, off), 10)
            rec["plain_ms"] = cuda_ms(torch, lambda: ref.grouped_gemm_ref(
                x, w, off), 3)
            rec["library_ms"] = _grouped_mm_ms(torch, x, w, off, want)
            used = int((np.diff(offs) > 0).sum())
            rec.update(bytes=(x.numel() + used * h_in * d_out + n * d_out)
                       * 2 + 4 * (E + 1),
                       flops=2 * int(offs[-1]) * h_in * d_out)
        print(f"[kernels] grouped_gemm {json.dumps(rec)}")
        check(ok, f"grouped_gemm {rec['dtype']} disagrees with its plain "
                  f"version: max err {err}")
        results.setdefault("grouped_gemm", {})[rec["dtype"]] = rec
        del x, w
        torch.cuda.empty_cache()
    # contracts: rows past offsets[-1] exactly zero, boundary in a tile
    x = torch.randn(200, 64, device=dev)
    w = torch.randn(4, 64, 48, device=dev)
    off = torch.tensor([0, 37, 37, 90, 150], dtype=torch.int32, device=dev)
    got = ops.grouped_gemm(x, w, off)
    ok = (bool((got[150:] == 0).all())
          and within(torch, got, ref.grouped_gemm_ref(x, w, off), 1e-4, 1e-4))
    print(f"[kernels] grouped_gemm contracts (empty expert, boundary inside "
          f"a tile, rows past offsets[-1]): ok={ok}")
    check(ok, "grouped_gemm contract case failed")
    return results


def _grouped_mm_ms(torch, x, w, off, want):
    """One PyTorch call for the same function, where this torch has it."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        print("[kernels] grouped_gemm yardstick: torch._grouped_mm absent")
        return None
    ends = off[1:].contiguous()
    try:
        got = fn(x, w, offs=ends)
        torch.cuda.synchronize()
    except RuntimeError as e:
        print(f"[kernels] grouped_gemm yardstick: torch._grouped_mm "
              f"refused: {str(e).splitlines()[0][:160]}")
        return None
    if not within(torch, got, want, 1e-2, 1.6e-2):
        print("[kernels] grouped_gemm yardstick: torch._grouped_mm result "
              "differs; not used")
        return None
    return cuda_ms(torch, lambda: fn(x, w, offs=ends), 10)


# ---------------------------------------------------------------------------
# phase 3 + 4: the engine
# ---------------------------------------------------------------------------

def _phi(layers):
    import repro_torch.configs as C
    full = C.get("phi3.5-moe-42b")
    return dataclasses.replace(full, n_layers=layers,
                               name=f"phi3.5-moe-42b-{layers}L")


def phase_parity(torch):
    import numpy as np
    from repro_torch.models.model import init_params
    from repro_torch.serving.api import LLM, ServeSpec
    from repro_torch.serving.engine import Request
    cfg = _phi(2)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    params = init_params(gen, cfg, torch.float32, "cuda")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (40, 100, 200, 150)]
    engines, first = {}, {}
    for kern in ("on", "off"):
        llm = LLM.from_spec(
            ServeSpec(kernels=kern, kv="paged", reduced=False, max_batch=4,
                      max_len=256, chunk=32, prompt_len=200,
                      max_new_tokens=8), cfg=cfg, params=params,
            device="cuda", dtype=torch.float32)
        eng = llm.engine
        reqs = [Request(rid=i, prompt=p, max_new_tokens=8)
                for i, p in enumerate(prompts)]
        for r in reqs:
            check(eng.admit(r), "parity: admission failed")
        q = eng.plan_q_lens(llm.spec.token_budget)
        eng.unified_step(q)
        first[kern] = (q, eng.last_logits.clone())
        while eng.n_active:
            eng.step(llm.spec.token_budget)
        engines[kern] = [list(r.out_tokens) for r in reqs]
        del llm, eng
        torch.cuda.empty_cache()
    q = first["on"][0]
    check((q == first["off"][0]).all(), "parity: plans differ")
    live = torch.from_numpy(q > 0).cuda()
    err = max_err(torch, first["on"][1][live], first["off"][1][live])
    equal = engines["on"] == engines["off"]
    print(f"[parity] f32 full width 2 layers: first-step logits max err "
          f"{err:.3e} (tol 1e-3), greedy streams equal: {equal}")
    check(err <= 1e-3, f"parity: first-step logits differ by {err}")
    check(equal, f"parity: streams differ\n on={engines['on']}\n "
                 f"off={engines['off']}")
    del params
    torch.cuda.empty_cache()
    return {"logits_max_err": err, "streams_equal": equal}


def phase_serve(torch, card_line):
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serving.api import LLM, ServeSpec
    cfg = _phi(8)
    rng = np.random.default_rng(2)
    shared = rng.integers(0, cfg.vocab_size, 512).astype(np.int32)
    tail = lambda n: rng.integers(0, cfg.vocab_size, n).astype(np.int32)
    # one shared-prefix prompt first, its siblings last: they are admitted
    # after it finishes and find its pages in the prefix index
    prompts = ([np.concatenate([shared, tail(100)])]
               + [tail(n) for n in (64, 1024, 300)]
               + [np.concatenate([shared, tail(n)]) for n in (40, 250, 480)]
               + [tail(700)])
    spec = ServeSpec(kernels="auto", kv="paged", reduced=False, max_batch=4,
                     prompt_len=1024, max_new_tokens=32, seed=0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    llm = LLM.from_spec(spec, cfg=cfg, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    print(f"[serve] {cfg.name} bf16 weights ready in {t_load:.1f}s; "
          f"resolved:\n{llm.spec.describe()}")
    eng = llm.engine
    ops.reset_counters()
    n0 = eng.n_forward
    t0 = time.perf_counter()
    t_sub = {llm.submit(p, 32): time.perf_counter() for p in prompts}
    t_tok: dict = {}
    outs: dict = {}
    for rid, tok in llm.stream():
        t_tok.setdefault(rid, []).append(time.perf_counter())
        outs.setdefault(rid, []).append(tok)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.counters)
    steps = eng.n_forward - n0
    n_tok = sum(len(v) for v in outs.values())
    ttft = [t_tok[r][0] - t_sub[r] for r in t_sub]
    itl = [(t_tok[r][-1] - t_tok[r][0]) / (len(t_tok[r]) - 1)
           for r in t_sub if len(t_tok[r]) > 1]
    hits = eng.kv.stats.n_prefix_hits
    print(f"[serve] {len(prompts)} requests, {n_tok} new tokens, {steps} "
          f"unified steps in {wall:.2f}s: {n_tok / wall:.1f} tok/s, TTFT "
          f"mean {np.mean(ttft) * 1e3:.0f} ms / max {max(ttft) * 1e3:.0f} "
          f"ms, ITL mean {np.mean(itl) * 1e3:.1f} ms, prefix hits {hits}, "
          f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB "
          f"[{card_line}]")
    print(f"[serve] kernel launches {launches} (expect 8/8/24 per step)")
    check(all(len(outs.get(r, [])) == 32 for r in t_sub),
          "serve: a request did not finish with 32 tokens")
    check(all(0 <= t < cfg.vocab_size for v in outs.values() for t in v),
          "serve: token id outside the vocabulary")
    check(hits >= 1, "serve: no prefix hit")
    want = {"flash_chunk_paged": 8 * steps, "topk_gate": 8 * steps,
            "grouped_gemm": 24 * steps}
    check(steps > 0 and all(launches.get(k, 0) == v
                            for k, v in want.items()),
          f"serve: launch counters {launches} != {want}")
    phase_profile(torch, llm, rng)
    return {"launches": launches, "steps": steps, "tok_s": n_tok / wall,
            "ttft_ms": float(np.mean(ttft) * 1e3),
            "itl_ms": float(np.mean(itl) * 1e3), "prefix_hits": hits,
            "max_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "shapes": {"max_batch": llm.spec.max_batch,
                       "chunk": eng.chunk, "max_len": eng.max_len,
                       "pool_pages": eng.kv.n_pages}}


def phase_profile(torch, llm, rng):
    """Where the device time goes: torch.profiler over a short extra run
    on the same engine (4 fresh prompts of 256 tokens, 8 new tokens each;
    not part of the counted main-path run).  Prints each kernel family's
    share of device time and the device's idle share of the window."""
    from torch.profiler import ProfilerActivity, profile
    prompts = [rng.integers(0, llm.cfg.vocab_size, 256).astype("int32")
               for _ in range(4)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        llm.generate(prompts, 8)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    groups = {"flash_chunk_paged": 0.0, "topk_gate": 0.0,
              "grouped_gemm": 0.0, "other": 0.0}
    top = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0)
        if us <= 0 or ev.device_type.name != "CUDA":
            continue
        key = next((k for k in groups if k in ev.key), "other")
        groups[key] += us
        if key == "other":
            top.append((us, ev.key[:60]))
    busy = sum(groups.values())
    if busy <= 0:
        print("[profile] device time: not measured (the profiler reported "
              "no CUDA kernel time)")
        return
    shares = {k: round(v / busy, 4) for k, v in groups.items()}
    print(f"[profile] 4x256-token prompts + 8 new tokens: window "
          f"{wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms, idle "
          f"share {max(0.0, 1 - busy / wall_us):.3f} (profiler on); "
          f"device-time shares {json.dumps(shares)}")
    top.sort(reverse=True)
    print("[profile] largest other kernels: " + "; ".join(
        f"{name} {us / 1e3:.1f} ms" for us, name in top[:5]))


def kernels_record(kres, serve):
    out = []
    for name, source, replaces in KERNELS:
        r = kres[name]["bfloat16"]
        t_bytes = r["bytes"] / HBM_BW
        t_ops = r["flops"] / (PEAK_F32 if name == "topk_gate" else PEAK_BF16)
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": int(serve["launches"].get(name, 0)),
            "max_abs_err": max(kres[name][d]["max_err"]
                               for d in kres[name]),
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": r["library_ms"],
            "max_err": {d: kres[name][d]["max_err"] for d in kres[name]},
            "tol": {d: kres[name][d]["tol"] for d in kres[name]},
            "ok": all(kres[name][d]["ok"] for d in kres[name]),
            "kernel_ms": r["kernel_ms"], "shape": r["shape"],
        })
    return out


def main() -> int:
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").exists():
        print("chip_smoke: no src/repro_torch beside this script; run it "
              "from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card_line, name = phase_card(torch)
    phase_build()
    # the serve phase's envelope fixes the kernel shapes; resolve it first
    # (cheap, host only) so phase 2 times exactly what phase 4 launches
    from repro_torch.serving.api import ServeSpec
    res = ServeSpec(kernels="auto", kv="paged", reduced=False, max_batch=4,
                    prompt_len=1024, max_new_tokens=32).resolve(
                        _phi(8), device="cuda")
    shapes = {"max_batch": res.max_batch, "chunk": res.chunk,
              "max_len": res.max_len, "pool_pages": res.kv.pool_pages}
    kres = phase_kernels(torch, shapes)
    phase_parity(torch)
    serve = phase_serve(torch, card_line)
    check(serve["shapes"] == shapes,
          f"serve ran {serve['shapes']}, kernels were checked at {shapes}")
    rec = kernels_record(kres, serve)
    check(all(k["ok"] and k["launches"] > 0 for k in rec),
          "a kernel failed or never launched on the main path")
    print(f"[done] {time.perf_counter() - t_start:.1f}s [{card_line}]")
    print(json.dumps({"kernels": rec}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
