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
             the shapes each serve phase below resolves to (phi3.5-moe-42b
             and deepseek-v2-236b, full width, dropless and capacity
             dispatch; one rank of the distributed serve: its router
             gate, and its EP exchange's gathers, grouped GEMMs and
             combine at the row cap and at the worst-case extent), bf16
             and f32, plus its contract cases (for the grouped GEMM's
             per-segment schedule: 1-row segments, one expert holding all
             rows, boundaries at every residue mod 16 and mod 64, rows past
             offsets[-1]; for attention: split-KV boundaries, q_len 0 with
             kv_len 0, paged == dense bitwise), and the router gate also
             at the paper's routers (qwen3-235b and deepseek-r1, k 8, at a
             served step and at the largest auto-resolved one);
             times beside the plain version, the bound and, where one
             exists, a single PyTorch call: ``ms`` by CUDA events over
             back-to-back wrapper calls (the host's launch path
             included), ``device_ms`` from 20 calls captured in a CUDA
             graph and replayed (device only); the same two times of an
             empty kernel, the card's per-launch floor (``launch_floor``);
             then the two gather wrappers' host microseconds per call, cut
             into their parts, and the router's device ops and host
             microseconds per MoE layer around its kernel
  3 parity   f32, full width: capacity-dispatch moe_local with kernels on
             against off on one input, with drops; then the engine (2
             layers) with kernels "on" against kernels "off" on the card —
             phi3.5 (chunk 32), deepseek with expanded MLA (chunk 32) and
             with absorbed MLA (chunk 1), and both models in capacity mode
             with a capacity factor at which nothing drops; first-step
             logits within 1e-3, greedy streams equal
  4 serve    bf16, full width: LLM.from_spec(...) submit + stream (what
             LLM.generate runs), kernel launch counters read from each run
             only, exact per step:
               phi3.5, 8 of 32 layers (the 32-layer model is ~84 GB, over
               the card's 80 GB): 8 prompts of 64-1024 tokens, 4 sharing a
               512-token prefix, 32 new tokens each; dropless, then the
               same prompts with dispatch="capacity" on the same weights;
               deepseek-v2, 4 of 60 layers (1 dense + 3 MoE; 60 layers are
               ~470 GB): 6 prompts of 64-512 tokens, 3 sharing a 256-token
               prefix, 16 new tokens each (expanded MLA, dense flash_chunk);
               then 2 prompts of 16-24 tokens at chunk=1, 4 new tokens
               (absorbed MLA, flash_decode); then the first serve's prompts
               with dispatch="capacity";
             a torch.profiler window on each long serve's engine for the
             device-time breakdown (phi3.5 dropless and capacity, deepseek
             dropless)
  5 dist     MixServe's sharded MoE on 4 ranks, a 2x2 (data, model) mesh:
             4 processes on this card over gloo (with 4 cards, one rank per
             card over NCCL), the kernel library built once above and only
             loaded by the ranks.
             (a) f32, phi3.5 2 layers, full width: moe_block and
                 LLM.generate under mixserve fused, mixserve unfused,
                 dp_ep and pure_tp, dropless and capacity (no-drop
                 factor), plus the micro-chunked exchange with the auto
                 row cap and an 8-row cap that overflows, each against the
                 unsharded run on the same weights (moe_block to 1e-4,
                 greedy streams equal);
             (b) bf16, phi3.5 8 layers, full width, mixserve fused,
                 dropless, the resolved ep_overlap: 4 prompts of 64-512
                 tokens (2 sharing a prefix), 16 new tokens; streams equal
                 on every rank, exact launch counts per step and exchange
                 chunk, ep_load_stats and the A2A byte ledger; times
                 labelled as ranks sharing one card

The line before the last is the ``kernels`` JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
PEAK_BF16 = 989e12      # H100 SXM dense bf16 FLOP/s (data sheet)
PEAK_F32 = 67e12        # H100 SXM float32 outside the tensor cores
HBM_BW = 3.35e12        # H100 SXM HBM3 bytes/s
CSRC = "src/repro_torch/kernels/csrc/"

# (name, source, the TPU kernel it replaces)
KERNELS = [
    ("flash_chunk_paged", CSRC + "flash_chunk_paged.cu",
     "src/repro/kernels/flash_chunk.py:200"),
    ("flash_chunk", CSRC + "flash_chunk.cu",
     "src/repro/kernels/flash_chunk.py:110"),
    ("topk_gate", CSRC + "topk_gate.cu", "src/repro/kernels/topk_gate.py:45"),
    ("grouped_gemm", CSRC + "grouped_gemm.cu",
     "src/repro/kernels/moe_gemm.py:151"),
    ("moe_gemm", CSRC + "moe_gemm.cu", "src/repro/kernels/moe_gemm.py:51"),
    ("permute_tokens", CSRC + "permute.cu",
     "src/repro/kernels/permute.py:60"),
    ("permute_tokens_ragged", CSRC + "permute.cu",
     "src/repro/kernels/permute.py:118"),
    ("unpermute_tokens", CSRC + "permute.cu",
     "src/repro/kernels/permute.py:183"),
]

# profiler kernel-name pattern -> kernel family (first match wins)
PROFILE_GROUPS = [("unpermute_kernel", "unpermute_tokens"),
                  ("permute_ragged_kernel", "permute_tokens_ragged"),
                  ("permute_kernel", "permute_tokens"),
                  ("PagedKV", "flash_chunk_paged"),
                  ("DenseKV", "flash_chunk"),
                  ("topk_gate_kernel", "topk_gate"),
                  ("grouped_gemm_kernel", "grouped_gemm"),
                  ("moe_gemm_kernel", "moe_gemm")]


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


def graph_ms(torch, fn, calls=20, replays=5):
    """Device-only ms per call: ``calls`` calls of fn captured in one CUDA
    graph, the graph replayed ``replays`` times between two CUDA events.
    The host's launch path drops out; each call's kernels and the gaps
    between the graph's nodes remain."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):            # warm-up off the capture
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    del g
    return start.elapsed_time(end) / (replays * calls)


def time_rec(torch, rec, run, iters, plain, plain_iters, library=None):
    """A timed record's times: the wrapper over ``iters`` back-to-back
    calls (CUDA events: the host's launch path included) and its device
    time (``graph_ms``), the plain version (None for a record that has
    none), and ``library`` (one PyTorch call for the same function,
    already held to the plain version, or None) by both methods."""
    rec["kernel_ms"] = cuda_ms(torch, run, iters)
    rec["device_ms"] = graph_ms(torch, run)
    rec["plain_ms"] = None if plain is None else \
        cuda_ms(torch, plain, plain_iters)
    rec["library_ms"] = rec["library_device_ms"] = None
    if library is not None:
        rec["library_ms"] = cuda_ms(torch, library, iters)
        try:
            rec["library_device_ms"] = graph_ms(torch, library)
        except RuntimeError as e:
            print(f"[kernels] {rec['label']}: the library call does not "
                  f"capture in a CUDA graph: {str(e).splitlines()[0][:160]}")


def host_us(torch, fn, calls=2000):
    """Host microseconds per call: ``calls`` calls back to back on the
    host clock, one synchronize at the end (after a warm-up)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def max_err(torch, a, b):
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def within(torch, got, want, atol, rtol):
    return bool(((got.float() - want.float()).abs()
                 <= atol + rtol * want.float().abs()).all())


def digest(torch, *ts) -> str:
    """A short hash of the tensors' bytes: equal digests on two trees show
    bitwise-equal inputs or outputs."""
    import hashlib
    h = hashlib.sha1()
    for t in ts:
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def dname(dt) -> str:
    return str(dt).split(".")[1]


def free_memory(torch):
    gc.collect()
    torch.cuda.empty_cache()


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
# phase 2: kernels at the serve phases' shapes
# ---------------------------------------------------------------------------

# float32: summation-order noise; bf16: one bf16 rounding step of the result
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1.6e-2)}
# attention keeps its arithmetic in f32 and rounds once on output, so its
# bf16 result is also held against the f32 plain version on the same
# (upcast) inputs: half a bf16 ulp, 2^-9 relative, plus f32 summation noise
FLASH_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (5e-3, 1.6e-2)}
FLASH_TOL_VS_F32 = (1e-5, 4e-3)
# the combine accumulates in f32 and rounds once: within one bf16 ulp
# (2^-7 relative) of the bf16 plain version, half an ulp of the f32 one
UNPERMUTE_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-6, 2 ** -7)}
UNPERMUTE_TOL_VS_F32 = (1e-6, 2 ** -8)


def _upcast(args):
    return tuple(a.float() if a.is_floating_point() else a for a in args)


def _i32(torch, a, dev):
    import numpy as np
    return torch.from_numpy(np.asarray(a, np.int32)).to(dev)


def _paged_case(torch, rng, *, b, sq, nq, nkv, hd, page, nb, n_pages,
                q_off, q_len, kv_len, dtype, dev, hdv=None):
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
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dev, dtype)
    q = t(rng.standard_normal((b, sq, nq, hd), np.float32))
    kp = t(rng.standard_normal((n_pages, page, nkv, hd), np.float32))
    vp = t(rng.standard_normal((n_pages, page, nkv, hdv or hd), np.float32))
    return (q, kp, vp, _i32(torch, bt, dev), _i32(torch, q_off, dev),
            _i32(torch, q_len, dev), _i32(torch, kv_len, dev))


def _dense_case(torch, rng, *, b, sq, nq, nkv, hd, hdv, skv, q_off, q_len,
                kv_len, dtype, dev):
    import numpy as np
    t = lambda shape: torch.from_numpy(
        rng.standard_normal(shape, np.float32)).to(dev, dtype)
    return (t((b, sq, nq, hd)), t((b, skv, nkv, hd)), t((b, skv, nkv, hdv)),
            _i32(torch, q_off, dev), _i32(torch, q_len, dev),
            _i32(torch, kv_len, dev))


def _routing(rng, n_tok, n_exp, k, empty):
    """(E+1,) expert offsets and the (T*k,) expert-sorted slot order of the
    top-k routing of random tokens, with expert ``empty`` unused."""
    import numpy as np
    logits = rng.standard_normal((n_tok, n_exp))
    logits[:, empty] = -np.inf
    ids = np.argsort(-logits, axis=1, kind="stable")[:, :k].reshape(-1)
    counts = np.bincount(ids, minlength=n_exp)
    order = np.argsort(ids, kind="stable")
    return (np.concatenate([[0], np.cumsum(counts)]).astype(np.int32),
            order.astype(np.int32))


def _attn_work(q_off, q_len, kv_len, nq, nkv, hd, hdv, item):
    """(bytes, flops) attention must move and do for these lengths: q at
    its sum(q_len) real rows, every output row written (callers pass the
    output's element count separately), K/V to each live slot's kv_len."""
    flops = sum(min(kv_len[i], q_off[i] + r + 1) * nq * 2 * (hd + hdv)
                for i in range(len(q_len)) for r in range(q_len[i]))
    bts = (sum(q_len) * nq * hd * item
           + sum(kv_len[i] * nkv * (hd + hdv) * item
                 for i in range(len(q_len)) if q_len[i] > 0)
           + 4 * 3 * len(q_len))
    return bts, flops


def _sdpa_call(torch, q, k, v, q_off, q_len, kv_len, scale, want):
    """One PyTorch call for ragged causal attention on a dense cache:
    scaled_dot_product_attention with the explicit boolean mask, held to
    the plain version on the rows that see at least one key; None where
    this torch refuses it or disagrees."""
    import torch.nn.functional as F
    b, sq, nq, _ = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    row = torch.arange(sq, device=q.device)[None, :, None]
    pos = torch.arange(skv, device=q.device)[None, None, :]
    mask = ((row < q_len.long()[:, None, None])
            & (pos < kv_len.long()[:, None, None])
            & (pos <= q_off.long()[:, None, None] + row))[:, None]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kw = dict(attn_mask=mask, scale=scale, enable_gqa=nq != nkv)
    try:
        got = F.scaled_dot_product_attention(qt, kt, vt, **kw)
        torch.cuda.synchronize()
    except (RuntimeError, TypeError) as e:
        print(f"[kernels] attention yardstick: scaled_dot_product_attention "
              f"refused: {str(e).splitlines()[0][:160]}")
        return None
    live = mask.any(-1)[:, 0]                               # (b, sq)
    if not within(torch, got.transpose(1, 2)[live], want[live], 1e-2,
                  1.6e-2):
        print("[kernels] attention yardstick: scaled_dot_product_attention "
              "result differs; not used")
        return None
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw)


def _grouped_mm_call(torch, x, w, off, want):
    """One PyTorch call for the same function, where this torch has it and
    it agrees with the plain version; else None."""
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
    # _grouped_mm leaves the rows at/after offsets[-1] unwritten (the
    # kernel zeroes them): compare the routed rows only
    routed = int(off[-1])
    if not within(torch, got[:routed], want[:routed], 1e-2, 1.6e-2):
        print("[kernels] grouped_gemm yardstick: torch._grouped_mm result "
              "differs; not used")
        return None
    return lambda: fn(x, w, offs=ends)


class Results:
    """Per-kernel check records; timed ones carry bytes/flops/peak."""

    def __init__(self):
        self.recs: dict = {}

    def add(self, name, rec, msg):
        print(f"[kernels] {name} {json.dumps(rec)}")
        check(rec["ok"], f"{name} {rec['label']}: {msg} (max err "
                         f"{rec['max_err']})")
        self.recs.setdefault(name, []).append(rec)


def check_flash_paged(torch, rng, res, sh, dev):
    """The phi3.5 serve's mixed step: prefill chunk mid-prompt, decode deep
    in the cache, first chunk of a prompt, idle slot."""
    ops, ref = _ops()
    B, sq = sh["max_batch"], sh["chunk"]
    nq, nkv, hd, page = 32, 8, 128, 16
    q_off = [512, 1000, 0, 0][:B] + [0] * max(0, B - 4)
    q_len = [sq, 1, 37, 0][:B] + [0] * max(0, B - 4)
    kv_len = [o + n for o, n in zip(q_off, q_len)]
    for dtype in (torch.bfloat16, torch.float32):
        d = dname(dtype)
        args = _paged_case(torch, rng, b=B, sq=sq, nq=nq, nkv=nkv, hd=hd,
                           page=page, nb=sh["max_len"] // page,
                           n_pages=sh["pool_pages"], q_off=q_off,
                           q_len=q_len, kv_len=kv_len, dtype=dtype, dev=dev)
        got = ops.flash_chunk_paged(*args)
        want = ref.flash_chunk_paged_ref(*args)
        torch.cuda.synchronize()
        ok = within(torch, got, want, *FLASH_TOL[d])
        ok &= all(bool((got[i, q_len[i]:] == 0).all()) for i in range(B))
        rec = {"label": f"phi3.5 {d}", "max_err": max_err(torch, got, want),
               "tol": list(FLASH_TOL[d]), "ok": ok,
               "shape": f"q {tuple(args[0].shape)} pools "
                        f"{tuple(args[1].shape)} q_len {q_len}"}
        if dtype == torch.bfloat16:
            want32 = ref.flash_chunk_paged_ref(*_upcast(args))
            rec.update(max_err_vs_f32=max_err(torch, got, want32),
                       tol_vs_f32=list(FLASH_TOL_VS_F32))
            rec["ok"] = ok and within(torch, got, want32, *FLASH_TOL_VS_F32)
            time_rec(torch, rec, lambda: ops.flash_chunk_paged(*args), 50,
                     lambda: ref.flash_chunk_paged_ref(*args), 10)
            bts, flops = _attn_work(q_off, q_len, kv_len, nq, nkv, hd, hd, 2)
            rec.update(bytes=bts + got.numel() * 2 + 4 * args[3].numel(),
                       flops=flops, peak="bf16", primary=True)
        res.add("flash_chunk_paged", rec, "disagrees with its plain version")


def check_flash_dense(torch, rng, res, sh, sh1, dev):
    """flash_chunk at the deepseek serve's expanded-MLA step (g = 1,
    hd 192 / hdv 128) and, through flash_decode, at the chunk=1 serve's
    absorbed step (nkv = 1, g = 128, hd 576 / hdv 512)."""
    ops, ref = _ops()
    B, sq, S = sh["max_batch"], sh["chunk"], sh["max_len"]
    nq, hd, hdv = 128, 192, 128
    scale = 192 ** -0.5
    q_off = [S - 64 - sq, S - 76, 0, 0][:B]
    q_len = [sq, 1, 37, 0][:B]
    kv_len = [o + n for o, n in zip(q_off, q_len)]
    for dtype in (torch.bfloat16, torch.float32):
        d = dname(dtype)
        args = _dense_case(torch, rng, b=B, sq=sq, nq=nq, nkv=nq, hd=hd,
                           hdv=hdv, skv=S, q_off=q_off, q_len=q_len,
                           kv_len=kv_len, dtype=dtype, dev=dev)
        got = ops.flash_chunk(*args, scale=scale)
        want = ref.flash_chunk_ref(*args, scale)
        torch.cuda.synchronize()
        ok = within(torch, got, want, *FLASH_TOL[d])
        ok &= all(bool((got[i, q_len[i]:] == 0).all()) for i in range(B))
        rec = {"label": f"deepseek expanded {d}",
               "max_err": max_err(torch, got, want),
               "tol": list(FLASH_TOL[d]), "ok": ok,
               "shape": f"q {tuple(args[0].shape)} k {tuple(args[1].shape)} "
                        f"v {tuple(args[2].shape)} q_len {q_len}"}
        if dtype == torch.bfloat16:
            want32 = ref.flash_chunk_ref(*_upcast(args), scale)
            rec.update(max_err_vs_f32=max_err(torch, got, want32),
                       tol_vs_f32=list(FLASH_TOL_VS_F32))
            rec["ok"] = ok and within(torch, got, want32, *FLASH_TOL_VS_F32)
            time_rec(torch, rec, lambda: ops.flash_chunk(*args, scale=scale),
                     20, lambda: ref.flash_chunk_ref(*args, scale), 5,
                     _sdpa_call(torch, *args, scale, want))
            bts, flops = _attn_work(q_off, q_len, kv_len, nq, nq, hd, hdv, 2)
            rec.update(bytes=bts + got.numel() * 2, flops=flops, peak="bf16",
                       primary=True)
        res.add("flash_chunk", rec, "disagrees with its plain version")
        del args, got, want
    free_memory(torch)

    # flash_decode at the absorbed step of the chunk=1 serve, and at a
    # cache as long as the expanded serve's
    B1, S1 = sh1["max_batch"], sh1["max_len"]
    nq, hd, hdv = 128, 576, 512
    for S_, lens in ((S1, [S1, 1, S1 // 2 + 5, 0][:B1]),
                     (S, [S, 1, 300, 0][:B])):
        for dtype in (torch.bfloat16, torch.float32):
            d = dname(dtype)
            b = len(lens)
            q, k, v, *_ = _dense_case(torch, rng, b=b, sq=1, nq=nq, nkv=1,
                                      hd=hd, hdv=hdv, skv=S_, q_off=lens,
                                      q_len=lens, kv_len=lens, dtype=dtype,
                                      dev=dev)
            q = q[:, 0].contiguous()
            ln = _i32(torch, lens, dev)
            got = ops.flash_decode(q, k, v, ln, scale=scale)
            want = ref.flash_decode_ref(q, k, v, ln, scale)
            torch.cuda.synchronize()
            ok = (within(torch, got, want, *FLASH_TOL[d])
                  and bool((got[3] == 0).all()))
            rec = {"label": f"flash_decode absorbed S={S_} {d}",
                   "max_err": max_err(torch, got, want),
                   "tol": list(FLASH_TOL[d]), "ok": ok,
                   "shape": f"q {tuple(q.shape)} k {tuple(k.shape)} v "
                            f"{tuple(v.shape)} lengths {lens}"}
            if dtype == torch.bfloat16:
                want32 = ref.flash_decode_ref(q.float(), k.float(), v.float(),
                                              ln, scale)
                rec.update(max_err_vs_f32=max_err(torch, got, want32),
                           tol_vs_f32=list(FLASH_TOL_VS_F32))
                rec["ok"] = ok and within(torch, got, want32,
                                          *FLASH_TOL_VS_F32)
            if dtype == torch.bfloat16 and S_ == S1:
                q_off = [max(n - 1, 0) for n in lens]
                q_len = [min(n, 1) for n in lens]
                lib = _sdpa_call(torch, q[:, None], k, v, *(
                    _i32(torch, a, dev) for a in (q_off, q_len, lens)),
                    scale, want[:, None])
                time_rec(torch, rec,
                         lambda: ops.flash_decode(q, k, v, ln, scale=scale),
                         50, lambda: ref.flash_decode_ref(q, k, v, ln, scale),
                         10, lib)
                bts, flops = _attn_work(q_off, q_len, lens, nq, 1, hd, hdv, 2)
                rec.update(bytes=bts + got.numel() * 2, flops=flops,
                           peak="bf16")
            res.add("flash_chunk", rec, "flash_decode disagrees with its "
                                        "plain version")


def check_flash_contracts(torch, rng, dev):
    """kv_len == 0 with live rows, q_len == 0, -1 tables, rows past q_len;
    the dense kernel on the MLA shapes likewise; paged output bitwise equal
    to dense at equal tiles."""
    ops, ref = _ops()
    args = _paged_case(torch, rng, b=3, sq=8, nq=32, nkv=8, hd=128,
                       page=16, nb=4, n_pages=8, q_off=[0, 0, 20],
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
    for label, nq, nkv, hd, hdv in (("expanded", 128, 128, 192, 128),
                                    ("absorbed", 128, 1, 576, 512)):
        args = _dense_case(torch, rng, b=4, sq=3, nq=nq, nkv=nkv, hd=hd,
                           hdv=hdv, skv=48, q_off=[30, 37, 0, 0],
                           q_len=[3, 1, 0, 2], kv_len=[33, 38, 0, 0],
                           dtype=torch.float32, dev=dev)
        got = ops.flash_chunk(*args)
        ok = (within(torch, got, ref.flash_chunk_ref(*args), 1e-4, 1e-4)
              and bool((got[1, 1:] == 0).all())
              and bool((got[2:] == 0).all()))
        # the same cache as pages in shuffled order, bf16: bitwise equal
        q, k, v, q_off, q_len, kv_len = (
            a.to(torch.bfloat16) if a.is_floating_point() else a
            for a in args)
        bt = torch.randperm(12, device=dev).reshape(4, 3).to(torch.int32)
        kp = torch.empty(12, 16, nkv, hd, dtype=k.dtype, device=dev)
        vp = torch.empty(12, 16, nkv, hdv, dtype=v.dtype, device=dev)
        kp[bt.long()] = k.reshape(4, 3, 16, nkv, hd)
        vp[bt.long()] = v.reshape(4, 3, 16, nkv, hdv)
        same = torch.equal(ops.flash_chunk(q, k, v, q_off, q_len, kv_len),
                           ops.flash_chunk_paged(q, kp, vp, bt, q_off, q_len,
                                                 kv_len))
        print(f"[kernels] flash_chunk contracts at the {label} MLA shape "
              f"(kv_len=0, q_len=0, rows past q_len): ok={ok}; paged == "
              f"dense bitwise: {same}")
        check(ok and same, f"flash_chunk {label} contract case failed")


def check_flash_split(torch, rng, dev):
    """The bf16 body's split-KV walk at split boundaries: a grid of few
    CTAs over a long cache, so ops.flash_plan splits every query tile's KV
    range (at the phi3.5, expanded and absorbed head shapes), with a slot
    whose q_len and kv_len are 0.  Held to the plain version (FLASH_TOL), to
    the f32 plain version (FLASH_TOL_VS_F32), zero rows exact, and paged ==
    dense bitwise through shuffled pages."""
    ops, ref = _ops()
    ok = True
    splits = []
    for nq, nkv, hd, hdv in ((32, 8, 128, 128), (8, 8, 192, 128),
                             (128, 1, 576, 512)):
        q, k, v, q_off, q_len, kv_len = _dense_case(
            torch, rng, b=3, sq=2, nq=nq, nkv=nkv, hd=hd, hdv=hdv, skv=1024,
            q_off=[990, 500, 0], q_len=[2, 1, 0], kv_len=[992, 501, 0],
            dtype=torch.bfloat16, dev=dev)
        splits.append(ops.flash_plan(3, 2, nq, nkv, hd, hdv)[1])
        got = ops.flash_chunk(q, k, v, q_off, q_len, kv_len)
        want = ref.flash_chunk_ref(q, k, v, q_off, q_len, kv_len)
        want32 = ref.flash_chunk_ref(q.float(), k.float(), v.float(), q_off,
                                     q_len, kv_len)
        ok &= within(torch, got, want, *FLASH_TOL["bfloat16"])
        ok &= within(torch, got, want32, *FLASH_TOL_VS_F32)
        ok &= bool((got[1, 1:] == 0).all()) and bool((got[2] == 0).all())
        bt = torch.randperm(3 * 64, device=dev).reshape(3, 64) \
            .to(torch.int32)
        kp = torch.empty(3 * 64, 16, nkv, hd, dtype=k.dtype, device=dev)
        vp = torch.empty(3 * 64, 16, nkv, hdv, dtype=v.dtype, device=dev)
        kp[bt.long()] = k.reshape(3, 64, 16, nkv, hd)
        vp[bt.long()] = v.reshape(3, 64, 16, nkv, hdv)
        ok &= torch.equal(got, ops.flash_chunk_paged(q, kp, vp, bt, q_off,
                                                     q_len, kv_len))
    print(f"[kernels] flash_chunk split-KV (splits {splits} over 992 / 501 "
          f"keys, a q_len 0 / kv_len 0 slot; vs plain, vs f32, paged == "
          f"dense bitwise): ok={ok}")
    check(ok and min(splits) > 1, "flash_chunk split-KV case failed")


def check_topk(torch, rng, res, T, E, K, label, dev, primary):
    """The router gate at (T, E) k K, bf16 and f32: row 0 all tied (ids
    0, 1, ...), row 1 a tied top pair (ids 3, 5), row 2 -inf in every
    other entry (zero probabilities, still picked lowest id first); ids
    equal to the plain version's, weights within 1e-6.  Each record
    carries the digests of its weights, its ids and its logits."""
    import numpy as np
    ops, ref = _ops()
    for dtype in (torch.bfloat16, torch.float32):
        d = dname(dtype)
        lg = torch.from_numpy(rng.standard_normal((T, E), np.float32)) \
            .to(dev, dtype)
        lg[0] = 0.5                      # all tied -> ids 0, 1, ...
        lg[1, 5] = lg[1, 3] = 6.0        # tied top pair -> ids 3, 5
        lg[2, 1::2] = -math.inf          # zero probabilities
        w, i = ops.topk_gate(lg, K)
        w_r, i_r = ref.topk_gate_ref(lg, K)
        torch.cuda.synchronize()
        err = max_err(torch, w, w_r)
        ok = (bool((i == i_r).all()) and err <= 1e-6
              and i[0].tolist() == list(range(K))
              and i[1].tolist()[:2] == [3, 5])
        rec = {"label": f"{label} {d}", "max_err": err, "tol": [1e-6, 0.0],
               "ids_equal": bool((i == i_r).all()), "ok": ok,
               "digest": digest(torch, w), "ids_digest": digest(torch, i),
               "input_digest": digest(torch, lg),
               "shape": f"logits {tuple(lg.shape)} k={K}"}
        if dtype == torch.bfloat16:
            time_rec(torch, rec, lambda: ops.topk_gate(lg, K), 200,
                     lambda: ref.topk_gate_ref(lg, K), 50)
            rec.update(bytes=lg.numel() * 2 + T * K * 8, flops=5 * T * E,
                       peak="f32", primary=primary)
        res.add("topk_gate", rec, "disagrees with its plain version (ids or "
                                  "weights)")


def check_launch_floor(torch, res):
    """The card's per-launch floor: an empty kernel (one CTA of one warp)
    through its C entry, timed as the kernels are (``kernel_ms`` with the
    host's launch path, ``device_ms`` by graph replay).  It is the bound a
    kernel of a few microseconds is held to.  A tree whose library has no
    such kernel prints so and records none."""
    from repro_torch.kernels import build
    ops, _ = _ops()
    lib = build.load()
    if not hasattr(lib, "rt_launch_floor"):
        print("[kernels] launch_floor: no rt_launch_floor in this tree's "
              "library; not recorded")
        return
    rec = {"label": "empty kernel", "max_err": 0.0, "tol": [0.0, 0.0],
           "ok": True, "shape": "1 CTA x 32 threads, no work"}
    time_rec(torch, rec, lambda: ops._launch(lib.rt_launch_floor,
                                             ops._stream()), 200, None, 0)
    res.add("launch_floor", rec, "failed")


def check_grouped_gemm(torch, rng, res, offs, n, H, D, label, dev,
                       primary):
    """The w_in / w_gate GEMM of n rows whose expert segments are the
    (E+1,) offsets ``offs`` (H -> D) and the w_out GEMM (D -> H); timed at
    the first.  Rows past offs[-1] come back zero."""
    import numpy as np
    ops, ref = _ops()
    E = len(offs) - 1
    empty = [int(i) for i in np.flatnonzero(np.diff(offs) == 0)]
    for h_in, d_out, part in ((H, D, ""), (D, H, " w_out")):
        for dtype in (torch.bfloat16, torch.float32):
            d = dname(dtype)
            x = torch.from_numpy(rng.standard_normal((n, h_in), np.float32)) \
                .to(dev, dtype)
            w = (torch.randn(E, h_in, d_out, device=dev) * h_in ** -0.5) \
                .to(dtype)
            off = _i32(torch, offs, dev)
            got = ops.grouped_gemm(x, w, off)
            want = ref.grouped_gemm_ref(x, w, off)
            torch.cuda.synchronize()
            rec = {"label": f"{label} {d}{part}",
                   "max_err": max_err(torch, got, want),
                   "tol": list(TOL[d]),
                   "ok": within(torch, got, want, *TOL[d]),
                   "shape": f"x {tuple(x.shape)} w {tuple(w.shape)}, "
                            f"{int(offs[-1])} routed rows, empty experts "
                            f"{empty}"}
            if dtype == torch.bfloat16 and not part:
                time_rec(torch, rec, lambda: ops.grouped_gemm(x, w, off), 10,
                         lambda: ref.grouped_gemm_ref(x, w, off), 3,
                         _grouped_mm_call(torch, x, w, off, want))
                used = int((np.diff(offs) > 0).sum())
                rec.update(bytes=(int(offs[-1]) * h_in + used * h_in * d_out
                                  + n * d_out) * 2 + 4 * (E + 1),
                           flops=2 * int(offs[-1]) * h_in * d_out,
                           peak="bf16", primary=primary)
            res.add("grouped_gemm", rec, "disagrees with its plain version")
            del x, w, got, want
            free_memory(torch)


def _bmm_call(torch, x, w, want):
    """torch.bmm on the same bf16 inputs: one PyTorch call for the batched
    expert GEMM, held to the plain version before it is timed."""
    got = torch.bmm(x, w)
    torch.cuda.synchronize()
    if not within(torch, got, want, 1e-2, 1.6e-2):
        print("[kernels] moe_gemm yardstick: torch.bmm result differs; not "
              "used")
        return None
    return lambda: torch.bmm(x, w)


def check_moe_gemm(torch, rng, res, E, C, H, D, label, dev, primary):
    """The capacity path's expert GEMMs at a serve's (E, C): w_in / w_gate
    (H -> D) and w_out (D -> H), both timed in bf16.  One expert's buffer
    is all zero, as an expert no slot was routed to is, and gives exact
    zeros; a second call gives the same bits."""
    import numpy as np
    ops, ref = _ops()
    for h_in, d_out, part in ((H, D, ""), (D, H, " w_out")):
        for dtype in (torch.bfloat16, torch.float32):
            d = dname(dtype)
            torch.manual_seed(0)        # the same w in every process
            x = torch.from_numpy(rng.standard_normal((E, C, h_in),
                                                     np.float32))
            x[E // 2] = 0
            x = x.to(dev, dtype)
            w = (torch.randn(E, h_in, d_out, device=dev) * h_in ** -0.5) \
                .to(dtype)
            got = ops.moe_gemm(x, w)
            again = ops.moe_gemm(x, w)
            want = ref.moe_gemm_ref(x, w)
            torch.cuda.synchronize()
            ok = (got.shape == (E, C, d_out)
                  and within(torch, got, want, *TOL[d])
                  and bool((got[E // 2] == 0).all())
                  and torch.equal(got, again))
            rec = {"label": f"{label} {d}{part}",
                   "max_err": max_err(torch, got, want),
                   "tol": list(TOL[d]), "ok": ok,
                   "digest": digest(torch, got),
                   "input_digest": digest(torch, x, w),
                   "shape": f"x {tuple(x.shape)} w {tuple(w.shape)} "
                            f"zero expert {E // 2}"}
            if dtype == torch.bfloat16:
                time_rec(torch, rec, lambda: ops.moe_gemm(x, w), 20,
                         lambda: ref.moe_gemm_ref(x, w), 3,
                         _bmm_call(torch, x, w, want))
                rec.update(bytes=(x.numel() + w.numel() + got.numel()) * 2,
                           flops=2 * E * C * h_in * d_out, peak="bf16",
                           primary=primary and not part)
            res.add("moe_gemm", rec, "disagrees with its plain version or "
                                     "with itself")
            del x, w, got, again, want
            free_memory(torch)


def check_moe_gemm_contracts(torch, dev):
    """A ragged C (13 rows: one 16-row tile) and C = 70 (two row tiles),
    H and D off the tiles and not multiples of 8 (the element-wise loads),
    an all-zero expert and an all-zero row: exact zeros, output exactly
    (E, C, D)."""
    ops, ref = _ops()
    ok = True
    for dtype in (torch.bfloat16, torch.float32):
        for c, h, d in ((13, 264, 200), (13, 100, 75), (70, 264, 200)):
            x = torch.randn(5, c, h, device=dev)
            x[2] = 0
            x[4, 3] = 0
            x = x.to(dtype)
            w = (torch.randn(5, h, d, device=dev) * h ** -0.5).to(dtype)
            got = ops.moe_gemm(x, w)
            ok &= got.shape == (5, c, d)
            ok &= within(torch, got, ref.moe_gemm_ref(x, w),
                         *TOL[dname(dtype)])
            ok &= bool((got[2] == 0).all()) and bool((got[4, 3] == 0).all())
    print(f"[kernels] moe_gemm contracts (ragged C 13 and 70, H/D off the "
          f"tiles and off 8, zero expert, zero row): ok={ok}")
    check(ok, "moe_gemm contract case failed")


def check_permute_capacity(torch, rng, res, T, E, K, H, C, label, dev):
    """permute_tokens into the (E*C, h) capacity buffers and
    unpermute_tokens back, on a real capacity dispatch of T skewed routed
    tokens: cells no slot fills are -1 in src (expert 7 gets none), slots
    past C are -1 in slot (expert 0 is overloaded)."""
    import numpy as np
    from repro_torch.models import moe
    logits = rng.standard_normal((T, E))
    logits[:, 0] += 3.0
    logits[:, 7] = -np.inf
    ids = np.argsort(-logits, axis=1, kind="stable")[:, :K]
    idx = _i32(torch, ids, dev)
    torch.manual_seed(0)        # the same weights in every process
    wts = torch.rand(T, K, device=dev)
    d = moe.make_dispatch(idx, wts, E, C)
    src = moe.dispatch_src_tok(d, E, T)
    slot, w = moe.dispatch_src_slot(d, T)
    n_drop, n_empty = int((slot < 0).sum()), int((src < 0).sum())
    check(n_drop > 0 and n_empty > 0, f"permute capacity case has "
                                      f"{n_drop} drops, {n_empty} empty cells")
    _check_gather(torch, res, f"{label} capacity", T, H, src, None, None,
                  dev, False)
    _check_combine(torch, res, f"{label} capacity", E * C, H, slot, w, dev,
                   False)


def check_permute(torch, rng, res, T, E, K, H, label, dev, primary):
    """permute_tokens on the step's T tokens into expert order (N = T*k
    rows, no -1 entries, as on the dropless path) and unpermute_tokens
    combining the N rows back with f32 weights."""
    n = T * K
    _, order = _routing(rng, T, E, K, empty=7)
    src = _i32(torch, order // K, dev)
    inv = torch.empty_like(src)
    inv[src.new_tensor(order).long()] = torch.arange(
        n, dtype=torch.int32, device=dev)
    _check_gather(torch, res, label, T, H, src, None, None, dev, primary)
    torch.manual_seed(0)        # the same weights in every process
    _check_combine(torch, res, label, n, H, inv.reshape(T, K),
                   torch.rand(T, K, device=dev), dev, primary)


def check_permute_contracts(torch, dev):
    """src < 0 gives a zero row, slot < 0 adds 0, and rows whose width is
    not a multiple of 16 bytes (the element-wise instantiations)."""
    ops, ref = _ops()
    ok = True
    for dtype in (torch.bfloat16, torch.float32):
        for h in (4096, 4098):
            x = torch.randn(40, h, device=dev).to(dtype)
            src = torch.randint(0, 40, (90,), dtype=torch.int32, device=dev)
            src[::4] = -1
            got = ops.permute_tokens(x, src)
            ok &= torch.equal(got, ref.permute_tokens_ref(x, src))
            ok &= bool((got[::4] == 0).all())
            slot = torch.randint(0, 90, (40, 6), dtype=torch.int32,
                                 device=dev)
            slot[::3, 1] = -1
            slot[5] = -1
            w = torch.rand(40, 6, device=dev)
            out = ops.unpermute_tokens(got, slot, w)
            ok &= within(torch, out, ref.unpermute_tokens_ref(got, slot, w),
                         *UNPERMUTE_TOL[dname(dtype)])
            ok &= bool((out[5] == 0).all())
    print(f"[kernels] permute / unpermute contracts (src<0 zero rows, "
          f"slot<0 adds 0, 16-byte and element-wise rows): ok={ok}")
    check(ok, "permute / unpermute contract case failed")


def _ep_exchange(rng, dsh, S):
    """One rank's side of the distributed serve's dropless EP exchange at
    extent S, laid out as ``moe._moe_shard_dropless_fn`` lays it out: ep
    sources each route t_c tokens (top-k, expert-sorted, the last expert
    unused); this rank is EP index 0 and holds experts [0, e_local).
    Returns numpy int64 arrays: source 0's dispatch buffer (``send_src``
    (ep*S,), ``send_tot`` (ep,)), the received rows regrouped by local
    expert (``comb_src`` (ep*S,), ``m_real`` of them valid, segments
    ``off_local`` (e_local+1,)), the return gather (``out_src`` (ep*S,))
    and source 0's combine rows (``slot`` (t_c, k))."""
    import numpy as np
    t_c, e, k, ep = (dsh[n] for n in ("t_c", "E", "k", "ep"))
    el = e // ep
    routes = [_routing(rng, t_c, e, k, empty=e - 1) for _ in range(ep)]
    # source s sends this rank its experts-[0, el) segment cut at S rows
    csum = np.stack([np.minimum(np.cumsum(np.diff(off)[:el]), S)
                     for off, _ in routes])                   # (ep, el)
    cnt = np.diff(csum, axis=1, prepend=0)
    comb = [s * S + i for le in range(el) for s in range(ep)
            for i in range(csum[s, le] - cnt[s, le], csum[s, le])]
    m_real = len(comb)
    comb_src = np.full(ep * S, -1)
    comb_src[:m_real] = comb
    out_src = np.full(ep * S, -1)
    out_src[comb] = np.arange(m_real)
    off0, order0 = routes[0]
    rank_off = off0[::el].astype(np.int64)
    send_tot = np.minimum(np.diff(rank_off), S)
    send_src = np.full((ep, S), -1)
    for r in range(ep):
        send_src[r, :send_tot[r]] = \
            order0[rank_off[r]:rank_off[r] + send_tot[r]] // k
    inv = np.empty(order0.size, np.int64)
    inv[order0] = np.arange(order0.size)
    r_of = (rank_off[None, 1:] <= inv[:, None]).sum(1)
    slot = r_of * S + np.minimum(inv - rank_off[r_of], S - 1)
    return {"send_src": send_src.reshape(-1), "send_tot": send_tot,
            "comb_src": comb_src, "m_real": m_real, "out_src": out_src,
            "off_local": np.concatenate([[0], np.cumsum(cnt.sum(0))]),
            "slot": slot.reshape(t_c, k)}


def _index_select_call(torch, x, src, want):
    """One PyTorch call for the same rows: index_select over x with a zero
    row appended, -1 mapped onto it (the mapping is set-up, untimed)."""
    xz = torch.cat([x, x.new_zeros(1, x.shape[1])])
    idx = torch.where(src >= 0, src, x.shape[0]).long()
    check(torch.equal(torch.index_select(xz, 0, idx), want),
          "gather yardstick index_select differs")
    return lambda: torch.index_select(xz, 0, idx)


def _check_gather(torch, res, label, n_x, width, src, tot, stride, dev,
                  primary):
    """permute_tokens_ragged (``tot`` given) or permute_tokens of random
    (n_x, width) rows by ``src``, bitwise against the plain version, -1
    rows zero; timed in bf16 beside index_select."""
    ops, ref = _ops()
    ragged = tot is not None
    name = "permute_tokens_ragged" if ragged else "permute_tokens"
    n_valid = int((src >= 0).sum())
    if ragged:
        run = lambda x: ops.permute_tokens_ragged(  # noqa: E731
            x, src, tot, seg_stride=stride)
        plain = lambda x: ref.permute_tokens_ragged_ref(  # noqa: E731
            x, src, tot, seg_stride=stride)
        extra = f" total {tuple(tot.shape)} = {tot.tolist()}, stride {stride}"
    else:
        run = lambda x: ops.permute_tokens(x, src)  # noqa: E731
        plain = lambda x: ref.permute_tokens_ref(x, src)  # noqa: E731
        extra = ""
    for dtype in (torch.bfloat16, torch.float32):
        d = dname(dtype)
        x = torch.randn(n_x, width, device=dev).to(dtype)
        got, want = run(x), plain(x)
        torch.cuda.synchronize()
        rec = {"label": f"{label} {d}", "max_err": max_err(torch, got, want),
               "tol": [0.0, 0.0], "ok": torch.equal(got, want)
               and bool((got[src < 0] == 0).all()),
               "shape": f"x {tuple(x.shape)} src ({src.numel()},){extra}, "
                        f"{n_valid} valid rows"}
        if dtype == torch.bfloat16:
            time_rec(torch, rec, lambda: run(x), 100, lambda: plain(x), 50,
                     _index_select_call(torch, x, src, want))
            live = int(src[src >= 0].unique().numel())
            rec.update(bytes=(live + src.numel()) * width * 2
                       + 4 * (n_valid + tot.numel() if ragged
                              else src.numel()),
                       flops=0, peak="bf16", primary=primary)
        res.add(name, rec, "differs from its plain version")


def _embedding_bag_call(torch, buf, slot, w, want):
    """One PyTorch call for the weighted combine: embedding_bag in sum
    mode over buf with a zero row appended, -1 slots mapped onto it (the
    mapping is set-up, untimed), the weights as its per-sample weights,
    which it takes only in buf's dtype.  Held to the plain version at the
    bf16 tolerance; None where it is refused or differs."""
    import torch.nn.functional as F
    bz = torch.cat([buf, buf.new_zeros(1, buf.shape[1])])
    idx = torch.where(slot >= 0, slot, buf.shape[0]).long()
    psw = w.to(buf.dtype)
    try:
        got = F.embedding_bag(idx, bz, per_sample_weights=psw, mode="sum")
        torch.cuda.synchronize()
    except (RuntimeError, TypeError) as e:
        print(f"[kernels] unpermute_tokens yardstick: embedding_bag "
              f"refused: {str(e).splitlines()[0][:160]}")
        return None
    if not within(torch, got, want, *TOL["bfloat16"]):
        print(f"[kernels] unpermute_tokens yardstick: embedding_bag differs "
              f"by {max_err(torch, got, want)} (its per-sample weights are "
              f"rounded to {dname(buf.dtype)}); not used")
        return None
    return lambda: F.embedding_bag(idx, bz, per_sample_weights=psw,
                                   mode="sum")


def _check_combine(torch, res, label, n_buf, width, slot, w, dev,
                   primary):
    """unpermute_tokens of random (n_buf, width) rows into slot.shape[0]
    tokens by ``slot`` (-1 adds 0) and f32 weights ``w``, against the
    plain version in each dtype and, in bf16, against the plain version
    in f32; timed in bf16 beside embedding_bag."""
    ops, ref = _ops()
    T, K = slot.shape
    n_neg = int((slot < 0).sum())
    for dtype in (torch.bfloat16, torch.float32):
        d = dname(dtype)
        torch.manual_seed(0)    # the same buf in every process
        buf = torch.randn(n_buf, width, device=dev).to(dtype)
        out = ops.unpermute_tokens(buf, slot, w)
        want = ref.unpermute_tokens_ref(buf, slot, w)
        torch.cuda.synchronize()
        ok = within(torch, out, want, *UNPERMUTE_TOL[d])
        rec = {"label": f"{label} {d}", "max_err": max_err(torch, out, want),
               "tol": list(UNPERMUTE_TOL[d]), "ok": ok,
               "digest": digest(torch, out),
               "input_digest": digest(torch, buf, slot, w),
               "shape": f"buf {tuple(buf.shape)} slot {tuple(slot.shape)}"
                        + (f", {n_neg} dropped slots" if n_neg else "")}
        if dtype == torch.bfloat16:
            want32 = ref.unpermute_tokens_ref(buf.float(), slot, w)
            rec.update(max_err_vs_f32=max_err(torch, out, want32),
                       tol_vs_f32=list(UNPERMUTE_TOL_VS_F32))
            rec["ok"] = ok and within(torch, out, want32,
                                      *UNPERMUTE_TOL_VS_F32)
            time_rec(torch, rec, lambda: ops.unpermute_tokens(buf, slot, w),
                     100, lambda: ref.unpermute_tokens_ref(buf, slot, w), 50,
                     _embedding_bag_call(torch, buf, slot, w, want))
            kept = slot[slot >= 0]
            rec.update(bytes=(int(kept.unique().numel()) + T) * width * 2
                       + 8 * T * K, flops=2 * int(kept.numel()) * width,
                       peak="f32", primary=primary)
        res.add("unpermute_tokens", rec, "disagrees with its plain version")


def check_ep_exchange(torch, rng, res, dsh, dev):
    """The kernels one rank of the distributed serve launches, at its
    shapes: the router gate on the rank's t tokens; then, at each extent
    S the exchange runs (the row cap, and the worst case n_c of the
    overflow rerun), the ragged dispatch gather (t_c, h/tp) -> (ep*S,
    h/tp) with per-destination totals at stride S, the ragged comb gather
    of the received (ep*S, h) rows by local expert under one scalar total,
    the grouped GEMMs over the local experts' (h, d_ff/tp) blocks, the
    return gather of the reduce-scattered (ep*S, h/tp) rows and the
    combine of the t_c tokens' k rows."""
    import numpy as np
    t, t_c, e, k, ep, tp, h, d = (dsh[n] for n in (
        "t", "t_c", "E", "k", "ep", "tp", "h", "d_ff"))
    check_topk(torch, rng, res, t, e, k, "phi3.5 EP rank", dev, False)
    i32 = lambda a: _i32(torch, a, dev)  # noqa: E731
    for S in dsh["extents"]:
        ex = _ep_exchange(rng, dsh, S)
        tag = f"phi3.5 EP S={S}"
        first = S == dsh["extents"][0]
        _check_gather(torch, res, f"{tag} send", t_c, h // tp,
                      i32(ex["send_src"]), i32(ex["send_tot"]), S, dev,
                      first)
        _check_gather(torch, res, f"{tag} comb", ep * S, h,
                      i32(ex["comb_src"]), i32(np.asarray(ex["m_real"])),
                      None, dev, False)
        check_grouped_gemm(torch, rng, res, ex["off_local"], ep * S, h,
                           d // tp, tag, dev, False)
        _check_gather(torch, res, f"{tag} return", ep * S, h // tp,
                      i32(ex["out_src"]), None, None, dev, False)
        torch.manual_seed(0)    # the same weights in every process
        _check_combine(torch, res, f"{tag} combine", ep * S, h // tp,
                       i32(ex["slot"]), torch.rand(t_c, k, device=dev), dev,
                       False)
    free_memory(torch)


def check_permute_ragged_contracts(torch, dev):
    """A vector total with an empty segment, an all-zero total, a scalar
    total, n off the 32-row tile, rows off 16 bytes (h 4098), tiles wholly
    past a prefix written as zeros even when src there is not -1 (the
    kernel reads neither src nor x there), and the ValueError for segments
    that do not cover the buffer."""
    ops, ref = _ops()
    ok = True
    for dtype in (torch.bfloat16, torch.float32):
        for h in (4096, 4098):
            x = torch.randn(40, h, device=dev).to(dtype)
            for totals, stride, n in (([5, 0, 23], 23, 69),
                                      ([0, 0, 0], 23, 69),
                                      (17, None, 70)):
                tot = torch.tensor(totals, dtype=torch.int32, device=dev)
                st = stride or n
                row = torch.arange(n, device=dev)
                seg = (row // st).clamp_max(tot.numel() - 1)
                valid = (row - seg * st) < tot.reshape(-1)[seg]
                src = torch.randint(0, 40, (n,), dtype=torch.int32,
                                    device=dev)
                src[~valid] = -1
                got = ops.permute_tokens_ragged(x, src, tot,
                                                seg_stride=stride)
                ok &= torch.equal(got, ref.permute_tokens_ragged_ref(
                    x, src, tot)) and bool((got[~valid] == 0).all())
            junk = torch.randint(0, 40, (128,), dtype=torch.int32,
                                 device=dev)
            if dev.type == "cuda":    # the kernel's tiles, not the plain
                got = ops.permute_tokens_ragged(   # version's dense gather
                    x, junk, torch.tensor(20, dtype=torch.int32, device=dev))
                ok &= bool((got[32:] == 0).all()) \
                    and torch.equal(got[:32], x[junk[:32].long()])
    try:
        ops.permute_tokens_ragged(
            x, junk[:100], torch.tensor([1, 1], dtype=torch.int32,
                                        device=dev), seg_stride=40)
        ok = False
    except ValueError:
        pass
    print(f"[kernels] permute_tokens_ragged contracts (empty segments, zero "
          f"and scalar totals, n off the tile, 16-byte and element-wise "
          f"rows, empty-tail tiles zero without reading src, uncovered "
          f"segments raise): ok={ok}")
    check(ok, "permute_tokens_ragged contract case failed")


def _ops():
    from repro_torch.kernels import ops, ref
    return ops, ref


def host_split(torch, label, wrapper, cname, x, n, library):
    """The host's microseconds per call of a gather wrapper on x (T, h)
    into n rows, cut into its parts: the C launch alone (ctypes and
    cudaLaunchKernel, on the arguments the wrapper passed), the output's
    allocation (``x.new_empty``, the wrapper's call; beside it the same
    allocation by ``torch.empty`` with keywords), the raw stream handle
    (``ops._stream``), and the checks and the rest of the wrapper (what is
    left); beside it the host cost of ``library``, the one-call
    yardstick."""
    from repro_torch.kernels import build
    ops, _ = _ops()
    lib = build.load()
    fn = getattr(lib, cname)
    seen = []
    setattr(lib, cname, lambda *a: seen.append(a) or fn(*a))
    try:
        keep = wrapper()            # the buffer seen[0] writes into
    finally:
        setattr(lib, cname, fn)
    check(len(seen) == 1, f"{label}: the wrapper made {len(seen)} launches")
    h = x.shape[1]
    us = {"wrapper": host_us(torch, wrapper),
          "launch": host_us(torch, lambda: fn(*seen[0])),
          "new_empty": host_us(torch, lambda: x.new_empty(n, h)),
          "torch_empty": host_us(torch, lambda: torch.empty(
              n, h, dtype=x.dtype, device=x.device)),
          "stream": host_us(torch, ops._stream),
          "library": host_us(torch, library)}
    us["checks_and_rest"] = (us["wrapper"] - us["launch"] - us["new_empty"]
                             - us["stream"])
    del keep
    print(f"[host] {label} {json.dumps(us)}")
    return us


def _device_ops_per_call(torch, fn, calls=20):
    """{CUDA kernel or memory op name: its events per call} of fn, from
    torch.profiler (CUPTI) over ``calls`` calls after a warm-up (the trace
    can miss a few of the window's first events, so a count may fall
    short of 1)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {ev.key[:60]: ev.count / calls for ev in prof.key_averages()
            if ev.device_type.name == "CUDA" and ev.count}


def route_cost(torch, label, t, e, k):
    """What the router costs a MoE layer on the card around the gate
    kernel: the device ops each call launches (distinct kernels and
    memory ops, each once a call) and host us per call of
    ``moe.route_topk`` with the kernel on (its f32 softmax over (T, E)
    and the load-balance loss, which the serving engine drops, run
    beside the kernel), and of ``ops.topk_gate`` alone, on the same bf16
    logits; then the host us of the gate's two output allocations against
    one (2, T, k) buffer split into an f32 and an int32 view."""
    from repro_torch.models.moe import route_topk
    ops, _ = _ops()
    lg = torch.randn(t, e, device="cuda").to(torch.bfloat16)
    calls = {"route_topk": lambda: route_topk(lg, k, use_kernel=True),
             "topk_gate": lambda: ops.topk_gate(lg, k)}
    out = {}
    for name, fn in calls.items():
        n = _device_ops_per_call(torch, fn)
        out[name] = {"device_ops": len(n), "host_us": host_us(torch, fn),
                     "ops": n}
    def two():
        return (torch.empty(t, k, dtype=torch.float32, device=lg.device),
                torch.empty(t, k, dtype=torch.int32, device=lg.device))

    def one_and_views():
        w, idx = torch.empty(2, t, k, dtype=torch.int32,
                             device=lg.device).unbind(0)
        return w.view(torch.float32), idx
    out["alloc_us"] = {"two": host_us(torch, two),
                       "one_and_views": host_us(torch, one_and_views)}
    print(f"[host] router {label} ({t}, {e}) k {k}: {json.dumps(out)}")
    return out


def phase_host(torch, phi, dsh):
    """Host us per call of the two gather wrappers at a served shape each:
    the phi3.5 dropless gather and the sharded serve's ragged send at the
    row cap; then the router's cost around its kernel at the phi3.5 and
    deepseek-v2 steps."""
    t = phi["max_batch"] * phi["chunk"]
    route_cost(torch, "phi3.5", t, 16, 2)
    route_cost(torch, "deepseek-v2", t, 160, 6)
    ops, _ = _ops()
    dev = torch.device("cuda")
    bf = torch.bfloat16
    t = phi["max_batch"] * phi["chunk"]
    x = torch.randn(t, 4096, device=dev).to(bf)
    src = torch.randint(0, t, (2 * t,), dtype=torch.int32, device=dev)
    xz = torch.cat([x, x.new_zeros(1, 4096)])
    idx = src.long()
    host_split(torch, f"permute_tokens phi3.5 ({t}, 4096) -> ({2 * t}, 4096)",
               lambda: ops.permute_tokens(x, src), "rt_permute_tokens", x,
               2 * t, lambda: torch.index_select(xz, 0, idx))
    S, ep, w = dsh["extents"][0], dsh["ep"], dsh["h"] // dsh["tp"]
    xs = torch.randn(dsh["t_c"], w, device=dev).to(bf)
    tot = torch.full((ep,), S // 2, dtype=torch.int32, device=dev)
    ss = torch.randint(0, dsh["t_c"], (ep, S), dtype=torch.int32, device=dev)
    ss[:, S // 2:] = -1
    ss = ss.reshape(-1)
    xsz = torch.cat([xs, xs.new_zeros(1, w)])
    sidx = torch.where(ss >= 0, ss, dsh["t_c"]).long()
    host_split(torch, f"permute_tokens_ragged EP send S={S} "
                      f"({dsh['t_c']}, {w}) -> ({ep * S}, {w})",
               lambda: ops.permute_tokens_ragged(xs, ss, tot, seg_stride=S),
               "rt_permute_tokens_ragged", xs, ep * S,
               lambda: torch.index_select(xsz, 0, sidx))


def phase_kernels(torch, phi, ds, ds1, dsh):
    """phi / ds / ds1: the resolved shapes of the phi3.5 serve, the
    deepseek serve and the deepseek chunk=1 serve, each with the capacity
    ``C`` its capacity-dispatch serve gives; dsh: the distributed serve's
    per-rank shapes."""
    import numpy as np
    from repro_torch.configs.paper_models import PAPER_MODELS
    from repro_torch.core.resolve import AUTO_BATCH_CAP
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    res = Results()
    check_flash_paged(torch, rng, res, phi, dev)
    check_flash_dense(torch, rng, res, ds, ds1, dev)
    check_flash_contracts(torch, rng, dev)
    check_flash_split(torch, rng, dev)
    t_phi = phi["max_batch"] * phi["chunk"]
    t_ds = ds["max_batch"] * ds["chunk"]
    check_launch_floor(torch, res)
    check_topk(torch, rng, res, t_phi, 16, 2, "phi3.5", dev, True)
    check_topk(torch, rng, res, t_ds, 160, 6, "deepseek", dev, False)
    # the paper's routers (configs/paper_models.py), which no serve here
    # runs: at a served step's rows, and at the largest step auto
    # resolution gives (AUTO_BATCH_CAP slots x the chunk)
    for arch, t in (("qwen3-235b-a22b", t_ds), ("deepseek-r1-671b", t_ds),
                    ("deepseek-r1-671b", AUTO_BATCH_CAP * ds["chunk"])):
        cfg = PAPER_MODELS[arch]
        check_topk(torch, rng, res, t, cfg.n_experts, cfg.top_k,
                   f"{arch} router, {t} rows", dev, False)
    check_grouped_gemm(torch, rng, res, _routing(rng, t_phi, 16, 2, 7)[0],
                       t_phi * 2, 4096, 6400, "phi3.5", dev, True)
    check_grouped_gemm(torch, rng, res, _routing(rng, t_ds, 160, 6, 7)[0],
                       t_ds * 6, 5120, 1536, "deepseek", dev, False)
    check_permute(torch, rng, res, t_phi, 16, 2, 4096, "phi3.5", dev, True)
    check_permute(torch, rng, res, t_ds, 160, 6, 5120, "deepseek", dev,
                  False)
    check_permute_contracts(torch, dev)
    check_ep_exchange(torch, rng, res, dsh, dev)
    check_permute_ragged_contracts(torch, dev)
    check_moe_gemm(torch, rng, res, 16, phi["C"], 4096, 6400, "phi3.5", dev,
                   True)
    check_moe_gemm(torch, rng, res, 160, ds["C"], 5120, 1536, "deepseek",
                   dev, False)
    check_moe_gemm(torch, rng, res, 160, ds1["C"], 5120, 1536,
                   "deepseek chunk=1", dev, False)
    check_moe_gemm_contracts(torch, dev)
    check_permute_capacity(torch, rng, res, t_phi, 16, 2, 4096, phi["C"],
                           "phi3.5", dev)
    check_permute_capacity(torch, rng, res, t_ds, 160, 6, 5120, ds["C"],
                           "deepseek", dev)
    check_grouped_gemm_contracts(torch, dev)
    free_memory(torch)
    return res.recs


# (segment lengths, rows past offsets[-1], H, D): the per-segment schedule's
# edges.  An empty expert and a boundary inside a tile; boundaries at every
# residue mod 16 (17-row segments) and mod the 64-row visit (65-row
# segments); 1-row segments; one expert holding every row beside empty
# ones; segments longer than a visit; H and D off 8; no routed row at all
GG_CONTRACTS = [([37, 0, 53, 60], 50, 64, 48),
                ([17] * 16, 30, 256, 200),
                ([65] * 64, 10, 64, 136),
                ([1] * 32 + [0] * 8, 16, 64, 136),
                ([0, 0, 0, 200, 0, 0, 0, 0], 0, 128, 96),
                ([150, 0, 301, 90], 7, 256, 264),
                ([13, 0, 40, 1, 29], 21, 100, 75),
                ([0, 0, 0], 70, 64, 64)]


def check_grouped_gemm_contracts(torch, dev):
    """Each row computed by its own expert only and every output element
    written once, in bf16 and f32: equal to the plain version within TOL,
    rows past offsets[-1] exact zeros."""
    import numpy as np
    ops, ref = _ops()
    ok = True
    for lengths, tail, h, d in GG_CONTRACTS:
        off = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
        n = int(off[-1]) + tail
        offs = _i32(torch, off, dev)
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(n, h, device=dev).to(dtype)
            w = (torch.randn(len(lengths), h, d, device=dev)
                 * h ** -0.5).to(dtype)
            got = ops.grouped_gemm(x, w, offs)
            ok &= within(torch, got, ref.grouped_gemm_ref(x, w, offs),
                         *TOL[dname(dtype)])
            ok &= bool((got[int(off[-1]):] == 0).all())
    print(f"[kernels] grouped_gemm contracts (empty experts, boundaries at "
          f"every residue mod 16 and mod 64, 1-row segments, one expert "
          f"holding all rows, segments past a visit, H/D off 8, rows past "
          f"offsets[-1] zero, bf16 and f32): ok={ok}")
    check(ok, "grouped_gemm contract case failed")


# ---------------------------------------------------------------------------
# phase 3 + 4: the engine
# ---------------------------------------------------------------------------

def _cut(arch, layers):
    import repro_torch.configs as C
    full = C.get(arch)
    return dataclasses.replace(full, n_layers=layers,
                               name=f"{arch}-{layers}L")


def _parity(torch, cfg, params, knobs, lens, new, expect):
    """The engine with kernels "on" against "off" on the same weights:
    first-step logits and greedy streams; the "on" run must launch every
    kernel in ``expect``."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serving.api import LLM, ServeSpec
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    streams, first, launches = {}, {}, {}
    for kern in ("on", "off"):
        llm = LLM.from_spec(
            ServeSpec(kernels=kern, kv="paged", reduced=False, max_batch=4,
                      max_new_tokens=new, **knobs), cfg=cfg, params=params,
            device="cuda", dtype=torch.float32)
        eng = llm.engine
        reqs = [Request(rid=i, prompt=p, max_new_tokens=new)
                for i, p in enumerate(prompts)]
        ops.reset_counters()
        for r in reqs:
            check(eng.admit(r), "parity: admission failed")
        q = eng.plan_q_lens(llm.spec.token_budget)
        eng.unified_step(q)
        first[kern] = (q, eng.last_logits.clone())
        while eng.n_active:
            eng.step(llm.spec.token_budget)
        torch.cuda.synchronize()
        launches[kern] = dict(ops.counters)
        streams[kern] = [list(r.out_tokens) for r in reqs]
        del llm, eng
        free_memory(torch)
    q = first["on"][0]
    check((q == first["off"][0]).all(), "parity: plans differ")
    live = torch.from_numpy(q > 0).cuda()
    err = max_err(torch, first["on"][1][live], first["off"][1][live])
    equal = streams["on"] == streams["off"]
    print(f"[parity] {cfg.name} f32 full width, chunk {knobs['chunk']}, "
          f"dispatch {knobs.get('dispatch', 'auto')}: "
          f"first-step logits max err {err:.3e} (tol 1e-3), greedy streams "
          f"equal: {equal}; kernels-on launches {launches['on']}")
    check(err <= 1e-3, f"parity: first-step logits differ by {err}")
    check(equal, f"parity: streams differ\n on={streams['on']}\n "
                 f"off={streams['off']}")
    check(all(launches["on"].get(k, 0) > 0 for k in expect)
          and not launches["off"],
          f"parity: kernels-on run launched {launches['on']}, expected "
          f"{expect}; kernels-off {launches['off']}")
    return {"logits_max_err": err, "streams_equal": equal}


def phase_capacity_module(torch, phi, ds):
    """Capacity-dispatch moe_local at full width, f32, on one input of a
    serve step's rows (pad rows included), at the config's capacity factor:
    kernels on against off.  Slots drop; the drop count, from the routed
    counts and C, must be > 0 and equal in both runs."""
    import repro_torch.configs as C
    from repro_torch.kernels import ops
    from repro_torch.kernels.policy import KernelPolicy
    from repro_torch.models import moe
    from repro_torch.models.param import init_tree
    gen = torch.Generator(device="cuda")
    out = {}
    for arch, sh in (("phi3.5-moe-42b", phi), ("deepseek-v2-236b", ds)):
        cfg = C.get(arch)
        t = sh["max_batch"] * sh["chunk"]
        p = init_tree(gen.manual_seed(5), moe.moe_spec(cfg), torch.float32,
                      "cuda")
        # a direction every row shares, as real hidden states do, skews
        # the routing so that the busiest experts overflow C
        x = (torch.randn(1, t, cfg.d_model, generator=gen, device="cuda")
             + torch.randn(cfg.d_model, generator=gen, device="cuda"))
        runs = {}
        for kern, pol in (("on", KernelPolicy.all_on()),
                          ("off", KernelPolicy.off())):
            ops.reset_counters()
            y, _, counts = moe.moe_local(p, x, cfg, policy=pol,
                                         dispatch="capacity",
                                         with_stats=True)
            torch.cuda.synchronize()
            runs[kern] = (y, int((counts - sh["C"]).clamp_min(0).sum()),
                          dict(ops.counters))
        (y_on, d_on, l_on), (y_off, d_off, l_off) = runs["on"], runs["off"]
        err = max_err(torch, y_on, y_off)
        ok = within(torch, y_on, y_off, *TOL["float32"])
        want = {"topk_gate": 1, "permute_tokens": 1, "moe_gemm": 3,
                "unpermute_tokens": 1}
        print(f"[parity] {arch} capacity moe_local f32 full width, T {t}, "
              f"cf {cfg.capacity_factor}, C {sh['C']}: max err {err:.3e} "
              f"(tol {TOL['float32']}), dropped slots on {d_on} / off "
              f"{d_off} of {t * cfg.top_k}; launches on {l_on}")
        check(ok, f"capacity moe_local {arch}: kernels on and off differ "
                  f"by {err}")
        check(d_on == d_off > 0, f"capacity moe_local {arch}: dropped "
                                 f"slots on {d_on}, off {d_off}")
        check(l_on == want and not l_off,
              f"capacity moe_local {arch}: launches on {l_on}, off {l_off}")
        out[arch] = {"max_err": err, "dropped": d_on}
        del p, x, runs, y_on, y_off
        free_memory(torch)
    return out


def _no_drop(cfg):
    """The config with a capacity factor of at least E / k, so C >= T and
    no slot drops: kernels on and off then see the same buffers whatever
    the pad rows route to."""
    return dataclasses.replace(
        cfg, capacity_factor=float(math.ceil(cfg.n_experts / cfg.top_k)))


def phase_parity(torch):
    from repro_torch.models.model import init_params
    gen = torch.Generator(device="cuda")
    long_knobs = dict(max_len=256, chunk=32, prompt_len=200)
    cap_knobs = dict(long_knobs, dispatch="capacity")
    moe = ("topk_gate", "grouped_gemm", "permute_tokens", "unpermute_tokens")
    cap = ("topk_gate", "moe_gemm", "permute_tokens", "unpermute_tokens")
    lens = (40, 100, 200, 150)
    out = {}
    cfg = _cut("phi3.5-moe-42b", 2)
    params = init_params(gen.manual_seed(1), cfg, torch.float32, "cuda")
    out["phi3.5"] = _parity(torch, cfg, params, long_knobs, lens, 8,
                            ("flash_chunk_paged",) + moe)
    out["phi3.5 capacity"] = _parity(torch, _no_drop(cfg), params, cap_knobs,
                                     lens, 8, ("flash_chunk_paged",) + cap)
    del params
    free_memory(torch)
    cfg = _cut("deepseek-v2-236b", 2)
    params = init_params(gen.manual_seed(1), cfg, torch.float32, "cuda")
    out["deepseek expanded"] = _parity(torch, cfg, params, long_knobs, lens,
                                       8, ("flash_chunk",) + moe)
    out["deepseek absorbed"] = _parity(
        torch, cfg, params, dict(max_len=64, chunk=1, prompt_len=24),
        (20, 12, 16, 9), 4, ("flash_decode", "flash_chunk") + moe)
    out["deepseek expanded capacity"] = _parity(
        torch, _no_drop(cfg), params, cap_knobs, lens, 8,
        ("flash_chunk",) + cap)
    del params
    free_memory(torch)
    return out


def _serve(torch, llm, prompts, new, per_step, card_line, label):
    """Submit every prompt, stream to the end, check the tokens and the
    exact launch counts per step; print TTFT / ITL / tok/s / memory."""
    import numpy as np
    from repro_torch.kernels import ops
    eng = llm.engine
    ops.reset_counters()
    n0 = eng.n_forward
    t0 = time.perf_counter()
    t_sub = {llm.submit(p, new): time.perf_counter() for p in prompts}
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
    mem = torch.cuda.max_memory_allocated() / 2**30
    print(f"[serve] {label}: {len(prompts)} requests, {n_tok} new tokens, "
          f"{steps} unified steps in {wall:.2f}s: {n_tok / wall:.1f} tok/s, "
          f"TTFT mean {np.mean(ttft) * 1e3:.0f} ms / max "
          f"{max(ttft) * 1e3:.0f} ms, ITL mean {np.mean(itl) * 1e3:.1f} ms, "
          f"prefix hits {hits}, max_memory_allocated {mem:.1f} GiB "
          f"[{card_line}]")
    want = {k: v * steps for k, v in per_step.items() if v}
    print(f"[serve] {label}: kernel launches {launches} (expect per step "
          f"{per_step})")
    check(all(len(outs.get(r, [])) == new for r in t_sub),
          f"serve {label}: a request did not finish with {new} tokens")
    check(all(0 <= t < llm.cfg.vocab_size for v in outs.values() for t in v),
          f"serve {label}: token id outside the vocabulary")
    check(steps > 0 and launches == want,
          f"serve {label}: launch counters {launches} != {want}")
    return {"launches": launches, "steps": steps, "wall_s": wall,
            "tok_s": n_tok / wall,
            "ttft_ms": float(np.mean(ttft) * 1e3),
            "itl_ms": float(np.mean(itl) * 1e3), "prefix_hits": hits,
            "max_mem_gib": mem,
            "shapes": {"max_batch": llm.spec.max_batch, "chunk": eng.chunk,
                       "max_len": eng.max_len, "pool_pages": eng.kv.n_pages}}


def _serve_capacity(torch, llm, prompts, new, per_step, card_line, label):
    """``_serve`` on a capacity-dispatch engine, counting the slots each
    MoE layer drops: its routed counts (which the engine asks every layer
    for) over C.  Inside the timed stream the hook only keeps a reference
    to each layer's counts and row count (no device work); the drop
    arithmetic runs after the stream ends."""
    from repro_torch.models import moe
    eng, cfg = llm.engine, llm.cfg
    check(llm.spec.dispatch == "capacity"
          and eng.plan.dispatch_mode == "capacity",
          f"serve {label}: dispatch resolved to {llm.spec.dispatch}")
    sink = []
    block = moe.moe_block

    def counted(p, x, cfg, plan, **kw):
        r = block(p, x, cfg, plan, **kw)
        sink.append((x.shape[0] * x.shape[1], r[2]))
        return r
    torch.cuda.reset_peak_memory_stats()
    moe.moe_block = counted
    try:
        out = _serve(torch, llm, prompts, new, per_step, card_line, label)
    finally:
        moe.moe_block = block
    n_moe = cfg.n_layers - cfg.first_dense_layers
    check(len(sink) == out["steps"] * n_moe,
          f"serve {label}: {len(sink)} MoE layer runs in {out['steps']} "
          f"steps")
    dropped = int(sum(
        (n - moe.capacity_for(t, cfg.top_k, cfg.n_experts,
                              cfg.capacity_factor)).clamp_min(0).sum()
        for t, n in sink))
    routed = sum(t for t, _ in sink) * cfg.top_k
    c = moe.capacity_for(eng.max_batch * eng.chunk, cfg.top_k, cfg.n_experts,
                         cfg.capacity_factor)
    print(f"[serve] {label}: C {c}, dropped slots {dropped} of {routed} "
          f"routed ({dropped / routed:.4f}, pad rows included), "
          f"{dropped / out['steps']:.1f} per step")
    out.update(dropped=dropped, routed=routed,
               dropped_per_step=dropped / out["steps"])
    return out


def _load(torch, spec, cfg, card_line):
    from repro_torch.serving.api import LLM
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    llm = LLM.from_spec(spec, cfg=cfg, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name} bf16 weights ready in "
          f"{time.perf_counter() - t0:.1f}s [{card_line}]; resolved:\n"
          f"{llm.spec.describe()}")
    return llm


def phase_serve_phi(torch, card_line):
    import numpy as np
    from repro_torch.serving.api import LLM
    cfg = _cut("phi3.5-moe-42b", 8)
    rng = np.random.default_rng(2)
    shared = rng.integers(0, cfg.vocab_size, 512).astype(np.int32)
    tail = lambda n: rng.integers(0, cfg.vocab_size, n).astype(np.int32)
    # one shared-prefix prompt first, its siblings last: they are admitted
    # after it finishes and find its pages in the prefix index
    prompts = ([np.concatenate([shared, tail(100)])]
               + [tail(n) for n in (64, 1024, 300)]
               + [np.concatenate([shared, tail(n)]) for n in (40, 250, 480)]
               + [tail(700)])
    llm = _load(torch, phi_spec(), cfg, card_line)
    per_step = {"flash_chunk_paged": 8, "topk_gate": 8, "permute_tokens": 8,
                "unpermute_tokens": 8, "grouped_gemm": 24}
    label = f"{cfg.name} (8 of 32 layers)"
    out = _serve(torch, llm, prompts, 32, per_step, card_line, label)
    check(out["prefix_hits"] >= 1, "serve: no prefix hit")
    phase_profile(torch, llm, rng, label)
    # capacity dispatch: the same prompts on the same weights
    params = llm.params
    del llm
    free_memory(torch)
    cap = LLM.from_spec(phi_spec("capacity"), cfg=cfg, params=params,
                        device="cuda", dtype=torch.bfloat16)
    per_step.update(grouped_gemm=0, moe_gemm=24)
    capacity = _serve_capacity(torch, cap, prompts, 32, per_step, card_line,
                               label + " capacity")
    check(capacity["prefix_hits"] >= 1, "capacity serve: no prefix hit")
    phase_profile(torch, cap, rng, label + " capacity")
    return out, capacity


# launches per step of the deepseek cut's MoE layers (3 of its 4 layers)
DS_MOE = {"topk_gate": 3, "permute_tokens": 3, "unpermute_tokens": 3,
          "grouped_gemm": 9}


def ds_prompts(cfg):
    """The deepseek serve's 6 prompts (3 sharing a 256-token prefix) and a
    maker of more from the same generator, seeded 3."""
    import numpy as np
    rng = np.random.default_rng(3)
    shared = rng.integers(0, cfg.vocab_size, 256).astype(np.int32)
    tail = lambda n: rng.integers(0, cfg.vocab_size, n).astype(np.int32)
    prompts = ([np.concatenate([shared, tail(40)])]
               + [tail(n) for n in (64, 512, 300)]
               + [np.concatenate([shared, tail(n)]) for n in (200, 180)])
    return rng, prompts, tail


def phase_serve_deepseek(torch, card_line):
    from repro_torch.serving.api import LLM
    cfg = _cut("deepseek-v2-236b", 4)
    rng, prompts, tail = ds_prompts(cfg)
    llm = _load(torch, ds_spec(), cfg, card_line)
    label = f"{cfg.name} (4 of 60 layers, expanded MLA)"
    out = _serve(torch, llm, prompts, 16, {"flash_chunk": 4, **DS_MOE},
                 card_line, label)
    check(out["prefix_hits"] >= 1, "serve: no prefix hit")
    phase_profile(torch, llm, rng, label)
    # the absorbed regime: chunk=1 on the same weights
    params = llm.params
    del llm
    free_memory(torch)
    small = LLM.from_spec(ds1_spec(), cfg=cfg, params=params, device="cuda",
                          dtype=torch.bfloat16)
    absorbed = _serve(torch, small, [tail(16), tail(24)], 4,
                      {"flash_decode": 4, "flash_chunk": 4, **DS_MOE},
                      card_line,
                      f"{cfg.name} (4 of 60 layers, absorbed MLA, chunk=1)")
    # capacity dispatch: the first serve's prompts on the same weights
    del small
    free_memory(torch)
    cap = LLM.from_spec(ds_spec("capacity"), cfg=cfg, params=params,
                        device="cuda", dtype=torch.bfloat16)
    capacity = _serve_capacity(
        torch, cap, prompts, 16,
        {"flash_chunk": 4, **DS_MOE, "grouped_gemm": 0, "moe_gemm": 9},
        card_line, label + " capacity")
    check(capacity["prefix_hits"] >= 1, "capacity serve: no prefix hit")
    return out, absorbed, capacity


def phase_profile(torch, llm, rng, label):
    """Where the device time goes: torch.profiler over a short extra run
    on the same engine (4 fresh prompts of 256 tokens, 8 new tokens each;
    not part of the counted main-path run).  Prints each kernel family's
    share of device time and the device's idle share of the window, and
    returns the device busy ms and the idle share."""
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
    groups = dict.fromkeys([g for _, g in PROFILE_GROUPS] + ["other"], 0.0)
    top = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0)
        if us <= 0 or ev.device_type.name != "CUDA":
            continue
        key = next((g for pat, g in PROFILE_GROUPS if pat in ev.key),
                   "other")
        groups[key] += us
        if key == "other":
            top.append((us, ev.key[:60]))
    busy = sum(groups.values())
    if busy <= 0:
        print(f"[profile] {label}: device time not measured (the profiler "
              f"reported no CUDA kernel time)")
        return
    shares = {k: round(v / busy, 4) for k, v in groups.items() if v > 0}
    print(f"[profile] {label}, 4x256-token prompts + 8 new tokens: window "
          f"{wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms, idle "
          f"share {max(0.0, 1 - busy / wall_us):.3f} (profiler on); "
          f"device-time shares {json.dumps(shares)}")
    top.sort(reverse=True)
    print(f"[profile] {label}: largest other kernels: " + "; ".join(
        f"{name} {us / 1e3:.1f} ms" for us, name in top[:5]))
    return {"busy_ms": busy / 1e3, "idle_share": max(0.0, 1 - busy / wall_us),
            "family_ms": {k: v / 1e3 for k, v in groups.items() if v > 0}}


# ---------------------------------------------------------------------------
# phase 5: the distributed MoE (4 ranks)
# ---------------------------------------------------------------------------

DIST_MESH = (2, 2)                           # (data, model)
DIST_LAYOUTS = (("mixserve", "fused"), ("mixserve", "unfused"),
                ("dp_ep", "unfused"), ("pure_tp", "unfused"))
DIST_PARITY = dict(max_len=256, chunk=32, prompt_len=200, max_new_tokens=8)
DIST_LENS = (40, 100, 200, 150)
# per MoE layer and exchange chunk run (counts, dispatch, comb gather, FFN,
# return, combine) on the dropless EP path
DIST_PER_CHUNK = {"permute_tokens_ragged": 2, "permute_tokens": 1,
                  "grouped_gemm": 3, "unpermute_tokens": 1}


def _dist_strategy(layout, algo):
    """ServeSpec.strategy of a layout on the DIST_MESH: mixserve as the
    analyzer Strategy of its degrees, which carries the comm algorithm;
    dp_ep and pure_tp by name (both run unfused)."""
    if layout != "mixserve":
        return layout
    from repro_torch.core.cost_model import Strategy
    data, model = DIST_MESH
    return Strategy(attn_tp=model, attn_dp=data, moe_tp=model, moe_ep=data,
                    comm_algo=algo)


def dist_spec(**kw):
    """The distributed serve: mixserve with the fused RS-A2A-AG, dropless,
    the resolved ep_overlap."""
    return _spec(strategy=_dist_strategy("mixserve", "fused"), chunk=64,
                 prompt_len=512, max_new_tokens=16, **kw)


def _dist_shapes(cfg):
    """The shapes one rank of the distributed serve gives the kernels
    (resolved on a description of the mesh; no process group): t tokens
    per rank in ``chunks`` exchange chunks of t_c, and the extents S of
    the exchange, the row cap and, where the cap is below it, the worst
    case n_c that an overflowing chunk reruns at."""
    from repro_torch.core.cost_model import EP_OVERLAP_OFF, cap_rows_for
    from repro_torch.launch.mesh import Mesh
    res = dist_spec().resolve(cfg, mesh=Mesh(("data", "model"), DIST_MESH),
                              device="cuda")
    plan = res.plan
    ovl = plan.ep_overlap or EP_OVERLAP_OFF
    t = res.max_batch // plan.dp * res.chunk
    chunks = math.gcd(ovl.chunks, t) if ovl.chunks > 1 else 1
    n_c = t // chunks * cfg.top_k
    cap = cap_rows_for(n_c, plan.ep, ovl)
    return {"t": t, "chunks": chunks, "t_c": t // chunks, "n_c": n_c,
            "extents": [cap, n_c] if cap < n_c else [n_c], "ep": plan.ep,
            "tp": plan.tp, "h": cfg.d_model, "d_ff": cfg.d_ff,
            "E": cfg.n_experts, "k": cfg.top_k,
            "ep_overlap": ovl.describe(),
            "max_batch": res.max_batch, "chunk": res.chunk}


def _dist_inputs(torch, cfg, dev):
    """The parity phase's moe_block input and prompts, from seeds."""
    import numpy as np
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(4, 64, cfg.d_model, generator=gen, device=dev)
    rng = np.random.default_rng(1)
    return x, [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in DIST_LENS]


def _dist_reference(torch, path):
    """The unsharded f32 runs the ranks are held against: moe_block and
    LLM.generate on one device, both dispatch modes (capacity at a factor
    at which nothing drops), 2 layers at full width."""
    from repro_torch.core.partitioner import make_plan
    from repro_torch.kernels.policy import KernelPolicy
    from repro_torch.models import moe
    from repro_torch.models.model import init_params
    from repro_torch.serving.api import LLM
    cfg = _no_drop(_cut("phi3.5-moe-42b", 2))
    gen = torch.Generator(device="cuda")
    params = init_params(gen.manual_seed(1), cfg, torch.float32, "cuda")
    x, prompts = _dist_inputs(torch, cfg, "cuda")
    ref = {"moe": {}, "streams": {}}
    for d in ("dropless", "capacity"):
        plan = make_plan("mixserve", kernels=KernelPolicy.all_on(),
                         dispatch=d)
        ref["moe"][d] = moe.moe_block(params["groups"][0][0]["moe"], x, cfg,
                                      plan)[0].cpu()
        llm = LLM.from_spec(_spec(dispatch=d, **DIST_PARITY), cfg=cfg,
                            params=params, device="cuda",
                            dtype=torch.float32)
        ref["streams"][d] = llm.generate(prompts, 8)
        del llm
    torch.save(ref, path)
    del params, x
    free_memory(torch)


def _dist_parity_rank(torch, mesh, ref):
    """(a) on one rank: each layout's moe_block and LLM.generate against
    the unsharded runs; mixserve fused also micro-chunked, with the auto
    row cap and with a cap of 8 rows that every chunk overflows."""
    from repro_torch.core.cost_model import EpOverlap
    from repro_torch.models import moe
    from repro_torch.models.model import init_params
    from repro_torch.serving.api import LLM
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = _no_drop(_cut("phi3.5-moe-42b", 2))
    x, prompts = _dist_inputs(torch, cfg, dev)
    gen = torch.Generator(device=dev)
    out = []
    for lay, algo in DIST_LAYOUTS:
        params = None
        cases = [("dropless", "off"), ("capacity", "off")]
        if (lay, algo) == ("mixserve", "fused"):
            cases += [("dropless", EpOverlap(chunks=2)),
                      ("dropless", EpOverlap(chunks=2, cap_rows=8))]
        for d, ovl in cases:
            res = _spec(strategy=_dist_strategy(lay, algo), dispatch=d,
                        ep_overlap=ovl, **DIST_PARITY).resolve(
                cfg, mesh=mesh, device=dev)
            if params is None:      # one draw per layout's weight slicing
                params = init_params(gen.manual_seed(1), cfg, torch.float32,
                                     dev, plan=res.plan)
            moe.exchange_counts.clear()
            y = moe.moe_block(params["groups"][0][0]["moe"], x, cfg,
                              res.plan)[0]
            want = ref["moe"][d].to(dev)
            ovf = moe.exchange_counts.get("overflow", 0)
            llm = LLM.from_spec(res, cfg=cfg, params=params, device=dev,
                                dtype=torch.float32)
            t0 = time.perf_counter()
            streams = llm.generate(prompts, 8)
            torch.cuda.synchronize()
            out.append({
                "case": f"{lay} {res.plan.comm_algo} {d}"
                        + ("" if ovl == "off" else f" ({ovl.describe()})"),
                "moe_max_err": max_err(torch, y, want),
                "moe_ok": within(torch, y, want, *TOL["float32"]),
                "moe_overflow": ovf, "cap8": ovl != "off"
                and ovl.cap_rows == 8, "auto_cap": ovl != "off"
                and ovl.cap_rows == 0, "streams": streams,
                "streams_equal": streams == ref["streams"][d],
                "generate_s": time.perf_counter() - t0})
            del llm
        del params
        free_memory(torch)
    return out


def _dist_serve_rank(torch, mesh):
    """(b) on one rank: the bf16 8-layer phi3.5 serve, counters read from
    this run only."""
    import numpy as np
    from repro_torch.core import collectives
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.serving.api import LLM
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = _cut("phi3.5-moe-42b", 8)
    res = dist_spec().resolve(cfg, mesh=mesh, device=dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    llm = LLM.from_spec(res, cfg=cfg, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    weights = sum(t.numel() * t.element_size() for t in _leaves(llm.params))
    rng = np.random.default_rng(4)
    shared = rng.integers(0, cfg.vocab_size, 256).astype(np.int32)
    tail = lambda n: rng.integers(0, cfg.vocab_size, n).astype(np.int32)
    prompts = [np.concatenate([shared, tail(40)]), tail(64), tail(512),
               np.concatenate([shared, tail(200)])]
    eng = llm.engine
    ops.reset_counters()
    moe.exchange_counts.clear()
    collectives.reset_counters()
    # host seconds this rank spends inside collectives (issue, exchange
    # and waits), timed here only: the port's module keeps no clock
    spent, depth = [0.0], [0]
    issue, wait = collectives._issue, collectives.Pending.wait

    def timed(fn):            # outermost call only (sync calls nest a wait)
        def run(*a, **kw):
            depth[0] += 1
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                depth[0] -= 1
                if not depth[0]:
                    spent[0] += time.perf_counter() - t
        return run
    collectives._issue = timed(issue)
    collectives.Pending.wait = timed(wait)
    n0 = eng.n_forward
    t0 = time.perf_counter()
    try:
        streams = llm.generate(prompts, 16)
        torch.cuda.synchronize()
    finally:
        collectives._issue, collectives.Pending.wait = issue, wait
    wall = time.perf_counter() - t0
    ovl = res.plan.ep_overlap
    return {"streams": streams, "launches": dict(ops.counters),
            "collective_s": spent[0],
            "steps": eng.n_forward - n0, "exchange": dict(moe.exchange_counts),
            "collectives": {f"{k} {'+'.join(a)}": n for (k, a), n
                            in sorted(collectives.counters.items())},
            "wall_s": wall, "load_s": load_s, "weights_gb": weights / 1e9,
            "max_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "ep_load": eng.ep_load_stats(), "prefix_hits":
            eng.kv.stats.n_prefix_hits, "spec": res.describe(),
            "vocab": cfg.vocab_size,
            "plan": f"{res.strategy} {res.plan.comm_algo}, tp {res.plan.tp} "
                    f"{res.plan.tp_axes}, ep {res.plan.ep} "
                    f"{res.plan.ep_axes}, dp {res.plan.dp} "
                    f"{res.plan.dp_axes}, ep_overlap "
                    f"{ovl.describe() if ovl else 'off'}"}


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def dist_rank(rank, world, workdir):
    """One rank of phase 5 (runs in its own process)."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_host_mesh(*DIST_MESH)
    ref = torch.load(pathlib.Path(workdir) / "ref.pt")
    parity = _dist_parity_rank(torch, mesh, ref)
    free_memory(torch)
    serve = _dist_serve_rank(torch, mesh)
    return {"rank": rank, "backend": mesh.backend, "mesh": repr(mesh),
            "device": torch.cuda.get_device_name(), "parity": parity,
            "serve": serve}


def phase_dist(torch, card_line, dsh):
    """4 ranks on a 2x2 (data, model) mesh: gloo on one card shared by
    all ranks (NCCL, one rank per card, where there are 4 cards)."""
    from repro_torch.launch.mesh import pick_backend
    from repro_torch.launch.ranks import RankFailed, run_ranks
    work = ROOT / "build" / "dist_smoke"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    _dist_reference(torch, work / "ref.pt")
    t_ref = time.perf_counter() - t0
    backend = pick_backend(4, "cuda")
    label = ("4 ranks sharing one card" if backend == "gloo"
             else "4 ranks, one card each")
    print(f"[dist] unsharded f32 references in {t_ref:.1f}s; spawning 4 "
          f"ranks, backend {backend}, mesh (data, model) = {DIST_MESH} "
          f"[{label}]")
    t0 = time.perf_counter()
    try:
        ranks = run_ranks(dist_rank, 4, (str(work),), workdir=work,
                          device="cuda", timeout_s=900)
    except RankFailed as e:
        raise SmokeError(f"distributed phase: {e}") from e
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    print(f"[dist] {len(ranks)} ranks done in {wall:.1f}s: backend "
          f"{r0['backend']}, world 4, {r0['mesh']}, devices "
          f"{sorted({r['device'] for r in ranks})}")
    check(all(r["backend"] == backend for r in ranks),
          f"distributed phase: backends {[r['backend'] for r in ranks]}")
    # (a) f32 parity
    for i, case in enumerate(r0["parity"]):
        per = [r["parity"][i] for r in ranks]
        err = max(c["moe_max_err"] for c in per)
        ovf = [c["moe_overflow"] for c in per]
        print(f"[dist] (a) {case['case']}: moe_block vs unsharded max err "
              f"{err:.3e} (tol {TOL['float32']}), overflowed chunks per "
              f"rank {ovf}; LLM.generate streams equal unsharded on every "
              f"rank: {all(c['streams_equal'] for c in per)} "
              f"({case['generate_s']:.2f}s, {label})")
        check(all(c["moe_ok"] for c in per),
              f"distributed {case['case']}: moe_block differs by {err}")
        check(all(c["streams_equal"] for c in per),
              f"distributed {case['case']}: streams differ from unsharded: "
              f"{[c['streams'] for c in per]}")
        check(not case["cap8"] or min(ovf) > 0,
              f"distributed {case['case']}: the 8-row cap never overflowed")
        check(not case["auto_cap"] or max(ovf) == 0,
              f"distributed {case['case']}: the auto cap overflowed")
    # (b) the bf16 serve
    sv = [r["serve"] for r in ranks]
    s0 = sv[0]
    print(f"[dist] (b) plan: {s0['plan']}; resolved:\n{s0['spec']}")
    runs = s0["exchange"].get("chunks", 0) + s0["exchange"].get("overflow",
                                                               0)
    n_moe = 8
    want = {"flash_chunk_paged": 8 * s0["steps"],
            "topk_gate": n_moe * s0["steps"]}
    want.update({k: v * runs for k, v in DIST_PER_CHUNK.items()})
    n_tok = sum(len(v) for v in s0["streams"])
    for r, s in enumerate(sv):
        print(f"[dist] (b) rank {r}: {n_tok} new tokens in {s['steps']} "
              f"steps, {s['wall_s']:.2f}s ({n_tok / s['wall_s']:.1f} tok/s, "
              f"{s['wall_s'] / s['steps'] * 1e3:.1f} ms/step, {label}; "
              f"{s['collective_s']:.2f}s of it inside collectives, host "
              f"clock); "
              f"weights {s['weights_gb']:.2f} GB, max_memory_allocated "
              f"{s['max_mem_gib']:.1f} GiB, load {s['load_s']:.1f}s; "
              f"exchange chunks {s['exchange']}; prefix hits "
              f"{s['prefix_hits']} [{card_line}]")
        print(f"[dist] (b) rank {r}: kernel launches {s['launches']} "
              f"(expect {want}); collectives {s['collectives']}; "
              f"ep_load_stats {s['ep_load']}")
        check(s["launches"] == want and s["exchange"] == s0["exchange"],
              f"distributed serve rank {r}: launches {s['launches']} != "
              f"{want}")
        check(s["exchange"].get("chunks") == s["steps"] * n_moe
              * dsh["chunks"], f"distributed serve rank {r}: "
              f"{s['exchange']} exchange chunks in {s['steps']} steps")
        check(s["streams"] == s0["streams"],
              f"distributed serve: rank {r}'s streams differ from rank 0's")
    check(all(len(v) == 16 and all(0 <= t < s0["vocab"] for t in v)
              for v in s0["streams"]),
          f"distributed serve: streams {s0['streams']}")
    (work / "ref.pt").unlink()
    launches: dict = {}
    for s in sv:
        for k, v in s["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return {"launches": launches, "wall_s": wall,
            "serve": {k: v for k, v in s0.items() if k != "streams"}}


def kernels_record(kres, launches):
    out = []
    for name, source, replaces in KERNELS:
        recs = kres[name]
        timed = [r for r in recs if "kernel_ms" in r]

        def bound(r):
            t_bytes = r["bytes"] / HBM_BW
            t_ops = r["flops"] / (PEAK_F32 if r["peak"] == "f32"
                                  else PEAK_BF16)
            return (max(t_bytes, t_ops) * 1e3,
                    "bytes" if t_bytes >= t_ops else "operations")
        main = next(r for r in timed if r.get("primary"))
        b_ms, b_by = bound(main)
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": int(launches.get(name, 0)),
            "max_abs_err": max(r["max_err"] for r in recs),
            "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": main["library_ms"],
            "device_ms": main["device_ms"],
            "library_device_ms": main["library_device_ms"],
            "shape": main["label"] + ": "
            + main["shape"],
            "max_err": {r["label"]: r["max_err"] for r in recs},
            "tol": {r["label"]: r["tol"] for r in recs},
            "ok": all(r["ok"] for r in recs),
            "other_shapes": [{
                "label": r["label"], "shape": r["shape"],
                "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": bound(r)[0], "bound_by": bound(r)[1],
                "library_ms": r["library_ms"], "device_ms": r["device_ms"],
                "library_device_ms": r["library_device_ms"]}
                for r in timed if r is not main],
        })
    return out


def _spec(**kw):
    from repro_torch.serving.api import ServeSpec
    return ServeSpec(kernels="auto", kv="paged", reduced=False, max_batch=4,
                     seed=0, **kw)


def phi_spec(dispatch="auto"):
    return _spec(prompt_len=1024, max_new_tokens=32, dispatch=dispatch)


def ds_spec(dispatch="auto"):
    return _spec(prompt_len=512, max_new_tokens=16, dispatch=dispatch)


def ds1_spec():
    return _spec(prompt_len=24, max_new_tokens=4, chunk=1)


def _shapes(spec, cfg):
    res = spec.resolve(cfg, device="cuda")
    return {"max_batch": res.max_batch, "chunk": res.chunk,
            "max_len": res.max_len, "pool_pages": res.kv.pool_pages}


def _capacity(sh, cfg):
    """The C that capacity dispatch gives a step of the envelope's
    max_batch * chunk rows (pad rows take capacity slots too)."""
    from repro_torch.models.moe import capacity_for
    return capacity_for(sh["max_batch"] * sh["chunk"], cfg.top_k,
                        cfg.n_experts, cfg.capacity_factor)


def resolve_shapes():
    """The kernel shapes of every serve phase, from the envelopes the serve
    specs resolve to (cheap, host only), so phase 2 times exactly what
    phases 4-5 launch: (phi, ds, ds1, dsh)."""
    phi_cfg, ds_cfg = _cut("phi3.5-moe-42b", 8), _cut("deepseek-v2-236b", 4)
    phi = _shapes(phi_spec(), phi_cfg)
    ds = _shapes(ds_spec(), ds_cfg)
    ds1 = _shapes(ds1_spec(), ds_cfg)
    check(_shapes(phi_spec("capacity"), phi_cfg) == phi
          and _shapes(ds_spec("capacity"), ds_cfg) == ds,
          "capacity dispatch resolved another envelope than dropless")
    for sh, cfg in ((phi, phi_cfg), (ds, ds_cfg), (ds1, ds_cfg)):
        sh["C"] = _capacity(sh, cfg)
    dsh = _dist_shapes(phi_cfg)
    print(f"[shapes] phi3.5 {phi} | deepseek {ds} | deepseek chunk=1 {ds1}"
          f" | distributed phi3.5 EP exchange per rank {dsh}")
    return phi, ds, ds1, dsh


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
    phi, ds, ds1, dsh = resolve_shapes()
    kres = phase_kernels(torch, phi, ds, ds1, dsh)
    phase_host(torch, phi, dsh)
    phase_capacity_module(torch, phi, ds)
    phase_parity(torch)
    serve_phi, cap_phi = phase_serve_phi(torch, card_line)
    free_memory(torch)
    serve_ds, serve_ds1, cap_ds = phase_serve_deepseek(torch, card_line)
    for got, want in ((serve_phi, phi), (cap_phi, phi), (serve_ds, ds),
                      (serve_ds1, ds1), (cap_ds, ds)):
        want = {k: v for k, v in want.items() if k != "C"}
        check(got["shapes"] == want,
              f"serve ran {got['shapes']}, kernels were checked at {want}")
    free_memory(torch)
    dist = phase_dist(torch, card_line, dsh)
    launches: dict = {}
    for s in (serve_phi, cap_phi, serve_ds, serve_ds1, cap_ds, dist):
        for k, v in s["launches"].items():
            launches[k] = launches.get(k, 0) + v
    rec = kernels_record(kres, launches)
    check(all(k["ok"] and k["launches"] > 0 for k in rec),
          "a kernel failed or never launched on a served path")
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
