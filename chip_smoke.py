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
             dispatch; one rank of the distributed serve: its paged
             attention at its batch rows and heads, its router gate, and
             its EP exchange's gathers, grouped GEMMs and combine at the
             row cap and at the worst-case extent), bf16
             and f32, plus its contract cases (for the grouped GEMM's
             per-segment schedule: 1-row segments, one expert holding all
             rows, boundaries at every residue mod 16 and mod 64, rows past
             offsets[-1]; for attention: split-KV boundaries, q_len 0 with
             kv_len 0, paged == dense bitwise), and the router gate also
             at the paper's routers (qwen3-235b and deepseek-r1, k 8, at a
             served step and at the largest auto-resolved one); the
             attention of the gemma-2b and minitron-8b serves at their
             step shapes (flash_chunk on the dense backend's cache and
             flash_chunk_paged on the same cache as shuffled pages,
             paged == dense bitwise) and flash_decode at gemma's chunk=1
             step and at a 1024-key cache;
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
             with a capacity factor at which nothing drops; gemma-2b and
             minitron-8b (chunk 32) on the paged and on the dense KV
             backend; first-step logits within 1e-3, greedy streams
             equal; and for gemma and minitron dense against paged (prefix
             cache off, the same chunking): first-step logits bitwise
             equal on the scheduled slots, streams equal, kernels on and
             off
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
               gemma-2b (9 of 18 layers, MQA 8/1 heads at hd 256) and
               minitron-8b (16 of 32 layers): phi3.5's traffic, paged
               (flash_chunk_paged), then kv="dense" on the same weights
               (flash_chunk); gemma also 2 prompts of 16-24 tokens at
               chunk=1 on the dense backend (flash_decode);
             a torch.profiler window on each long serve's engine for the
             device-time breakdown (phi3.5 dropless and capacity, deepseek
             dropless, gemma and minitron paged)
  4c recurrent  the legacy blocking path (no kernel lies on it):
             (a) bf16, full width, half depth: rwkv6-1.6b (12 of 24
                 layers) and recurrentgemma-9b (19 of 38 layers, window
                 2048), max_batch 4,
                 max_len 2048, 8 prompts of 64-1024 tokens (two exactly a
                 bucket long) padded to their buckets, 32 new tokens each:
                 ms per decode step, TTFT, ITL, tok/s, peak memory, the
                 blocking prefills' share of the wall time, a profiler
                 window over 4 short (32-token) prompts, which decode
                 dominates; no kernel counter moves;
             (b) f32 and f64, full width: rwkv6 2 layers,
                 recurrentgemma 3 layers (one pattern) with window 64:
                 one 64-token prompt (its own bucket), max_batch 1,
                 max_len 256: the engine's 48-token greedy stream equals a
                 greedy loop through forward(cache=), whose logits at
                 every step match the stateless forward within rtol 1e-4
                 plus 1e-4 of the largest |logit| (recurrentgemma in f32:
                 1e-3) (the ring wraps); the recurrent leaves that
                 init_params zeroes are drawn
  4d frontend   the frontend families on the legacy path, whose blocking
             prefill runs flash_chunk (batch 1, q_offset 0) and whose
             decode runs flash_decode, a layer each:
             (a) bf16, full width and depth, a seeded stub through
                 embeds_fn: qwen2-vl-7b (28 layers, M-RoPE, 256 patch
                 embeddings of the embedding table's scale ahead of each
                 prompt), max_batch 4, max_len 2048, 8 prompts of 64-1024
                 tokens, 32 new; whisper-tiny (4 + 4 layers, 1500 random
                 frames into the encoder), max_len 512, 8 prompts of
                 16-256 tokens, 64 new: launches exact per decode step
                 and per prefill, every attention geometry recorded and
                 held to the ones phase 2 checked, ms per decode step,
                 the prefills' share of wall time, TTFT, ITL, tok/s,
                 peak memory, a profiler window;
             (b) f32, full width, qwen2-vl 3 layers and whisper whole,
                 the zero-initialised norms drawn: the engine with
                 kernels on against off (streams equal, first-token
                 logits within the bound), and the cached loop through
                 the kernels and through the plain bodies against the
                 stateless forward within the same bound: rtol 1e-4 plus
                 the larger of 1e-4 of the largest |logit| and how far
                 the logits move when the first layer's norm weight is
                 scaled by 1 + 2^-23 (at full width the random init
                 makes them chaotic in f32)
             (phase 2 checks flash_chunk at each prefill geometry of
             these serves and flash_decode at their decode step)
  4b spec    speculative decoding (ServeSpec(speculation=...), k 4):
             (a) f32, 2 layers, full width: phi3.5 paged and dense,
                 deepseek-v2 paged, gemma-2b dense; the self draft with
                 kernels on and off and the plain serve with kernels on:
                 streams equal, launches exact;
             (b) bf16, full width, 8 prompts of 32-64 tokens, 64 new
                 each, the plain serve and then each draft on the same
                 weights: phi3.5 8 layers paged (self, ngram, a reduced
                 smollm-360m with random weights), deepseek-v2 4 layers
                 paged (self), gemma-2b 9 layers on kv="dense" (self,
                 ngram);
                 steps, ms/step, tok/s, TTFT, ITL, acceptance, tokens a
                 verify step, draft forwards and the share of wall time
                 spent drafting; launches exact per verify step and per
                 draft forward; which streams differ from the plain
                 serve's, and the top-2 logit margin at the first
                 differing token (printed, not held: bf16)
             (phase 2 checks its two geometries: flash_chunk_paged with
             four 5-row verify blocks in the chunk-64 step, flash_chunk
             at the draft's (4, 16) step on its (4, 128) cache)
  5 dist     MixServe's layout on 4 ranks, a 2x2 (data, model) mesh:
             attention on each rank's heads and batch rows, the vocab-
             sharded embedding and LM head, the TP dense MLP, the
             residual stream cut along seq (sp), the sharded MoE; 4
             processes on this card over gloo (with 4 cards, one rank per
             card over NCCL), the kernel library built once above and only
             loaded by the ranks.
             (a) f32, phi3.5 2 layers, full width: moe_block, forward
                 logits (a 32-row mixed step with the residual stream cut,
                 then a 1-row step) and LLM.generate under mixserve fused,
                 mixserve unfused, dp_ep and pure_tp, dropless and
                 capacity (no-drop factor), mixserve fused also with sp
                 off, plus the micro-chunked exchange with the auto row
                 cap and an 8-row cap that overflows, each against the
                 unsharded run on the same weights (moe_block to 1e-4,
                 logits to rtol 1e-4 plus 1e-3 of the largest logit,
                 greedy streams equal); deepseek-v2 2 layers (dense + MoE)
                 at full width, f32, mixserve fused: the same forward
                 (expanded MLA, then absorbed) and greedy streams;
             (b) bf16, phi3.5 8 layers, full width, mixserve fused,
                 dropless, the resolved ep_overlap: 4 prompts of 64-512
                 tokens (2 sharing a prefix), 16 new tokens; streams equal
                 on every rank, exact launch counts per step and exchange
                 chunk, the collectives per step by kind and axes,
                 ep_load_stats and the A2A byte ledger, weights, KV pool
                 and peak memory per rank; times labelled as ranks sharing
                 one card;
             (c) f32, full width, cut in depth, every serve option the
                 mesh once refused, each against the unsharded run on the
                 same weights: phi3.5 and deepseek-v2 2 layers on
                 kv="dense" (the 32-row mixed step, then a 1-row step,
                 deepseek expanded then absorbed; the stateless forward;
                 logits to rtol 1e-4 plus 1e-3 of the largest logit,
                 LLM.generate streams equal); phi3.5 speculation, k 4 at
                 chunk 16, the self draft on both backends and a reduced
                 smollm-360m draft (streams equal the plain mesh serve's
                 and the unsharded serve's, acceptance counters the
                 unsharded run's); the legacy path: rwkv6-1.6b 2 layers,
                 recurrentgemma-9b 3 layers, whisper-tiny whole (default
                 and seeded frames), qwen2-vl-7b 2 layers (a seeded patch
                 stub and none), the zero-initialised recurrent leaves and
                 norms drawn: streams equal, each prefill's first-token
                 logits within rtol 1e-4 plus the larger of 1e-4 of the
                 largest logit and the one-ulp move of layer 0's norm;
             (d) bf16: phi3.5 8 layers on kv="dense" with (b)'s traffic
                 (launches exact, flash_chunk where (b) runs
                 flash_chunk_paged; the collectives a step against (b)'s:
                 the batch all_gather of the new KV rows, one a layer,
                 gone); rwkv6-1.6b whole (24 layers) on the mesh, 4 prompts
                 of 64-256 tokens, 8 new: streams equal on every rank, ms a
                 decode step, the prefills' share of wall time, the
                 collectives a decode step by kind, weights per rank;
             every attention geometry (c) and (d) launched is then held to
             the plain version on the card, and the dense-cache rank step
             and the legacy rank decode timed beside SDPA and their bound
  6 train    the training path on one card (training.train_step: the
             stateless forward, cross-entropy plus the router's aux loss,
             autograd, AdamW), the plain bodies only (no kernel has a
             backward):
             (a) f32, every config reduced, the zero-initialised leaves
                 drawn: one value_and_grad and AdamW step on the card and
                 on the CPU from the same weights and batch: the loss,
                 every gradient leaf (within the CPU parity tests'
                 bounds) and the weights after the step;
             (b) smollm-360m whole (32 layers), bf16, remat, batch
                 8 x 256, 30 steps (lr 2e-3, warm-up 3, clip off): the
                 loss falls by 0.1 or more; ms a step, tokens/s, peak
                 memory, a profiler window; (e) a checkpoint of the
                 trained params and optimizer state restored bit for bit;
                 the first 10 steps with the default clip (printed); the
                 peak with remat off;
             (c) phi3.5-moe-42b at full width, 2 of 32 layers (2.86 B
                 params), capacity dispatch, bf16, remat, batch 4 x 256,
                 10 steps, the same checks and numbers; the first step
                 again with microbatches=2, its loss within 2^-7;
             no kernel counter moves in (a)-(c); (d) a kernels-on forward
             under autograd raises, under no_grad it launches the kernels
  7 train-mesh
             training on a 2x2 (data, model) mesh, 4 ranks over gloo on
             the one card (as phase 5; NCCL with 4 cards), no kernel:
             (a) phi3.5-moe-42b and smollm-360m reduced, f32, capacity
                 factor 8 (nothing drops), mixserve with sp and fsdp on,
                 remat: two steps from the same weights and batches as
                 the unsharded steps on the card (their router aux by the
                 mesh's rule): the first step's loss within 1e-5 and each
                 gradient block within the CPU tests' GRAD_BOUND, the
                 weights after two AdamW steps within Adam's move under
                 both steps' gradient differences;
             (b) phi3.5-moe-42b at full width, 2 of 32 layers, through
                 ``launch.train.train_loop`` as the CLI trains (mixserve,
                 sp on, bf16, remat), batch 4 x 256, 3 steps: ms a step,
                 tokens/s, peak GiB a rank, the host clock inside
                 collectives, the collectives a step by (kind, axes,
                 forward or backward), the loss finite and falling, the
                 same on every rank;
             (c) (a)'s phi3.5 state (params, moments, step) saved through
                 the mesh is byte-equal to the single-device file of the
                 same state (assembled from the ranks' blocks), and
                 restores to every rank's blocks bit for bit

  8 entry    the entry points as a user drives them, each on its own
             weights (no depth cut):
             (a) ``python -m repro_torch.launch.serve`` through
                 ``launch.serve.main``, the cluster and kernels ``auto``
                 (h100x1, all on), f32: gemma-2b whole, 12 requests of
                 128-256 tokens due at once, 32 new (exactly 18
                 flash_chunk_paged launches a step); phi3.5-moe-42b
                 reduced with the CLI's defaults (the MoE kernels exact
                 per step); rwkv6-1.6b whole on the legacy path (no
                 launch); steps, ms a step of the serve, TTFT, ITL, tok/s,
                 peak memory; every kernel held to its plain version on
                 the inputs these serves gave it (the first and a later
                 call of each geometry);
             (b) gemma-2b whole in bf16 exported to the HF-style flat
                 dict and loaded back onto the card: every leaf bitwise
                 equal; 4 prompts of 64-256 tokens, 16 new, from each
                 tree (kernels on): the greedy streams equal; export and
                 load seconds;
             (c) the quickstart example (reduced deepseek-v2, kernels
                 on) and train_small for 20 steps: its loss falls
  9 dryrun   the dry run (``launch/dryrun.py``: one rank's step on the meta
             device) held against the card, its own step functions run
             once for real and once on meta:
             (a) phi3.5-moe-42b, 8 of 32 layers at full width, bf16, one
                 card: one prefill chunk (4 x 1024 into a 4 x 4096 dense
                 cache) and one decode step, kernels on and then off: the
                 predicted argument bytes equal the real tensors' exactly,
                 the predicted FLOPs equal FlopCounterMode's on the real
                 step plus the kernels' own counts, and the predicted
                 peak of the step's allocations is within ``dry_bound``
                 of torch.cuda.max_memory_allocated() less what was
                 allocated before the step;
             (b) 4 ranks on phase 5's 2x2 mixserve mesh over gloo, phi3.5
                 8 layers, bf16, kernels on: each rank's dry run of one
                 decode step gives the real step's collective calls and
                 bytes by (kind, axes) exactly, and its argument bytes;
             (c) on the host, in a subprocess beside (a) and (b):
                 phi3.5-moe-42b and deepseek-v2-236b whole, decode_32k
                 and prefill_32k, on the 16x16 and 2x16x16 meshes: GiB a
                 rank, FLOPs, collective bytes by kind; every one fits the
                 card
 10 autotune the launch-plan cache (``kernels/autotune.py``), its file a
             temp file outside the checkout; phases 0-9 run with
             REPRO_TORCH_AUTOTUNE_CACHE="" (set at the top of ``main``),
             so no file on the host changes the plans they check:
             (a) bf16, full width: ``autotune.tune`` over every valid plan
                 of attention on the page pool, the router gate and the
                 combine at phase 2's phi3.5 step (and at (c)'s step),
                 phase 2's phi3.5 capacity GEMM (w_out), deepseek-v2's
                 gate and dense attention; each candidate held to the
                 plain version at phase 2's tolerance, the gate's and the
                 combine's bit for bit across candidates; a plan the
                 kernel refuses raises before any launch; each candidate's
                 ms (CUDA events, the median of 20) beside the analytic
                 plan's, the fastest registered;
             (b) a registered attention plan whose n_split is not
                 flash_plan's, at gemma-2b's step: paged == dense bitwise;
             (c) a fresh process on that file, after kv_page {page: 32}
                 and resolver {batch_cap: 4, itl_slack_pct: 25} were
                 registered: the resolved spec's provenance reads
                 autotune:measured for the page, the batch cap and the
                 ITL slack; phi3.5-moe-42b at full width, 2 of 32 layers,
                 bf16, 4 prompts of 64-256 tokens, 8 new, through
                 LLM.from_spec: launches exact per step, the plans it
                 read the tuned ones; the same serve on the same knobs
                 with no registered plan: the first differing token of
                 each stream;
             (d) one all-decode step of (c)'s serve (the engine's
                 device-side body) under ``trace_contract.sync_issues``:
                 every synchronizing line is one lint rule R2 flags under
                 an audited ``disable=R2``;
             (e) host microseconds a call of the four wrappers that look
                 a plan up, at tiny shapes: with the cache hit, with the
                 analytic plan recomputed per call, and the lookup alone

The line before the last is the ``kernels`` JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
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


def check_flash_paged(torch, rng, res, sh, dev, label="phi3.5", heads=None,
                      primary=True):
    """The phi3.5 serve's mixed step: prefill chunk mid-prompt, decode deep
    in the cache, first chunk of a prompt, idle slot.  With ``heads`` =
    (nq, nkv), one rank of the sharded serve: its batch rows, its heads,
    every page of the pool; a prefill chunk mid-prompt and a decode at the
    end of the cache."""
    ops, ref = _ops()
    B, sq = sh["max_batch"], sh["chunk"]
    nq, nkv = heads or (32, 8)
    hd, page = 128, 16
    if heads is None:
        q_off = [512, 1000, 0, 0][:B] + [0] * max(0, B - 4)
        q_len = [sq, 1, 37, 0][:B] + [0] * max(0, B - 4)
    else:
        q_off = ([sh["max_len"] // 2, sh["max_len"] - 1] + [0] * B)[:B]
        q_len = ([sq, 1] + [0] * B)[:B]
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
        rec = {"label": f"{label} {d}", "max_err": max_err(torch, got, want),
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
                       flops=flops, peak="bf16", primary=primary)
        res.add("flash_chunk_paged", rec, "disagrees with its plain version")


def check_flash_dense(torch, rng, res, sh, sh1, dev):
    """flash_chunk at the deepseek serve's expanded-MLA step (g = 1,
    hd 192 / hdv 128), also at one rank's share of it on a 2x2 mesh (2 of
    the 4 slots, 64 of the 128 heads), and, through flash_decode, at the
    chunk=1 serve's absorbed step (nkv = 1, g = 128, hd 576 / hdv 512)."""
    ops, ref = _ops()
    B, sq, S = sh["max_batch"], sh["chunk"], sh["max_len"]
    hd, hdv = 192, 128
    scale = 192 ** -0.5
    for b, nq, label, primary in (
            (B, 128, "deepseek expanded", True),
            (B // 2, 64, "deepseek expanded, one rank of a 2x2 mesh", False)):
        q_off = [S - 64 - sq, S - 76, 0, 0][:b]
        q_len = [sq, 1, 37, 0][:b]
        kv_len = [o + n for o, n in zip(q_off, q_len)]
        for dtype in (torch.bfloat16, torch.float32):
            d = dname(dtype)
            args = _dense_case(torch, rng, b=b, sq=sq, nq=nq, nkv=nq, hd=hd,
                               hdv=hdv, skv=S, q_off=q_off, q_len=q_len,
                               kv_len=kv_len, dtype=dtype, dev=dev)
            got = ops.flash_chunk(*args, scale=scale)
            want = ref.flash_chunk_ref(*args, scale)
            torch.cuda.synchronize()
            ok = within(torch, got, want, *FLASH_TOL[d])
            ok &= all(bool((got[i, q_len[i]:] == 0).all()) for i in range(b))
            rec = {"label": f"{label} {d}",
                   "max_err": max_err(torch, got, want),
                   "tol": list(FLASH_TOL[d]), "ok": ok,
                   "shape": f"q {tuple(args[0].shape)} k "
                            f"{tuple(args[1].shape)} v {tuple(args[2].shape)}"
                            f" q_len {q_len}"}
            if dtype == torch.bfloat16:
                want32 = ref.flash_chunk_ref(*_upcast(args), scale)
                rec.update(max_err_vs_f32=max_err(torch, got, want32),
                           tol_vs_f32=list(FLASH_TOL_VS_F32))
                rec["ok"] = ok and within(torch, got, want32,
                                          *FLASH_TOL_VS_F32)
                time_rec(torch, rec,
                         lambda: ops.flash_chunk(*args, scale=scale), 20,
                         lambda: ref.flash_chunk_ref(*args, scale), 5,
                         _sdpa_call(torch, *args, scale, want))
                bts, flops = _attn_work(q_off, q_len, kv_len, nq, nq, hd,
                                        hdv, 2)
                rec.update(bytes=bts + got.numel() * 2, flops=flops,
                           peak="bf16", primary=primary)
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


# the dense GQA models' attention: (label, n_heads, n_kv_heads, head_dim)
DENSE_ATTN = (("gemma-2b", 8, 1, 256), ("minitron-8b", 32, 8, 128))


def mma_ptxas(tile="Li8ELi64E"):
    """Registers and spill-store bytes of each built entry point of the
    bf16 attention body at one tile (``<KV, 8, 64>``: the 128-row tile
    that hd 256 runs on), from ``build.build_info["ptxas"]``."""
    from repro_torch.kernels import build
    out = {}
    for src, report in build.build_info["ptxas"].items():
        for part in report.split("Compiling entry function '")[1:]:
            name = part.split("'", 1)[0]
            if "flash_attn_kernel_mma" not in name or tile not in name:
                continue
            regs = re.search(r"Used (\d+) registers", part)
            spill = re.search(r"(\d+) bytes spill stores", part)
            kind = "paged" if "Paged" in name else "dense"
            out[f"{src} {kind}"] = {
                "registers": int(regs.group(1)) if regs else None,
                "spill_stores": int(spill.group(1)) if spill else None}
    return out


def check_flash_dense_models(torch, rng, res, gm, mn, gm1, dev):
    """The attention of the gemma-2b and minitron-8b serves at their step
    shapes (``gm`` / ``mn``: 4 slots, chunk 64): a prefill chunk ending at
    key 1024, a decode at key 1001, a prompt's first 37 rows, an idle slot.
    One dense cache per dtype, (B, max_len, nkv, hd) as the dense backend
    holds it, and the same cache as shuffled 16-token pages: flash_chunk
    and flash_chunk_paged against their plain versions (FLASH_TOL; bf16
    also against the f32 plain version), rows past q_len exact zeros,
    paged == dense bitwise.  The bf16 records carry their times, the
    dense one SDPA's with the boolean mask (no single call takes block
    tables).  Then flash_decode at gemma's chunk-1 step (``gm1``) and at
    a 1024-key cache."""
    import numpy as np
    ops, ref = _ops()
    print(f"[build] the 128-row bf16 attention tile hd 256 runs on: "
          f"{json.dumps(mma_ptxas())}")
    for (label, nq, nkv, hd), sh in zip(DENSE_ATTN, (gm, mn)):
        B, sq, S = sh["max_batch"], sh["chunk"], sh["max_len"]
        q_off = ([1024 - sq, 1000, 0, 0] + [0] * B)[:B]
        q_len = ([sq, 1, 37, 0] + [0] * B)[:B]
        kv_len = [o + n for o, n in zip(q_off, q_len)]
        for dtype in (torch.bfloat16, torch.float32):
            d = dname(dtype)
            q, k, v, off, ql, kl = _dense_case(
                torch, rng, b=B, sq=sq, nq=nq, nkv=nkv, hd=hd, hdv=hd,
                skv=S, q_off=q_off, q_len=q_len, kv_len=kv_len, dtype=dtype,
                dev=dev)
            nb = S // 16
            bt = torch.randperm(B * nb, device=dev).reshape(B, nb) \
                .to(torch.int32)
            kp = torch.empty(B * nb, 16, nkv, hd, dtype=dtype, device=dev)
            vp = torch.empty_like(kp)
            kp[bt.long()] = k.reshape(B, nb, 16, nkv, hd)
            vp[bt.long()] = v.reshape(B, nb, 16, nkv, hd)
            dense_args = (q, k, v, off, ql, kl)
            paged_args = (q, kp, vp, bt, off, ql, kl)
            got = ops.flash_chunk(*dense_args)
            got_p = ops.flash_chunk_paged(*paged_args)
            want = ref.flash_chunk_ref(*dense_args)
            torch.cuda.synchronize()
            same = torch.equal(got, got_p)
            zeros = all(bool((got[i, q_len[i]:] == 0).all())
                        for i in range(B))
            want32 = ref.flash_chunk_ref(*_upcast(dense_args)) \
                if dtype == torch.bfloat16 else None
            bts, flops = _attn_work(q_off, q_len, kv_len, nq, nkv, hd, hd, 2)
            shape = (f"q {tuple(q.shape)} k {tuple(k.shape)} (pools "
                     f"{tuple(kp.shape)}) q_len {q_len} kv_len {kv_len}")
            for name, out, args, fn, plain, extra in (
                    ("flash_chunk", got, dense_args, ops.flash_chunk,
                     ref.flash_chunk_ref, 0),
                    ("flash_chunk_paged", got_p, paged_args,
                     ops.flash_chunk_paged, ref.flash_chunk_paged_ref,
                     4 * bt.numel())):
                ok = within(torch, out, want, *FLASH_TOL[d]) and zeros \
                    and same
                rec = {"label": f"{label} step {d}",
                       "max_err": max_err(torch, out, want),
                       "tol": list(FLASH_TOL[d]), "ok": ok,
                       "paged_equals_dense": same, "shape": shape}
                if want32 is not None:
                    rec.update(max_err_vs_f32=max_err(torch, out, want32),
                               tol_vs_f32=list(FLASH_TOL_VS_F32))
                    rec["ok"] = ok and within(torch, out, want32,
                                              *FLASH_TOL_VS_F32)
                    lib = _sdpa_call(torch, *dense_args, hd ** -0.5, want) \
                        if name == "flash_chunk" else None
                    time_rec(torch, rec, lambda fn=fn, a=args: fn(*a), 50,
                             lambda pl=plain, a=args: pl(*a), 5, lib)
                    rec.update(bytes=bts + out.numel() * 2 + extra,
                               flops=flops, peak="bf16", primary=False)
                res.add(name, rec, "disagrees with its plain version, or "
                                   "paged != dense")
            del q, k, v, kp, vp, got, got_p, want, want32
        free_memory(torch)

    # flash_decode at gemma's chunk-1 step, and at a cache as long as the
    # chunk-64 serve's
    _, nq, nkv, hd = DENSE_ATTN[0]
    B1, S1, S = gm1["max_batch"], gm1["max_len"], gm["max_len"]
    for S_, lens in ((S1, ([S1, 1, S1 // 2 + 5, 0] + [0] * B1)[:B1]),
                     (S, [1024, 1, 517, 0][:gm["max_batch"]])):
        for dtype in (torch.bfloat16, torch.float32):
            d = dname(dtype)
            b = len(lens)
            q, k, v, *_ = _dense_case(torch, rng, b=b, sq=1, nq=nq, nkv=nkv,
                                      hd=hd, hdv=hd, skv=S_, q_off=lens,
                                      q_len=lens, kv_len=lens, dtype=dtype,
                                      dev=dev)
            q = q[:, 0].contiguous()
            ln = _i32(torch, lens, dev)
            got = ops.flash_decode(q, k, v, ln)
            want = ref.flash_decode_ref(q, k, v, ln)
            torch.cuda.synchronize()
            ok = within(torch, got, want, *FLASH_TOL[d]) and all(
                bool((got[i] == 0).all()) for i in range(b) if lens[i] == 0)
            rec = {"label": f"flash_decode gemma-2b S={S_} {d}",
                   "max_err": max_err(torch, got, want),
                   "tol": list(FLASH_TOL[d]), "ok": ok,
                   "shape": f"q {tuple(q.shape)} k {tuple(k.shape)} "
                            f"lengths {lens}"}
            if dtype == torch.bfloat16 and S_ == S1:
                n_ops = _device_ops_per_call(
                    torch, lambda: ops.flash_decode(q, k, v, ln))
                print(f"[kernels] flash_decode gemma-2b S={S_}: device ops "
                      f"per call {json.dumps(n_ops)}")
            if dtype == torch.bfloat16:
                want32 = ref.flash_decode_ref(q.float(), k.float(),
                                              v.float(), ln)
                rec.update(max_err_vs_f32=max_err(torch, got, want32),
                           tol_vs_f32=list(FLASH_TOL_VS_F32))
                rec["ok"] = ok and within(torch, got, want32,
                                          *FLASH_TOL_VS_F32)
                q_off = [max(n - 1, 0) for n in lens]
                q_len = [min(n, 1) for n in lens]
                lib = _sdpa_call(torch, q[:, None], k, v, *(
                    _i32(torch, a, dev) for a in (q_off, q_len, lens)),
                    hd ** -0.5, want[:, None])
                time_rec(torch, rec, lambda: ops.flash_decode(q, k, v, ln),
                         50, lambda: ref.flash_decode_ref(q, k, v, ln), 10,
                         lib)
                bts, flops = _attn_work(q_off, q_len, lens, nq, nkv, hd, hd,
                                        2)
                rec.update(bytes=bts + got.numel() * 2, flops=flops,
                           peak="bf16")
            res.add("flash_chunk", rec, "flash_decode disagrees with its "
                                        "plain version")
    free_memory(torch)


def check_flash_spec(torch, rng, res, sp, dev):
    """The two geometries speculative decoding adds (``sp``: the phi3.5
    speculated serve's shapes, ``spec_shapes``): flash_chunk_paged with
    four decode slots verifying 1 + SPEC_K rows each inside the chunk-64
    step, and flash_chunk at the self draft's (max_batch, DRAFT_CHUNK)
    step on its (max_batch, max_len) dense cache, one proposal row a slot.
    bf16 and f32 against the plain versions (FLASH_TOL; bf16 also against
    the f32 plain version), rows past q_len exact zeros; the bf16 records
    timed beside SDPA with the boolean mask (for the paged step on the
    same keys gathered into a dense cache: no single call takes block
    tables) and their bound."""
    from repro_torch.serving.draft import DRAFT_CHUNK
    ops, ref = _ops()
    B, S, page = sp["max_batch"], sp["max_len"], 16
    nq, nkv, hd = 32, 8, 128
    rows = 1 + SPEC_K
    verify = (sp["chunk"], ([35, 64, 97, S - rows] + [0] * B)[:B],
              ([rows] * 4 + [0] * B)[:B])
    draft = (DRAFT_CHUNK, ([36, 71, 99, S - 1] + [0] * B)[:B],
             ([1] * 4 + [0] * B)[:B])
    for name, (sq, q_off, q_len) in (("flash_chunk_paged", verify),
                                     ("flash_chunk", draft)):
        kv_len = [o + n for o, n in zip(q_off, q_len)]
        for dtype in (torch.bfloat16, torch.float32):
            d = dname(dtype)
            if name == "flash_chunk_paged":
                args = _paged_case(torch, rng, b=B, sq=sq, nq=nq, nkv=nkv,
                                   hd=hd, page=page, nb=S // page,
                                   n_pages=sp["pool_pages"], q_off=q_off,
                                   q_len=q_len, kv_len=kv_len, dtype=dtype,
                                   dev=dev)
                fn, plain = ops.flash_chunk_paged, ref.flash_chunk_paged_ref
                q, kp, vp, bt = args[:4]
                dense = (q, *(p[bt.clamp_min(0).long()].reshape(
                    B, S, nkv, hd) for p in (kp, vp)), *args[4:])
                label = (f"phi3.5 verify step, {B} slots x {rows} rows in "
                         f"chunk {sq} {d}")
                extra = 4 * bt.numel()
            else:
                args = _dense_case(torch, rng, b=B, sq=sq, nq=nq, nkv=nkv,
                                   hd=hd, hdv=hd, skv=S, q_off=q_off,
                                   q_len=q_len, kv_len=kv_len, dtype=dtype,
                                   dev=dev)
                fn, plain, dense = ops.flash_chunk, ref.flash_chunk_ref, args
                label = (f"phi3.5 self draft step ({B}, {sq}) on a ({B}, "
                         f"{S}) cache {d}")
                extra = 0
            got, want = fn(*args), plain(*args)
            torch.cuda.synchronize()
            ok = within(torch, got, want, *FLASH_TOL[d]) and all(
                bool((got[i, q_len[i]:] == 0).all()) for i in range(B))
            rec = {"label": label, "max_err": max_err(torch, got, want),
                   "tol": list(FLASH_TOL[d]), "ok": ok,
                   "shape": f"q {tuple(args[0].shape)} k "
                            f"{tuple(args[1].shape)} q_len {q_len} "
                            f"kv_len {kv_len}"}
            if dtype == torch.bfloat16:
                want32 = plain(*_upcast(args))
                rec.update(max_err_vs_f32=max_err(torch, got, want32),
                           tol_vs_f32=list(FLASH_TOL_VS_F32))
                rec["ok"] = ok and within(torch, got, want32,
                                          *FLASH_TOL_VS_F32)
                time_rec(torch, rec, lambda f=fn, a=args: f(*a), 50,
                         lambda pl=plain, a=args: pl(*a), 5,
                         _sdpa_call(torch, *dense, hd ** -0.5, want))
                bts, flops = _attn_work(q_off, q_len, kv_len, nq, nkv, hd,
                                        hd, 2)
                rec.update(bytes=bts + got.numel() * 2 + extra, flops=flops,
                           peak="bf16", primary=False)
            res.add(name, rec, "disagrees with its plain version at a "
                               "speculative geometry")
            del args, got, want, dense
        free_memory(torch)


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


def phase_kernels(torch, phi, ds, ds1, dsh, dense=None, spec=None,
                  front=None):
    """phi / ds / ds1: the resolved shapes of the phi3.5 serve, the
    deepseek serve and the deepseek chunk=1 serve, each with the capacity
    ``C`` its capacity-dispatch serve gives; dsh: the distributed serve's
    per-rank shapes; ``dense``: those of the gemma-2b, minitron-8b and
    gemma chunk=1 serves (``resolve_dense_shapes``), or None to skip
    their attention records; ``spec``: the phi3.5 speculated serve's
    (``spec_shapes``), or None to skip the speculative geometries;
    ``front``: the frontend serves' envelopes and attention geometries
    (``resolve_front_shapes``), or None to skip them."""
    import numpy as np
    from repro_torch.configs.paper_models import PAPER_MODELS
    from repro_torch.core.resolve import AUTO_BATCH_CAP
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    res = Results()
    check_flash_paged(torch, rng, res, phi, dev)
    check_flash_paged(torch, rng, res, dsh["attn"], dev,
                      label="phi3.5 one rank of the sharded serve",
                      heads=dsh["attn"]["heads"], primary=False)
    check_flash_dense(torch, rng, res, ds, ds1, dev)
    check_flash_contracts(torch, rng, dev)
    check_flash_split(torch, rng, dev)
    if dense is not None:
        check_flash_dense_models(torch, rng, res, *dense, dev)
    if spec is not None:
        check_flash_spec(torch, rng, res, spec, dev)
    if front is not None:
        check_flash_frontend(torch, rng, res, front, dev)
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
    knobs = {"kv": "paged", **knobs}
    for kern in ("on", "off"):
        llm = LLM.from_spec(
            ServeSpec(kernels=kern, reduced=False, max_batch=4,
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
    kv = knobs["kv"]
    print(f"[parity] {cfg.name} f32 full width, chunk {knobs['chunk']}, "
          f"dispatch {knobs.get('dispatch', 'auto')}, kv "
          f"{getattr(kv, 'backend', kv)}: "
          f"first-step logits max err {err:.3e} (tol 1e-3), greedy streams "
          f"equal: {equal}; kernels-on launches {launches['on']}")
    check(err <= 1e-3, f"parity: first-step logits differ by {err}")
    check(equal, f"parity: streams differ\n on={streams['on']}\n "
                 f"off={streams['off']}")
    check(all(launches["on"].get(k, 0) > 0 for k in expect)
          and not launches["off"],
          f"parity: kernels-on run launched {launches['on']}, expected "
          f"{expect}; kernels-off {launches['off']}")
    return {"logits_max_err": err, "streams_equal": equal,
            "first": {k: v[1][live] for k, v in first.items()},
            "streams": streams}


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
    out.update(phase_parity_dense(torch, gen))
    return out


def phase_parity_dense(torch, gen):
    """gemma-2b and minitron-8b, 2 layers, f32, full width, chunk 32:
    kernels on against off on the paged backend (flash_chunk_paged) and on
    the dense one (flash_chunk); then dense against paged with the prefix
    cache off and the same chunking: first-step logits bitwise equal on
    the scheduled slots (an idle slot's row is garbage that differs with
    the buffer's stale rows) and the streams equal, kernels on and off
    alike."""
    from repro_torch.core.resolve import KVConfig
    from repro_torch.models.model import init_params
    knobs = dict(max_len=256, chunk=32, prompt_len=200)
    lens = (40, 100, 200, 150)
    out = {}
    for arch in ("gemma-2b", "minitron-8b"):
        cfg = _cut(arch, 2)
        params = init_params(gen.manual_seed(1), cfg, torch.float32, "cuda")
        runs = {}
        for kv, expect in ((KVConfig(backend="paged", prefix_cache=False),
                            ("flash_chunk_paged",)),
                           ("dense", ("flash_chunk",))):
            name = getattr(kv, "backend", kv)
            runs[name] = _parity(torch, cfg, params, dict(knobs, kv=kv),
                                 lens, 8, expect)
            out[f"{arch} {name}"] = {k: runs[name][k] for k in (
                "logits_max_err", "streams_equal")}
        same = {k: bool(torch.equal(runs["dense"]["first"][k],
                                    runs["paged"]["first"][k]))
                for k in ("on", "off")}
        streams = runs["dense"]["streams"] == runs["paged"]["streams"]
        print(f"[parity] {cfg.name} f32, dense against paged (prefix cache "
              f"off, chunk 32): first-step logits bitwise equal "
              f"{same}, streams equal: {streams}")
        check(all(same.values()) and streams,
              f"parity: {cfg.name} dense and paged differ ({same}, streams "
              f"{streams})")
        out[f"{arch} dense == paged"] = {"bitwise": same, "streams": streams}
        del params, runs
        free_memory(torch)
    return out


def expected_launches(per_step, steps, per_draft=None, d_fwd=0,
                       per_prefill=None, prefills=0):
    """Launches of ``steps`` steps at ``per_step`` each plus ``d_fwd``
    draft forwards at ``per_draft`` each and ``prefills`` blocking
    prefills at ``per_prefill`` each (zero counts left out, as the
    counters leave them)."""
    want: dict = {}
    for per, n in ((per_step, steps), (per_draft or {}, d_fwd),
                   (per_prefill or {}, prefills)):
        for k, v in per.items():
            if v * n:
                want[k] = want.get(k, 0) + v * n
    return want


def _serve(torch, llm, prompts, new, per_step, card_line, label,
           per_draft=None, per_prefill=None):
    """Submit every prompt, stream to the end, check the tokens and the
    exact launch counts: ``per_step`` a step (unified, or a legacy decode
    step), plus ``per_draft`` a forward of the engine's draft model when
    speculating and ``per_prefill`` a legacy blocking prefill; print TTFT
    / ITL / tok/s / memory."""
    import numpy as np
    from repro_torch.kernels import ops
    eng = llm.engine
    draft = eng.draft
    d0 = getattr(draft, "n_forward", 0)
    ops.reset_counters()
    n0, p0 = eng.n_forward, eng.n_prefill
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
    prefills = eng.n_prefill - p0
    d_fwd = getattr(draft, "n_forward", 0) - d0
    n_tok = sum(len(v) for v in outs.values())
    ttft = [t_tok[r][0] - t_sub[r] for r in t_sub]
    itl = [(t_tok[r][-1] - t_tok[r][0]) / (len(t_tok[r]) - 1)
           for r in t_sub if len(t_tok[r]) > 1]
    hits = eng.kv.stats.n_prefix_hits
    mem = torch.cuda.max_memory_allocated() / 2**30
    print(f"[serve] {label}: {len(prompts)} requests, {n_tok} new tokens, "
          f"{steps} unified steps in {wall:.2f}s "
          f"({wall / max(steps, 1) * 1e3:.1f} ms/step): "
          f"{n_tok / wall:.1f} tok/s, "
          f"TTFT mean {np.mean(ttft) * 1e3:.0f} ms / max "
          f"{max(ttft) * 1e3:.0f} ms, ITL mean {np.mean(itl) * 1e3:.1f} ms, "
          f"prefix hits {hits}, max_memory_allocated {mem:.1f} GiB "
          f"[{card_line}]")
    want = expected_launches(per_step, steps, per_draft, d_fwd,
                             per_prefill, prefills)
    print(f"[serve] {label}: kernel launches {launches} (expect per step "
          f"{per_step}" + (f", per draft forward {per_draft} x {d_fwd}"
                           if per_draft else "")
          + (f", per blocking prefill {per_prefill} x {prefills}"
             if per_prefill else "") + ")")
    check(all(len(outs.get(r, [])) == new for r in t_sub),
          f"serve {label}: a request did not finish with {new} tokens")
    check(all(0 <= t < llm.cfg.vocab_size for v in outs.values() for t in v),
          f"serve {label}: token id outside the vocabulary")
    check(steps > 0 and launches == want,
          f"serve {label}: launch counters {launches} != {want}")
    return {"launches": launches, "steps": steps, "wall_s": wall,
            "tok_s": n_tok / wall, "draft_forwards": d_fwd,
            "prefills": prefills,
            "streams": [outs[r] for r in t_sub],
            "ttft_ms": float(np.mean(ttft) * 1e3),
            "itl_ms": float(np.mean(itl) * 1e3), "prefix_hits": hits,
            "max_mem_gib": mem,
            "shapes": {"max_batch": llm.spec.max_batch, "chunk": eng.chunk,
                       "max_len": eng.max_len,
                       "pool_pages": getattr(eng.kv, "n_pages", None)}}


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
    # the forward's MoE entry (a tree from before moe_rank calls moe_block)
    entry = "moe_rank" if hasattr(moe, "moe_rank") else "moe_block"
    block = getattr(moe, entry)

    def counted(p, x, cfg, plan, **kw):
        r = block(p, x, cfg, plan, **kw)
        sink.append((x.shape[0] * x.shape[1], r[2]))
        return r
    torch.cuda.reset_peak_memory_stats()
    setattr(moe, entry, counted)
    try:
        out = _serve(torch, llm, prompts, new, per_step, card_line, label)
    finally:
        setattr(moe, entry, block)
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


def _load(torch, spec, cfg, card_line, **kw):
    from repro_torch.serving.api import LLM
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    llm = LLM.from_spec(spec, cfg=cfg, device="cuda", dtype=torch.bfloat16,
                        **kw)
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name} bf16 weights ready in "
          f"{time.perf_counter() - t0:.1f}s, max_memory_allocated while "
          f"loading {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB "
          f"(each leaf drawn in float32, then cast) [{card_line}]; "
          f"resolved:\n{llm.spec.describe()}")
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


# the indices of dense_prompts' prompts that share the 512-token prefix
DENSE_SHARED = (0, 4, 5, 6)
# the dense models' serves run half their depth (the per-layer costs are
# what they measure), as do the recurrent families' (REC_LAYERS): it
# keeps the whole script well inside its time limit on a slow host
DENSE_LAYERS = {"gemma-2b": 9, "minitron-8b": 16}


def dense_prompts(cfg, seed):
    """The dense models' serve: 8 prompts of 64-1024 tokens, 4 sharing a
    512-token prefix (the first, and three admitted after it finishes)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab_size, 512).astype(np.int32)
    tail = lambda n: rng.integers(0, cfg.vocab_size, n).astype(np.int32)
    prompts = ([np.concatenate([shared, tail(100)])]
               + [tail(n) for n in (64, 1024, 300)]
               + [np.concatenate([shared, tail(n)]) for n in (40, 250, 480)]
               + [tail(700)])
    return rng, prompts, tail


def phase_serve_dense(torch, card_line):
    """gemma-2b and minitron-8b at full width and DENSE_LAYERS depth,
    bf16: the paged serve (one flash_chunk_paged a layer a step,
    with a profiler window), then kv="dense" on the same weights (one
    flash_chunk a layer a step; the dense backend has no prefix index, so
    the shared-prefix prompts are prefilled whole and the two runs' steps
    differ: how many streams agree is printed, not held); then gemma at
    chunk=1 on the dense backend (flash_decode, which launches
    flash_chunk, a layer a step)."""
    from repro_torch.serving.api import LLM
    out = {}
    for arch, seed in (("gemma-2b", 4), ("minitron-8b", 5)):
        cfg = _cut(arch, DENSE_LAYERS[arch])
        n = cfg.n_layers
        rng, prompts, tail = dense_prompts(cfg, seed)
        llm = _load(torch, dense_spec(), cfg, card_line)
        label = f"{arch} ({n} layers)"
        torch.cuda.reset_peak_memory_stats()     # the serve's own peak
        paged = _serve(torch, llm, prompts, 32, {"flash_chunk_paged": n},
                       card_line, label + ", paged")
        check(paged["prefix_hits"] >= 1, "serve: no prefix hit")
        phase_profile(torch, llm, rng, label + ", paged")
        params = llm.params
        del llm
        free_memory(torch)
        torch.cuda.reset_peak_memory_stats()
        llm = LLM.from_spec(dense_spec("dense"), cfg=cfg, params=params,
                            device="cuda", dtype=torch.bfloat16)
        check(llm.engine.kv.backend == "dense", "kv='dense' did not resolve")
        dense = _serve(torch, llm, prompts, 32, {"flash_chunk": n},
                       card_line, label + ", dense")
        differ = [i for i, (a, b) in enumerate(zip(paged["streams"],
                                                   dense["streams"]))
                  if a != b]
        print(f"[serve] {label}: {len(prompts) - len(differ)} of "
              f"{len(prompts)} streams of the dense serve equal the paged "
              f"serve's (bf16; not held: the steps differ); differing "
              f"streams {differ}, of which shared-prefix prompts "
              f"{[i for i in differ if i in DENSE_SHARED]} (the shared-"
              f"prefix prompts are {list(DENSE_SHARED)})")
        out[arch] = {"paged": paged, "dense": dense}
        del llm
        free_memory(torch)
        if arch == "gemma-2b":
            small = LLM.from_spec(dense1_spec(), cfg=cfg, params=params,
                                  device="cuda", dtype=torch.bfloat16)
            out["gemma-2b chunk=1"] = _serve(
                torch, small, [tail(16), tail(24)], 4,
                {"flash_decode": n, "flash_chunk": n}, card_line,
                f"{label}, dense, chunk=1")
            del small
        del params
        free_memory(torch)
    return out


def phase_profile(torch, llm, rng, label, prompt_len=256):
    """Where the device time goes: torch.profiler over a short extra run
    on the same engine (4 fresh prompts of ``prompt_len`` tokens, 8 new
    tokens each; not part of the counted main-path run).  Prints each
    kernel family's share of device time and the device's idle share of
    the window, and returns the device busy ms and the idle share."""
    from torch.profiler import ProfilerActivity, profile
    prompts = [rng.integers(0, llm.cfg.vocab_size, prompt_len)
               .astype("int32") for _ in range(4)]
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
    print(f"[profile] {label}, 4x{prompt_len}-token prompts + 8 new tokens: "
          f"window {wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms, "
          f"idle share {max(0.0, 1 - busy / wall_us):.3f} (profiler on); "
          f"device-time shares {json.dumps(shares)}")
    top.sort(reverse=True)
    print(f"[profile] {label}: largest other kernels: " + "; ".join(
        f"{name} {us / 1e3:.1f} ms" for us, name in top[:5]))
    return {"busy_ms": busy / 1e3, "idle_share": max(0.0, 1 - busy / wall_us),
            "family_ms": {k: v / 1e3 for k, v in groups.items() if v > 0}}


# ---------------------------------------------------------------------------
# phase 4c: the recurrent families on the legacy blocking path
# ---------------------------------------------------------------------------

# 8 prompts of 64-1024 tokens, two exactly a bucket long (64 and 512)
REC_LENS = (64, 1000, 300, 512, 130, 700, 250, 900)
REC_LAYERS = {"rwkv6-1.6b": 12, "recurrentgemma-9b": 19}
REC_NEW = 32
REC_PARITY = (("rwkv6-1.6b", 2, {}),
              ("recurrentgemma-9b", 3, {"window_size": 64}))


def rec_spec(**kw):
    """The recurrent serves: kv="auto" (the dense cache of the legacy
    path), max_batch 4, max_len 2048."""
    return _spec("auto", **{"prompt_len": 1024, "max_new_tokens": REC_NEW,
                            "max_len": 2048, **kw})


def _greedy_loop(torch, cfg, params, prompt, new, max_len, dtype):
    """Greedy decode through forward(cache=) from an unpadded prefill:
    (tokens, each step's logits (new, V))."""
    from repro_torch.models.model import forward, init_cache
    cache = init_cache(cfg, 1, max_len, dtype, "cuda")
    out = forward(params, cfg, tokens=torch.as_tensor(
        prompt, device="cuda").long()[None], cache=cache)
    rows = [out.logits[0, -1]]
    toks = [int(rows[-1].argmax())]
    while len(toks) < new:
        out = forward(params, cfg, tokens=torch.tensor(
            [[toks[-1]]], device="cuda"), cache=cache)
        rows.append(out.logits[0, 0])
        toks.append(int(rows[-1].argmax()))
    return toks, torch.stack(rows)


# loop against stateless logits: rtol 1e-4 plus this share of the largest
# |logit|, by arch and dtype.  1e-4 is the CPU tests' bound.  Only
# recurrentgemma's attention needs 1e-3 in f32, as the sharded logits of
# phase 5 do: the random init's attention scores reach ~1e3 there (wq and
# wk drawn with the head count as fan-in), where an f32 score carries
# ~6e-5 of rounding, and the one-row ring decode sums them in another
# order than the stateless forward (1.545e-03 against a 1e-4 bound of
# 6.693e-04 on an H100; rwkv6 1.287e-05 against 4.994e-04).  f64 holds
# 1e-4 for both (the attention body still sums its scores in f32, as the
# reference's does: 3.750e-04); a wrong ring or state would miss either
# by far
REC_ATOL = {"rwkv6-1.6b": {"float32": 1e-4, "float64": 1e-4},
            "recurrentgemma-9b": {"float32": 1e-3, "float64": 1e-4}}

# the recurrent leaves init_params sets to zero (as the reference does), by
# the sublayer that holds them: at zero the token shift ignores the
# previous row (mu), the bonus vanishes, and the conv taps keep the RG-LRU's
# input and state at zero, so a fault in the carried state would not show.
# The parity checks draw them
REC_LEAVES = {"tm": ("mu", "w0", "bonus", "ln_x"), "cm": ("mu",),
              "rglru": ("conv_w", "conv_b", "b_input_gate", "b_rec_gate",
                        "lambda_p")}


def draw_recurrent_leaves(torch, tree, gen):
    """``tree`` (the port's params) with every REC_LEAVES leaf drawn from
    ``gen``: the mixes uniform in [0, 1], lambda_p from N(-2, 1) (decays
    ~0.3-0.8), the rest from N(0, 0.25)."""
    def leaf(old, name):
        z = torch.randn(old.shape, generator=gen, device=old.device)
        if name == "mu":
            z = torch.rand(old.shape, generator=gen, device=old.device)
        elif name == "lambda_p":
            z = z - 2.0
        else:
            z = 0.5 * z
        return z.to(old.dtype)

    def walk(node, key=None):
        if isinstance(node, dict):
            names = REC_LEAVES.get(key, ())
            return {k: leaf(v, k) if k in names else walk(v, k)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, key) for v in node)
        return node
    return walk(tree)


def rec_parity(torch, gen, arch, layers, over):
    """Full width, reduced depth, f32 and then f64 on the same weights: the
    engine's 48-token greedy stream of one 64-token prompt (its own
    bucket: no padding) equals a greedy loop through forward(cache=), and
    the loop's logits at every step match the stateless forward over the
    same tokens within rtol 1e-4 plus REC_ATOL of the largest |logit|
    (recurrentgemma: window 64, so the ring wraps); no kernel launches.
    The zero-initialised recurrent leaves are drawn
    (``draw_recurrent_leaves``)."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.models.model import forward, init_params
    from repro_torch.serving.api import LLM
    cfg = dataclasses.replace(_cut(arch, layers), **over)
    prompt = np.random.default_rng(7).integers(
        0, cfg.vocab_size, 64).astype(np.int32)
    new = 48
    out = {}
    for dtype in (torch.float32, torch.float64):
        dn = dname(dtype)
        params = draw_recurrent_leaves(
            torch, init_params(gen.manual_seed(1), cfg, dtype, "cuda"), gen)
        ops.reset_counters()
        llm = LLM.from_spec(_spec("auto", max_batch=1, max_len=256,
                                  prompt_len=64, max_new_tokens=new),
                            cfg=cfg, params=params, device="cuda",
                            dtype=dtype)
        check(llm.engine.legacy and llm.engine.kv.backend == "dense",
              f"{arch}: not on the legacy path's dense cache")
        served = llm.generate([prompt], new)[0]
        loop, rows = _greedy_loop(torch, cfg, params, prompt, new, 256,
                                  dtype)
        full = forward(params, cfg, tokens=torch.as_tensor(
            np.concatenate([prompt, loop[:-1]]), device="cuda").long()[None])
        want = full.logits[0, len(prompt) - 1:]
        # the stateless forward's last prompt row over the prompt alone
        alone = forward(params, cfg, tokens=torch.as_tensor(
            prompt, device="cuda").long()[None]).logits[0, -1]
        gap = max_err(torch, alone, want[0])
        torch.cuda.synchronize()
        err = max_err(torch, rows, want)
        bound = REC_ATOL[arch][dn] * float(want.abs().max())
        ok = bool(((rows - want).abs() <= 1e-4 * want.abs() + bound).all())
        launches = dict(ops.counters)
        print(f"[recurrent] {cfg.name} {dn} full width, {layers} layers"
              + (f", window {cfg.window_size}" if cfg.window_size else "")
              + f": engine stream == greedy loop: {served == loop}; loop "
              f"logits vs stateless forward max err {err:.3e} (bound rtol "
              f"1e-4 + {bound:.3e}, {REC_ATOL[arch][dn]:g} of the largest "
              f"|logit| {float(want.abs().max()):.3f}): {ok}; the "
              f"stateless forward's row {len(prompt) - 1} over "
              f"{len(prompt)} rows against over {len(loop) + len(prompt) - 1}"
              f" rows (shape_gap) {gap:.3e}; kernel launches {launches}")
        check(served == loop,
              f"{arch} {dn}: engine stream {served} != loop {loop}")
        check(ok, f"{arch} {dn}: cached logits differ from the stateless "
                  f"forward by {err}")
        check(not launches, f"{arch}: the recurrent path launched "
                            f"{launches}")
        out[dn] = {"logits_max_err": err, "bound": bound, "shape_gap": gap}
        del llm, params, full
        free_memory(torch)
    return out


def _serve_legacy(torch, llm, prompts, card_line, label, new=REC_NEW,
                  per_step=None, per_prefill=None):
    """``_serve`` on a legacy-path engine (exact launches: ``per_step`` a
    decode step and ``per_prefill`` a blocking prefill; none by default),
    with the blocking prefills' share of the wall time: admission runs
    the prefill and reads its first token back, so its host time is
    device-complete."""
    eng = llm.engine
    admit = eng._admit_legacy
    spent = [0.0, 0]

    def timed(req, slot):
        t0 = time.perf_counter()
        try:
            return admit(req, slot)
        finally:
            spent[0] += time.perf_counter() - t0
            spent[1] += 1
    eng._admit_legacy = timed
    try:
        out = _serve(torch, llm, prompts, new, per_step or {}, card_line,
                     label, per_prefill=per_prefill)
    finally:
        del eng._admit_legacy
    share = spent[0] / out["wall_s"]
    from repro_torch.serving.engine import _bucket
    rows = sum(_bucket(len(p)) + eng._front_len() for p in prompts)
    print(f"[serve] {label}: {spent[1]} blocking prefills "
          f"({rows} bucket rows, the frontend's included) "
          f"{spent[0]:.2f}s = {share:.3f} of the wall time; "
          f"{out['steps']} decode steps, "
          f"{(out['wall_s'] - spent[0]) / out['steps'] * 1e3:.1f} ms a "
          f"decode step (the rest of the wall time over them)")
    out.update(prefill_s=spent[0], prefill_share=share)
    return out


def phase_serve_recurrent(torch, card_line):
    """rwkv6-1.6b (12 of 24 layers) and recurrentgemma-9b (19 of 38: six
    (rec, rec, attn) patterns and a rec), bf16, on the legacy blocking
    path: 8 prompts (REC_LENS) padded to their
    buckets, 32 new tokens each, max_batch 4, max_len 2048; no kernel
    counter may move; a profiler window on each; then the f32 checks at
    reduced depth (``rec_parity``)."""
    import numpy as np
    out = {}
    for arch, seed in (("rwkv6-1.6b", 6), ("recurrentgemma-9b", 7)):
        cfg = _cut(arch, REC_LAYERS[arch])
        rng = np.random.default_rng(seed)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in REC_LENS]
        llm = _load(torch, rec_spec(), cfg, card_line)
        check(llm.engine.legacy and llm.engine.kv.backend == "dense"
              and llm.engine.draft is None,
              f"{arch}: not on the legacy path's dense cache")
        label = f"{arch} ({cfg.n_layers} layers, legacy path)"
        torch.cuda.reset_peak_memory_stats()
        out[arch] = _serve_legacy(torch, llm, prompts, card_line, label)
        # short prompts: the recurrences' per-token prefill loop emits
        # ~100k events a 1024-token bucket, which the profiler takes
        # minutes to reduce
        out[arch]["profile"] = phase_profile(torch, llm, rng, label,
                                             prompt_len=32)
        del llm
        free_memory(torch)
    gen = torch.Generator(device="cuda")
    for arch, layers, over in REC_PARITY:
        out[f"{arch} parity"] = rec_parity(torch, gen, arch, layers, over)
    return out


# ---------------------------------------------------------------------------
# phase 4d: the frontend families on the legacy blocking path
# ---------------------------------------------------------------------------

# the bf16 serves: 8 prompts a model (qwen2-vl: 64-1024 tokens, two a
# bucket long; whisper: 16-256, three a bucket long), max_batch 4; the
# profiler window's prompt length is one of the served buckets, so its
# kernel geometries are the serve's
FRONT_SERVES = {
    "qwen2-vl-7b": dict(lens=(64, 1024, 300, 512, 130, 700, 250, 900),
                        new=32, max_len=2048, profile_len=64, seed=8),
    "whisper-tiny": dict(lens=(16, 256, 100, 32, 200, 64, 150, 240),
                         new=64, max_len=512, profile_len=32, seed=9),
}
# the f32 checks at full width: qwen2-vl at 3 layers, whisper whole
FRONT_PARITY = (("qwen2-vl-7b", 3), ("whisper-tiny", None))
FRONT_PARITY_LENS = (40, 100, 200)
FRONT_PARITY_NEW = 8
# The f32 checks' bound: rtol 1e-4 plus the larger of 1e-4 of the largest
# |logit| (the CPU tests' bound) and ``ulp_gap``, how far the stateless
# logits move when the first layer's norm weight is scaled by 1 + 2^-23.
# At full width the random init (wq / wk drawn with the head count as
# fan-in: peaked attention; whisper's cross-attention over 1500 iid
# frames) makes the logits chaotic in f32: on an H100 that one-ulp change
# moves them by 1.377e-02 (qwen2-vl, 3 layers) and 1.456e-01 (whisper),
# the plain bodies' own cached loop differs from the stateless forward by
# 4.217e-03 / 3.843e-02, and kernels on against off by 1.202e-03 /
# 3.360e-03, while 1e-4 of the largest |logit| is ~5.4e-04 (each f32
# kernel alone matches its plain version to 7.2e-07 at these geometries).
# So the kernels' f32 order may move the logits no more than one ulp at
# the input does; the reduced CPU and card tests hold 1e-4.
# the norm weights init_params sets to zero (as the reference does): at
# zero a swapped or skipped norm would not show, so the f32 checks draw
# them, as the CPU tests do
FRONT_NORMS = ("norm", "mlp_norm", "final_norm")


def front_spec(arch, **kw):
    """A frontend serve: kv="auto" (the legacy path's dense cache)."""
    sv = FRONT_SERVES[arch]
    return _spec("auto", **{"prompt_len": max(sv["lens"]),
                            "max_new_tokens": sv["new"],
                            "max_len": sv["max_len"], **kw})


def front_stub(torch, cfg, seed):
    """(forward keyword, tensor) of one seeded stub input, f32 on the
    card: qwen2-vl's (1, 256, 3584) patch embeddings at the embedding
    table's scale (0.02), whisper's (1, 1500, 384) frames from N(0, 1)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if cfg.frontend == "vision_stub":
        return "embeds", 0.02 * torch.randn(
            (1, cfg.n_frontend_tokens, cfg.d_model), generator=gen,
            device="cuda")
    e = cfg.encoder
    return "frames", torch.randn((1, e.n_frames, e.d_model), generator=gen,
                                 device="cuda")


def stub_fn(name, stub):
    """An ``embeds_fn``: the same stub for every admission (the
    reference's interface takes only a batch size)."""
    return lambda b: {name: stub.expand(b, *stub.shape[1:])}


def _geometry(kernel, b, sq, q, k):
    """One attention launch's geometry: (kernel, B, sq, nq, nkv, hd, S,
    dtype)."""
    return (kernel, b, sq, q.shape[-2], k.shape[2], q.shape[-1],
            k.shape[1], dname(q.dtype))


class record_geometries:
    """Within the block, add the geometry of every ``ops.flash_chunk`` /
    ``ops.flash_decode`` call to ``sink`` (the wrappers count and launch
    as before)."""

    def __init__(self, sink):
        self.sink = sink

    def __enter__(self):
        from repro_torch.kernels import ops
        self.ops, self.saved = ops, (ops.flash_chunk, ops.flash_decode)
        chunk, decode = self.saved
        sink = self.sink

        def rec_chunk(q, k, v, *a, **kw):
            sink.add(self.geo("flash_chunk", q, k, v))
            return chunk(q, k, v, *a, **kw)

        def rec_decode(q, k, v, *a, **kw):
            sink.add(self.geo("flash_decode", q, k, v))
            return decode(q, k, v, *a, **kw)
        ops.flash_chunk, ops.flash_decode = rec_chunk, rec_decode
        return sink

    def __exit__(self, *exc):
        self.ops.flash_chunk, self.ops.flash_decode = self.saved

    @staticmethod
    def geo(kernel, q, k, v):
        sq = 1 if kernel == "flash_decode" else q.shape[1]
        return _geometry(kernel, q.shape[0], sq, q, k)


def resolve_front_shapes():
    """Each frontend serve's envelope and the attention geometries its
    bf16 serve and profiler window launch: the blocking prefill of each
    bucket, (1, front + bucket) rows on a (1, max_len) cache, and the
    decode of every slot on the (max_batch, max_len) cache."""
    import repro_torch.configs as C
    from repro_torch.serving.engine import _bucket
    out = {}
    for arch, sv in FRONT_SERVES.items():
        cfg = C.get(arch)
        res = front_spec(arch).resolve(cfg, device="cuda")
        B, S = res.max_batch, res.max_len
        front = cfg.n_frontend_tokens if cfg.frontend == "vision_stub" \
            else 0
        heads = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
        sqs = sorted({front + _bucket(n)
                      for n in sv["lens"] + (sv["profile_len"],)})
        geo = {("flash_chunk", 1, sq) + heads + (S, "bfloat16")
               for sq in sqs}
        geo.add(("flash_decode", B, 1) + heads + (S, "bfloat16"))
        out[arch] = {"max_batch": B, "max_len": S, "front": front,
                     "heads": heads, "prefill_sq": sqs, "geometries": geo}
    print(f"[shapes] frontend serves " + json.dumps(
        {a: {k: v for k, v in d.items() if k != "geometries"}
         for a, d in out.items()}))
    return out


def check_flash_frontend(torch, rng, res, front, dev):
    """flash_chunk at every blocking prefill of the frontend serves (batch
    1, q_offset 0, kv_len = front + bucket on the (1, max_len) cache) and
    flash_decode at their decode step ((max_batch, max_len), lengths
    [S, 1, S/2 + 5, 0]): bf16 against the plain version (FLASH_TOL) and
    against the f32 plain version, the largest prefill and the decode
    also in f32; the largest and smallest prefill and the decode timed
    beside SDPA with the boolean mask and their bound."""
    ops, ref = _ops()
    for arch, sh in front.items():
        nq, nkv, hd = sh["heads"]
        B, S, sqs = sh["max_batch"], sh["max_len"], sh["prefill_sq"]
        for sq in sqs:
            for dtype in (torch.bfloat16, torch.float32):
                if dtype == torch.float32 and sq != sqs[-1]:
                    continue
                d = dname(dtype)
                args = _dense_case(torch, rng, b=1, sq=sq, nq=nq, nkv=nkv,
                                   hd=hd, hdv=hd, skv=S, q_off=[0],
                                   q_len=[sq], kv_len=[sq], dtype=dtype,
                                   dev=dev)
                got, want = ops.flash_chunk(*args), ref.flash_chunk_ref(*args)
                torch.cuda.synchronize()
                rec = {"label": f"{arch} legacy prefill, {sh['front']} "
                                f"front + {sq - sh['front']} bucket rows {d}",
                       "max_err": max_err(torch, got, want),
                       "tol": list(FLASH_TOL[d]),
                       "ok": within(torch, got, want, *FLASH_TOL[d]),
                       "shape": f"q {tuple(args[0].shape)} k "
                                f"{tuple(args[1].shape)} q_len [{sq}] "
                                f"kv_len [{sq}]"}
                if dtype == torch.bfloat16:
                    want32 = ref.flash_chunk_ref(*_upcast(args))
                    rec.update(max_err_vs_f32=max_err(torch, got, want32),
                               tol_vs_f32=list(FLASH_TOL_VS_F32))
                    rec["ok"] &= within(torch, got, want32,
                                        *FLASH_TOL_VS_F32)
                if dtype == torch.bfloat16 and sq in (sqs[0], sqs[-1]):
                    time_rec(torch, rec, lambda a=args: ops.flash_chunk(*a),
                             20, lambda a=args: ref.flash_chunk_ref(*a), 5,
                             _sdpa_call(torch, *args, hd ** -0.5, want))
                    bts, flops = _attn_work([0], [sq], [sq], nq, nkv, hd,
                                            hd, 2)
                    rec.update(bytes=bts + got.numel() * 2, flops=flops,
                               peak="bf16", primary=False)
                res.add("flash_chunk", rec, "disagrees with its plain "
                                            "version at a legacy prefill")
                del args, got, want
        lens = [S, 1, S // 2 + 5, 0][:B] + [1] * max(0, B - 4)
        for dtype in (torch.bfloat16, torch.float32):
            d = dname(dtype)
            q, k, v, *_ = _dense_case(torch, rng, b=B, sq=1, nq=nq, nkv=nkv,
                                      hd=hd, hdv=hd, skv=S, q_off=lens,
                                      q_len=lens, kv_len=lens, dtype=dtype,
                                      dev=dev)
            q = q[:, 0].contiguous()
            ln = _i32(torch, lens, dev)
            got, want = ops.flash_decode(q, k, v, ln), \
                ref.flash_decode_ref(q, k, v, ln)
            torch.cuda.synchronize()
            ok = within(torch, got, want, *FLASH_TOL[d]) and all(
                bool((got[i] == 0).all()) for i in range(B) if lens[i] == 0)
            rec = {"label": f"flash_decode {arch} legacy decode S={S} {d}",
                   "max_err": max_err(torch, got, want),
                   "tol": list(FLASH_TOL[d]), "ok": ok,
                   "shape": f"q {tuple(q.shape)} k {tuple(k.shape)} "
                            f"lengths {lens}"}
            if dtype == torch.bfloat16:
                want32 = ref.flash_decode_ref(q.float(), k.float(),
                                              v.float(), ln)
                rec.update(max_err_vs_f32=max_err(torch, got, want32),
                           tol_vs_f32=list(FLASH_TOL_VS_F32))
                rec["ok"] = ok and within(torch, got, want32,
                                          *FLASH_TOL_VS_F32)
                q_off = [max(n - 1, 0) for n in lens]
                q_len = [min(n, 1) for n in lens]
                lib = _sdpa_call(torch, q[:, None], k, v, *(
                    _i32(torch, a, dev) for a in (q_off, q_len, lens)),
                    hd ** -0.5, want[:, None])
                time_rec(torch, rec, lambda: ops.flash_decode(q, k, v, ln),
                         50, lambda: ref.flash_decode_ref(q, k, v, ln), 10,
                         lib)
                bts, flops = _attn_work(q_off, q_len, lens, nq, nkv, hd, hd,
                                        2)
                rec.update(bytes=bts + got.numel() * 2, flops=flops,
                           peak="bf16")
            res.add("flash_chunk", rec, "flash_decode disagrees with its "
                                        "plain version at a legacy decode")
            del q, k, v, got, want
        free_memory(torch)


def draw_norms(torch, tree, gen):
    """``tree`` (the port's params) with every FRONT_NORMS leaf drawn from
    N(0, 0.25) by ``gen``."""
    def walk(node):
        if isinstance(node, dict):
            return {k: (0.5 * torch.randn(v.shape, generator=gen,
                                          device=v.device)).to(v.dtype)
                    if k in FRONT_NORMS and torch.is_tensor(v) else walk(v)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node
    return walk(tree)


def _within_bound(torch, got, want, share):
    """(max err, bound, ok): |got - want| <= 1e-4 |want| + ``share`` of
    the largest |want|."""
    bound = share * float(want.abs().max())
    return (max_err(torch, got, want), bound,
            bool(((got - want).abs() <= 1e-4 * want.abs() + bound).all()))


def _cached_rows(torch, params, cfg, plan, prompt, stub_kw, new, feed=None):
    """A greedy loop through forward(cache=) from a prefill of the stub and
    ``prompt``: (logits (new, vocab_size), tokens); with ``feed`` it
    feeds those tokens instead of its own argmax."""
    from repro_torch.models.model import forward, init_cache
    cache = init_cache(cfg, 1, 512, torch.float32, "cuda")
    v = cfg.vocab_size
    out = forward(params, cfg, plan, tokens=torch.as_tensor(
        prompt, device="cuda").long()[None], cache=cache, **stub_kw)
    rows = [out.logits[0, -1, :v]]
    toks = [int(rows[-1].argmax())]
    while len(rows) < new:
        nxt = toks[-1] if feed is None else feed[len(rows) - 1]
        out = forward(params, cfg, plan, tokens=torch.tensor(
            [[nxt]], device="cuda"), cache=cache)
        rows.append(out.logits[0, 0, :v])
        toks.append(int(rows[-1].argmax()))
    return torch.stack(rows), toks


def front_parity(torch, gen, arch, layers):
    """Full width, f32, at ``layers`` layers (None: whole), the norms
    drawn; logits compared on the real vocabulary columns:
    (a) the legacy engine with kernels "on" against "off" on the same
        weights and stub: 3 prompts (FRONT_PARITY_LENS) on 4 slots, 8 new
        tokens; streams equal, each blocking prefill's first-token logits
        within the bound, flash_chunk and flash_decode launched on "on"
        only;
    (b) the cached loop (prefill with the stub, then one-token decode
        steps) against the stateless forward over the same rows, through
        the kernels and through the plain bodies (the kernels' tokens
        fed), each within the bound.
    The bound: rtol 1e-4 plus the larger of 1e-4 of the largest |logit|
    and ``ulp_gap``, how far the stateless logits move when the first
    layer's norm weight is scaled by 1 + 2^-23 (the comment above
    FRONT_NORMS says why)."""
    import dataclasses as dc
    import numpy as np
    import repro_torch.configs as C
    from repro_torch.kernels import ops
    from repro_torch.models.model import forward, init_params
    from repro_torch.serving.api import LLM
    cfg = C.get(arch) if layers is None else _cut(arch, layers)
    params = draw_norms(torch, init_params(gen.manual_seed(1), cfg,
                                           torch.float32, "cuda"), gen)
    name, stub = front_stub(torch, cfg, 3)
    prompts = [np.random.default_rng(2).integers(
        0, cfg.vocab_size, n).astype(np.int32) for n in FRONT_PARITY_LENS]
    new, v = FRONT_PARITY_NEW, cfg.vocab_size
    runs = {}
    for kern in ("on", "off"):
        llm = LLM.from_spec(
            front_spec(arch, kernels=kern, max_len=512,
                       prompt_len=max(FRONT_PARITY_LENS),
                       max_new_tokens=new),
            cfg=cfg, params=params, embeds_fn=stub_fn(name, stub),
            device="cuda", dtype=torch.float32)
        eng = llm.engine
        check(eng.legacy and eng.kv.backend == "dense",
              f"{arch}: not on the legacy path's dense cache")
        firsts, prefill = [], eng._prefill_impl

        def kept(tokens, real_len, prefill=prefill, firsts=firsts):
            last, cache = prefill(tokens, real_len)
            firsts.append(last[0, :v].clone())
            return last, cache
        eng._prefill_impl = kept
        ops.reset_counters()
        streams = llm.generate(prompts, new)
        torch.cuda.synchronize()
        runs[kern] = (streams, torch.stack(firsts), dict(ops.counters),
                      eng.plan)
        del llm, eng
        free_memory(torch)
    on, off = runs["on"], runs["off"]

    # (b) the cached loop, through the kernels and through the plain
    # bodies, against the stateless forward
    kw = {name: stub}
    ops.reset_counters()
    got, toks = _cached_rows(torch, params, cfg, on[3], prompts[0], kw, new)
    launches = dict(ops.counters)
    plain_plan = dc.replace(on[3], kernels=off[3].kernels)
    got_off, _ = _cached_rows(torch, params, cfg, plain_plan, prompts[0], kw,
                              new, feed=toks[:-1])
    front = cfg.n_frontend_tokens if cfg.frontend == "vision_stub" else 0
    seq = torch.as_tensor(np.concatenate([prompts[0], toks[:-1]]),
                          device="cuda").long()[None]
    row0 = front + len(prompts[0]) - 1
    want = forward(params, cfg, tokens=seq, **kw).logits[0, row0:, :v]
    norm0 = params["groups"][0][0]["attn"]["norm"]
    saved = norm0.clone()
    norm0.add_((1 + norm0) * 2 ** -23)
    moved = forward(params, cfg, tokens=seq, **kw).logits[0, row0:, :v]
    norm0.copy_(saved)
    torch.cuda.synchronize()
    ulp = max_err(torch, moved, want)
    big = float(want.abs().max())
    share = max(1e-4, ulp / big)
    err_a, bound_a, ok_a = _within_bound(torch, on[1], off[1], share)
    err_b, bound_b, ok_b = _within_bound(torch, got, want, share)
    err_p, bound_p, ok_p = _within_bound(torch, got_off, want, share)
    print(f"[frontend] {cfg.name} f32 full width, {cfg.n_layers} layers, "
          f"{name} stub, largest |logit| {big:.3f}, ulp_gap (layer 0's norm "
          f"x (1 + 2^-23)) {ulp:.3e} (1e-4 of the largest: "
          f"{1e-4 * big:.3e}), bound rtol 1e-4 + {share:.3g} of the "
          f"largest: (a) kernels on vs off: streams equal "
          f"{on[0] == off[0]}; first-token logits of the {len(prompts)} "
          f"prefills max err {err_a:.3e} (bound {bound_a:.3e}): {ok_a}; "
          f"launches on {on[2]}, off {off[2]}; (b) cached loop vs the "
          f"stateless forward, {len(toks)} rows: through the kernels "
          f"({launches}) max err {err_b:.3e} (bound {bound_b:.3e}): {ok_b};"
          f" through the plain bodies {err_p:.3e}: {ok_p}")
    check(on[0] == off[0], f"{arch}: kernels on/off streams differ\n "
                           f"on={on[0]}\n off={off[0]}")
    check(ok_a, f"{arch}: kernels on/off first-token logits differ by "
                f"{err_a}")
    check(on[2].get("flash_chunk", 0) > 0 and on[2].get("flash_decode", 0)
          > 0 and not off[2], f"{arch}: launches on {on[2]}, off {off[2]}")
    check(ok_b and ok_p, f"{arch}: cached logits differ from the stateless "
                         f"forward by {err_b} (kernels) / {err_p} (plain)")
    check(launches.get("flash_chunk", 0) > 0
          and launches.get("flash_decode", 0) > 0,
          f"{arch}: the cached loop launched {launches}")
    del params
    free_memory(torch)
    return {"on_off_streams_equal": on[0] == off[0],
            "on_off_logits_max_err": err_a, "on_off_bound": bound_a,
            "cached_vs_stateless_max_err": err_b, "bound": bound_b,
            "plain_cached_vs_stateless_max_err": err_p,
            "plain_bound": bound_p, "ulp_gap": ulp, "largest_logit": big}


def phase_serve_frontend(torch, card_line, front):
    """qwen2-vl-7b (28 layers) and whisper-tiny (4 + 4 layers) whole, bf16,
    on the legacy blocking path with a seeded stub (FRONT_SERVES): exact
    launches (a decode step: flash_decode and its flash_chunk launch a
    layer; a blocking prefill: flash_chunk a layer), every attention
    geometry recorded (``front``: the ones phase 2 checked), a profiler
    window on each; then the f32 checks (``front_parity``)."""
    import numpy as np
    import repro_torch.configs as C
    out = {}
    for arch, sv in FRONT_SERVES.items():
        cfg = C.get(arch)
        rng = np.random.default_rng(sv["seed"])
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in sv["lens"]]
        name, stub = front_stub(torch, cfg, sv["seed"])
        llm = _load(torch, front_spec(arch), cfg, card_line,
                    embeds_fn=stub_fn(name, stub))
        eng = llm.engine
        check(eng.legacy and eng.kv.backend == "dense" and eng.draft is None
              and (eng.max_batch, eng.max_len)
              == (front[arch]["max_batch"], front[arch]["max_len"]),
              f"{arch}: not on the legacy path's dense cache at the "
              f"envelope phase 2 checked")
        n = cfg.n_layers
        label = f"{arch} ({n} layers, legacy path, seeded {name})"
        torch.cuda.reset_peak_memory_stats()
        geo: set = set()
        with record_geometries(geo):
            res = _serve_legacy(torch, llm, prompts, card_line, label,
                                new=sv["new"],
                                per_step={"flash_decode": n,
                                          "flash_chunk": n},
                                per_prefill={"flash_chunk": n})
            res["profile"] = phase_profile(torch, llm, rng, label,
                                           prompt_len=sv["profile_len"])
        res["geometries"] = geo
        print(f"[serve] {label}: attention geometries (kernel, B, sq, nq, "
              f"nkv, hd, S, dtype) {sorted(geo)}")
        out[arch] = res
        del llm, eng
        free_memory(torch)
    gen = torch.Generator(device="cuda")
    for arch, layers in FRONT_PARITY:
        out[f"{arch} parity"] = front_parity(torch, gen, arch, layers)
    return out


# ---------------------------------------------------------------------------
# phase 4b: speculative decoding
# ---------------------------------------------------------------------------

SPEC_K = 4           # draft tokens a verify block
SPEC_NEW = 64        # new tokens a request of the speculated serves
# (arch, layers or None for the whole model, prompt seed, runs): the bf16
# speculated serves, one set of weights an arch; each run (kv backend,
# chunk or None for the resolved one, drafts) serves the plain serve
# ("off") and then each draft.  phi3.5's second run verifies at the
# self draft's own width (chunk 16 = DRAFT_CHUNK, on the dense backend:
# the draft's geometry), where the draft's rows are the verifier's bit
# for bit
SPEC_SERVES = (("phi3.5-moe-42b", 8, 6,
                (("paged", None, ("self", "ngram", "smollm-360m")),
                 ("dense", 16, ("self",)))),
               ("deepseek-v2-236b", 4, 7, (("paged", None, ("self",)),)),
               ("gemma-2b", DENSE_LAYERS["gemma-2b"], 8,
                (("dense", None, ("self", "ngram")),)))


def spec_runs():
    """SPEC_SERVES flattened: (arch, layers, seed, kv, chunk, drafts)."""
    return [(arch, layers, seed, kv, chunk, drafts)
            for arch, layers, seed, runs in SPEC_SERVES
            for kv, chunk, drafts in runs]


def spec_spec(draft, kv="paged", chunk=None, **kw):
    """A speculated serve's envelope (prompts to 64 tokens, 64 new) with
    ``draft`` drafting SPEC_K tokens, or "off" for the plain serve;
    ``chunk`` None resolves it."""
    from repro_torch.serving.api import SpeculationConfig
    sc = "off" if draft == "off" else SpeculationConfig(k=SPEC_K,
                                                        draft=draft)
    if chunk is not None:
        kw["chunk"] = chunk
    return _spec(kv, **{"prompt_len": 64, "max_new_tokens": SPEC_NEW,
                        **kw}, speculation=sc)


def spec_prompts(cfg, seed, n=8):
    """``n`` prompts of 32-64 tokens (short prompts, long generations: the
    regime where a model draft's one-slot catch-up stays cheap)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, int(m)).astype(np.int32)
            for m in rng.integers(32, 65, n)]


def step_launches(cfg, kv):
    """Kernel launches of one unified step of a dropless serve on ``kv``,
    or of one draft-model forward (``kv="dense"``): the attention kernel a
    layer (MLA's expanded attention runs flash_chunk on either backend),
    the router gate, both gathers and three grouped GEMMs a MoE layer."""
    attn = "flash_chunk" if cfg.attention == "mla" or kv == "dense" \
        else "flash_chunk_paged"
    out = {attn: cfg.n_layers}
    n_moe = cfg.n_layers - cfg.first_dense_layers if cfg.is_moe else 0
    if n_moe:
        out.update(topk_gate=n_moe, permute_tokens=n_moe,
                   unpermute_tokens=n_moe, grouped_gemm=3 * n_moe)
    return out


def _spec_parity(torch, cfg, params, kv, lens, new):
    """f32, 2 layers: the self-draft serve with kernels on and off and the
    plain serve with kernels on, on the same weights and prompts; every
    stream equal, the kernels-on launches exact (verify steps and draft
    forwards), the kernels-off run launching none."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serving.api import LLM
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    runs = {}
    for kern, draft in (("on", "self"), ("off", "self"), ("on", "off")):
        llm = LLM.from_spec(
            spec_spec(draft, kv, 16, kernels=kern, max_len=128,
                      max_new_tokens=new), cfg=cfg, params=params,
            device="cuda", dtype=torch.float32)
        eng = llm.engine
        ops.reset_counters()
        streams = llm.generate(prompts, new)
        torch.cuda.synchronize()
        d_fwd = getattr(eng.draft, "n_forward", 0)
        want = {} if kern == "off" else expected_launches(
            step_launches(cfg, kv), eng.n_forward,
            step_launches(cfg, "dense"), d_fwd)
        runs[(kern, draft)] = (streams, dict(ops.counters), want,
                               eng.spec_stats(), eng.n_forward, d_fwd)
        del llm, eng
        free_memory(torch)
    base = runs[("on", "off")][0]
    equal = {f"{k[0]} {k[1]}": r[0] == base for k, r in runs.items()}
    st = runs[("on", "self")][3]
    print(f"[spec] {cfg.name} f32, kv {kv}, chunk 16, self draft k "
          f"{SPEC_K}: streams equal the kernels-on plain serve's "
          f"{json.dumps(equal)}; kernels-on spec: {runs[('on', 'self')][4]}"
          f" verify steps, {runs[('on', 'self')][5]} draft forwards, "
          f"acceptance {st['spec_accept_rate']:.4f}, "
          f"{st['spec_tokens_per_step']:.3f} tokens a verify step, "
          f"launches {runs[('on', 'self')][1]}")
    check(all(equal.values()), f"spec parity {cfg.name} {kv}: streams "
                               f"differ {equal}")
    for k, (_, got, want, *_) in runs.items():
        check(got == want, f"spec parity {cfg.name} {kv} {k}: launches "
                           f"{got} != {want}")
    check(st["n_spec_steps"] > 0, f"spec parity {cfg.name}: no verify step")
    return {"equal": equal, "spec": st}


def spec_parity(torch):
    """phase 4b (a): phi3.5 (paged and dense), deepseek-v2 (paged) and
    gemma-2b (dense), 2 layers each, f32, full width."""
    from repro_torch.models.model import init_params
    gen = torch.Generator(device="cuda")
    lens, new = (40, 33, 57, 48), 12
    out = {}
    for arch, kvs in (("phi3.5-moe-42b", ("paged", "dense")),
                      ("deepseek-v2-236b", ("paged",)),
                      ("gemma-2b", ("dense",))):
        cfg = _cut(arch, 2)
        params = init_params(gen.manual_seed(1), cfg, torch.float32, "cuda")
        for kv in kvs:
            out[f"{arch} {kv}"] = _spec_parity(torch, cfg, params, kv, lens,
                                               new)
        del params
        free_memory(torch)
    return out


def _spec_serve(torch, llm, prompts, kv, card_line, label):
    """``_serve`` on a (possibly) speculating engine: launches exact per
    verify step and per draft forward; the host seconds inside
    ``draft.propose`` (the draft model's forwards, which end in a host
    read, included) give the share of wall time spent drafting."""
    eng = llm.engine
    draft, spent = eng.draft, [0.0]
    per_draft = None
    if draft is not None:
        if getattr(draft, "cfg", None) is not None:      # a model draft
            per_draft = step_launches(draft.cfg, "dense")
        propose = draft.propose

        def timed(ctx, want):
            t0 = time.perf_counter()
            try:
                return propose(ctx, want)
            finally:
                spent[0] += time.perf_counter() - t0
        draft.propose = timed
    out = _serve(torch, llm, prompts, SPEC_NEW, step_launches(llm.cfg, kv),
                 card_line, label, per_draft=per_draft)
    st = eng.spec_stats()
    out.update(spec=st, draft_s=spent[0],
               draft_share=spent[0] / out["wall_s"])
    if draft is not None:
        print(f"[spec] {label}: {out['steps']} steps, "
              f"{out['wall_s'] / out['steps'] * 1e3:.1f} ms/step, "
              f"{out['tok_s']:.1f} tok/s, TTFT {out['ttft_ms']:.0f} ms, ITL "
              f"{out['itl_ms']:.1f} ms; {st['n_spec_steps']} slot verify "
              f"steps, {st['n_spec_drafted']} drafted, "
              f"{st['n_spec_accepted']} accepted (rate "
              f"{st['spec_accept_rate']:.4f}), "
              f"{st['spec_tokens_per_step']:.3f} tokens a verify step, "
              f"{out['draft_forwards']} draft forwards, drafting "
              f"{spent[0]:.2f} s = {out['draft_share']:.3f} of wall time "
              f"[{card_line}]")
    return out


def _stream_report(torch, spec, cfg, params, prompts, off, got, label):
    """Which speculated streams differ from the plain serve's, and where;
    on a difference, the plain serve is replayed with a hook that keeps
    the top-2 logit margin of every token it samples, and the margin at
    each first differing token is printed."""
    from repro_torch.serving.api import LLM
    differ = [i for i, (a, b) in enumerate(zip(off, got)) if a != b]
    print(f"[spec] {label}: {len(off) - len(differ)} of {len(off)} streams "
          f"equal the plain serve's (bf16); differing {differ}")
    if not differ:
        return {"equal": True, "differ": []}
    llm = LLM.from_spec(spec, cfg=cfg, params=params, device="cuda",
                        dtype=torch.bfloat16)
    eng = llm.engine
    orig, margins = eng._unified_impl, {}

    def hooked(tokens, q_lens, v_lens):
        res = orig(tokens, q_lens, v_lens)
        top = torch.topk(res[2].float(), 2, -1).values
        m, q = (top[:, 0] - top[:, 1]).tolist(), q_lens.tolist()
        for i, r in enumerate(eng.slots):
            if r is not None and q[i] > 0:
                margins[(r.rid, len(r.out_tokens))] = m[i]
        return res
    eng._unified_impl = hooked
    again = llm.generate(prompts, SPEC_NEW)
    firsts = []
    for i in differ:
        t = next(j for j, (a, b) in enumerate(zip(off[i], got[i])) if a != b)
        firsts.append({"stream": i, "token": t, "plain": off[i][t],
                       "spec": got[i][t], "margin": margins.get((i, t))})
    print(f"[spec] {label}: first differing tokens {json.dumps(firsts)} "
          f"(top-2 logit margin of the plain serve there; its replay "
          f"equal to it: {again == off})")
    del llm, eng
    free_memory(torch)
    return {"equal": False, "differ": differ, "first": firsts}


def phase_spec(torch, card_line):
    """phase 4b: speculative decoding.  (a) f32 parity (``spec_parity``);
    (b) the bf16 serves of SPEC_SERVES at full width: for each run the
    plain serve, then each draft, on one set of weights and prompts."""
    import repro_torch.configs as C
    from repro_torch.serving.api import LLM
    from repro_torch.serving.draft import DRAFT_CHUNK
    out = {"parity": spec_parity(torch), "serves": []}
    for arch, layers, seed, runs in SPEC_SERVES:
        cfg = _cut(arch, layers) if layers else C.get(arch)
        depth = (f"{layers} of {C.get(arch).n_layers} layers" if layers
                 else f"{cfg.n_layers} layers")
        prompts = spec_prompts(cfg, seed)
        params, plain = None, []
        for kv, chunk, drafts in runs:
            label = (f"{arch} ({depth}), {kv}"
                     + (f", chunk {chunk}" if chunk else "")
                     + f", {len(prompts)} prompts of 32-64")
            if params is None:
                llm = _load(torch, spec_spec("off", kv, chunk), cfg,
                            card_line)
                params = llm.params
            else:
                llm = LLM.from_spec(spec_spec("off", kv, chunk), cfg=cfg,
                                    params=params, device="cuda",
                                    dtype=torch.bfloat16)
            base = _spec_serve(torch, llm, prompts, kv, card_line,
                               f"{label}, plain")
            del llm
            free_memory(torch)
            out["serves"].append(base)
            if plain:
                # one model, one prompt set, another step width: how far
                # the width alone moves the bf16 greedy streams
                first = [next((j for j, (a, b) in enumerate(zip(x, y))
                               if a != b), None)
                         for x, y in zip(plain[0][1], base["streams"])]
                print(f"[spec] {arch}: the plain serve at {kv}, chunk "
                      f"{chunk} against {plain[0][0]}: "
                      f"{first.count(None)} of {len(first)} streams equal; "
                      f"first differing token of each {first} [bf16]")
            plain.append((f"{kv}, chunk {chunk or 'resolved'}",
                          base["streams"]))
            for d in drafts:
                llm = LLM.from_spec(spec_spec(d, kv, chunk), cfg=cfg,
                                    params=params, device="cuda",
                                    dtype=torch.bfloat16)
                check(llm.engine.spec_k == SPEC_K,
                      f"spec {arch} {d}: k resolved to {llm.engine.spec_k}")
                check(d != "self" or llm.engine.draft.params is params,
                      f"spec {arch}: the self draft copied the weights")
                r = _spec_serve(torch, llm, prompts, kv, card_line,
                                f"{label}, draft {d} k {SPEC_K}")
                del llm
                free_memory(torch)
                r["streams_vs_plain"] = _stream_report(
                    torch, spec_spec("off", kv, chunk), cfg, params,
                    prompts, base["streams"], r["streams"],
                    f"{label}, draft {d}")
                check(r["spec"]["n_spec_steps"] > 0 or d == "ngram",
                      f"spec {arch} {d}: the draft never verified")
                if d == "self" and chunk == DRAFT_CHUNK:
                    # the draft's step and the verifier's share one
                    # geometry: every draft is the verifier's own token
                    check(r["spec"]["spec_accept_rate"] == 1.0,
                          f"spec {label}: the self draft at the verifier's "
                          f"width was rejected: {r['spec']}")
                out["serves"].append(r)
        del params
        free_memory(torch)
    return out


# ---------------------------------------------------------------------------
# phase 5: MixServe's layout on 4 ranks
# ---------------------------------------------------------------------------

DIST_MESH = (2, 2)                           # (data, model)
DIST_LAYOUTS = (("mixserve", "fused"), ("mixserve", "unfused"),
                ("dp_ep", "unfused"), ("pure_tp", "unfused"))
DIST_PARITY = dict(max_len=256, chunk=32, prompt_len=200, max_new_tokens=8)
DIST_LENS = (40, 100, 200, 150)
# the sharded forward against the unsharded one: (q_lens, width) steps on
# a fresh paged cache of 4 slots; the first step's residual stream is cut
# along seq over TP (32 rows), the second's is not (1 row)
DIST_FWD = (([32, 20, 5, 0], 32), ([1, 1, 1, 0], 1))
DIST_FWD_LEN, DIST_FWD_PAGE = 64, 16
# deepseek-v2 at full width, its dense and its first MoE layer: forward
# (expanded MLA, then absorbed at width 1) and greedy streams
DS_DIST = dict(max_len=128, chunk=32, prompt_len=100, max_new_tokens=4)
DS_DIST_LENS = (30, 70, 100, 50)
# the sharded forward's f32 logits against the unsharded ones: rtol 1e-4
# plus 1e-3 of the largest logit.  Only the summation order differs (the
# TP partial sums of wo / w_out / the expert FFN), but the random init
# draws q and k at a scale of 1/sqrt(heads), so attention scores grow with
# the width and their softmax amplifies f32 rounding: the gap grows with
# d_model at fixed depth (the CPU tests hold 1e-4 of the largest logit
# at the reduced widths)
FWD_RTOL, FWD_ATOL_REL = 1e-4, 1e-3
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
    cut = plan.tp if plan.heads_sharded(cfg) else 1
    return {"t": t, "chunks": chunks, "t_c": t // chunks, "n_c": n_c,
            "extents": [cap, n_c] if cap < n_c else [n_c], "ep": plan.ep,
            "tp": plan.tp, "h": cfg.d_model, "d_ff": cfg.d_ff,
            "E": cfg.n_experts, "k": cfg.top_k,
            "ep_overlap": ovl.describe(),
            "max_batch": res.max_batch, "chunk": res.chunk,
            # one rank's attention: its batch rows and heads, every page
            "attn": {"max_batch": res.max_batch // plan.dp,
                     "chunk": res.chunk, "max_len": res.max_len,
                     "pool_pages": res.kv.pool_pages,
                     "heads": (cfg.n_heads // cut, cfg.n_kv_heads // cut)}}


def _dist_inputs(torch, cfg, dev):
    """The parity phase's moe_block input and prompts, from seeds."""
    import numpy as np
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(4, 64, cfg.d_model, generator=gen, device=dev)
    rng = np.random.default_rng(1)
    return x, [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in DIST_LENS]


def _dist_forward(torch, cfg, params, plan, dev, kv="paged"):
    """DIST_FWD on a fresh cache of 4 slots through ``forward`` under
    ``plan`` (sharded on a mesh, else on one device): each step's logits
    of every row, on the host.  ``kv="dense"``: on ``make_batched_cache``
    (on a mesh the rank's rows and heads), then the stateless forward over
    OPT_STATELESS tokens, its logits last."""
    import numpy as np
    from repro_torch.models import model as MOD
    from repro_torch.serving.kv_cache import make_batched_cache
    if kv == "dense":
        cache = make_batched_cache(cfg, 4, DIST_FWD_LEN, torch.float32,
                                   dev, plan)
    else:
        nb = DIST_FWD_LEN // DIST_FWD_PAGE
        cache = MOD.init_paged_cache(cfg, 4, DIST_FWD_LEN,
                                     page_size=DIST_FWD_PAGE,
                                     pool_pages=4 * nb, dtype=torch.float32,
                                     device=dev, plan=plan)
        cache["block_tables"].copy_(torch.arange(
            4 * nb, dtype=torch.int32, device=dev).reshape(4, nb))
    rng = np.random.default_rng(3)
    out = []
    for q_lens, w in DIST_FWD:
        toks = rng.integers(0, cfg.vocab_size, (4, w)).astype(np.int32)
        o = MOD.forward(params, cfg, plan,
                        tokens=torch.from_numpy(toks).to(dev), cache=cache,
                        q_lens=torch.tensor(q_lens, dtype=torch.int32,
                                            device=dev))
        out.append(o.logits.cpu())
    if kv == "dense":
        toks = rng.integers(0, cfg.vocab_size, OPT_STATELESS).astype(
            np.int32)
        o = MOD.forward(params, cfg, plan,
                        tokens=torch.from_numpy(toks).to(dev))
        check(o.cache is None, "the stateless forward returned a cache")
        out.append(o.logits.cpu())
    return out


def _forward_err(torch, got, want):
    """(max abs error over the valid rows of every step (and every row of
    a stateless forward after them), within the bound, the largest logit)
    of the sharded forward's logits against the unsharded ones."""
    err, ok = 0.0, True
    rows = [q for q, _ in DIST_FWD] + [None] * (len(want) - len(DIST_FWD))
    for q_lens, g, w in zip(rows, got, want):
        pairs = [(g, w)] if q_lens is None else \
            [(g[i, :n], w[i, :n]) for i, n in enumerate(q_lens) if n]
        for a, b in pairs:
            err = max(err, max_err(torch, a, b))
            ok &= within(torch, a, b, FWD_ATOL_REL * float(b.abs().max()),
                         FWD_RTOL)
    return err, ok, max(float(w.abs().max()) for w in want)


def _ds_prompts(cfg):
    import numpy as np
    rng = np.random.default_rng(2)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in DS_DIST_LENS]


def _dist_reference(torch, path):
    """The unsharded f32 runs the ranks are held against: moe_block and
    LLM.generate on one device, both dispatch modes (capacity at a factor
    at which nothing drops), 2 layers at full width, and the forward's
    logits; the same forward and greedy streams for deepseek-v2 (a dense
    and an MoE layer)."""
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
    ref["forward"] = _dist_forward(torch, cfg, params, make_plan(
        "mixserve", kernels=KernelPolicy.all_on()), "cuda")
    del x
    _dist_options_reference(torch, ref, params, cfg)
    del params
    free_memory(torch)
    cfg = _cut("deepseek-v2-236b", 2)
    params = init_params(gen.manual_seed(1), cfg, torch.float32, "cuda")
    ref["ds_forward"] = _dist_forward(torch, cfg, params, make_plan(
        "mixserve", kernels=KernelPolicy.all_on()), "cuda")
    llm = LLM.from_spec(_spec(**DS_DIST), cfg=cfg, params=params,
                        device="cuda", dtype=torch.float32)
    ref["ds_streams"] = llm.generate(_ds_prompts(cfg), 4)
    del llm, params
    torch.save(ref, path)
    free_memory(torch)


def _dist_parity_rank(torch, mesh, ref):
    """(a) on one rank: each layout's moe_block, forward logits and
    LLM.generate against the unsharded runs; mixserve fused also with the
    residual stream whole (sp off) and micro-chunked, with the auto row
    cap and with a cap of 8 rows that every chunk overflows."""
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
        cases = [("dropless", "off", True), ("capacity", "off", True)]
        if (lay, algo) == ("mixserve", "fused"):
            cases += [("dropless", "off", False),
                      ("dropless", EpOverlap(chunks=2), True),
                      ("dropless", EpOverlap(chunks=2, cap_rows=8), True)]
        for d, ovl, sp in cases:
            res = _spec(strategy=_dist_strategy(lay, algo), dispatch=d,
                        ep_overlap=ovl, **DIST_PARITY).resolve(
                cfg, mesh=mesh, device=dev, sp=sp)
            if params is None:      # one draw per layout's weight slicing
                params = init_params(gen.manual_seed(1), cfg, torch.float32,
                                     dev, plan=res.plan)
            moe.exchange_counts.clear()
            y = moe.moe_block(params["groups"][0][0]["moe"], x, cfg,
                              res.plan)[0]
            want = ref["moe"][d].to(dev)
            ovf = moe.exchange_counts.get("overflow", 0)
            fwd_err, fwd_ok, fwd_max = _forward_err(torch, _dist_forward(
                torch, cfg, params, res.plan, dev), ref["forward"])
            llm = LLM.from_spec(res, cfg=cfg, params=params, device=dev,
                                dtype=torch.float32)
            t0 = time.perf_counter()
            streams = llm.generate(prompts, 8)
            torch.cuda.synchronize()
            out.append({
                "case": f"{lay} {res.plan.comm_algo} {d}"
                        + ("" if sp else ", sp off")
                        + ("" if ovl == "off" else f" ({ovl.describe()})"),
                "moe_max_err": max_err(torch, y, want),
                "moe_ok": within(torch, y, want, *TOL["float32"]),
                "fwd_max_err": fwd_err, "fwd_ok": fwd_ok,
                "fwd_max_logit": fwd_max,
                "moe_overflow": ovf, "cap8": ovl != "off"
                and ovl.cap_rows == 8, "auto_cap": ovl != "off"
                and ovl.cap_rows == 0, "streams": streams,
                "streams_equal": streams == ref["streams"][d],
                "generate_s": time.perf_counter() - t0})
            del llm
        del params
        free_memory(torch)
    return out


def _dist_deepseek_rank(torch, mesh, ref):
    """(a) deepseek-v2 on one rank, mixserve fused: its sharded forward
    (MLA on the rank's heads, the dense MLP's d_ff slice, the MoE) and
    greedy streams against the unsharded runs."""
    from repro_torch.models.model import init_params
    from repro_torch.serving.api import LLM
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = _cut("deepseek-v2-236b", 2)
    res = _spec(strategy=_dist_strategy("mixserve", "fused"),
                **DS_DIST).resolve(cfg, mesh=mesh, device=dev)
    gen = torch.Generator(device=dev)
    params = init_params(gen.manual_seed(1), cfg, torch.float32, dev,
                         plan=res.plan)
    weights = sum(t.numel() * t.element_size() for t in _leaves(params))
    fwd_err, fwd_ok, fwd_max = _forward_err(torch, _dist_forward(
        torch, cfg, params, res.plan, dev), ref["ds_forward"])
    llm = LLM.from_spec(res, cfg=cfg, params=params, device=dev,
                        dtype=torch.float32)
    streams = llm.generate(_ds_prompts(cfg), 4)
    torch.cuda.synchronize()
    out = {"fwd_max_err": fwd_err, "fwd_ok": fwd_ok,
           "fwd_max_logit": fwd_max, "streams": streams,
           "streams_equal": streams == ref["ds_streams"],
           "weights_gb": weights / 1e9,
           "heads": (params["groups"][0][0]["attn"]["w_uk"].shape[1],
                     cfg.n_heads),
           "d_ff": (params["groups"][0][0]["mlp"]["w_in"].shape[1],
                    cfg.d_ff)}
    del llm, params
    free_memory(torch)
    return out


def _dist_serve_rank(torch, mesh, kv="paged"):
    """(b) on one rank: the bf16 8-layer phi3.5 serve, counters read from
    this run only; with ``kv="dense"`` (d)'s serve on the dense backend,
    its attention geometries recorded."""
    import numpy as np
    from repro_torch.core import collectives
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.serving.api import LLM
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = _cut("phi3.5-moe-42b", 8)
    res = dist_spec(kv=kv).resolve(cfg, mesh=mesh, device=dev)
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
    geos: set = set()
    t0 = time.perf_counter()
    try:
        with record_dist_geometries(geos):
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
            "kv_gb": eng.kv.kv_bytes() / 1e9,
            "max_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "ep_load": eng.ep_load_stats(), "prefix_hits":
            eng.kv.stats.n_prefix_hits, "spec": res.describe(),
            "backend": eng.kv.backend, "geometries": sorted(geos),
            "vocab": cfg.vocab_size,
            "plan": f"{res.strategy} {res.plan.comm_algo}, tp {res.plan.tp} "
                    f"{res.plan.tp_axes}, ep {res.plan.ep} "
                    f"{res.plan.ep_axes}, dp {res.plan.dp} "
                    f"{res.plan.dp_axes}, ep_overlap "
                    f"{ovl.describe() if ovl else 'off'}"}


# ---------------------------------------------------------------------------
# phase 5 (c) and (d): every serve option on the mesh
# ---------------------------------------------------------------------------

# (c) f32, full width, cut in depth.  The dense backend: DIST_FWD on a
# dense cache of 4 slots (the 32-row mixed step, then a 1-row step:
# deepseek's MLA expanded, then absorbed), then the stateless forward
# over OPT_STATELESS tokens, and LLM.generate with kv="dense"
OPT_STATELESS = (4, 32)
# speculation on phi3.5 2 layers, k SPEC_K at chunk 16: (kv, draft), each
# against the plain serve on the mesh and the same serve unsharded
OPT_SPEC = (("paged", "self"), ("dense", "self"), ("paged", "smollm-360m"))
OPT_SPEC_LENS, OPT_SPEC_NEW = (40, 33, 57, 48), 12
# the legacy families: (arch, layers or None for the whole model, stub:
# None, whisper's "default" frames or a "seeded" one, dtype).  f64 runs
# the plain bodies (no kernel takes f64).  whisper runs in f64 only: at
# full width its random-init f32 logits are chaotic under any change of
# summation order, the encoder's attention over near-alike frames near
# one-hot (on the CPU, the whole model's f32 first-token logits move by
# 0.70 of a largest 4.23 between the sharded and the unsharded forward,
# and by 6.7e-04 merely between a batch of 4 and one row at a time; in
# f64 the two agree to 0.0), so equal f32 streams would test the
# rounding, not the layout.  qwen2-vl runs in f32 through the kernels
# and again in f64, which shows what of its f32 gap is rounding
OPT_LEGACY = (("rwkv6-1.6b", 2, None, "float32"),
              ("recurrentgemma-9b", 3, None, "float32"),
              ("whisper-tiny", None, "default", "float64"),
              ("whisper-tiny", None, "seeded", "float64"),
              ("qwen2-vl-7b", 2, "seeded", "float32"),
              ("qwen2-vl-7b", 2, None, "float32"),
              ("qwen2-vl-7b", 2, "seeded", "float64"))
# the first-token logits' bound, sharded against unsharded: rtol 1e-4
# plus the larger of a share of the largest |logit| and the one-ulp move
# of layer 0's norm (the frontend checks' rule, above FRONT_NORMS).  The
# share is 1e-4 in f64 and, in f32, phase 5 (a)'s FWD_ATOL_REL: the TP
# partial sums reorder every layer's f32 sums, which moves full-width
# logits more than one ulp at one norm does (qwen2-vl 2 layers: 1.245e-03
# against a largest 5.757 and a one-ulp move of 2.967e-04, on an H100)
LEGACY_SHARE = {"float32": FWD_ATOL_REL, "float64": 1e-4}
OPT_LEGACY_LENS, OPT_LEGACY_NEW = (40, 100, 200), 8
# (d) rwkv6-1.6b whole on the mesh, bf16: 4 prompts of 64-256 tokens
RWKV_DIST_LENS, RWKV_DIST_NEW = (64, 256, 100, 180), 8


class record_dist_geometries(record_geometries):
    """``record_geometries`` with the value width: MLA's expanded and
    absorbed attention have hdv != hd.  A geometry is (kernel, B, sq, nq,
    nkv, hd, hdv, S, dtype)."""

    @staticmethod
    def geo(kernel, q, k, v):
        sq = 1 if kernel == "flash_decode" else q.shape[1]
        return (kernel, q.shape[0], sq, q.shape[-2], k.shape[2],
                q.shape[-1], v.shape[-1], k.shape[1], dname(q.dtype))


def _rank_tree(tree, cfg, plan):
    """This rank's block of a whole params tree (``plan.keep_hook``), each
    cut leaf copied so that the whole tree can be freed."""
    from repro_torch.models.model import model_spec
    from repro_torch.models.param import P
    keep = plan.keep_hook(cfg)

    def walk(t, s, path):
        if isinstance(s, P):
            sl = keep(path, s) if keep is not None else None
            return t if sl is None else t[sl].contiguous()
        if isinstance(s, dict):
            return {k: walk(t[k], s[k], path + (k,)) for k in s}
        return [walk(t[i], s[i], path + (i,)) for i in range(len(s))]
    return walk(tree, model_spec(cfg), ())


def _legacy_params(torch, cfg, dtype, dev, plan=None):
    """The weights of a legacy case, seed 1, the zero-initialised
    recurrent leaves and norms drawn on the whole tree (so every rank's
    block is the whole tree's), then cut to ``plan``'s block."""
    from repro_torch.models.model import init_params
    gen = torch.Generator(device=dev)
    whole = init_params(gen.manual_seed(1), cfg, dtype, dev)
    whole = draw_norms(torch, draw_recurrent_leaves(torch, whole, gen), gen)
    return whole if plan is None else _rank_tree(whole, cfg, plan)


def _legacy_cfg(arch, layers):
    import repro_torch.configs as C
    return C.get(arch) if layers is None else _cut(arch, layers)


def _legacy_stub(torch, cfg, stub):
    """An embeds_fn of the case's stub (None: the LLM's default)."""
    return stub_fn(*front_stub(torch, cfg, 3)) if stub == "seeded" else None


def _legacy_spec(dtype):
    """A legacy case's envelope: kernels "auto" in f32, off in f64."""
    kw = {} if dtype == "float32" else {"kernels": "off"}
    return _spec("auto", strategy="mixserve", max_len=512,
                 prompt_len=max(OPT_LEGACY_LENS),
                 max_new_tokens=OPT_LEGACY_NEW, **kw)


def _legacy_serve(torch, cfg, params, stub, dtype, dev, mesh=None):
    """The legacy engine's greedy streams of OPT_LEGACY_LENS and each
    blocking prefill's first-token logits (on the real vocabulary)."""
    import numpy as np
    from repro_torch.serving.api import LLM
    llm = LLM.from_spec(_legacy_spec(dtype), cfg=cfg, params=params,
                        mesh=mesh,
                        embeds_fn=_legacy_stub(torch, cfg, stub),
                        device=dev, dtype=getattr(torch, dtype))
    eng = llm.engine
    check(eng.legacy and eng.kv.backend == "dense",
          f"{cfg.name}: not on the legacy path's dense cache")
    firsts, prefill = [], eng._prefill_impl

    def kept(tokens, real_len):
        last, cache = prefill(tokens, real_len)
        firsts.append(last[0, :cfg.vocab_size].cpu())
        return last, cache
    eng._prefill_impl = kept
    prompts = [np.random.default_rng(2).integers(
        0, cfg.vocab_size, n).astype(np.int32) for n in OPT_LEGACY_LENS]
    streams = llm.generate(prompts, OPT_LEGACY_NEW)
    torch.cuda.synchronize()
    return streams, torch.stack(firsts), eng.plan


def _norm0(params):
    """Layer 0's first norm weight."""
    layer = params["groups"][0][0]
    if "tm" in layer:
        return layer["tm"]["norm"]
    if "l0" in layer:
        return layer["l0"]["rglru"]["norm"]
    return layer["attn"]["norm"]


def _legacy_ulp_gap(torch, cfg, params, stub, dev):
    """How far the first prefill's first-token logits move when layer 0's
    norm weight is scaled by 1 + 2^-23 (the frontend checks' one-ulp
    move), and the largest |logit| there."""
    import numpy as np
    from repro_torch.models.model import forward
    prompt = np.random.default_rng(2).integers(
        0, cfg.vocab_size, OPT_LEGACY_LENS[0]).astype(np.int32)
    fn = _legacy_stub(torch, cfg, stub)
    kw = fn(1) if fn is not None else {}
    if cfg.family == "audio" and not kw:      # whisper's default frames
        e = cfg.encoder
        kw = {"frames": torch.full((1, e.n_frames, e.d_model), 0.01,
                                   device=dev)}
    toks = torch.as_tensor(prompt, device=dev).long()[None]
    front = cfg.n_frontend_tokens if "embeds" in kw else 0
    row = front + len(prompt) - 1
    v = cfg.vocab_size
    base = forward(params, cfg, tokens=toks, **kw).logits[0, row, :v]
    norm0 = _norm0(params)
    saved = norm0.clone()
    norm0.add_((1 + norm0) * 2 ** -23)
    moved = forward(params, cfg, tokens=toks, **kw).logits[0, row, :v]
    norm0.copy_(saved)
    return max_err(torch, moved, base), float(base.abs().max())


def _opt_spec_runs(torch, cfg, params, dev, mesh=None):
    """phi3.5 on OPT_SPEC_LENS at chunk 16: the plain paged serve, then
    each OPT_SPEC run: (streams, spec_stats) by run."""
    import numpy as np
    from repro_torch.serving.api import LLM
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in OPT_SPEC_LENS]
    out = {}
    for kv, draft in (("paged", "off"),) + OPT_SPEC:
        spec = spec_spec(draft, kv, 16, max_len=128,
                         max_new_tokens=OPT_SPEC_NEW,
                         strategy=_dist_strategy("mixserve", "fused"))
        llm = LLM.from_spec(spec, cfg=cfg, params=params, mesh=mesh,
                            device=dev, dtype=torch.float32)
        streams = llm.generate(prompts, OPT_SPEC_NEW)
        torch.cuda.synchronize()
        out[(kv, draft)] = (streams, llm.engine.spec_stats())
        del llm
        free_memory(torch)
    return out


def _dist_options_reference(torch, ref, params, cfg):
    """The unsharded f32 runs of (c), on one device: phi3.5's dense
    forward, dense streams and speculated serves on ``params`` (phase 5
    (a)'s weights), deepseek-v2's dense forward and streams, and each
    legacy case's streams, first-token logits and one-ulp move."""
    from repro_torch.core.partitioner import make_plan
    from repro_torch.kernels.policy import KernelPolicy
    from repro_torch.models.model import init_params
    from repro_torch.serving.api import LLM
    plan = make_plan("mixserve", kernels=KernelPolicy.all_on())
    x, prompts = _dist_inputs(torch, cfg, "cuda")
    ref["dense_forward"] = _dist_forward(torch, cfg, params, plan, "cuda",
                                         "dense")
    llm = LLM.from_spec(_spec(kv="dense", **DIST_PARITY), cfg=cfg,
                        params=params, device="cuda", dtype=torch.float32)
    ref["dense_streams"] = llm.generate(prompts, 8)
    del llm, x
    ref["spec"] = _opt_spec_runs(torch, cfg, params, "cuda")
    free_memory(torch)
    ds = _cut("deepseek-v2-236b", 2)
    gen = torch.Generator(device="cuda")
    dp = init_params(gen.manual_seed(1), ds, torch.float32, "cuda")
    ref["ds_dense_forward"] = _dist_forward(torch, ds, dp, plan, "cuda",
                                            "dense")
    llm = LLM.from_spec(_spec(kv="dense", **DS_DIST), cfg=ds, params=dp,
                        device="cuda", dtype=torch.float32)
    ref["ds_dense_streams"] = llm.generate(_ds_prompts(ds), 4)
    del llm, dp
    free_memory(torch)
    ref["legacy"] = {}
    for arch, layers, stub, dtype in OPT_LEGACY:
        lc = _legacy_cfg(arch, layers)
        lp = _legacy_params(torch, lc, getattr(torch, dtype), "cuda")
        streams, firsts, _ = _legacy_serve(torch, lc, lp, stub, dtype,
                                           "cuda")
        ulp, big = _legacy_ulp_gap(torch, lc, lp, stub, "cuda")
        ref["legacy"][(arch, stub, dtype)] = {
            "streams": streams, "firsts": firsts, "ulp": ulp, "big": big}
        del lp
        free_memory(torch)


def _dist_options_rank(torch, mesh, ref):
    """(c) on one rank: the dense backend's forward (steps and stateless)
    and streams for phi3.5 and deepseek-v2, the speculated serves, and
    the legacy families' serves, each against the unsharded run; every
    attention geometry recorded."""
    from repro_torch.models.model import init_params
    from repro_torch.serving.api import LLM
    dev = torch.device("cuda", torch.cuda.current_device())
    geos: set = set()
    out = {}
    gen = torch.Generator(device=dev)
    with record_dist_geometries(geos):
        for arch, knobs, n_new, key in (
                ("phi3.5-moe-42b", DIST_PARITY, 8, ""),
                ("deepseek-v2-236b", DS_DIST, 4, "ds_")):
            cfg = _no_drop(_cut(arch, 2)) if not key else _cut(arch, 2)
            res = _spec(kv="dense", strategy=_dist_strategy(
                "mixserve", "fused"), **knobs).resolve(cfg, mesh=mesh,
                                                       device=dev)
            params = init_params(gen.manual_seed(1), cfg, torch.float32,
                                 dev, plan=res.plan)
            t0 = time.perf_counter()
            err, ok, big = _forward_err(torch, _dist_forward(
                torch, cfg, params, res.plan, dev, "dense"),
                ref[f"{key}dense_forward"])
            llm = LLM.from_spec(res, cfg=cfg, params=params, device=dev,
                                dtype=torch.float32)
            prompts = _ds_prompts(cfg) if key else _dist_inputs(
                torch, cfg, dev)[1]
            streams = llm.generate(prompts, n_new)
            torch.cuda.synchronize()
            rows = next(iter(llm.engine.cache["groups"][0].values()))
            out[arch] = {"fwd_max_err": err, "fwd_ok": ok,
                         "fwd_max_logit": big, "streams": streams,
                         "streams_equal": streams == ref[
                             f"{key}dense_streams"],
                         "cache_rows": int(rows.shape[1]),
                         "seconds": time.perf_counter() - t0}
            del llm
            if not key:
                t0 = time.perf_counter()
                spec = _opt_spec_runs(torch, cfg, params, dev, mesh)
                # (streams, counters, each equal to the unsharded run's)
                out["spec"] = {"runs": {
                    k: (v[0], v[1], v[0] == ref["spec"][k][0],
                        v[1] == ref["spec"][k][1])
                    for k, v in spec.items()},
                    "seconds": time.perf_counter() - t0}
            del params
            free_memory(torch)
        out["legacy"] = {}
        for arch, layers, stub, dtype in OPT_LEGACY:
            t0 = time.perf_counter()
            cfg = _legacy_cfg(arch, layers)
            res_plan = _legacy_spec(dtype).resolve(cfg, mesh=mesh,
                                                   device=dev).plan
            params = _legacy_params(torch, cfg, getattr(torch, dtype), dev,
                                    res_plan)
            free_memory(torch)
            streams, firsts, plan = _legacy_serve(torch, cfg, params, stub,
                                                  dtype, dev, mesh)
            want = ref["legacy"][(arch, stub, dtype)]
            share = max(LEGACY_SHARE[dtype], want["ulp"] / want["big"])
            err, bound, ok = _within_bound(torch, firsts, want["firsts"],
                                           share)
            out["legacy"][(arch, stub, dtype)] = {
                "streams": streams, "streams_equal":
                streams == want["streams"], "first_max_err": err,
                "bound": bound, "first_ok": ok, "ulp": want["ulp"],
                "big": want["big"], "heads_sharded": plan.heads_sharded(cfg),
                "seconds": time.perf_counter() - t0}
            del params
            free_memory(torch)
    out["geometries"] = sorted(geos)
    return out


def _dist_rwkv_rank(torch, mesh):
    """(d) rwkv6-1.6b whole, bf16, on the mesh: RWKV_DIST_LENS, the
    blocking prefills timed apart (admission reads the first token back,
    so its host time is device-complete) and the collectives of the
    decode steps counted apart."""
    import numpy as np
    import repro_torch.configs as C
    from repro_torch.core import collectives
    from repro_torch.serving.api import LLM
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = C.get("rwkv6-1.6b")
    res = rec_spec(strategy="mixserve", max_len=512,
                   prompt_len=max(RWKV_DIST_LENS),
                   max_new_tokens=RWKV_DIST_NEW).resolve(cfg, mesh=mesh,
                                                         device=dev)
    llm = LLM.from_spec(res, cfg=cfg, device=dev, dtype=torch.bfloat16)
    eng = llm.engine
    weights = sum(t.numel() * t.element_size() for t in _leaves(llm.params))
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in RWKV_DIST_LENS]
    spent = {"prefill_s": 0.0, "prefills": 0, "decode_s": 0.0, "steps": 0}
    decode_coll: dict = {}
    admit, decode = eng._admit_legacy, eng._decode_impl

    def timed_admit(req, slot):
        t0 = time.perf_counter()
        try:
            return admit(req, slot)
        finally:
            spent["prefill_s"] += time.perf_counter() - t0
            spent["prefills"] += 1

    def counted_decode(tokens, active):
        before = dict(collectives.counters)
        t0 = time.perf_counter()
        nxt = decode(tokens, active)
        torch.cuda.synchronize()
        spent["decode_s"] += time.perf_counter() - t0
        spent["steps"] += 1
        for k, n in collectives.counters.items():
            d = n - before.get(k, 0)
            if d:
                key = f"{k[0]} {'+'.join(k[1])}"
                decode_coll[key] = decode_coll.get(key, 0) + d
        return nxt
    eng._admit_legacy, eng._decode_impl = timed_admit, counted_decode
    collectives.reset_counters()
    t0 = time.perf_counter()
    streams = llm.generate(prompts, RWKV_DIST_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    state = eng.cache["groups"][0]["state"]
    return {"streams": streams, "wall_s": wall, "weights_gb": weights / 1e9,
            "state_shape": tuple(state.shape),
            "decode_collectives": decode_coll, **spent}




def check_dist_geometries(torch, res, geos, dev):
    """flash_chunk / flash_decode at every geometry phase 5's ranks
    launched on a dense cache (the (c) f32 cases and the (d) bf16 serve):
    the kernel against its plain version on random inputs at those
    shapes, lengths [S, 1, S/2 + 5, 0] cut to the batch (a prefill:
    its rows from offset 0; a batch of 1: the whole step); the two
    geometries of this slice's PERF rows timed beside SDPA and their
    bound, in bf16 (the dense-cache rank step of (d), and the legacy rank
    decode of qwen2-vl-7b, which (c) runs in f32, also as a bf16 serve
    would run it)."""
    import numpy as np
    ops, ref = _ops()
    rng = np.random.default_rng(5)
    timed = {g for g in geos if g[0] == "flash_chunk"
             and g[-1] == "bfloat16"}
    legacy = {g for g in geos if g[0] == "flash_decode" and g[4] == 2
              and g[3] == 14 and g[5] == 128}          # qwen2-vl 14/2 heads
    timed |= legacy | {g[:-1] + ("bfloat16",) for g in legacy}
    todo = sorted(set(geos) | timed)
    for g in todo:
        kernel, b, sq, nq, nkv, hd, hdv, S, dn = g
        dtype = getattr(torch, dn)
        if kernel == "flash_decode" or b == 1:
            lens = [S, 1, S // 2 + 5, 0][:b] + [1] * max(0, b - 4)
            if b == 1:
                lens = [min(S, sq)]
        else:
            lens = [S, sq, S // 2 + 5, 0][:b] + [sq] * max(0, b - 4)
        q_len = [min(n, sq) for n in lens]
        q_off = [n - m for n, m in zip(lens, q_len)]
        args = _dense_case(torch, rng, b=b, sq=sq, nq=nq, nkv=nkv, hd=hd,
                           hdv=hdv, skv=S, q_off=q_off, q_len=q_len,
                           kv_len=lens, dtype=dtype, dev=dev)
        scale = hd ** -0.5
        if kernel == "flash_decode":
            q = args[0][:, 0].contiguous()
            ln = args[5]
            call = lambda q=q, a=args, ln=ln: ops.flash_decode(
                q, a[1], a[2], ln, scale=scale)
            plain = lambda q=q, a=args, ln=ln: ref.flash_decode_ref(
                q, a[1], a[2], ln, scale=scale)
            got, want = call(), plain()
            sd_args = (q[:, None], args[1], args[2], *(
                _i32(torch, a, dev) for a in (q_off, q_len, lens)))
            sd_want = want[:, None]
        else:
            call = lambda a=args: ops.flash_chunk(*a, scale=scale)
            plain = lambda a=args: ref.flash_chunk_ref(*a, scale=scale)
            got, want = call(), plain()
            sd_args, sd_want = args, want
        torch.cuda.synchronize()
        rec = {"label": f"{kernel} phase 5 rank geometry B={b} sq={sq} "
                        f"heads {nq}/{nkv} hd {hd}/{hdv} S={S} {dn}",
               "max_err": max_err(torch, got, want),
               "tol": list(FLASH_TOL[dn]),
               "ok": within(torch, got, want, *FLASH_TOL[dn]),
               "shape": f"q {tuple(args[0].shape)} k {tuple(args[1].shape)}"
                        f" v {tuple(args[2].shape)} q_off {q_off} q_len "
                        f"{q_len} kv_len {lens}"}
        if g in timed:
            time_rec(torch, rec, call, 20, plain, 5,
                     _sdpa_call(torch, *sd_args, scale, sd_want))
            item = 2 if dn == "bfloat16" else 4
            bts, flops = _attn_work(q_off, q_len, lens, nq, nkv, hd, hdv,
                                    item)
            rec.update(bytes=bts + got.numel() * item, flops=flops,
                       peak="bf16" if item == 2 else "f32", primary=False,
                       ran=g in geos)
        res.add("flash_chunk", rec, "disagrees with its plain version at a "
                                    "phase 5 rank geometry")
        del args, got, want
    free_memory(torch)

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
    deepseek = _dist_deepseek_rank(torch, mesh, ref)
    free_memory(torch)
    t0 = time.perf_counter()
    options = _dist_options_rank(torch, mesh, ref)
    options["seconds"] = time.perf_counter() - t0
    free_memory(torch)
    serve = _dist_serve_rank(torch, mesh)
    free_memory(torch)
    t0 = time.perf_counter()
    dense = _dist_serve_rank(torch, mesh, kv="dense")
    free_memory(torch)
    rwkv = _dist_rwkv_rank(torch, mesh)
    rwkv["seconds"] = time.perf_counter() - t0
    return {"rank": rank, "backend": mesh.backend, "mesh": repr(mesh),
            "device": torch.cuda.get_device_name(), "parity": parity,
            "deepseek": deepseek, "options": options, "serve": serve,
            "dense": dense, "rwkv": rwkv}


def dist_serve_rank(rank, world, workdir):
    """One rank of the bf16 sharded serve alone (``chip_compare.py``'s
    ``dist`` mode, on either tree): an untimed serve first, which sets up
    the process groups' communicators and the libraries' handles, as
    phase 5's parity runs do before its serve; then the timed one."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_host_mesh(*DIST_MESH)
    _dist_serve_rank(torch, mesh)
    free_memory(torch)
    return _dist_serve_rank(torch, mesh)


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
        ferr = max(c["fwd_max_err"] for c in per)
        print(f"[dist] (a) {case['case']}: moe_block vs unsharded max err "
              f"{err:.3e} (tol {TOL['float32']}), overflowed chunks per "
              f"rank {ovf}; forward logits (sharded attention, head and "
              f"residual) max err {ferr:.3e} (tol rtol {FWD_RTOL} + "
              f"{FWD_ATOL_REL} x max |logit| {case['fwd_max_logit']:.3f}); "
              f"LLM.generate streams equal "
              f"unsharded on every rank: "
              f"{all(c['streams_equal'] for c in per)} "
              f"({case['generate_s']:.2f}s, {label})")
        check(all(c["moe_ok"] for c in per),
              f"distributed {case['case']}: moe_block differs by {err}")
        check(all(c["fwd_ok"] for c in per),
              f"distributed {case['case']}: forward logits differ by {ferr}")
        check(all(c["streams_equal"] for c in per),
              f"distributed {case['case']}: streams differ from unsharded: "
              f"{[c['streams'] for c in per]}")
        check(not case["cap8"] or min(ovf) > 0,
              f"distributed {case['case']}: the 8-row cap never overflowed")
        check(not case["auto_cap"] or max(ovf) == 0,
              f"distributed {case['case']}: the auto cap overflowed")
    ds = [r["deepseek"] for r in ranks]
    ferr = max(c["fwd_max_err"] for c in ds)
    print(f"[dist] (a) deepseek-v2 2 layers (dense + MoE) f32 full width, "
          f"mixserve fused: {ds[0]['heads'][0]} of {ds[0]['heads'][1]} MLA "
          f"heads and d_ff {ds[0]['d_ff'][0]} of {ds[0]['d_ff'][1]} a rank, "
          f"weights "
          f"{[round(c['weights_gb'], 2) for c in ds]} GB per rank; forward "
          f"logits max err {ferr:.3e} (tol rtol {FWD_RTOL} + {FWD_ATOL_REL} "
          f"x max |logit| {ds[0]['fwd_max_logit']:.3f}); streams equal "
          f"unsharded on every rank: "
          f"{all(c['streams_equal'] for c in ds)}")
    check(all(c["fwd_ok"] for c in ds),
          f"distributed deepseek-v2: forward logits differ by {ferr}")
    check(all(c["streams_equal"] for c in ds),
          f"distributed deepseek-v2: streams differ from unsharded: "
          f"{[c['streams'] for c in ds]} vs {ds[0]['streams']}")
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
              f"weights {s['weights_gb']:.2f} GB, KV pool "
              f"{s['kv_gb']:.2f} GB, max_memory_allocated "
              f"{s['max_mem_gib']:.2f} GiB, load {s['load_s']:.1f}s; "
              f"exchange chunks {s['exchange']}; prefix hits "
              f"{s['prefix_hits']} [{card_line}]")
        per_step = {k: round(n / s["steps"], 3)
                    for k, n in s["collectives"].items()}
        print(f"[dist] (b) rank {r}: kernel launches {s['launches']} "
              f"(expect {want}); collectives {s['collectives']} "
              f"({per_step} per step); ep_load_stats {s['ep_load']}")
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
    _report_options(ranks, card_line)
    dense = _report_dense_serve(ranks, s0, n_moe, dsh, card_line, label)
    _report_rwkv(ranks, card_line, label)
    (work / "ref.pt").unlink()
    launches: dict = {}
    for s in sv + [r["dense"] for r in ranks]:
        for k, v in s["launches"].items():
            launches[k] = launches.get(k, 0) + v
    geos = {tuple(g) for r in ranks for part in (r["options"], r["dense"])
            for g in part["geometries"]}
    secs = {"options": max(r["options"]["seconds"] for r in ranks),
            "dense_and_rwkv": max(r["rwkv"]["seconds"] for r in ranks)}
    print(f"[dist] (c) and (d) seconds on the slowest rank "
          f"{json.dumps({k: round(v, 1) for k, v in secs.items()})}; phase "
          f"5 ranks {wall:.1f}s in all")
    return {"launches": launches, "wall_s": wall, "geometries": geos,
            "serve": {k: v for k, v in s0.items() if k != "streams"},
            "dense": {k: v for k, v in dense.items() if k != "streams"}}


def _report_options(ranks, card_line):
    """(c): print and check every rank's f32 option cases."""
    per = [r["options"] for r in ranks]
    for arch in ("phi3.5-moe-42b", "deepseek-v2-236b"):
        cs = [o[arch] for o in per]
        err = max(c["fwd_max_err"] for c in cs)
        print(f"[dist] (c) {arch} 2 layers f32 kv=dense: {cs[0]['cache_rows']}"
              f" of 4 slots a rank; dense-cache steps (32-row mixed, 1-row)"
              f" and the stateless forward, logits vs unsharded max err "
              f"{err:.3e} (tol rtol {FWD_RTOL} + {FWD_ATOL_REL} x max "
              f"|logit| {cs[0]['fwd_max_logit']:.3f}); LLM.generate streams "
              f"equal unsharded on every rank: "
              f"{all(c['streams_equal'] for c in cs)} "
              f"({max(c['seconds'] for c in cs):.1f}s) [{card_line}]")
        check(all(c["fwd_ok"] for c in cs),
              f"(c) {arch} dense: forward logits differ by {err}")
        check(all(c["streams_equal"] for c in cs),
              f"(c) {arch} dense: streams differ from unsharded: "
              f"{[c['streams'] for c in cs]}")
        check(all(c["cache_rows"] == 2 for c in cs),
              f"(c) {arch}: dense cache rows {[c['cache_rows'] for c in cs]}")
    runs = [o["spec"]["runs"] for o in per]
    plain = runs[0][("paged", "off")][0]
    check(all(r[("paged", "off")][2] for r in runs),
          "(c) spec: the plain mesh serve's streams differ from unsharded")
    for run in OPT_SPEC:
        got = [r[run] for r in runs]
        st = got[0][1]
        print(f"[dist] (c) phi3.5 2 layers f32 speculation k {SPEC_K} at "
              f"chunk 16, kv {run[0]}, draft {run[1]}: streams equal the "
              f"plain mesh serve's on every rank "
              f"{all(g[0] == plain for g in got)}, the unsharded run's "
              f"{all(g[2] for g in got)}; counters equal the unsharded "
              f"run's {all(g[3] for g in got)}: {json.dumps(st)}")
        check(all(g[0] == plain for g in got),
              f"(c) spec {run}: streams differ from the plain serve's")
        check(all(g[2] and g[3] for g in got),
              f"(c) spec {run}: streams or counters differ from unsharded")
        check(st["n_spec_drafted"] > 0, f"(c) spec {run}: nothing drafted")
    for arch, layers, stub, dtype in OPT_LEGACY:
        cs = [o["legacy"][(arch, stub, dtype)] for o in per]
        err = max(c["first_max_err"] for c in cs)
        c0 = cs[0]
        print(f"[dist] (c) {arch} "
              f"{'whole' if layers is None else f'{layers} layers'} {dtype} "
              f"legacy path, stub {stub}, heads split "
              f"{c0['heads_sharded']}: streams equal unsharded on every "
              f"rank {all(c['streams_equal'] for c in cs)}; first-token "
              f"logits max err {err:.3e} (bound rtol 1e-4 + "
              f"{c0['bound']:.3e}: max({LEGACY_SHARE[dtype]:g} of the "
              f"largest |logit| {c0['big']:.3f}, the move under layer 0's "
              f"norm x (1 + 2^-23) {c0['ulp']:.3e}); {err / c0['big']:.2e}"
              f" of the largest) "
              f"({max(c['seconds'] for c in cs):.1f}s)")
        check(all(c["streams_equal"] for c in cs),
              f"(c) {arch} {stub} {dtype}: streams differ from unsharded: "
              f"{[c['streams'] for c in cs]}")
        check(all(c["first_ok"] for c in cs),
              f"(c) {arch} {stub} {dtype}: first-token logits differ by "
              f"{err}")


def _report_dense_serve(ranks, paged, n_moe, dsh, card_line, label):
    """(d): phi3.5 8 layers bf16 on kv="dense": launches exact, streams
    equal across ranks, the collectives a step against (b)'s."""
    sv = [r["dense"] for r in ranks]
    s0 = sv[0]
    runs = s0["exchange"].get("chunks", 0) + s0["exchange"].get("overflow",
                                                               0)
    want = {"flash_chunk": 8 * s0["steps"], "topk_gate": n_moe * s0["steps"]}
    want.update({k: v * runs for k, v in DIST_PER_CHUNK.items()})
    n_tok = sum(len(v) for v in s0["streams"])
    gather = "all_gather data"
    for r, s in enumerate(sv):
        per_step = {k: round(n / s["steps"], 3)
                    for k, n in s["collectives"].items()}
        paged_step = {k: round(n / paged["steps"], 3)
                      for k, n in paged["collectives"].items()}
        total = sum(s["collectives"].values()) / s["steps"]
        total_p = sum(paged["collectives"].values()) / paged["steps"]
        print(f"[dist] (d) rank {r}: phi3.5 8 layers bf16 kv=dense, "
              f"{n_tok} new tokens in {s['steps']} steps, {s['wall_s']:.2f}s"
              f" ({s['wall_s'] / s['steps'] * 1e3:.1f} ms/step, {label}); "
              f"weights {s['weights_gb']:.2f} GB, KV (dense, the rank's "
              f"rows and heads) {s['kv_gb']:.2f} GB, max_memory_allocated "
              f"{s['max_mem_gib']:.2f} GiB [{card_line}]")
        print(f"[dist] (d) rank {r}: kernel launches {s['launches']} "
              f"(expect {want}); collectives a step {total:.3f} against "
              f"(b)'s {total_p:.3f} on the paged cache: {per_step} vs "
              f"{paged_step}")
        check(s["backend"] == "dense", f"(d) rank {r}: {s['backend']}")
        check(s["launches"] == want,
              f"(d) dense serve rank {r}: launches {s['launches']} != "
              f"{want}")
        check(s["exchange"].get("chunks") == s["steps"] * n_moe
              * dsh["chunks"], f"(d) dense serve rank {r}: "
              f"{s['exchange']} exchange chunks in {s['steps']} steps")
        check(s["streams"] == s0["streams"],
              f"(d) dense serve: rank {r}'s streams differ from rank 0's")
        # the dense cache drops the paged KV rows' gather: one a layer
        check(s["collectives"].get(gather, 0) == s["steps"]
              and paged["collectives"].get(gather, 0)
              == (8 + 1) * paged["steps"],
              f"(d) rank {r}: batch gathers {s['collectives'].get(gather)} "
              f"in {s['steps']} dense steps, "
              f"{paged['collectives'].get(gather)} in {paged['steps']} "
              f"paged steps")
    check(all(len(v) == 16 and all(0 <= t < s0["vocab"] for t in v)
              for v in s0["streams"]),
          f"(d) dense serve: streams {s0['streams']}")
    return s0


def _report_rwkv(ranks, card_line, label):
    """(d): rwkv6-1.6b whole, bf16, on the mesh."""
    rs = [r["rwkv"] for r in ranks]
    for r, s in enumerate(rs):
        steps = max(s["steps"], 1)
        coll = {k: round(n / steps, 3)
                for k, n in s["decode_collectives"].items()}
        print(f"[dist] (d) rank {r}: rwkv6-1.6b 24 layers bf16 legacy path "
              f"on the mesh: {s['prefills']} blocking prefills "
              f"{s['prefill_s']:.2f}s = {s['prefill_s'] / s['wall_s']:.3f} "
              f"of the wall time {s['wall_s']:.2f}s; {s['steps']} decode "
              f"steps, {s['decode_s'] / steps * 1e3:.1f} ms a decode step "
              f"({label}); collectives a decode step {coll}; weights "
              f"{s['weights_gb']:.2f} GB, wkv state {s['state_shape']} "
              f"[{card_line}]")
        check(s["streams"] == rs[0]["streams"],
              f"(d) rwkv6: rank {r}'s streams differ from rank 0's")
    check(all(len(v) == RWKV_DIST_NEW for v in rs[0]["streams"]),
          f"(d) rwkv6 streams {rs[0]['streams']}")


# ---------------------------------------------------------------------------
# phase 6: training on one device
# ---------------------------------------------------------------------------

# (a) each reduced config's gradient leaves, the card against the CPU:
# |cuda - cpu| <= bound * max|cpu leaf|.  The CPU tests hold the port to
# the reference with the same bounds (tests/_torch_train_helpers.py
# GRAD_BOUND): above 1e-4 the float32 gradient is ill-conditioned (the
# reference's own float32 gradients stray from float64 by that order).
TRAIN_GRAD_BOUND = {
    "smollm-360m": 6e-4, "phi3.5-moe-42b": 1.5e-3, "gemma-2b": 5e-3,
    "deepseek-v2-236b": 1e-4, "minicpm3-4b": 1e-4, "minitron-8b": 2e-3,
    "rwkv6-1.6b": 1e-4, "recurrentgemma-9b": 1e-3, "whisper-tiny": 1.5e-2,
    "qwen2-vl-7b": 1e-3,
}
# the loss, relative (whisper's float32 outputs are chaotic under a change
# of summation order: ROADMAP queue C)
TRAIN_LOSS_BOUND = {"whisper-tiny": 1e-4}
# (a)'s AdamW step: eps above most |g| keeps the step smooth in the
# gradient (the first step is g / (|g| + eps)), no clip, so an entry's
# move differs between the devices by at most lr |dg| / eps (checked
# elementwise with a factor 2), plus the last rounding of the new weight
# (the card fuses p - lr u into one multiply-add): 2^-23 (|p| + lr)
TRAIN_PARITY_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-2,
                        grad_clip=0.0)
# (b) smollm-360m whole; (c) phi3.5-moe-42b, 2 of 32 layers, full width
TRAIN_SMOLLM = dict(batch=8, seq=256, steps=30)
TRAIN_PHI = dict(layers=2, batch=4, seq=256, steps=10)
# test_training.py's schedule with the clip off: with the default clip at
# 1.0 a 32-layer model's gradient norm (a few hundred at init) shrinks
# every entry of the gradient that much, most of them under Adam's eps, and
# the loss does not move in 30 steps (in the reference as in the port:
# tests/test_torch_train_deep.py); (b) also runs the clip for comparison
TRAIN_OPT = dict(lr=2e-3, warmup_steps=3, total_steps=30, grad_clip=0.0)
TRAIN_CLIP_STEPS = 10
# the microbatched first step's loss against the whole batch's, relative:
# two bf16 roundings of the loss (its activations carry 8-bit mantissas;
# the half batch also gives capacity dispatch half the buffer rows, which
# moves which slots drop)
TRAIN_MICRO_BOUND = 2.0 ** -7


def draw_zero_leaves(torch, tree, gen):
    """``tree`` with every all-zero leaf (the norms' weights and the
    recurrent leaves init_params zeroes) drawn from ``gen``: the token-shift
    mixes uniform in [0, 1], lambda_p from N(-2, 1), the rest from
    N(0, 0.25)."""
    def leaf(t, name):
        if bool(t.any()):
            return t
        z = torch.randn(t.shape, generator=gen, device=t.device)
        if name == "mu":
            z = torch.rand(t.shape, generator=gen, device=t.device)
        elif name == "lambda_p":
            z = z - 2.0
        else:
            z = 0.5 * z
        return z.to(t.dtype)

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, key) for v in node)
        return leaf(node, key)
    return walk(tree)


def _train_batches(torch, cfg, batch, seq, n, dev, seed=0):
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    data = SyntheticLM(cfg, DataConfig(batch=batch, seq_len=seq, seed=seed))
    return [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
            for b in data.batches(n)]


def train_parity(torch, arch):
    """(a) One value_and_grad and AdamW step of a reduced config on the
    card and on the CPU from the same float32 weights and batch."""
    import repro_torch.configs as C
    from repro_torch.models.model import init_params
    from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                                init_opt_state)
    from repro_torch.training.train_step import value_and_grad
    from repro_torch.training.tree import flatten_with_paths, tree_map
    cfg = C.get_reduced(arch)
    gen = torch.Generator().manual_seed(11)
    cpu = draw_zero_leaves(torch, init_params(gen, cfg, torch.float32,
                                              "cpu"), gen)
    dev = tree_map(lambda t: t.cuda(), cpu)
    b_cpu = _train_batches(torch, cfg, 2, 32, 1, "cpu")[0]
    b_dev = {k: v.cuda() for k, v in b_cpu.items()}
    (l_dev, _), g_dev = value_and_grad(dev, b_dev, cfg)
    (l_cpu, _), g_cpu = value_and_grad(cpu, b_cpu, cfg)
    loss_err = abs(float(l_dev) - float(l_cpu)) / abs(float(l_cpu))
    bound = TRAIN_GRAD_BOUND[arch]
    worst, worst_at = 0.0, None
    for (p, a), (_, c) in zip(flatten_with_paths(g_dev),
                              flatten_with_paths(g_cpu)):
        e = float((a.cpu() - c).abs().max()) / max(float(c.abs().max()),
                                                   1e-30)
        if e > worst:
            worst, worst_at = e, "/".join(map(str, p))
    opt = AdamWConfig(**TRAIN_PARITY_OPT)
    adamw_update(opt, g_dev, init_opt_state(dev), dev)
    adamw_update(opt, g_cpu, init_opt_state(cpu), cpu)
    step_ratio = 0.0
    for (_, pa), (_, pc), (_, ga), (_, gc) in zip(
            flatten_with_paths(dev), flatten_with_paths(cpu),
            flatten_with_paths(g_dev), flatten_with_paths(g_cpu)):
        allowed = 2 * opt.lr * (ga.cpu() - gc).abs() / opt.eps \
            + 2.0 ** -23 * (pc.abs() + opt.lr)
        step_ratio = max(step_ratio,
                         float(((pa.cpu() - pc).abs() / allowed).max()))
    loss_bound = TRAIN_LOSS_BOUND.get(arch, 1e-5)
    ok = loss_err <= loss_bound and worst <= bound and step_ratio <= 1.0
    print(f"[train] parity {arch}: loss cuda {float(l_dev):.6f} cpu "
          f"{float(l_cpu):.6f} (rel {loss_err:.2e}, bound "
          f"{loss_bound:.0e}); worst "
          f"gradient leaf {worst_at} {worst:.3e} of its largest (bound "
          f"{bound:.1e}); params after an AdamW step within "
          f"{step_ratio:.3f} of 2 lr |dg| / eps (bound 1)")
    check(ok, f"train parity {arch}: card and CPU disagree")


def _profile_steps(torch, step, n):
    """Device busy ms and idle share over ``n`` calls of ``step``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = sorted(((getattr(ev, "self_device_time_total", 0.0) / 1e3,
                    ev.key) for ev in prof.key_averages()
                   if ev.device_type.name == "CUDA"), reverse=True)
    busy = sum(ms for ms, _ in kern)
    if busy <= 0:
        return None
    return {"busy_ms": busy / n, "wall_ms": wall_ms / n,
            "idle_share": max(0.0, 1 - busy / wall_ms),
            "top": [(name[:48], ms / busy) for ms, name in kern[:4]]}


def _train_run(torch, cfg, params, batches, card_line, label, *,
               remat=True, microbatches=1, prof_steps=2, **opt_kw):
    """Steps of make_train_step over ``batches`` (made beforehand): the
    losses, ms a step by wall clock (steps after the first), tokens/s,
    the peak memory, and a profiler window of ``prof_steps`` further
    steps (device ms a step, idle share)."""
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_step import make_train_step
    opt = init_opt_state(params)
    step = make_train_step(cfg, opt_cfg=AdamWConfig(**dict(TRAIN_OPT,
                                                           **opt_kw)),
                           remat=remat, microbatches=microbatches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    t1 = None
    for i, b in enumerate(batches):
        params, opt, m = step(params, opt, b)
        losses.append(m["loss"])
        if i == 0:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
    torch.cuda.synchronize()
    n = len(batches) - 1
    ms = (time.perf_counter() - t1) * 1e3 / max(n, 1)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    out = {"losses": losses, "peak": peak, "params": params, "opt": opt}
    if not n:
        return out
    dev = "no profiler window"
    if prof_steps:
        def one():
            step(params, opt, batches[-1])
        prof = _profile_steps(torch, one, prof_steps)
        dev = ("device not measured (the profiler reported no CUDA "
               "kernel time)" if prof is None else
               f"device {prof['busy_ms']:.1f} ms a step, idle share "
               f"{prof['idle_share']:.3f} over {prof_steps} profiled "
               f"steps (wall {prof['wall_ms']:.1f} ms a step, profiler on; "
               f"largest device-time shares: "
               + ", ".join(f"{k} {v:.3f}" for k, v in prof["top"]) + ")")
    print(f"[train] {label}: {len(batches)} steps, {ms:.1f} ms a step "
          f"(wall, steps 2-{len(batches)}), "
          f"{batches[0]['tokens'].numel() / (ms / 1e3):.0f} tokens/s, peak "
          f"{peak / 2**30:.2f} GiB; {dev}; losses {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} [{card_line}]")
    return out


def _falling(losses):
    k = min(5, len(losses) // 2)
    first, last = sum(losses[:k]) / k, sum(losses[-k:]) / k
    return all(math.isfinite(x) for x in losses) and last < first - 0.1, \
        first, last


def train_smollm(torch, card_line):
    """(b) smollm-360m, all 32 layers, bf16, remat on: 30 steps of batch
    8 x 256 (made before the timed loop) and (e) a checkpoint of the
    trained state; then the first 10 steps again with the default clip
    (1.0), whose loss is printed, not held; then 3 steps with remat off
    from the same weights, for its peak memory."""
    import repro_torch.configs as C
    from repro_torch.models.model import count_params, init_params
    cfg = C.get("smollm-360m")
    tr = TRAIN_SMOLLM
    batches = _train_batches(torch, cfg, tr["batch"], tr["seq"],
                             tr["steps"], "cuda")

    def fresh():
        return init_params(torch.Generator(device="cuda").manual_seed(0),
                           cfg, torch.bfloat16, "cuda")
    label = (f"smollm-360m whole ({cfg.n_layers} layers), bf16, remat, "
             f"batch {tr['batch']} x {tr['seq']}")
    run = _train_run(torch, cfg, fresh(), batches, card_line, label)
    ok, first, last = _falling(run["losses"])
    print(f"[train] smollm-360m: losses finite, mean of the first 5 "
          f"{first:.4f}, of the last 5 {last:.4f} (must fall by 0.1)")
    check(ok, "smollm-360m: the loss did not fall")
    train_checkpoint(torch, {"params": run.pop("params"),
                             "opt": run.pop("opt")}, "smollm-360m",
                     card_line)
    free_memory(torch)
    n_clip = TRAIN_CLIP_STEPS
    clip = _train_run(torch, cfg, fresh(), batches[:n_clip], card_line,
                      label + ", grad_clip 1.0", prof_steps=0,
                      grad_clip=1.0)
    print(f"[train] smollm-360m, the first {n_clip} steps: with the "
          f"default clip 1.0 the loss went {clip['losses'][0]:.4f} -> "
          f"{clip['losses'][-1]:.4f}, without it "
          f"{run['losses'][0]:.4f} -> {run['losses'][n_clip - 1]:.4f}")
    del clip
    free_memory(torch)
    off = _train_run(torch, cfg, fresh(), batches[:3], card_line,
                     label.replace("remat", "remat off"), remat=False,
                     prof_steps=0)
    n = count_params(cfg)
    print(f"[train] smollm-360m peak memory: remat on "
          f"{run['peak'] / 2**30:.2f} GiB, remat off "
          f"{off['peak'] / 2**30:.2f} GiB; {n:,} params: "
          f"{_train_state_bytes(n) / 2**30:.2f} GiB of bf16 params and "
          f"grads and f32 moments [{card_line}]")
    del run, off
    free_memory(torch)


def _train_state_bytes(n_params: int) -> int:
    """bf16 params and grads, f32 m and v: 12 bytes a parameter."""
    return n_params * (2 + 2 + 4 + 4)


def train_checkpoint(torch, tree, label, card_line):
    """(e) ``tree`` (trained params and optimizer state) saved through the
    build directory (gitignored) and restored bit for bit."""
    from repro_torch.training import checkpoint
    from repro_torch.training.tree import flatten_with_paths
    ck_dir = ROOT / "build" / "train_checkpoint"
    ck_dir.mkdir(parents=True, exist_ok=True)
    path = ck_dir / "state.npz"
    t0 = time.perf_counter()
    checkpoint.save(str(path), tree)
    t_save = time.perf_counter() - t0
    size = path.stat().st_size
    t0 = time.perf_counter()
    back = checkpoint.restore(str(path), tree)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    same = all(a.dtype == b.dtype and torch.equal(a, b)
               for (_, a), (_, b) in zip(flatten_with_paths(back),
                                         flatten_with_paths(tree)))
    path.unlink()
    print(f"[train] checkpoint of {label}'s trained params and optimizer "
          f"state: {size / 1e9:.2f} GB, save {t_save:.1f} s, restore "
          f"{t_restore:.1f} s, bitwise equal {same} [{card_line}]")
    check(same, f"{label}: the checkpoint did not restore bit for bit")


def train_phi(torch, card_line):
    """(c) phi3.5-moe-42b at full width, 2 of 32 layers (16 experts,
    top-2, capacity dispatch), bf16, remat on: 10 steps of batch 4 x 256;
    then the first step again from the same weights with
    microbatches=2."""
    from repro_torch.models.model import count_params, init_params
    tr = TRAIN_PHI
    cfg = _cut("phi3.5-moe-42b", tr["layers"])
    n = count_params(cfg)
    print(f"[train] phi3.5-moe-42b {tr['layers']} layers: {n:,} params, "
          f"{_train_state_bytes(n) / 1e9:.1f} GB of bf16 params and grads "
          f"and f32 moments")
    batches = _train_batches(torch, cfg, tr["batch"], tr["seq"],
                             tr["steps"], "cuda")

    def fresh():
        return init_params(torch.Generator(device="cuda").manual_seed(1),
                           cfg, torch.bfloat16, "cuda")
    label = (f"phi3.5-moe-42b ({cfg.n_layers} of 32 layers, 16 experts, "
             f"top-2, capacity), bf16, remat, batch {tr['batch']} x "
             f"{tr['seq']}")
    run = _train_run(torch, cfg, fresh(), batches, card_line, label)
    ok, first, last = _falling(run["losses"])
    print(f"[train] phi3.5-moe-42b: losses finite, mean of the first 5 "
          f"{first:.4f}, of the last 5 {last:.4f} (must fall by 0.1)")
    check(ok, "phi3.5-moe-42b: the loss did not fall")

    del run["params"], run["opt"]
    free_memory(torch)

    micro = _train_run(torch, cfg, fresh(), batches[:1], card_line,
                       label + ", microbatches 2", microbatches=2,
                       prof_steps=0)
    rel = abs(micro["losses"][0] - run["losses"][0]) / abs(run["losses"][0])
    print(f"[train] phi3.5-moe-42b first step, microbatches 2 against the "
          f"whole batch: loss {micro['losses'][0]:.5f} against "
          f"{run['losses'][0]:.5f}, rel {rel:.2e} (bound "
          f"{TRAIN_MICRO_BOUND:.2e}); peak {micro['peak'] / 2**30:.2f} GiB "
          f"[{card_line}]")
    check(rel <= TRAIN_MICRO_BOUND, "phi3.5-moe-42b: the microbatched step "
                                    "strays from the whole batch's")
    del run, micro
    free_memory(torch)


def train_guard(torch):
    """(d) on the card, a kernels-on forward under autograd raises (no
    kernel has a backward); the same forward under no_grad runs through
    the kernels."""
    import repro_torch.configs as C
    from repro_torch.core.partitioner import make_plan
    from repro_torch.kernels import ops
    from repro_torch.kernels.policy import KernelPolicy
    from repro_torch.models.model import init_params
    from repro_torch.training.train_step import loss_fn, value_and_grad
    cfg = C.get_reduced("phi3.5-moe-42b")
    params = init_params(torch.Generator(device="cuda").manual_seed(2),
                         cfg, torch.float32, "cuda")
    plan = make_plan("mixserve", None, kernels=KernelPolicy.all_on())
    b = _train_batches(torch, cfg, 2, 32, 1, "cuda")[0]
    try:
        value_and_grad(params, b, cfg, plan)
        raised = ""
    except RuntimeError as e:
        raised = str(e)
    before = dict(ops.counters)
    with torch.no_grad():
        loss, _ = loss_fn(params, b, cfg, plan)
    moved = {k: v - before.get(k, 0) for k, v in ops.counters.items()
             if v != before.get(k, 0)}
    print(f"[train] guard: kernels on under autograd raised: "
          f"{raised[:80]!r}; under no_grad the forward ran (loss "
          f"{float(loss):.4f}) with launches {json.dumps(moved)}")
    check("no backward" in raised, "a kernels-on forward under autograd "
                                   "did not raise")
    check(math.isfinite(float(loss)) and moved.get("moe_gemm", 0) > 0,
          "the kernels-on forward under no_grad did not run the kernels")


def phase_train(torch, card_line):
    """Phase 6: (a) parity on the card, (b) smollm-360m whole with (e)
    its checkpoint, (c) phi3.5-moe-42b at full width, none of which
    launches a kernel, then (d) the guard."""
    from repro_torch.kernels import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    before = dict(ops.counters)
    for arch in TRAIN_GRAD_BOUND:
        train_parity(torch, arch)
    free_memory(torch)
    train_smollm(torch, card_line)
    train_phi(torch, card_line)
    check(dict(ops.counters) == before,
          "the training phases moved a kernel counter")
    train_guard(torch)
    free_memory(torch)


# ---------------------------------------------------------------------------
# phase 7: training on a mesh
# ---------------------------------------------------------------------------

TRAIN_MESH = (2, 2)                      # (data, model)
# (a) parity: reduced configs, f32, capacity factor 8 (nothing drops);
# each gradient block within TRAIN_GRAD_BOUND (the CPU tests' GRAD_BOUND)
TRAIN_MESH_ARCHS = ("phi3.5-moe-42b", "smollm-360m")
TRAIN_MESH_PARITY = dict(batch=4, seq=32, cf=8.0)
# (b) phi3.5-moe-42b at full width, 2 of 32 layers, as the CLI trains it
TRAIN_MESH_WIDE = dict(layers=2, batch=4, seq=256, steps=3, lr=2e-3)
# the dropless lane: (a') phi3.5 reduced with the EP exchange in 2 chunks
# capped at a chunk's mean rows a destination (a rank's 2 x 32 tokens, 32
# a chunk at top-2 over EP 2: 32 rows), so chunks overflow and run again;
# (b') the wide run of (b) with an explicit dropless plan
TRAIN_MESH_DROPLESS = dict(arch="phi3.5-moe-42b", chunks=2, cap_rows=32)


def _mesh_aux(dp):
    """The unsharded MoE's router aux by the mesh's rule (mixserve: the
    mean of the aux of each of the ``dp`` batch ranks' rows); the routing
    itself is per token, unchanged.  Returns the restore function."""
    from repro_torch.models import moe as M
    orig = M.route_topk

    def route(logits, k, renorm=True, use_kernel=False):
        idx, w, _ = orig(logits, k, renorm, use_kernel)
        n = logits.shape[0] // dp
        auxs = [orig(logits[d * n:(d + 1) * n], k, renorm, use_kernel)[2]
                for d in range(dp)]
        return idx, w, sum(auxs) / dp
    M.route_topk = route

    def restore():
        M.route_topk = orig
    return restore


def _train_mesh_cfg(arch):
    import repro_torch.configs as C
    return dataclasses.replace(C.get_reduced(arch),
                               capacity_factor=TRAIN_MESH_PARITY["cf"])


def _train_mesh_reference(torch, path):
    """(a)'s unsharded f32 steps on the card: per config the weights, two
    batches, the loss and gradients of each step, the weights after the
    two AdamW steps (the aux by the mesh's rule), all on the host; for
    (a') the first step's loss and gradients with dropless dispatch."""
    from repro_torch.core.partitioner import make_plan
    from repro_torch.models.model import init_params
    from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                                init_opt_state)
    from repro_torch.training.train_step import value_and_grad
    from repro_torch.training.tree import tree_map
    opt = AdamWConfig(**TRAIN_PARITY_OPT)
    tp = TRAIN_MESH_PARITY
    out = {}
    restore = _mesh_aux(TRAIN_MESH[0])
    try:
        for arch in TRAIN_MESH_ARCHS:
            cfg = _train_mesh_cfg(arch)
            gen = torch.Generator(device="cuda").manual_seed(21)
            w0 = draw_zero_leaves(torch, init_params(
                gen, cfg, torch.float32, "cuda"), gen)
            params = tree_map(lambda t: t.clone(), w0)
            batches = _train_batches(torch, cfg, tp["batch"], tp["seq"], 2,
                                     "cuda")
            state = init_opt_state(params)
            rec = {"weights": tree_map(lambda t: t.cpu(), w0),
                   "batches": [{k: v.cpu() for k, v in b.items()}
                               for b in batches], "loss": [], "grads": []}
            if arch == TRAIN_MESH_DROPLESS["arch"]:    # (a')
                (loss, _), g = value_and_grad(
                    tree_map(lambda t: t.clone(), w0), batches[0], cfg,
                    make_plan("mixserve", None, dispatch="dropless"),
                    remat=False)
                rec["dropless"] = {"loss": float(loss), "grads": tree_map(
                    lambda t: t.cpu(), g)}
            for b in batches:
                (loss, _), g = value_and_grad(params, b, cfg, remat=False)
                rec["loss"].append(float(loss))
                rec["grads"].append(tree_map(lambda t: t.cpu(), g))
                params, state, _ = adamw_update(opt, g, state, params)
            rec["params"] = tree_map(lambda t: t.cpu(), params)
            out[arch] = rec
    finally:
        restore()
    torch.save(out, path)


def _block_tree(torch, plan, cfg, tree, dev=None):
    """This rank's blocks of a whole tree (``training.tree.store_specs``)."""
    from repro_torch.training.tree import (flatten_with_paths, store_specs,
                                           tree_map)
    specs = iter(store_specs(cfg, plan, tree))
    paths = iter(flatten_with_paths(tree))

    def one(t):
        next(paths)
        s = next(specs)
        t = t if s is None else t[plan.block(tuple(t.shape), s)]
        return t.contiguous().to(dev) if dev else t.contiguous()
    return tree_map(one, tree)


def _train_mesh_parity_rank(torch, mesh, ref, work):
    """(a) on this rank: two mesh steps (mixserve, sp and fsdp on, remat)
    from the reference's weights: the first step's loss and each of its
    gradient blocks against the unsharded ones (the second step's weights
    already differ by rounding, and a routing decision near a tie may
    flip), the weights after the two AdamW steps elementwise within
    Adam's move under both steps' gradient differences; (c) phi3.5's
    state saved through the mesh and as this rank's blocks."""
    from repro_torch.core.partitioner import make_plan
    from repro_torch.training import checkpoint
    from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                                init_opt_state)
    from repro_torch.training.train_step import value_and_grad
    from repro_torch.training.tree import (flatten_with_paths, store_specs,
                                           tree_map)
    opt = AdamWConfig(**TRAIN_PARITY_OPT)
    out = {}
    for arch in TRAIN_MESH_ARCHS:
        cfg = _train_mesh_cfg(arch)
        plan = make_plan("mixserve", mesh, fsdp=True)
        r = ref[arch]
        params = _block_tree(torch, plan, cfg, r["weights"], "cuda")
        state = init_opt_state(params)
        cuts = [tuple(a for m in s if m is not None for a in m)
                for s in store_specs(cfg, plan, params)]
        worst, worst_at, dgs, losses = 0.0, None, [], []
        t0 = time.perf_counter()
        for i, b in enumerate(r["batches"]):
            b = {k: v.cuda() for k, v in b.items()}
            (loss, _), g = value_and_grad(params, b, cfg, plan)
            losses.append(abs(float(loss) - r["loss"][i]) / abs(r["loss"][i]))
            want = _block_tree(torch, plan, cfg, r["grads"][i])
            dg = []
            for (p, a), (_, w), (_, whole) in zip(
                    flatten_with_paths(g), flatten_with_paths(want),
                    flatten_with_paths(r["grads"][i])):
                d = (a.cpu() - w).abs()
                e = float(d.max()) / max(float(whole.abs().max()), 1e-30)
                if i == 0 and e > worst:
                    worst, worst_at = e, "/".join(map(str, p))
                dg.append(d)
            dgs.append(dg)
            params, state, _ = adamw_update(opt, g, state, params,
                                            cuts=cuts, mesh=mesh)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / len(r["batches"])
        # each step moves an entry by lr * u; u's move under a gradient
        # change dg is at most ~2 |dg| / eps a step (no clip), plus the
        # new weights' last rounding
        want_p = _block_tree(torch, plan, cfg, r["params"])
        ratio = 0.0
        for i, ((_, a), (_, w)) in enumerate(zip(flatten_with_paths(params),
                                                 flatten_with_paths(want_p))):
            allowed = 4 * opt.lr * (dgs[0][i] + dgs[1][i]) / opt.eps \
                + 2.0 ** -22 * (w.abs() + 2 * opt.lr)
            ratio = max(ratio, float(((a.cpu() - w).abs() / allowed).max()))
        out[arch] = {"loss_err": losses, "worst": worst,
                     "worst_at": worst_at, "ratio": ratio,
                     "step_s": step_s,
                     "ok": losses[0] <= TRAIN_LOSS_BOUND.get(arch, 1e-5)
                     and worst <= TRAIN_GRAD_BOUND[arch] and ratio <= 1.0}
        if arch == "phi3.5-moe-42b":       # (c)
            tree = {"params": params, "opt": state}
            t0 = time.perf_counter()
            checkpoint.save(str(work / "mesh_state.npz"), tree, plan=plan,
                            cfg=cfg)
            out["save_s"] = time.perf_counter() - t0
            torch.save(tree_map(lambda t: t.cpu(), tree),
                       work / f"blocks{mesh.rank}.pt")
            like = tree_map(torch.zeros_like, tree)
            back = checkpoint.restore(str(work / "mesh_state.npz"), like,
                                      plan=plan, cfg=cfg)
            out["restored"] = all(
                a.dtype == b.dtype and torch.equal(a, b)
                for (_, a), (_, b) in zip(flatten_with_paths(back),
                                          flatten_with_paths(tree)))
    return out


def _train_mesh_dropless_rank(torch, mesh, ref):
    """(a') on this rank: the first mesh step of an explicit dropless plan
    (mixserve, sp and fsdp on, remat; the exchange in chunks at a tight
    cap) from (a)'s phi3.5 weights: its loss and gradient blocks against
    the unsharded dropless step's, and the exchange's chunks and
    overflow reruns in that step."""
    from repro_torch.core.cost_model import EpOverlap
    from repro_torch.core.partitioner import make_plan
    from repro_torch.models import moe as M
    from repro_torch.training.train_step import value_and_grad
    from repro_torch.training.tree import flatten_with_paths
    td = TRAIN_MESH_DROPLESS
    arch = td["arch"]
    cfg = _train_mesh_cfg(arch)
    r = ref[arch]
    plan = make_plan("mixserve", mesh, fsdp=True, dispatch="dropless",
                     ep_overlap=EpOverlap(chunks=td["chunks"],
                                          cap_rows=td["cap_rows"]))
    params = _block_tree(torch, plan, cfg, r["weights"], "cuda")
    b = {k: v.cuda() for k, v in r["batches"][0].items()}
    M.exchange_counts.clear()
    (loss, _), g = value_and_grad(params, b, cfg, plan)
    exchange = dict(M.exchange_counts)
    want = _block_tree(torch, plan, cfg, r["dropless"]["grads"])
    worst, worst_at = 0.0, None
    for (p, a), (_, w), (_, whole) in zip(
            flatten_with_paths(g), flatten_with_paths(want),
            flatten_with_paths(r["dropless"]["grads"])):
        e = float((a.cpu() - w).abs().max()) \
            / max(float(whole.abs().max()), 1e-30)
        if e > worst:
            worst, worst_at = e, "/".join(map(str, p))
    want_loss = r["dropless"]["loss"]
    loss_err = abs(float(loss) - want_loss) / abs(want_loss)
    return {"loss_err": loss_err, "worst": worst, "worst_at": worst_at,
            "exchange": exchange,
            "ok": loss_err <= TRAIN_LOSS_BOUND.get(arch, 1e-5)
            and worst <= TRAIN_GRAD_BOUND[arch]
            and exchange.get("overflow", 0) > 0}


def _train_mesh_wide_rank(torch, mesh, dispatch="auto"):
    """(b) on this rank: phi3.5-moe-42b at full width, 2 layers, through
    ``launch.train.train_loop`` as the CLI trains (mixserve, sp on, bf16,
    remat; "auto" dispatch trains on capacity buffers, (b') passes
    "dropless"): ms a step, peak memory, the collectives a step and the
    dropless exchange's chunks and overflow reruns."""
    from repro_torch.core import collectives as C
    from repro_torch.core.partitioner import make_plan
    from repro_torch.launch.train import train_loop
    from repro_torch.models import moe as M
    from repro_torch.models.model import count_params
    tw = TRAIN_MESH_WIDE
    cfg = _cut("phi3.5-moe-42b", tw["layers"])
    plan = make_plan("mixserve", mesh, dispatch=dispatch)
    torch.cuda.reset_peak_memory_stats()
    C.reset_counters()
    M.exchange_counts.clear()
    # host seconds inside collectives (a gloo call waits for the kernels
    # that make its input), and inside the after-backward gradient sums,
    # timed here only: the port's module keeps no clock
    spent = {"all": 0.0, "grad_sums": 0.0}
    issue, sums = C._issue, C.psum_grads

    def clocked(fn, key):
        def run(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[key] += time.perf_counter() - t
        return run
    C._issue, C.psum_grads = clocked(issue, "all"), clocked(sums,
                                                           "grad_sums")
    t0 = time.perf_counter()
    try:
        params, _, hist = train_loop(cfg, plan, "cuda", steps=tw["steps"],
                                     batch=tw["batch"], seq=tw["seq"],
                                     lr=tw["lr"], dtype=torch.bfloat16,
                                     remat=True, log=None)
    finally:
        C._issue, C.psum_grads = issue, sums
    wall = time.perf_counter() - t0
    coll = {"/".join([k[0], "+".join(k[1])] + list(k[2:])): v
            for k, v in sorted(C.counters.items())}
    n_local = sum(t.numel() for t in _leaves(params))
    del params
    return {"losses": [h["loss"] for h in hist],
            "ms": [h["ms"] for h in hist], "wall_s": wall, "spent": spent,
            "peak": torch.cuda.max_memory_allocated(),
            "collectives": coll, "n_local": n_local,
            "n_params": count_params(cfg),
            "capacity": _capacity_rows(cfg, tw, plan),
            "exchange": dict(M.exchange_counts)}


def _capacity_rows(cfg, tw, plan):
    """(C a rank's buffers hold per expert, rows each expert's FFN
    takes after the exchange)."""
    from repro_torch.models.moe import capacity_for
    t = tw["batch"] // plan.dp * tw["seq"]
    c = capacity_for(t, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    return c, c * plan.ep


def train_mesh_rank(rank, world, workdir):
    """One rank of phase 7 (runs in its own process)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = pathlib.Path(workdir)
    mesh = make_host_mesh(*TRAIN_MESH)
    ref = torch.load(work / "train_ref.pt", weights_only=False)
    before = dict(ops.counters)
    parity = _train_mesh_parity_rank(torch, mesh, ref, work)
    dropless = _train_mesh_dropless_rank(torch, mesh, ref)
    del ref
    free_memory(torch)
    wide = _train_mesh_wide_rank(torch, mesh)
    free_memory(torch)
    wide_dropless = _train_mesh_wide_rank(torch, mesh, "dropless")
    free_memory(torch)
    return {"rank": rank, "backend": mesh.backend, "parity": parity,
            "dropless": dropless, "wide": wide,
            "wide_dropless": wide_dropless,
            "kernels_moved": dict(ops.counters) != before}


def _train_mesh_whole_file(torch, work):
    """(c) the single-device file of the mesh state: each leaf assembled
    from the 4 ranks' blocks (written by each rank, placed by
    ``plan.block`` here, not by the mesh's gathers), saved by one
    process."""
    from repro_torch.core.partitioner import make_plan
    from repro_torch.launch.mesh import Mesh
    from repro_torch.training import checkpoint
    from repro_torch.training.tree import (flatten_with_paths, store_specs,
                                           tree_map)
    cfg = _train_mesh_cfg("phi3.5-moe-42b")
    world = TRAIN_MESH[0] * TRAIN_MESH[1]
    blocks = [torch.load(work / f"blocks{r}.pt", weights_only=False)
              for r in range(world)]
    plans = [make_plan("mixserve", Mesh(("data", "model"), TRAIN_MESH, r),
                       fsdp=True) for r in range(world)]
    # whole shapes: each leaf's block times its cut sizes
    specs = store_specs(cfg, plans[0], blocks[0])
    wholes = []
    for i, ((_, b0), s) in enumerate(zip(flatten_with_paths(blocks[0]),
                                         specs)):
        shape = list(b0.shape)
        for d, m in enumerate(s or ()):
            if m is not None:
                shape[d] *= plans[0].mesh.axis_size(m)
        w = torch.empty(shape, dtype=b0.dtype)
        for r in range(world):
            blk = flatten_with_paths(blocks[r])[i][1]
            w[plans[r].block(tuple(shape), s) if s else ...] = blk
        wholes.append(w)
    it = iter(wholes)
    whole = tree_map(lambda _: next(it), blocks[0])
    checkpoint.save(str(work / "whole_state.npz"), whole)
    same = (work / "whole_state.npz").read_bytes() \
        == (work / "mesh_state.npz").read_bytes()
    size = (work / "mesh_state.npz").stat().st_size
    for p in list(work.glob("blocks*.pt")) + [work / "whole_state.npz",
                                             work / "mesh_state.npz"]:
        p.unlink()
    return same, size


def phase_train_mesh(torch, card_line):
    """Phase 7: training on a 2x2 (data, model) mesh, 4 ranks over gloo
    on the one card (NCCL, one rank a card, where there are 4): (a) f32
    parity of mesh steps against the unsharded ones, (b) phi3.5-moe-42b
    at full width as the CLI trains it, (c) the mesh checkpoint against
    the single-device file; the dropless lane: (a') f32 parity of an
    explicit dropless plan whose chunked exchange overflows its cap and
    reruns, (b') (b) with that plan; no kernel counter moves."""
    from repro_torch.launch.mesh import pick_backend
    from repro_torch.launch.ranks import RankFailed, run_ranks
    work = ROOT / "build" / "train_mesh"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    _train_mesh_reference(torch, work / "train_ref.pt")
    free_memory(torch)
    backend = pick_backend(4, "cuda")
    label = ("4 ranks sharing one card" if backend == "gloo"
             else "4 ranks, one card each")
    print(f"[train-mesh] unsharded f32 references in "
          f"{time.perf_counter() - t0:.1f}s; spawning 4 ranks, backend "
          f"{backend}, mesh (data, model) = {TRAIN_MESH} [{label}]")
    t0 = time.perf_counter()
    try:
        ranks = run_ranks(train_mesh_rank, 4, (str(work),), workdir=work,
                          device="cuda", timeout_s=600)
    except RankFailed as e:
        raise SmokeError(f"training on a mesh: {e}") from e
    wall = time.perf_counter() - t0
    (work / "train_ref.pt").unlink()
    # (a)
    for arch in TRAIN_MESH_ARCHS:
        per = [r["parity"][arch] for r in ranks]
        w = max(per, key=lambda c: c["worst"])
        print(f"[train-mesh] (a) {arch} reduced, f32, mixserve 2x2, sp and "
              f"fsdp on, remat, batch {TRAIN_MESH_PARITY['batch']} x "
              f"{TRAIN_MESH_PARITY['seq']}, 2 AdamW steps: loss rel err "
              f"{max(c['loss_err'][0] for c in per):.2e} (bound "
              f"{TRAIN_LOSS_BOUND.get(arch, 1e-5):.0e}; the second step's "
              f"{max(c['loss_err'][1] for c in per):.2e}); worst gradient "
              f"block {w['worst_at']} {w['worst']:.3e} of the leaf's "
              f"largest (bound {TRAIN_GRAD_BOUND[arch]:.1e}); weights after "
              f"2 steps within {max(c['ratio'] for c in per):.3f} of Adam's "
              f"move under the gradients' differences (bound 1); "
              f"{max(c['step_s'] for c in per) * 1e3:.0f} ms a step")
        check(all(c["ok"] for c in per),
              f"training on a mesh, {arch}: the mesh step strays from the "
              f"unsharded one")
    # (a')
    td = TRAIN_MESH_DROPLESS
    per = [r["dropless"] for r in ranks]
    w = max(per, key=lambda c: c["worst"])
    print(f"[train-mesh] (a') {td['arch']} reduced, f32, dropless, mixserve "
          f"2x2 fused, sp and fsdp on, remat, batch "
          f"{TRAIN_MESH_PARITY['batch']} x {TRAIN_MESH_PARITY['seq']}, the "
          f"EP exchange in {td['chunks']} chunks capped at {td['cap_rows']} "
          f"rows a destination: loss rel err "
          f"{max(c['loss_err'] for c in per):.2e} (bound "
          f"{TRAIN_LOSS_BOUND.get(td['arch'], 1e-5):.0e}); worst gradient "
          f"block {w['worst_at']} {w['worst']:.3e} of the leaf's largest "
          f"(bound {TRAIN_GRAD_BOUND[td['arch']]:.1e}) against the "
          f"unsharded dropless step; exchange chunks "
          f"{[c['exchange'].get('chunks', 0) for c in per]}, overflow "
          f"reruns {[c['exchange'].get('overflow', 0) for c in per]} a rank "
          f"in the differentiated step [{card_line}]")
    check(all(c["ok"] for c in per),
          "training a dropless plan on a mesh: the mesh step strays from "
          "the unsharded one, or no chunk overflowed its cap")
    # (b)
    wd = [r["wide"] for r in ranks]
    tw = TRAIN_MESH_WIDE
    w0 = wd[0]
    cap, rows = w0["capacity"]
    print(f"[train-mesh] (b) phi3.5-moe-42b {tw['layers']} of 32 layers at "
          f"full width ({w0['n_params']:,} params; "
          f"{[r['wide']['n_local'] for r in ranks]} a rank), mixserve 2x2 "
          f"fused, sp on, bf16, remat, batch {tw['batch']} x {tw['seq']}, "
          f"capacity C {cap} a rank ({rows} rows an expert after the "
          f"exchange), {tw['steps']} steps [{label}]")
    for r, x in enumerate(wd):
        steady = x["ms"][1:] or x["ms"]
        ms = sum(steady) / len(steady)
        coll = {k: round(v / tw["steps"], 2)
                for k, v in x["collectives"].items()}
        print(f"[train-mesh] (b) rank {r}: {ms:.1f} ms a step (wall, "
              f"steps 2-{tw['steps']}; first {x['ms'][0]:.1f}), "
              f"{tw['batch'] * tw['seq'] / (ms / 1e3):.0f} tokens/s, peak "
              f"{x['peak'] / 2**30:.2f} GiB; host clock inside "
              f"collectives {x['spent']['all']:.2f}s of the loop's "
              f"{x['wall_s']:.2f}s (the gradient sums after the backward "
              f"{x['spent']['grad_sums']:.2f}s); losses "
              f"{[round(v, 4) for v in x['losses']]} [{card_line}]")
        print(f"[train-mesh] (b) rank {r}: collectives a step by kind/axes"
              f"[/backward]: {json.dumps(coll)}")
        check(all(math.isfinite(v) for v in x["losses"])
              and x["losses"][-1] < x["losses"][0],
              f"training on a mesh, rank {r}: losses {x['losses']}")
        check(x["losses"] == w0["losses"],
              f"training on a mesh: rank {r}'s losses differ from rank 0's")
    # (b')
    wl = [r["wide_dropless"] for r in ranks]
    print(f"[train-mesh] (b') the same with dispatch=\"dropless\": "
          f"phi3.5-moe-42b {tw['layers']} of 32 layers at full width, "
          f"mixserve 2x2 fused, sp on, bf16, remat, batch {tw['batch']} x "
          f"{tw['seq']}, the EP exchange monolithic, {tw['steps']} steps "
          f"[{label}]")
    for r, (x, c) in enumerate(zip(wl, wd)):
        ms, cms = (sum(v[1:] or v) / len(v[1:] or v)
                   for v in (x["ms"], c["ms"]))
        fwd, bwd, cfwd, cbwd = (
            sum(v for k, v in y["collectives"].items()
                if k.endswith("/backward") == back) / tw["steps"]
            for y in (x, c) for back in (False, True))
        ex = {k: v / tw["steps"] for k, v in x["exchange"].items()}
        print(f"[train-mesh] (b') rank {r}: {ms:.1f} ms a step (wall, "
              f"steps 2-{tw['steps']}; first {x['ms'][0]:.1f}), "
              f"{tw['batch'] * tw['seq'] / (ms / 1e3):.0f} tokens/s, peak "
              f"{x['peak'] / 2**30:.2f} GiB, collectives a step {fwd:g} "
              f"forward + {bwd:g} backward, exchange chunks "
              f"{ex.get('chunks', 0):g} and overflow reruns "
              f"{ex.get('overflow', 0):g} a step; capacity lane (b): "
              f"{cms:.1f} ms, {tw['batch'] * tw['seq'] / (cms / 1e3):.0f} "
              f"tokens/s, {c['peak'] / 2**30:.2f} GiB, {cfwd:g} + {cbwd:g} "
              f"collectives; losses {[round(v, 4) for v in x['losses']]} "
              f"[{card_line}]")
        coll = {k: round(v / tw["steps"], 2)
                for k, v in x["collectives"].items()}
        print(f"[train-mesh] (b') rank {r}: collectives a step by kind/axes"
              f"[/backward]: {json.dumps(coll)}")
        check(all(math.isfinite(v) for v in x["losses"])
              and x["losses"][-1] < x["losses"][0],
              f"training a dropless plan on a mesh, rank {r}: losses "
              f"{x['losses']}")
        check(x["losses"] == wl[0]["losses"],
              f"training a dropless plan on a mesh: rank {r}'s losses "
              f"differ from rank 0's")
    check(not any(r["kernels_moved"] for r in ranks),
          "training on a mesh moved a kernel counter")
    # (c)
    same, size = _train_mesh_whole_file(torch, work)
    save_s = ranks[0]["parity"]["save_s"]
    print(f"[train-mesh] (c) phi3.5 reduced mesh state (params, moments, "
          f"step; {size / 1e6:.1f} MB) saved through the mesh in "
          f"{save_s:.2f}s: byte-equal to the single-device file of the "
          f"same state {same}; restored to every rank's blocks bit for "
          f"bit {all(r['parity']['restored'] for r in ranks)}; phase 7 "
          f"ranks {wall:.1f}s")
    check(same, "the mesh checkpoint differs from the single-device file")
    check(all(r["parity"]["restored"] for r in ranks),
          "the mesh checkpoint did not restore to each rank's blocks")


# ---------------------------------------------------------------------------
# Phase 8: the entry points (the serve CLI, the weight loader, the examples)
# ---------------------------------------------------------------------------

# (argv, label): the CLI's whole gemma-2b (f32, the CLI's default dtype),
# its default reduced phi3.5, and rwkv6 whole on the legacy path
ENTRY_CLI = (
    (["--arch", "gemma-2b", "--no-reduced", "--requests", "12", "--rate",
      "0", "--prompt-len", "256", "--max-new", "32"], "gemma-2b whole"),
    (["--arch", "phi3.5-moe-42b", "--rate", "0"], "phi3.5 reduced"),
    (["--arch", "rwkv6-1.6b", "--no-reduced", "--requests", "4", "--rate",
      "0", "--prompt-len", "32", "--max-new", "8"], "rwkv6-1.6b whole"),
)
ENTRY_LOAD_LENS = (64, 256, 100, 180)      # (b): gemma-2b bf16, 16 new
ENTRY_TRAIN_STEPS = 20                      # (c): train_small
# each kernel wrapper's inputs are kept at most this many distinct
# geometries a run, each at its first call and at its ENTRY_LATER-th (a
# step deep in the caches), then the kernel is held to its plain body on
# them
ENTRY_GEOMETRIES = 3
ENTRY_LATER = 40
# per wrapper: (tolerance by dtype, or None for bitwise equal)
ENTRY_TOL = {"flash_chunk_paged": FLASH_TOL, "flash_chunk": FLASH_TOL,
             "flash_decode": FLASH_TOL, "grouped_gemm": TOL,
             "moe_gemm": TOL, "unpermute_tokens": UNPERMUTE_TOL,
             "permute_tokens": None, "permute_tokens_ragged": None,
             "topk_gate": None}


class record_calls:
    """Within the block, keep copies of the inputs of the first and the
    ``ENTRY_LATER``-th call of every kernel wrapper at each of up to
    ``ENTRY_GEOMETRIES`` geometries (the shapes, dtypes and scalar
    arguments) in ``sink``: {wrapper: [(args, kwargs), ...]}.  The wrappers
    count and launch as before; only those calls copy their inputs."""

    def __init__(self, sink):
        self.sink = sink

    def __enter__(self):
        ops, _ = _ops()
        self.ops, self.saved = ops, {n: getattr(ops, n) for n in ENTRY_TOL}
        seen: dict = {}

        def key(v):
            return (tuple(v.shape), str(v.dtype)) if hasattr(v, "shape") \
                else v

        def clone(v):
            return v.clone() if hasattr(v, "clone") else v

        def wrap(name, fn):
            def rec(*a, **kw):
                k = (tuple(key(v) for v in a),
                     tuple(sorted((n, key(v)) for n, v in kw.items())))
                got = seen.setdefault(name, {})
                if k in got or len(got) < ENTRY_GEOMETRIES:
                    got[k] = got.get(k, 0) + 1
                if got.get(k) in (1, ENTRY_LATER):
                    self.sink.setdefault(name, []).append(
                        ([clone(v) for v in a],
                         {n: clone(v) for n, v in kw.items()}))
                return fn(*a, **kw)
            return rec
        for name, fn in self.saved.items():
            setattr(ops, name, wrap(name, fn))
        return self.sink

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.ops, name, fn)


def check_recorded(torch, res, calls, label):
    """Every recorded call (``record_calls``): the kernel against its plain
    body on the same inputs on the card (the router gate's ids and the
    gathers bitwise, its weights within 1e-6, the rest within the phase 2
    tolerances)."""
    ops, ref = _ops()
    for name, runs in sorted(calls.items()):
        for a, kw in runs:
            got = getattr(ops, name)(*a, **kw)
            want = getattr(ref, name + "_ref")(*a, **kw)
            torch.cuda.synchronize()
            if name == "topk_gate":
                err = max_err(torch, got[0], want[0])
                ok = bool(torch.equal(got[1], want[1])) and err <= 1e-6
                tol = [1e-6, 0.0]
            else:
                err = max_err(torch, got, want)
                tols = ENTRY_TOL[name]
                tol = [0.0, 0.0] if tols is None else \
                    list(tols[dname(got.dtype)])
                ok = bool(torch.equal(got, want)) if tols is None \
                    else within(torch, got, want, *tol)
            shapes = [tuple(v.shape) for v in a if hasattr(v, "shape")]
            res.add(name, {"label": f"{name} phase 8 {label}",
                           "max_err": err, "tol": tol, "ok": ok,
                           "shape": f"{shapes} {dname(a[0].dtype)}"},
                    f"disagrees with its plain version at a phase 8 "
                    f"({label}) geometry")
            del got, want


def _cli_per_step(cfg):
    """The kernel launches of one unified step of ``cfg`` with the CLI's
    defaults (paged KV, dropless dispatch)."""
    per = {"flash_chunk_paged": cfg.n_layers}
    n_moe = cfg.n_layers - cfg.first_dense_layers if cfg.is_moe else 0
    if n_moe:
        per.update(topk_gate=n_moe, permute_tokens=n_moe,
                   unpermute_tokens=n_moe, grouped_gemm=3 * n_moe)
    return per


def entry_cli(torch, card_line, res):
    """(a): ``repro_torch.launch.serve.main`` on each of ENTRY_CLI, kernel
    counters exact per step for the unified-step families, none for the
    legacy path; the serve's inputs of every kernel geometry held to the
    plain bodies afterwards."""
    import repro_torch.configs as C
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serving.api import LLM
    out = {}
    box: dict = {}
    orig = LLM.serve

    def timed_serve(self, reqs, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sched = orig(self, reqs, **kw)
        torch.cuda.synchronize()
        box["serve_s"] = time.perf_counter() - t0
        return sched
    LLM.serve = timed_serve
    try:
        for argv, label in ENTRY_CLI:
            free_memory(torch)
            torch.cuda.reset_peak_memory_stats()
            calls: dict = {}
            print(f"[entry] python -m repro_torch.launch.serve "
                  f"{' '.join(argv)}")
            ops.reset_counters()
            t0 = time.perf_counter()
            with record_calls(calls):
                sched = serve.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(ops.counters)
            eng = sched.engine
            cfg, spec = eng.cfg, eng.spec
            steps, m = eng.n_forward, sched.metrics()
            args = serve.parse_args(argv)
            n_req, new = args.requests, args.max_new
            mem = torch.cuda.max_memory_allocated() / 2**30
            ser = box.pop("serve_s")
            print(f"[entry] {label}: {cfg.name} ({cfg.n_layers} layers, "
                  f"f32), {len(sched.finished)} requests, {steps} steps "
                  f"({'legacy decode' if eng.legacy else 'unified'}) in "
                  f"{ser:.2f}s of serve ({ser / max(steps, 1) * 1e3:.1f} "
                  f"ms/step), TTFT mean {m.ttft_mean * 1e3:.0f} ms, ITL "
                  f"mean {m.itl_mean * 1e3:.1f} ms, "
                  f"{m.throughput_tok_s:.1f} tok/s, main() {wall:.1f}s, "
                  f"max_memory_allocated {mem:.1f} GiB; kernels "
                  f"{spec.kernels.describe()} <- "
                  f"{spec.provenance.get('kernels')}; launches {launches} "
                  f"[{card_line}]")
            check(spec.cluster == "h100x1"
                  and spec.kernels.describe() == "all-on"
                  and spec.provenance.get("kernels") == "auto:device(cuda)",
                  f"{label}: resolved {spec.cluster}, kernels "
                  f"{spec.kernels.describe()}")
            check(len(sched.finished) == n_req and all(
                len(r.out_tokens) == new for r in sched.finished),
                f"{label}: a request did not finish with {new} tokens")
            check(all(0 <= t < cfg.vocab_size for r in sched.finished
                      for t in r.out_tokens),
                  f"{label}: token id outside the vocabulary")
            if eng.legacy:
                check(not launches and cfg.family in ("ssm", "hybrid"),
                      f"{label}: the legacy path launched {launches}")
            else:
                want = expected_launches(_cli_per_step(cfg), steps)
                check(steps > 0 and launches == want,
                      f"{label}: launch counters {launches} != {want}")
            want_cfg = C.get_reduced(args.arch) if args.reduced \
                else C.get(args.arch)
            check(cfg == want_cfg,
                  f"{label}: served {cfg.name}, {cfg.n_layers} layers")
            out[label] = {"launches": launches, "steps": steps,
                          "serve_s": ser, "ms_step": ser / max(steps, 1) * 1e3,
                          "ttft_ms": m.ttft_mean * 1e3,
                          "itl_ms": m.itl_mean * 1e3,
                          "tok_s": m.throughput_tok_s, "max_mem_gib": mem}
            del sched, eng
            free_memory(torch)
            check_recorded(torch, res, calls, label)
            del calls
    finally:
        LLM.serve = orig
    return out


def _paired(a, b):
    """(leaf of a, leaf of b) at each path of two trees, which must have
    the same keys (in any order)."""
    if isinstance(a, dict):
        check(sorted(a) == sorted(b), f"trees differ: {sorted(a)} vs "
                                      f"{sorted(b)}")
        for k in sorted(a):
            yield from _paired(a[k], b[k])
    elif isinstance(a, list):
        check(len(a) == len(b), "trees differ in a list's length")
        for x, y in zip(a, b):
            yield from _paired(x, y)
    else:
        yield a, b


def entry_weights(torch, card_line, res):
    """(b): gemma-2b whole in bf16 on the card -> the HF-style flat dict
    (CPU) -> ``load_llama_style`` back onto the card: every leaf bitwise
    equal; then the same 4 prompts served from each tree, kernels on,
    greedy streams equal."""
    import numpy as np
    import repro_torch.configs as C
    from repro_torch.models.model import init_params
    from repro_torch.serving.api import LLM
    from repro_torch.serving.weights import (export_llama_style,
                                             load_llama_style)
    cfg = C.get("gemma-2b")
    params = init_params(torch.Generator("cuda").manual_seed(0), cfg,
                         torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flat = export_llama_style(params, cfg)
    t_exp = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load_llama_style(flat, cfg, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    n_bytes = sum(t.numel() * t.element_size() for t in flat.values())
    pairs = list(_paired(params, loaded))
    same = all(a.dtype == b.dtype and a.device == b.device
               and torch.equal(a, b) for a, b in pairs)
    print(f"[entry] weights: {cfg.name} whole, bf16, tied embeddings "
          f"(vocab {cfg.vocab_size}, padded {cfg.padded_vocab}): "
          f"{len(flat)} HF tensors, {n_bytes / 2**30:.2f} GiB; export "
          f"{t_exp:.1f}s (card -> host), load {t_load:.1f}s (host -> card); "
          f"{len(pairs)} leaves, all bitwise equal: {same} [{card_line}]")
    check(same, "weights: a loaded leaf differs from the original")
    del flat
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in ENTRY_LOAD_LENS]
    spec = _spec(prompt_len=max(ENTRY_LOAD_LENS), max_new_tokens=16)
    runs = []
    calls: dict = {}
    for tree, label in ((params, "original"), (loaded, "loaded")):
        llm = LLM.from_spec(spec, cfg=cfg, params=tree, device="cuda",
                            dtype=torch.bfloat16)
        with record_calls(calls):
            runs.append(_serve(torch, llm, prompts, 16,
                               {"flash_chunk_paged": cfg.n_layers},
                               card_line, f"{cfg.name} whole, {label} tree"))
        del llm
        free_memory(torch)
    check(runs[0]["streams"] == runs[1]["streams"],
          "weights: the loaded tree's streams differ from the original's")
    print(f"[entry] weights: the {len(prompts)} greedy streams of the "
          f"loaded tree equal the original's: True")
    del params, loaded, pairs
    free_memory(torch)
    check_recorded(torch, res, calls, "gemma-2b bf16 loaded")
    return {"export_s": t_exp, "load_s": t_load, "bytes": n_bytes,
            "serves": runs}


def entry_examples(torch, card_line, res):
    """(c): the quickstart (reduced deepseek-v2, kernels on) and
    train_small for ENTRY_TRAIN_STEPS steps; its loss must fall."""
    from repro_torch.examples import quickstart, train_small
    from repro_torch.kernels import ops
    calls: dict = {}
    ops.reset_counters()
    t0 = time.perf_counter()
    with record_calls(calls):
        llm, outs = quickstart.main(["--device", "cuda"])
    torch.cuda.synchronize()
    launches = dict(ops.counters)
    check(llm.spec.kernels.describe() == "all-on"
          and [len(o) for o in outs] == [8, 8, 8] and launches,
          f"quickstart: kernels {llm.spec.kernels.describe()}, streams "
          f"{[len(o) for o in outs]}, launches {launches}")
    print(f"[entry] quickstart: {time.perf_counter() - t0:.1f}s, launches "
          f"{launches} [{card_line}]")
    del llm
    free_memory(torch)
    check_recorded(torch, res, calls, "quickstart")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist = train_small.main(["--steps", str(ENTRY_TRAIN_STEPS),
                             "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    first, last = hist[0]["loss"], hist[-1]["loss"]
    print(f"[entry] train_small: {len(hist)} steps in {wall:.1f}s, loss "
          f"step 0 {first:.4f} -> step {len(hist) - 1} {last:.4f}, "
          f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB "
          f"[{card_line}]")
    check(len(hist) == ENTRY_TRAIN_STEPS and math.isfinite(last)
          and last < first, "train_small: the loss did not fall")
    free_memory(torch)
    return {"quickstart_launches": launches, "train_loss": [first, last]}


def phase_entry(torch, card_line, kres):
    """Phase 8: the entry points as a user drives them; returns the CLI
    serves' launches (read from their runs only)."""
    res = Results()
    res.recs = kres
    t0 = time.perf_counter()
    cli = entry_cli(torch, card_line, res)
    t1 = time.perf_counter()
    weights = entry_weights(torch, card_line, res)
    t2 = time.perf_counter()
    examples = entry_examples(torch, card_line, res)
    t3 = time.perf_counter()
    print(f"[entry] seconds: cli {t1 - t0:.1f}, weights {t2 - t1:.1f}, "
          f"examples {t3 - t2:.1f}")
    launches: dict = {}
    for s in cli.values():
        for k, v in s["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return {"launches": launches, "cli": cli, "weights": weights,
            "examples": examples}


# ---------------------------------------------------------------------------
# phase 9: the dry run against the card
# ---------------------------------------------------------------------------

DRY_LAYERS = 8                        # phi3.5's depth on one card (phase 4)
DRY_PREFILL = (4, 1024, 4096)         # slots, chunk rows, cache rows
DRY_DECODE_LENS = (1024, 700, 333, 4000)
DRY_MESH = dict(batch=4, max_len=1024, lens=(100, 200, 300, 400))
DRY_PRODUCTION = [(a, s, m) for a in ("phi3.5-moe-42b", "deepseek-v2-236b")
                  for s in ("decode_32k", "prefill_32k")
                  for m in ("single", "multi")]
CUBLAS_WORKSPACE = 32 << 20  # Hopper's default CUBLAS_WORKSPACE_CONFIG :4096:8
KERNEL_WRAPPERS = ("flash_chunk", "flash_decode", "flash_chunk_paged",
                   "topk_gate", "moe_gemm", "grouped_gemm", "permute_tokens",
                   "permute_tokens_ragged", "unpermute_tokens")


def dry_bound(at_peak: dict) -> int:
    """How far the card's peak may stand from the dry run's: 512 bytes a
    storage live at the predicted peak (the allocator rounds each request
    up to 512), 1 MiB more a large one (a cached large block is handed out
    unsplit when at most 1 MiB would remain), and one cuBLAS workspace (a
    GEMM path the warm-up did not take)."""
    return 512 * at_peak["live"] + (1 << 20) * at_peak["large"] \
        + CUBLAS_WORKSPACE


def _price_kernels(torch):
    """Wrap every kernel wrapper so that a call on the card also prices
    itself, on meta copies of its inputs, in ``ops.meta_flops``; returns
    the undo."""
    from repro_torch.kernels import ops
    saved = {n: getattr(ops, n) for n in KERNEL_WRAPPERS}

    def meta(x):
        return x.to("meta") if torch.is_tensor(x) else x

    def wrap(fn):
        def call(*a, **k):
            out = fn(*a, **k)
            fn(*map(meta, a), **{n: meta(v) for n, v in k.items()})
            return out
        return call
    for n, fn in saved.items():
        setattr(ops, n, wrap(fn))
    return lambda: [setattr(ops, n, fn) for n, fn in saved.items()]


def _dry_production_start():
    """(c) in a subprocess on the host: one JSON record a line."""
    code = ("import json\n"
            "from repro_torch.launch import dryrun\n"
            f"for a, s, m in {DRY_PRODUCTION!r}:\n"
            "    rec = dryrun.run_one(a, s, m, 'mixserve')\n"
            "    print(json.dumps(rec), flush=True)\n")
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            env={**os.environ,
                                 "PYTHONPATH": str(ROOT / "src"),
                                 "CUDA_VISIBLE_DEVICES": ""},
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _dry_compare(torch, label, step, real_args, meta_args):
    """One step predicted on meta, then run on the card: (a)'s checks."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    pred = dryrun.measure(step, meta_args)
    args = real_args()
    step(*args)                       # warm-up: kernels, cuBLAS handles
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = step(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    del out
    undo = _price_kernels(torch)
    ops.reset_counters()
    try:
        with FlopCounterMode(display=False) as fc:
            step(*args)
            torch.cuda.synchronize()
    finally:
        undo()
    kernels = sum(ops.meta_flops.values())
    real = {"argument_bytes": dryrun.argument_bytes(args),
            "flops": fc.get_total_flops() + kernels, "peak": peak}
    want = {"argument_bytes": pred["memory"]["argument_bytes"],
            "flops": int(pred["costs"]["flops"]),
            "peak": pred["memory"]["temp_bytes"]}
    bound = dry_bound(pred["storages_at_peak"])
    print(f"[dryrun] (a) {label}: arguments predicted "
          f"{want['argument_bytes']} real {real['argument_bytes']}; FLOPs "
          f"predicted {want['flops']:.6e} real {real['flops']:.6e} "
          f"(kernels {kernels:.6e}); peak of the step's allocations "
          f"predicted {want['peak']} measured {peak} (diff "
          f"{peak - want['peak']}, bound {bound}: {pred['storages_at_peak']}"
          f" storages live, large); bytes accessed "
          f"{pred['costs']['bytes_accessed']:.4e}; meta trace "
          f"{pred['trace_s']}s")
    check(real["argument_bytes"] == want["argument_bytes"],
          f"dry run {label}: argument bytes {want['argument_bytes']} "
          f"predicted, {real['argument_bytes']} real")
    check(real["flops"] == want["flops"],
          f"dry run {label}: {want['flops']} FLOPs predicted, "
          f"{real['flops']} counted")
    check(abs(peak - want["peak"]) <= bound,
          f"dry run {label}: peak {want['peak']} predicted, {peak} "
          f"measured, bound {bound}")
    return {"label": label, "predicted": want, "real": real, "bound": bound}


def _dry_single(torch, card_line):
    """(a): phi3.5 8 layers, bf16, NULL_PLAN with kernels on, then off."""
    from repro_torch.configs.base import InputShape
    from repro_torch.core.partitioner import NULL_PLAN
    from repro_torch.kernels.policy import KernelPolicy
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import cache_specs, params_and_specs
    from repro_torch.models.model import init_cache, init_params
    cfg = _cut("phi3.5-moe-42b", DRY_LAYERS)
    b, rows, max_len = DRY_PREFILL
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(gen, cfg, torch.bfloat16, "cuda")
    tok = torch.Generator().manual_seed(1)
    tokens = {"prefill": torch.randint(0, cfg.vocab_size, (b, rows),
                                       generator=tok, dtype=torch.int32),
              "decode": torch.randint(0, cfg.vocab_size, (b, 1),
                                      generator=tok, dtype=torch.int32)}
    out = []
    for kernels in ("on", "off"):
        plan = dataclasses.replace(NULL_PLAN,
                                   kernels=KernelPolicy.parse(kernels))
        meta_params, _ = params_and_specs(cfg, plan)
        for kind in ("prefill", "decode"):
            step = dryrun.make_step(cfg, InputShape(kind, rows, b, kind),
                                    plan, prefill_chunks=1)
            decode = kind == "decode"

            def real_args(kind=kind, decode=decode):
                cache = init_cache(cfg, b, max_len, torch.bfloat16, "cuda")
                if decode:
                    cache["length"] = torch.tensor(
                        DRY_DECODE_LENS, dtype=torch.int32, device="cuda")
                    return params, tokens[kind].cuda(), cache
                return params, {"tokens": tokens[kind].cuda()}, cache
            cache = cache_specs(cfg, b, max_len, plan, vector_lengths=decode)
            toks = torch.empty(tuple(tokens[kind].shape), dtype=torch.int32,
                               device="meta")
            meta_args = (meta_params, toks if decode else {"tokens": toks},
                         cache)
            out.append(_dry_compare(
                torch, f"{cfg.name} {kind} {b} x "
                       f"{1 if decode else rows} on a {b} x {max_len} cache,"
                       f" kernels {kernels} [{card_line}]",
                step, real_args, meta_args))
            free_memory(torch)
    return out


def dry_mesh_rank(rank, world):
    """(b): one rank's real decode step, then its dry run (own process)."""
    import torch

    from repro_torch.configs.base import InputShape
    from repro_torch.core import collectives as C
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh, make_host_mesh
    from repro_torch.launch.specs import cache_specs, params_and_specs
    from repro_torch.models.model import init_cache, init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_host_mesh(*DIST_MESH)
    cfg = _cut("phi3.5-moe-42b", DRY_LAYERS)
    b, max_len = DRY_MESH["batch"], DRY_MESH["max_len"]
    shape = InputShape("decode", max_len, b, "decode")
    plan = dryrun.plan_for(cfg, shape, mesh, "mixserve")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(gen, cfg, torch.bfloat16, "cuda", plan)
    cache = init_cache(cfg, b, max_len, torch.bfloat16, "cuda", plan)
    cache["length"] = torch.tensor(DRY_MESH["lens"], dtype=torch.int32,
                                   device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (b, 1),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32).cuda()
    step = dryrun.make_step(cfg, shape, plan)
    C.reset_counters()
    step(params, tokens, cache)
    torch.cuda.synchronize()
    real = {"calls": dict(C.counters), "bytes": dict(C.byte_counters),
            "argument_bytes": dryrun.argument_bytes((params, tokens, cache))}
    layout = Mesh(mesh.axis_names, DIST_MESH, rank)      # no process group
    plan = dryrun.plan_for(cfg, shape, layout, "mixserve")
    meta_args = (params_and_specs(cfg, plan)[0],
                 torch.empty(b, 1, dtype=torch.int32, device="meta"),
                 cache_specs(cfg, b, max_len, plan))
    m = dryrun.measure(dryrun.make_step(cfg, shape, plan), meta_args, layout)
    meta = {"calls": dict(C.counters), "bytes": dict(C.byte_counters),
            "argument_bytes": m["memory"]["argument_bytes"]}
    return {"rank": rank, "real": real, "meta": meta,
            "total": m["costs"]["collectives"]["bytes"]["total"]}


def _dry_mesh(torch, card_line):
    from repro_torch.launch.ranks import RankFailed, run_ranks
    work = ROOT / "build" / "dryrun_smoke"
    work.mkdir(parents=True, exist_ok=True)
    try:
        ranks = run_ranks(dry_mesh_rank, 4, workdir=work, device="cuda",
                          timeout_s=600)
    except RankFailed as e:
        raise SmokeError(f"dry run (b): {e}") from e
    for r in ranks:
        same = r["real"] == r["meta"]
        print(f"[dryrun] (b) rank {r['rank']} decode, phi3.5 "
              f"{DRY_LAYERS} layers, mixserve {DIST_MESH}: calls and bytes "
              f"by (kind, axes) equal {same}; "
              f"{sum(r['real']['calls'].values())} calls, "
              f"{r['total']} bytes on the wire, arguments "
              f"{r['real']['argument_bytes']} bytes [{card_line}]")
        check(same, f"dry run (b) rank {r['rank']}: real {r['real']} "
                    f"meta {r['meta']}")
    return ranks


def _dry_production_finish(proc):
    out, err = proc.communicate(timeout=600)
    check(proc.returncode == 0, f"dry run (c) failed: {err[-2000:]}")
    recs = [json.loads(line) for line in out.splitlines() if line.strip()]
    check(len(recs) == len(DRY_PRODUCTION), f"dry run (c): {len(recs)} "
          f"records of {len(DRY_PRODUCTION)}")
    for r in recs:
        c = r["costs"]
        print(f"[dryrun] (c) {r['arch']} {r['shape']} {r['mesh']} "
              f"({r['n_devices']} ranks, rank 0): "
              f"{r['peak_bytes'] / 2 ** 30:.2f} GiB a rank (arguments "
              f"{r['memory']['argument_bytes'] / 2 ** 30:.2f}, step "
              f"{r['memory']['temp_bytes'] / 2 ** 30:.2f}), fits "
              f"{r['fits']}; {c['flops']:.4e} FLOPs; collective bytes "
              f"{json.dumps(c['collectives']['bytes'])}; traced in "
              f"{r['trace_s']}s (host)")
        check(r["status"] == "ok" and r["fits"],
              f"dry run (c) {r['arch']} {r['shape']} {r['mesh']}: {r}")
    return recs


def phase_dryrun(torch, card_line):
    """Phase 9: (c) starts on the host first, (a) and (b) use the card."""
    proc = _dry_production_start()
    try:
        single = _dry_single(torch, card_line)
        free_memory(torch)
        mesh = _dry_mesh(torch, card_line)
        prod = _dry_production_finish(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return {"single": single, "mesh": mesh, "production": prod}


# ---------------------------------------------------------------------------
# phase 10: autotune
# ---------------------------------------------------------------------------

AT_ARCH, AT_LAYERS = "phi3.5-moe-42b", 2     # (c): the fresh process's serve
AT_LENS = (64, 256, 100, 180)                 # its 4 prompts
AT_NEW = 8
AT_PAGE, AT_CAP, AT_SLACK = 32, 4, 25         # (c)'s registered resolver tier
AT_FLASH = [{"rows": r, "n_split": s} for r in (64, 128)
            for s in (1, 2, 4, 8, 16)]
AT_ITERS = 20


def at_spec():
    """(c)'s serve: the batch cap, the chunk (ITL slack) and the page left
    to the resolver, which reads them from the registrations."""
    from repro_torch.serving.api import ServeSpec
    return ServeSpec(arch=AT_ARCH, kernels="auto", reduced=False, seed=0,
                     prompt_len=max(AT_LENS), max_new_tokens=AT_NEW)


def _at_cands(default, extra, bad):
    """The candidates of a sweep: the analytic plan first, then ``extra``
    (no repeats), then one the kernel refuses."""
    out = [default] + [c for c in extra if c != default]
    return out + [bad]


def _at_sweep(torch, label, op, fn, args, cands, plain, tol, bitwise):
    """Hold every valid candidate's output to ``plain`` within ``tol`` and,
    with ``bitwise``, to the analytic plan's bit for bit; then time them
    all through ``autotune.tune`` (CUDA events, the median of AT_ITERS),
    which registers the fastest.  A refused candidate must raise
    ``ValueError`` before any launch.  Returns the sweep's record."""
    from repro_torch.kernels import autotune as AT
    from repro_torch.kernels import ops
    key = AT.key_shape(op, args)
    out_of = lambda o: o if isinstance(o, tuple) else (o,)
    outs = []
    for c in cands:
        n0 = sum(ops.counters.values())
        try:
            AT.check_plan(op, key, args[0].dtype, c)
        except ValueError:
            try:
                fn(*args, **c)
            except ValueError:
                check(sum(ops.counters.values()) == n0,
                      f"{label}: refused plan {c} launched")
                outs.append(None)
                continue
            raise SmokeError(f"{label}: the wrapper launched {c}, which "
                             "check_plan refuses")
        outs.append(fn(*args, **c))
    torch.cuda.synchronize()
    ok_tol, same = [], []
    first = out_of(outs[0])
    for o in outs:
        if o is None:
            continue
        o = out_of(o)
        ok_tol.append(all(within(torch, a, b, *tol)
                          for a, b in zip(o, out_of(plain))))
        same.append(all(torch.equal(a, b) for a, b in zip(o, first)))
    timings = []
    best = AT.tune(op, fn, cands, *args, iters=AT_ITERS, timings=timings)
    rec = {"label": label, "key": list(key), "default": cands[0],
           "winner": best, "within_tol": all(ok_tol),
           "bitwise_across": all(same),
           "candidates": [{"plan": p, "ms": ms, "within_tol": t,
                           "bitwise_to_default": s}
                          for (p, ms), t, s in zip(
                              [x for x in timings if x[1] is not None],
                              ok_tol, same)]
           + [{"plan": p, "ms": None, "refused": True}
              for p, ms in timings if ms is None]}
    d_ms = timings[0][1]
    print(f"[autotune] {label} key {tuple(key)}: analytic {cands[0]} "
          f"{d_ms:.4f} ms | "
          + " | ".join(f"{p} {ms:.4f} ms" if ms is not None
                       else f"{p} refused" for p, ms in timings[1:])
          + f" | winner {best}; within tol {rec['within_tol']}, bitwise "
          f"across candidates {rec['bitwise_across']}")
    check(rec["within_tol"], f"{label}: a candidate plan disagrees with "
                             "the plain version")
    check(not bitwise or rec["bitwise_across"],
          f"{label}: candidate plans give different bits")
    check(AT.lookup(op, key, args[0].dtype) == best,
          f"{label}: the winner was not registered under the wrapper's key")
    return rec


def _at_attention(torch, rng, label, b, sq, nq, nkv, hd, hdv, max_len,
                  paged, dev):
    """Attention at a serve's step: a prefill chunk mid-cache, a decode at
    the cache's end, a prompt's first rows, an idle slot (as phase 2)."""
    q_off = ([max(0, max_len // 2 - sq), max_len - 1, 0, 0] + [0] * b)[:b]
    q_len = ([sq, 1, min(37, sq), 0] + [0] * b)[:b]
    kv_len = [o + n for o, n in zip(q_off, q_len)]
    ops, ref = _ops()
    if paged:
        page = 16
        args = _paged_case(torch, rng, b=b, sq=sq, nq=nq, nkv=nkv, hd=hd,
                           hdv=hdv, page=page, nb=max_len // page,
                           n_pages=b * (max_len // page), q_off=q_off,
                           q_len=q_len, kv_len=kv_len,
                           dtype=torch.bfloat16, dev=dev)
        fn, plain_fn = ops.flash_chunk_paged, ref.flash_chunk_paged_ref
    else:
        args = _dense_case(torch, rng, b=b, sq=sq, nq=nq, nkv=nkv, hd=hd,
                           hdv=hdv, skv=max_len, q_off=q_off, q_len=q_len,
                           kv_len=kv_len, dtype=torch.bfloat16, dev=dev)
        fn, plain_fn = ops.flash_chunk, ref.flash_chunk_ref
    default = dict(zip(("rows", "n_split"),
                       ops.flash_plan(b, sq, nq, nkv, hd, hdv)))
    cands = _at_cands(default, [c for c in AT_FLASH
                                if c["rows"] == 64 or hd <= 256],
                      {"rows": 64, "n_split": ops.FLASH_MAX_SPLIT + 1})
    plain = plain_fn(*args)
    rec = _at_sweep(torch, label, "flash", fn, args, cands, plain,
                    FLASH_TOL["bfloat16"], False)
    # the open question: do the bits move with rows at one n_split?
    by_split = {}
    for c in cands[:-1]:
        by_split.setdefault(c["n_split"], []).append(fn(*args, **c))
    rec["rows_change_bits"] = any(not torch.equal(v[0], x)
                                  for v in by_split.values() for x in v[1:])
    print(f"[autotune] {label}: rows changes the bits at one n_split: "
          f"{rec['rows_change_bits']}")
    return rec


def _at_tune(torch, card_line, shapes, phi, ds):
    """(a): the sweeps at each (label, B, chunk, max_len) step of
    ``shapes`` (attention on the page pool, the router gate, the combine)
    plus phase 2's phi3.5 capacity GEMM (``phi``'s C) and deepseek's gate
    and dense attention at its serve's step (``ds``)."""
    import numpy as np
    ops, ref = _ops()
    dev = torch.device("cuda")
    rng = np.random.default_rng(10)
    recs = []
    for label, b, sq, max_len in shapes:
        recs.append(_at_attention(torch, rng, f"{label} attention paged", b,
                                  sq, 32, 8, 128, 128, max_len, True, dev))
        t = b * sq
        lg = torch.from_numpy(rng.standard_normal((t, 16), np.float32)) \
            .to(dev, torch.bfloat16)
        default = {"warps": ops.topk_plan(t, 16)[1]}
        recs.append(_at_sweep(
            torch, f"{label} router gate", "topk_gate", ops.topk_gate,
            (lg, 2), _at_cands(default, [{"warps": w} for w in (1, 2, 4, 8)],
                               {"warps": 3}),
            ref.topk_gate_ref(lg, 2), (1e-6, 0.0), True))
        buf = torch.from_numpy(rng.standard_normal((t * 2, 4096),
                                                   np.float32)) \
            .to(dev, torch.bfloat16)
        slot = _i32(torch, rng.permutation(t * 2).reshape(t, 2), dev)
        w = torch.from_numpy(rng.random((t, 2), np.float32)).to(dev)
        es = 2
        default = {"rows": ops.unpermute_plan(t, 2, 4096 * es, es)[2]}
        recs.append(_at_sweep(
            torch, f"{label} combine", "unpermute_tokens",
            ops.unpermute_tokens, (buf, slot, w),
            _at_cands(default, [{"rows": 1}, {"rows": 2}], {"rows": 3}),
            ref.unpermute_tokens_ref(buf, slot, w),
            UNPERMUTE_TOL["bfloat16"], True))
    # phase 2's phi3.5 capacity GEMM (w_out: the widest H) and deepseek's
    e, c, h, d = 16, phi["C"], 6400, 4096
    x = torch.from_numpy(rng.standard_normal((e, c, h), np.float32)) \
        .to(dev, torch.bfloat16)
    wt = (0.02 * torch.randn(e, h, d, device=dev)).to(torch.bfloat16)
    ctas, units, _, _ = ops.moe_gemm_plan(e, c, h, d)
    recs.append(_at_sweep(
        torch, "phi3.5 capacity w_out", "moe_gemm", ops.moe_gemm, (x, wt),
        _at_cands({"ctas": ctas}, [{"ctas": n} for n in (
            ops.SMS // 2, ops.SMS // 4, ops.SMS - 4) if n <= units],
            {"ctas": min(ops.SMS, units) + 1}),
        ref.moe_gemm_ref(x, wt), TOL["bfloat16"], False))
    del x, wt
    t = ds["max_batch"] * ds["chunk"]
    lg = torch.from_numpy(rng.standard_normal((t, 160), np.float32)) \
        .to(dev, torch.bfloat16)
    recs.append(_at_sweep(
        torch, "deepseek router gate", "topk_gate", ops.topk_gate, (lg, 6),
        _at_cands({"warps": ops.topk_plan(t, 160)[1]},
                  [{"warps": w} for w in (1, 2, 4, 8)], {"warps": 16}),
        ref.topk_gate_ref(lg, 6), (1e-6, 0.0), True))
    recs.append(_at_attention(torch, rng, "deepseek attention dense",
                              ds["max_batch"], ds["chunk"], 128, 128, 192,
                              128, ds["max_len"], False, dev))
    gemm = recs[-3]
    print(f"[autotune] moe_gemm: ctas changes the bits: "
          f"{not gemm['bitwise_across']} (docstring: the same bits on "
          f"every call) [{card_line}]")
    return recs


def _at_dense_paged(torch, gm):
    """(b): a registered attention plan whose n_split is not flash_plan's,
    at gemma-2b's step (phase 2's case): paged == dense bit for bit, both
    within tolerance of the plain version."""
    import numpy as np
    from repro_torch.kernels import autotune as AT
    ops, ref = _ops()
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    b, sq, s = gm["max_batch"], gm["chunk"], gm["max_len"]
    nq, nkv, hd = 8, 1, 256
    rows, n0 = ops.flash_plan(b, sq, nq, nkv, hd, hd)
    n1 = n0 * 2 if n0 * 2 <= ops.FLASH_MAX_SPLIT else max(1, n0 // 2)
    q_off = ([1024 - sq, 1000, 0, 0] + [0] * b)[:b]
    q_len = ([sq, 1, 37, 0] + [0] * b)[:b]
    kv_len = [o + n for o, n in zip(q_off, q_len)]
    q, k, v, off, ql, kl = _dense_case(
        torch, rng, b=b, sq=sq, nq=nq, nkv=nkv, hd=hd, hdv=hd, skv=s,
        q_off=q_off, q_len=q_len, kv_len=kv_len, dtype=torch.bfloat16,
        dev=dev)
    nb = s // 16
    bt = torch.randperm(b * nb, device=dev).reshape(b, nb).to(torch.int32)
    kp = torch.empty(b * nb, 16, nkv, hd, dtype=torch.bfloat16, device=dev)
    vp = torch.empty_like(kp)
    kp[bt.long()] = k.reshape(b, nb, 16, nkv, hd)
    vp[bt.long()] = v.reshape(b, nb, 16, nkv, hd)
    before = ops.flash_chunk(q, k, v, off, ql, kl)
    AT.register("flash", (b, sq, nq, nkv, hd, hd), torch.bfloat16,
                {"rows": rows, "n_split": n1})
    dense = ops.flash_chunk(q, k, v, off, ql, kl)
    paged = ops.flash_chunk_paged(q, kp, vp, bt, off, ql, kl)
    want = ref.flash_chunk_ref(q, k, v, off, ql, kl)
    torch.cuda.synchronize()
    rec = {"geometry": [b, sq, nq, nkv, hd, hd], "analytic_n_split": n0,
           "registered_n_split": n1,
           "paged_equals_dense": torch.equal(dense, paged),
           "within_tol": within(torch, dense, want, *FLASH_TOL["bfloat16"]),
           "max_err": max_err(torch, dense, want),
           "bits_moved": not torch.equal(dense, before)}
    print(f"[autotune] (b) gemma-2b step {tuple(rec['geometry'])} under a "
          f"registered n_split {n1} (analytic {n0}): {json.dumps(rec)}")
    check(rec["paged_equals_dense"] and rec["within_tol"],
          "(b): paged != dense, or off the plain version, under a "
          "registered n_split")
    return rec


def _at_host(torch):
    """(e): host microseconds a call of the four wrappers that gained a
    lookup, at tiny shapes (the host's path, not the kernel, sets the
    pace): with the cache hit, and with the plan recomputed per call from
    the analytic ``*_plan`` function (the work the wrappers did before the
    cache), three times each, alternated, the least kept; and the lookup
    alone."""
    from repro_torch.kernels import autotune as AT
    ops, _ = _ops()
    dev = torch.device("cuda")
    bf = dict(dtype=torch.bfloat16, device=dev)
    i32 = lambda *s: torch.zeros(*s, dtype=torch.int32, device=dev)
    q, kp = torch.randn(1, 1, 8, 128, **bf), torch.randn(4, 16, 1, 128, **bf)
    bt, one = i32(1, 4), torch.ones(1, dtype=torch.int32, device=dev)
    lg = torch.randn(8, 16, **bf)
    x, w = torch.randn(2, 16, 64, **bf), torch.randn(2, 64, 128, **bf)
    buf, slot = torch.randn(16, 128, **bf), i32(8, 2)
    cw = torch.ones(8, 2, device=dev)
    calls = {
        "flash_chunk_paged": (lambda: ops.flash_chunk_paged(
            q, kp, kp, bt, one - 1, one, one),
            ("flash", (1, 1, 8, 1, 128, 128))),
        "topk_gate": (lambda: ops.topk_gate(lg, 2), ("topk_gate", (8, 16))),
        "moe_gemm": (lambda: ops.moe_gemm(x, w),
                     ("moe_gemm", (2, 16, 64, 128))),
        "unpermute_tokens": (lambda: ops.unpermute_tokens(buf, slot, cw),
                             ("unpermute_tokens", (8, 2, 128))),
    }
    real = AT.plan_for

    def analytic(op, shape, dtype):
        return AT.default_plan(op, shape, AT.dtype_name(dtype))
    out = {}
    for name, (fn, (op, key)) in calls.items():
        after, before = [], []
        for _ in range(3):                  # alternated; the least of each
            after.append(host_us(torch, fn))
            ops.autotune.plan_for = analytic
            try:
                before.append(host_us(torch, fn))
            finally:
                ops.autotune.plan_for = real
        after, before = min(after), min(before)
        t0 = time.perf_counter()
        for _ in range(100_000):
            real(op, key, torch.bfloat16)
        lookup = (time.perf_counter() - t0) * 10
        out[name] = {"cache_hit_us": after, "analytic_per_call_us": before,
                     "lookup_us": lookup}
    print(f"[autotune] (e) host us a call: {json.dumps(out)}")
    return out


def autotune_child():
    """(c) and (d), in a fresh process on the file (a) wrote: the resolved
    spec's provenance, a serve of phi3.5 (2 of 32 layers, full width,
    bf16, kernels on) through ``LLM.from_spec``, its launches, the plans
    it read, one decode step under ``trace_contract.sync_issues``, and the
    same serve on the same knobs with no registered plans.  Prints one
    JSON line last."""
    import numpy as np
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.analysis import trace_contract as TCt
    from repro_torch.kernels import autotune as AT
    from repro_torch.serving.api import LLM
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _cut(AT_ARCH, AT_LAYERS)
    res = at_spec().resolve(cfg, device="cuda")
    prov = {k: res.provenance[k] for k in ("chunk", "max_batch", "kv")}
    print(f"[autotune] (c) resolved from {AT.cache_path()}: {prov}")
    check(f"page {AT_PAGE} from autotune:measured" in prov["kv"]
          and "[autotune:measured]" in prov["max_batch"]
          and "[autotune:measured]" in prov["chunk"]
          and res.kv.page_size == AT_PAGE and res.max_batch <= AT_CAP,
          f"(c): the resolver did not read the registrations: {prov}")
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in AT_LENS]
    llm = _load(torch, res, cfg, "")
    eng = llm.engine
    b, sq = eng.max_batch, eng.chunk
    keys = {"flash": (b, sq, 32, 8, 128, 128), "topk_gate": (b * sq, 16),
            "unpermute_tokens": (b * sq, 2, 4096)}
    # (d): the first all-decode step's device-side body under the sync
    # debug mode
    probe = {"armed": False, "issues": None}
    impl, step = eng._unified_impl, eng.unified_step

    def unified_step(q_lens):
        q = np.asarray(q_lens)
        probe["armed"] = probe["issues"] is None and q.any() \
            and q.max() <= 1
        return step(q_lens)

    def unified_impl(*args):
        if not probe["armed"]:
            return impl(*args)
        probe["armed"] = False
        box = []
        probe["stacks"] = TCt.sync_stacks(lambda *a: box.append(impl(*a)),
                                          *args)
        probe["issues"] = [site for site, _ in probe["stacks"]]
        return box[0]
    eng.unified_step, eng._unified_impl = unified_step, unified_impl
    per_step = {"flash_chunk_paged": AT_LAYERS, "topk_gate": AT_LAYERS,
                "permute_tokens": AT_LAYERS, "unpermute_tokens": AT_LAYERS,
                "grouped_gemm": 3 * AT_LAYERS}
    # the process's first serve: its ms a step hold the warm-up and the
    # step under the sync debug mode, so they are no speed comparison
    tuned = _serve(torch, llm, prompts, AT_NEW, per_step, "",
                   f"{cfg.name} on the tuned plans (first serve, one step "
                   f"under the sync debug mode)")
    read = {op: AT.lookup(op, key, torch.bfloat16)
            for op, key in keys.items()}
    cached = {op: AT.cache_info().get(AT.cache_key(op, key, "bfloat16"))
              for op, key in keys.items()}
    print(f"[autotune] (c) plans the serve read: {json.dumps(cached)}; "
          f"registrations {json.dumps(read)}")
    check(all(read[op] is not None and read[op] == cached[op]
              for op in keys),
          f"(c): the serve did not run the tuned plans: {cached} / {read}")
    issues = probe["issues"]
    check(issues is not None, "(d): no all-decode step was probed")
    bad = TCt.unaudited(issues)
    print(f"[autotune] (d) syncs in one decode step's device-side body: "
          f"{len(issues)} {sorted(set(issues))}; not audited by R2: {bad}")
    for site, stack in probe["stacks"]:
        if site in bad:
            print(f"[autotune] (d) unaudited sync at {site}: {stack}")
    check(not bad, f"(d): synchronizing lines R2 does not flag with an "
                   f"audited disable: {bad}")
    # the same serve, the same knobs, no registered plans
    eng.unified_step, eng._unified_impl = step, impl
    os.environ[AT.ENV] = ""
    AT.clear_cache()
    plain = LLM.from_spec(llm.spec, cfg=cfg, params=eng.params,
                          device="cuda", dtype=torch.bfloat16)
    analytic = _serve(torch, plain, prompts, AT_NEW, per_step, "",
                      f"{cfg.name} on the analytic plans")
    first = [next((j for j, (a, c) in enumerate(zip(x, y)) if a != c), None)
             for x, y in zip(tuned["streams"], analytic["streams"])]
    print(f"[autotune] (c) streams tuned vs analytic plans: first differing "
          f"token per stream {first}")
    print(json.dumps({"autotune_child": {
        "provenance": prov, "max_batch": b, "chunk": sq,
        "page": res.kv.page_size, "read": read,
        "steps": tuned["steps"], "launches": tuned["launches"],
        "ms_step": tuned["wall_s"] / tuned["steps"] * 1e3,
        "syncs": issues, "first_differing_token": first}}))


def phase_autotune(torch, card_line, phi, ds, gm):
    """Phase 10: (a) tune sweeps into a temp file, (b) dense == paged under
    a registered split, (c) + (d) a fresh process serving on that file,
    (e) the wrappers' host cost.  The process's own hermetic setting (an
    empty REPRO_TORCH_AUTOTUNE_CACHE) is restored at the end."""
    import tempfile
    from repro_torch.core import resolve as R
    from repro_torch.kernels import autotune as AT
    tmp = tempfile.mkdtemp(prefix="repro_torch_autotune_")
    path = os.path.join(tmp, "autotune.json")
    os.environ[AT.ENV] = path
    AT.clear_cache()
    try:
        cfg = _cut(AT_ARCH, AT_LAYERS)
        max_len = at_spec().resolve(cfg, device="cuda").max_len
        AT.register("kv_page", R.kv_page_key(cfg, max_len), "bfloat16",
                    {"page": AT_PAGE})
        AT.register("resolver", R.resolver_key(), "host",
                    {"batch_cap": AT_CAP, "itl_slack_pct": AT_SLACK})
        served = at_spec().resolve(cfg, device="cuda")
        shapes = [("phi3.5 step", phi["max_batch"], phi["chunk"],
                   phi["max_len"])]
        if (served.max_batch, served.chunk) != (phi["max_batch"],
                                                phi["chunk"]):
            shapes.append(("(c) serve step", served.max_batch, served.chunk,
                           served.max_len))
        sweeps = _at_tune(torch, card_line, shapes, phi, ds)
        dense_paged = _at_dense_paged(torch, gm)
        host = _at_host(torch)
        free_memory(torch)
        print(f"[autotune] {path}: {len(json.load(open(path))['entries'])} "
              f"registrations; a fresh process serves on it")
        code = ("import sys; sys.path[:0] = [{!r}]; import chip_smoke; "
                "chip_smoke.autotune_child()").format(str(ROOT))
        child = subprocess.run([sys.executable, "-c", code],
                               env=dict(os.environ), cwd=str(ROOT),
                               capture_output=True, text=True, timeout=600)
        lines = child.stdout.splitlines()
        for line in lines[:-1] if child.returncode == 0 else lines:
            print(f"  | {line}")
        check(child.returncode == 0,
              f"(c): the fresh process failed: {child.stderr[-3000:]}")
        got = json.loads(child.stdout.splitlines()[-1])["autotune_child"]
    finally:
        os.environ[AT.ENV] = ""
        AT.clear_cache()
    return {"sweeps": sweeps, "dense_paged": dense_paged, "host": host,
            "child": got}


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


def _spec(kv="paged", **kw):
    from repro_torch.serving.api import ServeSpec
    return ServeSpec(**{"kernels": "auto", "kv": kv, "reduced": False,
                        "max_batch": 4, "seed": 0, **kw})


def phi_spec(dispatch="auto"):
    return _spec(prompt_len=1024, max_new_tokens=32, dispatch=dispatch)


def ds_spec(dispatch="auto"):
    return _spec(prompt_len=512, max_new_tokens=16, dispatch=dispatch)


def ds1_spec():
    return _spec(prompt_len=24, max_new_tokens=4, chunk=1)


def dense_spec(kv="paged"):
    """The dense models' serve: as phi3.5's (prompts to 1024 tokens, 32
    new), on either KV backend."""
    return _spec(kv, prompt_len=1024, max_new_tokens=32)


def dense1_spec():
    return _spec("dense", prompt_len=24, max_new_tokens=4, chunk=1)


def _shapes(spec, cfg):
    res = spec.resolve(cfg, device="cuda")
    return {"max_batch": res.max_batch, "chunk": res.chunk,
            "max_len": res.max_len,
            "pool_pages": res.kv.pool_pages if res.kv.backend == "paged"
            else None}


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


def resolve_dense_shapes():
    """The gemma-2b / minitron-8b serves' shapes (both backends resolve
    one envelope) and gemma's chunk=1 serve's: (gm, mn, gm1)."""
    gcfg, mcfg = (_cut(a, DENSE_LAYERS[a]) for a in ("gemma-2b",
                                                     "minitron-8b"))
    gm, mn = _shapes(dense_spec(), gcfg), _shapes(dense_spec(), mcfg)
    gm1 = _shapes(dense1_spec(), gcfg)
    for sh, cfg in ((gm, gcfg), (mn, mcfg)):
        d = _shapes(dense_spec("dense"), cfg)
        check({k: v for k, v in d.items() if k != "pool_pages"}
              == {k: v for k, v in sh.items() if k != "pool_pages"},
              f"{cfg.name}: kv='dense' resolved another envelope {d}")
    print(f"[shapes] gemma-2b {gm} | minitron-8b {mn} | gemma-2b chunk=1 "
          f"{gm1}")
    return gm, mn, gm1


def resolve_spec_shapes():
    """The shapes of each run of SPEC_SERVES (``spec_runs`` order), one
    envelope with and without speculation."""
    import repro_torch.configs as C
    out = []
    for arch, layers, _, kv, chunk, drafts in spec_runs():
        cfg = _cut(arch, layers) if layers else C.get(arch)
        out.append(_shapes(spec_spec("off", kv, chunk), cfg))
        for d in drafts:
            check(_shapes(spec_spec(d, kv, chunk), cfg) == out[-1],
                  f"{arch}: draft {d} resolved another envelope")
    print(f"[shapes] speculated serves {json.dumps(out)}")
    return out


def main() -> int:
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").exists():
        print("chip_smoke: no src/repro_torch beside this script; run it "
              "from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    # no file on this host may change the plans phases 2-9 check (paged
    # == dense bitwise, the dry run's predicted scratch): no autotune
    # registration is read or written but phase 10's, in a temp file
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = ""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    secs: dict = {}                  # script seconds by phase

    def timed(label, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        secs[label] = round(time.perf_counter() - t0, 1)
        return out
    card_line, name = phase_card(torch)
    timed("build", phase_build)
    phi, ds, ds1, dsh = resolve_shapes()
    gm, mn, gm1 = resolve_dense_shapes()
    sp = resolve_spec_shapes()
    fr = resolve_front_shapes()
    kres = timed("kernels", phase_kernels, torch, phi, ds, ds1, dsh,
                 dense=(gm, mn, gm1), spec=sp[0], front=fr)
    timed("host", phase_host, torch, phi, dsh)
    timed("capacity_module", phase_capacity_module, torch, phi, ds)
    timed("parity", phase_parity, torch)
    serve_phi, cap_phi = timed("serve_phi", phase_serve_phi, torch,
                               card_line)
    free_memory(torch)
    serve_ds, serve_ds1, cap_ds = timed("serve_deepseek",
                                        phase_serve_deepseek, torch,
                                        card_line)
    free_memory(torch)
    dense = timed("serve_dense", phase_serve_dense, torch, card_line)
    serves = [serve_phi, cap_phi, serve_ds, serve_ds1, cap_ds,
              dense["gemma-2b chunk=1"]]
    for arch in ("gemma-2b", "minitron-8b"):
        serves += [dense[arch]["paged"], dense[arch]["dense"]]
    checked = [phi, phi, ds, ds1, ds, gm1, gm, gm, mn, mn]
    free_memory(torch)
    # the recurrent families: no kernel lies on their path, so their
    # serves add no launches and no shapes to check
    recurrent = timed("serve_recurrent", phase_serve_recurrent, torch,
                      card_line)
    check(all(not recurrent[a]["launches"]
              for a in ("rwkv6-1.6b", "recurrentgemma-9b")),
          "a recurrent serve launched a kernel")
    free_memory(torch)
    # the frontend families: a legacy serve has no pool and no chunk, so
    # each is held to the attention geometries it launched
    frontend = timed("serve_frontend", phase_serve_frontend, torch,
                     card_line, fr)
    for arch in FRONT_SERVES:
        ran = frontend[arch]["geometries"]
        check(ran and ran <= fr[arch]["geometries"],
              f"{arch}: the serve ran attention geometries "
              f"{sorted(ran - fr[arch]['geometries'])} that phase 2 did "
              f"not check")
    free_memory(torch)
    spec = timed("spec", phase_spec, torch, card_line)
    for run, shapes in zip(spec_runs(), sp):
        checked += [shapes] * (1 + len(run[-1]))
    serves += spec["serves"]
    check(len(serves) == len(checked), "a serve's shapes went unchecked")
    for got, want in zip(serves, checked):
        want = {k: v for k, v in want.items() if k != "C"}
        got = got["shapes"]
        if got["pool_pages"] is None:          # the dense backend
            want = dict(want, pool_pages=None)
        check(got == want,
              f"serve ran {got}, kernels were checked at {want}")
    free_memory(torch)
    dist = timed("dist", phase_dist, torch, card_line, dsh)
    # the attention geometries phase 5's ranks launched on a dense cache,
    # each held to its plain version here (after the counted runs)
    geo_res = Results()
    geo_res.recs = kres
    timed("dist_geometries", check_dist_geometries, torch, geo_res,
          dist["geometries"], torch.device("cuda"))
    free_memory(torch)
    # training launches no kernel (none has a backward): no launches here
    timed("train", phase_train, torch, card_line)
    free_memory(torch)
    timed("train_mesh", phase_train_mesh, torch, card_line)
    free_memory(torch)
    entry = timed("entry", phase_entry, torch, card_line, kres)
    free_memory(torch)
    # the dry run's checks launch kernels only to compare with its
    # prediction: no launches here
    timed("dryrun", phase_dryrun, torch, card_line)
    free_memory(torch)
    timed("autotune", phase_autotune, torch, card_line, phi, ds, gm)
    launches: dict = {}
    for s in serves + [dist, entry] + [frontend[a] for a in FRONT_SERVES]:
        for k, v in s["launches"].items():
            launches[k] = launches.get(k, 0) + v
    rec = kernels_record(kres, launches)
    check(all(k["ok"] and k["launches"] > 0 for k in rec),
          "a kernel failed or never launched on a served path")
    print(f"[done] {time.perf_counter() - t_start:.1f}s by phase "
          f"{json.dumps(secs)} [{card_line}]")
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
