"""End-to-end serving example: batched requests through the continuous-
batching engine on an MoE model (the paper's serving scenario).

The offline stage resolves a full ``ServeSpec`` on each of the paper's two
evaluation clusters (H20 x16, Ascend 910B x32) — strategy from the
analyzer, chunk/token-budget/batch from the cost model — then the ``LLM``
facade replays a request stream against the resolution on the device's
own cluster (``h100x1``) and reports measured TTFT / ITL / throughput next
to the theoretical estimates.

The online stream is PRIORITY/DEADLINE-TIERED (every third request is
high-priority with a deadline, the rest best-effort), so the run also
exercises the robustness tier — priority preemption, deadline
enforcement, overload shedding — and prints the shed/preempt/deadline
counters next to the latency indicators.  Every request additionally
shares a SYSTEM PROMPT, so the paged KV cache serves its pages once and
re-matches them from the prefix index on later admissions — the cache
stats printed at the end show the reuse.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_moe \\
          [--arch phi3.5-moe-42b] [--device cpu]
"""

import argparse

import numpy as np

import repro_torch.configs as C
from repro_torch.core.topology import ASCEND_910B_CLUSTER, H20_CLUSTER
from repro_torch.serving.api import LLM, ServeSpec
from repro_torch.serving.engine import resolve_device
from repro_torch.serving.scheduler import tiered_workload


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3.5-moe-42b",
                    choices=[a for a in C.ARCH_IDS])
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=4.0)
    ap.add_argument("--deadline", type=float, default=5.0,
                    help="deadline (s) carried by the high-priority tier")
    ap.add_argument("--system-len", type=int, default=48,
                    help="length of the shared system prompt every request "
                         "carries (paged-KV prefix-reuse showcase)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    spec = ServeSpec(arch=args.arch, prompt_len=args.system_len + 32,
                     max_new_tokens=12, arrival_rate=args.rate)

    print("== offline stage: the spec resolved on the paper's clusters ==")
    for cl in (H20_CLUSTER, ASCEND_910B_CLUSTER):
        r = spec.resolve(cluster=cl, device=dev)
        best = r.report.best
        print(f"[{cl.name}] {r.strategy} ({r.strategy_detail})  "
              f"chunk={r.chunk} budget={r.token_budget} "
              f"b={r.max_batch}  ttft={best.ind.ttft*1e3:.0f}ms "
              f"itl={best.ind.itl*1e3:.1f}ms "
              f"thr={best.ind.throughput:.0f}tok/s")

    # online stage: serve the default-cluster resolution on the device
    # with a two-tier workload — every third request is high-priority
    # with a deadline, the rest best-effort (preemptible, sheddable)
    resolved = spec.resolve(device=dev)
    print("\n== resolved serving spec (provenance) ==")
    print(resolved.describe())
    llm = LLM.from_spec(resolved, device=dev)
    system = np.random.default_rng(7).integers(
        0, llm.cfg.vocab_size, args.system_len).astype(np.int32)
    reqs = list(tiered_workload(
        args.requests, prompt_len=32, max_new_tokens=12,
        vocab=llm.cfg.vocab_size, arrival_rate=args.rate,
        hi_every=3, hi_priority=10, hi_deadline_s=args.deadline,
        system=system))
    n_hi = sum(1 for r in reqs if r.priority > 0)
    print(f"\n== online stage: {len(reqs)} requests "
          f"({n_hi} high-priority w/ {args.deadline:.1f}s deadline, "
          f"{len(reqs) - n_hi} best-effort; shared {args.system_len}-token "
          "system prompt) ==")
    sched = llm.serve(reqs)
    m = sched.metrics()
    print(f"\n== measured on {dev.type} (reduced {llm.cfg.name}) ==")
    print(m.row())
    rb = m.robustness()
    print("robustness: " + " ".join(f"{k}={v}" for k, v in rb.items()))
    kv = llm.engine.kv
    print(f"kv cache: backend={kv.backend} peak_occupancy="
          f"{m.kv_occupancy:.0%} prefix_hits={m.n_prefix_hits} "
          f"({m.prefix_hit_tokens} tok reused) evictions={m.n_evictions} "
          f"pool_bytes={kv.kv_bytes()}")
    assert m.n_incomplete == 0, "every request must reach a terminal state"
    # the index seeds at retirement, so reuse needs a second admission wave
    if kv.backend == "paged" and len(reqs) > llm.engine.max_batch:
        assert m.n_prefix_hits > 0, "shared system prompt must re-match"
    return sched


if __name__ == "__main__":
    main()
