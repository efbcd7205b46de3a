"""The serving command line: the MixServe online stage end-to-end.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3.5-moe-42b \\
      --requests 16 --rate 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      --requests 4 --max-new 4 --device cpu

One door: the CLI builds a declarative ``ServeSpec`` (every knob defaults
to ``auto``), ``resolve`` runs the offline stage — the automatic analyzer
+ cost model pick the strategy, kernel policy, dispatch mode, prefill
chunk, token budget and slot envelope — and the ``LLM`` facade runs the
online engine with exactly that resolved configuration (the provenance
report printed below says which field came from where).  Explicit flags
(``--chunk 8``, ``--dispatch capacity``, ...) beat ``auto`` field by
field.

The engine is the unified token-budget mixed prefill/decode step; families
the unified step cannot serve (ssm/hybrid/frontend) fall back to the
internal blocking-prefill path automatically.

The engine runs on CUDA unless ``--device`` names another; with no CUDA
device the command exits non-zero rather than fall back to the CPU.  The
weights are random, drawn from ``--seed`` on the device, in float32.
"""

from __future__ import annotations

import argparse
import sys

import repro_torch.configs as C
from repro_torch.core.topology import CLUSTERS
from repro_torch.serving.api import AUTO, LLM, ServeSpec, SpeculationConfig
from repro_torch.serving.engine import resolve_device
from repro_torch.serving.scheduler import Scheduler, synthetic_workload


def _auto_int(v: str):
    return v if v == AUTO else int(v)


def _ep_overlap_arg(v: str):
    return v if v in (AUTO, "off") else int(v)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=C.ARCH_IDS)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the reduced config on this device (the "
                         "offline analyzer always prices the FULL config); "
                         "--no-reduced serves the full one")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--rate", type=float, default=4.0,
                    help="Poisson arrivals a second; 0 makes every request "
                         "due at once")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=_auto_int, default=AUTO,
                    help="engine slots; auto = largest power-of-two batch "
                         "the Eq. 8 memory constraint admits")
    ap.add_argument("--max-len", type=_auto_int, default=AUTO,
                    help="cache rows per slot; auto = the workload "
                         "envelope (prompt + new tokens, rounded up)")
    ap.add_argument("--cluster", default=AUTO,
                    choices=[AUTO] + list(CLUSTERS),
                    help="offline-stage target cluster (auto -> h100x1, "
                         "one H100)")
    ap.add_argument("--objective", default="balanced",
                    choices=("ttft", "itl", "throughput", "balanced"))
    ap.add_argument("--strategy", default=AUTO,
                    choices=(AUTO, "mixserve", "dp_ep", "pure_ep",
                             "pure_tp"),
                    help="parallel layout; auto = the analyzer's pick")
    ap.add_argument("--kernels", default=AUTO, choices=(AUTO, "on", "off"),
                    help="hand-written CUDA kernel policy: auto = on "
                         "exactly when --device is CUDA, off elsewhere; on "
                         "forces the kernelized path (on the CPU every "
                         "wrapper runs its plain PyTorch version)")
    ap.add_argument("--dispatch", default=AUTO,
                    choices=(AUTO, "dropless", "capacity"),
                    help="MoE dispatch buffers: auto (-> dropless, the "
                         "count-independent ragged inference dispatch) or "
                         "capacity (fixed (E, C, h) buffers; training's "
                         "scheme, kept for A/B comparison)")
    ap.add_argument("--chunk", type=_auto_int, default=AUTO,
                    help="prefill chunk size of the unified mixed step "
                         "(static width of the (B, chunk) token buffer); "
                         "auto = the largest chunk the cost model prices "
                         "under the ITL-inflation bound")
    ap.add_argument("--token-budget", type=_auto_int, default=AUTO,
                    help="total tokens per unified iteration across all "
                         "slots; auto = max_batch decode tokens + one "
                         "prefill chunk (decode is scheduled first)")
    ap.add_argument("--kv", default=AUTO, choices=(AUTO, "dense", "paged"),
                    help="KV cache backend: auto = paged with shared-"
                         "prefix reuse for unified-step families (pool "
                         "sized from the Eq. 8 envelope), dense for "
                         "legacy-path families")
    ap.add_argument("--ep-overlap", type=_ep_overlap_arg, default=AUTO,
                    metavar="auto|off|C",
                    help="micro-chunked EP-exchange overlap: auto = the "
                         "cost model picks the chunk count (count-bounded "
                         "A2A buffers on), off = monolithic worst-case "
                         "exchange, an int pins the chunk count")
    ap.add_argument("--speculation", type=_ep_overlap_arg, default="off",
                    metavar="auto|off|K",
                    help="speculative decoding on the unified step: off "
                         "(default), auto = the cost model prices draft "
                         "lengths against the verify step and picks k (or "
                         "off), an int pins k draft tokens per slot-step "
                         "(greedy sampling only; bit-exact either way)")
    ap.add_argument("--draft", default="ngram",
                    help="draft source for an explicit --speculation K: "
                         "ngram (zero-cost suffix matching), self (the "
                         "serving model drafting for itself), or a reduced "
                         "config name; auto always picks ngram")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs: cuda (default; the "
                         "command fails without a card) or cpu (the plain "
                         "PyTorch path)")
    return ap.parse_args(argv)


def build_spec(args: argparse.Namespace) -> ServeSpec:
    """CLI flags -> the declarative spec (auto flags stay auto)."""
    speculation = args.speculation
    if isinstance(speculation, int):   # explicit k honors --draft
        speculation = SpeculationConfig(k=speculation, draft=args.draft)
    return ServeSpec(
        arch=args.arch, reduced=args.reduced, cluster=args.cluster,
        strategy=args.strategy, kernels=args.kernels,
        dispatch=args.dispatch, chunk=args.chunk,
        token_budget=args.token_budget, kv=args.kv,
        max_batch=args.max_batch, max_len=args.max_len,
        prompt_len=args.prompt_len, max_new_tokens=args.max_new,
        arrival_rate=args.rate, objective=args.objective,
        ep_overlap=args.ep_overlap, speculation=speculation,
        seed=args.seed)


def main(argv=None) -> Scheduler:
    """Run the CLI; returns the ``Scheduler`` it served with (its
    ``engine`` holds the counters).  Exits 3 when the device is CUDA and
    there is no card."""
    args = parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError:
        print(f"serve: no CUDA device is available for --device "
              f"{args.device}; pass --device cpu to run the plain PyTorch "
              "path on the CPU", file=sys.stderr)
        sys.exit(3)
    spec = build_spec(args)

    # ---- offline stage: automatic analyzer + knob resolution on the
    # FULL config (model + cluster in, serving configuration out) ----
    resolved = spec.resolve(C.get(args.arch), device=dev)
    print("== offline analyzer (theoretical, full config on "
          f"{resolved.cluster}) ==")
    print(resolved.report.describe(top=3))
    print("\n== resolved serving spec (provenance) ==")
    print(resolved.describe())

    # ---- online stage: the LLM facade runs EXACTLY the resolved spec ----
    llm = LLM.from_spec(resolved, device=dev)
    if llm.engine.legacy:
        print(f"[engine] {llm.cfg.name}: family {llm.cfg.family!r} falls "
              "back to the internal blocking-prefill path")
    sched = llm.serve(synthetic_workload(
        args.requests, prompt_len=args.prompt_len,
        max_new_tokens=args.max_new, vocab=llm.cfg.vocab_size,
        arrival_rate=args.rate, seed=args.seed))
    print("\n== online measured "
          f"({'reduced' if args.reduced else 'full'} config on "
          f"{dev.type}) ==")
    print(sched.metrics().row())
    return sched


if __name__ == "__main__":
    main()
