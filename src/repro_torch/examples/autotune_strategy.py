"""The automatic resolver as a standalone tool (paper §III-A/B).

For every assigned architecture, resolve a full ``ServeSpec`` on a chosen
cluster: the analyzer ranks parallel strategies (top-3 printed with their
theoretical TTFT/ITL/throughput) and the cost model prices every serving
knob — the offline stage MixServe runs before loading any weights, with
the provenance report showing which value came from where.  ``--device``
is where an engine would run (it decides ``kernels="auto"``); nothing is
served.

Run:  PYTHONPATH=src python -m repro_torch.examples.autotune_strategy \\
          [--cluster h20x16] [--objective throughput] [--device cpu]
"""

import argparse

import repro_torch.configs as C
from repro_torch.core.topology import CLUSTERS
from repro_torch.serving.api import ServeSpec
from repro_torch.serving.engine import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cluster", default="h20x16", choices=list(CLUSTERS))
    ap.add_argument("--objective", default="balanced",
                    choices=["ttft", "itl", "throughput", "balanced"])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--l-in", type=int, default=1024)
    ap.add_argument("--l-out", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    out = {}
    for arch in C.ARCH_IDS:
        spec = ServeSpec(arch=arch, cluster=args.cluster,
                         max_batch=args.batch, prompt_len=args.l_in,
                         max_new_tokens=args.l_out,
                         objective=args.objective)
        resolved = spec.resolve(device=dev)
        print(f"\n=== {arch} on {resolved.cluster} "
              f"(objective={args.objective}) ===")
        print(resolved.report.describe(top=3))
        print(resolved.describe())
        out[arch] = resolved
    return out


if __name__ == "__main__":
    main()
