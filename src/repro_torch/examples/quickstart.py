"""Quickstart: the MixServe pipeline end-to-end through ONE API.

1. declare — a ``ServeSpec`` for DeepSeek-V2-236B with every knob "auto";
2. resolve — the offline stage: the automatic analyzer picks the parallel
   strategy on the paper's H20 cluster (2 nodes x 8 cards) and the cost
   model prices the serving knobs (prefill chunk, token budget, batch
   envelope); the provenance report says which field came from where;
3. serve — the ``LLM`` facade builds the engine from the resolved spec
   (a reduced same-family model on the device) and generates.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

import argparse

import numpy as np

import repro_torch.configs as C
from repro_torch.models.model import count_params
from repro_torch.serving.api import LLM, ServeSpec
from repro_torch.serving.engine import resolve_device

ARCH = "deepseek-v2-236b"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    full_cfg = C.get(ARCH)
    print(f"model: {full_cfg.name}  ({count_params(full_cfg):,} params, "
          f"{full_cfg.n_experts} experts top-{full_cfg.top_k})")

    # ---------------- declare + resolve (offline stage) ----------------
    spec = ServeSpec(arch=ARCH, cluster="h20x16", prompt_len=16,
                     max_new_tokens=8, arrival_rate=4.0,
                     objective="balanced")
    resolved = spec.resolve(device=dev)
    print("\n== offline stage: strategy ranking (theoretical) ==")
    print(resolved.report.describe(top=5))
    print("\n== resolved serving spec (provenance) ==")
    print(resolved.describe())

    # ---------------- serve (online stage, reduced config) ----------------
    llm = LLM.from_spec(resolved, device=dev)
    prompts = [np.arange(10 + rid, dtype=np.int32) % llm.cfg.vocab_size
               for rid in range(3)]
    outs = llm.generate(prompts, max_new_tokens=8)
    print(f"\n== online stage: served requests (reduced config, "
          f"{dev.type}) ==")
    for rid, (p, toks) in enumerate(zip(prompts, outs)):
        print(f"  req {rid}: prompt[{len(p)}] -> {toks}")
    return llm, outs


if __name__ == "__main__":
    main()
