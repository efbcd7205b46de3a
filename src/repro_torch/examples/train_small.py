"""Train a ~100M-parameter MoE for a few hundred steps.

A scaled phi3.5-family model (8 experts top-2, ~100M params) trains on the
synthetic Markov/Zipf pipeline; loss is expected to drop well below the
uniform floor log(V).  A run of at least ``CHECKED_STEPS`` steps checks
that the loss fell by more than 0.5 nats.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_small \\
          [--steps 300] [--device cpu]
"""

import argparse
import math
import time

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.model import count_params, init_params
from repro_torch.serving.engine import resolve_device
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.train_step import make_train_step

CFG_100M = ModelConfig(
    name="phi-mini-100m", family="moe", n_layers=6, d_model=512,
    n_heads=8, n_kv_heads=4, d_ff=1024, vocab_size=8192,
    n_experts=8, top_k=2, d_expert=1024, activation="swiglu",
    source="scaled phi3.5-moe family (hf:microsoft/Phi-3.5-MoE-instruct)")

# shorter runs end inside or just past the 20-step warm-up: not checked
CHECKED_STEPS = 100


def main(argv=None):
    """Returns the per-step metrics as floats."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = CFG_100M
    print(f"{cfg.name}: {count_params(cfg):,} params "
          f"({cfg.n_experts} experts top-{cfg.top_k})")
    params = init_params(torch.Generator(dev).manual_seed(0), cfg,
                         torch.float32, dev)
    opt = init_opt_state(params)
    step = make_train_step(
        cfg, opt_cfg=AdamWConfig(lr=args.lr, warmup_steps=20,
                                 total_steps=args.steps))
    data = SyntheticLM(cfg, DataConfig(batch=args.batch, seq_len=args.seq))
    t0, history = time.time(), []
    for i, b in enumerate(data.batches(args.steps)):
        b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        params, opt, m = step(params, opt, b)
        history.append({k: float(v) for k, v in m.items()})
        loss = history[-1]["loss"]
        if i % 25 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={loss:.4f} "
                  f"aux={history[-1]['aux']:.3f} ({time.time()-t0:.0f}s)")
    first = history[0]["loss"]
    print(f"\nloss {first:.3f} -> {loss:.3f} "
          f"(uniform floor would be {math.log(cfg.vocab_size):.2f})")
    if args.steps >= CHECKED_STEPS:
        assert loss < first - 0.5, "expected clear loss descent"
    return history


if __name__ == "__main__":
    main()
