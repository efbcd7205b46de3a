"""The training command line, on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --reduced --steps 50 --batch 8 --seq 128 --device cpu

Without ``--reduced`` the full config trains in bfloat16 with each layer
recomputed in the backward (remat); ``--reduced`` trains the smoke config
in float32 without remat, as the reference does.  The device is CUDA unless
``--device`` names another; with no CUDA device it exits non-zero
rather than fall back to the CPU.  Training on a mesh (``--mesh``) is not
ported yet.  The weights are drawn from ``--seed`` on the device.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

import repro_torch.configs as C
from repro_torch.core.partitioner import NULL_PLAN
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.model import count_params, init_params
from repro_torch.serving.engine import resolve_device
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.train_step import make_train_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=C.ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default=None, choices=[None, "single", "multi"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mesh:
        print("training on a mesh is not ported yet", file=sys.stderr)
        return 2
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"train: {e}", file=sys.stderr)
        return 3

    cfg = C.get_reduced(args.arch) if args.reduced else C.get(args.arch)
    print(f"arch={cfg.name} params={count_params(cfg):,}")
    dtype = torch.float32 if args.reduced else torch.bfloat16
    params = init_params(torch.Generator(dev).manual_seed(args.seed), cfg,
                         dtype, dev)
    opt_state = init_opt_state(params)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps)
    step_fn = make_train_step(cfg, NULL_PLAN, opt_cfg,
                              remat=not args.reduced)

    data = SyntheticLM(cfg, DataConfig(batch=args.batch, seq_len=args.seq,
                                       seed=args.seed))
    t0 = time.time()
    for i, batch in enumerate(data.batches(args.steps)):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        params, opt_state, m = step_fn(params, opt_state, batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:5d} loss={float(m['loss']):.4f} "
                  f"ce={float(m['ce']):.4f} aux={float(m['aux']):.3f} "
                  f"lr={float(m['lr']):.2e} gnorm={float(m['grad_norm']):.2f} "
                  f"({time.time() - t0:.1f}s)")
    if args.save:
        checkpoint.save(args.save, {"params": params})
        print(f"saved -> {args.save}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
