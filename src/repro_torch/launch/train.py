"""The training command line, on one device or on the production mesh.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --reduced --steps 50 --batch 8 --seq 128 --device cpu

  torchrun --nproc-per-node 16 --nnodes 16 ... -m repro_torch.launch.train \\
      --arch phi3.5-moe-42b --mesh single

Without ``--reduced`` the full config trains in bfloat16 with each layer
recomputed in the backward (remat); ``--reduced`` trains the smoke config
in float32 without remat, as the reference does.  The device is CUDA unless
``--device`` names another; with no CUDA device it exits non-zero
rather than fall back to the CPU.  The weights are drawn from ``--seed`` on
the device.

``--mesh single|multi`` trains under ``make_plan("mixserve", mesh)`` on the
reference's production mesh (``launch.mesh.make_production_mesh``: 256 or
512 ranks) over the process group ``torchrun`` starts; with another world
size it exits non-zero and names the one it needs.  Every rank draws the
same weights and keeps its block, reads the same batches, and trains; rank
0 alone prints and writes the checkpoint.  ``train_loop`` is the loop
itself, on any plan (a host mesh too).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

import repro_torch.configs as C
from repro_torch.core.partitioner import NULL_PLAN, ShardingPlan, make_plan
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.model import count_params, init_params
from repro_torch.serving.engine import resolve_device
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.train_step import (check_microbatches,
                                             make_train_step)


def train_loop(cfg, plan: ShardingPlan, device, *, steps: int, batch: int,
               seq: int, lr: float = 3e-4, seed: int = 0,
               dtype=torch.float32, remat: bool = False,
               save: Optional[str] = None, log_every: int = 10,
               log: Optional[Callable] = print):
    """Train ``cfg`` for ``steps`` on ``plan`` (a mesh plan: every rank
    calls this) from weights drawn from ``seed`` on ``device``, the
    synthetic batches of ``seed``, the weights in ``dtype``.  Returns
    (params, opt_state, history): the rank's blocks, and per step its
    metrics as floats and its wall ``ms``.  Rank 0 alone logs and writes
    ``save``; a batch the batch ranks do not divide raises before any
    weight is drawn."""
    check_microbatches(batch, 1, plan)
    lead = not plan.enabled or plan.mesh.rank == 0
    say = log if (lead and log is not None) else (lambda *a, **k: None)
    params = init_params(torch.Generator(device).manual_seed(seed), cfg,
                         dtype, device, plan=plan)
    opt_state = init_opt_state(params)
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1),
                          total_steps=steps)
    step_fn = make_train_step(cfg, plan, opt_cfg, remat=remat)
    data = SyntheticLM(cfg, DataConfig(batch=batch, seq_len=seq, seed=seed))
    history = []
    t0 = time.time()
    for i, b in enumerate(data.batches(steps)):
        b = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        t_step = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, b)
        m = {k: float(v) for k, v in m.items()}     # waits for the step
        m["ms"] = 1e3 * (time.perf_counter() - t_step)
        history.append(m)
        if i % log_every == 0 or i == steps - 1:
            say(f"step {i:5d} loss={m['loss']:.4f} ce={m['ce']:.4f} "
                f"aux={m['aux']:.3f} lr={m['lr']:.2e} "
                f"gnorm={m['grad_norm']:.2f} ({time.time() - t0:.1f}s)")
    if save:
        checkpoint.save(save, {"params": params}, plan=plan, cfg=cfg)
        say(f"saved -> {save}")
    return params, opt_state, history


def _mesh_plan(kind: str, device: str):
    """``make_plan("mixserve", mesh)`` on the production mesh, joining the
    process group ``torchrun`` describes (``RANK`` / ``WORLD_SIZE``, and
    the host's ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``, in the environment)
    when none is up."""
    from repro_torch.launch.mesh import (init_ranks, make_production_mesh,
                                         torchrun_ranks)
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        init_ranks(init_method="env://", device=device,
                   **torchrun_ranks(os.environ))
    mesh = make_production_mesh(multi_pod=kind == "multi")
    return make_plan("mixserve", mesh)


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
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"train: {e}", file=sys.stderr)
        return 3
    plan = NULL_PLAN
    if args.mesh:
        try:
            plan = _mesh_plan(args.mesh, args.device)
        except ValueError as e:
            print(f"train: {e}", file=sys.stderr)
            return 2
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
    try:
        check_microbatches(args.batch, 1, plan)
    except ValueError as e:
        print(f"train: {e}", file=sys.stderr)
        return 2

    cfg = C.get_reduced(args.arch) if args.reduced else C.get(args.arch)
    if not plan.enabled or plan.mesh.rank == 0:
        print(f"arch={cfg.name} params={count_params(cfg):,}")
    train_loop(cfg, plan, dev, steps=args.steps, batch=args.batch,
               seq=args.seq, lr=args.lr, seed=args.seed,
               dtype=torch.float32 if args.reduced else torch.bfloat16,
               remat=not args.reduced, save=args.save,
               log_every=args.log_every)
    return 0


if __name__ == "__main__":
    sys.exit(main())
