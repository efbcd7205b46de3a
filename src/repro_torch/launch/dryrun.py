"""Dry run: one rank's step of every (arch x input shape x mesh) on the
meta device, without the cards.

The reference lowers and compiles each combination on 512 placeholder XLA
devices and reads the compiled program's memory and cost analysis.  The
port has no compiled program: it runs the step itself, SPMD, one process a
rank.  So the dry run runs ONE rank's step (``rank``, 0 by default) on
meta tensors, which hold shapes and no data, over a ``launch.mesh.Mesh``
built with ``connect=False`` (the production layout, no process group):

  inputs       ``launch.specs.input_specs``: the rank's parameter blocks,
               bf16 AdamW moments, the batch, the dense cache
  collectives  ``core.collectives`` returns a meta result of each
               collective's shape and counts its calls and the bytes that
               reach the rank (``counters`` / ``byte_counters``), in place
               of the reference's HLO parse (``hlo_analysis.py``)
  kernels      ``kernels.ops`` wrappers allocate their outputs and scratch
               and add their operation counts (``meta_flops``); with
               ``kernels="on"`` (the default) the program priced is the
               one the card runs, with ``"off"`` the plain bodies (the
               reference's CPU dry run lowered those: its kernels are off
               on the CPU).  Training has no kernel (none has a backward)
  costs        ``launch.meta_costs.MetaCosts``: FLOPs (flop_counter's
               formulas plus the kernels'), bytes accessed, and the peak of
               the bytes the step allocates, storage by storage

The three steps are the reference's: ``train_step`` with remat, bf16
gradient accumulation and FSDP; a prefill of the 32k prompt in
``prefill_chunks`` chunks through the dense cache (a Python loop where the
reference scans), each chunk's logits kept in the rank's block and only
the last rows' gathered whole, as the reference's sharded program keeps
them; one decode token against the cache.

A record is the reference's (``status``, ``arch``, ``shape``, ``mesh``,
``strategy``, ``n_devices``, ``microbatches``, ``prefill_chunks``,
``memory{argument_bytes, output_bytes, temp_bytes}``,
``costs{flops, bytes_accessed, collectives{bytes{<kind>..., total},
counts}}``, in its hyphenated kinds), with ``trace_s`` in place of
``lower_s`` / ``compile_s``, plus ``rank``, ``kernels``, ``peak_bytes``,
``fits`` (``peak_bytes`` within the card's ``CARD_BYTES``; the
reference's check holds a 16.5 GB TPU), ``costs.kernels`` (each
kernel's count) and ``costs.collectives.by_group`` (calls and bytes by
kind, axes and direction).

Aliasing.  The reference donates the parameters and moments (train) and
the cache (prefill, decode), so XLA aliases them into the outputs.  The
port updates them IN PLACE (``adamw_update``, the cache writes): they are
arguments, counted once in ``argument_bytes``, and never as an output or
a temporary.  ``output_bytes`` counts the new storages the step returns
(logits, metrics); ``temp_bytes`` is the peak of the storages the step
allocates while it runs (the returned ones included), rounded as the CUDA
allocator rounds them; ``peak_bytes`` = ``argument_bytes`` +
``temp_bytes``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch deepseek-v2-236b --shape decode_32k --mesh single \\
        --strategy mixserve
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Records go to ``experiments/dryrun_torch/`` (``--out``); ``--all`` runs one
subprocess a combination and keeps the records it finds.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time
import traceback

import torch

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" \
    / "dryrun_torch"

# per-arch grad-accum depth for train_4k, and the archs whose training
# runs with the Megatron-SP cut off: the reference's choices
TRAIN_MICROBATCHES = {"deepseek-v2-236b": 16}
TRAIN_SP_OFF = {"minitron-8b"}

CARD_BYTES = 80 * 10 ** 9       # one H100's 80 GB
KINDS = {"all_gather": "all-gather", "all_reduce": "all-reduce",
         "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all"}
SKIP_REASON = ("long_500k requires sub-quadratic attention "
               "(DESIGN.md §4 shape-skip policy)")


def make_step(cfg, shape, plan, *, microbatches: int = 1,
              prefill_chunks: int = 8):
    """The step function ``shape`` runs, over ``input_specs``' arguments."""
    from repro_torch.models.model import forward, gather_logits
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import train_step

    if shape.kind == "train":
        def step(params, opt_state, batch):
            return train_step(params, opt_state, batch, cfg=cfg, plan=plan,
                              opt_cfg=AdamWConfig(), remat=True,
                              microbatches=microbatches,
                              accum_dtype=torch.bfloat16)
        return step

    if shape.kind == "prefill":
        n_pc = prefill_chunks

        @torch.no_grad()
        def step(params, batch, cache):
            toks = batch["tokens"]
            if toks.shape[1] % n_pc:
                raise ValueError(f"{toks.shape[1]} tokens not divisible "
                                 f"into {n_pc} prefill chunks")
            chunk = toks.shape[1] // n_pc
            out = forward(params, cfg, plan, tokens=toks[:, :chunk],
                          embeds=batch.get("embeds"),
                          frames=batch.get("frames"), cache=cache,
                          local_logits=True)
            for i in range(1, n_pc):
                out = forward(params, cfg, plan,
                              tokens=toks[:, i * chunk:(i + 1) * chunk],
                              cache=cache, local_logits=True)
            # every rank returns the last rows' logits whole; the rest
            # stay in its block
            return gather_logits(out.logits[:, -1],
                                 plan.for_batch(toks.shape[0])), cache
        return step

    @torch.no_grad()
    def step(params, tokens, cache):
        out = forward(params, cfg, plan, tokens=tokens, cache=cache)
        return out.logits[:, 0], cache
    return step


def _storages(tree) -> dict:
    """{storage key: bytes} of the tensors in a nested tree (each storage
    once, each tensor's own elements)."""
    from torch.utils._pytree import tree_leaves
    out: dict = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            key = t.untyped_storage()._cdata
            out[key] = max(out.get(key, 0), t.numel() * t.element_size())
    return out


def argument_bytes(args) -> int:
    """The bytes of a step's argument tensors, each storage once."""
    return sum(_storages(args).values())


def collective_census(mesh) -> dict:
    """The record's ``collectives`` from ``core.collectives``' counters:
    bytes and calls by hyphenated kind of every call whose group has more
    than one rank (those reach the wire), and ``by_group``: calls and
    bytes by "<kind> <axes>[ backward]" of every call."""
    from repro_torch.core import collectives as C
    by_kind: dict = {}
    counts: dict = {}
    by_group: dict = {}
    for key, n in sorted(C.counters.items()):
        kind, axes = key[0], key[1]
        nbytes = C.byte_counters.get(key, 0)
        name = f"{kind} {','.join(axes)}" + (" backward" if len(key) > 2
                                             else "")
        by_group[name] = {"calls": n, "bytes": nbytes}
        if mesh is not None and mesh.axis_size(axes) > 1:
            k = KINDS[kind]
            by_kind[k] = by_kind.get(k, 0) + nbytes
            counts[k] = counts.get(k, 0) + n
    return {"bytes": {**by_kind, "total": sum(by_kind.values())},
            "counts": counts, "by_group": by_group}


def measure(step, args, mesh=None) -> dict:
    """Run ``step(*args)`` once under ``MetaCosts`` (its arguments on the
    meta device; the collective and kernel counters reset first) and
    return the record's ``memory``, ``peak_bytes``, ``costs`` and
    ``trace_s``, and the storages live at the peak (live / large)."""
    from repro_torch.core import collectives as C
    from repro_torch.kernels import ops
    from repro_torch.launch.meta_costs import MetaCosts
    from torch.utils._pytree import tree_leaves
    arg_tensors = [t for t in tree_leaves(args)
                   if isinstance(t, torch.Tensor)]
    C.reset_counters()
    ops.reset_counters()
    mode = MetaCosts(external=arg_tensors)
    t0 = time.perf_counter()
    with mode:
        out = step(*args)
    trace_s = time.perf_counter() - t0
    args_b = argument_bytes(args)
    arg_keys = set(_storages(args))
    out_b = sum(v for k, v in _storages(out).items() if k not in arg_keys)
    kernels = {k: int(v) for k, v in sorted(ops.meta_flops.items())}
    return {
        "trace_s": round(trace_s, 2),
        "memory": {"argument_bytes": args_b, "output_bytes": out_b,
                   "temp_bytes": mode.peak},
        "peak_bytes": args_b + mode.peak,
        "storages_at_peak": {"live": mode.live_storages_at_peak,
                             "large": mode.large_storages_at_peak},
        "costs": {
            "flops": float(mode.flops + sum(kernels.values())),
            "bytes_accessed": float(mode.bytes_accessed
                                    + sum(ops.meta_bytes.values())),
            "kernels": kernels,
            "collectives": collective_census(mesh),
        },
    }


def plan_for(cfg, shape, mesh, strategy: str, *, sp: bool = True,
             fsdp: bool = True, kernels: str = "on"):
    """The plan the dry run prices: the named layout (or ``auto``: the
    analyzer's choice, ``launch.auto.auto_plan``) on ``mesh``, FSDP for
    training, the kernel policy ``kernels`` for serving (training runs
    none: no kernel has a backward)."""
    from repro_torch.core.partitioner import make_plan
    from repro_torch.kernels.policy import KernelPolicy
    train = shape.kind == "train"
    if strategy == "auto":
        from repro_torch.launch.auto import auto_plan
        plan, _rep = auto_plan(cfg, mesh, shape, fsdp=fsdp and train, sp=sp)
    else:
        plan = make_plan(strategy, mesh, fsdp=fsdp and train, sp=sp)
    policy = KernelPolicy.off() if train else KernelPolicy.parse(kernels)
    return dataclasses.replace(plan, kernels=policy)


def run_one(arch: str, shape_name: str, mesh_kind: str, strategy: str,
            out_dir=None, *, microbatches: int = 0, prefill_chunks: int = 8,
            sp: bool = True, fsdp: bool = True, rank: int = 0,
            kernels: str = "on") -> dict:
    """The record of one combination (module docstring); ``out_dir`` is
    the caller's to write to."""
    import repro_torch.configs as RC
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.launch.mesh import production_layout
    from repro_torch.launch.specs import input_specs

    del out_dir
    cfg = RC.get(arch)
    shape = INPUT_SHAPES[shape_name]
    if not RC.shape_supported(cfg, shape):
        return {"status": "skipped", "arch": arch, "shape": shape_name,
                "mesh": mesh_kind, "strategy": strategy,
                "reason": SKIP_REASON}
    mesh = production_layout(multi_pod=mesh_kind == "multi", rank=rank)
    if shape.kind == "train" and arch in TRAIN_SP_OFF:
        sp = False
    plan = plan_for(cfg, shape, mesh, strategy, sp=sp, fsdp=fsdp,
                    kernels=kernels)
    train = shape.kind == "train"
    if train:
        # grad-accum cannot split below one batch row per DP rank
        microbatches = min(microbatches or TRAIN_MICROBATCHES.get(arch, 8),
                           shape.global_batch // plan.dp)
    args = input_specs(cfg, shape, plan, device="meta")
    step = make_step(cfg, shape, plan, microbatches=max(microbatches, 1),
                     prefill_chunks=prefill_chunks)
    m = measure(step, args, mesh)
    return {
        "status": "ok", "arch": arch, "shape": shape_name,
        "mesh": mesh_kind, "strategy": strategy, "n_devices": mesh.size,
        "rank": rank, "kernels": plan.kernels.describe(),
        "microbatches": microbatches if train else 1,
        "prefill_chunks": prefill_chunks if shape.kind == "prefill" else 1,
        "trace_s": m["trace_s"], "memory": m["memory"],
        "peak_bytes": m["peak_bytes"],
        "fits": m["peak_bytes"] <= CARD_BYTES, "card_bytes": CARD_BYTES,
        "costs": m["costs"],
    }


def _name(arch, shape, mesh, strategy) -> str:
    return f"{arch}_{shape}_{mesh}_{strategy}"


def _cached(path: pathlib.Path) -> bool:
    if not path.exists():
        return False
    return json.loads(path.read_text()).get("status") in ("ok", "skipped")


def run_all(args) -> int:
    """One subprocess a combination, one for every two cores at once (a
    dry run is one Python thread); records already written (ok or
    skipped) are kept."""
    import repro_torch.configs as RC
    from repro_torch.configs.base import INPUT_SHAPES
    out = pathlib.Path(args.out)
    combos = [(a, s, m) for a in RC.ARCH_IDS for s in INPUT_SHAPES
              for m in ("single", "multi")]
    todo, failures = [], []
    for a, s, m in combos:
        name = _name(a, s, m, args.strategy)
        if _cached(out / f"{name}.json"):
            print(f"[cached] {name}")
        else:
            todo.append((a, s, m, name))
    # the long cells first (training, then prefill), so the last to end
    # is short
    todo.sort(key=lambda c: ("train" not in c[1], "prefill" not in c[1]))
    running: list = []

    def reap() -> None:
        """Wait for one subprocess to end (or outlive ``--timeout``)."""
        while True:
            for item in running:
                proc, name, t0, err = item
                if proc.poll() is None:
                    if time.time() - t0 < args.timeout:
                        continue
                    proc.kill()
                    proc.wait()
                running.remove(item)
                err.close()
                ok = proc.returncode == 0
                print(f"[{'ok' if ok else 'FAIL'}] {name}  "
                      f"({time.time() - t0:.0f}s)", flush=True)
                if ok:
                    os.remove(err.name)
                else:
                    failures.append(name)
                    print(pathlib.Path(err.name).read_text()[-800:])
                return
            time.sleep(0.2)

    for a, s, m, name in todo:
        while len(running) >= max(1, (os.cpu_count() or 2) // 2):
            reap()
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               a, "--shape", s, "--mesh", m, "--strategy", args.strategy,
               "--kernels", args.kernels, "--out", str(out)]
        err = open(out / f"{name}.err", "w")
        running.append((subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                         stderr=err),
                        name, time.time(), err))
    while running:
        reap()
    print(f"\n{len(combos) - len(failures)}/{len(combos)} combos passed")
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--strategy", default="mixserve",
                    choices=["mixserve", "dp_ep", "pure_tp", "auto"])
    ap.add_argument("--kernels", default="on", choices=["on", "off"],
                    help="price the hand-written kernels (the program the "
                         "card runs) or the plain bodies")
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape x both meshes), one "
                         "subprocess each")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    ap.add_argument("--timeout", type=int, default=3600)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.all:
        return run_all(args)
    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required without --all")
    rec = run_one(args.arch, args.shape, args.mesh, args.strategy,
                  args.out, kernels=args.kernels)
    path = pathlib.Path(args.out) / (_name(args.arch, args.shape, args.mesh,
                                           args.strategy) + ".json")
    path.write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec, indent=1))
    return 0 if rec["status"] in ("ok", "skipped") else 1


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
