"""Rank workers of ``tests/test_torch_dryrun.py``: each rank runs a step for
real on the CPU, then the same step as the dry run prices it on the meta
device.  Imports no JAX.

``rank_main(rank, world)`` (for ``launch.ranks.run_ranks`` on 4 gloo ranks,
a 2x2 (data, model) mesh) runs every case of ``CASES``: (arch, layout, sp,
step kind) for the reduced phi3.5, deepseek-v2 and smollm, kernels off, in
float32.  The real step takes inputs built by the port's own constructors
(``init_params(plan=)``, ``init_opt_state``, ``init_cache(plan=)``) and
counts its FLOPs with ``torch.utils.flop_counter.FlopCounterMode``; the dry
run takes ``launch.specs.input_specs`` on an unconnected mesh of the same
rank and ``launch.dryrun.measure``.  Each case returns both sides'
collective calls and bytes by (kind, axes[, "backward"]), argument bytes
and FLOPs.

The plain grouped GEMM on real rows computes only the rows its offsets
route (``offsets[-1]``); on the meta device it prices every row of its
buffer, as XLA prices the reference's ``ragged_dot`` (the EP exchange's
buffer holds ``ep * S`` rows for ~``S`` received).  The real side adds
2 x (rows - offsets[-1]) x H x D for each call, so the two counts agree
exactly where everything else does.
"""

import torch
from torch.utils.flop_counter import FlopCounterMode

import repro_torch.configs as RC
from repro_torch.configs.base import InputShape
from repro_torch.core import collectives as C
from repro_torch.kernels import ref as kref
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.models.model import init_cache, init_params
from repro_torch.training.optimizer import init_opt_state

SHAPES = {"train": InputShape("train", 16, 8, "train"),
          "prefill": InputShape("prefill", 32, 4, "prefill"),
          "decode": InputShape("decode", 32, 4, "decode")}
MICROBATCHES = 2
PREFILL_CHUNKS = 2
DECODE_LENGTHS = (3, 9, 17, 30)
ARCHS = ("phi3.5-moe-42b", "deepseek-v2-236b", "smollm-360m")
LAYOUTS = ("mixserve", "dp_ep", "pure_tp")
CASES = [(arch, layout, sp, kind) for arch in ARCHS for layout in LAYOUTS
         for sp in (True, False) for kind in SHAPES]


def real_args(cfg, shape, plan):
    """The step's arguments as a user builds them, seeded alike on every
    rank (each rank keeps its blocks)."""
    gen = torch.Generator().manual_seed(0)
    params = init_params(gen, cfg, torch.float32, "cpu", plan)
    b, s = shape.global_batch, shape.seq_len

    def tokens(n):
        return torch.randint(0, cfg.vocab_size, (b, n), generator=gen,
                             dtype=torch.int32)
    if shape.kind == "train":
        batch = {"tokens": tokens(s), "labels": tokens(s)}
        return params, init_opt_state(params, torch.bfloat16), batch
    cache = init_cache(cfg, b, s, torch.float32, "cpu", plan)
    if shape.kind == "prefill":
        return params, {"tokens": tokens(s)}, cache
    cache["length"] = torch.tensor(DECODE_LENGTHS[:b], dtype=torch.int32)
    return params, tokens(1), cache


def _real(cfg, shape, plan):
    args = real_args(cfg, shape, plan)
    step = dryrun.make_step(cfg, shape, plan, microbatches=MICROBATCHES,
                            prefill_chunks=PREFILL_CHUNKS)
    tail = []
    plain = kref.grouped_gemm_ref

    def grouped(x, w, offsets):
        tail.append(2 * (x.shape[0] - int(offsets[-1])) * x.shape[1]
                    * w.shape[2])
        return plain(x, w, offsets)
    kref.grouped_gemm_ref = grouped
    C.reset_counters()
    try:
        with FlopCounterMode(display=False) as fc:
            step(*args)
    finally:
        kref.grouped_gemm_ref = plain
    return {"calls": dict(C.counters), "bytes": dict(C.byte_counters),
            "argument_bytes": dryrun.argument_bytes(args),
            "flops": fc.get_total_flops() + sum(tail)}


def _meta(cfg, shape, plan):
    args = input_specs(cfg, shape, plan, torch.float32)
    step = dryrun.make_step(cfg, shape, plan, microbatches=MICROBATCHES,
                            prefill_chunks=PREFILL_CHUNKS)
    m = dryrun.measure(step, args, plan.mesh)
    return {"calls": dict(C.counters), "bytes": dict(C.byte_counters),
            "argument_bytes": m["memory"]["argument_bytes"],
            "flops": int(m["costs"]["flops"])}


def rank_main(rank, world):
    torch.manual_seed(0)
    live = make_host_mesh(2, 2)
    layout = Mesh(live.axis_names, (2, 2), rank)       # no process group
    out = {}
    for arch, lay, sp, kind in CASES:
        cfg, shape = RC.get_reduced(arch), SHAPES[kind]
        plans = [dryrun.plan_for(cfg, shape, mesh, lay, sp=sp,
                                 kernels="off") for mesh in (live, layout)]
        out[(arch, lay, sp, kind)] = {"real": _real(cfg, shape, plans[0]),
                                      "meta": _meta(cfg, shape, plans[1])}
    return out
