#!/usr/bin/env python3
"""Compare two trees of the port on one CUDA card, in one run.

    python3 chip_compare.py A_ROOT B_ROOT [MODE,...]

A_ROOT and B_ROOT are checkouts of the port (say, the parent commit's
``git archive`` unpacked under ``build/`` and ``.``).  Every measurement
runs in a fresh process per tree, in the order A B B A twice, with this
checkout's ``chip_smoke.py`` driving that tree's
``src/repro_torch`` (each tree builds its own kernels first, both at once):

  kernels  phase 2 of chip_smoke.py (every kernel held to its plain
           version, then timed: ``kernel_ms`` / ``device_ms`` and the
           yardstick's; the digests of the checked inputs and outputs;
           the empty kernel's launch floor, from each tree whose library
           has one) and the host split of the gather wrappers and the
           router; beside the graph-replay device time of each record
           under 50 µs, and of every capacity GEMM record, the mean
           duration per call of the CUDA kernels the call ran, from
           torch.profiler (``profiler_ms``,
           ``library_profiler_ms``); at each ragged gather's inputs, the
           same durations of the ragged kernel, of permute_tokens and of
           index_select side by side
  serve    the deepseek-v2 dropless serve of phase 4 (4 of 60 layers, its
           prompts and exact launch counts): one untimed run, then 3 timed
           runs, each on a fresh engine over the same weights, then the
           profiler window of phase 4 (device busy ms, idle share, device
           ms by kernel family)
  capacity the phi3.5-moe-42b capacity serve of phase 4 (8 of 32 layers,
           its prompts and exact launch counts, untimed), then its
           profiler window

MODE,... names the modes to run (default: all three, in this order).
Each child's whole output goes to ``build/chip_compare.log``; its
``[compare] {json}`` lines are gathered, and the last line printed is a
``{"compare": ...}`` JSON object holding every value per tree, in run
order.  Exits non-zero if a child fails or there is no CUDA device.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
SERVE_RUNS = 3
ORDER = ["A", "B", "B", "A"] * 2


def _profiler_ms(torch, fn, calls=50):
    """Mean device ms per call of the CUDA kernels ``fn`` runs (CUPTI
    kernel durations: no launch gaps, no graph nodes)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "self_device_time_total", 0.0)
             for ev in prof.key_averages()
             if ev.device_type.name == "CUDA")
    return us / calls / 1e3


def _ragged_cause(torch, cs, label, n_x, width, src, tot, stride):
    """What the ragged gather's skip tile costs on the card: CUPTI kernel
    ms per call of permute_tokens_ragged, of permute_tokens on the same
    bf16 inputs (the same rows: src is -1 outside the prefixes, so it
    differs only in reading no ``total`` and skipping no tile) and of the
    index_select yardstick."""
    from repro_torch.kernels import ops
    x = torch.randn(n_x, width, device="cuda").to(torch.bfloat16)
    got = ops.permute_tokens_ragged(x, src, tot, seg_stride=stride)
    cs.check(torch.equal(got, ops.permute_tokens(x, src)),
             f"{label}: the two gathers differ")
    library = cs._index_select_call(torch, x, src, got)
    return {"label": label,
            "ragged_ms": _profiler_ms(torch, lambda: ops.permute_tokens_ragged(
                x, src, tot, seg_stride=stride)),
            "plain_gather_ms": _profiler_ms(
                torch, lambda: ops.permute_tokens(x, src)),
            "index_select_ms": _profiler_ms(torch, library)}


def child_kernels(torch, cs):
    time_rec = cs.time_rec
    in_moe_gemm = []

    def timed(torch, rec, run, iters, plain, plain_iters, library=None):
        time_rec(torch, rec, run, iters, plain, plain_iters, library)
        if rec["device_ms"] < 0.05 or in_moe_gemm:
            rec["profiler_ms"] = _profiler_ms(torch, run)
            rec["library_profiler_ms"] = (
                None if library is None else _profiler_ms(torch, library))
    cs.time_rec = timed
    check_moe_gemm = cs.check_moe_gemm

    def moe_gemm(*a):
        in_moe_gemm.append(True)
        try:
            check_moe_gemm(*a)
        finally:
            in_moe_gemm.pop()
    cs.check_moe_gemm = moe_gemm
    add = cs.Results.add

    def added(self, name, rec, msg):
        add(self, name, rec, msg)
        if "kernel_ms" in rec:
            print("[compare] " + json.dumps({"kernel": name, "rec": rec}))
    cs.Results.add = added

    check_gather = cs._check_gather

    def gather(torch, res, label, n_x, width, src, tot, stride, dev,
               primary):
        check_gather(torch, res, label, n_x, width, src, tot, stride, dev,
                     primary)
        if tot is not None:
            print("[compare] " + json.dumps({"ragged_cause": _ragged_cause(
                torch, cs, label, n_x, width, src, tot, stride)}))
    cs._check_gather = gather
    host_split = cs.host_split

    def split(torch, label, *a):
        us = host_split(torch, label, *a)
        print("[compare] " + json.dumps({"host": {"label": label, **us}}))
        return us
    cs.host_split = split
    phi, ds, ds1, dsh = cs.resolve_shapes()
    cs.phase_kernels(torch, phi, ds, ds1, dsh)
    cs.phase_host(torch, phi, dsh)


def child_serve(torch, cs, card_line):
    from repro_torch.serving.api import LLM
    cfg = cs._cut("deepseek-v2-236b", 4)
    rng, prompts, _ = cs.ds_prompts(cfg)
    per_step = {"flash_chunk": 4, **cs.DS_MOE}
    label = f"{cfg.name} (4 of 60 layers, expanded MLA)"
    llm = cs._load(torch, cs.ds_spec(), cfg, card_line)
    params = llm.params
    cs._serve(torch, llm, prompts, 16, per_step, card_line,
              label + ", untimed")
    for _ in range(SERVE_RUNS):
        del llm
        cs.free_memory(torch)
        llm = LLM.from_spec(cs.ds_spec(), cfg=cfg, params=params,
                            device="cuda", dtype=torch.bfloat16)
        out = cs._serve(torch, llm, prompts, 16, per_step, card_line, label)
        print("[compare] " + json.dumps({"serve": {
            "ms_step": out["wall_s"] / out["steps"] * 1e3,
            "steps": out["steps"], "ttft_ms": out["ttft_ms"],
            "itl_ms": out["itl_ms"]}}))
    prof = cs.phase_profile(torch, llm, rng, label)
    print("[compare] " + json.dumps({"profile": prof}))


def child_capacity(torch, cs, card_line):
    import numpy as np
    from repro_torch.kernels import ops
    cfg = cs._cut("phi3.5-moe-42b", 8)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (612, 64, 1024, 300)]
    label = f"{cfg.name} (8 of 32 layers) capacity"
    llm = cs._load(torch, cs.phi_spec("capacity"), cfg, card_line)
    cs._serve_capacity(torch, llm, prompts, 32, {
        "flash_chunk_paged": 8, "topk_gate": 8, "permute_tokens": 8,
        "unpermute_tokens": 8, "moe_gemm": 24}, card_line, label)
    ops.reset_counters()
    prof = cs.phase_profile(torch, llm, rng, label) or {}
    prof["launches"] = dict(ops.counters)
    print("[compare] " + json.dumps({"capacity": prof}))


def child(mode, root):
    """One measurement on one tree: its ``src`` first on the path, this
    checkout's chip_smoke.py for the phases."""
    sys.path.insert(0, str(pathlib.Path(root).resolve() / "src"))
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device available", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_line, _ = cs.phase_card(torch)
    cs.phase_build()
    if mode == "kernels":
        child_kernels(torch, cs)
    elif mode == "serve":
        child_serve(torch, cs, card_line)
    elif mode == "capacity":
        child_capacity(torch, cs, card_line)
    return 0


def _run(mode, root, log):
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, str(HERE / "chip_compare.py"),
                        "--child", mode, str(root)],
                       capture_output=True, text=True, timeout=900)
    log.write(f"==== {mode} {root} rc={p.returncode} "
              f"{time.perf_counter() - t0:.1f}s\n{p.stdout}\n{p.stderr}\n")
    log.flush()
    if p.returncode != 0:
        sys.stderr.write(p.stdout[-4000:] + p.stderr[-4000:])
        raise SystemExit(f"chip_compare: {mode} on {root} failed "
                         f"(rc {p.returncode})")
    return [json.loads(line[len("[compare] "):])
            for line in p.stdout.splitlines()
            if line.startswith("[compare] ")]


KERNEL_FIELDS = ("kernel_ms", "device_ms", "profiler_ms", "library_ms",
                 "library_device_ms", "library_profiler_ms", "digest",
                 "ids_digest", "input_digest")
MODES = ("kernels", "serve", "capacity")   # run in this order


def _collect(into, rec):
    """Append each value of ``rec`` to its list under rec's label."""
    rec = dict(rec)
    fields = into.setdefault(rec.pop("label"), {})
    for f, v in rec.items():
        fields.setdefault(f, []).append(v)


def main(a_root, b_root, modes=MODES):
    import torch
    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device available", file=sys.stderr)
        return 3
    trees = {"A": pathlib.Path(a_root), "B": pathlib.Path(b_root)}
    (HERE / "build").mkdir(exist_ok=True)
    log = open(HERE / "build" / "chip_compare.log", "w")
    builds = [subprocess.Popen([sys.executable, str(HERE / "chip_compare.py"),
                                "--child", "build", str(r)],
                               stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
              for r in trees.values()]
    for p in builds:
        text = p.communicate(timeout=900)[0]
        print(text.strip())
        if p.returncode != 0:
            raise SystemExit("chip_compare: a build failed")
    res: dict = {t: {"kernels": {}, "host": {}, "ragged_cause": {},
                     "serve": [], "profile": [], "capacity": []}
                 for t in trees}
    for mode in modes:
        for t in ORDER:
            for item in _run(mode, trees[t], log):
                r = res[t]
                if "kernel" in item:
                    k = item["rec"]
                    _collect(r["kernels"], {
                        "label": f"{item['kernel']} {k['label']}",
                        **{f: k.get(f) for f in KERNEL_FIELDS}})
                elif "host" in item:
                    _collect(r["host"], item["host"])
                elif "ragged_cause" in item:
                    _collect(r["ragged_cause"], item["ragged_cause"])
                elif "serve" in item:
                    r["serve"].append(item["serve"]["ms_step"])
                elif "capacity" in item:
                    r["capacity"].append(item["capacity"])
                else:
                    r["profile"].append(item["profile"])
            print(f"[compare] {mode} {t} done")
    print(json.dumps({"compare": {"trees": {t: str(p) for t, p in
                                            trees.items()},
                                  "order": ORDER, "results": res}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(child(sys.argv[2], sys.argv[3]))
    modes = sys.argv[3].split(",") if len(sys.argv) == 4 else MODES
    if len(sys.argv) not in (3, 4) or not set(modes) <= set(MODES):
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1], sys.argv[2], modes))
