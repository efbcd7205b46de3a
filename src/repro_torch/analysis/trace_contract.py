"""Trace contract: the collectives the cost model prices are the ones the
port issues, and the step makes no host sync it has not declared.

The JAX package traces its lowered program and makes three checks; the
port runs eagerly and issues every collective itself
(``core/collectives.py`` counts each call), so its checks run the code:

(a) **Collective census.**  ``check_moe_census`` runs one ``moe_block`` on
    every rank of a mesh (``launch.ranks.run_ranks``), counts the
    collectives each rank issued by (kind, axes), and compares them with
    ``cost_model.comm_census`` resolved onto the plan's mesh axes
    (``expected_census``): the firm entries always, the conditional ones
    (the count-bounded exchange's worst-case rerun) for each chunk that
    overflowed (``models.moe.exchange_counts``).  One rule is the port's
    own: its block gathers its output back over the batch axes (one
    all-gather), which the JAX package's GSPMD does outside the traced
    ``shard_map`` body.  An extra all-reduce in the block, or a census
    entry the block stopped issuing, fails.
(b) **Retrace detector.**  No counterpart: eager PyTorch compiles nothing,
    so there is no retrace to detect (nor a ``compile_watch``).
(c) **Purity.**  ``sync_issues(fn, *args)`` runs ``fn`` on the card under
    ``torch.cuda.set_sync_debug_mode("warn")`` and returns the file:line of
    every call that synchronized the host with the card (the innermost
    frame outside torch).  ``unaudited(issues)`` keeps those that are not
    a line lint rule R2 flags under an audited ``disable=R2``.  It refuses
    a CPU device: on the CPU nothing synchronizes, so it would pass
    vacuously.

CLI (the JAX package's tiny sweep: an 8-expert MoE under mixserve,
pure_tp and dp_ep)::

    python -m repro_torch.analysis.trace_contract              # on the card
    python -m repro_torch.analysis.trace_contract --device cpu --mesh 2x2 \\
        --strategies mixserve --chunks 2 --cap-rows 4 --json report.json

Ranks run on the card by default (gloo on one card, NCCL with one card a
rank); ``--device cpu`` runs them over gloo on the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import tempfile
import traceback
import warnings
from collections import Counter
from pathlib import Path
from typing import Optional

# ---------------------------------------------------------------------------
# Expected counters from the cost model census
# ---------------------------------------------------------------------------


def strategy_for_plan(plan):
    """The cost-model ``Strategy`` a ShardingPlan realizes (inverse of
    ``partitioner.make_plan``'s canonical layouts, pod-less meshes)."""
    from repro_torch.core.cost_model import Strategy
    tp = plan.axis_size(plan.tp_axes)
    ep = plan.axis_size(plan.ep_axes)
    n = plan.mesh.size if plan.mesh is not None else 1
    token_sliced = bool(set(plan.tp_axes) & set(plan.ep_axes))
    if ep <= 1:                                   # pure_tp
        return Strategy(attn_tp=tp, attn_dp=max(1, n // tp),
                        moe_tp=tp, moe_ep=1, comm_algo=plan.comm_algo)
    if token_sliced:                              # dp_ep (pure EP)
        return Strategy(attn_tp=tp, attn_dp=max(1, n // tp),
                        moe_tp=1, moe_ep=ep, comm_algo="unfused")
    return Strategy(attn_tp=tp, attn_dp=max(1, n // tp),   # mixserve
                    moe_tp=tp, moe_ep=ep, comm_algo=plan.comm_algo)


def tokens_local_for(plan, batch: int, seq: int) -> int:
    """Per-rank token count the MoE body sees: pins the census's
    micro-chunk count C and cap decision to the issued program's."""
    r = plan.rules.get("batch") or ()
    r = r if isinstance(r, tuple) else (r,)
    b_local = max(1, batch // max(1, plan.axis_size(tuple(a for a in r if a))))
    t = b_local * seq
    if set(plan.tp_axes) & set(plan.ep_axes):     # token-sliced body
        tp = plan.axis_size(plan.tp_axes)
        t = (t + (-t) % tp) // tp                 # pad-to-tp then slice
    return max(1, t)


def expected_census(census, plan) -> tuple[Counter, Counter]:
    """Resolve the census's logical axes onto the plan's mesh axis names;
    returns (firm, conditional) Counters keyed (kind, frozenset(axes))."""
    groups = {
        "tp": frozenset(plan.tp_axes),
        "ep": frozenset(plan.ep_axes),
        "guard": frozenset(plan.tp_axes) | frozenset(plan.ep_axes),
        "mesh": frozenset(plan.mesh.axis_names) if plan.mesh is not None
        else frozenset(),
    }
    firm: Counter = Counter()
    cond: Counter = Counter()
    for e in census.entries:
        if not e.traceable:
            continue
        key = (e.kind, groups[e.axis])
        (cond if e.conditional else firm)[key] += e.count
    return firm, cond


# ---------------------------------------------------------------------------
# Check (a): the MoE block's collective census
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ContractReport:
    name: str
    ok: bool
    expected: dict
    actual: dict
    mismatches: list

    def as_json(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        head = f"[{'OK' if self.ok else 'FAIL'}] {self.name}"
        if self.ok:
            return head
        return head + "".join(f"\n  {m}" for m in self.mismatches)


def _fmt(key) -> str:
    kind, axes = key
    return f"{kind}({','.join(sorted(axes))})"


def _diff(name: str, expected: Counter, actual: Counter) -> list:
    out = []
    for k in sorted(set(expected) | set(actual), key=_fmt):
        e, a = expected.get(k, 0), actual.get(k, 0)
        if e != a:
            out.append(f"{name}: {_fmt(k)} expected {e}, issued {a}")
    return out


def _to_d(c: Counter) -> dict:
    return {_fmt(k): v for k, v in sorted(c.items(), key=lambda i:
                                          _fmt(i[0]))}


def _census_rank(rank, world, plan, cfg, batch, seq, seed, block, device):
    """One rank: the plan on a connected mesh of the same layout, the
    block's weights drawn whole from ``seed`` and cut to this rank's
    block, one ``block(p, x, cfg, plan)`` under no_grad.  Returns the
    collectives it issued and the exchange's chunk / overflow counts."""
    import torch

    from repro_torch.core import collectives as C
    from repro_torch.launch.mesh import Mesh, rank_device
    from repro_torch.models import moe as M
    from repro_torch.models.param import init_tree

    mesh = Mesh(plan.mesh.axis_names, tuple(plan.mesh.shape.values()), rank,
                connect=True)
    plan = dataclasses.replace(plan, mesh=mesh)
    dev = rank_device(rank, device)
    gen = torch.Generator().manual_seed(seed)
    spec = M.moe_spec(cfg)
    whole = init_tree(gen, spec, torch.float32, "cpu")
    p = {k: plan.shard(v, spec[k].axes).contiguous().to(dev)
         for k, v in whole.items()}
    x = torch.randn(batch, seq, cfg.d_model, generator=gen).to(dev)
    block = block or M.moe_block
    C.reset_counters()
    M.exchange_counts.clear()
    with torch.no_grad():
        block(p, x, cfg, plan)
    return ({k: v for k, v in C.counters.items() if len(k) == 2},
            dict(M.exchange_counts))


def check_moe_census(cfg, plan, *, batch: int = 4, seq: int = 8,
                     name: str = "moe_census", device: str = "cuda",
                     seed: int = 0, block=None,
                     workdir: Optional[str] = None) -> ContractReport:
    """Check (a): run ``moe_block`` (or ``block``, a module-level function
    of the same signature) once on every rank of ``plan``'s mesh and
    compare each rank's collectives with ``cost_model.comm_census``.

    ``plan`` is laid out on a ``launch.mesh.Mesh`` (``connect=False`` will
    do: each rank connects its own); ``device`` is where the ranks run
    ("cuda": gloo on one card, NCCL on several; "cpu": gloo)."""
    from repro_torch.core.cost_model import Workload, comm_census
    from repro_torch.launch.ranks import run_ranks

    census = comm_census(cfg, strategy_for_plan(plan),
                         Workload(batch=batch, seq_len=seq),
                         ep_overlap=plan.ep_overlap,
                         tokens_local=tokens_local_for(plan, batch, seq))
    exp_firm, exp_cond = expected_census(census, plan)
    exp_firm[("all_gather", frozenset(plan.dp_axes))] += 1    # the boundary
    with tempfile.TemporaryDirectory() as tmp:
        ranks = run_ranks(_census_rank, plan.mesh.size,
                          (dataclasses.replace(plan, mesh=_layout(plan)),
                           cfg, batch, seq, seed, block, device),
                          workdir=workdir or tmp, device=device, threads=1)
    mismatches, actual = [], {}
    for r, (issued, ex) in enumerate(ranks):
        got = Counter({(kind, frozenset(axes)): n
                       for (kind, axes), n in issued.items()})
        chunks, over = ex.get("chunks", 0), ex.get("overflow", 0)
        want = Counter(exp_firm)
        for k, v in exp_cond.items():      # the reruns that happened
            want[k] += v * over // max(chunks, 1)
        want = +want
        mismatches += [f"rank {r} {m}" for m in _diff("issued", want, got)]
        actual[f"rank {r}"] = {**_to_d(got), "chunks": chunks,
                               "overflow": over}
    return ContractReport(
        name=name, ok=not mismatches,
        expected={"firm": _to_d(exp_firm), "conditional": _to_d(exp_cond)},
        actual=actual, mismatches=mismatches)


def _layout(plan):
    """``plan``'s mesh as a layout with no process group (picklable)."""
    from repro_torch.launch.mesh import Mesh
    m = plan.mesh
    return Mesh(m.axis_names, tuple(m.shape.values()), 0)


# ---------------------------------------------------------------------------
# Check (c): host syncs on the card
# ---------------------------------------------------------------------------

def _cuda_args(args) -> bool:
    import torch
    todo = list(args)
    while todo:
        a = todo.pop()
        if isinstance(a, torch.Tensor):
            if a.is_cuda:
                return True
        elif isinstance(a, (list, tuple)):
            todo += a
        elif isinstance(a, dict):
            todo += a.values()
    return False


def sync_stacks(fn, *args, **kwargs) -> list:
    """Run ``fn(*args, **kwargs)`` once under
    ``torch.cuda.set_sync_debug_mode("warn")`` and return, for each call
    that synchronized, in the order they happened (repeats included),
    ("file:line" of the innermost frame outside torch, the innermost six
    such frames as "file:line function").  Raises ``RuntimeError`` without
    a card and ``ValueError`` when no argument lies on it: on the CPU
    nothing synchronizes, and the check would pass vacuously."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("sync_issues needs a CUDA device: on the CPU no "
                           "call synchronizes, so the check would pass "
                           "vacuously")
    if not _cuda_args(list(args) + list(kwargs.values())):
        raise ValueError("sync_issues: no argument lies on the card; run "
                         "the function on CUDA tensors")
    torch_dir = str(Path(torch.__file__).parent)
    found = []

    def show(message, category, filename, lineno, file=None, line=None):
        # the mode's own notice ("... is a prototype feature ...") is no sync
        text = str(message)
        if "synchroniz" not in text or "prototype" in text:
            return
        frames = [fr for fr in reversed(traceback.extract_stack()[:-1])
                  if not fr.filename.startswith(torch_dir)
                  and not fr.filename.endswith("warnings.py")]
        site = f"{frames[0].filename}:{frames[0].lineno}" if frames \
            else f"{filename}:{lineno}"
        found.append((site, [f"{fr.filename}:{fr.lineno} {fr.name}"
                             for fr in frames[:6]]))

    torch.cuda.synchronize()
    before = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(before)
    return found


def sync_issues(fn, *args, **kwargs) -> list:
    """The "file:line" sites of ``sync_stacks``: every call of
    ``fn(*args, **kwargs)`` that synchronized the host with the card."""
    return [site for site, _ in sync_stacks(fn, *args, **kwargs)]


def audited_sync_lines(root: Optional[str] = None) -> set:
    """{"file:line"} of every R2 finding in ``root`` (default: this
    package's ``src/repro_torch``) that a ``disable=R2`` suppresses."""
    from repro_torch.analysis import lint
    from repro_torch.analysis.rules import R2
    ctx = lint.LintContext(lint.discover(
        [root or str(Path(__file__).resolve().parents[1])]))
    mods = {str(m.path): m for m in ctx.modules}
    return {f"{Path(f.path).resolve()}:{f.line}"
            for f in lint.run_rules(ctx, [R2], respect_disables=False)
            if lint._suppressed(mods[f.path], "R2", f.line)}


def unaudited(issues, root: Optional[str] = None) -> list:
    """The sync sites of ``issues`` (``sync_issues``) that are not an
    audited R2 line."""
    ok = audited_sync_lines(root)
    out = []
    for s in issues:
        path, _, line = s.rpartition(":")
        if f"{Path(path).resolve()}:{line}" not in ok:
            out.append(s)
    return out


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _tiny_cfg():
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(name="tiny-moe", family="moe", n_layers=2,
                       d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                       vocab_size=256, n_experts=8, top_k=2, d_expert=96,
                       n_shared_experts=1)


def run_contract(arch: Optional[str], mesh_shape: tuple, strategies,
                 comm_algo: str, chunks: int, cap_rows: int = -1,
                 device: str = "cuda") -> list:
    """Resolve each strategy to a plan on a (data, model) layout and run
    check (a) for it."""
    from repro_torch.core.cost_model import EpOverlap
    from repro_torch.core.partitioner import make_plan
    from repro_torch.launch.mesh import Mesh

    ep_overlap = EpOverlap(chunks=max(1, chunks), cap_rows=cap_rows) \
        if chunks > 1 or cap_rows >= 0 else None
    mesh = Mesh(("data", "model"), mesh_shape)
    if arch is None:
        cfg = _tiny_cfg()
    else:
        import repro_torch.configs as C
        from repro_torch.serving.api import ServeSpec
        cfg = C.get_reduced(arch)
        if not strategies:
            strategies = [ServeSpec(arch=arch).resolve(
                cfg, mesh=mesh, device="cpu").strategy]
    reports = []
    for strat in strategies or ["mixserve", "pure_tp", "dp_ep"]:
        plan = make_plan(strat, mesh, comm_algo, dispatch="dropless",
                         ep_overlap=ep_overlap)
        tag = f"{cfg.name}/{strat}/{comm_algo}" \
            + (f"/chunks={chunks}" if chunks > 1 else "")
        reports.append(check_moe_census(cfg, plan, device=device,
                                        name=f"moe_census[{tag}]"))
    return reports


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.trace_contract",
        description="hold the MoE block's issued collectives, on the ranks "
                    "of a mesh, against cost_model.comm_census")
    ap.add_argument("--spec", default=None, metavar="ARCH",
                    help="registry arch id (its reduced config; the layout "
                         "the resolver picks for the mesh unless "
                         "--strategies); default: the tiny 8-expert MoE")
    ap.add_argument("--mesh", default="2x2",
                    help="data x model mesh, e.g. 2x2 (default) or 4x1")
    ap.add_argument("--strategies", default="",
                    help="comma list of mixserve,pure_tp,dp_ep "
                         "(default: all three; with --spec: the resolved one)")
    ap.add_argument("--algo", default="fused",
                    choices=["fused", "sync", "unfused"])
    ap.add_argument("--chunks", type=int, default=0,
                    help="micro-chunked EP overlap chunk count (0 = off)")
    ap.add_argument("--cap-rows", type=int, default=-1,
                    help="count-bound row cap (-1 = worst case, 0 = auto "
                         "rule, >0 explicit: small values overflow)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the ranks run (default: the card)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the reports as JSON")
    args = ap.parse_args(argv)

    shape = tuple(int(d) for d in args.mesh.lower().split("x"))
    if len(shape) != 2:
        ap.error("--mesh must be RxC (two axes: data x model)")
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            ap.exit(3, "trace_contract: no CUDA device; pass --device cpu "
                       "to run the ranks on the CPU\n")
    strategies = [s for s in args.strategies.split(",") if s]
    reports = run_contract(args.spec, shape, strategies, args.algo,
                           args.chunks, args.cap_rows, args.device)
    for r in reports:
        print(r)
    if args.json:
        with open(args.json, "w") as f:
            json.dump([r.as_json() for r in reports], f, indent=2)
    return 0 if all(r.ok for r in reports) else 1


if __name__ == "__main__":
    raise SystemExit(main())


__all__ = ["expected_census", "strategy_for_plan", "tokens_local_for",
           "check_moe_census", "ContractReport", "run_contract",
           "sync_issues", "sync_stacks", "audited_sync_lines", "unaudited"]
