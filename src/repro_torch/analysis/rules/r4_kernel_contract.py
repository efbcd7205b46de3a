"""R4: every kernel wrapper counts its launch once and has a plain body."""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterable

from repro_torch.analysis.lint import Finding


def contract_faults(ops_src: str, ref_names) -> list:
    """(line, fault) of every break of the kernel contract in the source of
    a wrapper module (``kernels/ops.py``): every public wrapper that
    reaches ``_launch`` (directly or through module-level helpers) bumps
    ``counters[<its name>]`` exactly once on its launch path (its body and
    the helpers it calls that launch), each bump after a launching call in
    its function and nowhere off a launch path, and has a plain body
    ``<name>_ref`` among ``ref_names`` (``kernels/ref.py``)."""
    tree = ast.parse(ops_src)
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    public = next((ast.literal_eval(n.value) for n in tree.body
                   if isinstance(n, ast.Assign)
                   and [getattr(t, "id", None) for t in n.targets]
                   == ["__all__"]), [])

    def calls(fn):
        return [c for c in ast.walk(fn) if isinstance(c, ast.Call)
                and isinstance(c.func, ast.Name) and c.func.id in funcs]

    launching = {"_launch"}
    grew = True
    while grew:
        grew = False
        for name, fn in funcs.items():
            if name not in launching and any(
                    c.func.id in launching for c in calls(fn)):
                launching.add(name)
                grew = True

    def bumps(fn):
        """(key, line) of each ``counters[key] += 1`` in ``fn``."""
        local = {t.id: n.value.value for n in ast.walk(fn)
                 if isinstance(n, ast.Assign)
                 and isinstance(n.value, ast.Constant)
                 for t in n.targets if isinstance(t, ast.Name)}
        out = []
        for n in ast.walk(fn):
            if isinstance(n, ast.AugAssign) \
                    and isinstance(n.target, ast.Subscript) \
                    and isinstance(n.target.value, ast.Name) \
                    and n.target.value.id == "counters":
                key = n.target.slice
                key = key.value if isinstance(key, ast.Constant) \
                    else local.get(getattr(key, "id", None))
                out.append((key, n.lineno))
        return out

    faults = []
    for name, fn in funcs.items():
        first_launch = min((c.lineno for c in calls(fn)
                            if c.func.id in launching), default=None)
        for key, line in bumps(fn):
            if first_launch is None or line < first_launch:
                faults.append((line, f"{name}: counters[{key!r}] bumped off "
                                     f"a launch path (line {line})"))
            if key not in public:
                faults.append((line, f"{name}: counters[{key!r}] names no "
                                     "public wrapper"))
    for name in public:
        if name not in launching or name == "reset_counters":
            continue
        path, todo = set(), [name]
        while todo:
            f = todo.pop()
            if f not in path:
                path.add(f)
                todo += [c.func.id for c in calls(funcs[f])
                         if c.func.id in launching
                         and c.func.id.startswith("_")]
        n = sum(key == name for f in path for key, _ in bumps(funcs[f]))
        line = funcs[name].lineno
        if n != 1:
            faults.append((line, f"{name}: counters[{name!r}] bumped {n} "
                                 "times on its launch path"))
        if f"{name}_ref" not in ref_names:
            faults.append((line, f"{name}: no plain body {name}_ref in "
                                 "ref.py"))
    return faults


def kernel_contract_faults(ops_src: str, ref_names) -> list:
    """The faults of ``contract_faults``, without their lines."""
    return [msg for _, msg in contract_faults(ops_src, ref_names)]


def _defs(source: str) -> set:
    return {n.name for n in ast.parse(source).body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


class KernelContractRule:
    """Every public wrapper of ``kernels/ops.py`` that launches a kernel
    counts that launch once, and has a plain body in ``kernels/ref.py``.

    The chip run proves that a served path went through the hand-written
    kernels by reading ``ops.counters``: zeroed before the path runs, read
    after, each kernel of the path counted at least once.  That proof
    holds only if every launch path bumps its wrapper's own counter
    exactly once, after the launch and nowhere else (not on the CPU's
    plain branch, not on the meta device's priced branch).  A wrapper
    without ``<name>_ref`` has no plain version to be held against, on the
    CPU or on the card.

    Applies to ``kernels.ops`` (the JAX package's rule keys on the module's
    trace counters; the port's wrappers count launches, so the rule reads
    the launch paths: every function that reaches ``_launch``).  The
    plain bodies are read from the sibling ``ref`` module among the linted
    ones, else from ``ref.py`` beside the file; a self-test fixture keeps
    its own.
    """

    id = "R4"
    title = "kernel wrappers count each launch once and have a plain body"

    def _applies(self, mod) -> bool:
        name = mod.name
        return name.endswith("kernels.ops") or (
            name.startswith("fixture_") and name.endswith("_r4"))

    def check(self, ctx) -> Iterable[Finding]:
        for mod in ctx.modules:
            if not self._applies(mod):
                continue
            ref = ctx.module(mod.name.rsplit(".", 1)[0] + ".ref") \
                if "." in mod.name else None
            if ref is not None:
                ref_names = _defs(ref.source)
            elif (Path(mod.path).parent / "ref.py").exists():
                ref_names = _defs((Path(mod.path).parent / "ref.py")
                                  .read_text())
            else:
                ref_names = _defs(mod.source)
            for line, msg in contract_faults(mod.source, ref_names):
                yield Finding(self.id, str(mod.path), line, 0, msg)

    FIXTURE_BAD = '''
import collections

counters = collections.Counter()


def _launch(fn, *args):
    return fn(*args)


def moe_gemm(x, w):
    # launches but never counts, and has no moe_gemm_ref
    return _launch(lib.rt_moe_gemm, x, w)


def topk_gate(logits, k):
    counters["topk_gate"] += 1          # counted before (and off) its launch
    _launch(lib.rt_topk_gate, logits, k)
    counters["topk_gate"] += 1          # and again after it


def topk_gate_ref(logits, k):
    return logits


__all__ = ["moe_gemm", "topk_gate"]
'''

    FIXTURE_GOOD = '''
import collections

counters = collections.Counter()


def reset_counters():
    counters.clear()


def _launch(fn, *args):
    return fn(*args)


def moe_gemm(x, w):
    if x.device.type == "cpu":
        return moe_gemm_ref(x, w)
    out = _launch(lib.rt_moe_gemm, x, w)
    counters["moe_gemm"] += 1
    return out


def moe_gemm_ref(x, w):
    return x @ w


__all__ = ["moe_gemm", "reset_counters"]
'''


RULE = KernelContractRule()
