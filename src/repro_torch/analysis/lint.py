"""The port's AST linter: the JAX package's ``repro-lint`` with the rules
that have a PyTorch meaning (``all_rules()``: R2, R4, R5).

Usage::

    python -m repro_torch.analysis.lint src/repro_torch [--json out.json]
        [--rules R2,R5] [--no-disables]
    python -m repro_torch.analysis.lint --self-test

The rule ids keep the JAX package's numbers.  R1 (a sort inside
``shard_map``) and R3 (a Python branch on a traced value) are about XLA
tracing and have no counterpart in eager PyTorch, so there is no R1 or R3.

Exit code 0 = clean, 1 = findings, 2 = usage/internal error.  Findings
are suppressed by a ``# repro-lint: disable=R2[,R5]`` comment on the
flagged line or the line directly above it (pair it with a justification
comment — the escape hatch is for *audited* exceptions).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path
from typing import Iterable, Optional

from repro_torch.analysis.astutils import Index, ModuleInfo, parse_module


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str
    symbol: str = ""

    def as_json(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{self.path}:{self.line}:{self.col}: {self.rule}{sym} {self.message}"


class LintContext:
    """Parsed modules + the cross-module index, shared by all rules."""

    def __init__(self, modules: Iterable[ModuleInfo]):
        self.modules = list(modules)
        self.index = Index(self.modules)

    def module(self, name: str) -> Optional[ModuleInfo]:
        for m in self.modules:
            if m.name == name or m.name.endswith("." + name):
                return m
        return None


def _suppressed(mod: ModuleInfo, rule: str, line: int) -> bool:
    for ln in (line, line - 1):
        if rule in mod.disables.get(ln, ()):
            return True
    return False


def all_rules() -> list:
    from repro_torch.analysis.rules import RULES
    return list(RULES)


def run_rules(ctx: LintContext, rules: Optional[Iterable] = None,
              respect_disables: bool = True) -> list[Finding]:
    mods_by_path = {str(m.path): m for m in ctx.modules}
    findings: list[Finding] = []
    for rule in (rules if rules is not None else all_rules()):
        for f in rule.check(ctx):
            mod = mods_by_path.get(f.path)
            if respect_disables and mod is not None \
                    and _suppressed(mod, f.rule, f.line):
                continue
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def discover(paths: Iterable[str]) -> list[ModuleInfo]:
    mods = []
    for p in paths:
        path = Path(p)
        files = sorted(path.rglob("*.py")) if path.is_dir() else [path]
        for f in files:
            mods.append(parse_module(f))
    return mods


def lint_paths(paths: Iterable[str], rule_ids: Optional[set] = None,
               respect_disables: bool = True) -> list[Finding]:
    ctx = LintContext(discover(paths))
    rules = all_rules()
    if rule_ids:
        rules = [r for r in rules if r.id in rule_ids]
    return run_rules(ctx, rules, respect_disables)


def lint_sources(sources: dict, rule_ids: Optional[set] = None,
                 respect_disables: bool = True) -> list[Finding]:
    """Lint in-memory ``{module_name: source}`` dicts (test fixtures)."""
    mods = [parse_module(Path(f"{name.replace('.', '/')}.py"), name=name,
                         source=src)
            for name, src in sources.items()]
    ctx = LintContext(mods)
    rules = all_rules()
    if rule_ids:
        rules = [r for r in rules if r.id in rule_ids]
    return run_rules(ctx, rules, respect_disables)


def self_test() -> int:
    """Each rule must catch its bad fixture and pass its good fixture.

    This is the CI red-on-seeded-violation proof: a rule that stops
    firing on its own fixture fails the lane.
    """
    ok = True
    for rule in all_rules():
        bad = lint_sources({f"fixture_bad_{rule.id.lower()}": rule.FIXTURE_BAD},
                           rule_ids={rule.id})
        good = lint_sources(
            {f"fixture_good_{rule.id.lower()}": rule.FIXTURE_GOOD},
            rule_ids={rule.id})
        if not bad:
            print(f"SELF-TEST FAIL: {rule.id} missed its seeded violation")
            ok = False
        if good:
            print(f"SELF-TEST FAIL: {rule.id} false-positives on its clean "
                  f"fixture: {[str(f) for f in good]}")
            ok = False
        if bad and not good:
            print(f"{rule.id}: OK ({len(bad)} seeded finding(s) caught, "
                  "clean fixture passes)")
    print("self-test:", "OK" if ok else "FAILED",
          f"({len(all_rules())} rules)")
    return 0 if ok else 1


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis.lint",
                                 description=__doc__)
    ap.add_argument("paths", nargs="*", help="files or directories to lint")
    ap.add_argument("--json", metavar="FILE",
                    help="write machine-readable findings to FILE")
    ap.add_argument("--rules", help="comma-separated rule ids (default: all)")
    ap.add_argument("--no-disables", action="store_true",
                    help="ignore # repro-lint: disable= comments")
    ap.add_argument("--self-test", action="store_true",
                    help="verify every rule catches its seeded violation")
    args = ap.parse_args(argv)

    if args.self_test:
        return self_test()
    if not args.paths:
        ap.print_usage()
        return 2
    rule_ids = {r.strip() for r in args.rules.split(",")} if args.rules else None
    findings = lint_paths(args.paths, rule_ids,
                          respect_disables=not args.no_disables)
    for f in findings:
        print(f)
    if args.json:
        payload = {"tool": "repro-lint", "findings": [f.as_json() for f in findings],
                   "count": len(findings),
                   "rules": [r.id for r in all_rules()]}
        Path(args.json).write_text(json.dumps(payload, indent=2) + "\n")
    print(f"repro-lint: {len(findings)} finding(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
