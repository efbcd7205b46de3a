"""The port's analysis layer (``repro_torch.analysis``): the lint rules
R2 / R4 / R5 on their fixtures, on the shipped tree and on seeded
violations in copies of it; the AST index against the reference's; the
collective census against the reference's expected census and on 4 gloo
ranks; ``sync_issues``' refusal of the CPU."""

import dataclasses
import pathlib
import subprocess
import sys
import types
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as RC  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro.analysis import astutils as R_AST  # noqa: E402
from repro.analysis import trace_contract as R_TC  # noqa: E402
from repro.core import cost_model as RCM  # noqa: E402
from repro.core import partitioner as RP  # noqa: E402
from repro.kernels.policy import NULL_POLICY as R_NULL  # noqa: E402
from repro_torch.analysis import astutils as T_AST  # noqa: E402
from repro_torch.analysis import lint  # noqa: E402
from repro_torch.analysis import trace_contract as TC_  # noqa: E402
from repro_torch.core import cost_model as TCM  # noqa: E402
from repro_torch.core.partitioner import make_plan  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT_FILES = sorted((SRC / "repro_torch").rglob("*.py"))


# ---------------------------------------------------------------------------
# the linter
# ---------------------------------------------------------------------------

def test_self_test_catches_each_seeded_violation(capsys):
    assert lint.self_test() == 0
    out = capsys.readouterr().out
    assert [r.id for r in lint.all_rules()] == ["R2", "R4", "R5"]
    for rid in ("R2", "R4", "R5"):
        assert f"{rid}: OK" in out
    assert "self-test: OK (3 rules)" in out


@pytest.mark.parametrize("rule", ["R2", "R4", "R5"])
def test_each_rule_flags_its_fixture_and_passes_its_clean_one(rule):
    r = next(r for r in lint.all_rules() if r.id == rule)
    bad = lint.lint_sources({f"fixture_bad_{rule.lower()}": r.FIXTURE_BAD})
    good = lint.lint_sources({f"fixture_good_{rule.lower()}":
                              r.FIXTURE_GOOD})
    assert bad and {f.rule for f in bad} == {rule}
    assert good == []


@pytest.fixture(scope="module")
def port_ctx():
    """The shipped tree, parsed and indexed once for this module."""
    return lint.LintContext(lint.discover([str(SRC / "repro_torch")]))


def test_the_port_is_clean(port_ctx):
    assert lint.run_rules(port_ctx) == []


def test_the_cli_exits_0_on_the_port_and_1_without_disables(tmp_path,
                                                            capsys):
    env = {"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"}
    ok = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", "src/repro_torch",
         "--json", str(tmp_path / "f.json")], env=env, capture_output=True,
        text=True, timeout=120, cwd=ROOT)
    assert ok.returncode == 0, ok.stdout + ok.stderr
    assert "repro-lint: 0 finding(s)" in ok.stdout
    assert '"count": 0' in (tmp_path / "f.json").read_text()
    assert lint.main([str(SRC / "repro_torch" / "models"),
                      str(SRC / "repro_torch" / "kernels"),
                      str(SRC / "repro_torch" / "serving"),
                      "--no-disables", "--rules", "R2"]) == 1
    out = capsys.readouterr().out
    assert "moe.py" in out and "ref.py" in out
    assert lint.main([]) == 2
    assert lint.main(["--self-test"]) == 0


def test_the_audited_syncs_are_the_known_sites(port_ctx):
    """The mesh's overflow branch, the plain grouped GEMM's bounds and the
    two masked KV-cache writes (ROADMAP C's list): a new sync on the
    step's path must be audited, and this set updated with it."""
    from repro_torch.analysis.rules import R2
    raw = lint.run_rules(port_ctx, [R2], respect_disables=False)
    sites = {(pathlib.Path(f.path).name, f.symbol) for f in raw}
    assert sites == {("moe.py", "_moe_shard_dropless_fn"),
                     ("ref.py", "grouped_gemm_ref"),
                     ("layers.py", "write_cache"),
                     ("layers.py", "write_cache_paged")}
    audited = TC_.audited_sync_lines()
    assert {pathlib.Path(s.rsplit(":", 1)[0]).name for s in audited} \
        == {"moe.py", "ref.py", "layers.py"}
    assert TC_.unaudited(sorted(audited)) == []
    elsewhere = f"{SRC / 'repro_torch' / 'models' / 'moe.py'}:1"
    assert TC_.unaudited([elsewhere]) == [elsewhere]


def _seeded_copy(port_ctx, rel, anchor, line):
    """The shipped tree with ``line`` inserted into a copy of ``rel`` after
    its first line holding ``anchor``: (the lint context, the copy's path,
    the inserted line's number)."""
    path = SRC / "repro_torch" / rel
    lines = path.read_text().splitlines()
    at = next(i for i, s in enumerate(lines) if anchor in s) + 1
    lines.insert(at, line)
    seeded = lint.parse_module(path, source="\n".join(lines) + "\n")
    mods = [seeded if m.path == path else m for m in port_ctx.modules]
    return lint.LintContext(mods), path, at + 1


@pytest.mark.parametrize("rel,anchor,line,rule", [
    ("models/moe.py", "    n = flat_e.shape[0]",
     "    top = flat_e.max().item()", "R2"),
    ("models/moe.py", "    n = flat_e.shape[0]",
     "    top = int(flat_e.max())", "R2"),
    ("models/layers.py", "    page = torch.gather(block_table.long(), 1, blk)",
     "    live = page[page >= 0]", "R2"),
    ("serving/scheduler.py", "    rng = np.random.default_rng(seed)",
     "    noise = torch.randn(4)", "R5"),
    ("serving/engine.py", "    def _sample(self, last):",
     "        torch.manual_seed(0)", "R5"),
    ("kernels/ops.py", '    counters["flash_chunk"] += 1',
     '    counters["flash_chunk"] += 1', "R4"),
], ids=["item-in-dropless", "int-in-dropless", "mask-in-paged-write",
        "randn-in-scheduler",
        "reseed-in-engine", "double-bump"])
def test_a_seeded_violation_is_flagged_at_its_line(port_ctx, rel, anchor,
                                                   line, rule):
    ctx, path, at = _seeded_copy(port_ctx, rel, anchor, line)
    found = lint.run_rules(ctx)
    assert found, "the seeded violation went unseen"
    assert {(f.rule, f.path) for f in found} == {(rule, str(path))}
    if rule != "R4":                  # R4 names the wrapper's def line
        assert [f.line for f in found] == [at]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(SRC)))
def test_astutils_parse_equals_the_reference(path):
    r, t = R_AST.parse_module(path), T_AST.parse_module(path)
    assert t.name == r.name
    assert t.disables == r.disables
    assert t.imports == r.imports
    assert sorted(t.functions) == sorted(r.functions)
    assert [f.positional_params() for f in t.functions.values()] \
        == [f.positional_params() for f in r.functions.values()]


def test_astutils_index_equals_the_reference():
    r = R_AST.Index([R_AST.parse_module(p) for p in PORT_FILES])
    t = T_AST.Index([T_AST.parse_module(p) for p in PORT_FILES])
    assert sorted(t.by_key) == sorted(r.by_key)
    assert t._edges == r._edges
    roots = [r.by_key[k] for k in sorted(r.by_key)
             if k.startswith("repro_torch.models.model:")]
    t_roots = [t.by_key[k] for k in sorted(t.by_key)
               if k.startswith("repro_torch.models.model:")]
    assert sorted(t.reachable(t_roots)) == sorted(r.reachable(roots))


# ---------------------------------------------------------------------------
# the census
# ---------------------------------------------------------------------------

def _ref_plan(t_plan):
    """The reference's plan of the same layout, on a stand-in mesh (its
    census functions read only the axis names, sizes and device count)."""
    m = t_plan.mesh
    mesh = types.SimpleNamespace(axis_names=m.axis_names, shape=dict(m.shape),
                                 devices=np.empty(tuple(m.shape.values())))
    return dataclasses.replace(
        RP.make_plan("mixserve", mesh, t_plan.comm_algo, kernels=R_NULL,
                     dispatch="dropless"),
        rules=dict(t_plan.rules), tp_axes=t_plan.tp_axes,
        ep_axes=t_plan.ep_axes, dp_axes=t_plan.dp_axes)


CENSUS_CASES = [(a, m, lay, ovl) for a in ("phi3.5-moe-42b",
                                           "deepseek-v2-236b")
                for m in ((2, 2), (4, 1))
                for lay in ("mixserve", "dp_ep", "pure_tp")
                for ovl in (None, (2, 4))]


@pytest.mark.parametrize("case", CENSUS_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_expected_census_equals_the_reference(case):
    arch, m, lay, ovl = case
    t_cfg, r_cfg = TC.get_reduced(arch), RC.get_reduced(arch)
    t_ovl = None if ovl is None else TCM.EpOverlap(chunks=ovl[0],
                                                   cap_rows=ovl[1])
    r_ovl = None if ovl is None else RCM.EpOverlap(chunks=ovl[0],
                                                   cap_rows=ovl[1])
    t_plan = make_plan(lay, Mesh(("data", "model"), m), dispatch="dropless",
                       ep_overlap=t_ovl)
    r_plan = dataclasses.replace(_ref_plan(t_plan), ep_overlap=r_ovl)
    assert dataclasses.asdict(TC_.strategy_for_plan(t_plan)) \
        == dataclasses.asdict(R_TC.strategy_for_plan(r_plan))
    assert dataclasses.asdict(TC_.strategy_for_plan(t_plan)) \
        == dataclasses.asdict(t_plan.strategy())
    for b, s in ((4, 8), (8, 16), (2, 3)):
        assert TC_.tokens_local_for(t_plan, b, s) \
            == R_TC.tokens_local_for(r_plan, b, s)
        tl = TC_.tokens_local_for(t_plan, b, s)
        t_c = TCM.comm_census(t_cfg, TC_.strategy_for_plan(t_plan),
                              TCM.Workload(batch=b, seq_len=s),
                              ep_overlap=t_ovl, tokens_local=tl)
        r_c = RCM.comm_census(r_cfg, R_TC.strategy_for_plan(r_plan),
                              RCM.Workload(batch=b, seq_len=s),
                              ep_overlap=r_ovl, tokens_local=tl)
        assert TC_.expected_census(t_c, t_plan) \
            == R_TC.expected_census(r_c, r_plan)


def test_check_moe_census_on_4_gloo_ranks(tmp_path):
    """phi3.5 reduced under mixserve on 2x2, its exchange in 2 chunks
    capped at 4 rows (each chunk overflows and reruns): every rank's
    collectives equal the census's firm entries plus the conditional ones
    of the reruns; a block with one all-reduce more fails."""
    cfg = TC.get_reduced("phi3.5-moe-42b")
    plan = make_plan("mixserve", Mesh(("data", "model"), (2, 2)),
                     dispatch="dropless",
                     ep_overlap=TCM.EpOverlap(chunks=2, cap_rows=4))
    rep = TC_.check_moe_census(cfg, plan, device="cpu",
                               workdir=str(tmp_path))
    assert rep.ok, str(rep)
    assert all(a["chunks"] == 2 and a["overflow"] == 2
               for a in rep.actual.values())
    assert rep.expected["conditional"]
    from _torch_analysis_blocks import moe_block_extra_psum
    bad = TC_.check_moe_census(cfg, plan, device="cpu",
                               block=moe_block_extra_psum,
                               workdir=str(tmp_path))
    assert not bad.ok
    assert len(bad.mismatches) == 4       # one a rank
    assert all("all_reduce(model) expected 0, issued 1" in m
               for m in bad.mismatches)


def test_sync_issues_refuses_the_cpu(monkeypatch):
    fn = lambda x: (x + 1).sum().item()
    with pytest.raises(RuntimeError, match="CUDA"):
        TC_.sync_issues(fn, torch.ones(3))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="no argument lies on the card"):
        TC_.sync_issues(fn, torch.ones(3))
    with pytest.raises(ValueError):
        TC_.sync_issues(fn, [torch.ones(3)], x=torch.ones(2))


def test_census_counter_keys_are_the_references():
    """The expected census is keyed as the reference's jaxpr census is:
    (kind, frozenset of mesh axes)."""
    plan = make_plan("mixserve", Mesh(("data", "model"), (2, 2)),
                     dispatch="dropless")
    cfg = TC.get_reduced("phi3.5-moe-42b")
    c = TCM.comm_census(cfg, plan.strategy(), TCM.Workload(batch=4,
                                                           seq_len=8),
                        tokens_local=TC_.tokens_local_for(plan, 4, 8))
    firm, cond = TC_.expected_census(c, plan)
    assert isinstance(firm, Counter) and not cond
    assert all(isinstance(k[1], frozenset) for k in firm)
