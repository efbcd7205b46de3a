"""The dry run's inputs against the reference's shardings.

``repro_torch.launch.specs.input_specs`` gives one rank's blocks of a
step's arguments as meta tensors.  For every (arch x supported shape x
production mesh x layout) each leaf's shape and dtype on rank 0 is held to
the shard shape device 0 holds under the reference's own
``repro.launch.specs.input_specs`` (computed by
``tests/_torch_ref_layouts.py specs`` in a process with 512 host devices:
the reference's NamedShardings, nothing lowered).  A dim that differs must
be one of the port's deliberate layout choices, listed in ``DIFFERENCES``
with its reason (ROADMAP queue C, "Mesh layout choices"), and differ by
exactly that rule.
"""

import json
import math
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import repro_torch.configs as RC  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES  # noqa: E402
from repro_torch.core.partitioner import make_plan  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import production_layout  # noqa: E402
from repro_torch.launch.specs import input_specs  # noqa: E402
from repro_torch.training.tree import flatten_with_paths  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
MOE_ARCHS = ("phi3.5-moe-42b", "deepseek-v2-236b")

DIFFERENCES = {
    "attention": "the port cuts a weight's heads over TP where TP divides "
                 "the query and kv heads (ShardingPlan.heads_sharded) and "
                 "keeps head_dim / kv_head_dim / qk whole; elsewhere the "
                 "attention runs replicated, where the reference cuts "
                 "head_dim (or MLA's latent qk) instead",
    "whole_batch": "every rank is handed the whole batch and the cache's "
                   "length covers every slot: the forward takes the rank's "
                   "rows itself (plan.rows)",
    "dense_cache": "a dense cache buffer holds the rank's heads (RWKV6: "
                   "its wkv heads, the RG-LRU: its channels) where they "
                   "split, whole along kv_seq, where the reference cuts "
                   "kv_seq over TP and keeps the heads whole",
    "refused": "dp_ep on a production mesh: EP over all 256 / 512 ranks "
               "does not divide phi3.5's 16 or deepseek-v2's 160 experts; "
               "the port's layout refuses it where the reference's specs "
               "leave the experts whole (its MoE block refuses it later, "
               "as the port's moe_rank does)",
}


def _layouts(arch):
    return ("mixserve", "dp_ep", "pure_tp") if arch in MOE_ARCHS \
        else ("mixserve",)


CASES = [(a, s, m, lay) for m in ("single", "multi") for a in RC.ARCH_IDS
         for s in INPUT_SHAPES
         if RC.shape_supported(RC.get(a), INPUT_SHAPES[s])
         for lay in _layouts(a)]


@pytest.fixture(scope="module")
def ref_specs(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "specs.json"
    env = {"PYTHONPATH": f"{ROOT / 'src'}:{ROOT / 'tests'}",
           "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_ref_layouts.py"),
         "specs", str(out)], env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(out.read_text())


def _port_path(path: tuple) -> tuple:
    """The reference's path of a port leaf: a layer's index (after a
    group's, or under whisper's encoder ``layers``) dropped, since the
    reference stacks the layers on a leading axis."""
    for i in range(1, len(path) - 1):
        if path[i - 1] == "groups" and isinstance(path[i], int) \
                and i + 1 < len(path) and isinstance(path[i + 1], int):
            return path[:i + 1] + path[i + 2:]
        if path[i - 1] == "layers" and isinstance(path[i], int):
            return path[:i] + path[i + 1:]
    return path


def _reason(cfg, plan, axis, got, glob, tree) -> str:
    """The ``DIFFERENCES`` entry that explains a dim of ``got`` elements
    (the whole dim ``glob``) on the port's side, or None."""
    tp = plan.tp
    split = plan.heads_sharded(cfg)
    if tree in ("params", "moments"):
        if axis in ("head_dim", "kv_head_dim", "qk") and got == glob:
            return "attention"
        if axis in ("heads", "kv_heads") \
                and got == (glob // tp if split else glob):
            return "attention"
        return None
    if tree == "batch" or (tree == "cache" and axis == "batch"):
        return "whole_batch" if axis == "batch" and got == glob else None
    if tree == "cache":
        if axis == "kv_seq" and got == glob:
            return "dense_cache"
        if axis is None and got * tp == glob:
            return "dense_cache"
    return None


def _tree(kind: str, path: tuple) -> str:
    if path[0] == 0:
        return "params"
    if kind == "train":
        return "moments" if path[0] == 1 and path[1] in (".m", ".v") \
            else "batch" if path[0] == 2 else "step"
    return "cache" if path[0] == 2 else "batch"


@pytest.mark.parametrize("case", CASES, ids=["|".join(c) for c in CASES])
def test_rank_blocks_match_reference_shards(ref_specs, case):
    arch, sname, mesh_kind, layout = case
    cfg, shape = RC.get(arch), INPUT_SHAPES[sname]
    ref = ref_specs["|".join(case)]
    mesh = production_layout(multi_pod=mesh_kind == "multi")
    plan = make_plan(layout, mesh, fsdp=shape.kind == "train")
    if layout == "dp_ep" and shape.kind != "train":
        # DIFFERENCES["refused"]: the experts do not split over every rank
        assert cfg.n_experts % mesh.size
        with pytest.raises(ValueError, match="does not split"):
            input_specs(cfg, shape, plan)
        experts = [leaf for leaf in ref if "expert" in leaf["axes"]]
        assert experts and all(leaf["shard"] == leaf["shape"]
                               for leaf in experts)
        return
    args = input_specs(cfg, shape, plan)
    port = dict(flatten_with_paths(args))
    by_ref: dict = {}
    for path, t in port.items():
        by_ref.setdefault(_port_path(path), []).append((path, t))
    seen = set()
    for leaf in ref:
        path = tuple(leaf["path"])
        mine = by_ref.get(path, [])
        assert mine, f"no port leaf for the reference's {path}"
        if [p for p, _ in mine] == [path]:
            want, glob, axes = leaf["shard"], leaf["shape"], leaf["axes"]
        else:             # stacked layers there, one leaf a layer here
            assert leaf["axes"][0] == "layers", path
            assert len(mine) == leaf["shape"][0] == leaf["shard"][0], path
            want, glob, axes = leaf["shard"][1:], leaf["shape"][1:], \
                leaf["axes"][1:]
        for p, t in mine:
            seen.add(p)
            assert str(t.dtype) == f"torch.{leaf['dtype']}", (p, t.dtype)
            assert len(t.shape) == len(want), (p, tuple(t.shape), want)
            tree = _tree(shape.kind, p)
            for d, (g, w, gl) in enumerate(zip(t.shape, want, glob)):
                if g == w:
                    continue
                why = _reason(cfg, plan, axes[d], g, gl, tree)
                assert why in DIFFERENCES, (
                    f"{p} dim {d} ({axes[d]}): the port holds {g}, the "
                    f"reference's shard {w} of {gl}; no listed difference "
                    f"explains it")
    assert seen == set(port), sorted(set(port) - seen)[:5]
    # per-rank argument bytes: every leaf once
    assert dryrun.argument_bytes(args) == sum(
        math.prod(t.shape) * t.element_size() for t in port.values())
