"""The dry run (``repro_torch.launch.dryrun``) against real steps and the
reference.

(a) Meta against real, on the CPU: one spawn of 4 gloo ranks on a 2x2
    mesh (``tests/_torch_dryrun_ranks.py``); for the reduced phi3.5,
    deepseek-v2 and smollm under mixserve, dp_ep and pure_tp, sp on and
    off, each rank's real decode, prefill and train step gives exactly its
    dry run's collective calls and bytes by (kind, axes[, "backward"]),
    argument bytes and FLOPs (kernels off; FlopCounterMode on the real
    step, the grouped GEMM priced at its buffer's rows on both sides).
(b) The MoE block's collective bytes against the reference: the shard_map
    jaxpr of ``repro.models.moe.moe_block`` on a 2x2 host mesh
    (``tests/_torch_ref_layouts.py moe``), each collective equation's
    output bytes summed by kind and axes, equal to the port's ``moe_rank``
    on the meta device, call for call and byte for byte.
(c) Full width on meta: phi3.5-moe-42b and deepseek-v2-236b ``decode_32k``
    on the single-pod mesh through ``run_one``: the reference's keys, and
    the rank fits its card; a training step there holds no whole logits.
(d) The CLI writes one record under ``--out``.
Plus the pieces the dry run added to the serving path: the dense cache's
writes read no host value and write what they wrote before.
"""

import json
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import collectives as C  # noqa: E402
from repro_torch.core.partitioner import make_plan  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.launch.specs import _sliced  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402

import repro_torch.configs as RC  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).parent))
import _torch_dryrun_ranks as R  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_KEYS = {"status", "arch", "shape", "mesh", "strategy", "n_devices",
            "microbatches", "prefill_chunks", "memory", "costs"}
MOE_CASES = [(a, lay) for a in ("phi3.5-moe-42b", "deepseek-v2-236b")
             for lay in ("mixserve", "dp_ep", "pure_tp")]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(R.rank_main, 4, workdir=tmp_path_factory.mktemp("rk"),
                     device="cpu", threads=1)


@pytest.mark.parametrize("case", R.CASES,
                         ids=[f"{a}-{lay}-sp{int(sp)}-{k}"
                              for a, lay, sp, k in R.CASES])
def test_meta_step_equals_real_step(ranks, case):
    for rank, out in enumerate(ranks):
        real, meta = out[case]["real"], out[case]["meta"]
        assert meta["calls"] == real["calls"], rank
        assert meta["bytes"] == real["bytes"], rank
        assert meta["argument_bytes"] == real["argument_bytes"], rank
        assert meta["flops"] == real["flops"], rank
    if case[1] != "pure_tp" or case[3] == "train":
        assert any(ranks[0][case]["real"]["bytes"].values())


@pytest.fixture(scope="module")
def ref_moe(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "moe.json"
    env = {"PYTHONPATH": f"{ROOT / 'src'}:{ROOT / 'tests'}",
           "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_ref_layouts.py"),
         "moe", str(out)], env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("arch,layout", MOE_CASES)
def test_moe_block_bytes_equal_reference_jaxpr(ref_moe, arch, layout):
    """The reference's shard_map body is one device's; so is ``moe_rank``
    on the rank's batch block (the port's ``moe_block`` adds the batch
    all_gather that GSPMD does outside the jaxpr)."""
    from repro_torch.kernels.policy import KernelPolicy
    cfg = RC.get_reduced(arch)
    plan = make_plan(layout, Mesh(("data", "model"), (2, 2), 0),
                     kernels=KernelPolicy.off())
    keep = plan.keep_hook(cfg)
    p = {k: torch.empty(_sliced(d.shape, keep(None, d)), device="meta")
         for k, d in M.moe_spec(cfg).items()}
    x = torch.empty(4, 8, cfg.d_model, device="meta")
    C.reset_counters()
    with torch.no_grad():
        M.moe_rank(p, plan.shard(x, ("batch", "seq", "embed")), cfg, plan)
    got = {f"{k[0]} {','.join(k[1])}": {"calls": n,
                                         "bytes": C.byte_counters[k]}
           for k, n in sorted(C.counters.items())}
    assert got == ref_moe[f"{arch}|{layout}"]


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b", "deepseek-v2-236b"])
def test_full_width_decode_fits_on_meta(arch):
    rec = dryrun.run_one(arch, "decode_32k", "single", "mixserve")
    assert rec["status"] == "ok" and REF_KEYS <= set(rec)
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes"}
    coll = rec["costs"]["collectives"]
    assert coll["bytes"]["total"] == sum(
        v for k, v in coll["bytes"].items() if k != "total") > 0
    assert set(coll["bytes"]) - {"total"} <= set(dryrun.KINDS.values())
    assert rec["n_devices"] == 256 and rec["kernels"] == "all-on"
    assert rec["peak_bytes"] == rec["memory"]["argument_bytes"] \
        + rec["memory"]["temp_bytes"]
    assert rec["fits"] and rec["peak_bytes"] <= dryrun.CARD_BYTES
    # every kernel of the served MoE path was priced
    assert {"grouped_gemm", "topk_gate", "flash_decode"} <= {
        k for k, v in rec["costs"]["kernels"].items() if v > 0}


def test_training_on_the_production_mesh_holds_no_whole_logits():
    """A training step on 256 ranks keeps each rank's block of the logits
    (the vocab-parallel loss): whisper-tiny's train_4k fits a card, where
    gathering the whole microbatch's logits on every rank took 128 GiB a
    rank; no collective a step moves the whole logits."""
    rec = dryrun.run_one("whisper-tiny", "train_4k", "single", "mixserve")
    cfg = RC.get("whisper-tiny")
    whole = 256 // rec["microbatches"] * 4096 * cfg.padded_vocab * 4
    assert rec["status"] == "ok" and rec["fits"]
    assert rec["memory"]["temp_bytes"] < whole
    groups = rec["costs"]["collectives"]["by_group"]
    assert all(v["bytes"] < whole // 16 for v in groups.values())


def test_cli_writes_one_record(tmp_path, capsys):
    assert dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k",
                        "--mesh", "multi", "--strategy", "mixserve",
                        "--out", str(tmp_path)]) == 0
    files = list(tmp_path.iterdir())
    assert [f.name for f in files] == \
        ["smollm-360m_decode_32k_multi_mixserve.json"]
    rec = json.loads(files[0].read_text())
    assert rec["status"] == "ok" and rec["n_devices"] == 512
    assert json.loads(capsys.readouterr().out) == rec
    assert dryrun.RESULTS_DIR.name == "dryrun_torch"


def test_unsupported_shape_is_skipped():
    rec = dryrun.run_one("gemma-2b", "long_500k", "single", "mixserve")
    assert rec["status"] == "skipped" and "sub-quadratic" in rec["reason"]


@pytest.mark.parametrize("idx", [0, 5, 30, -2])
def test_uniform_cache_write_reads_no_host_value(idx):
    """A 0-d offset writes its clamped slice, as the host slice did."""
    g = torch.Generator().manual_seed(1)
    buf = torch.randn(2, 8, 3, generator=g)
    new = torch.randn(2, 3, 3, generator=g)
    start = min(max(idx, 0), 8 - 3)
    want = buf.clone()
    want[:, start:start + 3] = new
    got = L.write_cache(buf.clone(), new, torch.tensor(idx))
    assert torch.equal(got, want)
    meta = L.write_cache(torch.empty(2, 8, 3, device="meta"),
                         torch.empty(2, 3, 3, device="meta"),
                         torch.zeros((), dtype=torch.int32, device="meta"))
    assert meta.shape == (2, 8, 3)


def test_decode_cache_write_reads_no_host_value():
    """One row a slot, a slot whose row lies outside the buffer untouched,
    on the meta device too."""
    g = torch.Generator().manual_seed(2)
    buf = torch.randn(4, 6, 2, 3, generator=g)
    new = torch.randn(4, 1, 2, 3, generator=g)
    idx = torch.tensor([0, 5, 6, -1], dtype=torch.int32)
    want = buf.clone()
    want[0, 0], want[1, 5] = new[0, 0], new[1, 0]
    assert torch.equal(L.write_cache(buf.clone(), new, idx), want)
    meta = L.write_cache(torch.empty(4, 6, 2, 3, device="meta"),
                         torch.empty(4, 1, 2, 3, device="meta"),
                         torch.empty(4, dtype=torch.int32, device="meta"))
    assert meta.shape == (4, 6, 2, 3)


CONSISTENCY = [(a, k) for a in ("smollm-360m", "rwkv6-1.6b",
                                 "recurrentgemma-9b")
               for k in R.SHAPES]


@pytest.mark.parametrize("arch,kind", CONSISTENCY)
def test_meta_costs_equal_the_same_mode_on_real_tensors(arch, kind):
    """``MetaCosts`` answers repeated functional ops on meta from memory;
    on real CPU tensors it runs every op.  The same step (zeros for
    inputs: token 0, empty caches) gives the same FLOPs, bytes accessed
    and peak either way, the recurrent families' per-token loops
    included."""
    from torch.utils._pytree import tree_leaves

    from repro_torch.core.partitioner import NULL_PLAN
    from repro_torch.launch.meta_costs import MetaCosts
    from repro_torch.launch.specs import input_specs
    cfg, shape = RC.get_reduced(arch), R.SHAPES[kind]
    got = []
    for dev in ("meta", "cpu"):
        args = input_specs(cfg, shape, NULL_PLAN, torch.float32,
                           device=dev)
        step = dryrun.make_step(cfg, shape, NULL_PLAN,
                                microbatches=R.MICROBATCHES,
                                prefill_chunks=R.PREFILL_CHUNKS)
        mode = MetaCosts(external=[t for t in tree_leaves(args)
                                   if isinstance(t, torch.Tensor)])
        with mode:
            step(*args)
        got.append((mode.flops, mode.bytes_accessed, mode.peak))
    assert got[0] == got[1] and got[0][2] > 0
