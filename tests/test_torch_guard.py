"""Guards of the port's boundaries: no JAX or reference import, no silent
CPU fallback, checked wrappers, and built kernels kept out of git."""

import ast
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from _kernel_calls import wrapper_calls  # noqa: E402
from repro_torch.analysis.rules.r4_kernel_contract import (  # noqa: E402
    kernel_contract_faults)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_compare.py",
    ROOT / "tools" / "phi_serve_ab.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [(ln, m) for ln, m in _imports(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path}: imports {bad}"


def test_serving_import_leaves_jax_unloaded():
    code = ("import sys; import repro_torch.serving.api; "
            "import repro_torch.kernels.ops, repro_torch.bridge; "
            "import repro_torch.launch.serve, repro_torch.launch.auto, "
            "repro_torch.serving.weights, repro_torch.examples.quickstart; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_never_fall_back_to_cpu(monkeypatch, capsys):
    """Without a card, the default device raises; only device="cpu" runs.
    The serve CLI exits non-zero, naming ``--device cpu``, before it
    resolves a spec or builds a model; the weight loader and the examples
    raise."""
    import importlib

    import repro_torch.configs as TC
    from repro_torch.launch import serve
    from repro_torch.serving.api import LLM, ServeSpec
    from repro_torch.serving.engine import resolve_device
    from repro_torch.serving.weights import load_llama_style
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = ServeSpec(arch="smollm-360m", max_batch=1, max_len=64, chunk=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLM.from_spec(spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"

    def built(*a, **k):
        raise AssertionError("the CLI went on without a device")
    monkeypatch.setattr(serve.ServeSpec, "resolve", built)
    monkeypatch.setattr(serve.LLM, "from_spec", built)
    with pytest.raises(SystemExit) as exit_:
        serve.main(["--arch", "smollm-360m", "--requests", "1"])
    assert exit_.value.code not in (0, None)
    assert "--device cpu" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_llama_style({}, TC.get_reduced("smollm-360m"))
    for name in ("quickstart", "serve_moe", "autotune_strategy",
                 "train_small"):
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mod.main([])


def _ops_source():
    src = (PORT / "kernels" / "ops.py").read_text()
    ref = ast.parse((PORT / "kernels" / "ref.py").read_text())
    return src, {n.name for n in ref.body if isinstance(n, ast.FunctionDef)}


_BUMPS = [i for i, line in enumerate(_ops_source()[0].splitlines())
          if line.strip().startswith("counters[")]


def test_every_kernel_wrapper_keeps_its_contract():
    src, ref_names = _ops_source()
    assert kernel_contract_faults(src, ref_names) == []
    # one bump a wrapper: the eight kernels' and flash_decode's
    assert len(_BUMPS) == len(wrapper_calls()) == 9
    # no launch path at all, and a wrapper without its plain body
    assert kernel_contract_faults(src.replace("def _launch(", "def _go("),
                                  ref_names)
    assert kernel_contract_faults(src, ref_names - {"topk_gate_ref"})


@pytest.mark.parametrize("line", _BUMPS)
def test_kernel_contract_check_catches_a_missing_bump(line):
    """The check fails on a copy of ops.py with one bump removed, doubled,
    or moved ahead of its function's first launching call."""
    import re
    src, ref_names = _ops_source()
    lines = src.splitlines()
    bump = lines[line]
    indent = bump[:len(bump) - len(bump.lstrip())]
    removed = lines[:line] + [indent + "pass"] + lines[line + 1:]
    assert kernel_contract_faults("\n".join(removed), ref_names)
    doubled = lines[:line] + [bump, bump] + lines[line + 1:]
    assert kernel_contract_faults("\n".join(doubled), ref_names)
    call = max(i for i in range(line)
               if re.search(r"\b(_launch|_gather|_flash_dense)\(", lines[i]))
    at = lines[call][:len(lines[call]) - len(lines[call].lstrip())]
    moved = (lines[:call] + [at + bump.lstrip()] + lines[call:line]
             + lines[line + 1:])
    assert kernel_contract_faults("\n".join(moved), ref_names)


def test_unported_options_raise(tmp_path):
    """The options a mesh once refused (the dense KV backend, the
    stateless forward, a model draft for speculative decoding, the legacy
    blocking path and with it the recurrent and frontend families) build
    on rank 0's plan of a 2x2 mesh and run on 4 gloo ranks; the MTP draft
    stub still raises, and the kernel policy's defaults hold."""
    import _torch_dist_helpers as H
    import repro_torch.configs as TC
    from repro_torch.core.partitioner import make_plan
    from repro_torch.core.resolve import KVConfig
    from repro_torch.kernels.policy import KernelPolicy
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.ranks import run_ranks
    from repro_torch.models import model as MOD
    from repro_torch.serving.api import LLM, ServeSpec
    from repro_torch.serving.draft import ModelDraft, make_draft
    from repro_torch.serving.kv_cache import DenseKVCache, make_kv_cache
    from repro_torch.core.resolve import SpeculationConfig
    cfg = TC.get_reduced("smollm-360m")
    mesh = Mesh(("data", "model"), (2, 2), 0)
    plan = make_plan("mixserve", mesh)
    kv = make_kv_cache(cfg, KVConfig(backend="dense"), 4, 64, torch.float32,
                       "cpu", plan=plan)
    assert isinstance(kv, DenseKVCache)
    # rank 0's rows (2 of 4); smollm's 15/5 heads do not split over TP 2
    assert tuple(kv.cache["groups"][0]["k"].shape) == (2, 2, 64, 5, 16)
    assert kv.cache["length"].shape == (4,)
    params = MOD.init_params(torch.Generator().manual_seed(0), cfg,
                             torch.float32, "cpu", plan=plan)
    for draft in ("self", "gemma-2b"):
        d = make_draft(SpeculationConfig(k=2, draft=draft), cfg, params,
                       plan=plan, dtype=torch.float32, device="cpu")
        assert isinstance(d, ModelDraft)
        assert d.plan.enabled == (draft == "self")
    assert make_draft(SpeculationConfig(k=2, draft="ngram"), cfg, params,
                      plan=plan).name == "ngram"
    with pytest.raises(NotImplementedError, match="MTP"):
        make_draft(SpeculationConfig(k=2, draft="mtp"), cfg, params,
                   plan=plan)
    for arch in ("whisper-tiny", "qwen2-vl-7b", "rwkv6-1.6b",
                 "recurrentgemma-9b"):
        llm = LLM.from_spec(ServeSpec(arch=arch, max_batch=4, max_len=64,
                                      chunk=8, kv="auto",
                                      strategy="mixserve"),
                            mesh=mesh, device="cpu")
        assert llm.engine.legacy and llm.engine.kv.backend == "dense"
        assert llm.engine.plan.enabled
    ranks = run_ranks(H.options_rank, 4, workdir=tmp_path, device="cpu",
                      threads=1, timeout_s=300)
    v = TC.get_reduced("smollm-360m").padded_vocab
    for r in ranks:
        assert r["stateless"] == (4, 8, v) and r["dense"] == (4, 8, v)
        assert r["dense_length"] == 8
        assert r["self"] == ranks[0]["self"] and set(r["self"]) == {0, 3}
        assert r["gemma-2b"] == ranks[0]["gemma-2b"]
        assert r["streams"] == ranks[0]["streams"]
    for arch, (streams, legacy, backend) in ranks[0]["streams"].items():
        assert [len(s) for s in streams] == [2, 2]
        assert backend == "dense" and legacy == (arch != "smollm-360m")
    assert KernelPolicy.auto("cpu") == KernelPolicy()
    assert KernelPolicy.auto("cuda") == KernelPolicy.parse("on")


def test_gitignore_lists_build_outputs():
    assert "build/" in (ROOT / ".gitignore").read_text().split()


def test_cached_build_reads_back_its_ptxas_report(tmp_path, monkeypatch):
    """A library found in the build cache still reports each source's
    ptxas summary, and a loaded library is reused as it is."""
    import json

    from repro_torch.kernels import build

    class _Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    cached = tmp_path / build.source_hash()
    cached.mkdir()
    (cached / build.LIB_NAME).write_bytes(b"")
    reports = {"topk_gate.cu": "ptxas info : Used 32 registers"}
    (cached / build.PTXAS_REPORT).write_text(json.dumps(reports))
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "build_info", {})
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: _Lib())
    lib = build.load()
    assert build.build_info["ptxas"] == reports
    assert build.build_info["dir"] == str(cached)
    assert build.load() is lib


def test_chip_smoke_refuses_without_card_or_port(tmp_path):
    """No result line, non-zero exit: alone in a directory, and (here) on a
    machine without a CUDA card."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((tmp_path, alone), (ROOT, ROOT / "chip_smoke.py")):
        if cwd == ROOT and torch.cuda.is_available():
            continue
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


def test_training_import_leaves_jax_unloaded():
    """The training path (data, optimizer, step, checkpoints, the CLI)
    loads neither JAX nor the reference package."""
    code = ("import sys; import repro_torch.data.pipeline, "
            "repro_torch.training.train_step, repro_torch.training.checkpoint,"
            " repro_torch.launch.train; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_every_kernel_wrapper_refuses_autograd_on_the_cpu(monkeypatch):
    """No kernel has a backward: under grad mode a wrapper given an input
    that requires grad raises before its CPU branch (the plain body, which
    autograd could differentiate, is not run either); under no_grad, or
    with no input requiring grad, it runs its plain body."""
    from repro_torch.kernels import ops, ref
    calls = wrapper_calls()
    helpers = {"flash_plan", "topk_plan", "moe_gemm_plan", "moe_gemm_split",
               "moe_gemm_bn", "grouped_gemm_visits", "permute_plan",
               "unpermute_plan", "counters", "reset_counters"}
    assert set(ops.__all__) - helpers == set(calls)
    ran = []
    for name in dir(ref):
        fn = getattr(ref, name)
        if callable(fn) and name.endswith("_ref"):
            def spy(*a, _fn=fn, _n=name, **k):
                ran.append(_n)
                return _fn(*a, **k)
            monkeypatch.setattr(ref, name, spy)
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name}: .*no backward"):
            call(True)
        assert not ran, (name, ran)
        with torch.no_grad():
            out = call(True)
        assert ran, name
        ran.clear()
        out = call(False)
        assert ran and not (out[0] if isinstance(out, tuple)
                            else out).requires_grad, name
        ran.clear()


def test_unconnected_mesh_refuses_a_real_collective():
    """The dry run's meta branch is taken for a meta input only: a CPU
    tensor on a mesh with no process group still raises, counted first."""
    from repro_torch.core import collectives as C
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh(("data", "model"), (2, 2), 0)
    C.reset_counters()
    with pytest.raises(RuntimeError, match="no process group"):
        C.psum(torch.ones(3), mesh, "model")
    out = C.all_gather(torch.ones(3, 2, device="meta"), mesh, "model",
                       axis=0)
    assert out.device.type == "meta" and out.shape == (6, 2)
    assert C.byte_counters[("all_gather", ("model",))] == 6 * 2 * 4
    C.reset_counters()
    assert not C.counters and not C.byte_counters


def test_every_kernel_wrapper_on_meta_launches_nothing(monkeypatch):
    """A meta tensor through every wrapper: outputs of the CUDA branch's
    shapes and dtypes on the meta device, no launch, no launch counted
    and the library never loaded; the compute kernels price their work."""
    from repro_torch.kernels import build, ops

    def no_build():
        raise AssertionError("a meta call reached the kernel library")
    monkeypatch.setattr(build, "load", no_build)
    ops.reset_counters()
    cpu = {n: call(False) for n, call in wrapper_calls().items()}
    for name, call in wrapper_calls("meta").items():
        out = call(False)
        for got, want in zip(*(o if isinstance(o, tuple) else (o,)
                               for o in (out, cpu[name]))):
            assert got.device.type == "meta", name
            assert (got.shape, got.dtype) == (want.shape, want.dtype), name
        assert ops.meta_bytes[name] > 0, name
        assert (ops.meta_flops[name] > 0) \
            == (not name.startswith("permute")), name
    assert not ops.counters
    ops.reset_counters()
    assert not ops.meta_flops and not ops.meta_bytes


def test_plain_grouped_gemm_on_meta_reads_no_offset():
    """The offsets are values the meta device does not hold: the plain
    body prices every row of its buffer (2 N H D) without reading them."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import ref
    x = torch.empty(37, 16, device="meta")
    w = torch.empty(5, 16, 8, device="meta")
    offsets = torch.empty(6, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="meta"):
        offsets.tolist()
    with FlopCounterMode(display=False) as fc:
        out = ref.grouped_gemm_ref(x, w, offsets)
    assert out.device.type == "meta" and out.shape == (37, 8)
    assert fc.get_total_flops() == 2 * 37 * 16 * 8


def test_reading_a_meta_routing_value_raises():
    """A plan whose exchange is count-bounded reads its overflow flag to
    the host: on the meta device that raises, and nothing guesses it."""
    import repro_torch.configs as RC
    from repro_torch.core.cost_model import EpOverlap
    from repro_torch.core.partitioner import make_plan
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.specs import _sliced
    from repro_torch.models import moe as M
    cfg = RC.get_reduced("phi3.5-moe-42b")
    plan = make_plan("mixserve", Mesh(("data", "model"), (2, 2), 0),
                     dispatch="dropless",
                     ep_overlap=EpOverlap(chunks=2, cap_rows=4))
    keep = plan.keep_hook(cfg)
    p = {k: torch.empty(_sliced(d.shape, keep(None, d)), device="meta")
         for k, d in M.moe_spec(cfg).items()}
    x = torch.empty(2, 8, cfg.d_model, device="meta")
    with torch.no_grad(), pytest.raises(RuntimeError, match="meta"):
        M.moe_rank(p, x, cfg, plan)
    # the monolithic exchange reads no value
    plan = make_plan("mixserve", plan.mesh, dispatch="dropless")
    with torch.no_grad():
        out, _aux = M.moe_rank(p, x, cfg, plan)
    assert out.device.type == "meta" and out.shape == x.shape
