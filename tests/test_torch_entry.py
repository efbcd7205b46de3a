"""The port's entry points against the reference's on the CPU: the serve
CLI (flags -> ServeSpec, the offline stage it prints, the online stage's
greedy tokens), ``auto_plan`` on the production layouts, the HF-style
weight loader, and the examples.

The reference's analyzer needs no mesh, so ``auto_plan`` is held to its
``analyzer.select`` and ``plan_name_for`` on the same cluster numbers; the
port plans on ``Mesh(..., connect=False)`` layouts in this process.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_helpers import both_params  # noqa: E402
import repro.configs as RC  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro.configs.base import INPUT_SHAPES as R_SHAPES  # noqa: E402
from repro.core import analyzer as RA  # noqa: E402
from repro.core import topology as RT  # noqa: E402
from repro.core.resolve import plan_name_for as r_plan_name  # noqa: E402
from repro.launch import serve as RS  # noqa: E402
from repro.models.model import forward as r_forward  # noqa: E402
from repro.serving import weights as RW  # noqa: E402
from repro.serving.api import LLM as RLLM  # noqa: E402
from repro.serving.scheduler import synthetic_workload as r_workload  # noqa: E402,E501
from repro_torch.configs.base import INPUT_SHAPES  # noqa: E402
from repro_torch.core import topology as TT  # noqa: E402
from repro_torch.core.partitioner import make_plan  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.launch.auto import auto_plan, cluster_for_mesh  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models.model import forward as t_forward  # noqa: E402
from repro_torch.models.model import model_spec  # noqa: E402
from repro_torch.serving import weights as TW  # noqa: E402
from repro_torch.serving.api import LLM as TLLM  # noqa: E402
from repro_torch.serving.scheduler import synthetic_workload as t_workload  # noqa: E402,E501

# --------------------------------------------------------------------------
# the serve CLI
# --------------------------------------------------------------------------

ARGVS = [
    [],
    ["--no-reduced", "--chunk", "8", "--dispatch", "capacity"],
    ["--speculation", "4", "--draft", "self"],
    ["--ep-overlap", "off"],
    ["--kv", "dense"],
    ["--strategy", "pure_tp"],
    ["--arch", "smollm-360m", "--max-batch", "2", "--token-budget", "24",
     "--speculation", "auto", "--cluster", "h20x16"],
]
# the CPU runs of main: every request due at once (``--rate 0``), so the
# batches, and with them the f32 sums, are the same in every run
RUN = ["--requests", "4", "--max-new", "4", "--rate", "0",
       "--cluster", "h20x16"]
# the provenance rows that differ by design: the kernel policy follows the
# port's device where the reference reads its JAX backend (kernels), and
# the port prints ``default(...)`` where the reference reads its autotune
# cache, here empty (chunk, max_batch, kv)
PROVENANCE = (("auto:backend(", "auto:device("),
              ("autotune:default(", "default("))


def _argv(extra):
    return (["--arch", "phi3.5-moe-42b"] if "--arch" not in extra else []) \
        + extra


def _fields(spec) -> dict:
    return {f.name: (dataclasses.asdict(v) if dataclasses.is_dataclass(v)
                     else v)
            for f in dataclasses.fields(spec)
            for v in (getattr(spec, f.name),)}


@pytest.fixture
def hermetic_autotune(monkeypatch):
    """The reference's resolver on its analytic defaults (no cache)."""
    from repro.kernels import autotune
    monkeypatch.setattr(autotune, "_CACHE", {})
    monkeypatch.setattr(autotune, "_persist_loaded", True)


@pytest.mark.parametrize("extra", ARGVS, ids=lambda a: " ".join(a) or "-")
def test_cli_builds_the_reference_spec(extra):
    argv = _argv(extra)
    r_args, t_args = RS.parse_args(argv), TS.parse_args(argv)
    assert t_args.device == "cuda"
    assert {k: v for k, v in vars(t_args).items() if k != "device"} \
        == vars(r_args)
    assert _fields(TS.build_spec(t_args)) == _fields(RS.build_spec(r_args))


def _reference_offline(argv) -> tuple:
    """(report, provenance) lines the reference's main prints for argv."""
    r = RS.build_spec(RS.parse_args(argv)).resolve(
        RC.get(RS.parse_args(argv).arch))
    text = r.describe()
    for a, b in PROVENANCE:
        text = text.replace(a, b)
    return r.report.describe(top=3), text


@pytest.mark.parametrize("arch", ["smollm-360m", "phi3.5-moe-42b",
                                  "rwkv6-1.6b"])
def test_main_on_the_cpu_prints_the_reference_offline_stage(
        arch, capsys, hermetic_autotune):
    argv = ["--arch", arch] + RUN
    sched = TS.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    report, describe = _reference_offline(argv)
    head = "== offline analyzer (theoretical, full config on h20x16) =="
    assert out.startswith(head + "\n" + report + "\n")
    assert "\n== resolved serving spec (provenance) ==\n" + describe + "\n" \
        in out
    assert "kernels       off" in describe and "auto:device(cpu)" in describe
    assert "\n== online measured (reduced config on cpu) ==\nn=4 " in out
    assert sorted(r.rid for r in sched.finished) == [0, 1, 2, 3]
    assert all(len(r.out_tokens) == 4 for r in sched.finished)
    legacy = f"[engine] {TC.get_reduced(arch).name}: family"
    assert (legacy in out) == (arch == "rwkv6-1.6b")
    assert sched.engine.legacy == (arch == "rwkv6-1.6b")


@pytest.mark.parametrize("arch", ["smollm-360m", "phi3.5-moe-42b"])
def test_online_stage_tokens_equal_the_reference(arch, hermetic_autotune):
    """The CLI's resolved specs on both sides, the reference's weights
    carried across, ``synthetic_workload(rate=0)``: the same greedy tokens
    for every request."""
    argv = ["--arch", arch] + RUN
    r_res = RS.build_spec(RS.parse_args(argv)).resolve(RC.get(arch))
    t_res = TS.build_spec(TS.parse_args(argv + ["--device", "cpu"])).resolve(
        TC.get(arch), device="cpu")
    assert (t_res.max_batch, t_res.chunk, t_res.token_budget,
            t_res.max_len, t_res.kv.pool_pages) == (
        r_res.max_batch, r_res.chunk, r_res.token_budget, r_res.max_len,
        r_res.kv.pool_pages)
    rcfg, rp, tcfg, tp = both_params(arch)
    work = dict(prompt_len=32, max_new_tokens=4, vocab=rcfg.vocab_size,
                arrival_rate=0.0, seed=0)
    r = RLLM.from_spec(r_res, cfg=rcfg, params=rp).serve(r_workload(4, **work))
    t = TLLM.from_spec(t_res, cfg=tcfg, params=tp, device="cpu").serve(
        t_workload(4, **work))
    want = {q.rid: [int(x) for x in q.out_tokens] for q in r.finished}
    got = {q.rid: [int(x) for x in q.out_tokens] for q in t.finished}
    assert len(want) == 4 and all(len(v) == 4 for v in want.values())
    assert got == want


# --------------------------------------------------------------------------
# auto_plan on the production layouts
# --------------------------------------------------------------------------

LAYOUTS = {"16x16": (("data", "model"), (16, 16)),
           "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
           "2x2": (("data", "model"), (2, 2))}
# (layout, cluster): a name the port defines, or None for the mesh-sized
# fallback (h100-256, h100-512, h100-2x2)
PLAN_CASES = [("16x16", "v5e-pod-256"), ("16x16", None),
              ("2x16x16", "v5e-2pods-512"), ("2x16x16", None),
              ("2x2", None)]


def _layout(name, rank=0):
    names, sizes = LAYOUTS[name]
    return Mesh(names, sizes, rank)


@pytest.mark.parametrize("layout,cluster", PLAN_CASES,
                         ids=lambda v: str(v))
@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k", "train_4k"])
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "phi3.5-moe-42b",
                                  "gemma-2b"])
def test_auto_plan_picks_the_reference_analyzers_layout(layout, cluster,
                                                        shape, arch):
    mesh = _layout(layout)
    cfg, rcfg = TC.get(arch), RC.get(arch)
    plan, rep = auto_plan(cfg, mesh, INPUT_SHAPES[shape], cluster=cluster)
    t_cl = cluster_for_mesh(mesh, cluster)
    assert t_cl.n_devices == mesh.size
    r_cl = RT.ClusterSpec(**dataclasses.asdict(t_cl))
    s = R_SHAPES[shape]
    l_out = 256 if s.kind == "decode" else 1
    want = RA.select(rcfg, r_cl, batch=s.global_batch,
                     l_in=min(s.seq_len, 8192), l_out=l_out).best.strategy
    best = rep.best.strategy
    assert best.describe() == want.describe()
    assert dataclasses.asdict(best) == dataclasses.asdict(want)
    name = r_plan_name(rcfg, want, mesh.size)
    want_plan = make_plan(name, mesh, comm_algo=want.comm_algo)
    assert plan.enabled and plan.rules == want_plan.rules
    assert plan.comm_algo == want_plan.comm_algo    # dp_ep runs unfused
    if cfg.is_moe and cfg.n_experts % mesh.size:
        assert plan.rules["expert"] == ("data",), (arch, shape)


def test_cluster_for_mesh():
    m256, m4 = _layout("16x16"), _layout("2x2")
    assert cluster_for_mesh(m4).name == "h100-2x2"
    assert cluster_for_mesh(Mesh(("data", "model"), (1, 1))).name == "h100x1"
    c256 = cluster_for_mesh(m256)
    assert (c256.name, c256.n_node, c256.n_proc) == ("h100-256", 32, 8)
    c8 = cluster_for_mesh(Mesh(("data", "model"), (1, 8)))
    assert (c8.name, c8.n_node, c8.n_proc) == ("h100-8", 1, 8)
    x1 = TT.H100_X1
    for c in (c8, c256, cluster_for_mesh(_layout("2x16x16"))):
        assert (c.peak_flops, c.hbm_bw, c.hbm_bytes, c.intra_node_bw) == (
            x1.peak_flops, x1.hbm_bw, x1.hbm_bytes, x1.intra_node_bw)
        assert c.inter_node_bw == 400e9 / 8          # one 400 Gb/s NIC a card
    # an explicit name or spec wins, validated against the mesh's size
    assert cluster_for_mesh(m256, "v5e-pod-256") is TT.TPU_V5E_POD
    assert cluster_for_mesh(m4, TT.H100_2X2) is TT.H100_2X2
    with pytest.raises(ValueError, match="has 256 devices but the mesh has 4"):
        cluster_for_mesh(m4, "v5e-pod-256")
    with pytest.raises(KeyError, match="unknown cluster"):
        cluster_for_mesh(m4, "h100-4")
    with pytest.raises(ValueError, match="multiple of 8"):
        cluster_for_mesh(Mesh(("data", "model"), (2, 3)))
    with pytest.raises(ValueError, match="multiple of 8"):
        TT.h100_cluster(12)


# --------------------------------------------------------------------------
# the HF-style weight loader
# --------------------------------------------------------------------------

LLAMA_ARCHS = ["smollm-360m", "minitron-8b", "gemma-2b", "qwen2-vl-7b"]


def _pairs(a, b, path=()):
    """(path, leaf of a, leaf of b) over two trees of one structure."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            yield from _pairs(a[k], b[k], path + (k,))
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _pairs(x, y, path + (i,))
    else:
        yield path, a, b


@pytest.fixture(scope="module", params=LLAMA_ARCHS)
def llama(request):
    return both_params(request.param)


def test_export_equals_the_reference_bitwise(llama):
    rcfg, rp, tcfg, tp = llama
    want = RW.export_llama_style(rp, rcfg)
    got = TW.export_llama_style(tp, tcfg)
    assert list(got) == list(want)
    for k, v in want.items():
        g = got[k]
        assert g.device.type == "cpu" and g.is_contiguous()
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(v), err_msg=k)
    assert got["model.layers.0.self_attn.q_proj.weight"].shape == (
        tcfg.n_heads * tcfg.head_dim, tcfg.d_model)
    assert got["model.embed_tokens.weight"].shape[0] == tcfg.vocab_size
    assert ("lm_head.weight" in got) == (not tcfg.tie_embeddings)


def test_load_equals_the_reference_load_bitwise(llama):
    from repro_torch.bridge import from_reference
    rcfg, rp, tcfg, tp = llama
    flat = RW.export_llama_style(rp, rcfg)
    want = from_reference(jax.tree.map(np.asarray,
                                       RW.load_llama_style(flat, rcfg)), tcfg)
    for tensors in (False, True):
        src = {k: torch.from_numpy(np.array(v)) for k, v in flat.items()} \
            if tensors else flat
        got = TW.load_llama_style(src, tcfg, device="cpu")
        for path, g, w in _pairs(got, want):
            assert g.dtype == torch.float32 and g.is_contiguous(), path
            assert torch.equal(g, w), path
    # the load owns its leaves: writing one leaves the flat dict as it was
    src = {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}
    got = TW.load_llama_style(src, tcfg, device="cpu")
    got["final_norm"].add_(1.0)
    np.testing.assert_array_equal(src["model.norm.weight"].numpy(),
                                  np.asarray(flat["model.norm.weight"]))


def test_loaded_tree_gives_the_original_logits(llama):
    rcfg, rp, tcfg, tp = llama
    loaded = TW.load_llama_style(TW.export_llama_style(tp, tcfg), tcfg,
                                 device="cpu")
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, 12))
    t = torch.from_numpy(toks.astype(np.int64))
    with torch.no_grad():
        a = t_forward(tp, tcfg, tokens=t).logits
        b = t_forward(loaded, tcfg, tokens=t).logits
    assert torch.equal(a, b)
    want = np.asarray(r_forward(rp, rcfg, tokens=toks.astype(np.int32)).logits)
    np.testing.assert_allclose(b.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("rank", range(4))
def test_mesh_load_keeps_each_ranks_block(llama, rank):
    rcfg, rp, tcfg, tp = llama
    flat = TW.export_llama_style(tp, tcfg)
    whole = TW.load_llama_style(flat, tcfg, device="cpu")
    plan = make_plan("mixserve", Mesh(("data", "model"), (2, 2), rank))
    keep = plan.keep_hook(tcfg)
    got = TW.load_llama_style(flat, tcfg, plan=plan, device="cpu")
    spec = model_spec(tcfg)
    specs = {path: p for path, p, _ in _pairs(spec, spec)}
    cut = 0
    for path, g, w in _pairs(got, whole):
        sl = keep(path, specs[path])
        cut += sl is not None
        want = w if sl is None else w[sl]
        assert g.is_contiguous() and torch.equal(g, want), path
    assert cut > 0


def test_loader_refuses_other_families():
    rcfg, tcfg = RC.get_reduced("deepseek-v2-236b"), \
        TC.get_reduced("deepseek-v2-236b")
    with pytest.raises(AssertionError):
        RW.export_llama_style({}, rcfg)
    with pytest.raises(AssertionError):
        RW.load_llama_style({}, rcfg)
    for call in (lambda: TW.export_llama_style({}, tcfg),
                 lambda: TW.load_llama_style({}, tcfg, device="cpu")):
        with pytest.raises(ValueError, match="not a llama-family"):
            call()


# --------------------------------------------------------------------------
# the examples
# --------------------------------------------------------------------------

EXAMPLES = {
    "quickstart": [],
    "autotune_strategy": ["--l-in", "256", "--l-out", "16"],
    "serve_moe": ["--requests", "6", "--rate", "0", "--system-len", "16"],
    "train_small": ["--steps", "2", "--batch", "2", "--seq", "16"],
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name, capsys):
    import importlib
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    out = mod.main(EXAMPLES[name] + ["--device", "cpu"])
    text = capsys.readouterr().out
    if name == "quickstart":
        llm, outs = out
        assert "on h20x16" in text and [len(o) for o in outs] == [8, 8, 8]
    elif name == "autotune_strategy":
        assert sorted(out) == sorted(TC.ARCH_IDS)
        assert all(r.cluster == "h20x16" for r in out.values())
    elif name == "serve_moe":
        assert "[h20x16]" in text and "[910bx32]" in text
        assert len(out.finished) == 6 and out.metrics().n_incomplete == 0
    else:
        assert len(out) == 2 and all(np.isfinite(m["loss"]) for m in out)
    assert "v5e" not in text and "TPU" not in text
