"""The port's autotune cache (``repro_torch.kernels.autotune``) against the
reference's cache semantics, the wrappers' plans, and the resolver's
provenance against the reference's ``core/resolve.py``.

Every test points ``REPRO_TORCH_AUTOTUNE_CACHE`` at ``tmp_path`` or at
``""`` and starts from an empty in-process cache (the ``clean`` fixture),
so no developer's file is read or written.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.configs as TC  # noqa: E402
import repro_torch.configs.paper_models  # noqa: E402,F401
from repro.configs.paper_models import PAPER_MODELS as R_PAPER  # noqa: E402
from repro.core import resolve as RR  # noqa: E402
from repro.core import topology as RT  # noqa: E402
from repro.kernels import autotune as R_AT  # noqa: E402
from repro.serving.api import ServeSpec as RSpec  # noqa: E402
from repro_torch.core import resolve as TR  # noqa: E402
from repro_torch.core import topology as TT  # noqa: E402
from repro_torch.kernels import autotune as AT  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving.api import ServeSpec as TSpec  # noqa: E402

RESOLVE_ARCHS = list(TC.ARCH_IDS) + sorted(TC.paper_models.PAPER_MODELS)
PAGE, CAP, SLACK = 32, 4, 25      # the registrations both sides get


@pytest.fixture
def clean(monkeypatch):
    """Empty in-process caches on both sides, persistence off on both."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", "")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", "")
    monkeypatch.setattr(AT, "_CACHE", {})
    monkeypatch.setattr(AT, "_ANALYTIC", set())
    monkeypatch.setattr(AT, "_persist_loaded", False)
    monkeypatch.setattr(R_AT, "_CACHE", {})
    monkeypatch.setattr(R_AT, "_persist_loaded", False)


def _at(path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    AT.clear_cache()


# ---------------------------------------------------------------------------
# the reference's cache semantics (tests/test_kernels.py), held on the port
# ---------------------------------------------------------------------------

def test_selection_is_cached_and_register_overrides(clean):
    shape = (16, 80, 4096, 6400)
    plan = AT.select_plan("moe_gemm", shape, torch.bfloat16)
    assert plan == {"ctas": ops.moe_gemm_plan(*shape)[0]}
    assert AT.select_plan("moe_gemm", shape, torch.bfloat16) == plan
    assert len(AT.cache_info()) == 1
    assert AT.lookup("moe_gemm", shape, torch.bfloat16) is None
    AT.register("moe_gemm", shape, torch.bfloat16, {"ctas": 66})
    assert AT.select_plan("moe_gemm", shape, torch.bfloat16) == {"ctas": 66}
    assert AT.lookup("moe_gemm", shape, torch.bfloat16) == {"ctas": 66}


@pytest.mark.parametrize("op,shape,dtype,plan", [
    ("flash", (4, 64, 32, 8, 128, 128), "bfloat16",
     dict(zip(("rows", "n_split"), ops.flash_plan(4, 64, 32, 8, 128, 128)))),
    ("flash", (4, 1, 8, 1, 256, 256), "bfloat16",
     dict(zip(("rows", "n_split"), ops.flash_plan(4, 1, 8, 1, 256, 256)))),
    ("flash", (1, 1, 128, 1, 576, 512), "bfloat16",
     dict(zip(("rows", "n_split"), ops.flash_plan(1, 1, 128, 1, 576, 512)))),
    ("topk_gate", (512, 16), "bfloat16", {"warps": ops.topk_plan(512, 16)[1]}),
    ("topk_gate", (3, 160), "float32", {"warps": ops.topk_plan(3, 160)[1]}),
    ("moe_gemm", (2, 5, 64, 48), "float32",
     {"ctas": ops.moe_gemm_plan(2, 5, 64, 48)[0]}),
    ("unpermute_tokens", (256, 2, 4096), "bfloat16",
     {"rows": ops.unpermute_plan(256, 2, 8192, 2)[2]}),
    ("unpermute_tokens", (7, 6, 100), "float32",
     {"rows": ops.unpermute_plan(7, 6, 400, 4)[2]}),
])
def test_no_registration_gives_the_analytic_plan(clean, op, shape, dtype,
                                                 plan):
    assert AT.select_plan(op, shape, dtype) == plan
    assert AT.lookup(op, shape, dtype) is None


def test_tune_registers_under_the_wrappers_key(clean):
    """On the CPU the wrappers run their plain bodies: ``tune`` proves the
    key (and the skip of refused plans), not a speed."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 8, 64), np.float32))
    w = torch.from_numpy(rng.standard_normal((2, 64, 48), np.float32))
    units = ops.moe_gemm_plan(2, 8, 64, 48)[1]
    cands = [{"ctas": 1}, {"ctas": units}, {"ctas": units + 1}]
    times = []
    best = AT.tune("moe_gemm", ops.moe_gemm, cands, x, w, timings=times)
    assert best in cands[:2]
    assert [ms is None for _, ms in times] == [False, False, True]
    assert AT.lookup("moe_gemm", (2, 8, 64, 48), torch.float32) == best
    assert AT.select_plan("moe_gemm", AT.key_shape("moe_gemm", (x, w)),
                          x.dtype) == best


def test_tune_keys_of_every_tuned_wrapper(clean):
    q = torch.zeros(2, 3, 8, 16)
    k = torch.zeros(2, 40, 2, 16)
    v = torch.zeros(2, 40, 2, 24)
    assert AT.key_shape("flash", (q, k, v)) == (2, 3, 8, 2, 16, 24)
    pages = torch.zeros(10, 4, 2, 16)
    assert AT.key_shape("flash", (q, pages, torch.zeros(10, 4, 2, 24))) \
        == (2, 3, 8, 2, 16, 24)
    assert AT.key_shape("flash", (q[:, 0], k, v)) == (2, 1, 8, 2, 16, 24)
    assert AT.key_shape("topk_gate", (torch.zeros(9, 5), 2)) == (9, 5)
    assert AT.key_shape("unpermute_tokens", (
        torch.zeros(12, 40), torch.zeros(6, 2, dtype=torch.int32),
        torch.zeros(6, 2))) == (6, 2, 40)


def test_persisted_registration_survives_and_a_version_skew_drops_it(
        clean, tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    _at(path, monkeypatch)
    shape = (4, 64, 32, 8, 128, 128)
    AT.register("flash", shape, torch.bfloat16, {"rows": 64, "n_split": 3})
    payload = json.loads(path.read_text())
    assert payload == {"version": AT.CACHE_VERSION, "entries": {
        "flash|4,64,32,8,128,128|bfloat16": {"n_split": 3, "rows": 64}}}
    AT.clear_cache()                                 # a new process
    assert AT.select_plan("flash", shape, "bfloat16") == {"rows": 64,
                                                          "n_split": 3}
    payload["version"] = AT.CACHE_VERSION + 1        # another schema
    path.write_text(json.dumps(payload))
    AT.clear_cache()
    assert AT.lookup("flash", shape, "bfloat16") is None
    assert AT.select_plan("flash", shape, "bfloat16") == dict(
        zip(("rows", "n_split"), ops.flash_plan(*shape)))
    # analytic plans are never written
    assert json.loads(path.read_text())["version"] == AT.CACHE_VERSION + 1


def test_empty_variable_disables_persistence(clean, tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", "")
    assert AT.cache_path() is None
    monkeypatch.setenv("HOME", str(tmp_path))
    AT.register("topk_gate", (64, 16), torch.bfloat16, {"warps": 4})
    AT.tune("topk_gate", ops.topk_gate, [{"warps": 1}],
            torch.zeros(64, 16), 2)
    assert not any(tmp_path.rglob("*.json"))
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE")
    assert AT.cache_path() == str(tmp_path / ".cache" / "repro_torch"
                                  / "autotune.json")


def test_in_memory_entry_beats_the_file(clean, tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    _at(path, monkeypatch)
    AT.register("topk_gate", (64, 16), torch.bfloat16, {"warps": 4})
    AT.clear_cache()
    AT.register("topk_gate", (64, 16), torch.bfloat16, {"warps": 2},
                persist=False)
    assert AT.load_persistent() == 0
    assert AT.select_plan("topk_gate", (64, 16), torch.bfloat16) \
        == {"warps": 2}
    assert json.loads(path.read_text())["entries"] == {
        "topk_gate|64,16|bfloat16": {"warps": 4}}


def test_dtype_spellings_give_one_key(clean):
    keys = {AT.cache_key("flash", (1, 2, 3, 4, 5, 6), d)
            for d in (torch.bfloat16, "bfloat16", "torch.bfloat16")}
    assert len(keys) == 1
    AT.register("unpermute_tokens", (8, 2, 64), torch.float32, {"rows": 1})
    for d in (torch.float32, "float32", np.float32, np.dtype("float32")):
        assert AT.lookup("unpermute_tokens", (8, 2, 64), d) == {"rows": 1}
    assert AT.plan_for("unpermute_tokens", (8, 2, 64), torch.float32) \
        == {"rows": 1}


def test_port_and_reference_never_read_each_others_file(clean, tmp_path,
                                                        monkeypatch):
    """Each package's file holds its own entries only, and neither reads the
    other's, whatever the other's variable points at."""
    import jax.numpy as jnp
    t_path, r_path = tmp_path / "port.json", tmp_path / "ref.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(t_path))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(r_path))
    AT.register("moe_gemm", (2, 8, 64, 48), torch.float32, {"ctas": 1})
    R_AT.register("moe_gemm", (2, 8, 64, 48), jnp.float32,
                  {"bc": 8, "bd": 48, "bh": 64})
    t_file, r_file = (json.loads(p.read_text()) for p in (t_path, r_path))
    assert t_file["version"] == AT.CACHE_VERSION
    assert r_file["version"] == R_AT.CACHE_VERSION
    assert t_file["entries"] == {"moe_gemm|2,8,64,48|float32": {"ctas": 1}}
    assert list(r_file["entries"]) == ["moe_gemm|2,8,64,48|float32"]
    assert r_file["entries"]["moe_gemm|2,8,64,48|float32"] \
        == {"bc": 8, "bd": 48, "bh": 64}
    # swap the variables' files: each side drops the other's schema
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(r_path))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(t_path))
    AT.clear_cache()
    R_AT.clear_cache()
    assert AT.lookup("moe_gemm", (2, 8, 64, 48), torch.float32) is None
    assert R_AT.lookup("moe_gemm", (2, 8, 64, 48), jnp.float32) is None
    # and with only the reference's variable set, the port's own default
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE")
    assert "repro_torch" in AT.cache_path()
    assert AT.cache_path() != str(t_path)


# ---------------------------------------------------------------------------
# the file is best effort, as the reference's is
# ---------------------------------------------------------------------------

FLASH_KEY = (4, 64, 32, 8, 128, 128)
GOOD = ("topk_gate|64,16|bfloat16", {"warps": 2})     # beside every bad one
# an entry this checkout cannot use: (key string, plan)
FOREIGN = {
    "unknown_op": ("grouped_gemm|8,4096,3200|bfloat16", {"bm": 64}),
    "one_bar": ("flash|4,64,32,8,128,128", {"rows": 64, "n_split": 2}),
    "non_integer_shape": ("flash|4,x64,32,8,128,128|bfloat16",
                          {"rows": 64, "n_split": 2}),
    "list_plan": ("flash|4,64,32,8,128,128|bfloat16", [64, 2]),
}


def _write_file(path, version, entries):
    path.write_text(json.dumps({"version": version, "entries": entries}))


@pytest.mark.parametrize("case", sorted(FOREIGN))
def test_a_foreign_or_malformed_entry_is_skipped_by_both(clean, tmp_path,
                                                         monkeypatch, case):
    """The same entries in each package's own file: both resolve a serve
    on it, the port skips the entry and adopts the good one beside it, and
    the analytic plan serves the key the entry would have named."""
    ks, plan = FOREIGN[case]
    entries = dict([(ks, plan), GOOD])
    t_path, r_path = tmp_path / "port.json", tmp_path / "ref.json"
    _write_file(t_path, AT.CACHE_VERSION, entries)
    _write_file(r_path, R_AT.CACHE_VERSION, entries)
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(t_path))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(r_path))
    _, t_cl = _clusters("h100x1")
    r = RSpec(arch="smollm-360m").resolve()
    t = TSpec(arch="smollm-360m").resolve(cluster=t_cl, device="cpu")
    assert t.max_batch > 0 and r.max_batch > 0
    R_AT.clear_cache()
    assert R_AT.load_persistent() == (1 if case in ("one_bar", "list_plan",
                                                    "non_integer_shape")
                                      else 2)
    AT.clear_cache()
    assert AT.load_persistent() == 1
    assert AT.lookup("topk_gate", (64, 16), "bfloat16") == GOOD[1]
    assert AT.lookup("flash", FLASH_KEY, "bfloat16") is None
    assert AT.select_plan("flash", FLASH_KEY, "bfloat16") == dict(
        zip(("rows", "n_split"), ops.flash_plan(*FLASH_KEY)))
    assert {k.op for k in AT.cache_info()} == {"topk_gate", "flash"}


def test_a_refused_plan_of_a_known_op_in_the_file_raises(clean, tmp_path,
                                                         monkeypatch):
    """The one entry that is not skipped: a dict plan of a known op that
    the kernel would refuse is a fault of this schema's writer, named with
    the file and the entry."""
    path = tmp_path / "port.json"
    _write_file(path, AT.CACHE_VERSION, {"topk_gate|64,16|bfloat16":
                                         {"warps": 3}})
    _at(path, monkeypatch)
    with pytest.raises(ValueError, match="topk_gate.64,16.bfloat16"):
        AT.load_persistent()


def test_an_unwritable_path_still_registers_in_both(clean, tmp_path,
                                                    monkeypatch):
    """A cache path under a regular file: ``register`` returns in both
    packages with the plan in the process's cache, ``tune`` returns its
    winner, and both still resolve a serve."""
    import jax.numpy as jnp
    (tmp_path / "file").write_text("not a folder")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "file" / "port.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE",
                       str(tmp_path / "file" / "ref.json"))
    AT.register("topk_gate", (64, 16), torch.bfloat16, {"warps": 2})
    R_AT.register("moe_gemm", (2, 8, 64, 48), jnp.float32,
                  {"bc": 8, "bd": 48, "bh": 64})
    assert AT.cache_info()[AT.cache_key("topk_gate", (64, 16),
                                        "bfloat16")] == {"warps": 2}
    assert R_AT.cache_key("moe_gemm", (2, 8, 64, 48), jnp.float32) \
        in R_AT.cache_info()
    best = AT.tune("topk_gate", ops.topk_gate, [{"warps": 1}],
                   torch.zeros(32, 16), 2)
    assert best == {"warps": 1}
    assert AT.lookup("topk_gate", (32, 16), torch.float32) == best
    _, t_cl = _clusters("h100x1")
    RSpec(arch="smollm-360m").resolve()
    TSpec(arch="smollm-360m").resolve(cluster=t_cl, device="cpu")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["file"]


def test_a_failed_replace_leaves_no_temp_file(clean, tmp_path, monkeypatch):
    """An ``OSError`` after the temp file is made removes it and leaves
    the file as it was."""
    import os
    path = tmp_path / "autotune.json"
    _at(path, monkeypatch)
    AT.register("topk_gate", (64, 16), torch.bfloat16, {"warps": 2})
    before = path.read_text()

    def refuse(src, dst):
        raise PermissionError(13, "read-only", dst)
    monkeypatch.setattr(os, "replace", refuse)
    AT.register("topk_gate", (64, 16), torch.bfloat16, {"warps": 4})
    assert AT.lookup("topk_gate", (64, 16), torch.bfloat16) == {"warps": 4}
    assert path.read_text() == before
    assert [p.name for p in tmp_path.iterdir()] == ["autotune.json"]


# ---------------------------------------------------------------------------
# the resolver tier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", RESOLVE_ARCHS)
def test_resolver_keys_equal_the_reference(name):
    import repro.configs as RC
    paper = name in R_PAPER
    r_cfg = R_PAPER[name] if paper else RC.get(name)
    t_cfg = TC.paper_models.PAPER_MODELS[name] if paper else TC.get(name)
    for max_len in (64, 1088, 4096, 32768):
        assert TR.kv_page_key(t_cfg, max_len) == RR.kv_page_key(r_cfg,
                                                                max_len)
    assert TR.resolver_key() == RR.resolver_key() == ()


def _clusters(cluster):
    t_cl = TT.CLUSTERS[cluster]
    r_cl = RT.CLUSTERS.get(cluster) or RT.ClusterSpec(
        **dataclasses.asdict(t_cl))
    return r_cl, t_cl


def _resolve_both(name, r_cl, t_cl, kw):
    paper = name in R_PAPER
    r_cfg = R_PAPER[name] if paper else None
    t_cfg = TC.paper_models.PAPER_MODELS[name] if paper else None
    r = RSpec(arch=None if paper else name, **kw).resolve(r_cfg,
                                                          cluster=r_cl)
    t = TSpec(arch=None if paper else name, **kw).resolve(
        t_cfg, cluster=t_cl, device="cpu")
    return r, t


def _register_both(name, max_len):
    import repro.configs as RC
    paper = name in R_PAPER
    r_cfg = R_PAPER[name] if paper else RC.get(name)
    t_cfg = TC.paper_models.PAPER_MODELS[name] if paper else TC.get(name)
    R_AT.register("kv_page", RR.kv_page_key(r_cfg, max_len), "bfloat16",
                  {"page": PAGE}, persist=False)
    R_AT.register("resolver", RR.resolver_key(), "host",
                  {"batch_cap": CAP, "itl_slack_pct": SLACK}, persist=False)
    AT.register("kv_page", TR.kv_page_key(t_cfg, max_len), "bfloat16",
                {"page": PAGE}, persist=False)
    AT.register("resolver", TR.resolver_key(), "host",
                {"batch_cap": CAP, "itl_slack_pct": SLACK}, persist=False)


AUTOTUNED = ("chunk", "max_batch", "kv")     # the rows that read the cache


@pytest.mark.parametrize("registered", [False, True],
                         ids=["empty", "registered"])
@pytest.mark.parametrize("cluster", ["h20x16", "h100x1"])
@pytest.mark.parametrize("name", RESOLVE_ARCHS)
def test_resolved_spec_and_provenance_equal_the_reference(clean, name,
                                                          cluster,
                                                          registered):
    """Empty caches on both sides give ``autotune:default(...)``; the same
    kv_page and resolver registrations in both give ``autotune:measured``
    and the same knobs.  Every provenance row but the kernel policy's (the
    port follows its device, the reference its JAX backend) is equal."""
    r_cl, t_cl = _clusters(cluster)
    for kw in (dict(), dict(prompt_len=1024, max_new_tokens=32,
                            arrival_rate=4.0), dict(chunk=16)):
        r, t = _resolve_both(name, r_cl, t_cl, kw)
        if registered:
            _register_both(name, r.max_len)
            r, t = _resolve_both(name, r_cl, t_cl, kw)
        assert t.max_len == r.max_len
        for f in ("strategy", "chunk", "token_budget", "max_batch",
                  "max_len", "dispatch"):
            assert getattr(t, f) == getattr(r, f), f
        assert t.kv.describe() == r.kv.describe()
        t_prov = {k: v.replace("auto:device(", "auto:backend(")
                  for k, v in t.provenance.items()}
        assert t_prov == r.provenance
        rows = " ".join(t.provenance[f] for f in AUTOTUNED)
        assert ("autotune:measured" in rows) == registered
        assert ("autotune:default(" in rows) != registered
        assert f"[autotune:{'measured' if registered else 'default(8)'}]" \
            in t.provenance["max_batch"]


def test_registered_page_reaches_the_paged_kv(clean):
    _, t_cl = _clusters("h100x1")
    spec = TSpec(arch="phi3.5-moe-42b")
    base = spec.resolve(cluster=t_cl, device="cpu")
    assert base.kv.page_size == TR.KV_PAGE_SIZE
    assert "autotune:default(16)" in base.provenance["kv"]
    AT.register("kv_page", TR.kv_page_key(TC.get("phi3.5-moe-42b"),
                                          base.max_len), "bfloat16",
                {"page": PAGE}, persist=False)
    AT.register("resolver", (), "host", {"batch_cap": CAP,
                                         "itl_slack_pct": SLACK},
                persist=False)
    got = spec.resolve(cluster=t_cl, device="cpu")
    assert got.kv.page_size == PAGE
    assert "page 32 from autotune:measured" in got.provenance["kv"]
    assert got.max_batch <= CAP


# ---------------------------------------------------------------------------
# plans the kernels refuse, and the plan a wrapper launches
# ---------------------------------------------------------------------------

def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _i32(*shape):
    return torch.empty(*shape, dtype=torch.int32, device="meta")


def _invalid_calls():
    q, k = _meta(4, 64, 32, 128), _meta(4, 1024, 8, 128)
    pages = _meta(300, 16, 8, 128)
    lens = _i32(4)
    return [
        ("flash n_split 17", lambda: ops.flash_chunk(q, k, k, lens, lens,
                                                      lens, n_split=17)),
        ("flash paged n_split 17", lambda: ops.flash_chunk_paged(
            q, pages, pages, _i32(4, 64), lens, lens, lens, n_split=17)),
        ("flash decode rows 128 at hd 576", lambda: ops.flash_decode(
            _meta(4, 128, 576), _meta(4, 64, 1, 576), _meta(4, 64, 1, 512),
            lens, rows=128)),
        ("flash f32 body", lambda: ops.flash_chunk(
            *(t.float() for t in (q, k, k)), lens, lens, lens, rows=64)),
        ("topk 3 warps", lambda: ops.topk_gate(_meta(256, 16), 2, warps=3)),
        ("moe_gemm ctas > units", lambda: ops.moe_gemm(
            _meta(2, 8, 64), _meta(2, 64, 48),
            ctas=ops.moe_gemm_plan(2, 8, 64, 48)[1] + 1)),
        ("moe_gemm ctas > SMS", lambda: ops.moe_gemm(
            _meta(16, 80, 4096), _meta(16, 4096, 6400), ctas=ops.SMS + 1)),
        ("unpermute rows 2 at k 4", lambda: ops.unpermute_tokens(
            _meta(64, 128), _i32(16, 4), _meta(16, 4, dtype=torch.float32),
            rows=2)),
    ]


@pytest.mark.parametrize("case", range(len(_invalid_calls())),
                         ids=[c[0] for c in _invalid_calls()])
def test_a_plan_the_kernel_refuses_raises_before_any_launch(clean, case):
    ops.reset_counters()
    _, call = _invalid_calls()[case]
    with pytest.raises(ValueError):
        call()
    assert not ops.counters and not ops.meta_flops     # nothing launched
    # a pinned attention knob reads the key's plan for the other one
    assert all(k.op == "flash" for k in AT.cache_info())


@pytest.mark.parametrize("op,plan", [
    ("flash", {"rows": 64, "n_split": 17}), ("topk_gate", {"warps": 3}),
    ("moe_gemm", {"ctas": 10_000}), ("unpermute_tokens", {"rows": 2})])
def test_register_refuses_what_the_kernel_refuses(clean, op, plan):
    shape = {"flash": (4, 64, 32, 8, 128, 128), "topk_gate": (256, 16),
             "moe_gemm": (2, 8, 64, 48), "unpermute_tokens": (16, 4, 128)}
    with pytest.raises(ValueError):
        AT.register(op, shape[op], "bfloat16", plan, persist=False)
    assert AT.lookup(op, shape[op], "bfloat16") is None


def _scratch_elems(fn):
    """The float32 allocations ``fn`` makes through torch.empty (the split
    scratch of the attention wrappers)."""
    seen = []
    real = torch.empty

    def spy(*shape, **kw):
        out = real(*shape, **kw)
        if out.dtype == torch.float32:
            seen.append(out.numel())
        return out
    from unittest import mock
    with mock.patch.object(ops.torch, "empty", spy):
        fn()
    return seen


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_a_registered_split_sizes_the_meta_scratch(clean, paged):
    """The dry run prices the scratch of the plan the card would launch:
    a meta call under a registered ``n_split`` allocates that plan's."""
    b, sq, nq, nkv, hd = 4, 64, 32, 8, 128
    q, lens = _meta(b, sq, nq, hd), _i32(b)
    if paged:
        kv = _meta(300, 16, nkv, hd)
        call = lambda: ops.flash_chunk_paged(q, kv, kv, _i32(b, 64), lens,
                                             lens, lens)
    else:
        kv = _meta(b, 1024, nkv, hd)
        call = lambda: ops.flash_chunk(q, kv, kv, lens, lens, lens)

    def want(n_split):
        return [n_split * b * sq * nq * hd + n_split * b * sq * nq * 2]
    rows, n0 = ops.flash_plan(b, sq, nq, nkv, hd, hd)
    assert _scratch_elems(call) == (want(n0) if n0 > 1 else [])
    n1 = 3 if n0 != 3 else 2
    AT.register("flash", (b, sq, nq, nkv, hd, hd), torch.bfloat16,
                {"rows": rows, "n_split": n1}, persist=False)
    assert _scratch_elems(call) == want(n1)
    assert _scratch_elems(lambda: (ops.flash_chunk_paged if paged
                                   else ops.flash_chunk)(
        q, kv, kv, *((_i32(b, 64),) if paged else ()), lens, lens, lens,
        n_split=1)) == []


def test_pinned_plans_leave_the_cpu_bodies_unchanged(clean):
    """On the CPU a pinned plan is checked, then the plain body runs."""
    rng = np.random.default_rng(1)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s, np.float32))
    logits = t(37, 16)
    assert all(torch.equal(a, b) for a, b in zip(
        ops.topk_gate(logits, 2), ops.topk_gate(logits, 2, warps=8)))
    buf, w = t(20, 32), t(9, 2)
    slot = torch.from_numpy(rng.integers(-1, 20, (9, 2)).astype(np.int32))
    assert torch.equal(ops.unpermute_tokens(buf, slot, w),
                       ops.unpermute_tokens(buf, slot, w, rows=1))
    x, wt = t(3, 5, 64), t(3, 64, 16)
    assert torch.equal(ops.moe_gemm(x, wt), ops.moe_gemm(x, wt, ctas=1))
    assert not AT.cache_info()        # the CPU branch never looks a plan up
