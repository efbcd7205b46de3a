"""The port's training path against the reference's, on the CPU.

Data batches byte for byte; ``cross_entropy``; the loss and every gradient
leaf of ``loss_fn`` for smollm, phi3.5 and gemma (the other seven reduced
configs in test_torch_train_families.py), within each config's ``GRAD_BOUND``;
``adamw_update`` on the reference's own grads and state, and ``cosine_lr``;
three ``train_step``s and a two-microbatch step; remat bitwise equal to no
remat; the loss falling over 30 steps; the CLI; checkpoints in the
reference's format, bit for bit.  All in float32 on reduced configs.
"""

import dataclasses
import os
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as RC  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from _torch_train_helpers import (GRAD_BOUND, LOSS_RTOL,  # noqa: E402
                                  assert_grads_close, batch_np, leaf_errors,
                                  port_loss_and_grads, ref_grads,
                                  ref_loss_and_grads, to_port, to_ref,
                                  train_params)
from repro.data import pipeline as RPIPE  # noqa: E402
from repro.training import checkpoint as RCK  # noqa: E402
from repro.training import optimizer as ROPT  # noqa: E402
from repro.training import train_step as RTS  # noqa: E402
from repro_torch.bridge import (from_reference,  # noqa: E402
                                opt_state_from_reference)
from repro_torch.data import pipeline as TPIPE  # noqa: E402
from repro_torch.launch import train as TCLI  # noqa: E402
from repro_torch.models import model as TMOD  # noqa: E402
from repro_torch.training import checkpoint as TCK  # noqa: E402
from repro_torch.training import optimizer as TOPT  # noqa: E402
from repro_torch.training import train_step as TTS  # noqa: E402
from repro_torch.training.tree import flatten_with_paths  # noqa: E402

ARCHS = ("smollm-360m", "phi3.5-moe-42b", "gemma-2b")


# ---------------------------------------------------------------------------
# data and loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,seq", [("smollm-360m", 32),
                                      ("qwen2-vl-7b", 40),
                                      ("whisper-tiny", 16)])
def test_batches_equal_reference_bytes(arch, seq):
    dr = RPIPE.DataConfig(batch=3, seq_len=seq, seed=4)
    dt = TPIPE.DataConfig(batch=3, seq_len=seq, seed=4)
    want = list(RPIPE.SyntheticLM(RC.get_reduced(arch), dr).batches(2))
    got = list(TPIPE.SyntheticLM(TC.get_reduced(arch), dt).batches(2))
    keys = {"smollm-360m": {"tokens", "labels"},
            "qwen2-vl-7b": {"tokens", "labels", "embeds", "mask"},
            "whisper-tiny": {"tokens", "labels", "frames"}}[arch]
    for g, w in zip(got, want):
        assert set(g) == set(w) == keys
        for k in keys:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            assert g[k].tobytes() == w[k].tobytes(), k


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    """On a padded vocab: the padding columns hold the head's -1e30."""
    rng = np.random.default_rng(3)
    v, vp = 50, 64
    logits = (3 * rng.standard_normal((2, 7, vp))).astype(np.float32)
    logits[..., v:] = -1e30
    labels = rng.integers(0, v, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.6).astype(np.float32) if masked else None
    want = RTS.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                             None if mask is None else jnp.asarray(mask))
    got = TTS.cross_entropy(torch.from_numpy(logits),
                            torch.from_numpy(labels),
                            None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    rcfg, rp, tcfg, tp = train_params(arch)
    b = batch_np(tcfg)[0]
    rl, rparts, rg = ref_loss_and_grads(rcfg, rp, tcfg, b, remat=False)
    tl, tparts, tg = port_loss_and_grads(tp, tcfg, b, remat=False)
    np.testing.assert_allclose(tl, rl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tparts["aux"], rparts["aux"], rtol=LOSS_RTOL,
                               atol=1e-7)
    assert_grads_close(tg, rg, GRAD_BOUND[arch], arch)


@pytest.mark.parametrize("arch", sorted(GRAD_BOUND))
def test_remat_equals_no_remat_bitwise(arch):
    tcfg = TC.get_reduced(arch)
    tp = TMOD.init_params(torch.Generator().manual_seed(0), tcfg,
                          torch.float32, "cpu")
    b = to_port(batch_np(tcfg)[0])
    (l0, p0), g0 = TTS.value_and_grad(tp, b, tcfg, remat=False)
    (l1, p1), g1 = TTS.value_and_grad(tp, b, tcfg, remat=True)
    assert torch.equal(l0, l1) and torch.equal(p0["aux"], p1["aux"])
    for (p, a), (_, c) in zip(flatten_with_paths(g0), flatten_with_paths(g1)):
        assert torch.equal(a, c), p


def test_remat_counts_nothing_twice():
    """The per-expert counts a remat forward returns are the forward's
    own: the backward's recompute adds none."""
    tcfg = TC.get_reduced("phi3.5-moe-42b")
    tp = TMOD.init_params(torch.Generator().manual_seed(0), tcfg,
                          torch.float32, "cpu")
    leaf = tp["groups"][0][0]["moe"]["router"].requires_grad_()
    toks = to_port(batch_np(tcfg)[0])["tokens"]
    outs = [TMOD.forward(tp, tcfg, tokens=toks, expert_stats=True,
                         remat=r) for r in (False, True)]
    want = outs[0].expert_counts.clone()
    outs[1].logits.sum().backward()
    assert leaf.grad is not None
    assert torch.equal(outs[1].expert_counts, want)
    assert int(want.sum()) == toks.numel() * tcfg.top_k * tcfg.n_layers


def test_kernels_on_training_raises():
    """The kernels have no backward: a plan with them on raises at the
    first one, on the CPU too (it never trains on the plain bodies
    quietly)."""
    from repro_torch.core.partitioner import make_plan
    from repro_torch.kernels.policy import KernelPolicy
    tcfg = TC.get_reduced("phi3.5-moe-42b")
    tp = TMOD.init_params(torch.Generator().manual_seed(0), tcfg,
                          torch.float32, "cpu")
    plan = make_plan("mixserve", None, kernels=KernelPolicy.all_on())
    b = to_port(batch_np(tcfg)[0])
    with pytest.raises(RuntimeError, match="no backward"):
        TTS.value_and_grad(tp, b, tcfg, plan)
    with torch.no_grad():
        loss, _ = TTS.loss_fn(tp, b, tcfg, plan)
    assert torch.isfinite(loss)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smollm_grads():
    rcfg, rp, tcfg, tp = train_params("smollm-360m")
    _, rg = ref_grads(rcfg, rp, batch_np(tcfg)[0], remat=False)
    return rcfg, rp, tcfg, tp, rg, from_reference(
        jax.tree.map(np.asarray, rg), tcfg)


def _ref_state(rp, step, dtype, seed):
    """A reference AdamWState at ``step`` with drawn moments (v > 0)."""
    rng = np.random.default_rng(seed)
    m = jax.tree.map(lambda p: jnp.asarray(
        0.01 * rng.standard_normal(p.shape), dtype), rp)
    v = jax.tree.map(lambda p: jnp.asarray(
        1e-4 * rng.random(p.shape) + 1e-6, dtype), rp)
    return ROPT.AdamWState(step=jnp.asarray(step, jnp.int32), m=m, v=v)


OPT_CASES = {
    # gnorm ~1e2 here: the clip scales every gradient down
    "clip": (dict(lr=1e-3, warmup_steps=10, total_steps=100), 0, "float32"),
    "bf16_moments": (dict(lr=1e-3, warmup_steps=10, total_steps=100,
                          grad_clip=0.0), 3, "bfloat16"),
    "past_warmup": (dict(lr=2e-3, warmup_steps=10, total_steps=100,
                         weight_decay=0.05), 40, "float32"),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_adamw_update_matches_reference(smollm_grads, case):
    rcfg, rp, tcfg, tp, rg, rg_port = smollm_grads
    kw, step, mdt = OPT_CASES[case]
    rstate = _ref_state(rp, step, getattr(jnp, mdt), seed=7)
    r_p, r_s, r_stats = jax.jit(ROPT.adamw_update, static_argnums=0)(
        ROPT.AdamWConfig(**kw), rg, rstate, rp)
    tstate = opt_state_from_reference(jax.tree.map(np.asarray, rstate),
                                      tcfg)
    params = from_reference(jax.tree.map(np.asarray, rp), tcfg)
    t_p, t_s, t_stats = TOPT.adamw_update(TOPT.AdamWConfig(**kw), rg_port,
                                          tstate, params)
    if case == "clip":
        assert float(r_stats["grad_norm"]) > 10 * kw.get("grad_clip", 1.0)
    assert int(t_s.step) == int(r_s.step) == step + 1
    np.testing.assert_allclose(float(t_stats["lr"]), float(r_stats["lr"]),
                               rtol=1e-6)
    # the norm: the reference's float32 jnp.sum on the CPU strays from the
    # float64 sum of squares by up to ~1e-5 of a leaf's (~1e-6 of the
    # total here); the port's torch.sum by ~1e-7.  So the port is held to
    # the float64 norm within 1e-6, and to the reference's within that
    # plus the reference's own distance from it
    exact = np.sqrt(sum(float(np.sum(np.square(np.asarray(x, np.float64))))
                        for x in jax.tree.leaves(rg)))
    got, want = float(t_stats["grad_norm"]), float(r_stats["grad_norm"])
    assert abs(got - exact) <= 1e-6 * exact
    assert abs(got - want) <= 1e-6 * exact + abs(want - exact)
    # with the clip on, the reference's scale carries its norm's error
    # into the moments, twice into v (the scale squared)
    tol = 1e-6 + (2 * abs(want - exact) / exact
                  if kw.get("grad_clip", 1.0) > 0 else 0.0)
    if mdt == "bfloat16":
        # XLA contracts the moments' float32 updates into fused
        # multiply-adds, torch does not: the float32 values may differ in
        # the last bit, and a value on a bfloat16 rounding boundary then
        # rounds one bfloat16 step apart.  Held to one step per element,
        # in a few elements.
        for got, want in ((t_s.m, r_s.m), (t_s.v, r_s.v)):
            n_off = n_all = 0
            for (p, a), (_, b) in zip(flatten_with_paths(got),
                                      flatten_with_paths(from_reference(
                                          jax.tree.map(np.asarray, want),
                                          tcfg, dtype=torch.bfloat16))):
                assert a.dtype == torch.bfloat16
                d = (a.float() - b.float()).abs()
                assert (d <= 2.0 ** -7 * b.float().abs()).all(), p
                n_off += int((d > 0).sum())
                n_all += d.numel()
            assert n_off <= 1e-3 * n_all, (n_off, n_all)
        checked = ((t_p, r_p),)
    else:
        checked = ((t_p, r_p), (t_s.m, r_s.m), (t_s.v, r_s.v))
    for got, want in checked:
        want = from_reference(jax.tree.map(np.asarray, want), tcfg,
                              dtype=leaf_dtype(got))
        assert all(a.dtype == leaf_dtype(got) for a in leaves(got))
        errs = leaf_errors(got, want)
        assert max(errs.values()) <= tol, max(errs.items(),
                                              key=lambda kv: kv[1])


def leaves(tree):
    return [t for _, t in flatten_with_paths(tree)]


def leaf_dtype(tree):
    return leaves(tree)[0].dtype


def test_cosine_lr_matches_reference():
    for kw in (dict(lr=1.0, warmup_steps=10, total_steps=110),
               dict(lr=3e-4, warmup_steps=100, total_steps=10000),
               dict(lr=2e-3, warmup_steps=0, total_steps=1)):
        for s in (0, 1, 5, 9, 10, 11, 37, 60, 109, 110, 500, 10000, 20000):
            want = ROPT.cosine_lr(ROPT.AdamWConfig(**kw),
                                  jnp.asarray(s, jnp.int32))
            got = TOPT.cosine_lr(TOPT.AdamWConfig(**kw),
                                 torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                       err_msg=f"{kw} step {s}")


def test_adamw_first_step_and_clip_match_reference_tests():
    """The reference's own optimizer tests, on the port."""
    cfg = TOPT.AdamWConfig(lr=0.1, beta1=0.9, beta2=0.999, eps=1e-8,
                           weight_decay=0.0, warmup_steps=0, total_steps=10,
                           min_lr_ratio=1.0, grad_clip=0.0)
    p = {"w": torch.tensor([1.0, 2.0])}
    new_p, st, _ = TOPT.adamw_update(cfg, {"w": torch.tensor([0.5, -0.5])},
                                     TOPT.init_opt_state(p), p)
    np.testing.assert_allclose(new_p["w"].numpy(), [0.9, 2.1], atol=1e-5)
    assert int(st.step) == 1
    cfg = TOPT.AdamWConfig(lr=1.0, grad_clip=1.0, warmup_steps=0,
                           total_steps=1, min_lr_ratio=1.0, weight_decay=0.0)
    p = {"w": torch.zeros(3)}
    _, _, stats = TOPT.adamw_update(cfg, {"w": torch.tensor([30., 40., 0.])},
                                    TOPT.init_opt_state(p), p)
    assert abs(float(stats["grad_norm"]) - 50.0) < 1e-4


# ---------------------------------------------------------------------------
# train_step
# ---------------------------------------------------------------------------

# Three steps of a freshly initialised model.  Adam's first steps move a
# weight by about lr whatever its gradient's size (m / sqrt(v) is the
# gradient's sign), so a near-zero gradient entry whose float32 sums differ
# in sign between the packages moves by 2 lr: eps = 1e-2, above most
# entries' |g|, keeps the update smooth in the gradient, and the steps'
# differences are the gradients' own.  MoE routing adds its own jumps: a
# weight that moved by an ulp can flip a top-k pick or a capacity drop
# after the first step, which moves that step's gradient norm (phi3.5:
# 1.7e-2 at step 3 on this data) while the loss stays within 1e-5.
STEP_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10, eps=1e-2)
# The first step's gradient norm carries the gradients' float32 spread
# (GRAD_BOUND); later steps' add the routing jumps.
STEP_BOUND = {   # (loss, ce, aux), grad norm at step 1 / after, params
    "smollm-360m": dict(loss=1e-5, gnorm0=5e-4, gnorm=5e-4, params=1e-4),
    "phi3.5-moe-42b": dict(loss=5e-5, gnorm0=2e-3, gnorm=5e-2,
                           params=1e-3),
}


@pytest.mark.parametrize("micro", [1, 2], ids=["whole", "microbatches2"])
@pytest.mark.parametrize("arch", ["smollm-360m", "phi3.5-moe-42b"])
def test_train_steps_match_reference(arch, micro):
    rcfg, rp, tcfg, tp = train_params(arch)
    bound = STEP_BOUND[arch]
    n = 3 if micro == 1 else 1
    batches = batch_np(tcfg, batch=4, seq=16, n=n)
    r_step = jax.jit(RTS.make_train_step(
        rcfg, opt_cfg=ROPT.AdamWConfig(**STEP_OPT), remat=False,
        microbatches=micro))
    t_step = TTS.make_train_step(tcfg, opt_cfg=TOPT.AdamWConfig(**STEP_OPT),
                                 remat=False, microbatches=micro)
    r_opt = ROPT.init_opt_state(rp)
    t_opt = TOPT.init_opt_state(tp)
    for i, b in enumerate(batches):
        rp, r_opt, rm = r_step(rp, r_opt, to_ref(b))
        tp, t_opt, tm = t_step(tp, t_opt, to_port(b))
        for k, rtol in (("loss", bound["loss"]), ("ce", bound["loss"]),
                        ("aux", bound["loss"]), ("lr", 1e-6),
                        ("grad_norm", bound["gnorm0" if i == 0 else "gnorm"])):
            np.testing.assert_allclose(float(tm[k]), float(rm[k]),
                                       rtol=rtol, err_msg=f"{k} step {i}")
    errs = leaf_errors(tp, from_reference(jax.tree.map(np.asarray, rp),
                                          tcfg))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= bound["params"], (worst, errs[worst])
    assert int(t_opt.step) == n


def test_indivisible_microbatches_refused_by_both_packages():
    """A batch of 3 rows in 2 microbatches: the reference's reshape
    raises, and the port's ``train_step`` refuses it before any forward
    (it used to drop the tail row)."""
    rcfg, rp, tcfg, tp = train_params("smollm-360m")
    b = batch_np(tcfg, batch=3, seq=16)[0]
    with pytest.raises(TypeError):
        RTS.train_step(rp, ROPT.init_opt_state(rp), to_ref(b), cfg=rcfg,
                       remat=False, microbatches=2)
    opt = TOPT.init_opt_state(tp)
    with pytest.raises(ValueError, match="microbatches=2 does not divide "
                                         "a batch of 3 rows"):
        TTS.train_step(tp, opt, to_port(b), cfg=tcfg, remat=False,
                       microbatches=2)
    assert int(opt.step) == 0


def test_loss_decreases_small_scale():
    """The port's counterpart of test_training.py's
    test_loss_decreases_100m_scale: 30 steps of the reduced smollm."""
    cfg = TC.get_reduced("smollm-360m")
    params = TMOD.init_params(torch.Generator().manual_seed(0), cfg,
                              torch.float32, "cpu")
    opt = TOPT.init_opt_state(params)
    step = TTS.make_train_step(cfg, opt_cfg=TOPT.AdamWConfig(
        lr=2e-3, warmup_steps=3, total_steps=30))
    data = TPIPE.SyntheticLM(cfg, TPIPE.DataConfig(batch=8, seq_len=64,
                                                   seed=0))
    losses = []
    for batch in data.batches(30):
        params, opt, m = step(params, opt, to_port(batch))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_trains_and_saves_on_the_cpu(tmp_path, capsys):
    path = str(tmp_path / "ck.npz")
    rc = TCLI.main(["--arch", "smollm-360m", "--reduced", "--steps", "3",
                    "--batch", "2", "--seq", "32", "--device", "cpu",
                    "--save", path, "--log-every", "1"])
    out = capsys.readouterr().out
    assert rc == 0 and os.path.exists(path) and "saved ->" in out
    assert out.count("step ") == 3 and "arch=smollm-reduced" in out
    cfg = TC.get_reduced("smollm-360m")
    like = {"params": TMOD.init_params(torch.Generator().manual_seed(1), cfg,
                                       torch.float32, "cpu")}
    back = TCK.restore(path, like)
    assert all(torch.isfinite(t).all() for t in leaves(back))


def test_cli_refuses_without_cuda_and_on_a_mesh(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--arch", "smollm-360m", "--reduced", "--steps", "1"]
    assert TCLI.main(argv) != 0
    assert "no CUDA device" in capsys.readouterr().err
    assert TCLI.main(argv + ["--device", "cpu", "--mesh", "single"]) != 0
    assert "needs a world of 256 ranks" in capsys.readouterr().err
    assert TCLI.main(argv + ["--device", "cpu", "--mesh", "multi"]) != 0
    assert "needs a world of 512 ranks" in capsys.readouterr().err


@pytest.mark.parametrize("local_world,device,want", [
    (8, "cuda", ("nccl", "cuda:5")),     # a card for each of 8 local ranks
    (16, "cuda", ("gloo", "cuda:5")),    # 16 local ranks on 8 cards
    (8, "cpu", ("gloo", "cpu")),
])
def test_mesh_cli_picks_backend_and_device_by_host(monkeypatch, local_world,
                                                   device, want):
    """``train --mesh`` under ``torchrun`` (rank 77 of 256, the host's
    rank 5, 8 cards a host): the backend and device come from the host's
    ranks (``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``), not the world's."""
    import torch.distributed as tdist
    from repro_torch.launch import mesh as LM

    class Joined(Exception):
        pass

    seen = {}

    def init_ranks(**kw):
        kw.pop("init_method")
        seen["layout"] = LM.rank_layout(**kw)
        raise Joined
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(tdist, "is_initialized", lambda: False)
    monkeypatch.setattr(LM, "init_ranks", init_ranks)
    for k, v in {"RANK": 77, "WORLD_SIZE": 256, "LOCAL_RANK": 5,
                 "LOCAL_WORLD_SIZE": local_world}.items():
        monkeypatch.setenv(k, str(v))
    with pytest.raises(Joined):
        TCLI._mesh_plan("single", device)
    backend, dev = seen["layout"]
    assert (backend, str(dev)) == want


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    p = {"w": torch.randn(3, 4, generator=g),
         "layers": [{"a": torch.randn(5, generator=g).to(torch.bfloat16)},
                    {"a": torch.randn(5, generator=g).to(torch.bfloat16)}]}
    st = TOPT.init_opt_state(p)
    st.m["w"].normal_(generator=g)
    return {"params": p, "opt": st._replace(step=torch.tensor(
        7, dtype=torch.int32)),
        "n": [torch.tensor(3, dtype=torch.int32), [torch.ones(2, 2)]]}


def _bits(t):
    return t.reshape(-1).view(torch.uint8)


def test_checkpoint_round_trip_bitwise(tmp_path):
    tree = _tree()
    path = str(tmp_path / "c.npz")
    TCK.save(path, tree)
    assert not os.path.exists(path + ".tmp")
    back = TCK.restore(path, _tree(1))
    assert isinstance(back["opt"], TOPT.AdamWState)
    for (p, a), (q, b) in zip(flatten_with_paths(back),
                              flatten_with_paths(tree)):
        assert p == q and a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(_bits(a), _bits(b)), p
    bad = _tree(1)
    bad["params"]["w"] = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="shape"):
        TCK.restore(path, bad)


def test_checkpoint_matches_reference_file(tmp_path):
    """The same tree through both packages: the same members, byte for
    byte (keys, .npy headers and data)."""
    tree = _tree()
    dt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
          torch.int32: jnp.int32}
    ref_tree = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.float().numpy()).astype(dt[t.dtype]),
        _as_ref_structure(tree))
    rpath, tpath = str(tmp_path / "r.npz"), str(tmp_path / "t.npz")
    RCK.save(rpath, ref_tree)
    TCK.save(tpath, tree)
    zr, zt = zipfile.ZipFile(rpath), zipfile.ZipFile(tpath)
    assert zr.namelist() == zt.namelist()
    assert "opt/.m/w.npy" in zt.namelist()
    for name in zr.namelist():
        assert zr.read(name) == zt.read(name), name


def _as_ref_structure(tree):
    """The port tree with its AdamWState as the reference's."""
    st = tree["opt"]
    return {"params": tree["params"], "n": tree["n"],
            "opt": ROPT.AdamWState(step=st.step, m=st.m, v=st.v)}


def test_reference_cannot_restore_its_bf16_file_the_port_can(tmp_path):
    """The reference writes a bfloat16 leaf as 2-byte void and its
    ``restore`` cannot cast that back (ROADMAP queue C); the port restores
    the reference's file bit for bit."""
    vals = np.random.default_rng(0).standard_normal((4, 3)).astype(
        np.float32)
    tree = {"w": jnp.asarray(vals, jnp.bfloat16)}
    path = str(tmp_path / "r.npz")
    RCK.save(path, tree)
    with pytest.raises(ValueError, match="No cast function available"):
        RCK.restore(path, tree)
    back = TCK.restore(path, {"w": torch.zeros(4, 3,
                                               dtype=torch.bfloat16)})
    want = torch.from_numpy(vals).to(torch.bfloat16)
    assert torch.equal(back["w"].view(torch.int16), want.view(torch.int16))


def test_dataclass_config_is_the_references():
    """AdamWConfig and DataConfig carry the reference's fields and
    defaults."""
    for r, t in ((ROPT.AdamWConfig, TOPT.AdamWConfig),
                 (RPIPE.DataConfig, TPIPE.DataConfig)):
        assert [(f.name, f.default) for f in dataclasses.fields(r)] == \
            [(f.name, f.default) for f in dataclasses.fields(t)]
