"""Each hand-written CUDA kernel against its plain PyTorch version, on the
card.  Skips without one; imports nothing of JAX, so it also runs where
only the port is installed:

    python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances: float32 to 1e-4; bf16 to one bf16 rounding step of the f32
result (atol 1e-2, rtol 1.6e-2); bf16 attention across split-KV boundaries
also to the f32 plain version within half a bf16 ulp (atol 1e-5, rtol
4e-3); top-k ids, permuted rows and every exact-zero contract exactly;
dense and paged attention bitwise equal.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels build and run only there)")
    return torch.device("cuda")


def _tol(dt):
    return (1e-4, 1e-4) if dt == torch.float32 else (1e-2, 1.6e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_chunk_paged_on_card(dev, dtype):
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cpu").manual_seed(0)
    b, sq, nq, nkv, hd, page, nb, n_pages = 4, 8, 12, 4, 64, 4, 5, 16
    q = torch.randn(b, sq, nq, hd, generator=g).to(dev, dt)
    kp = torch.randn(n_pages, page, nkv, hd, generator=g).to(dev, dt)
    vp = torch.randn(n_pages, page, nkv, hd, generator=g).to(dev, dt)
    bt = torch.full((b, nb), -1, dtype=torch.int32)
    bt[0, :4] = torch.tensor([3, 9, 1, 12])
    bt[1, :4] = torch.tensor([0, 5, 7, 2])
    i32 = dict(dtype=torch.int32, device=dev)
    q_off = torch.tensor([6, 13, 0, 0], **i32)
    q_len = torch.tensor([8, 1, 0, 3], **i32)
    kv_len = torch.tensor([14, 14, 0, 0], **i32)
    args = (q, kp, vp, bt.to(dev), q_off, q_len, kv_len)
    ops.reset_counters()
    got = ops.flash_chunk_paged(*args)
    want = ref.flash_chunk_paged_ref(*args)
    atol, rtol = _tol(dt)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    assert (got[0, 8:] == 0).all() and (got[1, 1:] == 0).all()
    assert (got[2] == 0).all() and (got[3] == 0).all()
    assert ops.counters["flash_chunk_paged"] == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_chunk_paged_at_a_ranks_heads_on_card(dev, dtype):
    """One rank of the sharded phi3.5 serve (2x2 mesh): its 2 of 4 slots,
    16 of 32 query heads and 4 of 8 kv heads, hd 128, page 16, a 64-row
    prefill chunk mid-prompt beside a decode deep in the cache, every
    page of the pool."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cpu").manual_seed(1)
    b, sq, nq, nkv, hd, page, nb, n_pages = 2, 64, 16, 4, 128, 16, 34, 136
    q = torch.randn(b, sq, nq, hd, generator=g).to(dev, dt)
    kp = torch.randn(n_pages, page, nkv, hd, generator=g).to(dev, dt)
    vp = torch.randn(n_pages, page, nkv, hd, generator=g).to(dev, dt)
    perm = torch.randperm(n_pages, generator=g).to(torch.int32)
    bt = torch.full((b, nb), -1, dtype=torch.int32)
    bt[0, :20], bt[1, :nb] = perm[:20], perm[20:20 + nb]
    i32 = dict(dtype=torch.int32, device=dev)
    q_off = torch.tensor([256, nb * page - 1], **i32)
    q_len = torch.tensor([sq, 1], **i32)
    kv_len = q_off + q_len
    args = (q, kp, vp, bt.to(dev), q_off, q_len, kv_len)
    ops.reset_counters()
    got = ops.flash_chunk_paged(*args)
    want = ref.flash_chunk_paged_ref(*args)
    atol, rtol = _tol(dt)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    assert (got[1, 1:] == 0).all()
    assert ops.counters["flash_chunk_paged"] == 1


# (E, k): the served routers (phi3.5, deepseek-v2), the paper's (qwen3-235b,
# deepseek-r1), k = E at an odd E (16-lane rows, k at run time), k = 32
TOPK_CASES = [(16, 2), (160, 6), (128, 8), (256, 8), (5, 5), (40, 32)]


def _topk_logits(t, e, seed, dt, dev):
    """Row 0 all tied (ids 0, 1, ...); from T = 3 on, row 1 a tied top pair
    (ids 1, E - 2) and row 2 -inf in every other entry."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    logits = torch.randn(t, e, generator=g)
    logits[0] = 0.5
    if t > 2:
        logits[1, e - 2] = logits[1, 1] = 3.0
        logits[2, 1::2] = -float("inf")
    return logits.to(dev, dt)


@pytest.mark.parametrize("renorm", [True, False], ids=["renorm", "raw"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 128, 300, 512])
@pytest.mark.parametrize("ek", TOPK_CASES,
                         ids=[f"E{e}_k{k}" for e, k in TOPK_CASES])
def test_topk_gate_on_card(dev, ek, t, dtype, renorm):
    """Every lane layout and instantiation the dispatch picks (16-lane rows
    at E <= 16; k at compile time and at run time): ids equal to the plain
    version's, weights within 1e-6."""
    e, k = ek
    logits = _topk_logits(t, e, t * 1000 + e, getattr(torch, dtype), dev)
    ops.reset_counters()
    w, i = ops.topk_gate(logits, k, renorm=renorm)
    w_r, i_r = ref.topk_gate_ref(logits, k, renorm)
    assert w.shape == i.shape == (t, k)
    assert w.dtype == torch.float32 and i.dtype == torch.int32
    assert torch.equal(i, i_r)
    assert i[0].tolist() == list(range(k))
    if t > 2:
        assert i[1].tolist()[:2] == [1, e - 2]
    torch.testing.assert_close(w, w_r, atol=1e-6, rtol=0)
    assert ops.counters["topk_gate"] == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ek", [(17, 3), (33, 8), (97, 2), (129, 6),
                                (255, 8)], ids=lambda ek: f"E{ek[0]}_k{ek[1]}")
def test_topk_gate_on_card_at_row_tails(dev, dtype, ek):
    """E one past a multiple of 32 (one live slot in a lane's last group)
    or one short of it, each row's largest logit in its last column, in a
    buffer of exactly T x E: the tail element is read and picked first,
    and no row reads its neighbour's."""
    e, k = ek
    logits = _topk_logits(301, e, e, getattr(torch, dtype), dev)
    logits[3:, -1] = 8.0
    w, i = ops.topk_gate(logits, k)
    w_r, i_r = ref.topk_gate_ref(logits, k)
    assert torch.equal(i, i_r) and (i[3:, 0] == e - 1).all()
    torch.testing.assert_close(w, w_r, atol=1e-6, rtol=0)


def _xor_tree(s, lanes):
    """The kernel's sum over (.., lanes) lane values: an xor butterfly from
    offset lanes / 2 down, each lane adding its partner's value."""
    o = lanes // 2
    while o:
        s = s + s[..., torch.arange(lanes, device=s.device) ^ o]
        o //= 2
    return s[..., 0]


@pytest.mark.parametrize("renorm", [True, False], ids=["renorm", "raw"])
@pytest.mark.parametrize("scale", [1.0, 40.0])
@pytest.mark.parametrize("ek", [(16, 2), (40, 32), (160, 6), (256, 8)],
                         ids=lambda ek: f"E{ek[0]}_k{ek[1]}")
def test_topk_gate_weights_are_the_divisions_bits(dev, ek, scale, renorm):
    """The kernel's weights bit for bit: each lane sums its slots in order
    (element lane + 32 i in slot i; 16 lanes where E <= 16), the lanes
    sum by an xor butterfly, each pick is the correctly rounded quotient
    of its exp by that sum, and renorm divides it by the picks' xor-tree
    sum (at least 1e-9).  Rebuilt here from torch.exp and torch's IEEE
    division in that order; logits 40x wider reach probabilities under
    2^-60, the kernel's division by the operator."""
    e, k = ek
    lanes = 16 if e <= 16 else 32
    t, epl = 4096, -(-e // lanes)
    g = torch.Generator(device="cpu").manual_seed(e)
    logits = (torch.randn(t, e, generator=g) * scale).to(dev)
    w, i = ops.topk_gate(logits, k, renorm=renorm)
    ex = torch.exp(logits - logits.amax(-1, keepdim=True))
    slots = torch.zeros(t, epl * lanes, device=dev)
    slots[:, :e] = ex
    s = torch.zeros(t, lanes, device=dev)
    for j in range(epl):
        s = s + slots[:, j * lanes:(j + 1) * lanes]
    p = torch.gather(ex, 1, i.long()) / _xor_tree(s, lanes)[:, None]
    if renorm:
        picks = torch.zeros(t, 32, device=dev)
        picks[:, :k] = p
        p = p / _xor_tree(picks, 32).clamp_min(1e-9)[:, None]
    assert torch.equal(w, p)
    assert scale == 1.0 or bool(((ex > 0) & (ex < 2 ** -60)).any())


@pytest.mark.parametrize("short", ["rows", "lanes", "warps"])
def test_topk_entry_refuses_a_grid_short_of_the_plan(dev, short):
    """The gate's C entry checks the launch: one CTA fewer than
    ops.topk_plan's, lanes per row other than the plan's for the E, or
    more warps a CTA than its launch bound is refused
    (cudaErrorInvalidConfiguration, 9) and launches nothing."""
    from repro_torch.kernels import build
    logits = torch.randn(300, 16, device=dev).to(torch.bfloat16)
    w = torch.zeros(300, 2, device=dev)
    idx = torch.zeros(300, 2, dtype=torch.int32, device=dev)
    lanes, wpc, ctas = ops.topk_plan(300, 16)
    plan = {"rows": (lanes, wpc, ctas - 1), "lanes": (32, wpc, ctas),
            "warps": (lanes, ops.TOPK_MAX_WARPS + 1, ctas)}[short]
    rc = build.load().rt_topk_gate(logits.data_ptr(), w.data_ptr(),
                                   idx.data_ptr(), 300, 16, 2, 1, 1, *plan,
                                   ops._stream())
    torch.cuda.synchronize()
    assert rc == 9 and (w == 0).all() and (idx == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_gemm_on_card(dev, dtype):
    dt = getattr(torch, dtype)
    x = torch.randn(200, 256, device=dev).to(dt)
    w = (torch.randn(4, 256, 96, device=dev) / 16).to(dt)
    off = torch.tensor([0, 37, 37, 90, 150], dtype=torch.int32, device=dev)
    out = ops.grouped_gemm(x, w, off)
    atol, rtol = _tol(dt)
    torch.testing.assert_close(out.float(),
                               ref.grouped_gemm_ref(x, w, off).float(),
                               atol=atol, rtol=rtol)
    assert (out[150:] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [1, 13, 16, 40, 70])
@pytest.mark.parametrize("hd", [(264, 200), (100, 75)],
                         ids=["16-byte rows", "element-wise"])
def test_moe_gemm_on_card(dev, dtype, c, hd):
    """Every row-tile size (C 1-16, 32, 48, 64 and two 64-row tiles), H and
    D off the tiles; an all-zero expert and an all-zero row give exact
    zeros; the output is exactly (E, C, D)."""
    dt = getattr(torch, dtype)
    h, d = hd
    g = torch.Generator(device="cpu").manual_seed(c)
    x = torch.randn(5, c, h, generator=g)
    x[2] = 0
    x[4, c // 2] = 0
    w = torch.randn(5, h, d, generator=g) * h ** -0.5
    x, w = x.to(dev, dt), w.to(dev, dt)
    ops.reset_counters()
    out = ops.moe_gemm(x, w)
    want = ref.moe_gemm_ref(x, w)
    assert out.shape == (5, c, d) and out.dtype == dt
    atol, rtol = _tol(dt)
    torch.testing.assert_close(out.float(), want.float(), atol=atol,
                               rtol=rtol)
    assert (out[2] == 0).all() and (out[4, c // 2] == 0).all()
    assert ops.counters["moe_gemm"] == 1


# (name, E, C, H, D): H just over a multiple of the 64-deep unit, so a
# split point and the H tail meet; D off the column tile; one expert whose
# single tile is carried across every SM in turn; fewer units than SMs
MOE_SPLITS = [("h_tail_split", 4, 40, 4104, 512),
              ("d_off_tile", 3, 13, 1000, 1288),
              ("one_expert_large_h", 1, 16, 16384, 256),
              ("few_units", 2, 5, 64, 100)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", MOE_SPLITS, ids=[c[0] for c in MOE_SPLITS])
def test_moe_gemm_split_tiles_on_card(dev, dtype, case):
    """The schedule's edges: the split tiles' carried sums match the plain
    version, an all-zero expert and row stay exact zeros, and two calls
    give the same bits (every output is summed in one pass in H order)."""
    _, e, c, h, d = case
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cpu").manual_seed(h)
    x = torch.randn(e, c, h, generator=g)
    x[0, c // 2] = 0
    if e > 1:
        x[e - 1] = 0
    w = torch.randn(e, h, d, generator=g) * h ** -0.5
    x, w = x.to(dev, dt), w.to(dev, dt)
    ops.reset_counters()
    out = ops.moe_gemm(x, w)
    again = ops.moe_gemm(x, w)
    assert ops.counters["moe_gemm"] == 2
    assert out.shape == (e, c, d) and torch.equal(out, again)
    atol, rtol = _tol(dt)
    torch.testing.assert_close(out.float(), ref.moe_gemm_ref(x, w).float(),
                               atol=atol, rtol=rtol)
    assert (out[0, c // 2] == 0).all()
    if e > 1:
        assert (out[e - 1] == 0).all()


def _segments(lengths, tail):
    """(E+1,) int32 offsets of segments of the given lengths, and N with
    ``tail`` rows past offsets[-1]."""
    off = [0]
    for n in lengths:
        off.append(off[-1] + n)
    return torch.tensor(off, dtype=torch.int32), off[-1] + tail


# (name, segment lengths, rows past offsets[-1], H, D): the per-segment
# schedule's edges.  Boundaries at every residue mod 16 (17-row segments)
# and mod BM = 64 (65-row segments), one expert holding every row beside
# empty ones, 1-row segments, segments longer than BM, H and D off 8
GG_CASES = [
    ("mod16", [17] * 16, 30, 256, 200),
    ("mod64", [65] * 64, 10, 64, 136),
    ("one_expert", [0, 0, 0, 200, 0, 0, 0, 0], 0, 128, 96),
    ("one_row", [1] * 32 + [0] * 8, 16, 64, 136),
    ("long", [150, 0, 301, 90], 7, 256, 264),
    ("off8", [13, 0, 40, 1, 29], 21, 100, 75),
    ("all_past", [0, 0, 0], 70, 64, 64),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GG_CASES, ids=[c[0] for c in GG_CASES])
def test_grouped_gemm_schedule_on_card(dev, dtype, case):
    """Each row computed by its own expert only, every element written
    once: equal to the plain version, rows past offsets[-1] exact zeros."""
    dt = getattr(torch, dtype)
    _, lengths, tail, h, d = case
    off, n = _segments(lengths, tail)
    g = torch.Generator(device="cpu").manual_seed(len(lengths))
    x = torch.randn(n, h, generator=g).to(dev, dt)
    w = (torch.randn(len(lengths), h, d, generator=g) * h ** -0.5).to(dev, dt)
    off = off.to(dev)
    ops.reset_counters()
    out = ops.grouped_gemm(x, w, off)
    want = ref.grouped_gemm_ref(x, w, off)
    atol, rtol = _tol(dt)
    torch.testing.assert_close(out.float(), want.float(), atol=atol,
                               rtol=rtol)
    assert (out[int(off[-1]):] == 0).all()
    assert ops.counters["grouped_gemm"] == 1


def test_wrapper_refuses_mixed_devices(dev):
    x = torch.randn(8, 16, device=dev)
    w = torch.randn(2, 16, 4)
    with pytest.raises(ValueError, match="one device"):
        ops.grouped_gemm(x, w, torch.tensor([0, 3, 8], dtype=torch.int32))


# (name, B, sq, nq, nkv, hd, hdv): GQA, MLA expanded (g = 1, hd != hdv),
# MLA absorbed (nkv = 1, g = 128 split across CTAs, hd 576 / hdv 512) and
# gemma-2b's MQA (nkv = 1, g = 8, hd 256: the 128-row tile at its widest)
ATTN_CASES = [("gqa", 4, 8, 12, 4, 64, 64),
              ("mha_64", 4, 8, 4, 4, 64, 64),
              ("gqa_128", 4, 8, 32, 8, 128, 128),
              ("mla_expanded", 4, 8, 4, 4, 192, 128),
              ("mla_absorbed", 4, 3, 128, 1, 576, 512),
              ("mqa_hd256", 4, 8, 8, 1, 256, 256)]


def _dense_case(dev, dt, b, sq, nq, nkv, hd, hdv, skv=40):
    """A mixed step: mid-prompt chunk, decode, idle slot (q_len 0), live
    rows with kv_len 0."""
    g = torch.Generator(device="cpu").manual_seed(1)
    q = torch.randn(b, sq, nq, hd, generator=g).to(dev, dt)
    k = torch.randn(b, skv, nkv, hd, generator=g).to(dev, dt)
    v = torch.randn(b, skv, nkv, hdv, generator=g).to(dev, dt)
    i32 = dict(dtype=torch.int32, device=dev)
    q_off = torch.tensor([30, 37, 0, 0], **i32)[:b]
    q_len = torch.tensor([sq, 1, 0, 2], **i32)[:b]
    kv_len = torch.tensor([30 + sq, 38, 0, 0], **i32)[:b]
    return q, k, v, q_off, q_len, kv_len


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_CASES, ids=[c[0] for c in ATTN_CASES])
def test_flash_chunk_on_card(dev, dtype, case):
    dt = getattr(torch, dtype)
    args = _dense_case(dev, dt, *case[1:])
    ops.reset_counters()
    got = ops.flash_chunk(*args, scale=0.07)
    want = ref.flash_chunk_ref(*args, 0.07)
    atol, rtol = _tol(dt)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    q_len = args[4].tolist()
    for i, n in enumerate(q_len):
        assert (got[i, n:] == 0).all()
    assert (got[3] == 0).all()                   # kv_len == 0
    assert ops.counters["flash_chunk"] == 1


@pytest.mark.parametrize("case", ATTN_CASES, ids=[c[0] for c in ATTN_CASES])
def test_flash_chunk_paged_equals_dense_bitwise(dev, case):
    """The paged pools gathered through the tables are the dense cache: one
    device body, so the two outputs are equal bit for bit."""
    _, b, sq, nq, nkv, hd, hdv = case
    q, k, v, q_off, q_len, kv_len = _dense_case(dev, torch.bfloat16, b, sq,
                                                nq, nkv, hd, hdv, skv=48)
    page, nb = 16, 3
    perm = torch.randperm(b * nb, generator=torch.Generator().manual_seed(2))
    bt = perm.reshape(b, nb).to(dev, torch.int32)
    kp = torch.empty(b * nb, page, nkv, hd, dtype=k.dtype, device=dev)
    vp = torch.empty(b * nb, page, nkv, hdv, dtype=v.dtype, device=dev)
    kp[bt.long()] = k.reshape(b, nb, page, nkv, hd)
    vp[bt.long()] = v.reshape(b, nb, page, nkv, hdv)
    dense = ops.flash_chunk(q, k, v, q_off, q_len, kv_len)
    paged = ops.flash_chunk_paged(q, kp, vp, bt, q_off, q_len, kv_len)
    assert torch.equal(dense, paged)


def _to_pages(k, v, page):
    """The dense (b, skv, ...) cache as pools in shuffled page order and
    the block tables that gather it back."""
    b, skv, nkv, hd = k.shape
    nb = skv // page
    perm = torch.randperm(b * nb, generator=torch.Generator().manual_seed(4))
    bt = perm.reshape(b, nb).to(k.device, torch.int32)
    kp = torch.empty(b * nb, page, nkv, hd, dtype=k.dtype, device=k.device)
    vp = torch.empty(b * nb, page, nkv, v.shape[3], dtype=v.dtype,
                     device=k.device)
    kp[bt.long()] = k.reshape(b, nb, page, nkv, hd)
    vp[bt.long()] = v.reshape(b, nb, page, nkv, v.shape[3])
    return kp, vp, bt


@pytest.mark.parametrize("case", ATTN_CASES[1:], ids=[c[0] for c in
                                                      ATTN_CASES[1:]])
def test_flash_chunk_split_kv_on_card(dev, case):
    """A small grid over a long cache: the bf16 body splits the KV walk
    (ops.flash_plan gives 16 splits here) and merges the splits.  Held to
    the plain version, and to the f32 plain version on the same inputs
    within half a bf16 ulp (atol 1e-5, rtol 4e-3, as chip_smoke.py);
    paged == dense bitwise at the same geometry."""
    _, _, _, nq, nkv, hd, hdv = case
    b, sq, skv = 2, 2, 1024
    g = torch.Generator(device="cpu").manual_seed(5)
    q = torch.randn(b, sq, nq, hd, generator=g).to(dev, torch.bfloat16)
    k = torch.randn(b, skv, nkv, hd, generator=g).to(dev, torch.bfloat16)
    v = torch.randn(b, skv, nkv, hdv, generator=g).to(dev, torch.bfloat16)
    i32 = dict(dtype=torch.int32, device=dev)
    q_off = torch.tensor([990, 500], **i32)
    q_len = torch.tensor([2, 1], **i32)
    kv_len = torch.tensor([992, 501], **i32)
    assert ops.flash_plan(b, sq, nq, nkv, hd, hdv)[1] > 1
    args = (q, k, v, q_off, q_len, kv_len)
    got = ops.flash_chunk(*args)
    want = ref.flash_chunk_ref(*args)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2,
                               rtol=1.6e-2)
    want32 = ref.flash_chunk_ref(q.float(), k.float(), v.float(), q_off,
                                 q_len, kv_len)
    torch.testing.assert_close(got.float(), want32, atol=1e-5, rtol=4e-3)
    assert (got[1, 1:] == 0).all()
    kp, vp, bt = _to_pages(k, v, 16)
    assert torch.equal(got, ops.flash_chunk_paged(q, kp, vp, bt, *args[3:]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_on_card(dev, dtype):
    """The absorbed MLA shape; a slot of length 0 is an exact-zero row."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cpu").manual_seed(3)
    q = torch.randn(3, 128, 576, generator=g).to(dev, dt)
    k = torch.randn(3, 64, 1, 576, generator=g).to(dev, dt)
    v = k[..., :512].contiguous()
    lens = torch.tensor([64, 0, 17], dtype=torch.int32, device=dev)
    ops.reset_counters()
    got = ops.flash_decode(q, k, v, lens, scale=192 ** -0.5)
    want = ref.flash_decode_ref(q, k, v, lens, 192 ** -0.5)
    atol, rtol = _tol(dt)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    assert (got[1] == 0).all()
    assert ops.counters["flash_decode"] == ops.counters["flash_chunk"] == 1


# the dense models' serve steps: (name, nq, nkv, hd) at 4 slots, chunk 64
SERVED_ATTN = [("gemma_2b", 8, 1, 256), ("minitron_8b", 32, 8, 128)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SERVED_ATTN, ids=[c[0] for c in SERVED_ATTN])
def test_attention_at_the_dense_models_served_step(dev, dtype, case):
    """flash_chunk and flash_chunk_paged at a gemma-2b / minitron-8b step:
    a prefill chunk ending at key 1024, a decode at key 1001, a prompt's
    first 37 rows, an idle slot, over a 1088-key cache (the serve's
    max_len); against the plain version, rows past q_len exact zeros,
    paged == dense bitwise (one device body)."""
    _, nq, nkv, hd = case
    dt = getattr(torch, dtype)
    b, sq, skv = 4, 64, 1088
    g = torch.Generator(device="cpu").manual_seed(6)
    q = torch.randn(b, sq, nq, hd, generator=g).to(dev, dt)
    k = torch.randn(b, skv, nkv, hd, generator=g).to(dev, dt)
    v = torch.randn(b, skv, nkv, hd, generator=g).to(dev, dt)
    i32 = dict(dtype=torch.int32, device=dev)
    q_off = torch.tensor([1024 - sq, 1000, 0, 0], **i32)
    q_len = torch.tensor([sq, 1, 37, 0], **i32)
    kv_len = q_off + q_len
    args = (q, k, v, q_off, q_len, kv_len)
    ops.reset_counters()
    got = ops.flash_chunk(*args)
    want = ref.flash_chunk_ref(*args)
    atol, rtol = _tol(dt)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    for i, n in enumerate(q_len.tolist()):
        assert (got[i, n:] == 0).all()
    kp, vp, bt = _to_pages(k, v, 16)
    paged = ops.flash_chunk_paged(q, kp, vp, bt, q_off, q_len, kv_len)
    assert torch.equal(got, paged)
    assert ops.counters == {"flash_chunk": 1, "flash_chunk_paged": 1}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_at_gemma_geometry_on_card(dev, dtype):
    """gemma-2b's chunk-1 step: 8 query heads over one KV head at hd 256
    (a 128-row tile holding 16 positions x 8 heads, one position real),
    lengths 1024 / 1 / 517 / 0 over a 1088-key cache."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cpu").manual_seed(7)
    q = torch.randn(4, 8, 256, generator=g).to(dev, dt)
    k = torch.randn(4, 1088, 1, 256, generator=g).to(dev, dt)
    v = torch.randn(4, 1088, 1, 256, generator=g).to(dev, dt)
    lens = torch.tensor([1024, 1, 517, 0], dtype=torch.int32, device=dev)
    got = ops.flash_decode(q, k, v, lens)
    want = ref.flash_decode_ref(q, k, v, lens)
    atol, rtol = _tol(dt)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    assert (got[3] == 0).all()


@pytest.mark.parametrize("chunk", [8, 1])
@pytest.mark.parametrize("arch", ["gemma-2b", "minitron-8b"])
def test_dense_backend_serve_streams_equal_paged_on_card(dev, arch, chunk):
    """A reduced serve with kernels on: kv="dense" (flash_chunk, or
    flash_decode at chunk 1) gives the paged serve's (flash_chunk_paged,
    prefix cache off) greedy streams, f32."""
    import numpy as np

    from repro_torch.core.resolve import KVConfig
    from repro_torch.serving.api import LLM, ServeSpec
    kw = dict(arch=arch, kernels="on", max_batch=2, max_len=64, chunk=chunk)
    rng = np.random.default_rng(0)
    streams, launches = {}, {}
    params = None
    for kv in ("dense", KVConfig(backend="paged", prefix_cache=False)):
        llm = LLM.from_spec(ServeSpec(kv=kv, **kw), params=params,
                            device=dev)
        params = llm.params
        prompts = [rng.integers(0, llm.cfg.vocab_size, n).astype(np.int32)
                   for n in (19, 7, 33)] if not streams else prompts
        ops.reset_counters()
        name = getattr(kv, "backend", kv)
        streams[name] = llm.generate(prompts, 6)
        launches[name] = dict(ops.counters)
    assert streams["dense"] == streams["paged"]
    assert set(launches["paged"]) == {"flash_chunk_paged"}
    assert set(launches["dense"]) == ({"flash_chunk", "flash_decode"}
                                      if chunk == 1 else {"flash_chunk"})


@pytest.mark.parametrize("kv", ["paged", "dense"])
@pytest.mark.parametrize("arch", ["smollm-360m", "phi3.5-moe-42b",
                                  "minicpm3-4b"])
def test_speculated_serve_streams_equal_plain_on_card(dev, arch, kv):
    """A reduced serve with kernels on, f32: the self draft (k 4) and the
    n-gram draft give the plain serve's greedy streams; the verify steps
    launch the serve's attention kernel, the self draft's forwards
    flash_chunk on its dense cache."""
    import numpy as np

    from repro_torch.serving.api import LLM, ServeSpec, SpeculationConfig
    kw = dict(arch=arch, kernels="on", kv=kv, max_batch=2, max_len=64,
              chunk=8)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (19, 7, 33)]
    streams, params = {}, None
    for draft in ("off", "self", "ngram"):
        sc = "off" if draft == "off" else SpeculationConfig(k=4, draft=draft)
        llm = LLM.from_spec(ServeSpec(speculation=sc, **kw), params=params,
                            device=dev)
        params = llm.params
        ops.reset_counters()
        streams[draft] = llm.generate(prompts, 8)
        if draft == "self":
            assert llm.engine.spec_stats()["n_spec_steps"] > 0
            assert ops.counters["flash_chunk"] >= \
                llm.engine.draft.n_forward * llm.cfg.n_layers
    assert streams["self"] == streams["off"] == streams["ngram"]


# (tokens, k): the served k (2 phi3.5, 6 deepseek), 1 and 8 (the
# reference's range), k past 8 (slot groups of 8), one token, the sharded
# serve's 128 tokens
COMBINE_SHAPES = [(50, 6), (1, 1), (128, 2), (256, 8), (33, 9)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [5120, 36])   # 16-byte rows; element-wise
@pytest.mark.parametrize("tk", COMBINE_SHAPES,
                         ids=[f"t{t}_k{k}" for t, k in COMBINE_SHAPES])
def test_permute_and_unpermute_on_card(dev, dtype, h, tk):
    """The gather into 120 rows, then the combine of t tokens from k slots
    each (some -1, and one token's all -1: an exact-zero row)."""
    t, k = tk
    dt = getattr(torch, dtype)
    x = torch.randn(50, h, device=dev).to(dt)
    src = torch.randint(0, 50, (120,), dtype=torch.int32, device=dev)
    src[::7] = -1
    got = ops.permute_tokens(x, src)
    assert torch.equal(got, ref.permute_tokens_ref(x, src))
    assert (got[::7] == 0).all()
    slot = torch.randint(0, 120, (t, k), dtype=torch.int32, device=dev)
    slot[::5, k // 2] = -1
    slot[t // 2] = -1
    w = torch.rand(t, k, device=dev).to(dt)
    ops.reset_counters()
    out = ops.unpermute_tokens(got, slot, w)
    assert ops.counters["unpermute_tokens"] == 1
    want = ref.unpermute_tokens_ref(got, slot, w)
    atol, rtol = (1e-5, 1e-5) if dt == torch.float32 else _tol(dt)
    assert out.dtype == dt and out.shape == (t, h)
    torch.testing.assert_close(out.float(), want.float(), atol=atol,
                               rtol=rtol)
    assert (out[t // 2] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [4096, 36])   # 16-byte rows; element-wise
def test_unpermute_negative_slot_reads_row_zero_on_card(dev, dtype, h):
    """A slot < 0 adds row 0 times 0, as the Pallas kernel does: with an
    inf (and a NaN) in row 0, every token holding a -1 slot comes back NaN
    exactly where the plain version's does, the others finite."""
    dt = getattr(torch, dtype)
    buf = torch.randn(40, h, device=dev).to(dt)
    buf[0, 3] = float("inf")
    buf[0, 5] = float("nan")
    slot = torch.randint(1, 40, (64, 2), dtype=torch.int32, device=dev)
    slot[::3, 1] = -1
    w = torch.rand(64, 2, device=dev)
    out = ops.unpermute_tokens(buf, slot, w)
    want = ref.unpermute_tokens_ref(buf, slot, w)
    assert torch.equal(out.isnan(), want.isnan())
    assert out[::3, 3].isnan().all() and out[1::3].isfinite().all()
    torch.testing.assert_close(out.float(), want.float(), equal_nan=True,
                               atol=1e-5 if dt == torch.float32 else 1e-2,
                               rtol=1e-5 if dt == torch.float32 else 1.6e-2)


@pytest.mark.parametrize("short",
                         ["rows", "units", "y_cap", "rows_per_thread"])
def test_unpermute_entry_refuses_a_grid_short_of_the_plan(dev, short):
    """The combine's C entry checks the grid: one row tile or one column
    chunk fewer than ops.unpermute_plan's, a y past 65535, or more rows a
    thread than k allows is refused (cudaErrorInvalidConfiguration, 9)
    and launches nothing."""
    from repro_torch.kernels import build
    buf = torch.randn(200, 1024, device=dev).to(torch.bfloat16)
    slot = torch.randint(0, 200, (100, 6), dtype=torch.int32, device=dev)
    w = torch.rand(100, 6, device=dev)
    out = torch.zeros(100, 1024, dtype=torch.bfloat16, device=dev)
    gx, gy, rows, _ = ops.unpermute_plan(100, 6, 2048, 2)
    grid = {"rows": (gx - 1, gy, rows), "units": (gx, gy - 1, rows),
            "y_cap": (gx, 65536, rows),
            "rows_per_thread": (gx, gy, rows + 1)}[short]
    rc = build.load().rt_unpermute_tokens(
        buf.data_ptr(), slot.data_ptr(), w.data_ptr(), out.data_ptr(), 100,
        6, 1024, 200, 1, *grid, ops._stream())
    torch.cuda.synchronize()
    assert rc == 9 and (out == 0).all()


@pytest.mark.parametrize("short", ["units", "idle_cta"])
def test_moe_gemm_entry_refuses_a_plan_off_its_tiling(dev, short):
    """The capacity GEMM's C entry refuses a unit count that is not its
    own tiling's (the plan would not cover the work) and a grid with more
    CTAs than units (cudaErrorInvalidConfiguration, 9)."""
    from repro_torch.kernels import build
    x = torch.randn(2, 8, 64, device=dev).to(torch.bfloat16)
    w = torch.randn(2, 64, 256, device=dev).to(torch.bfloat16)
    out = torch.zeros(2, 8, 256, dtype=torch.bfloat16, device=dev)
    ctas, units, _, mt = ops.moe_gemm_plan(2, 8, 64, 256)
    carry = torch.empty(ctas * 16 * mt * ops.moe_gemm_bn(mt),
                        dtype=torch.float32, device=dev)
    flags = torch.zeros(units + 1, dtype=torch.int32, device=dev)
    plan = {"units": (ctas, units - 1), "idle_cta": (units + 1, units)}[short]
    rc = build.load().rt_moe_gemm(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), carry.data_ptr(),
        flags.data_ptr(), 2, 8, 64, 256, *plan, 1, ops._stream())
    torch.cuda.synchronize()
    assert rc == 9 and (out == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,totals,stride", [
    (512, 2048, [200, 56], 256),      # the EP send buffer's layout
    (512, 4096, 300, None),           # the comb gather: a scalar prefix
    (512, 2048, [0, 0], 256),         # every tile empty
    (75, 36, [10, 0, 30], 25),        # n off the tile; h off 8
])
def test_permute_ragged_on_card(dev, dtype, n, h, totals, stride):
    dt = getattr(torch, dtype)
    tot = torch.tensor(totals, dtype=torch.int32, device=dev)
    st = stride or n
    row = torch.arange(n, device=dev)
    seg = (row // st).clamp_max(tot.numel() - 1)
    valid = (row - seg * st) < tot.reshape(-1)[seg]
    x = torch.randn(97, h, device=dev).to(dt)
    src = torch.randint(0, 97, (n,), dtype=torch.int32, device=dev)
    src[~valid] = -1
    src[::9] = -1
    ops.reset_counters()
    got = ops.permute_tokens_ragged(x, src, tot, seg_stride=stride)
    assert ops.counters["permute_tokens_ragged"] == 1
    assert torch.equal(got, ref.permute_tokens_ragged_ref(x, src, tot))
    assert (got[~valid] == 0).all()
    # garbage in the skipped tiles' src must not be read
    if not valid.any():
        junk = torch.randint(0, 97, (n,), dtype=torch.int32, device=dev)
        assert (ops.permute_tokens_ragged(x, junk, tot, seg_stride=stride)
                == 0).all()


def _gather_input(dev, dt, t, h, misaligned):
    """(t, h) random rows; ``misaligned``: a contiguous view starting one
    element past a 16-byte boundary (the wrapper copies it to an aligned
    buffer before the 16-byte kernel)."""
    flat = torch.randn(t * h + 1, device=dev).to(dt)
    x = flat[1:].view(t, h) if misaligned else flat[:-1].view(t, h)
    assert (x.data_ptr() % 16 != 0) == misaligned and x.is_contiguous()
    return x


# (name, N, h, misaligned): one row; 70 000 rows; a width off the 8-unit
# chunk (1032 bf16 = 129 16-byte units); a misaligned x; element-wise rows
GATHER_EDGES = [("n1", 1, 4096, False), ("n70000", 70_000, 64, False),
                ("width_off_chunk", 300, 1032, False),
                ("misaligned_x", 100, 2048, True),
                ("elementwise", 77, 4098, False)]


@pytest.mark.parametrize("ragged", [False, True], ids=["plain", "ragged"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GATHER_EDGES,
                         ids=[c[0] for c in GATHER_EDGES])
def test_gathers_on_card_at_plan_edges(dev, dtype, case, ragged):
    """Both gathers bitwise against their plain versions at the launch
    plan's edges, one launch each; the ragged one under two segments
    whose prefixes leave empty tiles."""
    _, n, h, misaligned = case
    dt = getattr(torch, dtype)
    x = _gather_input(dev, dt, 97, h, misaligned)
    src = torch.randint(0, 97, (n,), dtype=torch.int32, device=dev)
    src[::5] = -1
    ops.reset_counters()
    if ragged:
        st = -(-n // 2)
        tot = torch.tensor([min(st, 40), st // 3], dtype=torch.int32,
                           device=dev)
        row = torch.arange(n, device=dev)
        seg = row // st
        src[(row - seg * st) >= tot[seg]] = -1
        got = ops.permute_tokens_ragged(x, src, tot, seg_stride=st)
        want = ref.permute_tokens_ragged_ref(x, src, tot, seg_stride=st)
    else:
        got = ops.permute_tokens(x, src)
        want = ref.permute_tokens_ref(x, src)
    assert ops.counters["permute_tokens_ragged" if ragged
                        else "permute_tokens"] == 1
    assert torch.equal(got, want)
    assert (got[src < 0] == 0).all()


def _tile_empty(base, n, totals, stride, tile=32):
    """The ragged kernel's verdict on the tile at ``base``: every segment
    it touches starts its part of the tile at or past its prefix."""
    last = min(base + tile, n) - 1
    return all(max(base, r * stride) - r * stride >= totals[r]
               for r in range(base // stride, last // stride + 1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [2048, 36])   # 16-byte rows; element-wise
def test_permute_ragged_empty_tiles_ignore_junk_src(dev, dtype, h):
    """Segments 40 rows apart with prefixes 10, 0, 20 over 100 rows: the
    tile of rows 32-63 straddles two empty tails and comes back zero
    although src there holds valid-looking junk; the live tiles gather
    every row, junk included (validity rides in src)."""
    dt = getattr(torch, dtype)
    x = torch.randn(97, h, device=dev).to(dt)
    totals, stride, n = [10, 0, 20], 40, 100
    junk = torch.randint(0, 97, (n,), dtype=torch.int32, device=dev)
    got = ops.permute_tokens_ragged(
        x, junk, torch.tensor(totals, dtype=torch.int32, device=dev),
        seg_stride=stride)
    empty = [b for b in range(0, n, 32) if _tile_empty(b, n, totals, stride)]
    assert empty == [32]
    for b in range(0, n, 32):
        rows = slice(b, min(b + 32, n))
        want = (torch.zeros_like(got[rows]) if b in empty
                else x[junk[rows].long()])
        assert torch.equal(got[rows], want)


@pytest.mark.parametrize("short", ["rows", "units", "y_cap"])
def test_gather_entry_refuses_a_grid_short_of_the_plan(dev, short):
    """The C entry checks the grid it is given: one row tile or one column
    chunk fewer than ops.permute_plan's, or a y past 65535, is refused
    (cudaErrorInvalidConfiguration, 9) and launches nothing."""
    from repro_torch.kernels import build
    x = torch.randn(40, 1024, device=dev).to(torch.bfloat16)
    src = torch.randint(0, 40, (100,), dtype=torch.int32, device=dev)
    out = torch.zeros(100, 1024, dtype=torch.bfloat16, device=dev)
    gx, gy, _ = ops.permute_plan(100, 2048, 2)
    grid = {"rows": (gx - 1, gy), "units": (gx, gy - 1),
            "y_cap": (gx, 65536)}[short]
    rc = build.load().rt_permute_tokens(
        x.data_ptr(), src.data_ptr(), out.data_ptr(), 100, 40, 1024, 2,
        *grid, ops._stream())
    torch.cuda.synchronize()
    assert rc == 9 and (out == 0).all()


def _recurrent_calls(arch, cfg, params):
    """(params, [call(p, x, (s0, s1)) -> (out, (s0, s1))]) of the reduced
    model's first recurrent layer."""
    from repro_torch.models import ssm
    if arch == "rwkv6-1.6b":
        def time_mix(p, x, st):
            return ssm.rwkv6_time_mix(p["tm"], x, cfg, state=st[0],
                                      x_prev=st[1])

        def channel_mix(p, x, st):
            out, last = ssm.rwkv6_channel_mix(p["cm"], x, cfg, x_prev=st[1])
            return out, (None, last)
        return params["groups"][0][0], [time_mix, channel_mix]
    p = params["groups"][0][0]["l0"]["rglru"]

    def block(p, x, st):
        return ssm.rglru_block(p, x, cfg, state=st[0], conv_state=st[1])
    return p, [block]


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to(v, dev) for v in tree)
    return tree.to(dev) if torch.is_tensor(tree) else tree


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-9b"])
def test_recurrent_layers_on_card_match_the_cpu(dev, arch):
    """The reduced model's recurrent layers (rwkv6 time- and channel-mix;
    the RG-LRU block), their zero-initialised leaves drawn, on the card
    against the same call on the CPU, f32, from zero state and then from
    the state the first call carried; within rtol 1e-4 plus 1e-5 of the
    tensor's largest |value|, at most 5e-4 (the wkv state sums outer
    products of ~8-wide rows, so a small entry carries the rounding of the
    large ones: 1.75e-4 on an entry of 0.53 on an H100)."""
    import repro_torch.configs as C
    from _recurrent_leaves import draw_recurrent_leaves
    from repro_torch.models import model as M
    cfg = C.get_reduced(arch)
    params = draw_recurrent_leaves(M.init_params(
        torch.Generator().manual_seed(0), cfg, torch.float32, "cpu"))
    g = torch.Generator().manual_seed(1)
    p, calls = _recurrent_calls(arch, cfg, params)
    x = torch.randn(2, 9, cfg.d_model, generator=g)
    p_dev = _to(p, dev)
    for call in calls:
        st_cpu = st_dev = (None, None)
        for _ in range(2):                       # zero, then carried
            out_c, st_cpu = call(p, x, st_cpu)
            out_d, st_dev = call(p_dev, x.to(dev), st_dev)
            for got, want in ((out_d, out_c),) + tuple(zip(st_dev, st_cpu)):
                if want is not None:
                    torch.testing.assert_close(
                        got.cpu(), want, rtol=1e-4,
                        atol=min(5e-4, 1e-5 * max(1.0, float(
                            want.abs().max()))))


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-9b"])
def test_legacy_serve_on_card(dev, arch):
    """A reduced legacy serve on the card, f32, window 8 (the ring wraps),
    the zero-initialised recurrent leaves drawn: kernels on launch none and
    give the kernels-off streams; the cached greedy loop's logits match the
    stateless forward's."""
    import dataclasses

    import numpy as np

    import repro_torch.configs as C
    from _recurrent_leaves import draw_recurrent_leaves
    from repro_torch.models import model as M
    from repro_torch.serving.api import LLM, ServeSpec
    cfg = dataclasses.replace(C.get_reduced(arch), window_size=8)
    params = draw_recurrent_leaves(M.init_params(
        torch.Generator(device=dev).manual_seed(0), cfg, torch.float32, dev))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (20, 32, 70)]
    streams = {}
    for kern in ("on", "off"):
        llm = LLM.from_spec(ServeSpec(arch=arch, kernels=kern, max_batch=2,
                                      max_len=256), cfg=cfg, params=params,
                            device=dev)
        assert llm.engine.legacy
        ops.reset_counters()
        streams[kern] = llm.generate(prompts, 8)
        assert not ops.counters
    assert streams["on"] == streams["off"]
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 30))).to(dev)
    full = M.forward(params, cfg, tokens=toks).logits
    cache = M.init_cache(cfg, 2, 64, torch.float32, dev)
    rows = [M.forward(params, cfg, tokens=toks[:, :6],
                      cache=cache).logits]
    for i in range(6, 30):
        rows.append(M.forward(params, cfg, tokens=toks[:, i:i + 1],
                              cache=cache).logits)
    got = torch.cat(rows, 1)
    torch.testing.assert_close(got, full, rtol=1e-4,
                               atol=1e-4 * float(full.abs().max()))


# the frontend serves' attention: (name, nq, nkv, hd, front + bucket, S)
FRONT_ATTN = [("qwen2_vl_7b", 28, 4, 128, 256 + 1024, 2048),
              ("whisper_tiny", 6, 6, 64, 256, 512)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FRONT_ATTN, ids=[c[0] for c in FRONT_ATTN])
def test_attention_at_the_frontend_geometries(dev, dtype, case):
    """The legacy path's attention at the frontend serves' geometries: the
    blocking prefill (batch 1, q_offset 0, kv_len the rows: qwen2-vl's 256
    patch rows and a 1024-token bucket at a group of 7, whisper's
    256-token bucket at MHA) on the (1, max_len) cache through
    flash_chunk, and the decode of 4 slots on the (4, max_len) cache
    through flash_decode (lengths S / 1 / S/2 + 5 / 0): against the plain
    version, a length-0 slot an exact-zero row."""
    _, nq, nkv, hd, sq, skv = case
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cpu").manual_seed(8)
    q = torch.randn(1, sq, nq, hd, generator=g).to(dev, dt)
    k = torch.randn(1, skv, nkv, hd, generator=g).to(dev, dt)
    v = torch.randn(1, skv, nkv, hd, generator=g).to(dev, dt)
    i32 = dict(dtype=torch.int32, device=dev)
    args = (q, k, v, torch.tensor([0], **i32), torch.tensor([sq], **i32),
            torch.tensor([sq], **i32))
    atol, rtol = _tol(dt)
    torch.testing.assert_close(ops.flash_chunk(*args).float(),
                               ref.flash_chunk_ref(*args).float(),
                               atol=atol, rtol=rtol)
    q = torch.randn(4, nq, hd, generator=g).to(dev, dt)
    k = torch.randn(4, skv, nkv, hd, generator=g).to(dev, dt)
    v = torch.randn(4, skv, nkv, hd, generator=g).to(dev, dt)
    lens = torch.tensor([skv, 1, skv // 2 + 5, 0], **i32)
    got = ops.flash_decode(q, k, v, lens)
    torch.testing.assert_close(got.float(),
                               ref.flash_decode_ref(q, k, v, lens).float(),
                               atol=atol, rtol=rtol)
    assert (got[3] == 0).all()


def _drawn_norms(tree, seed):
    """The port's params with every zero-initialised norm weight drawn
    from N(0, 0.25), so a swapped norm would show."""
    g = torch.Generator().manual_seed(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: (0.5 * torch.randn(v.shape, generator=g)).to(
                v.device, v.dtype)
                if k in ("norm", "mlp_norm", "final_norm")
                and torch.is_tensor(v) else walk(v)
                for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node
    return walk(tree)


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "whisper-tiny"])
def test_frontend_serve_on_card(dev, arch):
    """A reduced frontend serve on the legacy path, f32, with a seeded stub
    (qwen2-vl's patch embeddings, whisper's frames) and the norms drawn:
    kernels on (flash_chunk in the blocking prefill, flash_decode in the
    decode) give the kernels-off streams; the cached loop through the
    kernels matches the stateless forward within rtol 1e-4 plus 1e-4 of
    the largest |logit|."""
    import numpy as np

    import repro_torch.configs as C
    from repro_torch.models import model as M
    from repro_torch.serving.api import LLM, ServeSpec
    cfg = C.get_reduced(arch)
    params = _drawn_norms(M.init_params(
        torch.Generator(device=dev).manual_seed(0), cfg, torch.float32, dev),
        1)
    g = torch.Generator(device="cpu").manual_seed(2)
    if cfg.frontend == "vision_stub":
        name = "embeds"
        stub = 0.02 * torch.randn(1, cfg.n_frontend_tokens, cfg.d_model,
                                  generator=g)
    else:
        name = "frames"
        stub = torch.randn(1, cfg.encoder.n_frames, cfg.encoder.d_model,
                           generator=g)
    stub = stub.to(dev)

    def embeds_fn(b):
        return {name: stub.expand(b, *stub.shape[1:])}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (20, 32, 70)]
    streams, launches, plan = {}, {}, None
    for kern in ("on", "off"):
        llm = LLM.from_spec(ServeSpec(arch=arch, kernels=kern, max_batch=2,
                                      max_len=256), cfg=cfg, params=params,
                            embeds_fn=embeds_fn, device=dev)
        assert llm.engine.legacy
        ops.reset_counters()
        streams[kern] = llm.generate(prompts, 8)
        launches[kern] = dict(ops.counters)
        plan = llm.engine.plan if kern == "on" else plan
    assert streams["on"] == streams["off"]
    assert set(launches["on"]) == {"flash_chunk", "flash_decode"}
    assert not launches["off"]
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 24))).to(dev)
    full = M.forward(params, cfg, tokens=toks, **{name: stub}).logits
    front = full.shape[1] - toks.shape[1]
    cache = M.init_cache(cfg, 1, 128, torch.float32, dev)
    rows = [M.forward(params, cfg, plan, tokens=toks[:, :6], cache=cache,
                      **{name: stub}).logits[:, front:]]
    for i in range(6, 24):
        rows.append(M.forward(params, cfg, plan, tokens=toks[:, i:i + 1],
                              cache=cache).logits)
    got = torch.cat(rows, 1)
    want = full[:, front:]
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))


def test_every_wrapper_refuses_autograd_on_card(dev):
    """No kernel has a backward: on the card too a wrapper given an input
    that requires grad raises under grad mode (it would otherwise return a
    tensor with no gradient history), and launches under no_grad."""
    from _kernel_calls import wrapper_calls
    for name, call in wrapper_calls(dev).items():
        ops.reset_counters()
        with pytest.raises(RuntimeError, match=f"{name}: .*no backward"):
            call(True)
        assert not ops.counters, name
        with torch.no_grad():
            call(True)
        torch.cuda.synchronize()
        assert sum(ops.counters.values()) >= 1, name


# one reduced config a family: the loss to 1e-5 (whisper, whose float32
# outputs are chaotic under a change of summation order: 1e-4), the card's
# gradients against the CPU's within the CPU parity tests' bounds
# (tests/_torch_train_helpers.py, GRAD_BOUND), and the weights after an
# AdamW step whose eps (1e-2, no clip) keeps it smooth in the gradient,
# within 2 lr |dg| / eps plus the new weight's last rounding (the card
# fuses p - lr u into one multiply-add)
TRAIN_FAMILIES = {"smollm-360m": 6e-4, "phi3.5-moe-42b": 1.5e-3,
                  "rwkv6-1.6b": 1e-4, "recurrentgemma-9b": 1e-3,
                  "qwen2-vl-7b": 1e-3, "whisper-tiny": 1.5e-2}


def _zero_leaves_drawn(tree, gen):
    """Every all-zero leaf (norms, recurrent leaves) drawn: token-shift
    mixes in [0, 1], lambda_p from N(-2, 1), the rest N(0, 0.25)."""
    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, key) for v in node]
        if node.any():
            return node
        if key == "mu":
            return torch.rand(node.shape, generator=gen)
        z = torch.randn(node.shape, generator=gen)
        return z - 2.0 if key == "lambda_p" else 0.5 * z
    return walk(tree)


@pytest.mark.parametrize("arch", sorted(TRAIN_FAMILIES))
def test_train_step_on_card_matches_cpu(dev, arch):
    import repro_torch.configs as C
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import init_params
    from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                                init_opt_state)
    from repro_torch.training.train_step import value_and_grad
    from repro_torch.training.tree import flatten_with_paths, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = C.get_reduced(arch)
    gen = torch.Generator().manual_seed(3)
    cpu = _zero_leaves_drawn(init_params(gen, cfg, torch.float32, "cpu"),
                             gen)
    card = tree_map(lambda t: t.to(dev), cpu)
    b = {k: torch.from_numpy(v) for k, v in next(iter(SyntheticLM(
        cfg, DataConfig(batch=2, seq_len=32, seed=0)).batches(1))).items()}
    ops.reset_counters()
    (l_card, _), g_card = value_and_grad(card, {k: v.to(dev) for k, v in
                                                b.items()}, cfg)
    (l_cpu, _), g_cpu = value_and_grad(cpu, b, cfg)
    torch.testing.assert_close(l_card.cpu(), l_cpu, atol=0, rtol=1e-4
                               if arch == "whisper-tiny" else 1e-5)
    for (p, a), (_, c) in zip(flatten_with_paths(g_card),
                              flatten_with_paths(g_cpu)):
        err = float((a.cpu() - c).abs().max() / c.abs().max().clamp_min(
            1e-30))
        assert err <= TRAIN_FAMILIES[arch], (p, err)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-2,
                      grad_clip=0.0)
    adamw_update(opt, g_card, init_opt_state(card), card)
    adamw_update(opt, g_cpu, init_opt_state(cpu), cpu)
    for (p, a), (_, c), (_, ga), (_, gc) in zip(
            flatten_with_paths(card), flatten_with_paths(cpu),
            flatten_with_paths(g_card), flatten_with_paths(g_cpu)):
        allowed = 2 * opt.lr * (ga.cpu() - gc).abs() / opt.eps \
            + 2.0 ** -23 * (c.abs() + opt.lr)
        assert ((a.cpu() - c).abs() <= allowed).all(), p
    assert not ops.counters


def test_mesh_training_parity_on_card(dev, tmp_path):
    """4 ranks over gloo on the one card, phi3.5-moe reduced, f32,
    mixserve 2x2 with sp and fsdp on: the first step's loss within 1e-5
    and every gradient block within GRAD_BOUND of the unsharded step's on
    the card, the weights after two AdamW steps within Adam's move under
    the gradients' differences (``chip_smoke.py`` phase 7 (a))."""
    import _torch_dist_train_ranks as D
    from repro_torch.launch.ranks import run_ranks
    ranks = run_ranks(D.card_parity_rank, 4, workdir=tmp_path,
                      device="cuda", timeout_s=600)
    for r, res in enumerate(ranks):
        assert res["loss"] <= 1e-5, (r, res)
        assert res["grad"] <= D.CARD_GRAD_BOUND, (r, res)
        assert res["ratio"] <= 1.0, (r, res)


# ---------------------------------------------------------------------------
# launch plans: pinned by keyword, registered in the autotune cache
# ---------------------------------------------------------------------------

@pytest.fixture
def plans(monkeypatch):
    """The autotune cache empty and not persisted for one test."""
    from repro_torch.kernels import autotune
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", "")
    monkeypatch.setattr(autotune, "_CACHE", {})
    monkeypatch.setattr(autotune, "_ANALYTIC", set())
    monkeypatch.setattr(autotune, "_persist_loaded", True)
    return autotune


@pytest.mark.parametrize("case", ATTN_CASES, ids=[c[0] for c in ATTN_CASES])
def test_every_attention_plan_keeps_paged_equal_to_dense(dev, plans, case):
    """Each plan the bf16 body takes (rows 64 / 128, n_split 1-16): within
    tolerance of the plain version, paged == dense bit for bit, and a
    registered plan is the one the unpinned call launches."""
    _, b, sq, nq, nkv, hd, hdv = case
    q, k, v, q_off, q_len, kv_len = _dense_case(dev, torch.bfloat16, b, sq,
                                                nq, nkv, hd, hdv, skv=48)
    kp, vp, bt = _to_pages(k, v, 16)
    want = ref.flash_chunk_ref(q, k, v, q_off, q_len, kv_len)
    for rows in (64, 128) if hd <= 256 else (64,):
        for n_split in (1, 2, 3, 8, 16):
            pin = dict(rows=rows, n_split=n_split)
            dense = ops.flash_chunk(q, k, v, q_off, q_len, kv_len, **pin)
            paged = ops.flash_chunk_paged(q, kp, vp, bt, q_off, q_len,
                                          kv_len, **pin)
            torch.testing.assert_close(dense.float(), want.float(),
                                       atol=5e-3, rtol=1.6e-2)
            assert torch.equal(dense, paged), pin
    n0 = ops.flash_plan(b, sq, nq, nkv, hd, hdv)[1]
    pin = dict(rows=64, n_split=3 if n0 != 3 else 2)     # not the analytic
    plans.register("flash", (b, sq, nq, nkv, hd, hdv), torch.bfloat16, pin)
    assert torch.equal(ops.flash_chunk(q, k, v, q_off, q_len, kv_len),
                       ops.flash_chunk(q, k, v, q_off, q_len, kv_len, **pin))
    assert torch.equal(ops.flash_chunk_paged(q, kp, vp, bt, q_off, q_len,
                                             kv_len),
                       ops.flash_chunk(q, k, v, q_off, q_len, kv_len, **pin))


def test_gate_combine_and_capacity_gemm_bits_do_not_move_with_the_plan(
        dev, plans):
    """The router gate's warps, the combine's rows and the capacity GEMM's
    grid change no bit of their outputs; a refused plan raises before a
    launch."""
    g = torch.Generator(device="cpu").manual_seed(7)
    lg = torch.randn(300, 160, generator=g).to(dev, torch.bfloat16)
    outs = [ops.topk_gate(lg, 6, warps=w) for w in (1, 2, 4, 8)]
    assert all(torch.equal(a, b) for o in outs[1:]
               for a, b in zip(o, outs[0]))
    buf = torch.randn(600, 2048, generator=g).to(dev, torch.bfloat16)
    slot = torch.randperm(600, generator=g).reshape(300, 2).to(
        dev, torch.int32)
    w = torch.rand(300, 2, generator=g).to(dev)
    assert torch.equal(ops.unpermute_tokens(buf, slot, w, rows=1),
                       ops.unpermute_tokens(buf, slot, w, rows=2))
    x = torch.randn(8, 40, 1024, generator=g).to(dev, torch.bfloat16)
    wt = (0.02 * torch.randn(8, 1024, 768, generator=g)).to(dev,
                                                           torch.bfloat16)
    units = ops.moe_gemm_plan(8, 40, 1024, 768)[1]
    ref_out = ops.moe_gemm(x, wt, ctas=min(ops.SMS, units))
    for ctas in (1, 7, 64, min(ops.SMS, units) - 1):
        assert torch.equal(ops.moe_gemm(x, wt, ctas=ctas), ref_out), ctas
    ops.reset_counters()
    for bad in (lambda: ops.topk_gate(lg, 6, warps=3),
                lambda: ops.unpermute_tokens(buf, slot, w, rows=3),
                lambda: ops.moe_gemm(x, wt, ctas=units + 1)):
        with pytest.raises(ValueError):
            bad()
    torch.cuda.synchronize()
    assert not ops.counters


def _write_cases(dt):
    """(write, arguments) on the CPU: the dense per-slot write (a ragged
    tail, an idle slot, rows past the buffer), its one-row decode with
    ``valid_len``, the paged write at MLA's latent width (-1 table entries,
    an idle slot) and both writes with no valid row."""
    from repro_torch.models import layers as L
    g = torch.Generator(device="cpu").manual_seed(3)
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32)     # noqa: E731
    buf = torch.randn(4, 16, 2, 8, generator=g).to(dt)
    new = torch.randn(4, 8, 2, 8, generator=g).to(dt)
    pool = torch.randn(9, 4, 512, generator=g).to(dt)
    newc = torch.randn(3, 6, 512, generator=g).to(dt)
    bt = torch.tensor([[3, 7, 1, -1], [0, 5, -1, -1], [-1] * 4],
                      dtype=torch.int32)
    return [
        (L.write_cache, (buf, new, i32(2, 12, 5, 0), i32(8, 6, 0, 3))),
        (L.write_cache, (buf, new, i32(14, 3, 15, 16), i32(8, 8, 2, 1))),
        (L.write_cache, (buf, new[:, :1], i32(0, 15, 7, 16), i32(1, 1, 0, 1))),
        (L.write_cache, (buf, new, i32(3, 0, 7, 1), i32(0, 0, 0, 0))),
        (L.write_cache_paged, (pool, newc, i32(5, 2, 0), bt, i32(6, 6, 0))),
        (L.write_cache_paged, (pool, newc[:, :1], i32(9, 7, 3), bt,
                               i32(1, 1, 1))),
        (L.write_cache_paged, (pool, newc, i32(5, 2, 0), bt, i32(0, 0, 0))),
    ]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_writes_make_no_host_sync_on_card(dev, dtype):
    """Every KV-cache write of the step synchronizes nothing on the card
    and writes the same bits as on the CPU."""
    from repro_torch.analysis import trace_contract as TCt
    dt = getattr(torch, dtype)
    bits = torch.int16 if dt == torch.bfloat16 else torch.int32
    for n, (write, args) in enumerate(_write_cases(dt)):
        want = write(*[a.clone() for a in args])
        on = [a.to(dev) for a in args]
        assert TCt.sync_issues(write, *on) == [], n
        assert torch.equal(on[0].cpu().view(bits), want.view(bits)), n
