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
def test_topk_gate_on_card(dev, dtype):
    dt = getattr(torch, dtype)
    logits = torch.randn(300, 16, device=dev).to(dt)
    logits[0] = 0.5
    logits[1, 9] = logits[1, 4] = 3.0
    w, i = ops.topk_gate(logits, 2)
    w_r, i_r = ref.topk_gate_ref(logits, 2)
    assert torch.equal(i, i_r)
    assert i[0].tolist() == [0, 1] and i[1].tolist() == [4, 9]
    torch.testing.assert_close(w, w_r, atol=1e-6, rtol=0)


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


# (name, B, sq, nq, nkv, hd, hdv): GQA, MLA expanded (g = 1, hd != hdv) and
# MLA absorbed (nkv = 1, g = 128 split across CTAs, hd 576 / hdv 512)
ATTN_CASES = [("gqa", 4, 8, 12, 4, 64, 64),
              ("mha_64", 4, 8, 4, 4, 64, 64),
              ("gqa_128", 4, 8, 32, 8, 128, 128),
              ("mla_expanded", 4, 8, 4, 4, 192, 128),
              ("mla_absorbed", 4, 3, 128, 1, 576, 512)]


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [5120, 36])   # 16-byte rows; element-wise
def test_permute_and_unpermute_on_card(dev, dtype, h):
    dt = getattr(torch, dtype)
    x = torch.randn(50, h, device=dev).to(dt)
    src = torch.randint(0, 50, (120,), dtype=torch.int32, device=dev)
    src[::7] = -1
    got = ops.permute_tokens(x, src)
    assert torch.equal(got, ref.permute_tokens_ref(x, src))
    assert (got[::7] == 0).all()
    slot = torch.randint(0, 120, (50, 6), dtype=torch.int32, device=dev)
    slot[::5, 2] = -1
    w = torch.rand(50, 6, device=dev).to(dt)
    out = ops.unpermute_tokens(got, slot, w)
    want = ref.unpermute_tokens_ref(got, slot, w)
    atol, rtol = (1e-5, 1e-5) if dt == torch.float32 else _tol(dt)
    assert out.dtype == dt
    torch.testing.assert_close(out.float(), want.float(), atol=atol,
                               rtol=rtol)


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
