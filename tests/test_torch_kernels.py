"""The port's kernels: plain versions against the reference's oracles and
its interpret-mode Pallas kernels (flash_chunk_paged, flash_chunk,
flash_decode, topk_gate, grouped_gemm, permute_tokens,
permute_tokens_ragged, unpermute_tokens),
and the wrappers' checks.  The CUDA
kernels themselves are held against these plain versions on the card by
tests/test_torch_gpu.py and chip_smoke.py.

Tolerances: float32 plain versions agree with the reference to 1e-5
(different summation order only); top-k ids and every exact-zero contract
are exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_helpers import jj, paged_tables, tt  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

RTOL = ATOL = 1e-5


def _flash_case(seed=0):
    """A mixed step with every contract: slot 0 prefills mid-prompt, slot 1
    decodes, slot 2 is idle (q_len 0), slot 3 has live rows but kv_len 0;
    block tables end in -1."""
    rng = np.random.default_rng(seed)
    b, sq, nq, nkv, hd, page, nb = 4, 8, 4, 2, 16, 4, 5
    q_off = np.array([6, 13, 0, 0], np.int32)
    q_len = np.array([8, 1, 0, 3], np.int32)
    kv_len = np.array([14, 14, 0, 0], np.int32)
    used = [-(-int(n) // page) for n in kv_len]
    bt, n_pages = paged_tables(b, nb, used, seed)
    q = rng.standard_normal((b, sq, nq, hd)).astype(np.float32)
    kp = rng.standard_normal((n_pages, page, nkv, hd)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page, nkv, hd)).astype(np.float32)
    return q, kp, vp, bt, q_off, q_len, kv_len


def test_flash_chunk_paged_plain_matches_reference():
    args = _flash_case()
    got = ref.flash_chunk_paged_ref(*map(tt, args)).numpy()
    want_ref = np.asarray(rref.flash_chunk_paged_ref(*map(jj, args)))
    want_ker = np.asarray(rops.flash_chunk_paged(*map(jj, args)))
    np.testing.assert_allclose(got, want_ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want_ker, rtol=RTOL, atol=ATOL)
    q_len, kv_len = args[5], args[6]
    for i in range(len(q_len)):
        assert (got[i, q_len[i]:] == 0).all()      # rows past q_len
    assert (got[3] == 0).all()                     # kv_len == 0
    assert (args[3] == -1).any()


def test_flash_chunk_paged_wrapper_cpu_is_plain_and_uncounted():
    args = tuple(map(tt, _flash_case(1)))
    ops.reset_counters()
    got = ops.flash_chunk_paged(*args, scale=0.25)
    torch.testing.assert_close(got, ref.flash_chunk_paged_ref(*args, 0.25),
                               rtol=0, atol=0)
    assert ops.counters["flash_chunk_paged"] == 0


# (E, k): the served routers (phi3.5, deepseek-v2), the paper's (qwen3-235b,
# deepseek-r1), k = E at an odd E, k = 32 (the most the kernel keeps)
TOPK_CASES = [(16, 2), (160, 6), (128, 8), (256, 8), (5, 5), (40, 32)]


def _topk_logits(t, e, seed):
    """Seeded logits with row 0 all tied (ids 0, 1, ...), row 1 a tied top
    pair (ids 1, E - 2) and row 2 -inf in every other entry (zero
    probabilities, picked lowest id first once the finite ones are)."""
    logits = np.random.default_rng(seed).standard_normal((t, e)) \
        .astype(np.float32)
    logits[0] = 0.25
    logits[1, e - 2] = logits[1, 1] = 5.0
    logits[2, 1::2] = -np.inf
    return logits


@pytest.mark.parametrize("renorm", [True, False], ids=["renorm", "raw"])
@pytest.mark.parametrize("ek", TOPK_CASES,
                         ids=[f"E{e}_k{k}" for e, k in TOPK_CASES])
def test_topk_gate_plain_matches_reference_ties_lowest_index(ek, renorm):
    """The plain version against the reference's oracle and its
    interpret-mode Pallas kernel: ids exact, weights within 1e-6."""
    e, k = ek
    logits = _topk_logits(24, e, e * 100 + k)
    w, i = ref.topk_gate_ref(tt(logits), k, renorm)
    rw, ri = rref.topk_gate_ref(jj(logits), k, renorm)
    kw, ki = rops.topk_gate(jj(logits), k, renorm=renorm, interpret=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ki))
    np.testing.assert_allclose(w.numpy(), np.asarray(rw), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(kw), rtol=1e-6,
                               atol=1e-6)
    assert i[0].tolist() == list(range(k))
    assert i[1].tolist()[:2] == [1, e - 2]
    odd = list(range(1, e, 2))                 # the -inf entries of row 2
    n_fin = e - len(odd)
    assert all(x % 2 == 0 for x in i[2].tolist()[:n_fin])
    assert i[2].tolist()[n_fin:] == odd[:max(0, k - n_fin)]
    assert (w[2, n_fin:] == 0).all()
    assert w.dtype == torch.float32 and i.dtype == torch.int32


@pytest.mark.parametrize("e,k", [(257, 2), (16, 0), (5, 6), (64, 33)])
def test_topk_gate_wrapper_rejects_outside_the_envelope(e, k):
    with pytest.raises(ValueError, match="E <= 256"):
        ops.topk_gate(torch.randn(4, e), k)


def test_grouped_gemm_plain_matches_reference():
    """Empty expert, a boundary inside a row tile, rows past offsets[-1]
    exactly zero."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((30, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16, 24)).astype(np.float32)
    off = np.array([0, 7, 7, 19, 25], np.int32)
    got = ref.grouped_gemm_ref(tt(x), tt(w), tt(off)).numpy()
    want_ker = np.asarray(rops.grouped_gemm(jj(x), jj(w), jj(off)))
    want_ref = np.asarray(rref.grouped_gemm_ref(jj(x), jj(w), jj(off)))
    np.testing.assert_allclose(got, want_ker, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[:25], want_ref[:25], rtol=RTOL,
                               atol=ATOL)
    assert (got[25:] == 0).all()


def test_permute_and_combine_plain_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 8)).astype(np.float32)
    src = np.array([3, -1, 0, 5, 5, -1], np.int32)
    np.testing.assert_array_equal(
        ref.permute_tokens_ref(tt(x), tt(src)).numpy(),
        np.asarray(rref.permute_tokens_ref(jj(x), jj(src))))
    slot = np.array([[0, 2], [1, -1], [5, 4]], np.int32)
    wts = rng.random((3, 2)).astype(np.float32)
    np.testing.assert_allclose(
        ref.unpermute_tokens_ref(tt(x), tt(slot), tt(wts)).numpy(),
        np.asarray(rref.unpermute_tokens_ref(jj(x), jj(slot), jj(wts))),
        rtol=RTOL, atol=ATOL)


def _dense_case(b, sq, nq, nkv, hd, hdv, skv=20, seed=0):
    """A mixed step on a dense cache: slot 0 prefills mid-prompt, slot 1
    decodes, slot 2 is idle (q_len 0), slot 3 has live rows but kv_len 0."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, nq, hd)).astype(np.float32)
    k = rng.standard_normal((b, skv, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, skv, nkv, hdv)).astype(np.float32)
    q_off = np.array([9, 15, 0, 0], np.int32)[:b]
    q_len = np.array([sq, 1, 0, 2], np.int32)[:b]
    kv_len = np.array([9 + sq, 16, 0, 0], np.int32)[:b]
    return q, k, v, q_off, q_len, kv_len


# (B, sq, nq, nkv, hd, hdv): GQA (g = 3); MLA absorbed-like (nkv = 1,
# hd != hdv); MLA expanded-like (g = 1, hd != hdv)
DENSE_CASES = {"gqa": (4, 6, 6, 2, 16, 16),
               "absorbed": (4, 3, 8, 1, 24, 16),
               "expanded": (4, 6, 4, 4, 24, 16)}


@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_flash_chunk_plain_matches_reference(case):
    args = _dense_case(*DENSE_CASES[case])
    got = ref.flash_chunk_ref(*map(tt, args), 0.3).numpy()
    want_ref = np.asarray(rref.flash_chunk_ref(*map(jj, args), 0.3))
    want_ker = np.asarray(rops.flash_chunk(*map(jj, args), scale=0.3,
                                           bq=4, bs=8))
    np.testing.assert_allclose(got, want_ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want_ker, rtol=RTOL, atol=ATOL)
    q_len = args[4]
    for i in range(len(q_len)):
        assert (got[i, q_len[i]:] == 0).all()      # rows past q_len
    assert (got[3] == 0).all()                     # kv_len == 0


@pytest.mark.parametrize("case", ["gqa", "absorbed"])
def test_flash_decode_plain_matches_reference(case):
    """The decode wrapper's contract on lengths (a 0 gives an exact-zero
    row, as the reference's kernel does; its jnp oracle has no such row)."""
    b, _, nq, nkv, hd, hdv = DENSE_CASES[case]
    q, k, v, *_ = _dense_case(b, 1, nq, nkv, hd, hdv, seed=1)
    q = q[:, 0]
    lens = np.array([20, 0, 1, 7], np.int32)
    got = ref.flash_decode_ref(tt(q), tt(k), tt(v), tt(lens)).numpy()
    want_ker = np.asarray(rops.flash_decode(jj(q), jj(k), jj(v), jj(lens),
                                            bs=8))
    want_ref = np.asarray(rref.flash_decode_ref(jj(q), jj(k), jj(v),
                                                jj(lens)))
    np.testing.assert_allclose(got, want_ker, rtol=RTOL, atol=ATOL)
    live = lens > 0
    np.testing.assert_allclose(got[live], want_ref[live], rtol=RTOL,
                               atol=ATOL)
    assert (got[1] == 0).all()


def test_dense_and_decode_wrappers_cpu_are_plain_and_uncounted():
    args = tuple(map(tt, _dense_case(*DENSE_CASES["absorbed"])))
    ops.reset_counters()
    got = ops.flash_chunk(*args, scale=0.25)
    torch.testing.assert_close(got, ref.flash_chunk_ref(*args, 0.25),
                               rtol=0, atol=0)
    q, k, v = args[0][:, 0].contiguous(), args[1], args[2]
    lens = torch.tensor([5, 0, 20, 1], dtype=torch.int32)
    torch.testing.assert_close(ops.flash_decode(q, k, v, lens),
                               ref.flash_decode_ref(q, k, v, lens),
                               rtol=0, atol=0)
    assert not ops.counters


def test_flash_chunk_paged_plain_is_dense_on_gathered_pages():
    """The paged contract is the dense one on the gathered slot view."""
    q, kp, vp, bt, q_off, q_len, kv_len = map(tt, _flash_case(2))
    n_pages, page = kp.shape[:2]
    b, nb = bt.shape
    idx = bt.long().clamp(0, n_pages - 1)
    k = kp[idx].reshape(b, nb * page, *kp.shape[2:])
    v = vp[idx].reshape(b, nb * page, *vp.shape[2:])
    torch.testing.assert_close(
        ref.flash_chunk_paged_ref(q, kp, vp, bt, q_off, q_len, kv_len),
        ref.flash_chunk_ref(q, k, v, q_off, q_len, kv_len), rtol=0, atol=0)


def test_permute_and_combine_plain_match_reference_kernels():
    """Against the reference's interpret-mode Pallas kernels, with -1
    entries in both index vectors."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((7, 16)).astype(np.float32)
    src = np.array([6, -1, 0, 2, 2, -1, 5, 1, 3], np.int32)
    got = ref.permute_tokens_ref(tt(x), tt(src)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(rops.permute_tokens(jj(x), jj(src), bn=4)))
    assert (got[[1, 5]] == 0).all()
    slot = np.array([[0, 8, 3], [1, -1, 4], [-1, -1, -1], [7, 2, 6]],
                    np.int32)
    wts = rng.random((4, 3)).astype(np.float32)
    out = ref.unpermute_tokens_ref(tt(got), tt(slot), tt(wts)).numpy()
    np.testing.assert_allclose(
        out, np.asarray(rops.unpermute_tokens(jj(got), jj(slot), jj(wts),
                                              bn=2)), rtol=RTOL, atol=ATOL)
    assert (out[2] == 0).all()


def test_permute_wrappers_cpu_are_plain_and_uncounted():
    x = torch.randn(5, 8)
    src = torch.tensor([4, -1, 0], dtype=torch.int32)
    slot = torch.tensor([[0, 2], [1, -1]], dtype=torch.int32)
    w = torch.rand(2, 2, dtype=torch.float64)
    ops.reset_counters()
    assert torch.equal(ops.permute_tokens(x, src),
                       ref.permute_tokens_ref(x, src))
    got = ops.unpermute_tokens(x, slot, w.to(torch.bfloat16))
    want = ref.unpermute_tokens_ref(x, slot, w.to(torch.bfloat16).float())
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert got.dtype == x.dtype and not ops.counters


def _ragged_case(n, h, totals, stride, seed=3):
    """x (9, h) and an (n,) src that is -1 outside each segment's prefix of
    ``totals[r]`` rows (segments ``stride`` apart; a scalar total is one
    segment), valid rows gathering random tokens."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((9, h)).astype(np.float32)
    tot = np.atleast_1d(np.asarray(totals, np.int32))
    row = np.arange(n)
    seg = np.minimum(row // stride, len(tot) - 1)
    valid = (row - seg * stride) < tot[seg]
    src = np.where(valid, rng.integers(0, 9, n), -1).astype(np.int32)
    src[valid & (rng.random(n) < 0.2)] = -1       # -1 inside a prefix too
    return x, src, np.asarray(totals, np.int32)


@pytest.mark.parametrize("n,h,totals,stride,bn", [
    (64, 16, [5, 0, 16, 2], 16, 8),      # EP send layout, an empty segment
    (64, 16, [0, 0, 0, 0], 16, 8),       # every segment empty
    (48, 24, 13, None, 8),               # scalar total: one prefix
    (48, 24, 0, None, 16),               # zero scalar total
    (50, 16, [3, 25], 25, 8),            # n and stride off the tile size
    (30, 12, [7, 1, 0], 10, 4),          # tiles straddling segments
])
def test_permute_ragged_plain_matches_reference_kernel(n, h, totals,
                                                        stride, bn):
    """The plain version against the reference's interpret-mode
    ``permute_tokens_ragged`` (forced small tiles, so its empty-tile skip
    runs), and the port's CPU wrapper returns it uncounted."""
    x, src, tot = _ragged_case(n, h, totals, stride or n)
    want = np.asarray(rops.permute_tokens_ragged(
        jj(x), jj(src), jj(tot), seg_stride=stride, bn=bn))
    got = ref.permute_tokens_ragged_ref(tt(x), tt(src), tt(tot),
                                        seg_stride=stride).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[src < 0], 0)
    ops.reset_counters()
    wrapped = ops.permute_tokens_ragged(tt(x), tt(src), tt(tot),
                                        seg_stride=stride)
    assert torch.equal(wrapped, tt(got)) and not ops.counters


def test_permute_ragged_wrapper_checks():
    x = torch.randn(6, 8)
    src = torch.full((40,), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="do not cover"):
        ops.permute_tokens_ragged(
            x, src, torch.tensor([3, 3, 3], dtype=torch.int32), seg_stride=10)
    with pytest.raises(ValueError, match="do not cover"):
        rops.permute_tokens_ragged(jj(x.numpy()), jj(src.numpy()),
                                   jj(np.array([3, 3, 3], np.int32)),
                                   seg_stride=10)
    with pytest.raises(ValueError, match="int32"):
        ops.permute_tokens_ragged(x, src, torch.tensor(3))
    with pytest.raises(ValueError, match=r"total \(\) or \(n_seg,\)"):
        ops.permute_tokens_ragged(x, src,
                                  torch.zeros(2, 2, dtype=torch.int32))


@pytest.mark.parametrize("case", ["dtype", "layout", "index_dtype"])
def test_wrappers_reject_unsupported_inputs(case):
    x = torch.randn(8, 16)
    w = torch.randn(2, 16, 4)
    off = torch.tensor([0, 3, 8], dtype=torch.int32)
    logits = torch.randn(8, 4)
    if case == "dtype":
        with pytest.raises(ValueError, match="dtype"):
            ops.grouped_gemm(x.half(), w.half(), off)
        with pytest.raises(ValueError, match="dtype"):
            ops.topk_gate(logits.double(), 2)
    elif case == "layout":
        with pytest.raises(ValueError, match="contiguous"):
            ops.grouped_gemm(torch.randn(16, 8).T, w, off)
        with pytest.raises(ValueError, match="contiguous"):
            ops.topk_gate(torch.randn(4, 8).T, 2)
    else:
        with pytest.raises(ValueError, match="int32"):
            ops.grouped_gemm(x, w, off.long())
        q, kp, vp, bt, qo, ql, kl = map(tt, _flash_case())
        with pytest.raises(ValueError, match="int32"):
            ops.flash_chunk_paged(q, kp, vp, bt.long(), qo, ql, kl)
        with pytest.raises(ValueError, match="int32"):
            ops.permute_tokens(x, torch.tensor([1, 0]))
        with pytest.raises(ValueError, match="int32"):
            ops.unpermute_tokens(x, off.long()[:, None], torch.ones(3, 1))


def test_attention_wrappers_reject_shapes_outside_the_kernel():
    q, k, v, qo, ql, kl = map(tt, _dense_case(4, 2, 4, 1, 776, 512))
    with pytest.raises(ValueError, match="up to 768"):
        ops.flash_chunk(q, k, v, qo, ql, kl)
    q, k, v, qo, ql, kl = map(tt, _dense_case(4, 2, 6, 4, 16, 16))
    with pytest.raises(ValueError, match="divisible"):
        ops.flash_chunk(q, k, v, qo, ql, kl)
    with pytest.raises(ValueError, match=r"\(B,\)"):
        ops.flash_chunk(q[:, :, :4].contiguous(), k, v, qo, ql, kl[:2])
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_chunk(q[:, :, :4], k, v, qo, ql, kl)
    with pytest.raises(ValueError, match="dtype"):
        ops.permute_tokens(torch.zeros(3, 4, dtype=torch.float16),
                           torch.tensor([0], dtype=torch.int32))


# --- the kernels' host-side launch math (csrc/grouped_gemm.cu and
# csrc/flash_attn.cuh take these numbers from ops and refuse others) ---

def _visits_brute(off, n, bm=ops.GG_ROWS):
    """The grouped GEMM's visits for ascending offsets from 0: each expert
    segment's bm-row tiles (clamped to the n rows) plus the zero tiles of
    [offsets[-1], n)."""
    segs = [min(off[e + 1], n) - min(off[e], n) for e in range(len(off) - 1)]
    return sum(-(-s // bm) for s in segs) + -(-(n - min(off[-1], n)) // bm)


@pytest.mark.parametrize("seed", range(6))
def test_grouped_gemm_visit_bound_holds_on_random_offsets(seed):
    rng = np.random.default_rng(seed)
    for _ in range(300):
        e = int(rng.integers(1, 300))
        n = int(rng.integers(0, 4000))
        routed = int(rng.integers(0, n + 1)) if rng.random() < 0.7 else n
        cuts = np.sort(rng.integers(0, routed + 1, e - 1)).tolist()
        off = [0, *cuts, routed]
        assert _visits_brute(off, n) <= ops.grouped_gemm_visits(n, e)


BM = ops.GG_ROWS
# (name, offsets, N): 1-row segments, one expert holding every row, every
# segment one row past a tile, empty experts, all rows past offsets[-1],
# segments past N; the first three reach the bound exactly
VISIT_EXTREMES = [
    ("one_row_each", list(range(64)), 128),
    ("one_row_then_tail", [0, 1, 2], BM),
    ("tile_plus_one", [i * (BM + 1) for i in range(9)], 8 * (BM + 1) + 3),
    ("one_expert", [0, 0, 0, 700, 700], 700),
    ("all_empty", [0] * 17, 300),
    ("past_n", [0, 50, 90, 400], 100),
    ("no_rows", [0, 0, 0], 0),
]


@pytest.mark.parametrize("case", VISIT_EXTREMES,
                         ids=[c[0] for c in VISIT_EXTREMES])
def test_grouped_gemm_visit_bound_holds_on_extreme_offsets(case):
    _, off, n = case
    e = len(off) - 1
    got, bound = _visits_brute(off, n), ops.grouped_gemm_visits(n, e)
    assert got <= bound
    if case[0] in ("one_row_each", "one_row_then_tail", "tile_plus_one"):
        assert got == bound
    # the bound is the reference kernel's static n_visits for bn = BM
    assert bound == -(-n // BM) + min(e, n)


# (name, (B, sq, nq, nkv, hd, hdv), (rows, n_split)): the serve steps'
# geometries and the card tests' small ones
FLASH_PLANS = [
    ("phi3.5_step", (4, 64, 32, 8, 128, 128), (128, 5)),
    ("deepseek_expanded", (4, 64, 128, 128, 192, 128), (64, 1)),
    ("deepseek_absorbed", (4, 1, 128, 1, 576, 512), (64, 9)),
    ("gqa_small", (4, 8, 12, 4, 64, 64), (128, 16)),
    ("long_decode", (1, 1, 8, 2, 128, 128), (128, 16)),
    ("hd_768", (2, 3, 16, 1, 768, 512), (64, 16)),
]


@pytest.mark.parametrize("case", FLASH_PLANS, ids=[c[0] for c in FLASH_PLANS])
def test_flash_plan_at_known_geometries(case):
    _, geo, want = case
    assert ops.flash_plan(*geo) == want


def test_flash_plan_fills_the_card_from_geometry_only():
    """rows 128 only where hd <= 256 and a group packs heads; n_split in
    [1, 16], and either the split grid holds two CTAs per SM or the split
    count is at its cap."""
    rng = np.random.default_rng(0)
    for _ in range(500):
        nkv = int(rng.choice([1, 2, 4, 8, 32, 128]))
        g = int(rng.choice([1, 2, 3, 4, 8, 128]))
        b, sq = int(rng.integers(1, 9)), int(rng.integers(1, 129))
        hd = 8 * int(rng.integers(1, 97))
        hdv = 8 * int(rng.integers(1, 65))
        rows, n_split = ops.flash_plan(b, sq, g * nkv, nkv, hd, hdv)
        assert rows in (64, 128) and (rows == 64 or (hd <= 256 and g >= 2))
        n_hs = -(-g // rows)
        bq = rows // -(-g // n_hs)
        ctas = b * -(-sq // bq) * nkv * n_hs * -(-hdv // ops.FLASH_DV)
        assert 1 <= n_split <= ops.FLASH_MAX_SPLIT
        assert ctas * n_split >= 2 * ops.SMS \
            or n_split == ops.FLASH_MAX_SPLIT
        assert n_split == 1 or ctas * (n_split - 1) < 2 * ops.SMS


# --- the gathers' launch plan (csrc/permute.cu takes the grid from
# ops.permute_plan and refuses one that does not cover the rows) ---

SERVED_GATHER_ROWS = [320, 512, 640, 1536, 2560]
SERVED_GATHER_WIDTHS = [2048, 4096, 5120]


@pytest.mark.parametrize("elem_bytes", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("h", SERVED_GATHER_WIDTHS)
@pytest.mark.parametrize("n", SERVED_GATHER_ROWS)
def test_permute_plan_fills_the_card_at_served_shapes(n, h, elem_bytes):
    """Every gather chip_smoke.py times launches at least two CTAs per SM
    of the H100 (132 SMs), on 16-byte units."""
    gx, gy, unit = ops.permute_plan(n, h * elem_bytes, elem_bytes)
    assert unit == 16
    assert gx * gy >= 2 * 132
    assert gy <= 65535


def _plan_cells(n, row_bytes, elem_bytes):
    """How often the kernel writes each (row, unit) cell under the plan,
    walked as csrc/permute.cu's gather_tile walks it: thread i of CTA
    (bx, by) owns unit by * CHUNK + i % CHUNK of rows
    bx * ROWS + i // CHUNK + p * (THREADS // CHUNK), p = 0..3, and writes
    a cell only inside the (n, units) buffer."""
    gx, gy, unit = ops.permute_plan(n, row_bytes, elem_bytes)
    w = row_bytes // unit
    rows_cta, chunk, threads = (ops.PERMUTE_ROWS, ops.PERMUTE_CHUNK,
                                ops.PERMUTE_THREADS)
    step = threads // chunk
    i = np.arange(threads)
    p = np.arange(rows_cta // step)
    row = (np.arange(gx)[:, None, None, None] * rows_cta
           + (i // chunk)[None, None, :, None] + p[None, None, None, :] * step)
    col = (np.arange(gy)[None, :, None, None] * chunk
           + (i % chunk)[None, None, :, None])
    row, col = np.broadcast_arrays(row, col)
    keep = (row < n) & (col < w)
    cells = np.bincount(row[keep] * w + col[keep], minlength=n * w)
    return cells, gy


# (n, row bytes, element bytes): one row; n off the 32-row tile; 70 000
# rows (past gridDim.y's 65535, were rows on y one per CTA); widths off
# the 8-unit chunk; element-wise rows (not multiples of 16 bytes)
PLAN_WALKS = [(1, 4096, 2), (75, 4096, 2), (70_000, 48, 4), (33, 208, 2),
              (96, 10_256, 4), (40, 8196, 2), (17, 36 * 4, 4),
              (50, 4098 * 2, 2)]


@pytest.mark.parametrize("case", PLAN_WALKS, ids=[
    f"n{c[0]}_b{c[1]}_e{c[2]}" for c in PLAN_WALKS])
def test_permute_plan_covers_each_cell_once(case):
    n, row_bytes, elem_bytes = case
    cells, gy = _plan_cells(n, row_bytes, elem_bytes)
    assert cells.min() == 1 and cells.max() == 1
    assert gy <= 65535


# --- the capacity GEMM's stream-K plan (csrc/moe_gemm.cu cuts the units,
# H fastest, into ops.moe_gemm_plan's ctas ranges and refuses a plan whose
# units are not its tiling's) ---

def _moe_ranges(ctas, units):
    """Each CTA's [begin, end) of stream-K units, as the kernel's
    Work::begin cuts them: floor(units / ctas) each, one more for the
    first units % ctas."""
    q, r = divmod(units, ctas)
    begin = [c * q + min(c, r) for c in range(ctas + 1)]
    return list(zip(begin[:-1], begin[1:]))


def _moe_walk(e, c, h, d):
    """Walk the plan as the kernel does: (ctas, per-CTA weight bytes, how
    often each (expert, row tile, column tile, H unit) is computed, each
    CTA's stream-K carry as (carries in, carries out, step it takes the
    carry in, step its carry is out), each whole round's tiles by CTA).
    The first ``tsk`` tiles are stream-K: CTA c walks its range [u0, u1)
    as the head of its last tile [hb, u1), its whole tiles [p0, hb), then
    the tail of its first tile [u0, p0); then tile tsk + j * ctas + c of
    round j.  A unit's weight bytes are its rows below H times its
    columns below D."""
    ctas, units, tiles, mt = ops.moe_gemm_plan(e, c, h, d)
    tsk, rounds = ops.moe_gemm_split(tiles, ctas)
    bk, bn = ops.MOE_BK, ops.moe_gemm_bn(mt)
    nk = max(1, -(-h // bk))
    n_rt, n_ct = -(-c // (16 * mt)), -(-d // bn)
    assert tiles == e * n_rt * n_ct and units == tiles * nk
    assert tsk + rounds * ctas == tiles
    seen = np.zeros((e, n_rt, n_ct, nk), np.int64)
    wbytes, carries = [], []

    def visit(tile, k):
        ex, rem = divmod(tile, n_rt * n_ct)
        rt, ct = divmod(rem, n_ct)
        seen[ex, rt, ct, k] += 1
        return (2 * max(0, min(bk, h - k * bk))
                * max(0, min(bn, d - ct * bn)))
    for cta, (u0, u1) in enumerate(_moe_ranges(ctas, tsk * nk)):
        hb = max(u0, (u1 - 1) // nk * nk) if u1 > u0 else u0
        p0 = min(-(-u0 // nk) * nk, hb)
        order = [*range(hb, u1), *range(p0, hb), *range(u0, p0)]
        total = sum(visit(*divmod(u, nk)) for u in order)
        total += sum(visit(tsk + j * ctas + cta, k)
                     for j in range(rounds) for k in range(nk))
        wbytes.append(total)
        takes, gives = u1 > u0 and u0 % nk != 0, u1 > u0 and u1 % nk != 0
        carries.append((takes, gives, order.index(u0) if takes else None,
                        order.index(u1 - 1) + 1 if gives else None))
    whole = [[tsk + j * ctas + cta for cta in range(ctas)]
             for j in range(rounds)]
    return ctas, units, wbytes, seen, carries, whole


# (E, C, H, D): the served expert GEMMs, w_in / w_gate then w_out
MOE_SERVED = [("phi3.5_w_in", 16, 40, 4096, 6400),
              ("phi3.5_w_out", 16, 40, 6400, 4096),
              ("deepseek_w_in", 160, 16, 5120, 1536),
              ("deepseek_w_out", 160, 16, 1536, 5120),
              ("deepseek_c1_w_in", 160, 1, 5120, 1536),
              ("deepseek_c1_w_out", 160, 1, 1536, 5120)]


@pytest.mark.parametrize("case", MOE_SERVED, ids=[c[0] for c in MOE_SERVED])
def test_moe_gemm_plan_balances_weight_bytes_at_served_shapes(case):
    """One CTA per SM of the H100, and every CTA's weight bytes within one
    unit (BK x BN bf16) of the mean: no tail of idle SMs."""
    _, e, c, h, d = case
    ctas, _, wbytes, seen, carries, whole = _moe_walk(e, c, h, d)
    assert ctas == ops.SMS
    assert sum(wbytes) == e * h * d * 2       # each weight read once
    mean = sum(wbytes) / ctas
    mt = ops.moe_gemm_plan(e, c, h, d)[3]
    unit = ops.MOE_BK * ops.moe_gemm_bn(mt) * 2
    assert max(abs(b - mean) for b in wbytes) <= unit
    assert (seen == 1).all()
    # each whole round is ctas consecutive tiles, one per SM, side by side
    assert all(r == list(range(r[0], r[0] + ctas)) for r in whole)
    # at equal rates every carry is out before the next CTA takes it in
    for (_, _, _, out), (takes, _, at, _) in zip(carries, carries[1:]):
        assert not takes or out <= at


# (E, C, H, D): C 1 / 13 / 70 (two row tiles), H and D off the tiles and
# off 8, one expert, 160 experts of 1536 columns, H = 0, fewer units than
# SMs, H just over a multiple of the unit; tiles a multiple of the grid
# (all whole), between one and two rounds (all stream-K), one round plus
# a remainder of one
MOE_EDGES = [(5, 1, 264, 200), (5, 13, 100, 75), (5, 70, 264, 200),
             (1, 40, 8200, 264), (160, 16, 5120, 1536), (3, 7, 0, 40),
             (2, 5, 64, 100), (16, 40, 4128, 6400), (7, 64, 33, 1000),
             (132, 16, 64, 256), (200, 8, 32, 256), (265, 1, 96, 256)]


@pytest.mark.parametrize("case", MOE_EDGES,
                         ids=[f"E{c[0]}_C{c[1]}_H{c[2]}_D{c[3]}"
                              for c in MOE_EDGES])
def test_moe_gemm_plan_covers_each_unit_once(case):
    """Brute force: every (expert, row tile, column tile, H unit) is
    computed by exactly one CTA; every CTA has a unit and shares differ
    by at most one; a CTA takes a carry in exactly when the CTA before it
    hands one out (CTA 0 never takes one), so every split tile is summed
    along one chain in H order."""
    e, c, h, d = case
    ctas, units, _, seen, carries, _ = _moe_walk(e, c, h, d)
    assert 1 <= ctas <= min(ops.SMS, units)
    assert (seen == 1).all()
    _, tiles, _ = ops.moe_gemm_plan(e, c, h, d)[1:]
    tsk, rounds = ops.moe_gemm_split(tiles, ctas)
    nk = units // tiles
    shares = [hi - lo + rounds * nk
              for lo, hi in _moe_ranges(ctas, tsk * nk)]
    assert min(shares) >= 1 and max(shares) - min(shares) <= 1
    assert not carries[0][0] and not carries[-1][1]
    for (_, gives, _, _), (takes, _, _, _) in zip(carries, carries[1:]):
        assert gives == takes


# --- the combine's launch plan (csrc/permute.cu takes the grid from
# ops.unpermute_plan and refuses one that does not cover the rows) ---

@pytest.mark.parametrize("elem_bytes", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("h", SERVED_GATHER_WIDTHS)
@pytest.mark.parametrize("k", [2, 6])
@pytest.mark.parametrize("t", [128, 256])
def test_unpermute_plan_fills_the_card_at_served_shapes(t, k, h,
                                                        elem_bytes):
    """Every served combine launches at least two CTAs per SM on 16-byte
    units, each thread with at most 8 loads in flight."""
    gx, gy, rows, unit = ops.unpermute_plan(t, k, h * elem_bytes,
                                            elem_bytes)
    assert unit == 16 and gy <= 65535
    assert gx * gy >= 2 * 132
    assert 1 <= rows <= ops.unpermute_rows_max(k)
    assert rows * (2 if k <= 2 else 6) <= 8 and rows <= 2


def _unpermute_cells(t, k, row_bytes, elem_bytes):
    """How often the combine writes each (row, unit) cell under the plan,
    walked as unpermute_kernel walks it: thread i of CTA (bx, by) owns
    unit by * CHUNK + i % CHUNK of rows bx * LANES * R + i // CHUNK +
    r * LANES, r < R."""
    gx, gy, rows, unit = ops.unpermute_plan(t, k, row_bytes, elem_bytes)
    w = row_bytes // unit
    chunk, lanes = ops.UNPERMUTE_CHUNK, ops.UNPERMUTE_LANES
    i = np.arange(chunk * lanes)
    r = np.arange(rows)
    row = (np.arange(gx)[:, None, None, None] * lanes * rows
           + (i // chunk)[None, None, :, None]
           + r[None, None, None, :] * lanes)
    col = (np.arange(gy)[None, :, None, None] * chunk
           + (i % chunk)[None, None, :, None])
    row, col = np.broadcast_arrays(row, col)
    keep = (row < t) & (col < w)
    return np.bincount(row[keep] * w + col[keep], minlength=t * w), gy, rows


# (t, k, row bytes, element bytes): one row; t off every row tile; 70 000
# rows; k 1 / 3 / 8 / 9; a width off the 8-unit chunk; element-wise rows
UNPERMUTE_WALKS = [(1, 2, 8192, 2), (75, 2, 4096, 2), (70_000, 6, 64, 4),
                   (33, 1, 208, 2), (129, 3, 10_240, 4), (256, 8, 10_240, 2),
                   (50, 9, 4098 * 2, 2), (17, 2, 36 * 4, 4)]


@pytest.mark.parametrize("case", UNPERMUTE_WALKS, ids=[
    f"t{c[0]}_k{c[1]}_b{c[2]}_e{c[3]}" for c in UNPERMUTE_WALKS])
def test_unpermute_plan_covers_each_cell_once(case):
    t, k, row_bytes, elem_bytes = case
    cells, gy, rows = _unpermute_cells(t, k, row_bytes, elem_bytes)
    assert cells.min() == 1 and cells.max() == 1
    assert gy <= 65535 and 1 <= rows <= ops.unpermute_rows_max(k)


# --- the router gate's launch plan (csrc/topk_gate.cu takes the grid from
# ops.topk_plan and refuses one that does not cover the rows) ---

# (T, E, (lanes per row, warps per CTA, CTAs)): the phi3.5 step and one
# rank of the sharded serve (16-lane rows), the deepseek-v2, qwen3-235b
# and deepseek-r1 steps, the largest auto-resolved step (8 x chunk 64)
TOPK_SERVED = [(256, 16, (16, 2, 128)), (128, 16, (16, 1, 128)),
               (256, 160, (32, 2, 128)), (256, 128, (32, 2, 128)),
               (256, 256, (32, 2, 128)), (512, 256, (32, 4, 128))]


@pytest.mark.parametrize("case", TOPK_SERVED,
                         ids=[f"T{c[0]}_E{c[1]}" for c in TOPK_SERVED])
def test_topk_plan_at_served_shapes(case):
    """At most one CTA per SM of the H100, each of the fewest warps that
    allow it, so every served call spreads its rows over 128 SMs."""
    t, e, want = case
    assert ops.topk_plan(t, e) == want
    assert want[2] <= ops.SMS


def _topk_rows(t, e):
    """How often the kernel handles each row under the plan, walked as
    topk_gate_kernel derives it: warp w of CTA c takes row c * warps + w,
    and only rows below t do any work."""
    lanes, wpc, ctas = ops.topk_plan(t, e)
    rows = np.arange(ctas * wpc)
    return np.bincount(rows[rows < t], minlength=t), lanes, wpc, ctas


@pytest.mark.parametrize("e", [1, 5, 16, 17, 40, 160, 256])
@pytest.mark.parametrize("t", [1, 2, 3, 127, 300, 512, 4097, 70_000])
def test_topk_plan_covers_each_row_once(t, e):
    """Every row once, no CTA without a row, warps per CTA within the
    kernel's launch bound, 16-lane rows exactly where E <= 16."""
    cells, lanes, wpc, ctas = _topk_rows(t, e)
    assert cells.min() == 1 and cells.max() == 1
    assert (ctas - 1) * wpc < t <= ctas * wpc
    assert 1 <= wpc <= ops.TOPK_MAX_WARPS and ctas <= 2 ** 31 - 1
    assert wpc == ops.TOPK_MAX_WARPS or ctas <= ops.SMS
    assert lanes == (16 if e <= 16 else 32)
