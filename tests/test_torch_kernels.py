"""The port's kernels: plain versions against the reference's oracles and
its interpret-mode Pallas kernels, and the wrappers' checks.  The CUDA
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


def test_topk_gate_plain_matches_reference_ties_lowest_index():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((20, 8)).astype(np.float32)
    logits[0] = 0.25                       # all tied -> ids 0, 1
    logits[1, 6] = logits[1, 2] = 5.0      # tied pair -> ids 2, 6
    for renorm in (True, False):
        w, i = ref.topk_gate_ref(tt(logits), 2, renorm)
        rw, ri = rref.topk_gate_ref(jj(logits), 2, renorm)
        kw, ki = rops.topk_gate(jj(logits), 2, renorm=renorm)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ki))
        np.testing.assert_allclose(w.numpy(), np.asarray(rw), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(w.numpy(), np.asarray(kw), rtol=1e-6,
                                   atol=1e-6)
        assert i[0].tolist() == [0, 1] and i[1].tolist() == [2, 6]
        assert w.dtype == torch.float32 and i.dtype == torch.int32


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
