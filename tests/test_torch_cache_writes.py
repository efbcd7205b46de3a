"""The port's KV-cache writes (``models/layers.py`` ``write_cache`` and
``write_cache_paged``) against the reference's drop-scatter on the same
numpy-seeded inputs, bitwise (a write is a copy), in float32 and bf16, on
the dense per-slot buffers and on the paged pools, GQA and MLA widths.

The cases the scatter's dropped rows decide: idle slots (``valid_len``
0), a call with no valid row (the buffer, cell 0 included, unchanged),
unallocated pages (table entry -1), dense rows past the buffer, the
one-row decode write with ``valid_len``.  Both writes also run on the
meta device, and lint rule R2 (host syncs) finds nothing in them.
"""

import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from _torch_helpers import jj, paged_tables, tt  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro_torch.analysis import lint  # noqa: E402
from repro_torch.analysis.rules import R2  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# the trailing dims of a cache row: GQA (nkv, hd), MLA's latent c (r) and
# its rope key (rd) at the reduced scale
TAILS = {"gqa": (2, 8), "mla_c": (512,), "mla_rope": (64,)}


def _both(a, dtype):
    """One float32 numpy array as a (port, reference) pair of ``dtype``:
    both round the same float32 values to nearest even, so the pair holds
    the same bits."""
    t_dt, j_dt = DTYPES[dtype]
    return tt(a).to(t_dt), jj(a).astype(j_dt)


def _bits(x):
    """A tensor's or an array's bits, as integers of its width."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16 if x.element_size() == 2 else torch.int32)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16 if x.dtype.itemsize == 2 else np.int32)


def _dense(buf, new, idx, valid_len, dtype):
    """Both packages' ``write_cache`` on the same inputs: (port result,
    reference result, the port's buffer before the write)."""
    t_buf, r_buf = _both(buf, dtype)
    t_new, r_new = _both(new, dtype)
    before = t_buf.clone()
    vl = None if valid_len is None else np.asarray(valid_len, np.int32)
    idx = np.asarray(idx, np.int32)
    want = RL.write_cache(r_buf, r_new, jj(idx),
                          None if vl is None else jj(vl))
    got = TL.write_cache(t_buf, t_new, tt(idx),
                         None if vl is None else tt(vl))
    assert got is t_buf                                     # in place
    np.testing.assert_array_equal(_bits(got), _bits(want))
    return got, before


def _paged(pool, new, idx, bt, valid_len, dtype):
    t_pool, r_pool = _both(pool, dtype)
    t_new, r_new = _both(new, dtype)
    before = t_pool.clone()
    idx, vl = np.asarray(idx, np.int32), np.asarray(valid_len, np.int32)
    want = RL.write_cache_paged(r_pool, r_new, jj(idx), jj(bt),
                                valid_len=jj(vl))
    got = TL.write_cache_paged(t_pool, t_new, tt(idx), tt(bt), tt(vl))
    assert got is t_pool
    np.testing.assert_array_equal(_bits(got), _bits(want))
    return got, before


# (idx, valid_len, s) of the dense per-slot write: b 4 slots, S 16 rows
DENSE_CASES = {
    "ragged_and_idle": ([2, 12, 5, 0], [8, 6, 0, 3], 8),
    "rows_past_S": ([10, 14, 15, 16], [8, 8, 2, 1], 8),
    "no_valid_row": ([3, 0, 7, 1], [0, 0, 0, 0], 8),
    "all_past_S": ([16, 20, 16, 30], [4, 8, 1, 2], 8),
    "decode": ([0, 15, 7, 16], [1, 1, 0, 1], 1),
    "decode_idle": ([4, 2, 9, 3], [0, 0, 0, 0], 1),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("tail", sorted(TAILS))
@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_dense_write_bitwise_reference(case, tail, dtype):
    idx, vl, s = DENSE_CASES[case]
    rng = np.random.default_rng(sorted(DENSE_CASES).index(case))
    b, S = 4, 16
    buf = rng.standard_normal((b, S) + TAILS[tail]).astype(np.float32)
    new = rng.standard_normal((b, s) + TAILS[tail]).astype(np.float32)
    got, before = _dense(buf, new, idx, vl, dtype)
    rows = np.asarray(idx)[:, None] + np.arange(s)[None]
    ok = (rows < S) & (np.arange(s)[None] < np.asarray(vl)[:, None])
    # exactly the valid rows changed (the random rows differ from the old)
    changed = (_bits(got) != _bits(before)).reshape(b, S, -1).any(-1)
    want = np.zeros((b, S), bool)
    want[np.nonzero(ok)[0], rows[ok]] = True
    np.testing.assert_array_equal(changed, want)


# (used blocks per slot, idx, valid_len, s) of the paged write: page 4,
# 4 blocks a slot; slot 1's table ends early (-1 entries past its second
# block), slot 2 owns no page
PAGED_CASES = {
    "ragged_and_idle": ([3, 2, 0], [5, 2, 0], [6, 3, 0], 6),
    "unallocated_blocks": ([3, 2, 0], [1, 6, 0], [6, 6, 6], 6),
    "no_valid_row": ([3, 2, 0], [5, 2, 0], [0, 0, 0], 6),
    "only_unallocated": ([3, 0, 0], [0, 0, 0], [0, 5, 2], 6),
    "decode": ([3, 2, 0], [9, 7, 3], [1, 1, 1], 1),
    "decode_idle": ([3, 2, 1], [9, 7, 3], [0, 1, 0], 1),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("tail", sorted(TAILS))
@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_paged_write_bitwise_reference(case, tail, dtype):
    used, idx, vl, s = PAGED_CASES[case]
    rng = np.random.default_rng(10 + sorted(PAGED_CASES).index(case))
    b, page, nb = 3, 4, 4
    bt, n_pages = paged_tables(b, nb, used, seed=1)
    pool = rng.standard_normal((n_pages, page) + TAILS[tail]).astype(
        np.float32)
    new = rng.standard_normal((b, s) + TAILS[tail]).astype(np.float32)
    got, before = _paged(pool, new, idx, bt, vl, dtype)
    if case in ("no_valid_row", "only_unallocated"):
        np.testing.assert_array_equal(_bits(got), _bits(before))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("seed", range(12))
def test_random_writes_bitwise_reference(seed, paged, dtype):
    """Random offsets, lengths (0 included), widths and tables: idle
    slots, -1 entries, rows past the buffer and no-valid-row calls all
    come up."""
    rng = np.random.default_rng(100 + seed)
    b = int(rng.integers(1, 5))
    s = int(rng.choice([1, 1, 3, 8]))
    tail = TAILS[sorted(TAILS)[seed % len(TAILS)]]
    vl = rng.integers(0, s + 1, b) * (rng.random(b) < 0.8)
    new = rng.standard_normal((b, s) + tail).astype(np.float32)
    if not paged:
        S = int(rng.integers(s, 24))
        idx = rng.integers(0, S + 4, b)
        buf = rng.standard_normal((b, S) + tail).astype(np.float32)
        _dense(buf, new, idx, vl, dtype)
        return
    page, nb = 4, 5
    used = rng.integers(0, nb + 1, b)
    bt, n_pages = paged_tables(b, nb, used, seed=seed)
    bt[rng.random(bt.shape) < 0.1] = -1                   # holes
    # offsets inside the table's reach: past it the clamp of the block
    # folds positions, where two valid rows may share a cell
    idx = rng.integers(0, nb * page - s + 1, b)
    pool = rng.standard_normal((n_pages, page) + tail).astype(np.float32)
    _paged(pool, new, idx, bt, vl, dtype)


def test_no_valid_row_keeps_cell_0_bit_for_bit():
    """Where no row is valid every row is parked on cell 0 with cell 0's
    own value: a NaN's payload and a negative zero come back unchanged."""
    buf = torch.zeros(2, 4, 3)
    buf[0, 0] = torch.tensor([float("nan"), -0.0, 1.5])
    pool = buf.clone()
    before = buf.clone()
    new = torch.randn(2, 3, 3)
    idx = torch.tensor([0, 1], dtype=torch.int32)
    zero = torch.zeros(2, dtype=torch.int32)
    TL.write_cache(buf, new, idx, zero)
    TL.write_cache_paged(pool, new, idx, torch.tensor([[0], [1]]), zero)
    for got in (buf, pool):
        assert torch.equal(got.view(torch.int32), before.view(torch.int32))


def test_both_writes_run_on_the_meta_device():
    meta = dict(device="meta")
    i32 = dict(dtype=torch.int32, device="meta")
    for s in (1, 8):
        buf = TL.write_cache(torch.empty(4, 16, 2, 8, **meta),
                             torch.empty(4, s, 2, 8, **meta),
                             torch.empty(4, **i32), torch.empty(4, **i32))
        assert buf.shape == (4, 16, 2, 8) and buf.is_meta
        pool = TL.write_cache_paged(torch.empty(9, 4, 512, **meta),
                                    torch.empty(3, s, 512, **meta),
                                    torch.empty(3, **i32),
                                    torch.empty(3, 4, **i32),
                                    torch.empty(3, **i32))
        assert pool.shape == (9, 4, 512) and pool.is_meta


def test_r2_finds_no_sync_in_the_writes():
    """No finding of the host-sync rule at the two writes or their
    scatter, with the audited disables ignored, and no audit left in
    ``layers.py``."""
    ctx = lint.LintContext(lint.discover([str(SRC / "repro_torch")]))
    found = [f for f in lint.run_rules(ctx, [R2], respect_disables=False)
             if pathlib.Path(f.path).name == "layers.py"]
    assert found == []
    text = (SRC / "repro_torch" / "models" / "layers.py").read_text()
    assert "disable=R2" not in text
    # the rule does reach them: a masked write seeded into the scatter is
    # flagged there
    anchor = "    ok = ok.reshape(-1)\n"
    seeded = text.replace(anchor, anchor + "    live = val[index[0] >= 0]\n",
                          1)
    assert seeded != text
    mods = lint.discover([str(SRC / "repro_torch")])
    path = SRC / "repro_torch" / "models" / "layers.py"
    copy = lint.LintContext([lint.parse_module(path, source=seeded)
                             if m.path == path else m for m in mods])
    hit = {f.symbol for f in lint.run_rules(copy, [R2],
                                            respect_disables=False)
           if pathlib.Path(f.path).name == "layers.py"}
    assert hit == {"_drop_scatter"}
