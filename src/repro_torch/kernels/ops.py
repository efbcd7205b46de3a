"""Checked wrappers for the hand-written kernels, with launch counters.

Every wrapper validates device, dtype, shape and contiguity, then:

* a CPU tensor goes to the plain PyTorch version in ``ref`` (the CPU tests
  and the kernels-on CPU path run there);
* a CUDA tensor launches the kernel from ``build.load()`` on PyTorch's
  current stream, or raises — there is no fallback;
* a meta tensor (the dry run, ``launch/dryrun.py``) makes the same checks
  and allocates on the meta device exactly the outputs and scratch the
  CUDA branch allocates; it launches nothing and counts no launch, but
  adds the kernel's operation count to ``meta_flops[name]`` and the bytes
  it moves to ``meta_bytes[name]`` (the work behind PERF.md's bound
  column, taken from the shapes: attention over every key the buffers
  hold, the grouped GEMM over every row of its buffer, the combine over
  every slot);
* an input that requires grad, under grad mode, raises on either device:
  the kernels have no backward (``_check_inputs``).

``counters[name]`` counts kernel launches (CUDA only), one per launch and
nowhere else; ``reset_counters()`` zeroes them (and the meta counters).  A
run can read them to show that its path went through the kernels.

Launch plans.  A wrapper with a runtime launch knob (attention's ``rows``
and ``n_split``, the router gate's ``warps``, the capacity GEMM's ``ctas``,
the combine's ``rows``) takes it from ``autotune.plan_for`` on its CUDA
and meta branches: a registered (measured) plan for its key, else the
analytic ``*_plan`` function's, one plan per key per process.  The caller
can pin a knob with the keyword of that name (``autotune.tune`` does);
a pinned plan is checked on every device, and one the kernel would refuse
raises ``ValueError`` before any launch.  The grouped GEMM and the two
gathers have no runtime knob (``autotune``'s docstring says why).
"""

from __future__ import annotations

import collections

import torch

from repro_torch.kernels import autotune, build, ref

counters: collections.Counter = collections.Counter()
meta_flops: collections.Counter = collections.Counter()
meta_bytes: collections.Counter = collections.Counter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # csrc/common.cuh codes
_DEVICES = ("cpu", "cuda", "meta")


def reset_counters() -> None:
    counters.clear()
    meta_flops.clear()
    meta_bytes.clear()


def _priced(name: str, flops: int, nbytes: int, out):
    """The meta device's stand-in for a launch: the kernel's operations
    and bytes go to ``meta_flops`` / ``meta_bytes``; ``out`` (its meta
    outputs) is returned as the launch's would be."""
    meta_flops[name] += int(flops)
    meta_bytes[name] += int(nbytes)
    return out


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_inputs(name: str, floats: tuple, ints: tuple = (),
                  others: tuple = ()) -> torch.device:
    """The checks every wrapper makes of its tensors, in one pass: all on
    one device, CPU, CUDA or meta; ``floats`` of one dtype the kernels take;
    ``ints`` int32; ``floats`` and ``ints`` contiguous (``others`` are held
    to the device alone).  Returns the device; raises ``ValueError`` for
    the first failure in that order, its message built only then.

    First of all, under autograd (grad mode on and a float input that
    requires grad) it raises ``RuntimeError``: no kernel has a backward
    (nor has the reference's), so a kernel would cut the gradient to every
    weight before it.  The plain body's CPU branch is refused alike."""
    if torch.is_grad_enabled() and (
            any(t.requires_grad for t in floats)
            or any(t.requires_grad for t in others)):
        raise RuntimeError(
            f"{name}: the hand-written kernels have no backward; run this "
            f"forward under torch.no_grad() or with the kernels off "
            f"(KernelPolicy.off())")
    dev = floats[0].device
    dt = floats[0].dtype
    ok = dev.type in _DEVICES and dt in _DTYPES
    for t in floats:
        ok = ok and t.device == dev and t.dtype == dt and t.is_contiguous()
    for t in ints:
        ok = ok and t.device == dev and t.dtype == torch.int32 \
            and t.is_contiguous()
    for t in others:
        ok = ok and t.device == dev
    if ok:
        return dev
    ts = floats + ints + others
    _check(all(t.device == dev for t in ts),
           "all tensors must be on one device, got "
           + ", ".join(str(t.device) for t in ts))
    _check(dev.type in _DEVICES, f"unsupported device {dev}")
    _check(dt in _DTYPES, f"{name}: dtype must be float32 or bfloat16, "
                          f"got {dt}")
    _check(all(t.dtype == dt for t in floats),
           f"{name}: all float inputs must share one dtype")
    _check(all(t.dtype == torch.int32 for t in ints),
           f"{name}: index tensors must be int32")
    raise ValueError(f"{name}: inputs must be contiguous")


def _launch(fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed to launch: CUDA error {rc}")


def _stream() -> int:
    """The raw handle of PyTorch's current stream on the current device:
    what ``torch.cuda.current_stream().cuda_stream`` gives, without
    building a ``Stream`` object."""
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def _check_attention(name, q, k, v, lengths) -> tuple:
    """The checks the dense and paged attention wrappers share: q and the
    K/V buffers 4-d with matching leading dims, a head layout and head dims
    the kernel takes, (B,) lengths (their dtype and device checked by
    ``_check_inputs`` before).  Returns (nkv, hd, hdv)."""
    _check(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
           f"{name}: q and the K/V buffers must be 4-d")
    b, _, nq, hd = q.shape
    nkv, hdv = k.shape[2], v.shape[3]
    _check(k.shape[3] == hd and v.shape[:3] == k.shape[:3],
           f"{name}: K/V shapes {tuple(k.shape)} / {tuple(v.shape)} do not "
           f"match q {tuple(q.shape)}")
    _check(nkv > 0 and nq % nkv == 0,
           f"{name}: need nq divisible by nkv, got nq={nq} nkv={nkv}")
    _check(hd % 8 == 0 and hdv % 8 == 0 and 0 < hd <= 768
           and 0 < hdv <= 512,
           f"{name}: head dims must be multiples of 8, keys up to 768 and "
           f"values up to 512, got {hd}/{hdv}")
    _check(all(t.shape == (b,) for t in lengths),
           f"{name}: (B,) = ({b},) lengths expected")
    return nkv, hd, hdv


SMS = 132                # H100 SXM streaming multiprocessors
FLASH_MAX_SPLIT = 16     # MAX_SPLIT in csrc/flash_attn.cuh
FLASH_DV = 128           # TC_DV: value columns per CTA of the bf16 body


def flash_plan(b: int, sq: int, nq: int, nkv: int, hd: int,
               hdv: int) -> tuple[int, int]:
    """(rows, n_split) of the bf16 attention body's launch, from the
    geometry alone.  ``rows`` query rows (position x head-in-group) per
    CTA: 128 when a group packs several heads and hd <= 256, else 64.
    ``n_split`` KV splits per query tile: enough CTAs for two per SM over
    the (B, query tiles, nkv, head splits, value-column splits) grid, at
    most ``FLASH_MAX_SPLIT``.  No length enters, so dense and paged
    launches of one geometry split alike (their outputs stay bitwise
    equal)."""
    g = nq // nkv
    rows = 128 if g >= 2 and hd <= 256 else 64
    n_hs = -(-g // rows)
    bq = rows // -(-g // n_hs)
    ctas = b * -(-sq // bq) * nkv * n_hs * -(-hdv // FLASH_DV)
    return rows, max(1, min(FLASH_MAX_SPLIT, -(-2 * SMS // ctas)))


def _aligned(t):
    """t, or a copy of it whose data starts on 16 bytes (the kernels'
    16-byte copies); torch's allocations always do (on the meta device,
    which has no addresses, the view's offset into its storage decides)."""
    at = t.storage_offset() * t.element_size() if t.device.type == "meta" \
        else t.data_ptr()
    return t if at % 16 == 0 else t.clone()


def _flash_pins(q, k, v, rows, n_split) -> None:
    """Check a pinned attention plan (either knob given) on any device:
    the f32 body takes none; the bf16 one a plan ``autotune.check_plan``
    accepts, the unpinned knob taken from the key's plan."""
    if rows is None and n_split is None:
        return
    if q.dtype == torch.float32:
        raise ValueError("flash: the float32 body takes no plan")
    key = autotune.key_shape("flash", (q, k, v))
    plan = autotune.plan_for("flash", key, q.dtype)
    autotune.check_plan("flash", key, q.dtype, {
        "rows": plan["rows"] if rows is None else rows,
        "n_split": plan["n_split"] if n_split is None else n_split})


def _flash_scratch(q, nq, nkv, hd, hdv, rows=None, n_split=None) -> tuple:
    """The launch plan and f32 split scratch of one attention call:
    (rows, n_split, part_o pointer, part_ml pointer, keep-alive), both
    parts in one allocation.  The plan is the key's (``autotune``) with a
    knob the caller pinned (checked before, ``_flash_pins``) in its
    place."""
    b, sq = q.shape[:2]
    if q.dtype == torch.float32:          # the FMA body takes no plan
        return 0, 1, None, None, None
    plan = autotune.plan_for("flash", (b, sq, nq, nkv, hd, hdv), q.dtype)
    rows = plan["rows"] if rows is None else rows
    n_split = plan["n_split"] if n_split is None else n_split
    if n_split == 1:
        return rows, 1, None, None, None
    n_o = n_split * b * sq * nq * hdv
    buf = torch.empty(n_o + n_split * b * sq * nq * 2, dtype=torch.float32,
                      device=q.device)
    return rows, n_split, buf.data_ptr(), buf.data_ptr() + 4 * n_o, buf


def _attn_ops(q, n_keys: int, hd: int, hdv: int) -> int:
    """Attention's operations with every one of ``n_keys`` keys a slot
    visible to every query row: 2 (hd + hdv) a (row, head, key)."""
    b, sq, nq = q.shape[:3]
    return 2 * b * sq * nq * n_keys * (hd + hdv)


def _flash_dense(q, k, v, q_offset, q_len, kv_len, nkv, hd, hdv, scale,
                 name="flash_chunk", rows=None, n_split=None):
    """Launch the dense kernel on checked CUDA inputs (on meta inputs,
    price it under ``name``)."""
    b, sq, nq, _ = q.shape
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty(b, sq, nq, hdv, dtype=q.dtype, device=q.device)
    rows, n_split, part_o, part_ml, _keep = _flash_scratch(
        q, nq, nkv, hd, hdv, rows, n_split)
    if q.device.type == "meta":
        return _priced(name, _attn_ops(q, k.shape[1], hd, hdv),
                       _nbytes(q, k, v, q_offset, q_len, kv_len, out), out)
    _launch(build.load().rt_flash_chunk, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), q_offset.data_ptr(), q_len.data_ptr(),
            kv_len.data_ptr(), out.data_ptr(), part_o, part_ml, b, sq, nq,
            nkv, hd, hdv, k.shape[1], rows, n_split, scale,
            _DTYPES[q.dtype], _stream())
    counters["flash_chunk"] += 1
    return out


def flash_chunk(q, k, v, q_offset, q_len, kv_len, *, scale=None, rows=None,
                n_split=None):
    """Ragged causal attention on a dense cache.  q (B, sq, nq, hd);
    k (B, S, nkv, hd); v (B, S, nkv, hdv); q_offset / q_len / kv_len (B,)
    int32 -> (B, sq, nq, hdv) in q's dtype.  ``rows`` / ``n_split`` pin the
    bf16 body's plan (``flash_plan``).  Contract: ``ref.flash_chunk_ref``."""
    name = "flash_chunk"
    lengths = (q_offset, q_len, kv_len)
    dev = _check_inputs(name, (q, k, v), lengths)
    nkv, hd, hdv = _check_attention(name, q, k, v, lengths)
    b = q.shape[0]
    _check(k.shape[0] == b, f"{name}: K/V batch {k.shape[0]} != q batch {b}")
    _flash_pins(q, k, v, rows, n_split)
    scale = float(hd ** -0.5 if scale is None else scale)
    if dev.type == "cpu":
        return ref.flash_chunk_ref(q, k, v, q_offset, q_len, kv_len, scale)
    return _flash_dense(q, k, v, q_offset, q_len, kv_len, nkv, hd, hdv,
                        scale, rows=rows, n_split=n_split)


def flash_decode(q, k, v, lengths, *, scale=None, rows=None, n_split=None):
    """Single-token decode attention.  q (B, nq, hd); k (B, S, nkv, hd);
    v (B, S, nkv, hdv); lengths (B,) int32 -> (B, nq, hdv).

    No kernel of its own: ``flash_chunk`` at sq == 1 under the decode
    invariant (``q_offset = lengths - 1``, ``q_len = min(lengths, 1)``), so
    a slot with ``lengths == 0`` gives an exact-zero row.  ``counters``
    counts these calls under ``flash_decode`` beside the ``flash_chunk``
    launch each makes; it reads and pins the plan of ``flash_chunk`` at sq
    1.  Contract: ``ref.flash_decode_ref``."""
    name = "flash_decode"
    dev = _check_inputs(name, (q, k, v), (lengths,))
    _check(q.dim() == 3, f"{name}: q must be (B, nq, hd)")
    nkv, hd, hdv = _check_attention(name, q[:, None], k, v, (lengths,))
    _check(k.shape[0] == q.shape[0],
           f"{name}: K/V batch {k.shape[0]} != q batch {q.shape[0]}")
    _flash_pins(q, k, v, rows, n_split)
    if dev.type == "cpu":
        return ref.flash_decode_ref(q, k, v, lengths, scale)
    scale = float(hd ** -0.5 if scale is None else scale)
    out = _flash_dense(q[:, None], k, v, (lengths - 1).clamp_min(0),
                       lengths.clamp_max(1), lengths, nkv, hd, hdv,
                       scale, name, rows, n_split)[:, 0]
    if dev.type == "meta":
        return out
    counters["flash_decode"] += 1
    return out


def flash_chunk_paged(q, k_pages, v_pages, block_tables, q_offset, q_len,
                      kv_len, *, scale=None, rows=None, n_split=None):
    """Paged ragged causal attention.  q (B, sq, nq, hd); k_pages
    (P, page, nkv, hd); v_pages (P, page, nkv, hdv); block_tables
    (B, max_blocks) int32 (-1 = unallocated); q_offset / q_len / kv_len
    (B,) int32 -> (B, sq, nq, hdv) in q's dtype.  It reads and pins the
    plan of ``flash_chunk`` at the same geometry, so the two stay bitwise
    equal.  Contract: ``ref.flash_chunk_paged_ref``."""
    name = "flash_chunk_paged"
    lengths = (q_offset, q_len, kv_len)
    dev = _check_inputs(name, (q, k_pages, v_pages),
                        (block_tables, *lengths))
    nkv, hd, hdv = _check_attention(name, q, k_pages, v_pages, lengths)
    b, sq, nq, _ = q.shape
    n_pages, page = k_pages.shape[:2]
    _check(block_tables.dim() == 2 and block_tables.shape[0] == b,
           f"{name}: block_tables (B, nb) expected")
    _flash_pins(q, k_pages, v_pages, rows, n_split)
    scale = float(hd ** -0.5 if scale is None else scale)
    if dev.type == "cpu":
        return ref.flash_chunk_paged_ref(q, k_pages, v_pages, block_tables,
                                         q_offset, q_len, kv_len, scale)
    q, k_pages, v_pages = _aligned(q), _aligned(k_pages), _aligned(v_pages)
    out = torch.empty(b, sq, nq, hdv, dtype=q.dtype, device=dev)
    rows, n_split, part_o, part_ml, _keep = _flash_scratch(
        q, nq, nkv, hd, hdv, rows, n_split)
    if dev.type == "meta":     # every key the block tables address
        keys = block_tables.shape[1] * page
        kv_bytes = b * keys * nkv * (hd + hdv) * q.element_size()
        return _priced(name, _attn_ops(q, keys, hd, hdv),
                       _nbytes(q, block_tables, q_offset, q_len, kv_len, out)
                       + kv_bytes, out)
    _launch(build.load().rt_flash_chunk_paged, q.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
            q_offset.data_ptr(), q_len.data_ptr(), kv_len.data_ptr(),
            out.data_ptr(), part_o, part_ml, b, sq, nq, nkv, hd, hdv, page,
            block_tables.shape[1], n_pages, rows, n_split, scale,
            _DTYPES[q.dtype], _stream())
    counters[name] += 1
    return out


TOPK_MAX_WARPS = 8   # MAX_WARPS in csrc/topk_gate.cu: warps per CTA


def topk_plan(t: int, e: int) -> tuple[int, int, int]:
    """(lanes per row, warps per CTA, CTAs) of the router gate's launch
    over t rows of e logits, from the shape alone (k does not enter).  A
    row takes one warp: all 32 lanes, or 16 where e <= 16 (the other 16
    exit at once).  Warps per CTA: the fewest, in powers of two up to
    ``TOPK_MAX_WARPS``, that keep the grid within one CTA per SM (SMS), so
    a served call spreads its rows over the SMs a few warps each.  The
    kernel refuses a launch that does not cover the rows or whose lanes
    per row are not its own."""
    wpc = 1
    while wpc < TOPK_MAX_WARPS and -(-t // wpc) > SMS:
        wpc *= 2
    return 16 if e <= 16 else 32, wpc, -(-t // wpc)


def topk_gate(logits, k: int, *, renorm: bool = True, warps=None):
    """logits (T, E) -> (weights (T, k) f32, idx (T, k) int32): softmax,
    top-k with ties to the lowest id, optional renorm.  ``warps`` pins the
    warps per CTA (``topk_plan``).  Contract: ``ref.topk_gate_ref``."""
    name = "topk_gate"
    dev = _check_inputs(name, (logits,))
    _check(logits.dim() == 2, f"{name}: logits must be (T, E)")
    t, e = logits.shape
    _check(1 <= e <= 256 and 1 <= k <= min(e, 32),
           f"{name}: need E <= 256 and 1 <= k <= min(E, 32), got E={e} k={k}")
    if warps is not None:
        warps = autotune.check_plan(name, (t, e), logits.dtype,
                                    {"warps": warps})["warps"]
    if dev.type == "cpu":
        return ref.topk_gate_ref(logits, k, renorm)
    # two allocations: one (2, T, k) buffer costs more host time in the
    # views that split it (chip_smoke.py's [host] router line)
    w = torch.empty(t, k, dtype=torch.float32, device=dev)
    idx = torch.empty(t, k, dtype=torch.int32, device=dev)
    if warps is None:
        warps = autotune.plan_for(name, (t, e), logits.dtype)["warps"]
    if dev.type == "meta":
        return _priced(name, 5 * t * e, _nbytes(logits, w, idx), (w, idx))
    _launch(build.load().rt_topk_gate, logits.data_ptr(), w.data_ptr(),
            idx.data_ptr(), t, e, k, int(bool(renorm)),
            _DTYPES[logits.dtype], 16 if e <= 16 else 32, warps,
            -(-t // warps), _stream())
    counters[name] += 1
    return w, idx


MOE_BK = 64         # BK in csrc/moe_gemm.cu: H per unit


def moe_gemm_bn(mt: int) -> int:
    """Output columns per tile of the capacity GEMM (``Geo`` in
    csrc/moe_gemm.cu): 256 for one 16-row m-tile, else 128; also its
    threads per CTA, so a tile's carried sums are 16 mt x this f32
    values."""
    return 256 if mt == 1 else 128


def moe_gemm_plan(e: int, c: int, h: int,
                  d: int) -> tuple[int, int, int, int]:
    """(ctas, units, tiles, mt) of the capacity GEMM's launch, from the
    shapes alone.  ``mt`` 16-row m-tiles per tile (all C rows up to 64,
    64-row tiles past that); a tile is one expert's row tile x
    ``moe_gemm_bn(mt)`` columns and holds ceil(H / ``MOE_BK``) units (at
    least one), ``units`` in all; one CTA per SM (fewer when there are
    fewer units).  ``moe_gemm_split`` says which tiles go whole, in
    rounds, and which are cut stream-K; either way every SM streams the
    same weight bytes to within one unit.  The kernel refuses a plan
    whose ``units`` are not its own tiling's or whose grid leaves a CTA
    idle."""
    mt = 1 if c <= 16 else 2 if c <= 32 else 3 if c <= 48 else 4
    tiles = e * -(-c // (16 * mt)) * -(-d // moe_gemm_bn(mt))
    units = tiles * max(1, -(-h // MOE_BK))
    return min(SMS, units), units, tiles, mt


def moe_gemm_split(tiles: int, ctas: int) -> tuple[int, int]:
    """(stream-K tiles, whole rounds) of the capacity GEMM's schedule, as
    csrc/moe_gemm.cu derives them: the tiles go whole in full rounds of
    ``ctas`` (CTA c taking each round's c-th tile, so the SMs stream
    neighbouring columns together), keeping one round plus the remainder
    back for stream-K, whose units are cut evenly, so every CTA's share is
    at least a tile; all whole when ``ctas`` divides the tiles, all
    stream-K under two rounds."""
    whole = tiles if tiles % ctas == 0 else \
        (tiles // ctas - 1) * ctas if tiles // ctas >= 2 else 0
    return tiles - whole, whole // ctas


_flags: dict = {}   # device index -> zeroed int32 carry flags, one a CTA


def _moe_flags(dev) -> torch.Tensor:
    """The capacity GEMM's carry flags: ``SMS`` int32 zeros, kept per
    device (the kernel sets each flag it raises back to zero).  Launches
    on one stream at a time share them."""
    buf = _flags.get(dev.index)
    if buf is None:
        buf = _flags[dev.index] = torch.zeros(SMS, dtype=torch.int32,
                                              device=dev)
    return buf


def moe_gemm(x, w, *, ctas=None):
    """Capacity-mode batched expert GEMM.  x (E, C, H) @ w (E, H, D) ->
    (E, C, D) in x's dtype, float32 accumulation; an all-zero row of x gives
    an exact-zero row.  bf16 runs on ``moe_gemm_plan``'s grid, the split
    tiles' f32 running sums carried between CTAs through scratch: every
    output is summed in one pass in H order, the same bits on every call.
    ``ctas`` pins the grid (``moe_gemm_plan``'s first entry).  Contract:
    ``ref.moe_gemm_ref``."""
    name = "moe_gemm"
    dev = _check_inputs(name, (x, w))
    _check(x.dim() == 3 and w.dim() == 3 and x.shape[0] == w.shape[0]
           and x.shape[2] == w.shape[1],
           f"{name}: need x (E, C, H) and w (E, H, D), got "
           f"{tuple(x.shape)} and {tuple(w.shape)}")
    e, c, h = x.shape
    d = w.shape[2]
    _check(e <= 65535, f"{name}: at most 65535 experts, got {e}")
    if ctas is not None:
        ctas = autotune.check_plan(name, (e, c, h, d), x.dtype,
                                   {"ctas": ctas})["ctas"]
    if dev.type == "cpu":
        return ref.moe_gemm_ref(x, w)
    out = torch.empty(e, c, d, dtype=x.dtype, device=dev)
    _, units, _, mt = moe_gemm_plan(e, c, h, d)
    if ctas is None:
        ctas = autotune.plan_for(name, (e, c, h, d), x.dtype)["ctas"]
    carry = flags = None
    if x.dtype == torch.bfloat16 and units:
        carry = torch.empty(ctas * 16 * mt * moe_gemm_bn(mt),
                            dtype=torch.float32, device=dev)
        flags = _moe_flags(dev)
    if dev.type == "meta":
        return _priced(name, 2 * e * c * h * d, _nbytes(x, w, out), out)
    _launch(build.load().rt_moe_gemm, x.data_ptr(), w.data_ptr(),
            out.data_ptr(), None if carry is None else carry.data_ptr(),
            None if flags is None else flags.data_ptr(), e, c, h, d, ctas,
            units, _DTYPES[x.dtype], _stream())
    counters[name] += 1
    return out


GG_ROWS = 64   # rows per grouped-GEMM visit (BM in csrc/grouped_gemm.cu)


def grouped_gemm_visits(n: int, e: int) -> int:
    """The static bound on the grouped GEMM's visits (one CTA row each):
    the BM-row tiles of the E expert segments plus the zero tiles of
    ``[offsets[-1], N)``.  Each non-empty segment ends in at most one
    partial tile, so the count is at most ``ceil(N / BM) + min(E, N)``
    (the reference's ``n_visits``); the kernel refuses a smaller grid."""
    return -(-n // GG_ROWS) + min(e, n)


def grouped_gemm(x, w, group_offsets):
    """x (N, H) sorted by expert @ w (E, H, D) with group_offsets (E+1,)
    int32, an ascending prefix sum from 0 -> (N, D) in x's dtype, f32
    accumulation; rows at/after ``offsets[-1]`` are exact zeros.
    Contract: ``ref.grouped_gemm_ref``."""
    name = "grouped_gemm"
    dev = _check_inputs(name, (x, w), (group_offsets,))
    _check(x.dim() == 2 and w.dim() == 3 and x.shape[1] == w.shape[1],
           f"{name}: need x (N, H) and w (E, H, D), got {tuple(x.shape)} "
           f"and {tuple(w.shape)}")
    n, h = x.shape
    e, _, d = w.shape
    _check(group_offsets.shape == (e + 1,),
           f"{name}: group_offsets must be (E+1,) = ({e + 1},)")
    if dev.type == "cpu":
        return ref.grouped_gemm_ref(x, w, group_offsets)
    out = torch.empty(n, d, dtype=x.dtype, device=dev)
    if dev.type == "meta":     # every row of the buffer, routed or not
        return _priced(name, 2 * n * h * d,
                       _nbytes(x, w, group_offsets, out), out)
    _launch(build.load().rt_grouped_gemm, x.data_ptr(), w.data_ptr(),
            group_offsets.data_ptr(), out.data_ptr(), n, h, d, e,
            grouped_gemm_visits(n, e), _DTYPES[x.dtype], _stream())
    counters[name] += 1
    return out


PERMUTE_ROWS = 32     # G_ROWS in csrc/permute.cu: rows per CTA, the skip tile
PERMUTE_CHUNK = 8     # G_CHUNK: units of each row per CTA
PERMUTE_THREADS = 64  # G_THREADS: a unit column and 4 rows 8 apart each


def permute_plan(n: int, row_bytes: int,
                 elem_bytes: int) -> tuple[int, int, int]:
    """(grid_x, grid_y, unit bytes) of a gather of n rows of ``row_bytes``
    (both gather kernels).  A unit is 16 bytes where the row is a multiple
    of 16, else one element (the element-wise kernels).  A CTA moves
    ``PERMUTE_ROWS`` rows x ``PERMUTE_CHUNK`` units of one column chunk:
    row tiles on grid x, which takes 2^31 - 1 of them, column chunks on
    grid y (at most 65535, so rows of up to 8 MB).  The kernels refuse a
    grid that does not cover the rows and units."""
    unit = 16 if row_bytes % 16 == 0 else elem_bytes
    return (-(-n // PERMUTE_ROWS),
            -(-(row_bytes // unit) // PERMUTE_CHUNK), unit)


def _gather(x, src_tok, total=None, seg_stride=0, name="permute_tokens"):
    """Launch a gather kernel (the ragged one where ``total`` is given) on
    checked CUDA inputs (on meta inputs, price it under ``name``: the
    rows it reads and writes)."""
    x = _aligned(x)
    t, h = x.shape
    n = src_tok.shape[0]
    out = x.new_empty(n, h)     # x's dtype and device: no keywords to parse
    if x.device.type == "meta":
        extra = () if total is None else (total,)
        return _priced(name, 0, 2 * _nbytes(out) + _nbytes(src_tok, *extra),
                       out)
    es = x.element_size()
    gx, gy, _ = permute_plan(n, h * es, es)
    lib = build.load()
    if total is None:
        _launch(lib.rt_permute_tokens, x.data_ptr(), src_tok.data_ptr(),
                out.data_ptr(), n, t, h, es, gx, gy, _stream())
    else:
        _launch(lib.rt_permute_tokens_ragged, x.data_ptr(),
                src_tok.data_ptr(), total.data_ptr(), out.data_ptr(), n, t,
                h, es, seg_stride, gx, gy, _stream())
    return out


def permute_tokens(x, src_tok):
    """x (T, h), src_tok (N,) int32 -> (N, h); ``src_tok[i] < 0`` yields a
    zero row.  Contract: ``ref.permute_tokens_ref``."""
    dev = _check_inputs("permute_tokens", (x,), (src_tok,))
    _check(x.dim() == 2 and src_tok.dim() == 1,
           "permute_tokens: need x (T, h) and src_tok (N,)")
    if dev.type == "cpu":
        return ref.permute_tokens_ref(x, src_tok)
    out = _gather(x, src_tok)
    if dev.type == "meta":
        return out
    counters["permute_tokens"] += 1
    return out


def permute_tokens_ragged(x, src_tok, total, *, seg_stride=None):
    """``permute_tokens`` on a buffer of fixed-stride segments, each valid
    only in a leading prefix.  x (T, h), src_tok (N,) int32 -> (N, h).
    ``total`` is a () int32 prefix over one segment spanning the buffer, or
    (n_seg,) int32 prefixes of segments ``seg_stride`` rows apart (default
    ``seg_stride`` = N).  Rows outside the prefixes must carry
    ``src_tok == -1``; tiles lying wholly past their prefixes are written as
    zeros without a gather.  Raises ``ValueError`` when the segments do not
    cover the buffer.  Contract: ``ref.permute_tokens_ragged_ref``."""
    name = "permute_tokens_ragged"
    dev = _check_inputs(name, (x,), (src_tok, total))
    _check(x.dim() == 2 and src_tok.dim() == 1 and total.dim() <= 1,
           "permute_tokens_ragged: need x (T, h), src_tok (N,) and total () "
           "or (n_seg,)")
    n, n_seg = src_tok.shape[0], total.numel()
    seg_stride = n if seg_stride is None else int(seg_stride)
    if n_seg * seg_stride < n:
        raise ValueError(f"{name}: segments ({n_seg} x {seg_stride}) do not "
                         f"cover the {n}-row buffer")
    if dev.type == "cpu":
        return ref.permute_tokens_ragged_ref(x, src_tok, total,
                                             seg_stride=seg_stride)
    if n == 0:
        return torch.empty(0, x.shape[1], dtype=x.dtype, device=dev)
    out = _gather(x, src_tok, total, seg_stride, name)
    if dev.type == "meta":
        return out
    counters[name] += 1
    return out


UNPERMUTE_CHUNK = 8   # U_CHUNK in csrc/permute.cu: units of a row per CTA
UNPERMUTE_LANES = 8   # U_LANES: row lanes per CTA, R rows each


def unpermute_rows_max(k: int) -> int:
    """The most rows a combine thread takes (``rows_max`` in
    csrc/permute.cu): 2 for k <= 2, else 1, so its loads in flight (R x
    the slot group, k rounded up to 1, 2, 4, 6 or 8) stay at most 8 and
    its registers under 64."""
    return 2 if k <= 2 else 1


def unpermute_plan(t: int, k: int, row_bytes: int, elem_bytes: int,
                   rows: int = 0) -> tuple[int, int, int, int]:
    """(grid_x, grid_y, rows, unit bytes) of the combine into t rows of
    ``row_bytes`` from k slots each.  A unit is 16 bytes where the row is
    a multiple of 16, else one element.  A CTA covers ``UNPERMUTE_LANES``
    x ``rows`` rows by ``UNPERMUTE_CHUNK`` units: row tiles on grid x,
    column chunks on grid y (at most 65535).  ``rows`` per thread, unless
    given, is the most the slot group allows, halved while the grid holds
    fewer than two CTAs per SM.  The kernel refuses a grid that does not
    cover the rows and units."""
    unit = 16 if row_bytes % 16 == 0 else elem_bytes
    gy = -(-(row_bytes // unit) // UNPERMUTE_CHUNK)
    if not rows:
        rows = unpermute_rows_max(k)
        while rows > 1 and -(-t // (UNPERMUTE_LANES * rows)) * gy \
                < 2 * SMS:
            rows //= 2
    return -(-t // (UNPERMUTE_LANES * rows)), gy, rows, unit


def unpermute_tokens(buf, src_slot, weights, *, rows=None):
    """buf (M, h), src_slot (T, k) int32, weights (T, k) -> (T, h) in buf's
    dtype: each token's k expert rows weighted and summed in float32, in
    slot order; ``src_slot < 0`` adds row 0 times 0.  The weights are cast
    to float32 here, as the reference wrapper does.  ``rows`` pins the rows
    a thread takes (``unpermute_plan``).  Contract:
    ``ref.unpermute_tokens_ref``."""
    name = "unpermute_tokens"
    dev = _check_inputs(name, (buf,), (src_slot,), (weights,))
    _check(weights.is_floating_point(), f"{name}: weights must be float")
    weights = weights.float().contiguous()
    _check(buf.dim() == 2 and src_slot.dim() == 2
           and weights.shape == src_slot.shape,
           f"{name}: need buf (M, h), src_slot and weights (T, k)")
    m, h = buf.shape
    t, k = src_slot.shape
    if rows is not None:
        rows = autotune.check_plan(name, (t, k, h), buf.dtype,
                                   {"rows": rows})["rows"]
    if dev.type == "cpu":
        return ref.unpermute_tokens_ref(buf, src_slot, weights)
    _check(m > 0 or t == 0, f"{name}: empty buf with {t} tokens to combine")
    buf = _aligned(buf)
    out = torch.empty(t, h, dtype=buf.dtype, device=dev)
    if rows is None:
        rows = autotune.plan_for(name, (t, k, h), buf.dtype)["rows"]
    if dev.type == "meta":     # every slot's row, weighted and summed
        return _priced(name, 2 * t * k * h,
                       (t * k + t) * h * buf.element_size()
                       + _nbytes(src_slot, weights), out)
    es = buf.element_size()
    gx, gy, _, _ = unpermute_plan(t, k, h * es, es, rows)
    _launch(build.load().rt_unpermute_tokens, buf.data_ptr(),
            src_slot.data_ptr(), weights.data_ptr(), out.data_ptr(), t, k, h,
            m, _DTYPES[buf.dtype], gx, gy, rows, _stream())
    counters[name] += 1
    return out


__all__ = ["flash_chunk", "flash_decode", "flash_chunk_paged", "flash_plan",
           "topk_gate", "topk_plan", "moe_gemm", "moe_gemm_plan",
           "moe_gemm_split", "moe_gemm_bn",
           "grouped_gemm",
           "grouped_gemm_visits", "permute_tokens", "permute_plan",
           "permute_tokens_ragged", "unpermute_tokens", "unpermute_plan",
           "counters", "reset_counters"]
