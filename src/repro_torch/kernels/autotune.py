"""Launch plans for the hand-written kernels: a shape-keyed cache of
measured choices over the analytic plans of ``kernels/ops.py``.

Every wrapper with a runtime launch knob asks ``select_plan(op, shape,
dtype)`` for it when the caller does not pin it (keyword-only arguments of
the wrapper).  Resolution order:

  1. the in-process cache (an earlier ``select_plan`` result for the same
     key, or an explicit ``register``), then
  2. the registrations a ``tune`` sweep measured and persisted (the file
     below, read once per process on the first miss), then
  3. the analytic plan of ``ops``: the plan every launch took before this
     cache existed.

A plan, once resolved for a key in a process, stays fixed for it (only an
explicit ``register`` replaces it), so split orders never change between
calls of one geometry.

Ops, knobs and keys (the key shape is what the wrapper builds):

  ``flash``             {rows, n_split} of the bf16 attention body, from
                        ``ops.flash_plan``; key (b, sq, nq, nkv, hd, hdv).
                        One key for ``flash_chunk``, ``flash_chunk_paged``
                        and ``flash_decode`` (sq 1): ``n_split`` sets the
                        order of the split-KV sums, and paged output must
                        stay bitwise equal to dense, so the three read one
                        entry and no length or page size enters the key.
                        The f32 body takes no plan.
  ``topk_gate``         {warps} per CTA (1, 2, 4 or 8; a row a warp), from
                        ``ops.topk_plan``; key (T, E).
  ``moe_gemm``          {ctas} of the capacity GEMM's grid (at most
                        min(SMS, units)), from ``ops.moe_gemm_plan``; key
                        (E, C, H, D).
  ``unpermute_tokens``  {rows} a combine thread takes (1 up to
                        ``ops.unpermute_rows_max(k)``), from
                        ``ops.unpermute_plan``; key (T, k, h).
  ``kv_page``           {page} of the paged KV cache, read by
                        ``core.resolve.auto_kv`` through ``lookup``; key
                        ``resolve.kv_page_key(cfg, max_len)``, dtype
                        "bfloat16".
  ``resolver``          {batch_cap, itl_slack_pct}, the per-host resolver
                        constants, read by ``core.resolve`` through
                        ``lookup``; key (), dtype "host".

Three kernels have no runtime knob and stay on their analytic launch:
``grouped_gemm`` (its 64-row tile is compiled in and its grid is the
static visit bound ``ops.grouped_gemm_visits``), ``permute_tokens`` and
``permute_tokens_ragged`` (their grid follows from the compiled
``PERMUTE_ROWS`` x ``PERMUTE_CHUNK`` tile).  They are keyed nowhere.

A plan is checked on the host before its first launch (``check_plan``): one
the kernel would refuse raises ``ValueError``.  ``register`` checks it,
the wrappers check a pinned one, and an entry read from the file is checked
when it is adopted.

Persistence.  Measured registrations are written through to a versioned
JSON file, ``~/.cache/repro_torch/autotune.json`` (override with
``REPRO_TORCH_AUTOTUNE_CACHE``; the empty string disables persistence)::

    {"version": 1,
     "entries": {"<op>|<d0>,<d1>,...|<dtype>": {"<knob>": <int>, ...}}}

e.g. ``"flash|4,64,32,8,128,128|bfloat16": {"rows": 128, "n_split": 2}``.
A file of another version is ignored wholesale (a stale plan is worse than
the analytic one), a write replaces the file atomically, an in-memory entry
beats the file's, and analytic plans are never written.  The file and the
variable are the port's own: the JAX package's cache (``REPRO_AUTOTUNE_CACHE``)
has another schema and is never read or written here.

``tune(op, fn, candidates, *args)`` times ``fn(*args, **plan)`` for each
candidate (CUDA events on the card, the median of ``iters``; the host
clock on the CPU, where the wrappers run their plain bodies, so a CPU
``tune`` proves only the key), skips a candidate ``check_plan`` refuses,
and registers the fastest under the key the wrapper builds from the same
arguments.  Nothing else is caught: a CUDA error is sticky and propagates.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Callable, NamedTuple, Optional

import torch

CACHE_VERSION = 1
ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
KNOBS = {"flash": ("rows", "n_split"), "topk_gate": ("warps",),
         "moe_gemm": ("ctas",), "unpermute_tokens": ("rows",),
         "kv_page": ("page",), "resolver": ("batch_cap", "itl_slack_pct")}
OPS = tuple(KNOBS)


class KernelKey(NamedTuple):
    """(op, shape, dtype name); equal to, and hashed as, the plain tuple,
    so the wrappers look up ``(op, shape, name)`` without building one."""
    op: str
    shape: tuple
    dtype: str


_CACHE: dict = {}
_ANALYTIC: set = set()      # keys whose cached plan is the analytic one
_persist_loaded = False
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16", torch.float64: "float64"}


def dtype_name(dtype) -> str:
    """One spelling per dtype: ``torch.bfloat16``, ``"bfloat16"`` and
    ``"torch.bfloat16"`` all give ``"bfloat16"``; numpy dtypes their name;
    a non-dtype string (the resolver's ``"host"``) stays as it is."""
    name = _DTYPE_NAMES.get(dtype)
    if name is not None:
        return name
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    if isinstance(dtype, str):
        return dtype.rsplit(".", 1)[-1] if dtype.startswith("torch.") \
            else dtype
    import numpy as np
    return np.dtype(dtype).name


def cache_key(op: str, shape: tuple, dtype) -> KernelKey:
    if op not in OPS:
        raise KeyError(f"unknown autotune op {op!r} (have {OPS})")
    return KernelKey(op, tuple(int(s) for s in shape), dtype_name(dtype))


# ---------------------------------------------------------------------------
# analytic plans and the host-side check
# ---------------------------------------------------------------------------

def default_plan(op: str, shape: tuple, dtype: str) -> dict:
    """The analytic plan: what ``ops`` launches with nothing registered."""
    from repro_torch.kernels import ops
    from repro_torch.core import resolve
    if op == "flash":
        rows, n_split = ops.flash_plan(*shape)
        return {"rows": rows, "n_split": n_split}
    if op == "topk_gate":
        return {"warps": ops.topk_plan(*shape)[1]}
    if op == "moe_gemm":
        return {"ctas": ops.moe_gemm_plan(*shape)[0]}
    if op == "unpermute_tokens":
        t, k, h = shape
        es = 4 if dtype == "float32" else 2
        return {"rows": ops.unpermute_plan(t, k, h * es, es)[2]}
    if op == "kv_page":
        page = resolve.KV_PAGE_SIZE
        while page > 1 and shape[0] % page:
            page //= 2
        return {"page": page}
    if op == "resolver":
        return {"batch_cap": resolve.AUTO_BATCH_CAP,
                "itl_slack_pct": round(resolve.ITL_SLACK * 100)}
    raise KeyError(op)


def check_plan(op: str, shape: tuple, dtype, plan: dict) -> dict:
    """``plan`` as ints if the kernel would launch it at this key, else
    ``ValueError`` naming the rule it breaks (the C entry points' own
    refusals, made on the host before any launch)."""
    key = cache_key(op, shape, dtype)
    want = KNOBS[op]
    if set(plan) != set(want):
        raise ValueError(f"{op}: a plan holds exactly {want}, got "
                         f"{sorted(plan)}")
    p = {k: int(v) for k, v in plan.items()}
    from repro_torch.kernels import ops
    if op == "flash":
        b, _sq, _nq, _nkv, hd, _hdv = key.shape
        if key.dtype != "bfloat16":
            raise ValueError(f"flash: the {key.dtype} body takes no plan")
        if p["rows"] not in (64, 128) or (p["rows"] == 128 and hd > 256):
            raise ValueError(f"flash: rows must be 64, or 128 where hd <= "
                             f"256, got {p['rows']} at hd {hd}")
        if not 1 <= p["n_split"] <= ops.FLASH_MAX_SPLIT \
                or b * p["n_split"] > 65535:
            raise ValueError(f"flash: n_split must be 1..{ops.FLASH_MAX_SPLIT}"
                             f" with B * n_split <= 65535, got "
                             f"{p['n_split']} at B {b}")
    elif op == "topk_gate":
        if p["warps"] not in (1, 2, 4, 8):
            raise ValueError(f"topk_gate: warps per CTA must be 1, 2, 4 or "
                             f"8, got {p['warps']}")
    elif op == "moe_gemm":
        units = ops.moe_gemm_plan(*key.shape)[1]
        if units and not 1 <= p["ctas"] <= min(ops.SMS, units):
            raise ValueError(f"moe_gemm: ctas must be 1..min(SMS, units) = "
                             f"{min(ops.SMS, units)}, got {p['ctas']}")
    elif op == "unpermute_tokens":
        k = key.shape[1]
        if not 1 <= p["rows"] <= ops.unpermute_rows_max(k):
            raise ValueError(f"unpermute_tokens: rows must be 1.."
                             f"{ops.unpermute_rows_max(k)} at k {k}, got "
                             f"{p['rows']}")
    elif min(p.values()) < 1:
        raise ValueError(f"{op}: every knob must be positive, got {p}")
    return p


# ---------------------------------------------------------------------------
# persistence (measured registrations only)
# ---------------------------------------------------------------------------

def cache_path() -> Optional[str]:
    """The persistent file's path, or None when persistence is off."""
    env = os.environ.get(ENV)
    if env is not None:
        return env or None
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "autotune.json")


def _key_str(key: KernelKey) -> str:
    return f"{key.op}|{','.join(map(str, key.shape))}|{key.dtype}"


def _key_from_str(s: str) -> KernelKey:
    op, shape, dtype = s.split("|")
    return cache_key(op, tuple(int(x) for x in shape.split(",") if x), dtype)


def _read_persistent() -> dict:
    """{key string: plan} from the file; {} when there is none, it cannot
    be read, or it is of another version."""
    path = cache_path()
    if not path or not os.path.exists(path):
        return {}
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}
    if not isinstance(payload, dict) or payload.get("version") \
            != CACHE_VERSION:
        return {}
    entries = payload.get("entries")
    return entries if isinstance(entries, dict) else {}


def load_persistent() -> int:
    """Adopt the file's registrations into the in-process cache (in-memory
    entries win); returns how many it adopted.  An entry the kernel would
    refuse raises ``ValueError``."""
    global _persist_loaded
    _persist_loaded = True
    adopted = 0
    for ks, plan in _read_persistent().items():
        key = _key_from_str(ks)
        if key in _CACHE:
            continue
        try:
            _CACHE[key] = check_plan(key.op, key.shape, key.dtype, plan)
        except ValueError as e:
            raise ValueError(f"{cache_path()}: entry {ks!r}: {e}") from None
        adopted += 1
    return adopted


def _write_persistent(key: KernelKey, plan: dict) -> None:
    path = cache_path()
    if not path:
        return
    folder = os.path.dirname(path) or "."
    os.makedirs(folder, exist_ok=True)
    entries = _read_persistent()
    entries[_key_str(key)] = plan
    fd, tmp = tempfile.mkstemp(dir=folder, suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        json.dump({"version": CACHE_VERSION, "entries": entries}, f,
                  indent=1, sort_keys=True)
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

def register(op: str, shape: tuple, dtype, plan: dict, *,
             persist: bool = True) -> None:
    """Make ``plan`` the key's plan in this process (and, with ``persist``,
    in the file).  Raises ``ValueError`` for a plan the kernel refuses."""
    key = cache_key(op, shape, dtype)
    p = check_plan(op, key.shape, key.dtype, plan)
    _CACHE[key] = p
    _ANALYTIC.discard(key)
    if persist:
        _write_persistent(key, p)


def _resolve(key: KernelKey) -> dict:
    """The key's plan on a miss of the in-process cache: the file's entry,
    else the analytic plan (kept in the cache from then on)."""
    if not _persist_loaded:
        load_persistent()
    hit = _CACHE.get(key)
    if hit is None:
        hit = _CACHE[key] = default_plan(*key)
        _ANALYTIC.add(key)
    return hit


def plan_for(op: str, shape: tuple, dtype) -> dict:
    """The wrappers' lookup: the cached plan itself (do not modify it).
    ``shape`` must be a tuple of ints and ``dtype`` a torch dtype; a hit is
    one dict get."""
    hit = _CACHE.get((op, shape, _DTYPE_NAMES[dtype]))
    return hit if hit is not None else _resolve(cache_key(op, shape, dtype))


def select_plan(op: str, shape: tuple, dtype) -> dict:
    """The plan for ``op`` at ``shape`` / ``dtype``: in-process cache, then
    the persisted registrations, then the analytic plan (a copy)."""
    key = cache_key(op, shape, dtype)
    hit = _CACHE.get(key)
    return dict(hit if hit is not None else _resolve(key))


select_blocks = select_plan     # the JAX package's name for it


def lookup(op: str, shape: tuple, dtype) -> Optional[dict]:
    """A registration for the key (in process or persisted), or None; never
    the analytic plan, so a resolver can tell a measured entry from the
    formula's."""
    key = cache_key(op, shape, dtype)
    if key not in _CACHE and not _persist_loaded:
        load_persistent()
    hit = _CACHE.get(key)
    return dict(hit) if hit is not None and key not in _ANALYTIC else None


def cache_info() -> dict:
    """{KernelKey: plan} of every key resolved or registered so far."""
    return {k: dict(v) for k, v in _CACHE.items()}


def clear_cache(*, persistent: bool = False) -> None:
    """Empty the in-process cache (the file is read again on the next
    miss); with ``persistent`` also remove the file."""
    global _persist_loaded
    _CACHE.clear()
    _ANALYTIC.clear()
    _persist_loaded = False
    if persistent:
        path = cache_path()
        if path and os.path.exists(path):
            os.remove(path)


# ---------------------------------------------------------------------------
# measuring
# ---------------------------------------------------------------------------

def key_shape(op: str, args: tuple) -> tuple:
    """The key shape the ``ops`` wrapper for ``op`` builds from its
    positional arguments."""
    if op == "flash":         # (q, k|k_pages, v|v_pages, ...); decode q 3-d
        q, k, v = args[:3]
        b, sq, nq = (q.shape[0], 1, q.shape[1]) if q.dim() == 3 \
            else q.shape[:3]
        return (b, sq, nq, k.shape[2], k.shape[3], v.shape[3])
    if op == "topk_gate":     # (logits, k)
        return tuple(args[0].shape)
    if op == "moe_gemm":      # (x (E, C, H), w (E, H, D))
        return tuple(args[0].shape) + (args[1].shape[2],)
    if op == "unpermute_tokens":    # (buf (M, h), src_slot (T, k), w)
        return tuple(args[1].shape) + (args[0].shape[1],)
    raise KeyError(f"{op}: no kernel arguments to key")


def _median_ms(fn, device, warmup: int, iters: int) -> float:
    for _ in range(warmup):
        fn()
    ts = []
    if device.type == "cuda":
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
    return sorted(ts)[len(ts) // 2]


def tune(op: str, fn: Callable, candidates: list, *args,
         shape: Optional[tuple] = None, dtype=None, warmup: int = 1,
         iters: int = 3, timings: Optional[list] = None) -> dict:
    """Time ``fn(*args, **plan)`` for each candidate plan, register the
    fastest (persisted, see the module docstring) and return it.

    ``shape`` / ``dtype`` default to the key the wrapper builds from the
    same arguments, so the registration is the one the served path reads.
    A candidate ``check_plan`` refuses is skipped (``ValueError`` only);
    with none left the analytic plan is registered.  ``timings``, when
    given, receives ``(plan, ms or None if refused)`` per candidate."""
    if shape is None:
        shape = key_shape(op, args)
    if dtype is None:
        dtype = args[0].dtype
    device = args[0].device
    best, best_ms = None, float("inf")
    for plan in candidates:
        try:
            plan = check_plan(op, shape, dtype, plan)
        except ValueError:
            if timings is not None:
                timings.append((dict(plan), None))
            continue
        ms = _median_ms(lambda: fn(*args, **plan), device, warmup, iters)
        if timings is not None:
            timings.append((plan, ms))
        if ms < best_ms:
            best, best_ms = plan, ms
    key = cache_key(op, shape, dtype)
    if best is None:
        best = default_plan(*key)
    register(op, key.shape, key.dtype, best)
    return dict(best)


__all__ = ["select_plan", "select_blocks", "plan_for", "lookup", "register",
           "tune", "cache_info", "clear_cache", "cache_key", "cache_path",
           "load_persistent", "check_plan", "default_plan", "key_shape",
           "dtype_name", "CACHE_VERSION", "KernelKey", "KNOBS", "OPS", "ENV"]
