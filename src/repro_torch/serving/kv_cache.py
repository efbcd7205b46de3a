"""KVCache — ONE allocation surface over the engine's device KV state.

The device tensors are defined by ``repro_torch.models.model``
(``init_cache`` for the dense per-slot layout, ``init_paged_cache`` for the
pools + block tables + lengths).  This module is the *host-side owner* of
that state: the ``KVCache`` interface (begin / reserve / advance / free /
evict / rollback / flush + occupancy stats) with two backends behind one
surface:

``DenseKVCache``
    the per-slot ``(B, max_len, ...)`` buffers.  Allocation is trivial (a
    slot always owns its max_len rows): ``reserve`` grants everything,
    begin/free zero the slot's length, the device ``length`` is
    authoritative, and there is no prefix index.

``PagedKVCache``
    fixed ``page_size``-token KV pages in a global ``pool_pages`` pool,
    a per-slot block table mapping logical block -> physical page, page
    refcounts, and a radix-trie *prefix index*: when a request is freed its
    prompt's full pages are inserted into the trie keyed by their token
    content, and a later ``begin`` whose prompt shares that prefix
    *references the same pages* instead of recomputing them (only FULL
    pages are shared, so a running slot never writes a shared page).  Pages
    are reclaimed refcount-0-first from the free list, then by LRU eviction
    of unreferenced index leaves; when even eviction cannot produce a page
    the engine preempts a slot (cache-preserving: its prompt pages stay in
    the index, so the resume re-matches them).

Which backend a spec gets is the ``ServeSpec.kv`` knob.  The device state
is updated in place: ``begin``/``free`` write the slot's ``length`` entry,
the paged ``flush`` copies the host block tables to the device only when
they changed.  On a mesh both backends hold this rank's heads; the dense
buffers also only this rank's batch rows, while ``length`` covers every
slot on every rank.  ``rollback`` drops a slot's rejected speculative
tail.  The dense backend also holds the recurrent families' state (RWKV6's
and the RG-LRU's in f32 whatever the serving dtype, the local attention's
ring); the legacy blocking path fills one slot of it from a batch-1
prefill cache with ``insert_slot`` (on a mesh, on the rank that holds the
slot's row).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.partitioner import NULL_PLAN, ShardingPlan
from repro_torch.core.resolve import KVConfig
from repro_torch.models.model import init_cache, init_paged_cache


@dataclasses.dataclass
class KVStats:
    """Cache-efficiency counters (surfaced in ``ServeMetrics``)."""
    n_prefix_hits: int = 0        # begins that reused >= 1 shared page
    prefix_hit_tokens: int = 0    # prompt tokens served from shared pages
    n_evictions: int = 0          # index pages evicted to satisfy a reserve


class KVCache:
    """The allocation interface the engine drives (one per Engine).

    ``cache`` is the live device dict the unified step consumes (and
    updates in place).  All other methods are host-side bookkeeping:

      begin(slot, tokens) -> int   claim the slot for a request; returns
                                   how many leading prompt tokens are
                                   already cached (prefix reuse)
      reserve(slot, n) -> int      guarantee capacity for the slot's next
                                   n tokens; returns how many fit
      advance(q_lens)              the step landed: lengths += q_lens
      rollback(slot, n) -> int     drop the slot's last n tokens (a
                                   rejected speculative tail); returns
                                   the pages freed
      free(slot, keep_prefix=...)  release the slot's pages; with
                                   keep_prefix the prompt's full pages
                                   enter the prefix index
      flush()                      push dirty host block tables to device
      occupancy() -> float         fraction of KV capacity in use
      kv_bytes() -> int            device bytes held by this rank's KV
                                   buffers (its heads' pools on a mesh)
    """

    backend = "none"
    cache: dict
    stats: KVStats
    pool_tokens: Optional[int] = None     # paged: hard pool capacity

    def begin(self, slot: int, tokens) -> int:
        raise NotImplementedError

    def reserve(self, slot: int, n: int) -> int:
        raise NotImplementedError

    def advance(self, q_lens) -> None:
        raise NotImplementedError

    def rollback(self, slot: int, n: int) -> int:
        raise NotImplementedError

    def free(self, slot: int, keep_prefix: bool = True) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        raise NotImplementedError

    def occupancy(self) -> float:
        raise NotImplementedError

    def kv_bytes(self) -> int:
        """Concrete device bytes of the KV buffers (and recurrent state)."""
        return int(sum(t.numel() * t.element_size()
                       for t in _leaves(self.cache["groups"])))


def _leaves(tree) -> list:
    """The tensors of a cache's nested dicts and lists, in order."""
    if torch.is_tensor(tree):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [t for sub in items for t in _leaves(sub)]


class DenseKVCache(KVCache):
    """Per-slot dense buffers: allocation is the slot itself."""

    backend = "dense"

    def __init__(self, cfg: ModelConfig, batch: int, max_len: int,
                 dtype=torch.bfloat16, device="cuda",
                 plan: ShardingPlan = NULL_PLAN):
        self.batch, self.max_len = batch, max_len
        self.cache = make_batched_cache(cfg, batch, max_len, dtype, device,
                                        plan)
        self.stats = KVStats()

    def begin(self, slot: int, tokens) -> int:
        self.cache["length"][slot] = 0
        return 0

    def reserve(self, slot: int, n: int) -> int:
        return n                      # a slot always owns its max_len rows

    def advance(self, q_lens) -> None:
        pass                          # the device length is authoritative

    def rollback(self, slot: int, n: int) -> int:
        # the verify step already subtracted the rejected tail from the
        # device length; the stale rows past it are inert ragged-tail rows
        return 0

    def free(self, slot: int, keep_prefix: bool = True) -> None:
        self.cache["length"][slot] = 0

    def flush(self) -> None:
        pass

    def occupancy(self) -> float:
        lens = self.cache["length"].cpu().numpy()
        return float(lens.sum()) / float(self.batch * self.max_len)


class _Node:
    """Radix-trie node: one full KV page keyed by its page of token ids."""
    __slots__ = ("key", "page", "parent", "children", "tick")

    def __init__(self, key: bytes, page: int, parent: "_Node", tick: int):
        self.key, self.page, self.parent = key, page, parent
        self.children: dict[bytes, _Node] = {}
        self.tick = tick


class PagedKVCache(KVCache):
    """Global page pool + per-slot block tables + radix prefix index."""

    backend = "paged"

    def __init__(self, cfg: ModelConfig, batch: int, max_len: int, *,
                 page_size: int, pool_pages: int, prefix_cache: bool = True,
                 dtype=torch.bfloat16, device="cuda",
                 plan: ShardingPlan = NULL_PLAN):
        if max_len % page_size:
            raise ValueError(f"page_size {page_size} must divide "
                             f"max_len {max_len}")
        self.batch, self.max_len = batch, max_len
        self.ps, self.n_pages = page_size, pool_pages
        self.nb = max_len // page_size
        self.prefix_cache = prefix_cache
        self.pool_tokens = pool_pages * page_size
        self.cache = init_paged_cache(cfg, batch, max_len,
                                      page_size=page_size,
                                      pool_pages=pool_pages, dtype=dtype,
                                      device=device, plan=plan)
        self.stats = KVStats()
        # allocator state (host): pop() hands out pages 0, 1, 2, ...
        self._free: list[int] = list(range(pool_pages - 1, -1, -1))
        self.ref = np.zeros(pool_pages, np.int32)
        self.bt = np.full((batch, self.nb), -1, np.int32)
        self.n_blocks = np.zeros(batch, np.int32)
        self.lengths = np.zeros(batch, np.int64)
        self._tokens: list[Optional[np.ndarray]] = [None] * batch
        self._root = _Node(b"", -1, None, 0)   # type: ignore[arg-type]
        self._node_of_page: dict[int, _Node] = {}
        self._tick = 0
        self._dirty = True

    # -- prefix index ------------------------------------------------------

    def _match(self, tokens: np.ndarray) -> list[int]:
        """Pages of the longest indexed FULL-page prefix of ``tokens[:-1]``
        (the last prompt token is never served from cache — its logits
        must be computed to sample the first output token)."""
        pages, node = [], self._root
        for i in range((len(tokens) - 1) // self.ps):
            child = node.children.get(tokens[i * self.ps:
                                             (i + 1) * self.ps].tobytes())
            if child is None:
                break
            self._tick += 1
            child.tick = self._tick
            pages.append(child.page)
            node = child
        return pages

    def _insert(self, tokens: np.ndarray, pages: list[int]) -> None:
        """Index ``pages`` (full pages of a freed request's prompt) under
        their token content.  A chain already indexed dedupes: the freed
        duplicate page simply drops to refcount 0 and returns to the pool."""
        node = self._root
        for i, page in enumerate(pages):
            key = tokens[i * self.ps:(i + 1) * self.ps].tobytes()
            child = node.children.get(key)
            if child is None:
                if page in self._node_of_page:    # defensive: never re-home
                    break
                self._tick += 1
                child = _Node(key, page, node, self._tick)
                node.children[key] = child
                self._node_of_page[page] = child
            node = child

    def evict(self) -> Optional[int]:
        """Drop the least-recently-used unreferenced index LEAF and return
        its page (None if every index page is referenced or interior)."""
        best = None
        for page, node in self._node_of_page.items():
            if self.ref[page] != 0 or node.children:
                continue
            k = (node.tick, page)
            if best is None or k < best[0]:
                best = (k, page, node)
        if best is None:
            return None
        _, page, node = best
        node.parent.children.pop(node.key, None)
        del self._node_of_page[page]
        self.stats.n_evictions += 1
        return page

    def _alloc_page(self) -> Optional[int]:
        if self._free:
            return self._free.pop()
        return self.evict()

    # -- the KVCache interface --------------------------------------------

    def begin(self, slot: int, tokens) -> int:
        if self.n_blocks[slot] or self._tokens[slot] is not None:
            self.free(slot)           # defensive: a begin implies a free
        toks = np.asarray(tokens, np.int32)
        pages = self._match(toks) if self.prefix_cache else []
        k = len(pages)
        if k:
            self.stats.n_prefix_hits += 1
            self.stats.prefix_hit_tokens += k * self.ps
            for p in pages:
                self.ref[p] += 1
            self.bt[slot, :k] = pages
        self.n_blocks[slot] = k
        self.lengths[slot] = k * self.ps
        self._tokens[slot] = toks
        self._dirty = True
        self.cache["length"][slot] = k * self.ps
        return k * self.ps

    def reserve(self, slot: int, n: int) -> int:
        if n <= 0:
            return 0
        start = int(self.lengths[slot])
        need = -(-(start + n) // self.ps)          # blocks incl. existing
        while self.n_blocks[slot] < need:
            p = self._alloc_page()
            if p is None:
                break
            self.bt[slot, self.n_blocks[slot]] = p
            self.ref[p] = 1
            self.n_blocks[slot] += 1
            self._dirty = True
        cap = int(self.n_blocks[slot]) * self.ps - start
        return max(0, min(n, cap))

    def advance(self, q_lens) -> None:
        self.lengths += np.asarray(q_lens, np.int64)

    def rollback(self, slot: int, n: int) -> int:
        """Shrink the slot by its rejected speculative tail: drop the last
        ``n`` tokens and return the pages past ``ceil(new_len / page)``
        to the pool.  Shared prefix pages sit at the front of the block
        table and a draft tail starts past the prompt, so the released
        blocks are the slot's own newest pages; an indexed or still
        referenced page never reaches the free list (as in ``free``)."""
        if n <= 0:
            return 0
        new_len = max(0, int(self.lengths[slot]) - int(n))
        keep = -(-new_len // self.ps)            # a partial page stays
        freed = 0
        for b in range(keep, int(self.n_blocks[slot])):
            p = int(self.bt[slot, b])
            if p < 0:
                continue
            self.ref[p] -= 1
            if self.ref[p] == 0 and p not in self._node_of_page:
                self._free.append(p)
                freed += 1
            self.bt[slot, b] = -1
        self.n_blocks[slot] = keep
        self.lengths[slot] = new_len
        self._dirty = True
        return freed

    def free(self, slot: int, keep_prefix: bool = True) -> None:
        n = int(self.n_blocks[slot])
        pages = [int(p) for p in self.bt[slot, :n]]
        for p in pages:
            self.ref[p] -= 1
        toks = self._tokens[slot]
        if (keep_prefix and self.prefix_cache and toks is not None
                and len(toks) > 1):
            done = min(int(self.lengths[slot]), len(toks))
            self._insert(toks, pages[:done // self.ps])
        for p in pages:      # unreferenced, un-indexed pages -> free list
            if self.ref[p] == 0 and p not in self._node_of_page:
                self._free.append(p)
        self.bt[slot, :] = -1
        self.n_blocks[slot] = 0
        self.lengths[slot] = 0
        self._tokens[slot] = None
        self._dirty = True
        self.cache["length"][slot] = 0

    def flush(self) -> None:
        if self._dirty:
            self.cache["block_tables"].copy_(torch.from_numpy(self.bt))
            self._dirty = False

    def occupancy(self) -> float:
        return (self.n_pages - len(self._free)) / max(self.n_pages, 1)


def make_kv_cache(cfg: ModelConfig, kv: Optional[KVConfig], batch: int,
                  max_len: int, dtype=torch.bfloat16, device="cuda",
                  plan: ShardingPlan = NULL_PLAN) -> KVCache:
    """Construct the backend a resolved ``ServeSpec.kv`` asks for; on a
    mesh ``plan`` cuts the pools to this rank's heads, the dense buffers
    to its rows and heads."""
    if kv is None or kv.backend == "dense":
        return DenseKVCache(cfg, batch, max_len, dtype, device, plan)
    ps = kv.page_size           # resolver-matching fallback: halve until
    while ps > 1 and max_len % ps:     # the page divides max_len
        ps //= 2
    pool = kv.pool_pages or batch * (max_len // ps)
    return PagedKVCache(cfg, batch, max_len, page_size=ps,
                        pool_pages=pool, prefix_cache=kv.prefix_cache,
                        dtype=dtype, device=device, plan=plan)


def insert_slot(big, small, slot: int, plan: ShardingPlan = NULL_PLAN):
    """Copy a batch-1 cache ``small`` into batch slot ``slot`` of ``big``
    IN PLACE (cast to ``big``'s dtypes); returns ``big``.  Every buffer is
    (layers, batch, ...), the ring positions ``kpos`` (layers, batch, W)
    included, so the slot is axis 1; ``length`` is (batch,).  On a mesh
    ``big`` holds this rank's rows: only the rank whose rows hold the slot
    copies (at its local row); every rank sets the slot's length."""
    big["length"][slot] = small["length"].reshape(-1)[0]
    rows = plan.rows(big["length"].shape[0])
    if not rows.start <= slot < rows.stop:
        return big
    i = slot - rows.start
    for b, s in zip(_leaves(big["groups"]), _leaves(small["groups"])):
        b[:, i:i + 1].copy_(s)
    return big


def batched_lengths(cache) -> torch.Tensor:
    return cache["length"]


def with_lengths(cache, lengths):
    return {**cache, "length": lengths}


def make_batched_cache(cfg: ModelConfig, batch: int, max_len: int,
                       dtype=torch.bfloat16, device="cuda",
                       plan: ShardingPlan = NULL_PLAN):
    """A dense batch cache whose ``length`` is a per-slot vector (all
    zero) of every slot; on a mesh the buffers are this rank's block
    (``init_cache``)."""
    c = init_cache(cfg, batch, max_len, dtype, device, plan)
    return with_lengths(c, torch.zeros(batch, dtype=torch.int32,
                                       device=device))


__all__ = ["KVCache", "KVStats", "DenseKVCache", "PagedKVCache",
           "make_kv_cache", "init_cache", "init_paged_cache", "insert_slot",
           "batched_lengths", "with_lengths", "make_batched_cache"]
