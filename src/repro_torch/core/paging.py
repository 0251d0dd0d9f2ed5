"""Paged KV residency: a page pool under the cache registry.

Counterpart of :mod:`repro.core.paging`.  Under contiguous ring slots every
request owns ``max_len`` positions of device memory even when many
requests share a system prompt; here the slot → storage identity is broken
and residency is decided by a page pool.

* :class:`PagedCacheFormat` — a registered cache format that lifts an inner
  format (``bf16``, ``int8``, ``int4_bp``, ``int4_bp_fused``) from ``[B, L,
  ...]`` ring slots onto pages: each payload and scale tensor becomes
  ``[num_pages, page_size, ...]`` (the inner format's per-slot scales are
  per-page rows) beside a ``[B, pages_per_slot]`` int32 **block table** a
  channel (``k_pages``, ``v_pages``, ``c_kv_pages``).  ``append`` writes
  each kept token **in place** at ``(table[b, ring // page], ring %
  page)``; the reads gather the pages back to the contiguous ``[B, L, ...]``
  layout (``store[table.long()]``, the table indexed as int64) and hand
  them to the inner format, so they read the same bits as the ring cache
  wherever the pages hold the same contents — the fused read included: a
  CUDA tensor reaches ``plane_decode_attention``'s kernel.
* :class:`PagePool` — the host-side allocator: refcounts, a LIFO free list,
  and the COW / eviction / prefix-hit telemetry (``pages.*`` counters and
  gauges while an observability sink is registered).
* :class:`RadixPrefixIndex` — a radix tree over page-sized token chunks
  mapping a prompt's page-aligned prefix to physical pages; the serving
  engine attaches later requests to them (refcounted, copy-on-write before
  a write into a shared page).

The port writes in place, so two live block-table entries must never name
a page that is being written: a write into a shared page would change
another slot's keys with nothing to catch it.  Keeping that true is the
engine's copy-on-write (``ServeEngine._cow_writes``).

Registered names are ``paged_<inner>`` (``page_size`` 8).  ``abstract_state``
(inherited: :meth:`init` on the meta device) is the page-rounded pool with
its per-page scales and the int32 block table, the dry run's count of what
a default pool allocates.  ``data_axes`` / ``flat_cache_axes`` give the
pool's leading page axis the ``kv_seq`` rule and the block table the
``batch`` rule, as the reference's do.

Over the serving engine's data axis every rank holds the whole pool and
its slots' rows of the tables; under ``kv_seq`` rules (a
sequence-parallel decode) a rank holds the contiguous block ``[r·P/w,
(r+1)·P/w)`` of the pool's pages and the whole tables, and attends over
the ring slots whose pages it holds (:mod:`repro_torch.models.attention`
maps the tables to its own pages before :meth:`append` and the reads).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import kvcache
from repro_torch.obs import trace as obs

#: flat-cache keys that live in the page pool under a paged format
#: (payloads and per-page scales; leading dims [num_pages, page_size])
POOL_KEYS = frozenset({"k", "v", "c_kv", "k_scale", "v_scale", "c_scale"})
#: flat-cache keys holding [B, pages_per_slot] int32 block tables
TABLE_KEYS = frozenset({"k_pages", "v_pages", "c_kv_pages"})


class PoolExhausted(RuntimeError):
    """The page pool cannot satisfy an allocation even after eviction."""


class PagedCacheFormat(kvcache.CacheFormat):
    """Lift an inner :class:`~repro_torch.core.kvcache.CacheFormat` onto pages.

    Storage a channel (``suffixes = inner.suffixes + ("_pages",)``):

    ``""``/``"_scale"``  ``inner.init(num_pages, page_size, lead, feat)``:
                         one pool row is one page.
    ``"_pages"``         the ``[B, pages_per_slot]`` int32 block table;
                         entry ``j`` is the pool row behind ring slots
                         ``[j·page, (j+1)·page)``.  ``init`` starts it as
                         the identity (slot ``b`` owns rows ``b·npp ...``),
                         so a cache on its own behaves as a ring; the
                         serving engine rewrites the tables.

    The ring length is rounded up to whole pages (:meth:`slot_capacity`),
    so ring semantics (slot = position mod L) carry over unchanged.
    """

    #: tokens a page
    page_size: int = 8

    def __init__(self, inner: kvcache.CacheFormat, page_size: Optional[int] = None,
                 name: Optional[str] = None):
        if page_size is not None:
            self.page_size = int(page_size)
        if self.page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.inner = inner
        self.name = name or f"paged_{inner.name}"
        self.suffixes = tuple(inner.suffixes) + ("_pages",)
        self.supports_fused_decode = inner.supports_fused_decode

    # -- page geometry ---------------------------------------------------
    def pages_per_slot(self, cache_len: int) -> int:
        return -(-int(cache_len) // self.page_size)

    def slot_capacity(self, cache_len: int) -> int:
        """Ring length rounded up to a whole number of pages."""
        return self.pages_per_slot(cache_len) * self.page_size

    # -- storage ---------------------------------------------------------
    def init(self, batch, cache_len, lead, feat, dtype=torch.bfloat16, device=None):
        npp = self.pages_per_slot(cache_len)
        store = self.inner.init(batch * npp, self.page_size, lead, feat, dtype=dtype,
                                device=device)
        store["_pages"] = torch.arange(batch * npp, dtype=torch.int32,
                                       device=store[""].device).reshape(batch, npp)
        return store

    def append(self, store, x, b_idx, s_idx, ring, keep=None) -> None:
        """In place: each token ``x[b_idx, s_idx]`` at ring slot ``ring`` of
        row ``b_idx`` goes to page ``table[b_idx, ring // page]`` at offset
        ``ring % page``.  The pairs are unique as long as no two rows' live
        table entries share a page being written (the engine's copy-on-write
        sees to it).  With ``keep`` (a sequence-parallel rank's tokens: those
        whose page it holds, the table mapped to its own pages) every token
        is encoded and only the kept ones are written."""
        phys = store["_pages"][b_idx, ring // self.page_size].long()
        offset = ring % self.page_size
        if keep is not None:
            phys, offset = phys[keep], offset[keep]
        for sfx, enc in self.inner._encode(x[b_idx, s_idx]).items():
            store[sfx][phys, offset] = (enc if keep is None else enc[keep]).to(store[sfx].dtype)

    def _gather(self, store) -> dict:
        """The block-table gather back to the contiguous ``[B, L, ...]``
        layout the inner format reads: identical page contents, identical
        bits."""
        table = store["_pages"]
        b, npp = table.shape
        idx = table.long()
        return {sfx: store[sfx][idx].reshape(b, npp * self.page_size, *store[sfx].shape[2:])
                for sfx in self.inner.suffixes}

    # -- reads: gather, then the inner format ----------------------------
    def qk(self, q, store):
        return self.inner.qk(q, self._gather(store))

    def av(self, w, store, feat):
        return self.inner.av(w, self._gather(store), feat)

    def decode_attention(self, q, k_store, v_store, bias, *, sm_scale, feat, impl=None,
                         stats: bool = False):
        return self.inner.decode_attention(q, self._gather(k_store), self._gather(v_store),
                                           bias, sm_scale=sm_scale, feat=feat, impl=impl,
                                           stats=stats)

    # -- sharding --------------------------------------------------------
    def data_axes(self, lead_axes):
        axes = dict(self.inner.data_axes(lead_axes))
        axes["_pages"] = ()
        return axes

    def flat_cache_axes(self, prefix, lead_axes):
        """Pool leaves are ``(pages → the kv_seq rule, in-page offset
        unsharded)`` + the inner format's axes (the lead axes shard as
        unpaged); the block table follows the batch axis."""
        data_key, _ = kvcache.CHANNEL_KEYS[prefix]
        keys = self._keys(prefix)
        out = {keys[sfx]: ("kv_seq", None) + tuple(ax)
               for sfx, ax in self.inner.data_axes(lead_axes).items()}
        out[data_key + "_pages"] = ("batch", None)
        return out

    # -- flat-cache plumbing ---------------------------------------------
    def _keys(self, prefix):
        data_key, scale_key = kvcache.CHANNEL_KEYS[prefix]
        return {"": data_key, "_scale": scale_key, "_pages": data_key + "_pages"}

    def channel(self, cache, prefix):
        keys = self._keys(prefix)
        return {sfx: cache[keys[sfx]] for sfx in self.suffixes}

    def channel_entries(self, prefix, store):
        keys = self._keys(prefix)
        return {keys[sfx]: t for sfx, t in store.items()}


class PagePool:
    """Refcounted allocator over a fixed pool of physical pages.

    Pure host-side bookkeeping (the device pool tensors are allocated once
    and never resize): ``alloc``/``retain``/``release`` move pages between the
    LIFO free list and refcounted use.  A page's refcount is the number of
    holders — one per block-table entry referencing it plus one when the
    radix prefix index retains it — so ``refs > 1`` means *shared* and a
    write into it must copy first (COW).  Telemetry is *lifetime*-scoped —
    ``total_allocated``/``total_freed`` monotone counters plus the
    ``peak_in_use`` high-water mark — so pool pressure between two
    ``stats()`` calls is visible, not just the instantaneous snapshot; COW
    copies, evictions and prefix hits are owned here too (the ``note_*``
    methods), feeding ``ServeEngine.stats()``, the scheduler's
    :class:`~repro_torch.serve.scheduler.EngineView`, and the :mod:`repro.obs`
    counter registry (``pages.alloc``/``pages.free``/``pages.cow``/
    ``pages.evict`` counters, ``pages.occupancy``/``pages.high_water``
    gauges) in one place.
    """

    def __init__(self, num_pages: int, page_size: int):
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.refs = np.zeros(self.num_pages, np.int32)
        # LIFO stack ordered so pop() hands out low page ids first
        self._free = list(range(self.num_pages - 1, -1, -1))
        self.cow_copies = 0
        self.evictions = 0
        self.prefix_hits = 0
        self.prefix_tokens_saved = 0
        self.peak_in_use = 0
        self.total_allocated = 0
        self.total_freed = 0

    def _note_occupancy(self) -> None:
        if obs.active():
            obs.gauge("pages.occupancy", self.pages_in_use)
            obs.gauge("pages.high_water", self.peak_in_use)

    # -- occupancy -------------------------------------------------------
    def free_count(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    def shared_pages(self) -> int:
        return int((self.refs > 1).sum())

    def shared_fraction(self) -> float:
        return self.shared_pages() / max(self.pages_in_use, 1)

    # -- lifecycle -------------------------------------------------------
    def alloc(self, n: int) -> np.ndarray:
        """Take ``n`` free pages (refcount 1 each); raises
        :class:`PoolExhausted` when the free list is short — the caller
        (engine) evicts prefix-index entries and retries."""
        if len(self._free) < n:
            raise PoolExhausted(
                f"page pool exhausted: need {n} pages, "
                f"{len(self._free)} free of {self.num_pages}"
            )
        pages = np.array([self._free.pop() for _ in range(n)], np.int64)
        self.refs[pages] = 1
        self.total_allocated += n
        self.peak_in_use = max(self.peak_in_use, self.pages_in_use)
        if obs.active():
            obs.counter("pages.alloc", n)
            self._note_occupancy()
        return pages

    def retain(self, pages) -> None:
        """Add one reference per page (sharing / index registration)."""
        for p in np.atleast_1d(np.asarray(pages, np.int64)):
            if self.refs[p] <= 0:
                raise ValueError(f"retain of free page {int(p)}")
            self.refs[p] += 1

    def release(self, pages) -> list[int]:
        """Drop one reference per page; returns the pages that became free."""
        freed = []
        for p in np.atleast_1d(np.asarray(pages, np.int64)):
            if self.refs[p] <= 0:
                raise ValueError(f"release of free page {int(p)}")
            self.refs[p] -= 1
            if self.refs[p] == 0:
                self._free.append(int(p))
                freed.append(int(p))
        if freed:
            self.total_freed += len(freed)
            if obs.active():
                obs.counter("pages.free", len(freed))
                self._note_occupancy()
        return freed

    # -- telemetry -------------------------------------------------------
    def note_cow(self, n: int = 1) -> None:
        """Record ``n`` copy-on-write page copies (engine calls this at the
        divergent-write site, so the counter lives with the pool)."""
        self.cow_copies += n
        if obs.active():
            obs.counter("pages.cow", n)

    def note_eviction(self, n: int = 1) -> None:
        """Record ``n`` prefix-index evictions forced by pool pressure."""
        self.evictions += n
        if obs.active():
            obs.counter("pages.evict", n)

    def note_prefix_hit(self, tokens_saved: int) -> None:
        """Record one prefix-cache attach that skipped ``tokens_saved``
        prefill positions."""
        self.prefix_hits += 1
        self.prefix_tokens_saved += int(tokens_saved)
        if obs.active():
            obs.counter("pages.prefix_hit")
            obs.counter("pages.prefix_tokens_saved", int(tokens_saved))

    def stats(self) -> dict:
        return {
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "pages_in_use": self.pages_in_use,
            "pages_free": self.free_count(),
            "peak_in_use": self.peak_in_use,
            "total_allocated": self.total_allocated,
            "total_freed": self.total_freed,
            "shared_pages": self.shared_pages(),
            "shared_fraction": self.shared_fraction(),
            "cow_copies": self.cow_copies,
            "evictions": self.evictions,
            "prefix_hits": self.prefix_hits,
            "prefix_tokens_saved": self.prefix_tokens_saved,
        }


# ---------------------------------------------------------------------------
# RadixPrefixIndex — page-granular prompt-prefix → physical pages
# ---------------------------------------------------------------------------


class _Node:
    __slots__ = ("children", "page", "stamp")

    def __init__(self, page: int, stamp: int):
        self.children: dict = {}
        self.page = page
        self.stamp = stamp


class RadixPrefixIndex:
    """Radix tree keyed by page-sized token chunks.

    Each node pins ONE physical page (the pool row holding that chunk's
    K/V across every layer — pool rows index all layer pools identically,
    so one page id is a whole-model page bundle).  ``match`` walks the
    longest registered prefix and LRU-touches it; ``insert`` registers a
    served prompt's pages, returning only the NEWLY referenced ones so the
    caller can bump exactly those refcounts; ``evict_lru`` removes the
    least-recently-matched leaf (leaf-first keeps interior chains
    reachable).
    """

    def __init__(self, page_size: int):
        self.page_size = int(page_size)
        self.root: dict = {}
        self.size = 0
        self._stamp = 0

    def _chunks(self, tokens) -> list[tuple]:
        toks = tuple(int(t) for t in np.asarray(tokens).ravel())
        n = len(toks) // self.page_size
        return [toks[i * self.page_size:(i + 1) * self.page_size]
                for i in range(n)]

    def match(self, tokens) -> np.ndarray:
        """Physical pages of the longest registered page-aligned prefix."""
        self._stamp += 1
        pages, level = [], self.root
        for chunk in self._chunks(tokens):
            node = level.get(chunk)
            if node is None:
                break
            node.stamp = self._stamp
            pages.append(node.page)
            level = node.children
        return np.asarray(pages, np.int64)

    def insert(self, tokens, page_ids) -> list[int]:
        """Register ``tokens``' page-aligned prefix backed by ``page_ids``;
        returns the page ids newly referenced (existing chain nodes keep
        their original pages — first writer wins)."""
        self._stamp += 1
        new, level = [], self.root
        for chunk, page in zip(self._chunks(tokens), np.asarray(page_ids)):
            node = level.get(chunk)
            if node is None:
                node = _Node(int(page), self._stamp)
                level[chunk] = node
                new.append(int(page))
                self.size += 1
            else:
                node.stamp = self._stamp
            level = node.children
        return new

    def evict_lru(self, evictable=None) -> Optional[int]:
        """Drop the least-recently-matched leaf; returns its page id (the
        caller releases the index's reference), or None when no leaf
        qualifies.  ``evictable(page_id)`` filters candidates — the engine
        passes ``refs == 1`` so eviction only ever touches pages whose sole
        holder is the index (evicting a page a live slot still maps would
        burn an index entry without freeing a single byte)."""
        best = None  # (stamp, parent level, key, node)

        def walk(level):
            nonlocal best
            for key, node in level.items():
                if node.children:
                    walk(node.children)
                elif (evictable is None or evictable(node.page)) and (
                        best is None or node.stamp < best[0]):
                    best = (node.stamp, level, key, node)

        walk(self.root)
        if best is None:
            return None
        _, level, key, node = best
        del level[key]
        self.size -= 1
        return node.page


#: inner formats lifted onto pages at import (registry names ``paged_<inner>``)
PAGED_BASES = ("bf16", "int8", "int4_bp", "int4_bp_fused")

for _base in PAGED_BASES:
    kvcache.register_cache_format(PagedCacheFormat(kvcache.get_cache_format(_base)))
