"""Copy of ``repro.serving.kvpool`` (numpy only), kept in the port so that it
imports nothing of the JAX package.

Paged KV-cache pool: a refcounted block allocator over a global page pool.

Dense decode caches reserve ``(slots, H_kv, S_max, d)`` for the *worst-case*
context of every slot — the memory wall that blocks long-context serving.
This module replaces that with the standard paged layout: one global pool of
fixed-size pages

    k_pool, v_pool : (num_pages, H_kv, page_size, d)

plus a small per-sequence *page table* mapping logical KV tile ``t`` of a
sequence to a physical page id. A LeanAttention tile is already a fixed-size
KV chunk, so tiles map 1:1 onto pages (``tile_size == page_size``) and the
stream-K descriptor stream just gains a page-table indirection (see
:mod:`repro.kernels.lean_decode`).

This module is the *host-side* allocator: it owns the free list, the
per-sequence page lists, the per-page **reference counts**, and the
accounting invariants

    live (refcount > 0) + free == usable pages     (no leaks)
    refcount(p) == number of holders of p          (no phantom shares)
    a sequence never holds the same page twice     (no self-aliasing)

Pages are refcounted so that *prefix sharing* works on top of the same
allocator: ``alloc`` hands out fresh pages at refcount 1, ``share`` lets a
second holder (another sequence, or the radix prefix cache —
:mod:`repro.serving.prefix_cache`) reference the same physical page, and a
page returns to the free list only when its last holder releases it.
Holders that share a page MUST treat it as immutable (copy-on-write before
any in-place mutation — the engine owns that policy).

The device-side pool arrays live in the engine's cache pytree; freeing here
never touches device memory — pages are recycled by being overwritten on the
next admit (copy-on-admit hook).

Page id 0 is reserved as the **null page**: page tables are padded with 0,
idle slots write their garbage token there, and reads from it are always
masked by the runtime context length. The allocator therefore hands out ids
``1 .. num_pages-1``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Hashable, Iterable, List, Optional, Sequence

import numpy as np

__all__ = ["KVLayout", "KVPagePool", "PoolStats", "NULL_PAGE"]

NULL_PAGE = 0

# bytes per stored KV element, by layout dtype tag
KV_ELEM_BYTES = {"f32": 4, "bf16": 2, "f16": 2, "f8": 1, "int8": 1}


@dataclass(frozen=True)
class KVLayout:
    """Dtype-aware description of what one physical page holds.

    The pool itself is a host-side allocator and never touches bytes; this
    descriptor is the single source of truth for *how big* a page is, so
    every consumer (engine telemetry, prefix-cache byte accounting, bench
    capacity math) derives the same number instead of re-hardcoding
    ``2 * layers * Hkv * page * d * elem_bytes`` with a stale dtype.

    ``kv_dtype='int8'`` marks a quantized layout: pages store symmetric
    int8 values and fp32 scales ride alongside (one per (page, kv-head)
    at ``scale_granularity='page_head'``, one per page — stored broadcast
    across head rows so the kernel-side layout is identical — at
    ``'page'``). Scale bytes are part of ``page_bytes``: they are real
    pool footprint.
    """

    kv_dtype: str = "bf16"                # 'f32'|'bf16'|'f16'|'f8'|'int8'
    n_kv_heads: int = 1
    head_dim: int = 1
    page_size: int = 1
    n_attn_layers: int = 1
    scale_granularity: str = "page_head"  # 'page_head' | 'page'

    def __post_init__(self):
        if self.kv_dtype not in KV_ELEM_BYTES:
            raise ValueError(
                f"unknown kv_dtype {self.kv_dtype!r} "
                f"(expected one of {sorted(KV_ELEM_BYTES)})"
            )
        if self.scale_granularity not in ("page_head", "page"):
            raise ValueError(
                f"unknown scale_granularity {self.scale_granularity!r}"
            )

    @property
    def quantized(self) -> bool:
        return self.kv_dtype == "int8"

    @property
    def elem_bytes(self) -> int:
        return KV_ELEM_BYTES[self.kv_dtype]

    @property
    def scale_bytes_per_page(self) -> int:
        """fp32 scale bytes riding with one page across k+v and all attn
        layers (0 for unquantized layouts)."""
        if not self.quantized:
            return 0
        per_layer = self.n_kv_heads if self.scale_granularity == "page_head" else 1
        return 2 * 4 * per_layer * self.n_attn_layers

    @property
    def page_bytes(self) -> int:
        """Total bytes one page id pins across the whole layer stack
        (k + v payload plus any scale sidecar)."""
        payload = (
            2 * self.n_attn_layers * self.n_kv_heads
            * self.page_size * self.head_dim * self.elem_bytes
        )
        return payload + self.scale_bytes_per_page

    def as_dict(self) -> dict:
        return {
            "kv_dtype": self.kv_dtype,
            "scale_granularity": self.scale_granularity,
            "elem_bytes": self.elem_bytes,
            "page_bytes": self.page_bytes,
            "quantized": self.quantized,
        }


@dataclass
class PoolStats:
    """Cumulative allocator statistics (host-side, cheap to keep exact)."""

    alloc_calls: int = 0
    pages_allocated: int = 0      # cumulative fresh allocations
    free_calls: int = 0
    pages_freed: int = 0          # cumulative returns to the free list
    failed_allocs: int = 0
    high_water: int = 0           # max pages simultaneously live
    evictions: int = 0            # free_seq calls with eviction=True
    share_calls: int = 0
    pages_shared: int = 0         # cumulative refcount increments via share
    pages_released: int = 0       # cumulative holder releases (any refcount)
    ctx_overflows: int = 0        # ctx-length clamp events (every occurrence)
    repairs: int = 0              # repair() invocations (audit self-healing)

    def as_dict(self) -> dict:
        return {
            "alloc_calls": self.alloc_calls,
            "pages_allocated": self.pages_allocated,
            "free_calls": self.free_calls,
            "pages_freed": self.pages_freed,
            "failed_allocs": self.failed_allocs,
            "high_water": self.high_water,
            "evictions": self.evictions,
            "share_calls": self.share_calls,
            "pages_shared": self.pages_shared,
            "pages_released": self.pages_released,
            "ctx_overflows": self.ctx_overflows,
            "repairs": self.repairs,
        }


class KVPagePool:
    """Refcounted block allocator over ``num_pages`` KV pages.

    Sequences are identified by an arbitrary hashable key (the engine uses
    its slot index; the radix prefix cache uses a reserved key). ``alloc``
    is all-or-nothing; a failed allocation leaves the pool untouched and
    bumps ``stats.failed_allocs`` so callers can apply their
    admission/eviction/preemption policy.

    ``on_admit(seq, pages)`` hooks fire after every successful allocation
    (the engine's device-side copy-on-admit rides on this); ``on_evict(seq,
    pages)`` hooks fire when a sequence releases pages — with the subset of
    those pages that actually returned to the free list (refcount 0).
    """

    def __init__(self, num_pages: int, page_size: int,
                 layout: Optional[KVLayout] = None):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the null page)")
        if page_size <= 0:
            raise ValueError("page_size must be positive")
        if layout is not None and layout.page_size != page_size:
            raise ValueError(
                f"layout.page_size {layout.page_size} != pool page_size "
                f"{page_size}"
            )
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.layout = layout
        # LIFO free list: recently-freed pages are re-used first, which keeps
        # the working set of hot pages small
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self._seq_pages: Dict[Hashable, List[int]] = {}
        self._refcount: Dict[int, int] = {}
        # sequences that already warned about a ctx-overflow clamp — the
        # kernel wrappers warn once per stuck sequence, not once per tick
        self._overflow_warned: set = set()
        self.stats = PoolStats()
        self.on_admit: List[Callable[[Hashable, List[int]], None]] = []
        self.on_evict: List[Callable[[Hashable, List[int]], None]] = []

    # ------------------------------------------------------------ accounting
    @property
    def usable_pages(self) -> int:
        """Pages the allocator may hand out (excludes the null page)."""
        return self.num_pages - 1

    @property
    def page_bytes(self) -> int:
        """Bytes one page pins across the layer stack, from the layout
        descriptor (0 when the pool was built without one — the caller
        opted out of byte accounting)."""
        return self.layout.page_bytes if self.layout is not None else 0

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_allocated(self) -> int:
        """Distinct physical pages live (a shared page counts once)."""
        return self.usable_pages - len(self._free)

    @property
    def live_sequences(self) -> int:
        return len(self._seq_pages)

    @property
    def pages_saved(self) -> int:
        """Σ (refcount - 1) over live pages: physical pages that sharing is
        currently saving vs. an unshared allocator serving the same holders."""
        return sum(rc - 1 for rc in self._refcount.values())

    def holds(self, seq: Hashable) -> bool:
        return seq in self._seq_pages

    def refcount(self, page: int) -> int:
        return self._refcount.get(page, 0)

    def pages_of(self, seq: Hashable) -> List[int]:
        return list(self._seq_pages.get(seq, ()))

    def count(self, seq: Hashable) -> int:
        return len(self._seq_pages.get(seq, ()))

    def token_capacity(self, seq: Hashable) -> int:
        """Tokens the sequence's held pages can hold — the clamp bound
        used by :func:`repro.kernels.ops.lean_decode_paged`."""
        return self.count(seq) * self.page_size

    def note_ctx_overflow(self, seq: Hashable) -> bool:
        """Record one ctx-length clamp event for ``seq``. Every occurrence
        counts in ``stats.ctx_overflows``; the return value is True only
        the *first* time for this sequence — the kernel wrappers use it to
        dedupe the per-tick ``RuntimeWarning`` of a stuck sequence to a
        single warning (the counter keeps the full occurrence tally)."""
        self.stats.ctx_overflows += 1
        if seq in self._overflow_warned:
            return False
        self._overflow_warned.add(seq)
        return True

    # ------------------------------------------------------------- alloc/free
    def alloc(self, seq: Hashable, n: int = 1) -> Optional[List[int]]:
        """Allocate ``n`` fresh pages for ``seq`` at refcount 1.
        All-or-nothing; returns the new page ids, or ``None`` (pool
        unchanged) when fewer than ``n`` are free."""
        self.stats.alloc_calls += 1
        if n < 0:
            raise ValueError("n must be >= 0")
        if n > len(self._free):
            self.stats.failed_allocs += 1
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._seq_pages.setdefault(seq, []).extend(pages)
        for p in pages:
            self._refcount[p] = 1
        self.stats.pages_allocated += n
        self.stats.high_water = max(self.stats.high_water, self.num_allocated)
        for hook in self.on_admit:
            hook(seq, list(pages))
        return pages

    def share(self, seq: Hashable, pages: Sequence[int]) -> None:
        """Register ``seq`` as an additional holder of live ``pages``
        (refcount + 1 each, appended to the sequence's page list in order).

        The pages must be live (held by someone) and not already held by
        ``seq`` — a sequence holding the same physical page at two logical
        tiles would corrupt its own KV. Shared pages are immutable to every
        holder; the engine copy-on-writes before mutating one.
        """
        pages = [int(p) for p in pages]
        held = set(self._seq_pages.get(seq, ()))
        for p in pages:
            if self._refcount.get(p, 0) <= 0:
                raise ValueError(f"cannot share dead/free page {p}")
            if p in held:
                raise ValueError(f"sequence {seq!r} already holds page {p}")
            held.add(p)
        self._seq_pages.setdefault(seq, []).extend(pages)
        for p in pages:
            self._refcount[p] += 1
        self.stats.share_calls += 1
        self.stats.pages_shared += len(pages)

    def _release(self, pages: Iterable[int]) -> List[int]:
        """Drop one reference per page; return the subset that died."""
        dead = []
        for p in pages:
            rc = self._refcount[p] - 1
            self.stats.pages_released += 1
            if rc == 0:
                del self._refcount[p]
                dead.append(p)
            else:
                self._refcount[p] = rc
        # LIFO: most-recently-dead first, mirroring the old free order
        self._free.extend(reversed(dead))
        self.stats.pages_freed += len(dead)
        return dead

    def release_pages(self, seq: Hashable, pages: Sequence[int]) -> List[int]:
        """Release ``seq``'s hold on specific ``pages`` (each freed only if
        this was the last reference). Returns the pages actually freed.
        Raises ``KeyError`` for an unknown seq, ``ValueError`` for a page
        the sequence does not hold."""
        if seq not in self._seq_pages:
            raise KeyError(f"unknown sequence {seq!r}")
        held = self._seq_pages[seq]
        for p in pages:
            try:
                held.remove(int(p))
            except ValueError:
                raise ValueError(
                    f"sequence {seq!r} does not hold page {p}"
                ) from None
        if not held:
            del self._seq_pages[seq]
        dead = self._release(int(p) for p in pages)
        if dead:
            for hook in self.on_evict:
                hook(seq, list(dead))
        return dead

    def free_seq(self, seq: Hashable, *, eviction: bool = False) -> int:
        """Release every page ``seq`` holds; returns the count of pages that
        actually returned to the free list (shared pages survive under
        their remaining holders). Raises ``KeyError`` for a sequence the
        pool does not know — a silent 0-page return here masked double-free
        bugs upstream. ``eviction=True`` tags the release as a preemption
        (vs normal request completion) in the stats."""
        if seq not in self._seq_pages:
            raise KeyError(f"unknown sequence {seq!r}")
        pages = self._seq_pages.pop(seq)
        self._overflow_warned.discard(seq)   # a re-admitted seq warns afresh
        self.stats.free_calls += 1
        if eviction:
            self.stats.evictions += 1
        dead = self._release(pages)
        for hook in self.on_evict:
            hook(seq, list(dead))
        return len(dead)

    # ------------------------------------------------------------ page tables
    def table_row(self, seq: Hashable, width: int) -> np.ndarray:
        """The sequence's page table padded with the null page to ``width``
        (``width`` = pages_per_slot, the engine's static table shape)."""
        pages = self._seq_pages.get(seq, ())
        if len(pages) > width:
            raise ValueError(
                f"sequence holds {len(pages)} pages > table width {width}"
            )
        row = np.full(width, NULL_PAGE, dtype=np.int32)
        row[: len(pages)] = pages
        return row

    def table(self, seqs: Sequence[Hashable], width: int) -> np.ndarray:
        """Stacked page table for a batch of sequence keys: (len(seqs), width)."""
        return np.stack([self.table_row(s, width) for s in seqs])

    # ------------------------------------------------------------- invariants
    def repair(self) -> dict:
        """Rebuild the derived allocator state from the holder lists.

        The per-sequence page lists are the ground truth (they are what
        the engine's page tables were built from); refcounts and the free
        list are derived views that corruption (or a bug) can desynchronize.
        Repair: dedupe each sequence's holdings (a sequence must never
        hold a page twice), drop null/out-of-range entries, recompute
        every refcount from the holder lists, and rebuild the free list
        as exactly the non-held usable pages — which also recovers leaked
        pages (neither held nor free). Returns a summary of what was
        fixed; a consistent pool is a no-op (summary of zeros) and
        ``check()`` passes by construction afterwards.
        """
        fixed = {"dropped_holdings": 0, "refcount_fixes": 0,
                 "leaked_pages": 0, "freelist_fixes": 0}
        for seq in list(self._seq_pages):
            seen: set = set()
            clean: List[int] = []
            for p in self._seq_pages[seq]:
                p = int(p)
                if p in seen or not 1 <= p < self.num_pages:
                    fixed["dropped_holdings"] += 1
                    continue
                seen.add(p)
                clean.append(p)
            if clean:
                self._seq_pages[seq] = clean
            else:
                del self._seq_pages[seq]
        holders: Dict[int, int] = {}
        for pages in self._seq_pages.values():
            for p in pages:
                holders[p] = holders.get(p, 0) + 1
        fixed["refcount_fixes"] = sum(
            1 for p in set(holders) | set(self._refcount)
            if holders.get(p) != self._refcount.get(p)
        )
        self._refcount = holders
        prev_free = set(self._free)
        free = [p for p in range(self.num_pages - 1, 0, -1)
                if p not in holders]
        fixed["leaked_pages"] = sum(
            1 for p in free if p not in prev_free
        )
        fixed["freelist_fixes"] = len(prev_free.symmetric_difference(free))
        self._free = free
        self.stats.repairs += 1
        return fixed

    def check(self, *, scales: Optional[Sequence[np.ndarray]] = None) -> None:
        """Assert the pool accounting invariants (tests / debug ticks).

        ``scales``: optional iterable of fp32 scale arrays whose leading
        axis is the page id (e.g. the engine's per-layer ``(num_pages,
        H_kv)`` k/v scale sidecars, host-fetched). When given, every
        *live* page's scales must be finite and non-negative — a NaN/Inf
        scale would dequantize an entire page to garbage, and a negative
        one can never come out of amax/127 quantization. Free pages are
        exempt (their scales are stale by design until re-admit
        overwrites them)."""
        holders: Dict[int, int] = {}
        for seq, pages in self._seq_pages.items():
            assert pages, f"empty page list left behind for {seq!r}"
            assert len(pages) == len(set(pages)), (
                f"sequence {seq!r} holds a page twice: {pages}"
            )
            for p in pages:
                holders[p] = holders.get(p, 0) + 1
        live = set(holders)
        assert NULL_PAGE not in live, "null page handed out"
        assert NULL_PAGE not in self._free, "null page on the free list"
        assert holders == self._refcount, (
            f"refcounts out of sync: holders={holders} rc={self._refcount}"
        )
        assert len(live) + len(self._free) == self.usable_pages, (
            f"leak: {len(live)} live + {len(self._free)} free "
            f"!= {self.usable_pages} usable"
        )
        overlap = live & set(self._free)
        assert not overlap, f"pages both live and free: {overlap}"
        assert len(self._free) == len(set(self._free)), "free list duplicates"
        if scales is not None and live:
            idx = np.asarray(sorted(live))
            for i, arr in enumerate(scales):
                a = np.asarray(arr)
                assert a.shape[0] >= self.num_pages, (
                    f"scale array {i} covers {a.shape[0]} pages "
                    f"< pool {self.num_pages}"
                )
                vals = a[idx]
                assert np.isfinite(vals).all(), (
                    f"non-finite scales on live pages (array {i}): "
                    f"{idx[~np.isfinite(vals).reshape(len(idx), -1).all(axis=1)]}"
                )
                assert (vals >= 0).all(), (
                    f"negative scales on live pages (array {i})"
                )

    def fragmentation(self) -> float:
        """1 - (longest contiguous free run / free pages). Pages are
        position-independent (the table is full indirection), so this is a
        diagnostic only — 'defrag' for this pool is simply freeing."""
        if not self._free:
            return 0.0
        ids = np.sort(np.asarray(self._free))
        runs = np.split(ids, np.flatnonzero(np.diff(ids) != 1) + 1)
        longest = max(len(r) for r in runs)
        return 1.0 - longest / len(ids)

    def as_dict(self) -> dict:
        """Stats snapshot for EngineStats / benchmarks."""
        d = {
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "allocated": self.num_allocated,
            "free": self.num_free,
            "live_sequences": self.live_sequences,
            "pages_saved": self.pages_saved,
            "utilization": self.num_allocated / max(1, self.usable_pages),
            "fragmentation": self.fragmentation(),
            **self.stats.as_dict(),
        }
        if self.layout is not None:
            d["layout"] = self.layout.as_dict()
        return d

    def register_metrics(self, registry, prefix: str = "kvpool") -> None:
        """Publish live occupancy into a :class:`repro.obs.metrics.
        MetricsRegistry` as callback gauges — sampled at export time, so
        the pool pays nothing per tick."""
        registry.gauge_fn(
            f"{prefix}_pages_in_use", lambda: self.num_allocated,
            help="KV pages currently allocated",
        )
        registry.gauge_fn(
            f"{prefix}_pages_free", lambda: self.num_free,
            help="KV pages on the free list",
        )
        registry.gauge_fn(
            f"{prefix}_page_utilization",
            lambda: self.num_allocated / max(1, self.usable_pages),
            help="allocated / usable pages",
        )
        registry.gauge_fn(
            f"{prefix}_pages_saved", lambda: self.pages_saved,
            help="pages deduped by refcount sharing",
        )
        registry.gauge_fn(
            f"{prefix}_live_sequences", lambda: self.live_sequences,
            help="sequences currently holding pages",
        )
