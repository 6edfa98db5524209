"""Copy of ``repro.serving.prefix_cache`` (numpy only), kept in the port so
that it imports nothing of the JAX package; it indexes the port's
:class:`~repro_torch.serving.kvpool.KVPagePool`.

Radix (trie) prefix cache over the paged KV pool.

LeanAttention's associativity means attention over a context can be computed
in arbitrary pieces and merged — so the KV of a *shared* prompt prefix
(system prompt, few-shot template) is a reusable artifact: compute it once,
keep its pages alive, and let every later request that starts with the same
tokens map those pages straight into its page table. This module is the
host-side index that makes that lookup cheap:

  * the trie is keyed by **page-aligned token blocks**: each node owns one
    physical page of the :class:`~repro_torch.serving.kvpool.KVPagePool` holding
    the KV of exactly that block of ``page_size`` tokens (at the node's
    depth — positions are absolute, and RoPE is applied before cache write,
    so a page is only reusable at its original depth: the trie structure
    guarantees that by construction);
  * interior/leaf nodes of **full** blocks are extendable; a **partial**
    tail node (< page_size tokens, from donating a non-aligned sequence) is
    matchable but childless — a requester that appends into a partial page
    must copy-on-write first (the engine owns that policy);
  * the cache holds its pages through the pool's refcounts under a reserved
    holder key; a request *shares* matched pages (refcount + 1) and
    releases them on finish/preemption — a page dies only when the cache
    AND every request let go;
  * under pool pressure the engine evicts **least-recently-used leaves**
    whose page no live request shares, walking up the trie as parents
    become leaves.

Insertion is donation: when a sequence finishes, the engine offers its
(tokens, pages); blocks already present are skipped (the duplicate page
stays with the sequence and dies with its release), new blocks hand the
page over to the cache. Matching never splits pages — divergence inside a
block simply ends the match at the last fully-matching boundary (or at a
partial node whose tokens are a prefix of the remainder).
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.kvpool import KVPagePool

__all__ = [
    "RadixPrefixCache",
    "PrefixMatch",
    "PrefixCacheStats",
    "CACHE_SEQ",
    "lcp_group_passes",
]

# reserved KVPagePool holder key for pages the cache keeps alive
CACHE_SEQ = "__radix_prefix_cache__"


class _Node:
    __slots__ = ("block", "page", "n_tokens", "children", "parent", "last_used")

    def __init__(self, block: Tuple[int, ...], page: int, n_tokens: int,
                 parent: Optional["_Node"]):
        self.block = block
        self.page = page
        self.n_tokens = n_tokens
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.last_used = 0

    def __repr__(self):
        return f"_Node(page={self.page}, n={self.n_tokens}, kids={len(self.children)})"


@dataclass
class PrefixMatch:
    """Result of a radix lookup: the matched page run, in logical order."""

    pages: List[int]
    matched_tokens: int
    tail_partial: bool        # last matched page holds < page_size tokens
    nodes: List[_Node] = field(default_factory=list, repr=False)

    @property
    def hit(self) -> bool:
        return self.matched_tokens > 0


@dataclass
class PrefixCacheStats:
    lookups: int = 0
    hits: int = 0
    misses: int = 0
    matched_tokens: int = 0       # cumulative prompt tokens served from cache
    matched_pages: int = 0
    inserted_pages: int = 0       # pages donated into the trie
    dedup_insert_pages: int = 0   # insert blocks already present (page not taken)
    evicted_pages: int = 0
    partial_matches: int = 0      # lookups whose match ended on a partial node
    aliased_insert_skips: int = 0  # donations refused: page backs another node
    aborted_inserts: int = 0      # donations rolled back mid-way (all-or-nothing)
    invalidated_pages: int = 0    # nodes dropped by invalidate_pages()
    repairs: int = 0              # repair() invocations (audit self-healing)

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def as_dict(self) -> dict:
        return {
            "lookups": self.lookups,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hit_rate,
            "matched_tokens": self.matched_tokens,
            "matched_pages": self.matched_pages,
            "inserted_pages": self.inserted_pages,
            "dedup_insert_pages": self.dedup_insert_pages,
            "evicted_pages": self.evicted_pages,
            "partial_matches": self.partial_matches,
            "aliased_insert_skips": self.aliased_insert_skips,
            "aborted_inserts": self.aborted_inserts,
            "invalidated_pages": self.invalidated_pages,
            "repairs": self.repairs,
        }


class RadixPrefixCache:
    """Token-keyed radix cache of KV pages over a :class:`KVPagePool`.

    Byte accounting (``bytes_cached``/``bytes_saved`` in :meth:`as_dict`)
    comes from the pool's :class:`~repro_torch.serving.kvpool.KVLayout`
    descriptor — there is deliberately no constructor knob: a static
    number would silently go stale the moment the pool layout (dtype,
    scale sidecar) changes under it.
    """

    def __init__(self, pool: KVPagePool):
        self.pool = pool
        self.page_size = pool.page_size
        self.root = _Node((), -1, 0, None)
        self._clock = 0
        self._num_nodes = 0
        self._pages: set = set()          # physical pages backing trie nodes
        self.stats = PrefixCacheStats()

    @property
    def page_bytes(self) -> int:
        """Live view of the pool layout's per-page byte cost (0 when the
        pool has no layout descriptor)."""
        return self.pool.page_bytes

    # ----------------------------------------------------------------- sizes
    def __len__(self) -> int:
        return self._num_nodes

    @property
    def cached_pages(self) -> int:
        return self._num_nodes

    def _touch(self, node: _Node) -> None:
        # touch the whole path: an ancestor is always at least as recently
        # used as its most recently used descendant, so LRU leaf eviction
        # never strands a hot suffix behind a "cold" (but live) ancestor
        self._clock += 1
        while node is not self.root and node is not None:
            node.last_used = self._clock
            node = node.parent

    # ---------------------------------------------------------------- lookup
    def match(self, tokens: Sequence[int]) -> PrefixMatch:
        """Longest page-aligned cached prefix of ``tokens``.

        Descends full-block children while whole ``page_size`` blocks match;
        at the frontier, additionally accepts one *partial* child whose
        (short) block is a prefix of the remaining tokens. Matched nodes are
        LRU-touched. The caller shares the returned pages into its own pool
        key before using them.
        """
        toks = [int(t) for t in tokens]
        ps = self.page_size
        self.stats.lookups += 1
        node = self.root
        pages: List[int] = []
        nodes: List[_Node] = []
        matched = 0
        i = 0
        while len(toks) - i >= ps:
            child = node.children.get(tuple(toks[i : i + ps]))
            if child is None or child.n_tokens != ps:
                break
            node = child
            pages.append(node.page)
            nodes.append(node)
            matched += ps
            i += ps
        # frontier: longest partial child contained in the remainder
        rem = toks[i:]
        best = None
        for child in node.children.values():
            if child.n_tokens == ps or child.n_tokens > len(rem):
                continue
            if list(child.block) == rem[: child.n_tokens]:
                if best is None or child.n_tokens > best.n_tokens:
                    best = child
        tail_partial = False
        if best is not None:
            pages.append(best.page)
            nodes.append(best)
            matched += best.n_tokens
            tail_partial = True
            self.stats.partial_matches += 1
        if nodes:
            self._touch(nodes[-1])
            self.stats.hits += 1
        else:
            self.stats.misses += 1
        self.stats.matched_tokens += matched
        self.stats.matched_pages += len(pages)
        return PrefixMatch(pages=pages, matched_tokens=matched,
                           tail_partial=tail_partial, nodes=nodes)

    # ---------------------------------------------------------------- insert
    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Donate a sequence's prefix pages into the trie.

        ``pages[j]`` must hold the KV of tokens ``[j*ps, min((j+1)*ps, L))``
        — exactly the engine's page-table row for the sequence. Blocks
        already cached are skipped (their duplicate page stays with the
        donor and dies on its release); new blocks are shared into the
        cache's pool key, so they outlive the donor. A non-aligned tail
        becomes a childless *partial* node. Returns the number of pages the
        cache newly took a reference on.

        Descent stops at the first skipped block boundary mismatch — a
        child chain must stay contiguous from the root.

        Donation is **all-or-nothing**: a failure partway through (a
        ``pool.share`` that raises — e.g. under fault injection or after
        state corruption) unwinds every node this call created before
        re-raising, so a crashed finish can never leave a half-donated
        chain in the trie.
        """
        toks = [int(t) for t in tokens]
        ps = self.page_size
        nfull, j = divmod(len(toks), ps)
        if len(pages) < nfull + (1 if j else 0):
            raise ValueError(
                f"{len(toks)} tokens need {nfull + (1 if j else 0)} pages, "
                f"got {len(pages)}"
            )
        created: List[_Node] = []

        def take_block(node: _Node, block: Tuple[int, ...],
                       page: int, n_tokens: int) -> Optional[_Node]:
            """Donate one page as a child of ``node``; None = alias stop.

            A physical page may back at most one trie node — a donor that
            extended a matched partial page without copy-on-write offers a
            page that already backs another node; the walk must stop there
            (the chain stays contiguous from the root).
            """
            if page in self._pages:
                self.stats.aliased_insert_skips += 1
                return None
            self.pool.share(CACHE_SEQ, [page])
            child = _Node(block, page, n_tokens, node)
            node.children[block] = child
            self._num_nodes += 1
            self._pages.add(page)
            self.stats.inserted_pages += 1
            created.append(child)
            return child

        node = self.root
        last = None
        try:
            for b in range(nfull):
                block = tuple(toks[b * ps : (b + 1) * ps])
                child = node.children.get(block)
                if child is not None and child.n_tokens == ps:
                    self.stats.dedup_insert_pages += 1
                else:
                    child = take_block(node, block, int(pages[b]), ps)
                    if child is None:
                        break
                node = last = child
            else:
                if j:
                    block = tuple(toks[nfull * ps :])
                    child = node.children.get(block)
                    if child is not None:
                        self.stats.dedup_insert_pages += 1
                        last = child
                    else:
                        child = take_block(node, block, int(pages[nfull]), j)
                        if child is not None:
                            last = child
        except Exception:
            # crash-consistent finish: roll the whole donation back
            for child in reversed(created):
                del child.parent.children[child.block]
                self.pool.release_pages(CACHE_SEQ, [child.page])
                self._pages.discard(child.page)
                self._num_nodes -= 1
                self.stats.inserted_pages -= 1
            self.stats.aborted_inserts += 1
            raise
        if last is not None:
            self._touch(last)
        return len(created)

    # ----------------------------------------------------------------- evict
    def evictable_leaves(self) -> List[_Node]:
        """Leaves whose page only the cache still holds (refcount 1)."""
        out: List[_Node] = []

        def walk(node: _Node):
            for child in node.children.values():
                if child.children:
                    walk(child)
                elif self.pool.refcount(child.page) == 1:
                    out.append(child)

        walk(self.root)
        return out

    def evict(self, n_pages: int) -> int:
        """Free up to ``n_pages`` pool pages by dropping LRU unreferenced
        leaves (walking upward as parents become leaves). Returns the
        number of pages actually freed."""
        freed = 0
        candidates = sorted(self.evictable_leaves(), key=lambda c: c.last_used)
        while freed < n_pages and candidates:
            victim = candidates.pop(0)
            parent = victim.parent
            del parent.children[victim.block]
            self.pool.release_pages(CACHE_SEQ, [victim.page])
            self._pages.discard(victim.page)
            self._num_nodes -= 1
            freed += 1
            self.stats.evicted_pages += 1
            if (
                parent is not self.root
                and not parent.children
                and self.pool.refcount(parent.page) == 1
            ):
                # keep the candidate list LRU-sorted as the frontier recedes
                keys = [c.last_used for c in candidates]
                candidates.insert(
                    bisect.bisect_left(keys, parent.last_used), parent
                )
        return freed

    def drop_all(self) -> int:
        """Release every cached page (cache reset; pool survives)."""
        n = 0
        while True:
            freed = self.evict(self._num_nodes or 1)
            n += freed
            if freed == 0:
                break
        return n

    def invalidate_pages(self, pages) -> int:
        """Drop every trie node backed by one of ``pages`` — together with
        its whole subtree (a child's KV is only valid below its ancestors'
        tokens, so a removed ancestor invalidates the chain). Used by the
        engine's poison path: a slot presumed KV-corrupt withdraws its
        shared prefix pages from the cache so no future request maps them.
        Live requests already sharing those pages keep their refs; the
        cache just stops handing the pages out. Returns nodes removed."""
        bad = {int(p) for p in pages}
        if not bad:
            return 0
        removed = 0

        def drop_subtree(node: _Node) -> int:
            n = 1
            for child in list(node.children.values()):
                n += drop_subtree(child)
            self.pool.release_pages(CACHE_SEQ, [node.page])
            self._pages.discard(node.page)
            self._num_nodes -= 1
            return n

        def walk(node: _Node):
            nonlocal removed
            for block, child in list(node.children.items()):
                if child.page in bad:
                    del node.children[block]
                    removed += drop_subtree(child)
                else:
                    walk(child)

        walk(self.root)
        self.stats.invalidated_pages += removed
        return removed

    def repair(self) -> int:
        """Reset the trie to empty and release every page the pool records
        under the cache's holder key — the recovery action for a failed
        ``check()`` (the trie's host structures are presumed corrupt, so
        nothing in them can be trusted enough for a surgical fix; future
        donations repopulate the cache). Safe against arbitrary internal
        inconsistency because it only consults the *pool's* records.
        Returns the number of page references released."""
        released = 0
        if self.pool.holds(CACHE_SEQ):
            released = len(self.pool.pages_of(CACHE_SEQ))
            self.pool.free_seq(CACHE_SEQ)
        self.root = _Node((), -1, 0, None)
        self._pages = set()
        self._num_nodes = 0
        self.stats.repairs += 1
        return released

    # ------------------------------------------------------------ invariants
    def check(self) -> None:
        """Assert trie/pool consistency (tests / debug ticks)."""
        seen: List[int] = []

        def walk(node: _Node, depth: int):
            for block, child in node.children.items():
                assert child.parent is node
                assert child.block == block
                assert 0 < child.n_tokens <= self.page_size
                assert len(block) == child.n_tokens
                if child.n_tokens < self.page_size:
                    assert not child.children, "partial node must be a leaf"
                assert self.pool.refcount(child.page) >= 1
                seen.append(child.page)
                walk(child, depth + 1)

        walk(self.root, 0)
        assert len(seen) == len(set(seen)) == self._num_nodes
        assert set(seen) == self._pages, "page index out of sync with trie"
        assert sorted(seen) == sorted(self.pool.pages_of(CACHE_SEQ)), (
            "trie pages out of sync with the pool's cache holdings"
        )

    def as_dict(self) -> dict:
        d = {
            "nodes": self._num_nodes,
            "cached_pages": self.cached_pages,
            "pages_saved": self.pool.pages_saved,
            **self.stats.as_dict(),
        }
        if self.page_bytes:
            d["bytes_cached"] = self.cached_pages * self.page_bytes
            d["bytes_saved"] = self.pool.pages_saved * self.page_bytes
        return d

    def register_metrics(self, registry,
                         prefix: str = "prefix_cache") -> None:
        """Publish cache effectiveness into a :class:`repro_torch.obs.metrics.
        MetricsRegistry` as callback gauges (zero per-lookup cost)."""
        registry.gauge_fn(
            f"{prefix}_hit_rate", lambda: self.stats.hit_rate,
            help="radix lookups served from cache",
        )
        registry.gauge_fn(
            f"{prefix}_cached_pages", lambda: self.cached_pages,
            help="pages held by the radix trie",
        )
        registry.gauge_fn(
            f"{prefix}_nodes", lambda: self._num_nodes,
            help="radix trie nodes",
        )
        registry.gauge_fn(
            f"{prefix}_bytes_saved",
            lambda: self.pool.pages_saved * self.page_bytes,
            help="KV bytes deduped via shared prefixes",
        )


# -------------------------------------------------------------- grouping
def lcp_group_passes(
    paths: Dict[int, Sequence[int]],
    *,
    multi_level: bool = True,
    min_group: int = 2,
) -> List[Tuple[Tuple[int, ...], int, int]]:
    """Grouped cascade passes from per-slot radix page paths.

    ``paths[slot]`` is the slot's run of shared (radix-matched) physical
    pages, in logical order — exactly the leading entries of its page
    table. The function walks the compressed trie those paths induce and
    emits one pass per trie node where at least ``min_group`` slots still
    travel together: ``(members, page_start, page_count)`` meaning the
    members share pages ``[page_start, page_start + page_count)`` of
    their tables.

    This is longest-common-prefix grouping: slots matching 3 and 5 pages
    of the same chain group at 3 (the LCP), the deeper slot keeping its
    extra shared pages in its private suffix walk. With ``multi_level``
    (the default) the recursion continues below each divergence point, so
    nested subsets that share deeper emit additional stacked passes — one
    grouped pass per trie level, merged by the same associative operator.
    With ``multi_level=False`` only the top-level LCP pass per root chain
    is emitted (each slot appears in at most one pass).

    Output is deterministic (sorted members, chain-page order) and
    contains no singleton passes — a slot sharing with nobody decodes on
    the vanilla paged path.
    """
    def rec(slots: List[int], depth: int):
        # extend the run while every slot still shares the next page
        d = depth
        while (
            all(len(paths[s]) > d for s in slots)
            and len({paths[s][d] for s in slots}) == 1
        ):
            d += 1
        out = []
        if d > depth:
            out.append((tuple(sorted(slots)), depth, d - depth))
            if not multi_level:
                return out    # single-level: stop below the LCP pass
        kids: Dict[int, List[int]] = {}
        for s in slots:
            if len(paths[s]) > d:
                kids.setdefault(int(paths[s][d]), []).append(s)
        for _, sub in sorted(kids.items()):
            if len(sub) >= min_group:
                out.extend(rec(sub, d))
        return out

    roots: Dict[int, List[int]] = {}
    for s, p in paths.items():
        if len(p) > 0:
            roots.setdefault(int(p[0]), []).append(s)
    passes: List[Tuple[Tuple[int, ...], int, int]] = []
    for _, slots in sorted(roots.items()):
        if len(slots) >= min_group:
            passes.extend(rec(slots, 0))
    return passes
