"""Copy of ``repro.core.leantile`` (numpy only). The port keeps its own copy
because importing the reference module runs ``repro/core/__init__.py``, which
imports JAX. Schedules and descriptors must stay array-equal to the
reference's (``tests/test_torch_leantile.py``); the TPU defaults
(``default_tile_size``) are kept for that parity.

LeanTile stream-K scheduler (paper §IV-B/IV-C), host-side.

The schedule linearizes every LeanTile iteration of a decode-attention
problem across ``batch -> kv_head -> context`` (the paper's constant-stride
linearization), then splits that flat iteration list into ``G`` contiguous,
*equal-size* ranges — one per worker. A worker's range may cross segment
(output-tile) boundaries; each maximal same-segment run inside a worker is a
"piece" whose un-scaled partial result is later reduced with the associative
softmax re-scaling operator (:mod:`repro.core.merge`).

Terminology (matching the paper):
  segment   = one output tile = one (batch, kv_head) pair in decode
  LeanTile  = ``tile_size`` KV tokens of one segment
  worker    = the TPU analogue of a CTA: one grid step of the Pallas kernel
              (or one device in the distributed setting)
  piece     = (worker x segment) contiguous run -> one partial (o, m, l)
  host piece= the first piece of a segment (paper's "host block")

Ragged batches (heterogeneous context lengths) fall out naturally: tiles per
segment just differ, the linearization stays contiguous (paper Fig. 6).

Everything here is plain numpy executed on the host: in serving, context
lengths are concrete host values each step, so schedules are cheap to build
and are passed to the Pallas kernel as scalar-prefetch descriptor arrays.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "CascadeBinding",
    "CascadeSchedule",
    "LeanSchedule",
    "ScheduleCache",
    "ScheduleCacheStats",
    "bucket_ctx_lens",
    "bucket_length",
    "cascade_fused_descriptors",
    "make_schedule",
    "make_cascade_schedule",
    "make_chunk_schedule",
    "make_spec_schedule",
    "default_tile_size",
    "fixed_split_factor",
]


def default_tile_size(head_dim: int) -> int:
    """Paper §IV-B found 256 tokens (d=64) / 128 tokens (d=128) optimal on
    A100. On TPU the constraint is MXU/VMEM alignment: the KV tile is the
    matmul N dimension, so keep it a multiple of 128 lanes; 256 keeps the
    (tile x d) VMEM working set ~64-128 KiB. Swept in EXPERIMENTS.md §Perf."""
    return 256 if head_dim <= 64 else 128


@dataclass(frozen=True, eq=False)
class LeanSchedule:
    """Static-shape stream-K schedule + merge metadata.

    All descriptor arrays have length ``num_workers * tiles_per_worker``
    (padded); padded iters have ``iter_valid == 0`` and point at the
    dedicated garbage piece ``num_pieces`` (partial buffers are allocated
    with ``num_pieces + 1`` rows).

    Instances hash and compare by *content* (a cached byte signature over
    the descriptor arrays), so a schedule is a valid ``jax.jit`` static
    argument: equal schedules — notably the memoized instances handed out
    by :class:`ScheduleCache` — share one trace.
    """

    tile_size: int
    num_workers: int          # G
    tiles_per_worker: int     # ceil(total_tiles / G)
    total_tiles: int
    num_segments: int         # S = B * H_kv
    num_pieces: int           # P <= S + G - 1

    # per-iteration descriptors, each (G * tiles_per_worker,) int32
    iter_seg: np.ndarray      # segment id (S for padding)
    iter_tile: np.ndarray     # kv-tile index within the segment
    iter_piece: np.ndarray    # partial slot accumulated into (P for padding)
    iter_first: np.ndarray    # 1 -> first iter of its piece (reset scratch)
    iter_last: np.ndarray     # 1 -> last iter of its piece (flush partial)
    iter_len: np.ndarray      # valid tokens in this tile (<= tile_size)
    iter_valid: np.ndarray    # 1 -> real work

    # merge metadata
    piece_seg: np.ndarray     # (P,) segment of each piece
    piece_host: np.ndarray    # (P,) 1 -> first piece of its segment
    seg_batch: np.ndarray     # (S,) batch index of segment
    seg_head: np.ndarray      # (S,) kv-head index of segment
    seg_len: np.ndarray       # (S,) context length

    @property
    def grid_iters(self) -> int:
        return self.num_workers * self.tiles_per_worker

    # ---------------------------------------------------- hash / equality
    @property
    def signature(self) -> tuple:
        sig = self.__dict__.get("_sig")
        if sig is None:
            sig = (
                self.tile_size, self.num_workers, self.tiles_per_worker,
                self.total_tiles, self.num_segments, self.num_pieces,
                self.iter_seg.tobytes(), self.iter_tile.tobytes(),
                self.iter_piece.tobytes(), self.iter_first.tobytes(),
                self.iter_last.tobytes(), self.iter_len.tobytes(),
                self.iter_valid.tobytes(), self.piece_seg.tobytes(),
                self.piece_host.tobytes(), self.seg_batch.tobytes(),
                self.seg_head.tobytes(), self.seg_len.tobytes(),
            )
            object.__setattr__(self, "_sig", sig)
        return sig

    def __hash__(self) -> int:
        h = self.__dict__.get("_hash")
        if h is None:
            h = hash(self.signature)
            object.__setattr__(self, "_hash", h)
        return h

    def __eq__(self, other) -> bool:
        if self is other:
            return True
        if not isinstance(other, LeanSchedule):
            return NotImplemented
        return self.signature == other.signature

    # ------------------------------------------------------ observability
    def work_summary(self) -> dict:
        """Scalar work totals for tracing/attribution (tiles, segments,
        pieces, real KV tokens covered). Memoized on the instance like
        the packed descriptors, so annotating a trace span with a
        cache-hit schedule costs a dict copy and nothing else."""
        ws = self.__dict__.get("_work_summary")
        if ws is None:
            ws = {
                "tile_size": int(self.tile_size),
                "total_tiles": int(self.total_tiles),
                "num_segments": int(self.num_segments),
                "num_pieces": int(self.num_pieces),
                "num_workers": int(self.num_workers),
                "kv_tokens": int(self.seg_len.sum()),
            }
            object.__setattr__(self, "_work_summary", ws)
        return ws

    # ------------------------------------------------- packed descriptors
    def packed_descriptors(self) -> np.ndarray:
        """The (7, G*T) int32 scalar-prefetch array the two-phase kernel
        consumes (row layout in :mod:`repro.kernels.lean_decode`). Built
        once and memoized on the instance — a cache-hit decode tick does
        zero numpy work here."""
        desc = self.__dict__.get("_packed")
        if desc is None:
            desc = np.stack(
                [
                    self.iter_seg, self.iter_tile, self.iter_piece,
                    self.iter_first, self.iter_last, self.iter_len,
                    self.iter_valid,
                ]
            ).astype(np.int32)
            object.__setattr__(self, "_packed", desc)
        return desc

    def fused_descriptors(self) -> np.ndarray:
        """Descriptors for the fused partial+merge kernel: the (7, G*T)
        partial-phase rows with ``num_pieces`` merge iterations appended.

        Merge iteration ``p`` (grid step ``G*T + p``) reduces partial row
        ``p`` into its segment: SEG = piece_seg[p], PIECE = p, FIRST/LAST
        flag segment boundaries in the (segment-contiguous) piece order,
        and VALID = 2 marks the merge opcode. Memoized like
        :meth:`packed_descriptors`."""
        desc = self.__dict__.get("_packed_fused")
        if desc is None:
            base = self.packed_descriptors()
            P = self.num_pieces
            merge = np.zeros((7, P), dtype=np.int32)
            merge[0] = self.piece_seg                       # DESC_SEG
            merge[2] = np.arange(P, dtype=np.int32)         # DESC_PIECE
            first = np.ones(P, dtype=np.int32)
            first[1:] = self.piece_seg[1:] != self.piece_seg[:-1]
            last = np.ones(P, dtype=np.int32)
            last[:-1] = self.piece_seg[:-1] != self.piece_seg[1:]
            merge[3] = first                                # DESC_FIRST
            merge[4] = last                                 # DESC_LAST
            merge[6] = 2                                    # DESC_VALID: op
            desc = np.concatenate([base, merge], axis=1)
            object.__setattr__(self, "_packed_fused", desc)
        return desc

    def piece_ranges(self) -> Tuple[np.ndarray, np.ndarray]:
        """(starts, counts): segment ``s`` owns partial rows
        ``[starts[s], starts[s] + counts[s])`` — pieces are contiguous per
        segment by construction. Memoized (merge-phase metadata)."""
        pr = self.__dict__.get("_piece_ranges")
        if pr is None:
            S = self.num_segments
            starts = np.searchsorted(self.piece_seg, np.arange(S)).astype(
                np.int32
            )
            ends = np.searchsorted(
                self.piece_seg, np.arange(S), side="right"
            ).astype(np.int32)
            pr = (starts, ends - starts)
            object.__setattr__(self, "_piece_ranges", pr)
        return pr

    def iter_kv_meta(self, fused: bool = False):
        """Per-grid-iteration KV routing metadata for the *paged* kernels:
        ``(batch_idx, head_idx, tile_idx, is_partial)``, each ``(I,) int32``
        with ``I = grid_iters`` (+ ``num_pieces`` merge rows when ``fused``).

        A paged execution resolves iteration ``i`` to the physical KV page
        ``page_table[batch_idx[i], tile_idx[i]]`` and kv head ``head_idx[i]``
        (tile_size == page_size, so tiles map 1:1 onto pages). Only this
        *logical* routing is emitted here — composing with the runtime page
        table happens in :mod:`repro.kernels.ops` — so schedules stay
        page-table-independent: :class:`ScheduleCache` keys remain pure
        functions of the bucketed lengths and bucketing keeps hitting even
        as sequences migrate across physical pages. Padding and merge rows
        route to (0, 0, 0) with ``is_partial == 0``. Memoized like the
        packed descriptors.
        """
        key = "_kv_meta_fused" if fused else "_kv_meta"
        meta = self.__dict__.get(key)
        if meta is None:
            desc = self.fused_descriptors() if fused else self.packed_descriptors()
            seg = desc[0]
            ok = desc[6] == 1                           # OP_PARTIAL rows only
            # index S (padding sentinel) lands on the appended 0
            seg_batch_ext = np.append(self.seg_batch, 0).astype(np.int32)
            seg_head_ext = np.append(self.seg_head, 0).astype(np.int32)
            i32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)
            meta = (
                i32(np.where(ok, seg_batch_ext[np.minimum(seg, self.num_segments)], 0)),
                i32(np.where(ok, seg_head_ext[np.minimum(seg, self.num_segments)], 0)),
                i32(np.where(ok, desc[1], 0)),
                i32(ok),
            )
            object.__setattr__(self, key, meta)
        return meta

    def max_pieces_per_worker(self) -> int:
        counts = np.zeros(self.num_workers, dtype=np.int64)
        T = self.tiles_per_worker
        for g in range(self.num_workers):
            sl = self.iter_piece[g * T : (g + 1) * T]
            sl = sl[self.iter_valid[g * T : (g + 1) * T] == 1]
            counts[g] = len(np.unique(sl))
        return int(counts.max(initial=0))


def make_schedule(
    ctx_lens: Sequence[int],
    num_kv_heads: int,
    tile_size: int,
    num_workers: int,
) -> LeanSchedule:
    """Build the LeanAttention stream-K schedule.

    Args:
      ctx_lens: context length per batch element (ragged OK, paper Fig. 6).
      num_kv_heads: KV heads per element; q-head GQA groups ride along.
      tile_size: LeanTile granularity in KV tokens.
      num_workers: G — grid size (TPU: cores x pipeline factor; mesh: devices).
    """
    ctx_lens = np.asarray(list(ctx_lens), dtype=np.int64)
    if np.any(ctx_lens <= 0):
        raise ValueError("context lengths must be positive")
    B, H = len(ctx_lens), int(num_kv_heads)
    S = B * H
    # tiles per segment; segments ordered batch-major (b * H + h)
    tiles_per_batch = (ctx_lens + tile_size - 1) // tile_size
    seg_tiles = np.repeat(tiles_per_batch, H)           # (S,)
    seg_len = np.repeat(ctx_lens, H)                    # (S,)
    seg_batch = np.repeat(np.arange(B, dtype=np.int64), H)
    seg_head = np.tile(np.arange(H, dtype=np.int64), B)

    total = int(seg_tiles.sum())
    G = int(num_workers)
    T = max(1, -(-total // G))                          # ceil
    padded = G * T

    seg_off = np.zeros(S + 1, dtype=np.int64)
    np.cumsum(seg_tiles, out=seg_off[1:])

    # flat iter -> (segment, tile-within-segment)
    flat = np.arange(padded, dtype=np.int64)
    valid = (flat < total).astype(np.int32)
    seg_of = np.searchsorted(seg_off, np.minimum(flat, total - 1), side="right") - 1
    tile_of = np.minimum(flat, total - 1) - seg_off[seg_of]

    # pieces: a new piece starts when (a) iter 0 of a worker, or (b) the
    # segment changes from the previous iter — restricted to valid iters.
    worker_of = flat // T
    new_piece = np.zeros(padded, dtype=bool)
    v = valid.astype(bool)
    new_piece[v] = True
    idx = np.flatnonzero(v)
    if len(idx) > 1:
        prev = idx[:-1]
        cur = idx[1:]
        same_worker = worker_of[cur] == worker_of[prev]
        same_seg = seg_of[cur] == seg_of[prev]
        contiguous = cur == prev + 1
        new_piece[cur] = ~(same_worker & same_seg & contiguous)
        new_piece[idx[0]] = True
    piece_of = np.cumsum(new_piece) - 1                 # valid iters: 0..P-1
    P = int(piece_of[v].max(initial=-1)) + 1 if v.any() else 0
    piece_of = np.where(v, piece_of, P)                 # padding -> garbage

    is_first = np.where(v, new_piece, 0).astype(np.int32)
    is_last = np.zeros(padded, dtype=np.int32)
    if len(idx):
        # a valid iter is last-of-piece if the next valid-in-same-worker iter
        # starts a new piece, or it is the worker's final valid iter.
        nxt = np.roll(new_piece, -1)
        nxt[-1] = True
        boundary = (np.arange(padded) % T) == (T - 1)
        is_last[v] = (nxt[v] | boundary[v]).astype(np.int32)
        # also: the very last valid iter overall
        is_last[idx[-1]] = 1

    # tile token counts (last tile of a segment may be short)
    tlen = np.where(
        v,
        np.minimum(seg_len[seg_of] - tile_of * tile_size, tile_size),
        0,
    )

    piece_seg = np.full(P, -1, dtype=np.int64)
    piece_seg[piece_of[v]] = seg_of[v]
    # host piece = piece containing tile 0 of its segment
    piece_host = np.zeros(P, dtype=np.int32)
    first_tile_mask = v & (tile_of == 0)
    piece_host[piece_of[first_tile_mask]] = 1

    i32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)
    return LeanSchedule(
        tile_size=tile_size,
        num_workers=G,
        tiles_per_worker=T,
        total_tiles=total,
        num_segments=S,
        num_pieces=P,
        iter_seg=i32(np.where(v, seg_of, S)),
        iter_tile=i32(tile_of),
        iter_piece=i32(piece_of),
        iter_first=i32(is_first),
        iter_last=i32(is_last),
        iter_len=i32(tlen),
        iter_valid=i32(valid),
        piece_seg=i32(piece_seg),
        piece_host=i32(piece_host),
        seg_batch=i32(seg_batch),
        seg_head=i32(seg_head),
        seg_len=i32(seg_len),
    )


def make_chunk_schedule(
    visible_lens: Sequence[int],
    num_kv_heads: int,
    tile_size: int,
    num_workers: int,
    *,
    max_len: Optional[int] = None,
    cache: Optional["ScheduleCache"] = None,
) -> LeanSchedule:
    """Stream-K schedule for a *pack of prefill chunks* (the ragged chunk
    grid of the continuous-batching scheduler).

    A chunk pack is N concurrent prompt chunks, one per in-flight request;
    ``visible_lens[n]`` is the KV the n-th chunk attends over — everything
    already prefilled for that request *plus* the chunk itself
    (``off + chunk_len``). The workload is exactly a decode workload with a
    taller query block (``g * chunk_capacity`` rows per segment instead of
    ``g``), so the segment/tile/piece linearization is :func:`make_schedule`
    verbatim — only the kernel differs (causal masking per q row, see
    :mod:`repro.kernels.lean_prefill`).

    Dummy pack rows (fewer live chunks than the pack width) pass visible
    length 0 and are clamped to one fully-masked tile, mirroring how idle
    slots ride in decode schedules. With ``cache`` given, lengths bucket
    through the shared :class:`ScheduleCache` — chunk schedules hit the
    same memoized lattice as decode schedules, so steady-state chunked
    prefill builds zero schedules too.
    """
    lens = [max(1, int(n)) for n in visible_lens]
    if cache is not None:
        return cache.get(
            lens, num_kv_heads, tile_size, num_workers, max_len=max_len
        )
    if max_len is not None:
        lens = [min(n, max_len) for n in lens]
    return make_schedule(lens, num_kv_heads, tile_size, num_workers)


def make_spec_schedule(
    ctx_lens: Sequence[int],
    rows: int,
    num_kv_heads: int,
    tile_size: int,
    num_workers: int,
    *,
    max_len: Optional[int] = None,
    cache: Optional["ScheduleCache"] = None,
) -> LeanSchedule:
    """Stream-K schedule for a *speculative verify* tick: ``rows`` stacked
    query rows per sequence (the last committed token plus k draft tokens)
    scored against ``ctx_lens[b] + rows`` visible KV in one sweep.

    This is a chunk schedule in disguise — a verify tick is a prefill pack
    whose "chunk" is the draft block, so the visible KV per sequence is the
    committed context plus the block itself and the linearization is
    :func:`make_chunk_schedule` verbatim (the per-row runtime ``qstart``
    causal mask handles the offset inside the kernel). Sequences excluded
    from the verify pass ride along with ``ctx_lens[b] = 0``: their walk
    covers ``rows`` tokens of tiles that the runtime ``seg_ctx = 0`` masks
    entirely, like idle slots in decode schedules.

    With ``cache`` given, bucketing over ``(ctx_len, rows)`` falls out of
    the shared length lattice: ``ctx + rows`` buckets exactly like any other
    visible length, so verify schedules hit the same memoized entries as
    decode and chunk-prefill schedules.
    """
    if rows < 1:
        raise ValueError(f"spec schedule needs rows >= 1, got {rows}")
    visible = [int(c) + rows for c in ctx_lens]
    return make_chunk_schedule(
        visible, num_kv_heads, tile_size, num_workers,
        max_len=max_len, cache=cache,
    )


# ----------------------------------------------------------------- cascade
@dataclass(frozen=True, eq=False)
class CascadeSchedule:
    """Prefix-grouped (cascade) stream-K schedule for shared-prefix decode.

    Sequences sharing page-aligned prompt-prefix runs form *grouped
    passes* — one pass per node of the (compressed) radix trie over the
    slots' shared page paths. A pass covers a contiguous page range
    ``[page_start, page_start + pages)`` of its members' tables, so nested
    trie levels simply stack passes (a slot may appear in several). The
    cascade splits attention into two ordinary stream-K phases:

      * **prefix phase** — one segment per (pass, kv_head) whose query
        block stacks every member's query rows (``group_size * g`` rows,
        padded to the largest pass), walking the pass's shared pages
        exactly once instead of once per member;
      * **suffix phase** — the normal per-sequence decode over each slot's
        private tail pages (table shifted past its deepest coverage).

    Both phases are plain :class:`LeanSchedule` instances; the merge
    reduces each sequence's expanded prefix piece rows and suffix pieces
    with the associative softmax re-scaling operator (paper §IV-A).

    The schedule is **membership-free**: it carries only the phase
    geometry (bucketed pass/suffix walks in canonical order), and hashes
    by that content, so it is a valid ``jax.jit`` static argument that is
    *shared* by every grouping with equivalent geometry. Which slots sit
    in which pass — and which physical pages they walk — rides alongside
    as a :class:`CascadeBinding` of runtime arrays.
    """

    batch: int                 # B sequences
    num_kv_heads: int          # H_kv
    num_groups: int            # NP grouped passes (trie nodes), >= 1
    group_size: int            # nmax: members per pass, padded
    tile_size: int
    prefix_sched: LeanSchedule  # NP * H_kv segments, nmax * g query rows
    suffix_sched: LeanSchedule  # B * H_kv segments, g query rows

    @property
    def signature(self) -> tuple:
        sig = self.__dict__.get("_sig")
        if sig is None:
            sig = (
                self.batch, self.num_kv_heads, self.num_groups,
                self.group_size, self.tile_size,
                self.prefix_sched.signature, self.suffix_sched.signature,
            )
            object.__setattr__(self, "_sig", sig)
        return sig

    def __hash__(self) -> int:
        h = self.__dict__.get("_hash")
        if h is None:
            h = hash(self.signature)
            object.__setattr__(self, "_hash", h)
        return h

    def __eq__(self, other) -> bool:
        if self is other:
            return True
        if not isinstance(other, CascadeSchedule):
            return NotImplemented
        return self.signature == other.signature

    # ------------------------------------------------- fused-kernel layout
    @property
    def num_pieces_total(self) -> int:
        """Combined piece axis: prefix pieces then suffix pieces (the
        fused kernel's VMEM partial ring is this + 1 garbage row)."""
        return self.prefix_sched.num_pieces + self.suffix_sched.num_pieces

    @property
    def fused_merge_iters(self) -> int:
        """Merge iterations of the fused grid: every prefix piece expands
        to ``group_size`` member contributions (padding ranks become
        garbage-target iterations) plus one per suffix piece."""
        return (
            self.group_size * self.prefix_sched.num_pieces
            + self.suffix_sched.num_pieces
        )

    @property
    def fused_grid_iters(self) -> int:
        return (
            self.prefix_sched.grid_iters
            + self.suffix_sched.grid_iters
            + self.fused_merge_iters
        )

    def fused_partial_descriptors(self) -> np.ndarray:
        """Static partial-phase section of the fused cascade descriptors:
        prefix then suffix packed descriptors, renumbered into the
        combined segment space (prefix segments first) and combined piece
        space (padding rows point at the combined garbage piece).
        Memoized."""
        desc = self.__dict__.get("_fused_static")
        if desc is None:
            dp = self.prefix_sched.packed_descriptors().copy()
            ds = self.suffix_sched.packed_descriptors().copy()
            Pp = self.prefix_sched.num_pieces
            Ptot = self.num_pieces_total
            nph = self.num_groups * self.num_kv_heads
            vp = dp[6] == 1
            dp[0] = np.where(vp, dp[0], 0)
            dp[2] = np.where(vp, dp[2], Ptot)
            vs = ds[6] == 1
            ds[0] = np.where(vs, ds[0] + nph, 0)
            ds[2] = np.where(vs, ds[2] + Pp, Ptot)
            desc = np.ascontiguousarray(
                np.concatenate([dp, ds], axis=1).astype(np.int32)
            )
            object.__setattr__(self, "_fused_static", desc)
        return desc


@dataclass(frozen=True, eq=False)
class CascadeBinding:
    """Per-tick runtime companion of a :class:`CascadeSchedule`: which
    slots sit in which grouped pass and how deep each pass/slot's shared
    coverage runs. Host-side numpy, rebuilt cheaply every lookup — these
    arrays enter the jitted step as *runtime* operands, never as trace
    keys, which is what lets equivalent groupings share one trace."""

    members: np.ndarray          # (NP, nmax) int32 slot ids, -1 padding
    page_start: np.ndarray       # (NP,) int32 first shared page of the pass
    prefix_pages: np.ndarray     # (NP,) int32 clamped shared pages walked
    prefix_lens: np.ndarray      # (NP,) int32 == prefix_pages * tile_size
    seq_prefix_pages: np.ndarray  # (B,) int32 deepest contiguous coverage
    seq_prefix_len: np.ndarray   # (B,) int32 == seq_prefix_pages * tile
    num_levels: int              # max passes stacked on any one slot


def _resolve_cascade_structure(
    ctx: Sequence[int],
    passes: Sequence[Tuple[Sequence[int], int, int]],
    tile_size: int,
    max_len: Optional[int],
    bucket: bool,
):
    """Clamp, validate, and canonically order the grouped passes.

    ``passes`` entries are ``(members, page_start, page_count)``. A pass
    survives only if it has >= 2 members (a collapsed group is vanilla
    decode), its start matches every member's current coverage (nesting
    stays contiguous from page 0), and its clamped count — every member
    must keep >= 1 suffix token past its deepest coverage — stays
    positive. Survivors are ordered by *geometry* (bucketed walk, size)
    with membership only as a deterministic tie-break, so two groupings
    with equal geometry resolve to identical schedule inputs.

    Returns ``(kept, cov_pages, pref_walk, suf_walk)``.
    """
    B = len(ctx)
    norm = []
    for mem, start, count in passes:
        m = tuple(sorted({int(b) for b in mem}))
        if any(b < 0 or b >= B for b in m):
            raise ValueError(f"pass member out of range(batch={B}): {m}")
        norm.append((m, int(start), int(count)))
    # shallow passes first; bigger groups win ties at equal depth
    norm.sort(key=lambda p: (p[1], -len(p[0]), p[0]))
    cov = np.zeros(B, dtype=np.int64)
    kept = []
    for m, start, count in norm:
        if len(m) < 2 or count <= 0:
            continue
        if any(cov[b] != start for b in m):
            continue            # broken nesting (e.g. a shallower clamp)
        cap = min((int(ctx[b]) - 1) // tile_size for b in m) - start
        c = min(count, cap)
        if c <= 0:
            continue
        kept.append((m, start, c))
        for b in m:
            cov[b] = start + c
    if not kept:
        # degenerate geometry: one empty dummy pass (a single fully-masked
        # tile) keeps the phase shapes well-formed
        kept = [((), 0, 0)]

    def walk(c: int) -> int:
        n = max(c * tile_size, 1)
        return bucket_length(n, tile_size) if bucket else n

    kept.sort(key=lambda p: (walk(p[2]), len(p[0]), p[1], p[0]))
    pref_walk = [walk(c) for _, _, c in kept]
    suf = [int(ctx[b]) - int(cov[b]) * tile_size for b in range(B)]
    if bucket:
        suf_walk = [
            bucket_length(
                n, tile_size,
                None if max_len is None
                else max_len - int(cov[b]) * tile_size,
            )
            for b, n in enumerate(suf)
        ]
    else:
        suf_walk = suf
    return kept, cov, pref_walk, suf_walk


def _binding_from_structure(kept, cov, batch: int, tile_size: int) -> CascadeBinding:
    NP = len(kept)
    nmax = max([len(m) for m, _, _ in kept if m] or [1])
    members = np.full((NP, nmax), -1, dtype=np.int32)
    page_start = np.zeros(NP, dtype=np.int64)
    counts = np.zeros(NP, dtype=np.int64)
    levels = np.zeros(batch, dtype=np.int64)
    for j, (m, s, c) in enumerate(kept):
        members[j, : len(m)] = np.asarray(m, dtype=np.int32)
        page_start[j] = s
        counts[j] = c
        for b in m:
            levels[b] += 1
    return CascadeBinding(
        members=members,
        page_start=page_start.astype(np.int32),
        prefix_pages=counts.astype(np.int32),
        prefix_lens=(counts * tile_size).astype(np.int32),
        seq_prefix_pages=np.asarray(cov, dtype=np.int32),
        seq_prefix_len=(np.asarray(cov) * tile_size).astype(np.int32),
        num_levels=int(levels.max(initial=0)),
    )


def _cascade_schedule_from_walks(
    pref_walk, suf_walk, batch: int, num_passes: int, group_size: int,
    num_kv_heads: int, tile_size: int, num_workers: int,
) -> CascadeSchedule:
    """The one place a CascadeSchedule is assembled from resolved walks —
    shared by :func:`make_cascade_schedule` and the cache's miss path so
    cached and uncached schedules can never drift apart."""
    return CascadeSchedule(
        batch=batch,
        num_kv_heads=int(num_kv_heads),
        num_groups=num_passes,
        group_size=int(group_size),
        tile_size=int(tile_size),
        prefix_sched=make_schedule(
            pref_walk, num_kv_heads, tile_size, num_workers
        ),
        suffix_sched=make_schedule(
            suf_walk, num_kv_heads, tile_size, num_workers
        ),
    )


def make_cascade_schedule(
    ctx_lens: Sequence[int],
    groups: Sequence[Sequence[int]],
    prefix_pages: Sequence[int],
    num_kv_heads: int,
    tile_size: int,
    num_workers: int,
    *,
    page_starts: Optional[Sequence[int]] = None,
    max_len: Optional[int] = None,
    bucket: bool = True,
) -> Tuple[CascadeSchedule, CascadeBinding]:
    """Build the cascade (prefix-grouped) schedule and its runtime binding.

    Args:
      ctx_lens: full visible context per sequence (prefix + private tail).
      groups: grouped passes over ``range(len(ctx_lens))``. Unlike the
        original single-level form this need NOT partition the batch: a
        slot may appear in several nested passes (one per radix-trie
        level) or in none (pure-suffix decode). Single-member passes are
        dropped — a collapsed group IS vanilla decode.
      prefix_pages: page count of each pass; clamped so every member
        keeps >= 1 suffix token past its deepest coverage.
      page_starts: first shared page of each pass (default 0 everywhere —
        the single-level form). Nested passes must tile each member's
        coverage contiguously from page 0; passes breaking that (e.g.
        after a clamp upstream) are dropped.
      max_len: per-slot KV capacity in tokens (caps suffix buckets so the
        shifted suffix table walk never leaves the backing table row).
      bucket: round phase lengths to the canonical bucket lattice
        (:func:`bucket_length`) — runtime masking keeps results exact, and
        schedule signatures stay stable as sequences grow.
    """
    ctx = [int(n) for n in ctx_lens]
    if any(n <= 0 for n in ctx):
        raise ValueError("context lengths must be positive")
    if len(groups) != len(prefix_pages):
        raise ValueError("one prefix_pages entry per group required")
    starts = [0] * len(groups) if page_starts is None else list(page_starts)
    if len(starts) != len(groups):
        raise ValueError("one page_starts entry per group required")
    kept, cov, pref_walk, suf_walk = _resolve_cascade_structure(
        ctx, list(zip(groups, starts, prefix_pages)), tile_size,
        max_len, bucket,
    )
    binding = _binding_from_structure(kept, cov, len(ctx), tile_size)
    sched = _cascade_schedule_from_walks(
        pref_walk, suf_walk, len(ctx), len(kept),
        binding.members.shape[1], num_kv_heads, tile_size, num_workers,
    )
    return sched, binding


def cascade_fused_descriptors(
    csched: CascadeSchedule, binding: CascadeBinding
) -> np.ndarray:
    """Full ``(7, N)`` descriptor array for the fused cascade kernel.

    ``N = fused_grid_iters``: the static partial-phase section
    (:meth:`CascadeSchedule.fused_partial_descriptors`) followed by the
    merge section built from this tick's *binding*. Merge iteration rows:
    SEG = target output segment (``b * H_kv + h``; the garbage row
    ``B * H_kv`` for padding ranks), TILE = member rank (the kernel reads
    partial rows ``[rank * g, (rank + 1) * g)``), PIECE = combined piece
    row, FIRST/LAST flag each target's contribution run, VALID = 2.

    Per-target order is deterministic — shallow pass first, suffix last —
    so equal bindings produce identical merge fp sequences (the
    shared-vs-duplicated-pages bit-identity contract). The array is a
    *runtime* operand of the kernel: its values change freely tick to
    tick, only its (schedule-determined) shape is static.
    """
    H = csched.num_kv_heads
    B = csched.batch
    S = B * H
    Pp = csched.prefix_sched.num_pieces
    Ptot = csched.num_pieces_total
    M = csched.fused_merge_iters
    pstarts, pcnts = csched.prefix_sched.piece_ranges()
    sstarts, scnts = csched.suffix_sched.piece_ranges()
    mem = binding.members
    NP, nmax = mem.shape
    # slot -> [(pass j, rank i)] ordered shallow-first
    slot_passes: dict = {}
    for j in range(NP):
        for i in range(nmax):
            b = int(mem[j, i])
            if b >= 0:
                slot_passes.setdefault(b, []).append((int(binding.page_start[j]), j, i))
    merge = np.zeros((7, M), dtype=np.int32)
    col = 0
    for b in range(B):
        ranks = sorted(slot_passes.get(b, []))
        for h in range(H):
            cols = []
            for _, j, i in ranks:
                sp = j * H + h
                for p in range(int(pstarts[sp]), int(pstarts[sp] + pcnts[sp])):
                    cols.append((p, i))
            s = b * H + h
            for p in range(int(sstarts[s]), int(sstarts[s] + scnts[s])):
                cols.append((Pp + p, 0))
            for k, (p, rank) in enumerate(cols):
                merge[0, col] = s
                merge[1, col] = rank
                merge[2, col] = p
                merge[3, col] = 1 if k == 0 else 0
                merge[4, col] = 1 if k == len(cols) - 1 else 0
                merge[6, col] = 2
                col += 1
    # padding-rank fills: self-contained garbage merges (write the garbage
    # output row from the garbage partial row; sliced off by the caller)
    merge[0, col:] = S
    merge[2, col:] = Ptot
    merge[3, col:] = 1
    merge[4, col:] = 1
    merge[6, col:] = 2
    return np.ascontiguousarray(
        np.concatenate([csched.fused_partial_descriptors(), merge], axis=1)
    )


# --------------------------------------------------------------- bucketing
def bucket_length(n: int, tile_size: int, max_len: Optional[int] = None) -> int:
    """Round a context length up to a canonical bucket.

    Buckets are "power-of-two-ish" tile counts — {1, 2, 3, 4, 6, 8, 12,
    16, ...} tiles, i.e. powers of two plus their midpoints — so the number
    of distinct buckets below any capacity C is O(log C), yet rounding never
    wastes more than ~33% of KV tiles. A decode slot crosses a bucket
    boundary only every ~len/3 generated tokens, which is what lets the
    schedule cache (and the per-signature jit cache above it) hit on nearly
    every tick.

    The *bucketed* length drives the schedule's tile walk; the kernels mask
    with the *true* lengths passed at runtime, so bucketing never changes
    results — only how many (fully masked) tail tiles a schedule carries.

    ``max_len`` (e.g. the padded KV-cache capacity) caps the bucket so the
    kernel never indexes tiles beyond the backing buffer.
    """
    if n <= 0:
        raise ValueError("context length must be positive")
    if max_len is not None:
        # capacity-clamp the length itself, not just the bucket: a request
        # longer than the KV buffer can only ever attend to what the buffer
        # holds, and an unclamped n with a clamped bucket would silently
        # under-cover (schedule walks fewer tokens than seg_ctx claims)
        n = min(n, max_len)
    tiles = -(-n // tile_size)
    b = 1
    while b < tiles:
        b *= 2
    # midpoint bucket: 3 * 2^k sits between 2^k+1 and 2^(k+1)
    if b > 2 and 3 * (b // 4) >= tiles:
        b = 3 * (b // 4)
    if max_len is not None:
        # ceil: the KV buffer is always padded UP to a tile multiple, so a
        # non-multiple capacity still owns its partial last tile (a floor
        # here would silently drop real tokens from the schedule walk)
        b = min(b, max(1, -(-max_len // tile_size)))
    return b * tile_size


def bucket_ctx_lens(
    ctx_lens: Sequence[int], tile_size: int, max_len: Optional[int] = None
) -> Tuple[int, ...]:
    """Bucket every ragged length (see :func:`bucket_length`)."""
    return tuple(bucket_length(int(n), tile_size, max_len) for n in ctx_lens)


# ----------------------------------------------------------- schedule cache
@dataclass
class ScheduleCacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def as_dict(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "hit_rate": self.hit_rate,
        }


class ScheduleCache:
    """Memoized stream-K schedules over bucketed ragged lengths.

    ``get`` buckets the exact per-batch context lengths to canonical shapes
    (:func:`bucket_length`), then returns the memoized
    :class:`LeanSchedule` for the bucketed signature — building it with
    :func:`make_schedule` only on a miss. Because the returned instance is
    *the same object* tick after tick (and hashes by content besides), any
    ``jax.jit`` keyed on it as a static argument also hits its trace cache.
    Packed kernel descriptors memoize on the schedule itself
    (:meth:`LeanSchedule.packed_descriptors`), so a steady-state decode
    tick performs zero numpy schedule work.

    LRU-bounded: at most ``max_entries`` signatures are kept (the bucket
    lattice keeps the live set small, but admission churn could otherwise
    grow it without bound).
    """

    def __init__(self, max_entries: int = 128):
        self.max_entries = max_entries
        self.stats = ScheduleCacheStats()
        self._entries: "OrderedDict[tuple, LeanSchedule]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def get(
        self,
        ctx_lens: Sequence[int],
        num_kv_heads: int,
        tile_size: int,
        num_workers: int,
        max_len: Optional[int] = None,
    ) -> LeanSchedule:
        lens = bucket_ctx_lens(ctx_lens, tile_size, max_len)
        key = (lens, int(num_kv_heads), int(tile_size), int(num_workers))
        sched = self._entries.get(key)
        if sched is not None:
            self.stats.hits += 1
            self._entries.move_to_end(key)
            return sched
        self.stats.misses += 1
        sched = make_schedule(lens, num_kv_heads, tile_size, num_workers)
        # pre-pack both descriptor layouts (and the paged-routing metadata)
        # so the miss pays all numpy cost
        sched.packed_descriptors()
        sched.fused_descriptors()
        sched.iter_kv_meta(fused=False)
        sched.iter_kv_meta(fused=True)
        self._entries[key] = sched
        if len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)
            self.stats.evictions += 1
        return sched

    def get_cascade(
        self,
        ctx_lens: Sequence[int],
        groups: Sequence[Sequence[int]],
        prefix_pages: Sequence[int],
        num_kv_heads: int,
        tile_size: int,
        num_workers: int,
        max_len: Optional[int] = None,
        page_starts: Optional[Sequence[int]] = None,
    ) -> Tuple["CascadeSchedule", "CascadeBinding"]:
        """Memoized :func:`make_cascade_schedule` (the schedule half — the
        binding is rebuilt every call, it is cheap host numpy).

        The key is the *canonical geometry*: bucketed suffix lengths plus
        the clamped passes' (bucketed walk, member count) multiset — NO
        member ids. Two groupings that differ only in which slots sit
        where (equivalent geometries) therefore share one schedule entry,
        and — because every member-dependent value rides in the binding as
        a runtime operand — one jit trace.
        """
        ctx = [int(n) for n in ctx_lens]
        starts = [0] * len(groups) if page_starts is None else list(page_starts)
        kept, cov, pref_walk, suf_walk = _resolve_cascade_structure(
            ctx, list(zip(groups, starts, prefix_pages)), tile_size,
            max_len, True,
        )
        binding = _binding_from_structure(kept, cov, len(ctx), tile_size)
        key = (
            "cascade2", tuple(suf_walk),
            tuple((w, len(m)) for w, (m, _, _) in zip(pref_walk, kept)),
            int(binding.members.shape[1]), int(num_kv_heads),
            int(tile_size), int(num_workers),
        )
        sched = self._entries.get(key)
        if sched is not None:
            self.stats.hits += 1
            self._entries.move_to_end(key)
            return sched, binding
        self.stats.misses += 1
        sched = _cascade_schedule_from_walks(
            pref_walk, suf_walk, len(ctx), len(kept),
            binding.members.shape[1], num_kv_heads, tile_size, num_workers,
        )
        # pre-pack everything the kernels read so the miss pays all numpy
        sched.prefix_sched.packed_descriptors()
        sched.suffix_sched.packed_descriptors()
        sched.prefix_sched.iter_kv_meta(fused=False)
        sched.suffix_sched.iter_kv_meta(fused=False)
        sched.prefix_sched.piece_ranges()
        sched.suffix_sched.piece_ranges()
        sched.fused_partial_descriptors()
        self._entries[key] = sched
        if len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)
            self.stats.evictions += 1
        return sched, binding

    def clear(self) -> None:
        self._entries.clear()
        self.stats = ScheduleCacheStats()


def fixed_split_factor(
    ctx_len: int, num_segments: int, tile_size: int, num_workers: int
) -> int:
    """FlashDecoding's heuristic: pick the smallest split factor s such that
    ``num_segments * s`` covers the workers, capped by tiles available.
    (Used by the fixed-split baseline and the occupancy model.)"""
    tiles = -(-ctx_len // tile_size)
    s = 1
    while num_segments * s < num_workers and s < tiles:
        s += 1
    return min(s, tiles)
