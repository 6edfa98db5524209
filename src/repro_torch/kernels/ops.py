"""Public entry points for decode and chunked-prefill attention (port of
``repro.kernels.ops`` without the cascade kind).

``decode(q, kv, plan=DecodePlan(...), ctx=..., page_tbl=..., qstart=...)``
is the one dispatcher; the convenience functions build a plan and delegate,
as in the reference. Plan kinds:

  * ``'dense'`` / ``'paged'``: stream-K decode. ``fused=True`` runs K2
    (partials and merge in one launch); ``fused=False`` runs K1 followed by
    :func:`segment_merge`.
  * ``'verify'``: multi-query-row paged attention with a runtime causal
    offset -- a chunked-prefill pack (:func:`lean_prefill_chunks`): K4
    partials, then :func:`segment_merge`.
  * ``'flash'``: the fixed-split FlashDecoding baseline over dense KV
    (:func:`flash_decode_from_lens`): K6 partials, then :func:`merge_n`.

The reference
falls back from its fused kernel to the two-phase path when a schedule
exceeds a TPU VMEM budget (``FUSED_VMEM_BUDGET``); K2 keeps its partials in
global scratch and has no such budget, so here ``fused`` alone decides.

Dense KV runs the same kernels as paged KV: a dense ``(B*Hkv, S_pad, d)``
cache is already a pool of ``(B*Hkv*S_pad/tile)`` rows of ``(tile, d)``,
routed by ``seg * (S_pad/tile) + tile``. Dense and paged decode of equal
logical inputs therefore run the identical op sequence and agree bit for bit
(the reference's promise, ``repro/kernels/lean_decode.py:523-532``).

The schedule is built on the host from host context lengths, as in the
paper; ``seg_ctx`` carries the true lengths at run time and the kernels mask
with it, which is what keeps bucketed (cached) schedules exact.
"""
from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.leantile import (
    LeanSchedule,
    ScheduleCache,
    default_tile_size,
    fixed_split_factor,
    make_schedule,
)
from repro_torch.core.merge import AttnPartial, finalize, merge_n, segment_merge
from .flash_decode import flash_decode_partials
from .lean_prefill import lean_prefill_chunk_partials
from .lean_decode import (
    DESC_SEG,
    DESC_TILE,
    DESC_VALID,
    OP_PARTIAL,
    lean_decode_fused,
    lean_decode_partials,
    schedule_tensors,
)

__all__ = [
    "DecodePlan",
    "decode",
    "lean_decode",
    "lean_decode_from_schedule",
    "lean_decode_paged",
    "lean_decode_paged_from_schedule",
    "lean_prefill_chunks",
    "flash_decode",
    "flash_decode_from_lens",
    "default_num_workers",
]

_PLAN_KINDS = ("dense", "paged", "flash", "verify")
# plan kinds of the reference not ported yet, with their ROADMAP item
_LATER_KINDS = {
    "cascade": "ROADMAP queue 1, item 8 (cascade, kernel K5)",
}


def _clamp_ctx_lens(ctx_lens: Sequence[int], caps, what: str):
    """Clamp per-sequence context lengths to their capacity, *loudly*.

    ``caps`` is a scalar (dense capacity) or per-sequence (paged: allocated
    pages * page_size). Overflow warns instead of truncating silently.
    """
    n = len(ctx_lens)
    caps = [int(caps)] * n if np.ndim(caps) == 0 else [int(c) for c in caps]
    clamped = [min(int(c), cap) for c, cap in zip(ctx_lens, caps)]
    over = [
        (i, int(c), cap)
        for i, (c, cap) in enumerate(zip(ctx_lens, caps))
        if int(c) > cap
    ]
    if over:
        warnings.warn(
            f"{what}: context length exceeds KV capacity for sequences "
            f"{[(i, c, cap) for i, c, cap in over[:8]]}"
            f"{'...' if len(over) > 8 else ''} — clamping (attention only "
            "covers the stored tokens)",
            RuntimeWarning,
            stacklevel=3,
        )
    return clamped


def default_num_workers(n_cores: int = 8, pipeline_factor: int = 2) -> int:
    """The reference's TPU worker count (cores x pipeline factor), kept so
    that schedules match the reference's. On the H100 pass the grid of the
    paper, one worker per SM (``multi_processor_count``), explicitly."""
    return n_cores * pipeline_factor


def _to_segments(q, k, v):
    """``(B, Hq, d)``, ``(B, Hkv, S, d)`` -> segment-major views ``(B*Hkv,
    g, d)`` and ``(B*Hkv, S, d)`` (the paper's constant-stride layout)."""
    B, Hq, d = q.shape
    _, Hkv, S, _ = k.shape
    return (q.reshape(B * Hkv, Hq // Hkv, d), k.reshape(B * Hkv, S, d),
            v.reshape(B * Hkv, S, d))


def _pad_kv(k_seg, v_seg, tile: int):
    """Pad the KV axis to a multiple of ``tile`` with zeros."""
    pad = (-k_seg.shape[1]) % tile
    if pad:
        k_seg = torch.nn.functional.pad(k_seg, (0, 0, 0, pad))
        v_seg = torch.nn.functional.pad(v_seg, (0, 0, 0, pad))
    return k_seg, v_seg


@dataclass(frozen=True)
class DecodePlan:
    """Which kernel family, which schedule, which flags: one hashable key.

    kind:
      * ``'dense'``  -- stream-K decode over dense per-slot KV
      * ``'paged'``  -- stream-K decode through a page table
      * ``'flash'``  -- fixed-split FlashDecoding baseline (``num_splits``
        and ``tile``, no schedule)
      * ``'verify'`` -- ``spec_rows`` stacked query rows per sequence
        through a page table, against a chunk schedule with a runtime causal
        offset: a chunked-prefill pack (speculative verify, the same
        workload, is ROADMAP queue 1, item 10).

    The reference's ``'cascade'`` kind raises ``NotImplementedError`` naming
    its ROADMAP item. The reference's ``merge_impl`` is not a field: its
    alternative picks the merge kernel K3, which is not ported, so the only
    merge is :func:`segment_merge`.
    """

    kind: str
    sched: Optional[LeanSchedule] = None
    fused: bool = True
    return_lse: bool = False
    num_splits: Optional[int] = None      # flash only
    tile: Optional[int] = None            # flash only
    spec_rows: int = 0                    # verify only: q rows per sequence

    def __post_init__(self):
        if self.kind in _LATER_KINDS:
            raise NotImplementedError(
                f"plan kind {self.kind!r} is not ported yet: {_LATER_KINDS[self.kind]}"
            )
        if self.kind not in _PLAN_KINDS:
            raise ValueError(f"unknown plan kind {self.kind!r} (one of {_PLAN_KINDS})")
        if self.kind == "flash":
            if self.num_splits is None or self.tile is None:
                raise ValueError("flash plans need num_splits and tile")
        elif self.sched is None:
            raise ValueError(f"{self.kind!r} plans need a schedule")
        if self.kind == "verify" and self.spec_rows < 1:
            raise ValueError("verify plans need spec_rows >= 1")


def decode(
    q: torch.Tensor,
    kv: Tuple[torch.Tensor, torch.Tensor],
    *,
    plan: DecodePlan,
    ctx: torch.Tensor,
    page_tbl: Optional[torch.Tensor] = None,
    qstart: Optional[torch.Tensor] = None,
):
    """The one decode dispatcher: ``plan`` picks the kernel family, the
    tensors ride alongside. ``kv`` is dense per-slot ``(k, v)`` for
    ``'dense'``/``'flash'`` plans and the page pools for
    ``'paged'``/``'verify'``. ``ctx`` carries the runtime lengths: the
    per-segment context ``(B*Hkv,)`` for decode kinds, the visible KV
    (offset + chunk length) for ``'verify'``. ``qstart`` (verify only) is
    the per-segment absolute position of query row 0."""
    k, v = kv
    if plan.kind == "dense":
        return _dense_decode_impl(q, k, v, ctx, plan)
    if plan.kind == "flash":
        return _flash_decode_impl(q, k, v, ctx, plan)
    if page_tbl is None:
        raise ValueError(f"{plan.kind!r} plans need page_tbl")
    if plan.kind == "paged":
        return _paged_decode_impl(q, k, v, ctx, page_tbl, plan)
    if qstart is None:
        raise ValueError("verify plans need qstart")
    return _verify_impl(q, k, v, ctx, qstart, page_tbl, plan)


def _run(q_seg, k_rows, v_rows, seg_ctx, route, plan: DecodePlan):
    """K2, or K1 + segment_merge, at scale 1/sqrt(d). Returns
    (o_seg (S, gq, d), lse (S, gq))."""
    sched = plan.sched
    scale = 1.0 / math.sqrt(q_seg.shape[-1])
    if plan.fused:
        return lean_decode_fused(q_seg, k_rows, v_rows, seg_ctx, route, sched, scale)
    o_p, m_p, l_p = lean_decode_partials(q_seg, k_rows, v_rows, seg_ctx, route, sched, scale)
    seg = segment_merge(
        AttnPartial(o=o_p, m=m_p, l=l_p),
        schedule_tensors(sched, o_p.device)["piece_seg"],
        sched.num_segments,
    )
    return finalize(seg), seg.m + torch.log(seg.l)


def _finish(o_seg, lse, q, plan: DecodePlan):
    B, Hq, d = q.shape
    out = o_seg.reshape(B, Hq, d).to(q.dtype)
    if plan.return_lse:
        return out, lse.reshape(B, Hq)
    return out


def _dense_route(sched: LeanSchedule, s_pad: int, device) -> torch.Tensor:
    """Pool row of each descriptor column when the dense cache is read as
    rows of tiles: ``seg * (s_pad / tile) + tile`` (padding columns -> 0)."""
    st = schedule_tensors(sched, device)
    desc = st["desc"]
    seg, tile, valid = desc[DESC_SEG], desc[DESC_TILE], desc[DESC_VALID]
    route = seg * (s_pad // sched.tile_size) + tile
    return torch.where(valid == OP_PARTIAL, route, torch.zeros_like(route)).contiguous()


def _dense_decode_impl(q, k, v, seg_ctx, plan: DecodePlan):
    sched = plan.sched
    tile = sched.tile_size
    q_seg, k_seg, v_seg = _to_segments(q, k, v)
    k_seg, v_seg = _pad_kv(k_seg, v_seg, tile)
    S_seg, s_pad, d = k_seg.shape
    if int(sched.seg_len.max(initial=0)) > s_pad:
        # the kernels read every scheduled tile: one past the cache would
        # read another segment's rows, or past the buffer
        raise ValueError(
            f"schedule walks {int(sched.seg_len.max())} tokens, the cache holds {s_pad}"
        )
    k_rows = k_seg.contiguous().view(S_seg * s_pad // tile, tile, d)
    v_rows = v_seg.contiguous().view(S_seg * s_pad // tile, tile, d)
    route = _dense_route(sched, s_pad, q.device)
    o_seg, lse = _run(
        q_seg.contiguous(), k_rows, v_rows, seg_ctx.to(torch.int32).contiguous(), route, plan,
    )
    return _finish(o_seg, lse, q, plan)


def _paged_route(sched: LeanSchedule, page_tbl: torch.Tensor, num_kv_heads: int) -> torch.Tensor:
    """Per-column flattened pool row ``page * H_kv + head``. The schedule
    gives the logical routing (batch, head, tile per column); the runtime
    page table gives the physical page. Padding columns, and tiles past the
    table width (which the runtime length always masks), route to the null
    page's rows."""
    st = schedule_tensors(sched, page_tbl.device)
    width = page_tbl.shape[1]
    pages = page_tbl[st["kv_batch"], st["kv_tile"].clamp(max=width - 1)].to(torch.int32)
    pages = torch.where(st["kv_ok"], pages, torch.zeros_like(pages))
    return (pages * num_kv_heads + st["kv_head"]).contiguous()


def _pool_rows(k_pool, v_pool):
    """(page, head) flatten: one pool row is one head's page. A view."""
    num_pages, Hkv, page_size, d = k_pool.shape
    return (
        k_pool.view(num_pages * Hkv, page_size, d),
        v_pool.view(num_pages * Hkv, page_size, d),
    )


def _paged_decode_impl(q, k_pool, v_pool, seg_ctx, page_tbl, plan: DecodePlan):
    B, Hq, d = q.shape
    num_pages, Hkv, page_size, _ = k_pool.shape
    sched = plan.sched
    if page_size != sched.tile_size:
        raise ValueError(
            f"page_size {page_size} != schedule tile_size {sched.tile_size}"
            " — lean tiles must map 1:1 onto pages"
        )
    gq = Hq // Hkv
    k_rows, v_rows = _pool_rows(k_pool, v_pool)
    route = _paged_route(sched, page_tbl, Hkv)
    o_seg, lse = _run(
        q.reshape(B * Hkv, gq, d).contiguous(), k_rows, v_rows,
        seg_ctx.to(torch.int32).contiguous(), route, plan,
    )
    return _finish(o_seg, lse, q, plan)


def lean_decode_from_schedule(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    seg_ctx: torch.Tensor,            # (B*Hkv,) int32 true context lengths
    sched: LeanSchedule,
    *,
    fused: bool = True,
    return_lse: bool = False,
):
    """Stream-K decode over dense KV ``(B, Hkv, S, d)`` against a prebuilt
    schedule (whose walk must cover ``seg_ctx``). Thin wrapper over
    :func:`decode` with a ``'dense'`` plan."""
    plan = DecodePlan(kind="dense", sched=sched, fused=fused, return_lse=return_lse)
    return decode(q, (k, v), plan=plan, ctx=seg_ctx)


def lean_decode(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    ctx_lens: Optional[Sequence[int]] = None,
    *,
    num_workers: Optional[int] = None,
    tile: Optional[int] = None,
    fused: bool = False,
    schedule_cache: Optional[ScheduleCache] = None,
    return_lse: bool = False,
):
    """LeanAttention decode: exact attention, stream-K partitioned.

    q: (B, Hq, d); k, v: (B, Hkv, S, d); ctx_lens: host ints per batch row.
    ``schedule_cache`` buckets the lengths and memoizes the schedule;
    without one an exact schedule is built per call.
    """
    B, Hq, d = q.shape
    _, Hkv, S, _ = k.shape
    if ctx_lens is None:
        ctx_lens = [S] * B
    ctx_lens = _clamp_ctx_lens(ctx_lens, S, "lean_decode")
    tile = tile or default_tile_size(d)
    tile = min(tile, max(8, S))
    num_workers = num_workers or default_num_workers()
    if schedule_cache is not None:
        s_pad = S + ((-S) % tile)
        sched = schedule_cache.get(ctx_lens, Hkv, tile, num_workers, max_len=s_pad)
    else:
        sched = make_schedule(ctx_lens, Hkv, tile, num_workers)
    seg_ctx = torch.as_tensor(
        np.repeat(np.asarray(ctx_lens), Hkv), dtype=torch.int32
    ).to(q.device)
    return lean_decode_from_schedule(q, k, v, seg_ctx, sched, fused=fused, return_lse=return_lse)


def lean_decode_paged_from_schedule(
    q: torch.Tensor,                  # (B, Hq, d)
    k_pool: torch.Tensor,             # (num_pages, Hkv, page_size, d)
    v_pool: torch.Tensor,
    seg_ctx: torch.Tensor,            # (B*Hkv,) int32 true context lengths
    page_tbl: torch.Tensor,           # (B, pages_per_seq) int32 physical pages
    sched: LeanSchedule,
    *,
    fused: bool = True,
    return_lse: bool = False,
):
    """Paged stream-K decode against a prebuilt schedule
    (``sched.tile_size`` must equal the pool's page size; every id in
    ``page_tbl`` must index the pools -- the kernels trust it, checking it
    here would cost a device sync per call). Runs the same op sequence as
    the dense path: on equal logical inputs the outputs are bit-identical.
    Thin wrapper over :func:`decode` with a ``'paged'`` plan.
    """
    plan = DecodePlan(kind="paged", sched=sched, fused=fused, return_lse=return_lse)
    return decode(q, (k_pool, v_pool), plan=plan, ctx=seg_ctx, page_tbl=page_tbl)


def lean_decode_paged(
    q: torch.Tensor,                  # (B, Hq, d)
    k_pool: torch.Tensor,             # (num_pages, Hkv, page_size, d)
    v_pool: torch.Tensor,
    page_tbl,                         # (B, pages_per_seq) int32 (host or device)
    ctx_lens: Sequence[int],
    *,
    num_workers: Optional[int] = None,
    fused: bool = True,
    schedule_cache: Optional[ScheduleCache] = None,
    return_lse: bool = False,
):
    """Convenience paged decode: builds (or cache-fetches) the schedule from
    host context lengths, then runs :func:`lean_decode_paged_from_schedule`.

    Lengths clamp, with a warning, to each sequence's allocated capacity:
    its non-null table entries (page 0 is the null page) times the page
    size.
    """
    B, Hq, d = q.shape
    num_pages, Hkv, page_size, _ = k_pool.shape
    ptbl_np = (
        page_tbl.cpu().numpy() if isinstance(page_tbl, torch.Tensor)
        else np.asarray(page_tbl)
    )
    if ptbl_np.shape[0] != B:
        raise ValueError("page table rows must match the batch")
    if ptbl_np.size and (ptbl_np.min() < 0 or ptbl_np.max() >= num_pages):
        raise ValueError(f"page table holds page ids outside [0, {num_pages})")
    page_counts = (ptbl_np != 0).sum(axis=1)
    ctx_lens = _clamp_ctx_lens(ctx_lens, page_counts * page_size, "lean_decode_paged")
    ctx_lens = [max(1, c) for c in ctx_lens]        # schedule needs >= 1
    num_workers = num_workers or default_num_workers()
    max_len = ptbl_np.shape[1] * page_size
    if schedule_cache is not None:
        sched = schedule_cache.get(ctx_lens, Hkv, page_size, num_workers, max_len=max_len)
    else:
        sched = make_schedule(ctx_lens, Hkv, page_size, num_workers)
    seg_ctx = torch.as_tensor(
        np.repeat(np.asarray(ctx_lens), Hkv), dtype=torch.int32
    ).to(q.device)
    tbl = torch.as_tensor(ptbl_np, dtype=torch.int32).to(q.device)
    return lean_decode_paged_from_schedule(
        q, k_pool, v_pool, seg_ctx, tbl, sched, fused=fused, return_lse=return_lse,
    )


def lean_prefill_chunks(
    q: torch.Tensor,                  # (N, Hq, C, d) one prompt chunk per row
    k_pool: torch.Tensor,             # (num_pages, Hkv, page_size, d)
    v_pool: torch.Tensor,
    seg_ctx: torch.Tensor,            # (N*Hkv,) int32 visible KV (off + len)
    seg_qstart: torch.Tensor,         # (N*Hkv,) int32 chunk start offsets
    page_tbls: torch.Tensor,          # (N, W) int32 page table rows
    sched: LeanSchedule,
):
    """Stream-K chunked prefill against a prebuilt chunk schedule
    (:func:`repro_torch.core.leantile.make_chunk_schedule` over the pack's
    visible KV lengths). ``seg_ctx``, ``seg_qstart`` and ``page_tbls`` are
    runtime tensors, so one bucketed schedule serves a request at every
    depth of its prompt. Two-phase: K4 partials, then the decode merge
    (partials carry ``g * C`` rows per segment instead of ``g``). Returns
    ``(N, Hq, C, d)`` in q's dtype.

    Thin wrapper over :func:`decode` with a ``'verify'`` plan (``spec_rows
    = C``).
    """
    plan = DecodePlan(kind="verify", sched=sched, spec_rows=q.shape[2])
    return decode(q, (k_pool, v_pool), plan=plan, ctx=seg_ctx, page_tbl=page_tbls,
                  qstart=seg_qstart)


def _verify_impl(q, k_pool, v_pool, seg_ctx, seg_qstart, page_tbls, plan: DecodePlan):
    N, Hq, C, d = q.shape
    num_pages, Hkv, page_size, _ = k_pool.shape
    sched = plan.sched
    if page_size != sched.tile_size:
        raise ValueError(
            f"page_size {page_size} != schedule tile_size {sched.tile_size}"
            " — lean tiles must map 1:1 onto pages"
        )
    if C != plan.spec_rows:
        raise ValueError(f"q carries {C} rows per sequence, plan says {plan.spec_rows}")
    g = Hq // Hkv
    scale = 1.0 / math.sqrt(d)
    q_seg = q.reshape(N, Hkv, g, C, d).reshape(N * Hkv, g * C, d).contiguous()
    k_rows, v_rows = _pool_rows(k_pool, v_pool)
    route = _paged_route(sched, page_tbls, Hkv)
    o_p, m_p, l_p = lean_prefill_chunk_partials(
        q_seg, k_rows, v_rows, seg_ctx.to(torch.int32).contiguous(),
        seg_qstart.to(torch.int32).contiguous(), route, sched, scale, chunk_cap=C,
    )
    seg = segment_merge(
        AttnPartial(o=o_p, m=m_p, l=l_p),
        schedule_tensors(sched, o_p.device)["piece_seg"],
        sched.num_segments,
    )
    return finalize(seg).reshape(N, Hq, C, d).to(q.dtype)


def flash_decode_from_lens(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    seg_ctx: torch.Tensor,            # (B*Hkv,) int32 true context lengths
    *,
    num_splits: int,
    tile: int,
):
    """The FlashDecoding baseline with runtime lengths and a fixed split:
    ``q (B, Hq, d)``, dense ``k, v (B, Hkv, S, d)``. Thin wrapper over
    :func:`decode` with a ``'flash'`` plan."""
    plan = DecodePlan(kind="flash", num_splits=num_splits, tile=tile)
    return decode(q, (k, v), plan=plan, ctx=seg_ctx)


def _flash_decode_impl(q, k, v, seg_ctx, plan: DecodePlan):
    B, Hq, d = q.shape
    q_seg, k_seg, v_seg = _to_segments(q, k, v)
    k_seg, v_seg = _pad_kv(k_seg, v_seg, plan.tile)
    o_p, m_p, l_p = flash_decode_partials(
        q_seg.contiguous(), k_seg.contiguous(), v_seg.contiguous(),
        seg_ctx.to(torch.int32).contiguous(), plan.num_splits, plan.tile, 1.0 / math.sqrt(d),
    )
    part = AttnPartial(o=o_p.movedim(1, 0), m=m_p.movedim(1, 0), l=l_p.movedim(1, 0))
    out = finalize(merge_n(part))
    return out.reshape(B, Hq, d).to(q.dtype)


def flash_decode(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    ctx_lens: Optional[Sequence[int]] = None,
    *,
    num_splits: Optional[int] = None,
    num_workers: Optional[int] = None,
    tile: Optional[int] = None,
):
    """FlashDecoding baseline: fixed-split partitioning + merge.
    ``num_splits=None`` applies FlashDecoding's heuristic, the smallest
    split factor that covers the workers (paper section III-C, Fig. 1)."""
    B, Hq, d = q.shape
    _, Hkv, S, _ = k.shape
    if ctx_lens is None:
        ctx_lens = [S] * B
    ctx_lens = _clamp_ctx_lens(ctx_lens, S, "flash_decode")
    tile = tile or default_tile_size(d)
    tile = min(tile, max(8, S))
    if num_splits is None:
        num_workers = num_workers or default_num_workers()
        num_splits = fixed_split_factor(max(ctx_lens), B * Hkv, tile, num_workers)
    seg_lens = torch.as_tensor(
        np.repeat(np.asarray(ctx_lens), Hkv), dtype=torch.int32
    ).to(q.device)
    return flash_decode_from_lens(q, k, v, seg_lens, num_splits=num_splits, tile=tile)
