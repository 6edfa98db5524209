"""Public entry points for decode and chunked-prefill attention (port of
``repro.kernels.ops``).

``decode(q, kv, plan=DecodePlan(...), ctx=..., page_tbl=..., qstart=...,
cascade=...)`` is the one dispatcher; the convenience functions build a plan
and delegate, as in the reference. Plan kinds:

  * ``'dense'`` / ``'paged'``: stream-K decode. ``fused=True`` runs K2
    (partials and merge in one launch); ``fused=False`` runs K1 followed by
    the two-phase merge.
  * ``'cascade'``: prefix-grouped decode over shared pages
    (:func:`lean_decode_cascade`). ``fused=True`` runs K5 (grouped prefix
    pass, suffix pass and merge in one launch); ``fused=False`` runs K1 on
    each pass, then :func:`segment_merge`.
  * ``'verify'``: multi-query-row paged attention with a runtime causal
    offset -- a chunked-prefill pack (:func:`lean_prefill_chunks`).
    ``fused=True`` runs the fused K4 (stream-K pieces and their merge in one
    launch, on the tensor cores for bf16 queries at the kernel's head dims
    and pages); ``fused=False`` runs K4 partials, then the two-phase merge.
    As for ``'paged'`` plans, ``fused`` takes precedence over
    ``merge_impl``. (The reference ignores ``fused`` for verify plans and
    always runs its partials kernel and merge.)
  * ``'flash'``: the fixed-split FlashDecoding baseline over dense KV
    (:func:`flash_decode_from_lens`): K6 partials, then :func:`merge_n`.

The two-phase merge is the plan's ``merge_impl``: ``"xla"`` (the default)
runs :func:`segment_merge`, ``"pallas"`` the merge kernel K3
(:func:`repro_torch.kernels.lean_decode.lean_merge`). The values keep the
reference's names, so that a plan reads the same in both packages.

The reference falls back from its fused kernels (K2, K5) to the two-phase
paths when a schedule exceeds a TPU VMEM budget (``FUSED_VMEM_BUDGET``,
``cascade_fused_vmem_bytes``); K2 and K5 keep their partials in global
scratch and have no such budget, so here ``fused`` alone decides.

Dense KV runs the same kernels as paged KV: a dense ``(B*Hkv, S_pad, d)``
cache is already a pool of ``(B*Hkv*S_pad/tile)`` rows of ``(tile, d)``,
routed by ``seg * (S_pad/tile) + tile``. Dense and paged decode of equal
logical inputs therefore run the identical op sequence and agree bit for bit
(the reference's promise, ``repro/kernels/lean_decode.py:523-532``).

int8 pools: the ``'paged'``, ``'cascade'`` and ``'verify'`` plans take
``k_scales``/``v_scales`` ``(num_pages, Hkv)`` float32 beside int8 pools,
and the kernels dequantize each routed tile with its pool row's scale (the
reference's ``repro/kernels/ops.py:467-514``). The reference's fused budget
differs for int8 (``kv_elem_bytes=1``); here, again, ``fused`` alone
decides.

f8 pools and caches (``float8_e4m3fn``, no scales) go to every kernel as
they are: K1, K2, K5 and K6 read e4m3 rows on the decode ring, the fused K4
and K8 stage them for the tensor cores, widening in-register; the plain
versions widen to bf16 first.

The schedule is built on the host from host context lengths, as in the
paper; ``seg_ctx`` carries the true lengths at run time and the kernels mask
with it, which is what keeps bucketed (cached) schedules exact.
"""
from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.leantile import (
    CascadeBinding,
    CascadeSchedule,
    LeanSchedule,
    ScheduleCache,
    cascade_fused_descriptors,
    default_tile_size,
    fixed_split_factor,
    make_cascade_schedule,
    make_schedule,
)
from repro_torch.core.attention import kv_bytes
from repro_torch.core.merge import AttnPartial, MergeGrid, finalize, merge_n, segment_merge
from .flash_decode import flash_decode_partials
from .lean_prefill import lean_prefill_chunk_partials, lean_prefill_fused
from .lean_decode import (
    DESC_SEG,
    DESC_TILE,
    DESC_VALID,
    OP_PARTIAL,
    CascadeFusedDesc,
    cascade_fused_desc,
    lean_cascade_fused,
    lean_decode_fused,
    lean_decode_partials,
    lean_merge,
    schedule_memo,
    schedule_tensors,
)

__all__ = [
    "CascadeOperands",
    "CascadeRouting",
    "DecodePlan",
    "decode",
    "cascade_merge_ids",
    "cascade_routing",
    "cascade_tables",
    "paged_route",
    "lean_decode",
    "lean_decode_cascade",
    "lean_decode_cascade_from_schedule",
    "lean_decode_from_schedule",
    "lean_decode_paged",
    "lean_decode_paged_from_schedule",
    "lean_prefill_chunks",
    "flash_decode",
    "flash_decode_from_lens",
    "default_num_workers",
]

_PLAN_KINDS = ("dense", "paged", "cascade", "flash", "verify")
_MERGE_IMPLS = ("xla", "pallas")


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
    """Pad the KV axis to a multiple of ``tile`` with zeros (an e4m3
    cache's bytes: 0 is +0.0)."""
    pad = (-k_seg.shape[1]) % tile
    if pad:
        k_seg, v_seg = (torch.nn.functional.pad(kv_bytes(t), (0, 0, 0, pad)).view(t.dtype)
                        for t in (k_seg, v_seg))
    return k_seg, v_seg


def _merge_two_phase(o_p, m_p, l_p, sched: LeanSchedule, merge_impl: str, need_lse: bool):
    """Phase 2 shared by the dense, paged and verify two-phase paths: reduce
    the per-piece partials per segment -- with :func:`segment_merge`
    (``"xla"``) or the merge kernel K3 (``"pallas"``). Returns (o_seg,
    lse); ``segment_merge``'s lse is None unless ``need_lse``. Neither
    syncs with the host: ``segment_merge`` takes its grid from the
    schedule (``schedule_tensors``' ``merge_grid``)."""
    if merge_impl == "pallas":
        return lean_merge(o_p, m_p, l_p, sched)
    st = schedule_tensors(sched, o_p.device)
    seg = segment_merge(AttnPartial(o=o_p, m=m_p, l=l_p), st["piece_seg"], sched.num_segments,
                        grid=st["merge_grid"])
    return finalize(seg), (seg.m + torch.log(seg.l) if need_lse else None)


@dataclass(frozen=True)
class DecodePlan:
    """Which kernel family, which schedule, which flags: one hashable key.

    kind:
      * ``'dense'``   -- stream-K decode over dense per-slot KV
      * ``'paged'``   -- stream-K decode through a page table
      * ``'cascade'`` -- prefix-grouped decode (``sched`` is the
        :class:`~repro_torch.core.leantile.CascadeSchedule`; the grouping's
        tensors arrive as :class:`CascadeOperands`)
      * ``'flash'``   -- fixed-split FlashDecoding baseline (``num_splits``
        and ``tile``, no schedule)
      * ``'verify'``  -- ``spec_rows`` stacked query rows per sequence
        through a page table, against a chunk schedule with a runtime causal
        offset: a chunked-prefill pack, or a speculative verify block
        (the engine's ``_spec_verify``, the same workload).

    ``fused`` (``'dense'``, ``'paged'``, ``'cascade'``, ``'verify'``) runs
    the kernel that merges its pieces in its own launch (K2, K5, the fused
    K4); ``fused=False`` the partials kernel and the two-phase merge, which
    ``merge_impl`` picks: ``"xla"`` is :func:`segment_merge`, ``"pallas"``
    selects the CUDA merge kernel K3 here (the reference's Pallas
    ``lean_merge_pallas``). The reference's
    ``scale`` and ``interpret`` are not fields: the scale is always
    ``1/sqrt(d)``, and a kernel runs for CUDA tensors, its plain version
    for CPU tensors.
    """

    kind: str
    sched: Optional[Union[LeanSchedule, CascadeSchedule]] = None
    fused: bool = True
    merge_impl: str = "xla"
    return_lse: bool = False
    num_splits: Optional[int] = None      # flash only
    tile: Optional[int] = None            # flash only
    spec_rows: int = 0                    # verify only: q rows per sequence
    out_dtype: Optional[torch.dtype] = None   # the output's dtype; None: the queries'

    def __post_init__(self):
        if self.kind not in _PLAN_KINDS:
            raise ValueError(f"unknown plan kind {self.kind!r} (one of {_PLAN_KINDS})")
        if self.merge_impl not in _MERGE_IMPLS:
            raise ValueError(f"unknown merge_impl {self.merge_impl!r} (one of {_MERGE_IMPLS})")
        if self.kind == "flash":
            if self.num_splits is None or self.tile is None:
                raise ValueError("flash plans need num_splits and tile")
        elif self.sched is None:
            raise ValueError(f"{self.kind!r} plans need a schedule")
        elif (self.kind == "cascade") != isinstance(self.sched, CascadeSchedule):
            raise ValueError("cascade plans, and only they, take a CascadeSchedule")
        if self.kind == "verify" and self.spec_rows < 1:
            raise ValueError("verify plans need spec_rows >= 1")


class CascadeRouting(NamedTuple):
    """What every layer of a cascade step reads alike, built once a step by
    :func:`cascade_routing`: the member gather of the stacked prefix
    queries, the runtime lengths and pool routes of both passes, and for
    the two-call path the grid of the merge's piece targets. A grid from
    the host (:func:`repro_torch.core.merge.merge_grid` of
    :func:`cascade_merge_ids`) merges with no host sync; without one the
    targets come from the device members and :func:`segment_merge` builds
    their grid on the device (one sync)."""

    q_members: torch.Tensor       # (NP, nmax) long member slots, padding -> 0
    ctx_p: torch.Tensor           # (NP*Hkv,) int32 prefix pass lengths
    ctx_s: torch.Tensor           # (B*Hkv,) int32 suffix lengths
    route_p: torch.Tensor         # (prefix columns,) int32 pool rows
    route_s: torch.Tensor         # (suffix columns,) int32 pool rows
    ctx_all: Optional[torch.Tensor] = None     # fused: ctx_p then ctx_s
    route_all: Optional[torch.Tensor] = None   # fused: route_p then route_s
    merge_grid: Optional[MergeGrid] = None     # two-call: the targets' grid, from the host


class CascadeOperands(NamedTuple):
    """Tensors of a cascade dispatch: everything that depends on which
    slots group where (the schedule is membership-free, as in the
    reference). ``fused_desc`` is K5's :class:`CascadeFusedDesc` (the
    reference passes the bare ``(7, N)`` descriptors; K5 also needs the
    target tables derived from them); the two-call path ignores it.
    ``routing`` is the step's :class:`CascadeRouting`, built once for all
    layers; without it each call builds its own."""

    prefix_lens: torch.Tensor      # (NP,) int32 true pass lengths (tokens)
    members: torch.Tensor          # (NP, nmax) int32 slot ids, -1 padding
    prefix_tbl: torch.Tensor       # (NP, W) int32 shared pass pages
    suffix_tbl: torch.Tensor       # (B, W) int32 private tails (shifted)
    fused_desc: Optional[CascadeFusedDesc] = None
    routing: Optional[CascadeRouting] = None


def decode(
    q: torch.Tensor,
    kv: Tuple[torch.Tensor, torch.Tensor],
    *,
    plan: DecodePlan,
    ctx: torch.Tensor,
    page_tbl: Optional[torch.Tensor] = None,
    qstart: Optional[torch.Tensor] = None,
    cascade: Optional[CascadeOperands] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    route: Optional[torch.Tensor] = None,
):
    """The one decode dispatcher: ``plan`` picks the kernel family, the
    tensors ride alongside. ``kv`` is dense per-slot ``(k, v)`` for
    ``'dense'``/``'flash'`` plans and the page pools for
    ``'paged'``/``'cascade'``/``'verify'``. ``ctx`` carries the runtime
    lengths: the per-segment context ``(B*Hkv,)`` for decode kinds, the
    suffix lengths for ``'cascade'``, the visible KV (offset + chunk length)
    for ``'verify'``. ``qstart`` (verify only) is the per-segment absolute
    position of query row 0; ``cascade`` (cascade only) the grouping's
    tensors. ``k_scales``/``v_scales`` ``(num_pages, Hkv)`` come with int8
    pools (paged kinds only). ``route`` (``'paged'`` and ``'verify'``) is
    :func:`paged_route` of the plan's schedule and ``page_tbl``, built once
    by a caller that runs many layers on them; without it each call builds
    its own (a cascade's counterpart is ``cascade.routing``)."""
    k, v = kv
    sc = (k_scales, v_scales)
    if plan.kind in ("dense", "flash"):
        if k_scales is not None:
            raise ValueError("quantized KV requires the paged layout")
        if plan.kind == "dense":
            return _dense_decode_impl(q, k, v, ctx, plan)
        return _flash_decode_impl(q, k, v, ctx, plan)
    if plan.kind == "cascade":
        if cascade is None:
            raise ValueError("cascade plans need CascadeOperands")
        return _cascade_decode_impl(q, k, v, ctx, cascade, plan, *sc)
    if page_tbl is None:
        raise ValueError(f"{plan.kind!r} plans need page_tbl")
    if plan.kind == "paged":
        return _paged_decode_impl(q, k, v, ctx, page_tbl, plan, *sc, route=route)
    if qstart is None:
        raise ValueError("verify plans need qstart")
    return _verify_impl(q, k, v, ctx, qstart, page_tbl, plan, *sc, route=route)


def _run(q_seg, k_rows, v_rows, seg_ctx, route, plan: DecodePlan, k_scales=None,
         v_scales=None):
    """K2, or K1 + the two-phase merge, at scale 1/sqrt(d), with an int8
    pool's scales (one per pool row) where given. Returns (o_seg (S, gq,
    d), lse (S, gq))."""
    sched = plan.sched
    scale = 1.0 / math.sqrt(q_seg.shape[-1])
    sc = dict(k_scales=k_scales, v_scales=v_scales)
    if plan.fused:
        return lean_decode_fused(q_seg, k_rows, v_rows, seg_ctx, route, sched, scale, **sc)
    o_p, m_p, l_p = lean_decode_partials(q_seg, k_rows, v_rows, seg_ctx, route, sched, scale,
                                         **sc)
    return _merge_two_phase(o_p, m_p, l_p, sched, plan.merge_impl, plan.return_lse)


def _finish(o_seg, lse, q, plan: DecodePlan):
    B, Hq, d = q.shape
    out = o_seg.reshape(B, Hq, d).to(plan.out_dtype or q.dtype)
    if plan.return_lse:
        return out, lse.reshape(B, Hq)
    return out


def _dense_route(sched: LeanSchedule, s_pad: int, device) -> torch.Tensor:
    """Pool row of each descriptor column when the dense cache is read as
    rows of tiles: ``seg * (s_pad / tile) + tile`` (padding columns -> 0).
    It depends on the schedule alone, so it is memoized on it."""

    def make():
        desc = schedule_tensors(sched, device)["desc"]
        seg, tile, valid = desc[DESC_SEG], desc[DESC_TILE], desc[DESC_VALID]
        route = seg * (s_pad // sched.tile_size) + tile
        return torch.where(valid == OP_PARTIAL, route, torch.zeros_like(route)).contiguous()

    return schedule_memo(sched, f"dense_route_{s_pad}", device, make)


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


def paged_route(sched: LeanSchedule, page_tbl: torch.Tensor, num_kv_heads: int) -> torch.Tensor:
    """Per-column flattened pool row ``page * H_kv + head``. The schedule
    gives the logical routing (batch, head, tile per column); the runtime
    page table gives the physical page. Padding columns, and tiles past the
    table width (which the runtime length always masks), route to the null
    page's rows. Every layer of a step reads the same route: a caller that
    runs them all builds it once and passes it as ``route``."""
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


def _paged_decode_impl(q, k_pool, v_pool, seg_ctx, page_tbl, plan: DecodePlan,
                       k_scales=None, v_scales=None, route=None):
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
    if route is None:
        route = paged_route(sched, page_tbl, Hkv)
    o_seg, lse = _run(
        q.reshape(B * Hkv, gq, d).contiguous(), k_rows, v_rows,
        seg_ctx.to(torch.int32).contiguous(), route, plan, k_scales, v_scales,
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
    merge_impl: str = "xla",
    return_lse: bool = False,
    out_dtype: Optional[torch.dtype] = None,
):
    """Stream-K decode over dense KV ``(B, Hkv, S, d)`` against a prebuilt
    schedule (whose walk must cover ``seg_ctx``). Thin wrapper over
    :func:`decode` with a ``'dense'`` plan."""
    plan = DecodePlan(kind="dense", sched=sched, fused=fused, merge_impl=merge_impl,
                      return_lse=return_lse, out_dtype=out_dtype)
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
    merge_impl: str = "xla",
    schedule_cache: Optional[ScheduleCache] = None,
    return_lse: bool = False,
    out_dtype: Optional[torch.dtype] = None,
):
    """LeanAttention decode: exact attention, stream-K partitioned.

    q: (B, Hq, d); k, v: (B, Hkv, S, d); ctx_lens: host ints per batch row.
    ``schedule_cache`` buckets the lengths and memoizes the schedule;
    without one an exact schedule is built per call. The output is in
    ``out_dtype`` (by default the queries'): float32 keeps the kernels'
    own output for a merge that follows.
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
    return lean_decode_from_schedule(q, k, v, seg_ctx, sched, fused=fused, merge_impl=merge_impl,
                                     return_lse=return_lse, out_dtype=out_dtype)


def lean_decode_paged_from_schedule(
    q: torch.Tensor,                  # (B, Hq, d)
    k_pool: torch.Tensor,             # (num_pages, Hkv, page_size, d)
    v_pool: torch.Tensor,
    seg_ctx: torch.Tensor,            # (B*Hkv,) int32 true context lengths
    page_tbl: torch.Tensor,           # (B, pages_per_seq) int32 physical pages
    sched: LeanSchedule,
    *,
    fused: bool = True,
    merge_impl: str = "xla",
    return_lse: bool = False,
    k_scales: Optional[torch.Tensor] = None,   # int8 pools: (num_pages, Hkv) float32
    v_scales: Optional[torch.Tensor] = None,
    route: Optional[torch.Tensor] = None,      # paged_route(sched, page_tbl, Hkv), prebuilt
):
    """Paged stream-K decode against a prebuilt schedule
    (``sched.tile_size`` must equal the pool's page size; every id in
    ``page_tbl`` must index the pools -- the kernels trust it, checking it
    here would cost a device sync per call). Runs the same op sequence as
    the dense path: on equal logical inputs the outputs are bit-identical.
    Thin wrapper over :func:`decode` with a ``'paged'`` plan.
    """
    plan = DecodePlan(kind="paged", sched=sched, fused=fused, merge_impl=merge_impl,
                      return_lse=return_lse)
    return decode(q, (k_pool, v_pool), plan=plan, ctx=seg_ctx, page_tbl=page_tbl,
                  k_scales=k_scales, v_scales=v_scales, route=route)


def lean_decode_paged(
    q: torch.Tensor,                  # (B, Hq, d)
    k_pool: torch.Tensor,             # (num_pages, Hkv, page_size, d)
    v_pool: torch.Tensor,
    page_tbl,                         # (B, pages_per_seq) int32 (host or device)
    ctx_lens: Sequence[int],
    *,
    num_workers: Optional[int] = None,
    fused: bool = True,
    merge_impl: str = "xla",
    schedule_cache: Optional[ScheduleCache] = None,
    return_lse: bool = False,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
):
    """Convenience paged decode: builds (or cache-fetches) the schedule from
    host context lengths, then runs :func:`lean_decode_paged_from_schedule`
    (int8 pools with ``k_scales``/``v_scales``).

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
        q, k_pool, v_pool, seg_ctx, tbl, sched, fused=fused, merge_impl=merge_impl,
        return_lse=return_lse, k_scales=k_scales, v_scales=v_scales,
    )


# ------------------------------------------------------------------ cascade
def cascade_tables(page_tbl: np.ndarray, binding: CascadeBinding) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side ``(prefix_tbl, suffix_tbl)`` for a cascade call.

    ``prefix_tbl[j]`` is grouped pass ``j``'s shared page run -- pages
    ``[page_start, page_start + prefix_pages)`` of its first member's table
    row (all members alias the same physical pages there); ``suffix_tbl[b]``
    is sequence ``b``'s row shifted left past its deepest shared coverage.
    Widths stay at the slot table width so bucketed walks never index out of
    range."""
    ptbl = np.asarray(page_tbl)
    B, W = ptbl.shape
    NP = binding.members.shape[0]
    prefix_tbl = np.zeros((NP, W), dtype=np.int32)
    suffix_tbl = np.zeros((B, W), dtype=np.int32)
    for j in range(NP):
        lead = int(binding.members[j, 0])
        if lead < 0:
            continue
        s = int(binding.page_start[j])
        n = int(binding.prefix_pages[j])
        prefix_tbl[j, :n] = ptbl[lead, s: s + n]
    for b in range(B):
        n = int(binding.seq_prefix_pages[b])
        suffix_tbl[b, : W - n] = ptbl[b, n:]
    return prefix_tbl, suffix_tbl


def lean_decode_cascade_from_schedule(
    q: torch.Tensor,                  # (B, Hq, d)
    k_pool: torch.Tensor,             # (num_pages, Hkv, page_size, d)
    v_pool: torch.Tensor,
    seg_ctx_suffix: torch.Tensor,     # (B*Hkv,) int32 true suffix lengths
    prefix_lens: torch.Tensor,        # (NP,) int32 true pass lengths (tokens)
    members: torch.Tensor,            # (NP, nmax) int32 slot ids, -1 padding
    prefix_tbl: torch.Tensor,         # (NP, W) int32 shared pass pages
    suffix_tbl: torch.Tensor,         # (B, W) int32 private tails (shifted)
    fused_desc: Optional[CascadeFusedDesc],   # K5's descriptors (cascade_fused_desc)
    csched: CascadeSchedule,
    *,
    fused: bool = True,
    return_lse: bool = False,
    k_scales: Optional[torch.Tensor] = None,   # int8 pools: (num_pages, Hkv) float32
    v_scales: Optional[torch.Tensor] = None,
    routing: Optional[CascadeRouting] = None,  # cascade_routing(...), prebuilt
):
    """Cascade (prefix-grouped) paged LeanAttention decode against a
    prebuilt membership-free schedule: the grouped prefix pass(es), the
    per-sequence suffix pass and the merge -- one K5 launch with ``fused``,
    else K1 on each pass and :func:`segment_merge`. Everything that depends
    on the grouping arrives as tensors.

    Numerics: sharing physical pages is bit-neutral (the same cascade over
    duplicated pages gives the same bits); the regrouping re-associates the
    softmax reduction, so against the unshared decode the result agrees
    within float32 tolerance, like any other stream-K repartition.

    Thin wrapper over :func:`decode` with a ``'cascade'`` plan."""
    plan = DecodePlan(kind="cascade", sched=csched, fused=fused, return_lse=return_lse)
    ops_c = CascadeOperands(prefix_lens=prefix_lens, members=members, prefix_tbl=prefix_tbl,
                            suffix_tbl=suffix_tbl, fused_desc=fused_desc, routing=routing)
    return decode(q, (k_pool, v_pool), plan=plan, ctx=seg_ctx_suffix, cascade=ops_c,
                  k_scales=k_scales, v_scales=v_scales)


def cascade_merge_ids(csched: CascadeSchedule, members: np.ndarray) -> np.ndarray:
    """The two-call cascade's merge targets on the host, from the binding's
    host ``members``: the prefix pieces of (pass j, head h) expand to one
    row block per member rank, aimed at sequence segment ``members[j, i] *
    Hkv + h`` (padding ranks at ``B * Hkv``, which the merge drops), rank
    major; then the suffix pieces at their own segments. The ids
    :func:`_cascade_decode_impl` otherwise derives on the device."""
    pre, suf = csched.prefix_sched, csched.suffix_sched
    Hkv, S = csched.num_kv_heads, csched.batch * csched.num_kv_heads
    pseg = np.asarray(pre.piece_seg, dtype=np.int64)
    mem_p = np.asarray(members, dtype=np.int64)[pseg // Hkv]              # (Pp, nmax)
    tgt = np.where(mem_p >= 0, mem_p * Hkv + (pseg % Hkv)[:, None], S)
    return np.concatenate([tgt.T.reshape(-1), np.asarray(suf.piece_seg, dtype=np.int64)])


def cascade_routing(csched: CascadeSchedule, members: torch.Tensor, prefix_lens: torch.Tensor,
                    prefix_tbl: torch.Tensor, suffix_tbl: torch.Tensor,
                    seg_ctx_suffix: torch.Tensor, *, fused: bool,
                    merge_grid: Optional[MergeGrid] = None) -> CascadeRouting:
    """The :class:`CascadeRouting` of one cascade step: what each layer's
    :func:`_cascade_decode_impl` would otherwise rebuild -- the stacked
    queries' member gather, both passes' lengths and routes (concatenated
    for K5 with ``fused``), and, given a host ``merge_grid`` (of
    :func:`cascade_merge_ids`), the two-call merge's targets."""
    Hkv = csched.num_kv_heads
    dev = seg_ctx_suffix.device
    ctx_p = prefix_lens.to(device=dev, dtype=torch.int32).repeat_interleave(Hkv)
    ctx_s = seg_ctx_suffix.to(torch.int32)
    route_p = paged_route(csched.prefix_sched, prefix_tbl, Hkv)
    route_s = paged_route(csched.suffix_sched, suffix_tbl, Hkv)
    r = CascadeRouting(q_members=members.to(dev).long().clamp(min=0), ctx_p=ctx_p, ctx_s=ctx_s,
                       route_p=route_p, route_s=route_s)
    if fused:
        return r._replace(ctx_all=torch.cat([ctx_p, ctx_s]).contiguous(),
                          route_all=torch.cat([route_p, route_s]).contiguous())
    return r._replace(merge_grid=merge_grid)


def _cascade_decode_impl(q, k_pool, v_pool, seg_ctx_suffix, ops_c: CascadeOperands,
                         plan: DecodePlan, k_scales=None, v_scales=None):
    csched = plan.sched
    B, Hq, d = q.shape
    num_pages, Hkv, page_size, _ = k_pool.shape
    if page_size != csched.tile_size:
        raise ValueError(
            f"page_size {page_size} != schedule tile_size {csched.tile_size}"
            " — lean tiles must map 1:1 onto pages"
        )
    if B != csched.batch or Hkv != csched.num_kv_heads:
        raise ValueError("cascade schedule does not match the batch geometry")
    scale = 1.0 / math.sqrt(d)
    g, nmax, NP = Hq // Hkv, csched.group_size, csched.num_groups
    pre, suf = csched.prefix_sched, csched.suffix_sched
    k_rows, v_rows = _pool_rows(k_pool, v_pool)
    sc = dict(k_scales=k_scales, v_scales=v_scales)
    rt = ops_c.routing
    if rt is None:
        rt = cascade_routing(csched, ops_c.members, ops_c.prefix_lens, ops_c.prefix_tbl,
                             ops_c.suffix_tbl, seg_ctx_suffix, fused=plan.fused)

    # stacked member queries of each (pass, head): padding ranks carry
    # member-0 copies whose rows no target reads
    q_r = q.reshape(B, Hkv, g, d)
    q_pref = q_r[rt.q_members]                                    # (NP, nmax, Hkv, g, d)
    q_pref = q_pref.movedim(2, 1).reshape(NP * Hkv, nmax * g, d).contiguous()
    q_suf = q.reshape(B * Hkv, g, d).contiguous()

    if plan.fused:
        if ops_c.fused_desc is None:
            raise ValueError("fused cascade plans need fused_desc")
        o_seg, lse = lean_cascade_fused(
            q_pref, q_suf, k_rows, v_rows, rt.ctx_all, rt.route_all, ops_c.fused_desc, csched,
            scale, **sc,
        )
        return _finish(o_seg, lse, q, plan)

    # two calls: K1 on the prefix pass, K1 on the suffix pass, then the
    # merge of the pieces at their targets (cascade_merge_ids)
    o_p, m_p, l_p = lean_decode_partials(q_pref, k_rows, v_rows, rt.ctx_p, rt.route_p, pre,
                                         scale, **sc)
    o_s, m_s, l_s = lean_decode_partials(q_suf, k_rows, v_rows, rt.ctx_s, rt.route_s, suf,
                                         scale, **sc)
    Pp = pre.num_pieces
    part = AttnPartial(
        o=torch.cat([o_p.reshape(Pp, nmax, g, d).transpose(0, 1).reshape(nmax * Pp, g, d), o_s]),
        m=torch.cat([m_p.reshape(Pp, nmax, g).transpose(0, 1).reshape(nmax * Pp, g), m_s]),
        l=torch.cat([l_p.reshape(Pp, nmax, g).transpose(0, 1).reshape(nmax * Pp, g), l_s]),
    )
    if rt.merge_grid is not None:
        ids = rt.merge_grid.ids
    else:
        # the targets from the device members: segment_merge then builds its
        # grid on the device, with one host sync
        pseg = torch.as_tensor(pre.piece_seg.astype(np.int64)).to(q.device)
        mem_p = ops_c.members.to(q.device).long()[pseg // Hkv]              # (Pp, nmax)
        tgt = torch.where(mem_p >= 0, mem_p * Hkv + (pseg % Hkv)[:, None],
                          torch.full_like(mem_p, B * Hkv))
        ids = torch.cat([tgt.T.reshape(-1), schedule_tensors(suf, q.device)["piece_seg"].long()])
    seg = segment_merge(part, ids, B * Hkv, grid=rt.merge_grid)
    return _finish(finalize(seg), seg.m + torch.log(seg.l) if plan.return_lse else None, q, plan)


def lean_decode_cascade(
    q: torch.Tensor,                  # (B, Hq, d)
    k_pool: torch.Tensor,             # (num_pages, Hkv, page_size, d)
    v_pool: torch.Tensor,
    page_tbl,                         # (B, pages_per_seq) int32 (host)
    ctx_lens: Sequence[int],
    groups: Sequence[Sequence[int]],
    prefix_pages: Sequence[int],
    *,
    page_starts: Optional[Sequence[int]] = None,
    num_workers: Optional[int] = None,
    fused: bool = True,
    schedule_cache: Optional[ScheduleCache] = None,
    return_lse: bool = False,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
):
    """Convenience cascade decode: builds (or cache-fetches) the cascade
    schedule and binding from host lengths and grouping, derives the phase
    tables and the fused descriptors, and runs
    :func:`lean_decode_cascade_from_schedule`.

    ``groups``/``prefix_pages``/``page_starts`` are grouped passes over the
    batch -- nested (multi-level) passes allowed, singletons dropped --
    exactly what :func:`repro_torch.serving.prefix_cache.lcp_group_passes`
    gives over a radix-cache admission. Lengths clamp to allocated capacity
    like :func:`lean_decode_paged`."""
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
    ctx_lens = _clamp_ctx_lens(ctx_lens, page_counts * page_size, "lean_decode_cascade")
    ctx_lens = [max(1, c) for c in ctx_lens]
    num_workers = num_workers or default_num_workers()
    max_len = ptbl_np.shape[1] * page_size
    if schedule_cache is not None:
        csched, binding = schedule_cache.get_cascade(
            ctx_lens, groups, prefix_pages, Hkv, page_size, num_workers,
            max_len=max_len, page_starts=page_starts,
        )
    else:
        csched, binding = make_cascade_schedule(
            ctx_lens, groups, prefix_pages, Hkv, page_size, num_workers,
            page_starts=page_starts, max_len=max_len,
        )
    prefix_tbl, suffix_tbl = cascade_tables(ptbl_np, binding)
    fdesc = None
    if fused:
        fdesc = cascade_fused_desc(cascade_fused_descriptors(csched, binding), csched, q.device)
    dev = q.device
    i32 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int32)).to(dev)
    seg_ctx_suffix = i32(np.repeat(np.asarray(ctx_lens) - binding.seq_prefix_len, Hkv))
    return lean_decode_cascade_from_schedule(
        q, k_pool, v_pool, seg_ctx_suffix, i32(binding.prefix_lens), i32(binding.members),
        i32(prefix_tbl), i32(suffix_tbl), fdesc, csched, fused=fused, return_lse=return_lse,
        k_scales=k_scales, v_scales=v_scales,
    )


def lean_prefill_chunks(
    q: torch.Tensor,                  # (N, Hq, C, d) one prompt chunk per row
    k_pool: torch.Tensor,             # (num_pages, Hkv, page_size, d)
    v_pool: torch.Tensor,
    seg_ctx: torch.Tensor,            # (N*Hkv,) int32 visible KV (off + len)
    seg_qstart: torch.Tensor,         # (N*Hkv,) int32 chunk start offsets
    page_tbls: torch.Tensor,          # (N, W) int32 page table rows
    sched: LeanSchedule,
    *,
    merge_impl: str = "xla",
    k_scales: Optional[torch.Tensor] = None,   # int8 pools: (num_pages, Hkv) float32
    v_scales: Optional[torch.Tensor] = None,
    route: Optional[torch.Tensor] = None,      # paged_route(sched, page_tbls, Hkv), prebuilt
):
    """Stream-K chunked prefill against a prebuilt chunk schedule
    (:func:`repro_torch.core.leantile.make_chunk_schedule` over the pack's
    visible KV lengths). ``seg_ctx``, ``seg_qstart`` and ``page_tbls`` are
    runtime tensors, so one bucketed schedule serves a request at every
    depth of its prompt. Runs the fused K4 (the plan's default ``fused``):
    the pieces of each segment merged in the same launch, so ``merge_impl``
    is not read; the two-phase form is a ``'verify'`` plan with
    ``fused=False`` through :func:`decode`. Returns ``(N, Hq, C, d)`` in q's
    dtype.

    Thin wrapper over :func:`decode` with a ``'verify'`` plan (``spec_rows
    = C``).
    """
    plan = DecodePlan(kind="verify", sched=sched, merge_impl=merge_impl, spec_rows=q.shape[2])
    return decode(q, (k_pool, v_pool), plan=plan, ctx=seg_ctx, page_tbl=page_tbls,
                  qstart=seg_qstart, k_scales=k_scales, v_scales=v_scales, route=route)


def _verify_impl(q, k_pool, v_pool, seg_ctx, seg_qstart, page_tbls, plan: DecodePlan,
                 k_scales=None, v_scales=None, route=None):
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
    if route is None:
        route = paged_route(sched, page_tbls, Hkv)
    args = (q_seg, k_rows, v_rows, seg_ctx.to(torch.int32).contiguous(),
            seg_qstart.to(torch.int32).contiguous(), route, sched, scale)
    sc = dict(k_scales=k_scales, v_scales=v_scales)
    if plan.fused:
        return lean_prefill_fused(*args, chunk_cap=C, **sc).reshape(N, Hq, C, d)
    o_p, m_p, l_p = lean_prefill_chunk_partials(*args, chunk_cap=C, **sc)
    o_seg, _ = _merge_two_phase(o_p, m_p, l_p, sched, plan.merge_impl, need_lse=False)
    return o_seg.reshape(N, Hq, C, d).to(q.dtype)


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
