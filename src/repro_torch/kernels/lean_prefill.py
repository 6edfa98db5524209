"""Stream-K chunked prefill: Hopper kernel K4 (and K4-int8, K4-f8) in two
forms, and their plain PyTorch versions.

K4 replaces the Pallas kernel ``repro/kernels/lean_prefill.py:51``
``_lean_prefill_kernel`` (int8 body ``:102``). One pack of N prompt chunks
is a decode workload with taller segments: segment ``(chunk, kv_head)``
holds ``g * C`` query rows, flattened ``(g, C)`` chunk-minor, and row ``r``
sees the keys at positions ``<= seg_qstart[seg] + r % C`` (below the
runtime visible length ``seg_ctx[seg]``). The stream-K schedule comes from
:func:`repro_torch.core.leantile.make_chunk_schedule`.

  * :func:`lean_prefill_fused` -- the chunk path's kernel: the stream-K
    pieces and their merge in one launch, ``o (S, g*C, d)`` in q's dtype.
    bf16 queries at ``d`` 64 or 128 on pages that are a multiple of 8 rows
    (:func:`repro_torch.kernels.flash_prefill.tensor_core_path`, bf16 or
    int8 pages) run the tensor-core kernel ``csrc/lean_prefill_tc.cu``
    (wgmma + TMA, ``attn_tc.cuh``'s row block with a stream-K walk; pieces
    of a segment that several workers share are merged by the last CTA to
    arrive, as K2 does); everything else -- float32, other head dims, other
    pages -- the CUDA-core kernel of ``csrc/lean_prefill.cu`` with the same
    fix-up. Nothing falls back from one to the other.
  * :func:`lean_prefill_chunk_partials` -- the per-piece partials ``(o, m,
    l)`` alone, on the CUDA cores, for the two-phase paths (``fused=False``
    plans): :func:`repro_torch.core.merge.segment_merge` or K3 finishes
    them. A page whose float32 tile does not fit a CTA's shared memory
    beside its row block's state is walked in sub-tiles
    (:func:`row_sub_tile`).

With ``k_scales``/``v_scales`` the pool rows are int8 (the reference's
quantized body): the CUDA-core kernel widens and scales each tile as it is
loaded; the tensor-core kernel converts the int8 tile to bf16 as it is
(exact) and applies the scales to the scores and to P. e4m3 pool rows (the
f8 pools, no scales) take the same loads and staging, widened to bf16
(exact) with nothing to scale: the bf16 kernel's bits on the widened pool.

The wrappers launch a kernel for CUDA tensors and run the plain version for
CPU tensors -- only because the tensors lie on the CPU; a failed launch
raises. The plain versions are K1's walk with the chunk-causal mask
(:func:`repro_torch.kernels.lean_decode.lean_decode_partials_plain`) and,
for the fused form, K2's piece-order fold. ``launches`` counts partials
launches, ``fused_launches`` fused ones and ``fused_tc_launches`` the fused
launches on the tensor cores (plain runs do not count).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core.leantile import LeanSchedule
from . import build
from .lean_decode import (
    _check_operands,
    arrival_counters,
    fold_pieces_plain,
    lean_decode_partials_plain,
    scale_rows,
    schedule_tensors,
)

SOURCE = "lean_prefill.cu"
TC_SOURCE = "lean_prefill_tc.cu"
TC_ROWS = 128                   # query rows per CTA of the tensor-core kernel
BLOCK_ROWS = 64                 # query rows per CTA (attn_tile.cuh kBlockRows)
SMEM_LIMIT = 232_448            # bytes of shared memory a CTA may use on Hopper

# launch counters: +1 per kernel launch, nowhere else
launches = 0              # partials
fused_launches = 0        # fused, every launch
fused_tc_launches = 0     # fused, on the tensor cores


def reset_launch_counts() -> None:
    global launches, fused_launches, fused_tc_launches
    launches = fused_launches = fused_tc_launches = 0


def row_smem_bytes(d: int, tile: int) -> int:
    """Shared memory of one row-block CTA (``attn::row_smem_bytes``): q and
    acc ``(64, d+1)``, the K/V tile ``(tile, d+1)``, scores ``(64,
    tile+1)`` and five per-row values, all 4 bytes."""
    return 4 * (2 * BLOCK_ROWS * (d + 1) + tile * (d + 1) + BLOCK_ROWS * (tile + 1)
                + 5 * BLOCK_ROWS)


def row_sub_tile(d: int, tile: int) -> int:
    """Keys per sub-tile of the row-block update (``attn::row_sub_tile``):
    the whole tile where its shared memory fits :data:`SMEM_LIMIT` -- so a
    page that fitted before runs the same single update -- else the largest
    of 128, 64, 32, 16 or 8 keys (at most the tile) that fits; 0 if none
    does."""
    if row_smem_bytes(d, tile) <= SMEM_LIMIT:
        return tile
    sub = min(tile, 128)
    while sub >= 8:
        if row_smem_bytes(d, sub) <= SMEM_LIMIT:
            return sub
        sub //= 2
    return 0


def check_row_kernel(d: int, tile: int, what: str):
    if row_sub_tile(d, tile) == 0:
        raise ValueError(
            f"{what}: head_dim {d} needs {row_smem_bytes(d, 8)} bytes of shared memory "
            f"even with sub-tiles of 8 keys, more than {SMEM_LIMIT}"
        )


P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ENTRY_POINTS = {
    SOURCE: {
        "lean_prefill_partials_launch": [
            I_, P_, P_, P_, P_, P_, P_, I_, I_, I_, P_, P_, P_, P_, P_, P_, I_, I_, I_, I_, F_, P_,
        ],
        "lean_prefill_fused_launch": [
            I_, P_, P_, P_, P_, P_, P_, I_, I_, I_, P_, P_, P_, P_, P_, P_, P_, P_, P_, P_,
            I_, I_, I_, I_, F_, P_,
        ],
    },
    TC_SOURCE: {
        "lean_prefill_fused_tc_launch": [
            I_, P_, P_, P_, P_, P_, P_, I_, I_, I_, P_, P_, P_, P_, P_, P_, P_, P_, P_, P_,
            I_, I_, I_, I_, I_, I_, F_, P_,
        ],
    },
}


def _library(source: str = SOURCE) -> ctypes.CDLL:
    lib = build.load(source)
    if not getattr(lib, "_argtypes_set", False):
        for name, argtypes in _ENTRY_POINTS[source].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = I_
        lib._argtypes_set = True
    return lib


def lean_prefill_partials_plain(q_seg, k_rows, v_rows, seg_ctx, seg_qstart, route,
                                sched: LeanSchedule, scale: float, chunk_cap: int,
                                k_scales=None, v_scales=None):
    """Plain PyTorch K4: the descriptor walk of K1 in the same order, rows
    masked chunk-causally. Returns float32 ``(o_p (P, g*C, d), m_p (P,
    g*C), l_p (P, g*C))``."""
    return lean_decode_partials_plain(
        q_seg, k_rows, v_rows, seg_ctx, route, sched, scale,
        seg_qstart=seg_qstart, chunk_cap=chunk_cap, k_scales=k_scales, v_scales=v_scales,
    )


def _check_chunk_operands(q_seg, k_rows, v_rows, seg_ctx, seg_qstart, route, sched,
                          chunk_cap, k_scales, v_scales):
    """Shapes and devices of K4's operands; returns the int8 pool's scales
    as one float32 per pool row (None for float pools)."""
    _check_operands(q_seg, k_rows, v_rows, seg_ctx, route, sched)
    rows = q_seg.shape[1]
    if rows % chunk_cap:
        raise ValueError(f"{rows} query rows per segment are not g x chunk_cap {chunk_cap}")
    if seg_qstart.shape != seg_ctx.shape or seg_qstart.device != q_seg.device:
        raise ValueError("seg_qstart must be (S,) on the device of q_seg")
    return scale_rows(k_rows, k_scales, v_scales)


def _check_cuda(q_seg, k_rows, v_rows, seg_ctx, seg_qstart, route):
    build.check_dtypes(q_seg, k_rows, v_rows)
    if any(t.dtype != torch.int32 for t in (seg_ctx, seg_qstart, route)):
        raise TypeError("seg_ctx, seg_qstart and route must be int32")
    build.check_contiguous(q_seg=q_seg, k_rows=k_rows, v_rows=v_rows, seg_ctx=seg_ctx,
                           seg_qstart=seg_qstart, route=route)


def lean_prefill_fused_plain(q_seg, k_rows, v_rows, seg_ctx, seg_qstart, route,
                             sched: LeanSchedule, scale: float, chunk_cap: int,
                             k_scales=None, v_scales=None):
    """Plain PyTorch fused K4: the partials of :func:`lean_prefill_partials_plain`,
    each segment's pieces folded in piece order (K2's fix-up), ``o / max(l,
    1e-30)``. Returns ``(S, g*C, d)`` in q's dtype."""
    parts = lean_prefill_partials_plain(q_seg, k_rows, v_rows, seg_ctx, seg_qstart, route,
                                        sched, scale, chunk_cap, k_scales=k_scales,
                                        v_scales=v_scales)
    acc, _, l = fold_pieces_plain(*parts, sched)
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q_seg.dtype)


def lean_prefill_chunk_partials(q_seg, k_rows, v_rows, seg_ctx, seg_qstart, route,
                                sched: LeanSchedule, scale: float, chunk_cap: int,
                                k_scales=None, v_scales=None
                                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4. ``q_seg (S, g*C, d)``; ``k_rows``/``v_rows (R, tile, d)`` pool
    rows; ``seg_ctx (S,)`` int32 visible KV lengths (offset + chunk length);
    ``seg_qstart (S,)`` int32 absolute position of each segment's first
    query; ``route (>= G*T,)`` int32 pool row per descriptor column; int8
    rows take ``k_scales``/``v_scales``, one float32 scale per pool row.
    Returns float32 per-piece partials ``(o_p (P, g*C, d), m_p (P, g*C), l_p (P,
    g*C))``: a row that sees no key of a piece has ``m = -1e30, l = 0``."""
    global launches
    ks, vs = _check_chunk_operands(q_seg, k_rows, v_rows, seg_ctx, seg_qstart, route, sched,
                                   chunk_cap, k_scales, v_scales)
    rows = q_seg.shape[1]
    if q_seg.device.type == "cpu":
        return lean_prefill_partials_plain(q_seg, k_rows, v_rows, seg_ctx, seg_qstart, route,
                                           sched, scale, chunk_cap, k_scales=ks, v_scales=vs)
    _check_cuda(q_seg, k_rows, v_rows, seg_ctx, seg_qstart, route)
    d, tile = q_seg.shape[2], sched.tile_size
    check_row_kernel(d, tile, "lean_prefill_chunk_partials (K4)")
    P, dev = sched.num_pieces, q_seg.device
    st = schedule_tensors(sched, dev)
    o_p = torch.empty(P + 1, rows, d, dtype=torch.float32, device=dev)
    m_p = torch.empty(P + 1, rows, dtype=torch.float32, device=dev)
    l_p = torch.empty(P + 1, rows, dtype=torch.float32, device=dev)
    err = _library().lean_prefill_partials_launch(
        build.dtype_code(q_seg, k_rows), build.ptr(q_seg), build.ptr(k_rows), build.ptr(v_rows),
        build.ptr(ks), build.ptr(vs), build.ptr(st["desc"]), sched.grid_iters, sched.tiles_per_worker, sched.num_workers,
        build.ptr(seg_ctx), build.ptr(seg_qstart), build.ptr(route),
        build.ptr(o_p), build.ptr(m_p), build.ptr(l_p), rows, int(chunk_cap), d, tile,
        float(scale), build.stream(dev),
    )
    build.check_launch(err, "lean_prefill_chunk_partials (K4)")
    launches += 1
    return o_p[:P], m_p[:P], l_p[:P]


def lean_prefill_fused(q_seg, k_rows, v_rows, seg_ctx, seg_qstart, route,
                       sched: LeanSchedule, scale: float, chunk_cap: int,
                       k_scales=None, v_scales=None) -> torch.Tensor:
    """Fused K4: operands as :func:`lean_prefill_chunk_partials`. Returns the
    attention ``o (S, g*C, d)`` in q's dtype: each segment's pieces merged
    in the launch. bf16 queries at ``d`` 64 or 128 on pages that are a
    multiple of 8 rows run on the tensor cores (``tensor_core_path``; q and
    the pool rows 16-byte aligned), the rest on the CUDA cores."""
    global fused_launches, fused_tc_launches
    from .flash_prefill import check_tc, tensor_core_path

    ks, vs = _check_chunk_operands(q_seg, k_rows, v_rows, seg_ctx, seg_qstart, route, sched,
                                   chunk_cap, k_scales, v_scales)
    if q_seg.device.type == "cpu":
        return lean_prefill_fused_plain(q_seg, k_rows, v_rows, seg_ctx, seg_qstart, route,
                                        sched, scale, chunk_cap, k_scales=ks, v_scales=vs)
    _check_cuda(q_seg, k_rows, v_rows, seg_ctx, seg_qstart, route)
    (S, rows, d), tile = q_seg.shape, sched.tile_size
    tc = tensor_core_path(q_seg.dtype, d, tile)
    if tc:
        check_tc("lean_prefill_fused (K4)", q_seg=q_seg, k_rows=k_rows, v_rows=v_rows)
    else:
        check_row_kernel(d, tile, "lean_prefill_fused (K4)")
    P, dev = sched.num_pieces, q_seg.device
    st = schedule_tensors(sched, dev)
    o_p = torch.empty(P + 1, rows, d, dtype=torch.float32, device=dev)
    m_p = torch.empty(P + 1, rows, dtype=torch.float32, device=dev)
    l_p = torch.empty(P + 1, rows, dtype=torch.float32, device=dev)
    block = TC_ROWS if tc else BLOCK_ROWS
    arrivals = arrival_counters(sched, (S, -(-rows // block)), dev)
    out = torch.empty_like(q_seg)
    common = (
        build.dtype_code(q_seg, k_rows), build.ptr(q_seg), build.ptr(k_rows), build.ptr(v_rows),
        build.ptr(ks), build.ptr(vs), build.ptr(st["desc"]), sched.grid_iters,
        sched.tiles_per_worker, sched.num_workers, build.ptr(seg_ctx), build.ptr(seg_qstart),
        build.ptr(route), build.ptr(st["piece_start"]), build.ptr(st["piece_count"]),
        build.ptr(arrivals), build.ptr(o_p), build.ptr(m_p), build.ptr(l_p), build.ptr(out),
    )
    if tc:
        err = _library(TC_SOURCE).lean_prefill_fused_tc_launch(
            *common, S, k_rows.shape[0], rows, int(chunk_cap), d, tile, float(scale),
            build.stream(dev))
    else:
        err = _library().lean_prefill_fused_launch(
            *common, rows, int(chunk_cap), d, tile, float(scale), build.stream(dev))
    build.check_launch(err, "lean_prefill_fused (K4)")
    fused_launches += 1
    fused_tc_launches += int(tc)
    return out
