"""Stream-K chunked prefill: Hopper kernel K4 and its plain PyTorch version.

K4, :func:`lean_prefill_chunk_partials`, replaces the Pallas kernel
``repro/kernels/lean_prefill.py:51`` ``_lean_prefill_kernel``. One pack of N
prompt chunks is a decode workload with taller segments: segment ``(chunk,
kv_head)`` holds ``g * C`` query rows, flattened ``(g, C)`` chunk-minor, and
row ``r`` sees the keys at positions ``<= seg_qstart[seg] + r % C`` (below
the runtime visible length ``seg_ctx[seg]``). The stream-K schedule comes
from :func:`repro_torch.core.leantile.make_chunk_schedule`; the kernel
writes per-piece partials ``(o, m, l)`` and the decode merge
(:func:`repro_torch.core.merge.segment_merge`) finishes them.

The CUDA source is ``csrc/lean_prefill.cu`` (its note says what bounds it:
K4 is the port's first kernel above the ridge point). On Hopper the rows of
a segment are split into blocks of 64 per CTA: one segment's f32
accumulators no longer fit a CTA.

The wrapper launches the kernel for CUDA tensors and runs the plain version
for CPU tensors -- only because the tensors lie on the CPU; a failed launch
raises. The plain version is K1's walk with the chunk-causal mask
(:func:`repro_torch.kernels.lean_decode.lean_decode_partials_plain`).
``launches`` counts kernel launches (plain runs do not count).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core.leantile import LeanSchedule
from . import build
from .lean_decode import _check_no_scales, _check_operands, lean_decode_partials_plain, schedule_tensors

SOURCE = "lean_prefill.cu"
BLOCK_ROWS = 64                 # query rows per CTA (attn_tile.cuh kBlockRows)
SMEM_LIMIT = 232_448            # bytes of shared memory a CTA may use on Hopper

# launch counter: +1 per kernel launch, nowhere else
launches = 0


def reset_launch_counts() -> None:
    global launches
    launches = 0


def row_smem_bytes(d: int, tile: int) -> int:
    """Shared memory of one row-block CTA (``attn::row_smem_bytes``): q and
    acc ``(64, d+1)``, the K/V tile ``(tile, d+1)``, scores ``(64,
    tile+1)`` and four per-row values, all 4 bytes."""
    return 4 * (2 * BLOCK_ROWS * (d + 1) + tile * (d + 1) + BLOCK_ROWS * (tile + 1)
                + 4 * BLOCK_ROWS)


def check_row_kernel(d: int, tile: int, what: str):
    if row_smem_bytes(d, tile) > SMEM_LIMIT:
        raise ValueError(
            f"{what}: head_dim {d} with tiles of {tile} keys needs "
            f"{row_smem_bytes(d, tile)} bytes of shared memory, more than {SMEM_LIMIT}"
        )


def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.lean_prefill_partials_launch.argtypes = [
            I, P, P, P, P, I, I, I, P, P, P, P, P, P, I, I, I, I, F, P,
        ]
        lib.lean_prefill_partials_launch.restype = I
        lib._argtypes_set = True
    return lib


def lean_prefill_partials_plain(q_seg, k_rows, v_rows, seg_ctx, seg_qstart, route,
                                sched: LeanSchedule, scale: float, chunk_cap: int):
    """Plain PyTorch K4: the descriptor walk of K1 in the same order, rows
    masked chunk-causally. Returns float32 ``(o_p (P, g*C, d), m_p (P,
    g*C), l_p (P, g*C))``."""
    return lean_decode_partials_plain(
        q_seg, k_rows, v_rows, seg_ctx, route, sched, scale,
        seg_qstart=seg_qstart, chunk_cap=chunk_cap,
    )


def lean_prefill_chunk_partials(q_seg, k_rows, v_rows, seg_ctx, seg_qstart, route,
                                sched: LeanSchedule, scale: float, chunk_cap: int,
                                k_scales=None, v_scales=None
                                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4. ``q_seg (S, g*C, d)``; ``k_rows``/``v_rows (R, tile, d)`` pool
    rows; ``seg_ctx (S,)`` int32 visible KV lengths (offset + chunk length);
    ``seg_qstart (S,)`` int32 absolute position of each segment's first
    query; ``route (>= G*T,)`` int32 pool row per descriptor column. Returns
    float32 per-piece partials ``(o_p (P, g*C, d), m_p (P, g*C), l_p (P,
    g*C))``: a row that sees no key of a piece has ``m = -1e30, l = 0``."""
    global launches
    _check_no_scales(k_scales, v_scales)
    _check_operands(q_seg, k_rows, v_rows, seg_ctx, route, sched)
    rows = q_seg.shape[1]
    if rows % chunk_cap:
        raise ValueError(f"{rows} query rows per segment are not g x chunk_cap {chunk_cap}")
    if seg_qstart.shape != seg_ctx.shape or seg_qstart.device != q_seg.device:
        raise ValueError("seg_qstart must be (S,) on the device of q_seg")
    if q_seg.device.type == "cpu":
        return lean_prefill_partials_plain(q_seg, k_rows, v_rows, seg_ctx, seg_qstart, route,
                                           sched, scale, chunk_cap)
    build.check_dtypes(q_seg, k_rows, v_rows)
    if any(t.dtype != torch.int32 for t in (seg_ctx, seg_qstart, route)):
        raise TypeError("seg_ctx, seg_qstart and route must be int32")
    build.check_contiguous(q_seg=q_seg, k_rows=k_rows, v_rows=v_rows, seg_ctx=seg_ctx,
                           seg_qstart=seg_qstart, route=route)
    d, tile = q_seg.shape[2], sched.tile_size
    check_row_kernel(d, tile, "lean_prefill_chunk_partials (K4)")
    P, dev = sched.num_pieces, q_seg.device
    st = schedule_tensors(sched, dev)
    o_p = torch.empty(P + 1, rows, d, dtype=torch.float32, device=dev)
    m_p = torch.empty(P + 1, rows, dtype=torch.float32, device=dev)
    l_p = torch.empty(P + 1, rows, dtype=torch.float32, device=dev)
    err = _library().lean_prefill_partials_launch(
        build.DTYPE_CODE[q_seg.dtype], build.ptr(q_seg), build.ptr(k_rows), build.ptr(v_rows),
        build.ptr(st["desc"]), sched.grid_iters, sched.tiles_per_worker, sched.num_workers,
        build.ptr(seg_ctx), build.ptr(seg_qstart), build.ptr(route),
        build.ptr(o_p), build.ptr(m_p), build.ptr(l_p), rows, int(chunk_cap), d, tile,
        float(scale), build.stream(dev),
    )
    build.check_launch(err, "lean_prefill_chunk_partials (K4)")
    launches += 1
    return o_p[:P], m_p[:P], l_p[:P]
