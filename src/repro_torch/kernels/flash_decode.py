"""Fixed-split (FlashDecoding) decode: Hopper kernel K6 and its plain
PyTorch version -- the paper's baseline (section III-C).

K6, :func:`flash_decode_partials`, replaces the Pallas kernel
``repro/kernels/flash_decode.py:25`` ``_flash_decode_kernel``. Every segment
(batch row x KV head) is cut into the same ``num_splits`` runs of ``tps``
tiles; each (segment, split) pair walks its run with the decode tile update
K1 and K2 share and flushes one partial ``(o, m, l)``. ``merge_n`` reduces
the splits outside (:func:`repro_torch.kernels.ops.flash_decode_from_lens`).
The CUDA source is ``csrc/flash_decode.cu``.

A CTA streams its split's tiles through the decode ring
(``csrc/attn_decode_ring.cuh``: bulk copies into shared-memory slots,
kept ahead of the compute by a producer warp) where
:func:`repro_torch.kernels.decode_ring.ring_slots` says it fits, with the
same arithmetic and bits as the walk over device memory it replaces; a
float32 tile of 256 keys at d 128 keeps that walk.

The wrapper launches the kernel for CUDA tensors and runs the plain version
for CPU tensors -- only because the tensors lie on the CPU; a failed launch
raises. ``launches`` counts kernel launches (plain runs do not count), and
``ring_launches`` those of them on the ring.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core.attention import NEG_INF, widen_kv
from . import build, decode_ring
from .lean_decode import check_f8_ring
SOURCE = "flash_decode.cu"
MAX_GQ = 8        # query rows per segment K6 takes: its row buckets 2, 4 and 8

# launch counters: +1 per kernel launch, nowhere else
launches = 0
ring_launches = 0         # those on the decode ring


def reset_launch_counts() -> None:
    global launches, ring_launches
    launches = 0
    ring_launches = 0


def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_decode_partials_launch.argtypes = [
            I, P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, I, P,
        ]
        lib.flash_decode_partials_launch.restype = I
        lib._argtypes_set = True
    return lib


def split_geometry(s_pad: int, num_splits: int, tile: int) -> int:
    """Tiles per split: the reference pads the KV so that every split covers
    ``tps`` whole tiles (``flash_decode.py:104-106``)."""
    return -(-(s_pad // tile) // num_splits)


def ring_slots(dtype: torch.dtype, gq: int, d: int, tile: int) -> int:
    """Slots of K6's decode ring for K/V of ``dtype`` and ``gq`` query rows,
    whose row bucket sizes the CTA's float state (0: the walk over device
    memory)."""
    return decode_ring.ring_slots(torch.finfo(dtype).bits // 8, d, tile,
                                  decode_ring.row_bucket(gq))


def flash_decode_partials_plain(q_seg, k_seg, v_seg, seg_lens, num_splits: int,
                                tile: int, scale: float):
    """Plain PyTorch K6: every (segment, split) walks its ``tps`` tiles in
    order, vectorised over segments and splits. Returns float32 ``(o (S,
    splits, gq, d), m (S, splits, gq), l (S, splits, gq))``. e4m3 K/V (the
    f8 pools) are widened to bf16 first: the f8 form's plain version is the
    bf16 form's on the widened rows."""
    k_seg, v_seg = widen_kv(k_seg), widen_kv(v_seg)
    S, gq, d = q_seg.shape
    s_pad = k_seg.shape[1]
    n_tiles = s_pad // tile
    tps = split_geometry(s_pad, num_splits, tile)
    dev = q_seg.device
    q = q_seg.float()[:, None]                                         # (S, 1, gq, d)
    acc = torch.zeros(S, num_splits, gq, d, dtype=torch.float32, device=dev)
    m = torch.full((S, num_splits, gq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(S, num_splits, gq, dtype=torch.float32, device=dev)
    pos = torch.arange(tile, device=dev)
    split = torch.arange(num_splits, device=dev)
    kt = k_seg.reshape(S, n_tiles, tile, d)
    vt = v_seg.reshape(S, n_tiles, tile, d)
    ctx = seg_lens.long()
    for t in range(tps):
        tile_idx = split * tps + t                                     # (splits,)
        in_range = tile_idx < n_tiles
        ti = tile_idx.clamp(max=n_tiles - 1)
        vlen = (ctx[:, None] - tile_idx[None, :] * tile).clamp(0, tile)  # (S, splits)
        vlen = torch.where(in_range[None, :], vlen, torch.zeros_like(vlen))
        mask = pos[None, None, :] < vlen[..., None]                    # (S, splits, tile)
        k = kt[:, ti].float()                                          # (S, splits, tile, d)
        v = torch.where(mask[..., None], vt[:, ti].float(), 0.0)
        s = torch.einsum("sxqd,sxtd->sxqt", q.expand(-1, num_splits, -1, -1), k) * scale
        s = torch.where(mask[:, :, None, :], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(mask[:, :, None, :], torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        work = (vlen > 0)[..., None]                                   # pl.when(vlen > 0)
        l = torch.where(work, alpha * l + p.sum(dim=-1), l)
        acc = torch.where(work[..., None],
                          alpha[..., None] * acc + torch.einsum("sxqt,sxtd->sxqd", p, v), acc)
        m = torch.where(work, m_new, m)
    return acc, m, l


def flash_decode_partials(q_seg, k_seg, v_seg, seg_lens, num_splits: int, tile: int,
                          scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6. ``q_seg (S, gq, d)``; ``k_seg``/``v_seg (S, S_pad, d)`` dense
    per-segment KV with ``S_pad`` a multiple of ``tile``; ``seg_lens (S,)``
    int32 runtime lengths. Returns float32 per-(segment, split) partials
    ``(o (S, splits, gq, d), m (S, splits, gq), l (S, splits, gq))``; a split
    with no visible key has ``m = -1e30, l = 0``. K/V share q's dtype, or
    are e4m3 (the f8 pools) beside bf16 queries, read on the decode ring
    only."""
    global launches, ring_launches
    S, gq, d = q_seg.shape
    if k_seg.dim() != 3 or k_seg.shape[0] != S or k_seg.shape[2] != d or v_seg.shape != k_seg.shape:
        raise ValueError(
            f"expected q_seg (S, gq, d) and K/V (S, S_pad, d), got {tuple(q_seg.shape)}, "
            f"{tuple(k_seg.shape)}, {tuple(v_seg.shape)}"
        )
    if k_seg.shape[1] % tile or num_splits < 1:
        raise ValueError(f"S_pad {k_seg.shape[1]} is not a multiple of tile {tile}, "
                         f"or num_splits {num_splits} < 1")
    if seg_lens.shape != (S,):
        raise ValueError("seg_lens must be (S,)")
    devices = {t.device for t in (q_seg, k_seg, v_seg, seg_lens)}
    if len(devices) != 1:
        raise ValueError(f"operands lie on several devices: {sorted(map(str, devices))}")
    if q_seg.device.type == "cpu":
        return flash_decode_partials_plain(q_seg, k_seg, v_seg, seg_lens, num_splits, tile,
                                           scale)
    build.check_dtypes(q_seg, k_seg, v_seg)
    if k_seg.dtype == torch.int8:
        raise TypeError("flash_decode_partials (K6) has no int8 form: dequantize the pages first")
    if seg_lens.dtype != torch.int32:
        raise TypeError("seg_lens must be int32")
    if not 1 <= gq <= MAX_GQ:
        raise ValueError(f"flash_decode_partials (K6) takes 1 to {MAX_GQ} query rows per "
                         f"segment, got {gq}")
    build.check_contiguous(q_seg=q_seg, k_seg=k_seg, v_seg=v_seg, seg_lens=seg_lens)
    n_tiles = k_seg.shape[1] // tile
    tps = split_geometry(k_seg.shape[1], num_splits, tile)
    ns = ring_slots(k_seg.dtype, gq, d, tile)
    if ns:
        decode_ring.check_aligned("flash_decode_partials (K6)", k_seg=k_seg, v_seg=v_seg)
    else:
        check_f8_ring("flash_decode_partials (K6)", k_seg.dtype, gq, d, tile)
    dev = q_seg.device
    o = torch.empty(S, num_splits, gq, d, dtype=torch.float32, device=dev)
    m = torch.empty(S, num_splits, gq, dtype=torch.float32, device=dev)
    l = torch.empty(S, num_splits, gq, dtype=torch.float32, device=dev)
    err = _library().flash_decode_partials_launch(
        build.dtype_code(q_seg, k_seg), build.ptr(q_seg), build.ptr(k_seg), build.ptr(v_seg),
        build.ptr(seg_lens), build.ptr(o), build.ptr(m), build.ptr(l),
        S, int(num_splits), tps, n_tiles, gq, d, int(tile), float(scale), ns, build.stream(dev),
    )
    build.check_launch(err, "flash_decode_partials (K6)")
    launches += 1
    ring_launches += int(ns > 0)
    return o, m, l
