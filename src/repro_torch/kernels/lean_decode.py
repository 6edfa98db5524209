"""Stream-K decode attention: Hopper kernels K1 and K2 and their plain
PyTorch versions.

  * K1, :func:`lean_decode_partials` -- stream-K phase 1. Replaces the
    Pallas kernel ``repro/kernels/lean_decode.py:117``
    ``_lean_decode_kernel`` (paged twin ``:535``). Each worker walks its T
    descriptor columns, runs the online-softmax update of one K/V tile for
    the segment's ``gq`` query rows (masked to the runtime ``ctx[seg]``)
    and flushes the un-scaled ``(o, m, l)`` of each piece. The phase-2
    merge is :func:`repro_torch.core.merge.segment_merge`, outside.
  * K2, :func:`lean_decode_fused` -- K1's partials plus the per-segment
    merge in one launch. Replaces ``repro/kernels/lean_decode.py:302``
    ``_lean_decode_fused_kernel`` (paged twin ``:539``). The TPU kernel ran
    its grid sequentially with the partials in VMEM; on Hopper the CTAs
    run in parallel, so K2 is the paper's stream-K fix-up instead: pieces
    go to global scratch, each flush bumps a per-segment arrival counter,
    and the CTA that completes a segment merges it in piece order.

Both are CUDA C++ for ``sm_90a`` in ``csrc/lean_decode.cu`` (see the note
there on what bounds them: the K/V bytes read, since decode at ``gq = 4``
sits far below the bf16 ridge point). The wrappers take the paged layout:
K/V as pool rows ``(R, tile, d)`` and a per-column ``route`` into them.
Dense KV reaches the same kernels through a route over its own rows
(:func:`repro_torch.kernels.ops`), so dense and paged decode are
bit-identical.

A wrapper launches its kernel for CUDA tensors and runs the plain version
for CPU tensors -- only because the tensors lie on the CPU; there is no
fallback from a failed launch. The plain versions walk the same descriptors
in the same order (vectorised over the G workers at each step ``t``) and
serve the CPU tests and the on-card comparison in ``chip_smoke.py``.
``partials_launches`` / ``fused_launches`` count kernel launches (plain
runs do not count).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.core.attention import NEG_INF
from repro_torch.core.leantile import LeanSchedule
from . import build

# descriptor rows of LeanSchedule.packed_descriptors(); VALID is 1 on a
# LeanTile column (OP_PARTIAL) and 0 on padding
DESC_SEG, DESC_TILE, DESC_PIECE, DESC_FIRST, DESC_LAST, DESC_LEN, DESC_VALID = range(7)
OP_PARTIAL = 1

SOURCE = "lean_decode.cu"
KERNEL_GQ = (2, 4)    # query rows per segment: the smoke config's and Mistral-NeMo-12B's

# launch counters: +1 per kernel launch, nowhere else
partials_launches = 0
fused_launches = 0


def reset_launch_counts() -> None:
    global partials_launches, fused_launches
    partials_launches = 0
    fused_launches = 0


# ------------------------------------------------------------ schedule data
def schedule_tensors(sched: LeanSchedule, device: torch.device) -> Dict[str, torch.Tensor]:
    """The schedule's kernel operands as int32 tensors on ``device``:
    packed descriptors ``(7, G*T)``, piece ranges, and the paged routing
    metadata. Memoized on the schedule per device (like the reference's
    packed descriptors), so a schedule-cache hit uploads nothing."""
    key = f"_torch_{device}"
    cached = sched.__dict__.get(key)
    if cached is None:
        starts, counts = sched.piece_ranges()
        batch, head, tile, ok = sched.iter_kv_meta(fused=False)
        i32 = lambda a: torch.as_tensor(a, dtype=torch.int32).to(device).contiguous()
        cached = {
            "desc": i32(sched.packed_descriptors()),
            "piece_start": i32(starts),
            "piece_count": i32(counts),
            "piece_seg": i32(sched.piece_seg),
            "kv_batch": i32(batch).long(),
            "kv_head": i32(head),
            "kv_tile": i32(tile).long(),
            "kv_ok": i32(ok).bool(),
        }
        object.__setattr__(sched, key, cached)
    return cached


# ---------------------------------------------------------------- checks
def _check_operands(q_seg, k_rows, v_rows, seg_ctx, route, sched: LeanSchedule):
    if q_seg.dim() != 3 or k_rows.dim() != 3 or v_rows.shape != k_rows.shape:
        raise ValueError(
            f"expected q_seg (S, gq, d) and K/V rows (R, tile, d), got "
            f"{tuple(q_seg.shape)}, {tuple(k_rows.shape)}, {tuple(v_rows.shape)}"
        )
    S, gq, d = q_seg.shape
    if S != sched.num_segments:
        raise ValueError(f"q_seg has {S} segments, schedule {sched.num_segments}")
    if k_rows.shape[1:] != (sched.tile_size, d):
        raise ValueError(
            f"K/V rows {tuple(k_rows.shape)} do not hold tiles of "
            f"({sched.tile_size}, {d})"
        )
    if seg_ctx.shape != (S,) or route.dim() != 1 or route.shape[0] < sched.grid_iters:
        raise ValueError("seg_ctx must be (S,) and route (>= G*T,)")
    devices = {t.device for t in (q_seg, k_rows, v_rows, seg_ctx, route)}
    if len(devices) != 1:
        raise ValueError(f"operands lie on several devices: {sorted(map(str, devices))}")


def _check_cuda(q_seg, k_rows, v_rows, seg_ctx, route):
    """What the CUDA kernels accept; anything else raises."""
    gq = q_seg.shape[1]
    build.check_dtypes(q_seg, k_rows, v_rows)
    if seg_ctx.dtype != torch.int32 or route.dtype != torch.int32:
        raise TypeError("seg_ctx and route must be int32")
    if gq not in KERNEL_GQ:
        raise ValueError(f"kernels take gq in {KERNEL_GQ}, got {gq}")
    build.check_contiguous(q_seg=q_seg, k_rows=k_rows, v_rows=v_rows, seg_ctx=seg_ctx,
                           route=route)


def _check_no_scales(k_scales, v_scales):
    if k_scales is not None or v_scales is not None:
        raise NotImplementedError(
            "int8 KV scales are not ported yet (ROADMAP queue 1, item 9)"
        )


def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.lean_decode_partials_launch.argtypes = [
            I, P, P, P, P, I, I, I, P, P, P, P, P, I, I, I, F, P,
        ]
        lib.lean_decode_partials_launch.restype = I
        lib.lean_decode_fused_launch.argtypes = [
            I, P, P, P, P, I, I, I, P, P, P, P, P, P, P, P, P, P, I, I, I, F, P,
        ]
        lib.lean_decode_fused_launch.restype = I
        lib._argtypes_set = True
    return lib


# ------------------------------------------------------------ plain versions
def lean_decode_partials_plain(q_seg, k_rows, v_rows, seg_ctx, route,
                               sched: LeanSchedule, scale: float,
                               seg_qstart=None, chunk_cap: int = 1):
    """Plain PyTorch K1: walks the descriptor columns of every worker in
    step ``t`` order, as the kernel does, vectorised over the workers.
    Returns ``(o_p (P, gq, d), m_p (P, gq), l_p (P, gq))`` in float32.

    With ``seg_qstart`` it is K4's walk (:mod:`.lean_prefill`): the ``gq``
    rows are ``(g, chunk_cap)`` flattened chunk-minor and row ``r`` of
    segment ``s`` sees only keys at positions ``<= seg_qstart[s] + r %
    chunk_cap`` (the chunk-causal mask)."""
    S, gq, d = q_seg.shape
    dev = q_seg.device
    tile, G, T, P = sched.tile_size, sched.num_workers, sched.tiles_per_worker, sched.num_pieces
    desc = schedule_tensors(sched, dev)["desc"].long().view(7, G, T)
    rt = route[: G * T].long().view(G, T)
    ctx = seg_ctx.long()
    acc = torch.zeros(G, gq, d, dtype=torch.float32, device=dev)
    m = torch.full((G, gq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(G, gq, dtype=torch.float32, device=dev)
    o_p = torch.zeros(P + 1, gq, d, dtype=torch.float32, device=dev)
    m_p = torch.zeros(P + 1, gq, dtype=torch.float32, device=dev)
    l_p = torch.zeros(P + 1, gq, dtype=torch.float32, device=dev)
    pos = torch.arange(tile, device=dev)
    row_pos = torch.arange(gq, device=dev) % chunk_cap
    for t in range(T):
        col = desc[:, :, t]
        seg, tl, piece = col[DESC_SEG], col[DESC_TILE], col[DESC_PIECE]
        first, last = col[DESC_FIRST], col[DESC_LAST]
        ok = col[DESC_VALID] == OP_PARTIAL
        segc = torch.where(ok, seg, torch.zeros_like(seg))
        reset = ok & (first == 1)
        acc = torch.where(reset[:, None, None], torch.zeros_like(acc), acc)
        m = torch.where(reset[:, None], torch.full_like(m, NEG_INF), m)
        l = torch.where(reset[:, None], torch.zeros_like(l), l)

        vlen = (ctx[segc] - tl * tile).clamp(0, tile)
        in_len = pos[None, :] < vlen[:, None]                     # (G, tile)
        mask = in_len[:, None, :]                                 # (G, 1 | gq, tile)
        if seg_qstart is not None:
            qpos = seg_qstart.long()[segc][:, None] + row_pos[None, :]            # (G, gq)
            mask = mask & ((tl * tile)[:, None, None] + pos[None, None, :] <= qpos[..., None])
        q = q_seg[segc].float()                                   # (G, gq, d)
        k = k_rows[rt[:, t]].float()                              # (G, tile, d)
        v = torch.where(in_len[..., None], v_rows[rt[:, t]].float(), 0.0)
        s = torch.einsum("gqd,gtd->gqt", q, k) * scale
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(mask, p, torch.zeros_like(p))
        alpha = torch.exp(m - m_new)
        upd = ok[:, None]
        l = torch.where(upd, alpha * l + p.sum(dim=-1), l)
        acc = torch.where(
            upd[..., None], alpha[..., None] * acc + torch.einsum("gqt,gtd->gqd", p, v), acc
        )
        m = torch.where(upd, m_new, m)

        flush = (ok & (last == 1)).nonzero().flatten()
        o_p[piece[flush]] = acc[flush]
        m_p[piece[flush]] = m[flush]
        l_p[piece[flush]] = l[flush]
    return o_p[:P], m_p[:P], l_p[:P]


def merge_pieces_plain(o_p, m_p, l_p, sched: LeanSchedule):
    """K2's fix-up in plain PyTorch: each segment folds its pieces in piece
    order with the fused kernel's merge update. Returns ``(o (S, gq, d),
    lse (S, gq))``."""
    dev = o_p.device
    S, gq, d = sched.num_segments, o_p.shape[1], o_p.shape[2]
    st = schedule_tensors(sched, dev)
    starts, counts = st["piece_start"].long(), st["piece_count"].long()
    acc = torch.zeros(S, gq, d, dtype=torch.float32, device=dev)
    m = torch.full((S, gq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(S, gq, dtype=torch.float32, device=dev)
    for k in range(int(sched.piece_ranges()[1].max(initial=0))):
        has = (counts > k)[:, None]
        p = torch.where(counts > k, starts + k, torch.zeros_like(starts))
        mp, lp, op = m_p[p], l_p[p], o_p[p]
        m_new = torch.maximum(m, mp)
        a_old = torch.exp(m - m_new)
        a_new = torch.exp(mp - m_new)
        l = torch.where(has, a_old * l + a_new * lp, l)
        acc = torch.where(has[..., None], a_old[..., None] * acc + a_new[..., None] * op, acc)
        m = torch.where(has, m_new, m)
    return acc / l[..., None], m + torch.log(l)


def lean_decode_fused_plain(q_seg, k_rows, v_rows, seg_ctx, route,
                            sched: LeanSchedule, scale: float):
    """Plain PyTorch K2: the K1 walk, then the per-segment piece-order merge."""
    o_p, m_p, l_p = lean_decode_partials_plain(
        q_seg, k_rows, v_rows, seg_ctx, route, sched, scale
    )
    return merge_pieces_plain(o_p, m_p, l_p, sched)


# ---------------------------------------------------------------- wrappers
def lean_decode_partials(q_seg, k_rows, v_rows, seg_ctx, route,
                         sched: LeanSchedule, scale: float,
                         k_scales=None, v_scales=None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1. ``q_seg (S, gq, d)``; ``k_rows``/``v_rows (R, tile, d)``;
    ``seg_ctx (S,)`` int32 runtime lengths; ``route (>= G*T,)`` int32 pool
    row per descriptor column. Returns float32 ``(o_p (P, gq, d), m_p (P,
    gq), l_p (P, gq))``: per-piece un-scaled partials."""
    global partials_launches
    _check_no_scales(k_scales, v_scales)
    _check_operands(q_seg, k_rows, v_rows, seg_ctx, route, sched)
    if q_seg.device.type == "cpu":
        return lean_decode_partials_plain(q_seg, k_rows, v_rows, seg_ctx, route, sched, scale)
    _check_cuda(q_seg, k_rows, v_rows, seg_ctx, route)
    S, gq, d = q_seg.shape
    P = sched.num_pieces
    st = schedule_tensors(sched, q_seg.device)
    o_p = torch.empty(P + 1, gq, d, dtype=torch.float32, device=q_seg.device)
    m_p = torch.empty(P + 1, gq, dtype=torch.float32, device=q_seg.device)
    l_p = torch.empty(P + 1, gq, dtype=torch.float32, device=q_seg.device)
    err = _library().lean_decode_partials_launch(
        build.DTYPE_CODE[q_seg.dtype], build.ptr(q_seg), build.ptr(k_rows), build.ptr(v_rows),
        build.ptr(st["desc"]), sched.grid_iters, sched.tiles_per_worker,
        sched.num_workers, build.ptr(seg_ctx), build.ptr(route),
        build.ptr(o_p), build.ptr(m_p), build.ptr(l_p), gq, d, sched.tile_size, float(scale),
        build.stream(q_seg.device),
    )
    build.check_launch(err, "lean_decode_partials (K1)")
    partials_launches += 1
    return o_p[:P], m_p[:P], l_p[:P]


def lean_decode_fused(q_seg, k_rows, v_rows, seg_ctx, route,
                      sched: LeanSchedule, scale: float,
                      k_scales=None, v_scales=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: operands as :func:`lean_decode_partials`. Returns float32
    ``(o (S, gq, d), lse (S, gq))``."""
    global fused_launches
    _check_no_scales(k_scales, v_scales)
    _check_operands(q_seg, k_rows, v_rows, seg_ctx, route, sched)
    if q_seg.device.type == "cpu":
        return lean_decode_fused_plain(q_seg, k_rows, v_rows, seg_ctx, route, sched, scale)
    _check_cuda(q_seg, k_rows, v_rows, seg_ctx, route)
    S, gq, d = q_seg.shape
    P, dev = sched.num_pieces, q_seg.device
    st = schedule_tensors(sched, dev)
    o_p = torch.empty(P + 1, gq, d, dtype=torch.float32, device=dev)
    m_p = torch.empty(P + 1, gq, dtype=torch.float32, device=dev)
    l_p = torch.empty(P + 1, gq, dtype=torch.float32, device=dev)
    arrivals = torch.zeros(S, dtype=torch.int32, device=dev)
    o = torch.empty(S, gq, d, dtype=torch.float32, device=dev)
    lse = torch.empty(S, gq, dtype=torch.float32, device=dev)
    err = _library().lean_decode_fused_launch(
        build.DTYPE_CODE[q_seg.dtype], build.ptr(q_seg), build.ptr(k_rows), build.ptr(v_rows),
        build.ptr(st["desc"]), sched.grid_iters, sched.tiles_per_worker,
        sched.num_workers, build.ptr(seg_ctx), build.ptr(route),
        build.ptr(st["piece_start"]), build.ptr(st["piece_count"]), build.ptr(arrivals),
        build.ptr(o_p), build.ptr(m_p), build.ptr(l_p), build.ptr(o), build.ptr(lse),
        gq, d, sched.tile_size, float(scale),
        build.stream(dev),
    )
    build.check_launch(err, "lean_decode_fused (K2)")
    fused_launches += 1
    return o, lse
