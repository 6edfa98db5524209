"""Stream-K decode attention: Hopper kernels K1, K2, K3 and K5 and their
plain PyTorch versions.

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
    and the CTA that completes a segment merges it in piece order and sets
    the counter back to 0 (:func:`arrival_counters`).
  * K3, :func:`lean_merge` -- phase 2 as a kernel: each segment's pieces
    folded in piece order into ``o = acc / l`` and ``lse = m + log l``.
    Replaces ``repro/kernels/lean_decode.py:813`` ``_lean_merge_kernel``
    (driven by ``lean_merge_pallas`` ``:852``). ``csrc/lean_merge.cu``.
  * K5, :func:`lean_cascade_fused` -- cascade (prefix-grouped) decode in
    one launch: the grouped prefix pass over shared pages, the per-sequence
    suffix pass and the merge per target sequence. Replaces
    ``repro/kernels/lean_decode.py:604`` ``_lean_cascade_fused_kernel``
    (driven by ``lean_cascade_fused`` ``:715``). ``csrc/lean_cascade.cu``:
    K2's last-arriver fix-up applied to targets instead of segments. A
    worker streams its columns' tiles through the decode ring
    (``csrc/attn_decode_ring.cuh``) where :func:`ring_slots` says it
    fits, and walks them in device memory elsewhere
    (``csrc/lean_cascade_walk.cu``); its last arriver folds each target's
    pieces with K2's batched fold. Both walks and the fold keep the order
    of every sum, so the bits are the same either way.

K1 and K2 are CUDA C++ for ``sm_90a`` in ``csrc/lean_decode.cu`` (see the
note there on what bounds them: the K/V bytes read, since decode at ``gq =
4`` sits far below the bf16 ridge point, and the latency of a worker's
short chain of tiles). A worker streams its columns' tiles through the
decode ring (``csrc/attn_decode_ring.cuh``) where :func:`ring_slots` says it
fits, and walks them in device memory elsewhere
(``csrc/lean_decode_walk.cu``); K2's last arriver folds a segment's pieces
several loads at a time. Both walks give the same bits. They take up to
``MAX_ROWS`` query rows per segment, so K1 also runs the cascade's prefix
pass with the stacked member rows. The wrappers take the paged layout:
K/V as pool rows ``(R, tile, d)`` and a per-column ``route`` into them.
Dense KV reaches the same kernels through a route over its own rows
(:func:`repro_torch.kernels.ops`), so dense and paged decode are
bit-identical.

int8 pools (the reference's ``quantized=True`` bodies): with ``k_scales`` /
``v_scales`` -- one float32 scale per pool row ``(R,)`` -- K1, K2, K4 and
K5 take int8 K/V rows. Each tile is widened to float32 and multiplied by its
routed row's scale before QK^T and PV, as the reference's
``_online_softmax_tile`` does (``repro/kernels/lean_decode.py:74-114``);
everything after the load is the float path's softmax and merge. On the
card the queries are bf16 (the model's dtype) and the scales contiguous
float32.

A wrapper launches its kernel for CUDA tensors and runs the plain version
for CPU tensors -- only because the tensors lie on the CPU; there is no
fallback from a failed launch. The plain versions walk the same descriptors
in the same order (vectorised over the G workers at each step ``t``) and
serve the CPU tests and the on-card comparison in ``chip_smoke.py``.
``partials_launches`` / ``fused_launches`` / ``merge_launches`` /
``cascade_launches`` count kernel launches (plain runs do not count);
``partials_ring_launches`` / ``fused_ring_launches`` /
``cascade_ring_launches`` those of K1, K2 and K5 on the ring.
"""
from __future__ import annotations

import ctypes
from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.attention import F8, NEG_INF, widen_kv
from repro_torch.core.leantile import CascadeSchedule, LeanSchedule
from repro_torch.core.merge import merge_grid
from . import build, decode_ring

# descriptor rows of LeanSchedule.packed_descriptors(); VALID is 1 on a
# LeanTile column (OP_PARTIAL) and 0 on padding
DESC_SEG, DESC_TILE, DESC_PIECE, DESC_FIRST, DESC_LAST, DESC_LEN, DESC_VALID = range(7)
OP_PARTIAL = 1

SOURCE = "lean_decode.cu"                     # K1 and K2 on the decode ring
WALK_SOURCE = "lean_decode_walk.cu"           # K1 and K2 where the ring does not fit
CASCADE_SOURCE = "lean_cascade.cu"            # K5 on the decode ring
CASCADE_WALK_SOURCE = "lean_cascade_walk.cu"  # K5 where the ring does not fit
MERGE_SOURCE = "lean_merge.cu"
# the row buckets of the query heads per KV head (g) that K5 takes for its
# suffix rows: any g up to the last (rows past g are zero)
KERNEL_GQ = (2, 4, 8)
WALK_MAX_G = 4        # K5's walk over device memory takes g up to 4 (CASCADE_MAX_GB)
# query rows per segment that K1, K2 and K5's prefix pass take (instantiated
# for row buckets 2, 4, ..., 64; rows past the count are zero)
MAX_ROWS = 64
MAX_TARGETS = 64      # targets one K5 piece can feed (its pass's members)

# launch counters: +1 per kernel launch, nowhere else
partials_launches = 0
fused_launches = 0
merge_launches = 0
cascade_launches = 0
# those of K1, K2 and K5 on the decode ring
partials_ring_launches = 0
fused_ring_launches = 0
cascade_ring_launches = 0


def reset_launch_counts() -> None:
    global partials_launches, fused_launches, merge_launches, cascade_launches
    global partials_ring_launches, fused_ring_launches, cascade_ring_launches
    partials_launches = 0
    fused_launches = 0
    merge_launches = 0
    cascade_launches = 0
    partials_ring_launches = 0
    fused_ring_launches = 0
    cascade_ring_launches = 0


# ------------------------------------------------------------ schedule data
def schedule_memo(sched, name: str, device: torch.device, make: Callable[[], Any]) -> Any:
    """``make()`` memoized on the schedule (a :class:`LeanSchedule` or a
    :class:`CascadeSchedule`) under ``name`` per device: device operands
    that depend on the schedule alone are built once, on its first call.
    A first call inside a CUDA graph capture raises: what it built would
    be filled in only when the graph replays, and the capture cannot take
    a host-to-device copy, so a captured step is run eagerly once first."""
    key = f"_torch_{name}_{device}"
    cached = sched.__dict__.get(key)
    if cached is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"schedule operand {name!r} first built inside a CUDA graph capture: "
                "run the step eagerly once before capturing it"
            )
        cached = make()
        object.__setattr__(sched, key, cached)
    return cached


def arrival_counters(sched, shape: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The zeroed int32 arrival counters of a fix-up kernel (K2, K5, the
    fused K4) on ``sched``, one buffer per schedule, device and shape: the
    last arriver at a segment (target, row block) sets its counter back to
    0, so every launch finds the buffer zeroed and none launches a memset
    of its own. Launches that share a buffer run one after another on one
    stream."""
    return schedule_memo(sched, f"arrivals_{'x'.join(map(str, shape))}", device,
                         lambda: torch.zeros(shape, dtype=torch.int32, device=device))


def schedule_tensors(sched: LeanSchedule, device: torch.device) -> Dict[str, Any]:
    """The schedule's kernel operands as int32 tensors on ``device``:
    packed descriptors ``(7, G*T)``, piece ranges, the paged routing
    metadata, and ``segment_merge``'s grid of the pieces (``merge_grid``, a
    :class:`repro_torch.core.merge.MergeGrid` from the host ``piece_seg``,
    so the two-phase merge syncs nothing). Memoized on the schedule per
    device (like the reference's packed descriptors, :func:`schedule_memo`),
    so a schedule-cache hit uploads nothing."""

    def make():
        starts, counts = sched.piece_ranges()
        batch, head, tile, ok = sched.iter_kv_meta(fused=False)
        i32 = lambda a: torch.as_tensor(a, dtype=torch.int32).to(device).contiguous()
        return {
            "desc": i32(sched.packed_descriptors()),
            "piece_start": i32(starts),
            "piece_count": i32(counts),
            "piece_seg": i32(sched.piece_seg),
            "kv_batch": i32(batch).long(),
            "kv_head": i32(head),
            "kv_tile": i32(tile).long(),
            "kv_ok": i32(ok).bool(),
            "merge_grid": merge_grid(sched.piece_seg, sched.num_segments, device),
        }

    return schedule_memo(sched, "operands", device, make)


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


def _check_cuda(q_seg, k_rows, v_rows, seg_ctx, route, sched: LeanSchedule, what: str) -> int:
    """What the CUDA kernels accept; anything else raises. Returns the
    decode ring's slots for the operands (0: the walk over device memory)."""
    S, gq, d = q_seg.shape
    build.check_dtypes(q_seg, k_rows, v_rows)
    if seg_ctx.dtype != torch.int32 or route.dtype != torch.int32:
        raise TypeError("seg_ctx and route must be int32")
    if not 1 <= gq <= MAX_ROWS:
        raise ValueError(f"kernels take 1 to {MAX_ROWS} query rows per segment, got {gq}")
    build.check_contiguous(q_seg=q_seg, k_rows=k_rows, v_rows=v_rows, seg_ctx=seg_ctx,
                           route=route)
    ns = ring_slots(k_rows.dtype, gq, d, sched.tile_size)
    if ns:
        decode_ring.check_aligned(what, k_rows=k_rows, v_rows=v_rows)
    else:
        check_f8_ring(what, k_rows.dtype, gq, d, sched.tile_size)
    return ns


def check_f8_ring(what: str, kv_dtype: torch.dtype, rows: int, d: int, tile: int):
    """e4m3 rows run on the decode ring only (the walks over device memory
    have no f8 form): raise where the ring does not fit."""
    if kv_dtype == F8:
        raise ValueError(f"{what}: e4m3 K/V rows run on the decode ring only, which does not "
                         f"fit {rows} query rows at d {d} on tiles of {tile}")


def ring_slots(kv_dtype: torch.dtype, rows: int, d: int, tile: int) -> int:
    """Slots of K1's, K2's and K5's decode ring for K/V rows of ``kv_dtype``
    (int8 pools: ``torch.int8``) and ``rows`` query rows per segment (K5:
    its stacked prefix rows), whose row bucket sizes the CTA's float state
    (0: the walk over device memory)."""
    elem = 1 if kv_dtype == torch.int8 else torch.finfo(kv_dtype).bits // 8
    return decode_ring.ring_slots(elem, d, tile, decode_ring.row_bucket(rows))


def scale_rows(k_rows, k_scales, v_scales):
    """An int8 pool's scales -- ``(R,)``, or ``(num_pages, Hkv)`` for the
    ``(num_pages * Hkv, ...)`` pool rows -- as one contiguous float32 scale
    per pool row ``(R,)`` (a view where they are already so); ``None, None``
    for a float pool. Scales come with int8 K/V rows and only with them."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales come together")
    if (k_scales is not None) != (k_rows.dtype == torch.int8):
        raise ValueError("int8 K/V rows take k_scales/v_scales, float rows none")
    if k_scales is None:
        return None, None
    R = k_rows.shape[0]
    out = []
    for t in (k_scales, v_scales):
        if t.numel() != R or t.device != k_rows.device:
            raise ValueError(f"scales must hold one value per pool row ({R}) on the pool's device")
        out.append(t.reshape(R).float().contiguous())
    return out[0], out[1]


def _deq(rows, scales, idx):
    """Pool rows ``idx`` widened to float32, times their scales if int8."""
    x = rows[idx].float()
    return x if scales is None else x * scales[idx][..., None, None]


P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ENTRY_POINTS = {
    SOURCE: {
        "lean_decode_partials_launch": [
            I_, P_, P_, P_, P_, P_, P_, I_, I_, I_, P_, P_, P_, P_, P_, I_, I_, I_, F_, I_, P_,
        ],
        "lean_decode_fused_launch": [
            I_, P_, P_, P_, P_, P_, P_, I_, I_, I_, P_, P_, P_, P_, P_, P_, P_, P_, P_, P_,
            I_, I_, I_, F_, I_, P_,
        ],
    },
    MERGE_SOURCE: {
        "lean_merge_launch": [P_, P_, P_, P_, P_, P_, P_, I_, I_, I_, P_],
    },
    CASCADE_SOURCE: {
        "lean_cascade_fused_launch": [
            I_, P_, P_, P_, P_, P_, P_, P_, I_, I_, I_, I_, I_, P_, P_, P_, P_, P_, P_, P_,
            P_, P_, P_, P_, P_, I_, I_, I_, I_, I_, F_, I_, P_,
        ],
    },
}
_ENTRY_POINTS[WALK_SOURCE] = _ENTRY_POINTS[SOURCE]
_ENTRY_POINTS[CASCADE_WALK_SOURCE] = _ENTRY_POINTS[CASCADE_SOURCE]


def _library(source: str = SOURCE) -> ctypes.CDLL:
    lib = build.load(source)
    if not getattr(lib, "_argtypes_set", False):
        for name, argtypes in _ENTRY_POINTS[source].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = I_
        lib._argtypes_set = True
    return lib


# ------------------------------------------------------------ plain versions
def lean_decode_partials_plain(q_seg, k_rows, v_rows, seg_ctx, route,
                               sched: LeanSchedule, scale: float,
                               seg_qstart=None, chunk_cap: int = 1,
                               k_scales=None, v_scales=None):
    """Plain PyTorch K1: walks the descriptor columns of every worker in
    step ``t`` order, as the kernel does, vectorised over the workers.
    Returns ``(o_p (P, gq, d), m_p (P, gq), l_p (P, gq))`` in float32.
    ``k_scales``/``v_scales`` (``(R,)`` float32) dequantize int8 rows: each
    tile is widened and multiplied by its row's scale before the products.
    e4m3 rows (the f8 pools) are widened to bf16 first: an f8 form's plain
    version is its bf16 form's on the widened rows.

    With ``seg_qstart`` it is K4's walk (:mod:`.lean_prefill`): the ``gq``
    rows are ``(g, chunk_cap)`` flattened chunk-minor and row ``r`` of
    segment ``s`` sees only keys at positions ``<= seg_qstart[s] + r %
    chunk_cap`` (the chunk-causal mask)."""
    S, gq, d = q_seg.shape
    dev = q_seg.device
    tile, G, T, P = sched.tile_size, sched.num_workers, sched.tiles_per_worker, sched.num_pieces
    ks, vs = scale_rows(k_rows, k_scales, v_scales)
    k_rows, v_rows = widen_kv(k_rows), widen_kv(v_rows)
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
        k = _deq(k_rows, ks, rt[:, t])                            # (G, tile, d)
        v = torch.where(in_len[..., None], _deq(v_rows, vs, rt[:, t]), 0.0)
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


def _neg_inf(x: torch.Tensor) -> torch.Tensor:
    return torch.isinf(x) & (x < 0)


def _fold(acc, m, l, op, mp, lp, has):
    """One merge step of the kernels' fix-ups (``attn::merge_piece``):
    where ``has``, fold the piece ``(op, mp, lp)`` into ``(acc, m, l)``,
    a side whose max is -inf weighing 0 (the guards of core/merge.py)."""
    m_new = torch.maximum(m, mp)
    a_old = torch.where(_neg_inf(m), 0.0, torch.exp(m - m_new))
    a_new = torch.where(_neg_inf(mp), 0.0, torch.exp(mp - m_new))
    l = torch.where(has, a_old * l + a_new * lp, l)
    acc = torch.where(has[..., None], a_old[..., None] * acc + a_new[..., None] * op, acc)
    return acc, torch.where(has, m_new, m), l


def merge_pieces_plain(o_p, m_p, l_p, sched: LeanSchedule):
    """K2's fix-up and K3 in plain PyTorch: each segment folds its pieces in
    piece order. Returns ``(o (S, gq, d), lse (S, gq))``."""
    acc, m, l = fold_pieces_plain(o_p, m_p, l_p, sched)
    return acc / l[..., None], m + torch.log(l)


def fold_pieces_plain(o_p, m_p, l_p, sched: LeanSchedule):
    """Each segment's pieces folded in piece order (``attn::merge_piece``,
    the order of the kernels' fix-ups). Returns the un-normalised ``(acc
    (S, gq, d), m (S, gq), l (S, gq))``."""
    dev = o_p.device
    S, gq, d = sched.num_segments, o_p.shape[1], o_p.shape[2]
    st = schedule_tensors(sched, dev)
    starts, counts = st["piece_start"].long(), st["piece_count"].long()
    acc = torch.zeros(S, gq, d, dtype=torch.float32, device=dev)
    m = torch.full((S, gq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(S, gq, dtype=torch.float32, device=dev)
    for k in range(int(sched.piece_ranges()[1].max(initial=0))):
        has = (counts > k)[:, None].expand(S, gq)
        p = torch.where(counts > k, starts + k, torch.zeros_like(starts))
        acc, m, l = _fold(acc, m, l, o_p[p], m_p[p], l_p[p], has)
    return acc, m, l


def lean_decode_fused_plain(q_seg, k_rows, v_rows, seg_ctx, route,
                            sched: LeanSchedule, scale: float, k_scales=None, v_scales=None):
    """Plain PyTorch K2: the K1 walk, then the per-segment piece-order merge."""
    o_p, m_p, l_p = lean_decode_partials_plain(
        q_seg, k_rows, v_rows, seg_ctx, route, sched, scale,
        k_scales=k_scales, v_scales=v_scales,
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
    gq), l_p (P, gq))``: per-piece un-scaled partials. int8 rows take
    ``k_scales``/``v_scales``, one float32 scale per pool row; e4m3 rows
    (bf16 queries) none, and run on the decode ring only."""
    global partials_launches, partials_ring_launches
    _check_operands(q_seg, k_rows, v_rows, seg_ctx, route, sched)
    ks, vs = scale_rows(k_rows, k_scales, v_scales)
    if q_seg.device.type == "cpu":
        return lean_decode_partials_plain(q_seg, k_rows, v_rows, seg_ctx, route, sched, scale,
                                          k_scales=ks, v_scales=vs)
    ns = _check_cuda(q_seg, k_rows, v_rows, seg_ctx, route, sched, "lean_decode_partials (K1)")
    S, gq, d = q_seg.shape
    P = sched.num_pieces
    st = schedule_tensors(sched, q_seg.device)
    o_p = torch.empty(P + 1, gq, d, dtype=torch.float32, device=q_seg.device)
    m_p = torch.empty(P + 1, gq, dtype=torch.float32, device=q_seg.device)
    l_p = torch.empty(P + 1, gq, dtype=torch.float32, device=q_seg.device)
    err = _library(SOURCE if ns else WALK_SOURCE).lean_decode_partials_launch(
        build.dtype_code(q_seg, k_rows), build.ptr(q_seg), build.ptr(k_rows), build.ptr(v_rows),
        build.ptr(ks), build.ptr(vs), build.ptr(st["desc"]), sched.grid_iters, sched.tiles_per_worker,
        sched.num_workers, build.ptr(seg_ctx), build.ptr(route),
        build.ptr(o_p), build.ptr(m_p), build.ptr(l_p), gq, d, sched.tile_size, float(scale), ns,
        build.stream(q_seg.device),
    )
    build.check_launch(err, "lean_decode_partials (K1)")
    partials_launches += 1
    partials_ring_launches += int(ns > 0)
    return o_p[:P], m_p[:P], l_p[:P]


def lean_decode_fused(q_seg, k_rows, v_rows, seg_ctx, route,
                      sched: LeanSchedule, scale: float,
                      k_scales=None, v_scales=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: operands as :func:`lean_decode_partials`. Returns float32
    ``(o (S, gq, d), lse (S, gq))``."""
    global fused_launches, fused_ring_launches
    _check_operands(q_seg, k_rows, v_rows, seg_ctx, route, sched)
    ks, vs = scale_rows(k_rows, k_scales, v_scales)
    if q_seg.device.type == "cpu":
        return lean_decode_fused_plain(q_seg, k_rows, v_rows, seg_ctx, route, sched, scale,
                                       k_scales=ks, v_scales=vs)
    ns = _check_cuda(q_seg, k_rows, v_rows, seg_ctx, route, sched, "lean_decode_fused (K2)")
    S, gq, d = q_seg.shape
    P, dev = sched.num_pieces, q_seg.device
    st = schedule_tensors(sched, dev)
    o_p = torch.empty(P + 1, gq, d, dtype=torch.float32, device=dev)
    m_p = torch.empty(P + 1, gq, dtype=torch.float32, device=dev)
    l_p = torch.empty(P + 1, gq, dtype=torch.float32, device=dev)
    arrivals = arrival_counters(sched, (S,), dev)
    o = torch.empty(S, gq, d, dtype=torch.float32, device=dev)
    lse = torch.empty(S, gq, dtype=torch.float32, device=dev)
    err = _library(SOURCE if ns else WALK_SOURCE).lean_decode_fused_launch(
        build.dtype_code(q_seg, k_rows), build.ptr(q_seg), build.ptr(k_rows), build.ptr(v_rows),
        build.ptr(ks), build.ptr(vs), build.ptr(st["desc"]), sched.grid_iters, sched.tiles_per_worker,
        sched.num_workers, build.ptr(seg_ctx), build.ptr(route),
        build.ptr(st["piece_start"]), build.ptr(st["piece_count"]), build.ptr(arrivals),
        build.ptr(o_p), build.ptr(m_p), build.ptr(l_p), build.ptr(o), build.ptr(lse),
        gq, d, sched.tile_size, float(scale), ns,
        build.stream(dev),
    )
    build.check_launch(err, "lean_decode_fused (K2)")
    fused_launches += 1
    fused_ring_launches += int(ns > 0)
    return o, lse


# -------------------------------------------------------------------- K3
def lean_merge(o_p, m_p, l_p, sched: LeanSchedule) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: the per-segment reduction of stream-K partials, the port of
    ``lean_merge_pallas``. ``o_p (P, rows, d)``, ``m_p``/``l_p (P, rows)``
    float32 (K1's or K4's output); segment ``s`` owns piece rows
    ``[start, start + count)`` of ``sched.piece_ranges()``. Returns float32
    ``(o (S, rows, d), lse (S, rows))``. Launches no host sync: the piece
    ranges are the schedule's, uploaded once per schedule."""
    global merge_launches
    if o_p.dim() != 3 or m_p.shape != o_p.shape[:2] or l_p.shape != m_p.shape:
        raise ValueError(
            f"expected o_p (P, rows, d) and m_p, l_p (P, rows), got {tuple(o_p.shape)}, "
            f"{tuple(m_p.shape)}, {tuple(l_p.shape)}"
        )
    if o_p.shape[0] != sched.num_pieces:
        raise ValueError(f"partials hold {o_p.shape[0]} pieces, schedule {sched.num_pieces}")
    if o_p.device.type == "cpu":
        return merge_pieces_plain(o_p, m_p, l_p, sched)
    if any(t.dtype != torch.float32 for t in (o_p, m_p, l_p)):
        raise TypeError("K3 takes float32 partials")
    build.check_contiguous(o_p=o_p, m_p=m_p, l_p=l_p)
    S, (P, rows, d), dev = sched.num_segments, o_p.shape, o_p.device
    st = schedule_tensors(sched, dev)
    o = torch.empty(S, rows, d, dtype=torch.float32, device=dev)
    lse = torch.empty(S, rows, dtype=torch.float32, device=dev)
    err = _library(MERGE_SOURCE).lean_merge_launch(
        build.ptr(o_p), build.ptr(m_p), build.ptr(l_p), build.ptr(st["piece_start"]),
        build.ptr(st["piece_count"]), build.ptr(o), build.ptr(lse), S, rows, d,
        build.stream(dev),
    )
    build.check_launch(err, "lean_merge (K3)")
    merge_launches += 1
    return o, lse


# -------------------------------------------------------------------- K5
class CascadeFusedDesc(NamedTuple):
    """K5's descriptor operands on the device: the fused cascade
    descriptors (:func:`repro_torch.core.leantile.cascade_fused_descriptors`)
    and the target tables derived from their merge section -- each target's
    first merge column and column count, and, per piece, the targets it
    feeds (CSR)."""

    desc: torch.Tensor        # (7, N) int32
    tgt_start: torch.Tensor   # (B*Hkv,) int32 descriptor column
    tgt_count: torch.Tensor   # (B*Hkv,) int32
    pt_start: torch.Tensor    # (P_tot + 2,) int32
    pt_tgt: torch.Tensor      # (live merge columns,) int32


def cascade_fused_desc(desc: np.ndarray, csched: CascadeSchedule,
                       device: torch.device) -> CascadeFusedDesc:
    """Upload the fused cascade descriptors with K5's target tables
    (:func:`cascade_fused_desc_arrays`)."""
    i32 = lambda a: torch.as_tensor(a).to(device).contiguous()
    return CascadeFusedDesc(*map(i32, cascade_fused_desc_arrays(desc, csched)))


def cascade_fused_desc_arrays(desc: np.ndarray, csched: CascadeSchedule) -> CascadeFusedDesc:
    """The fused cascade descriptors and K5's target tables derived from
    their merge section, where each target's columns are contiguous,
    targets in order, padding (target ``B*Hkv``) last: a
    :class:`CascadeFusedDesc` of int32 host arrays."""
    desc = np.ascontiguousarray(desc, dtype=np.int32)
    S = csched.batch * csched.num_kv_heads
    Ptot = csched.num_pieces_total
    n_part = csched.prefix_sched.grid_iters + csched.suffix_sched.grid_iters
    if desc.shape != (7, csched.fused_grid_iters):
        raise ValueError(f"descriptors {desc.shape} do not fit the schedule "
                         f"(7, {csched.fused_grid_iters})")
    seg, piece = desc[DESC_SEG, n_part:], desc[DESC_PIECE, n_part:]
    live = np.flatnonzero(seg < S)
    tgt, src = seg[live], piece[live]
    if np.any(np.diff(tgt) < 0) or np.any(np.diff(live) != 1) or (len(live) and live[0] != 0):
        raise ValueError("merge columns are not grouped by target")
    tgt_count = np.bincount(tgt, minlength=S)
    tgt_start = n_part + np.concatenate([[0], np.cumsum(tgt_count)[:-1]])
    order = np.argsort(src, kind="stable")
    per_piece = np.bincount(src, minlength=Ptot + 1)
    if per_piece.max(initial=0) > MAX_TARGETS:
        raise ValueError(f"a piece feeds {per_piece.max()} targets, K5 takes {MAX_TARGETS}")
    pt_start = np.concatenate([[0], np.cumsum(per_piece)])
    i32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)
    return CascadeFusedDesc(desc=desc, tgt_start=i32(tgt_start), tgt_count=i32(tgt_count),
                            pt_start=i32(pt_start), pt_tgt=i32(tgt[order]))


def _check_cascade(q_pref, q_suf, k_rows, v_rows, ctx_all, route, csched: CascadeSchedule):
    nph = csched.num_groups * csched.num_kv_heads
    S = csched.batch * csched.num_kv_heads
    if q_pref.dim() != 3 or q_suf.dim() != 3 or q_pref.shape[0] != nph or q_suf.shape[0] != S:
        raise ValueError(
            f"expected q_pref ({nph}, qmax, d) and q_suf ({S}, g, d), got "
            f"{tuple(q_pref.shape)}, {tuple(q_suf.shape)}"
        )
    d = q_suf.shape[2]
    if q_pref.shape[2] != d or q_pref.shape[1] != csched.group_size * q_suf.shape[1]:
        raise ValueError("q_pref must stack group_size x g query rows of q_suf's width")
    if k_rows.dim() != 3 or v_rows.shape != k_rows.shape or k_rows.shape[1:] != (
            csched.tile_size, d):
        raise ValueError(f"K/V rows {tuple(k_rows.shape)} do not hold tiles of "
                         f"({csched.tile_size}, {d})")
    n_part = csched.prefix_sched.grid_iters + csched.suffix_sched.grid_iters
    if ctx_all.shape != (nph + S,) or route.dim() != 1 or route.shape[0] < n_part:
        raise ValueError(f"ctx_all must be ({nph + S},) and route (>= {n_part},)")
    devices = {t.device for t in (q_pref, q_suf, k_rows, v_rows, ctx_all, route)}
    if len(devices) != 1:
        raise ValueError(f"operands lie on several devices: {sorted(map(str, devices))}")


def lean_cascade_fused_plain(q_pref, q_suf, k_rows, v_rows, ctx_all, route,
                             fdesc: CascadeFusedDesc, csched: CascadeSchedule, scale: float,
                             k_scales=None, v_scales=None):
    """Plain PyTorch K5: the K1 walk of the prefix phase and of the suffix
    phase (the fused descriptors' partial section), the pieces laid out as
    the kernel's scratch ``(P_tot + 1, qmax, d)``, then each target's merge
    columns in descriptor order (vectorised over the targets)."""
    pre, suf = csched.prefix_sched, csched.suffix_sched
    nph = csched.num_groups * csched.num_kv_heads
    S, g, d = q_suf.shape
    qmax, dev = q_pref.shape[1], q_pref.device
    sc = dict(k_scales=k_scales, v_scales=v_scales)
    parts_p = lean_decode_partials_plain(q_pref, k_rows, v_rows, ctx_all[:nph],
                                         route[: pre.grid_iters], pre, scale, **sc)
    parts_s = lean_decode_partials_plain(q_suf, k_rows, v_rows, ctx_all[nph:],
                                         route[pre.grid_iters:], suf, scale, **sc)
    Pp, Ptot = pre.num_pieces, csched.num_pieces_total
    o_all = torch.zeros(Ptot + 1, qmax, d, dtype=torch.float32, device=dev)
    m_all = torch.zeros(Ptot + 1, qmax, dtype=torch.float32, device=dev)
    l_all = torch.zeros(Ptot + 1, qmax, dtype=torch.float32, device=dev)
    for full, pp, ps in zip((o_all, m_all, l_all), parts_p, parts_s):
        full[:Pp] = pp
        full[Pp:Ptot, :g] = ps
    desc = fdesc.desc.long()
    start, count = fdesc.tgt_start.long(), fdesc.tgt_count.long()
    acc = torch.zeros(S, g, d, dtype=torch.float32, device=dev)
    m = torch.full((S, g), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(S, g, dtype=torch.float32, device=dev)
    rows = torch.arange(g, device=dev)
    for k in range(int(count.max())):
        has = count > k
        col = torch.where(has, start + k, torch.zeros_like(start))
        piece = desc[DESC_PIECE, col]
        row = desc[DESC_TILE, col][:, None] * g + rows[None, :]          # (S, g)
        acc, m, l = _fold(acc, m, l, o_all[piece[:, None], row], m_all[piece[:, None], row],
                          l_all[piece[:, None], row], has[:, None].expand(S, g))
    return acc / l[..., None], m + torch.log(l)


def lean_cascade_fused(q_pref, q_suf, k_rows, v_rows, ctx_all, route,
                       fdesc: CascadeFusedDesc, csched: CascadeSchedule, scale: float,
                       k_scales=None, v_scales=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5. ``q_pref (NP*Hkv, qmax, d)``: each prefix segment's stacked
    member queries (``qmax = group_size * g``); ``q_suf (B*Hkv, g, d)``;
    ``k_rows``/``v_rows (R, tile, d)`` pool rows; ``ctx_all (NP*Hkv +
    B*Hkv,)`` int32 runtime lengths, prefix segments first; ``route`` int32
    pool row per partial column, prefix columns first; ``fdesc`` from
    :func:`cascade_fused_desc`; int8 rows take ``k_scales``/``v_scales``.
    Returns float32 ``(o (B*Hkv, g, d), lse (B*Hkv, g))``."""
    global cascade_launches, cascade_ring_launches
    _check_cascade(q_pref, q_suf, k_rows, v_rows, ctx_all, route, csched)
    ks, vs = scale_rows(k_rows, k_scales, v_scales)
    if q_pref.device.type == "cpu":
        return lean_cascade_fused_plain(q_pref, q_suf, k_rows, v_rows, ctx_all, route, fdesc,
                                        csched, scale, k_scales=ks, v_scales=vs)
    build.check_dtypes(q_suf, k_rows, v_rows)
    if q_pref.dtype != q_suf.dtype:
        raise TypeError(f"q_pref {q_pref.dtype} and q_suf {q_suf.dtype} differ")
    if ctx_all.dtype != torch.int32 or route.dtype != torch.int32:
        raise TypeError("ctx_all and route must be int32")
    S, g, d = q_suf.shape
    qmax, dev = q_pref.shape[1], q_pref.device
    if not 1 <= g <= KERNEL_GQ[-1] or qmax > MAX_ROWS:
        raise ValueError(f"lean_cascade_fused (K5) takes g of 1 to {KERNEL_GQ[-1]} and up to "
                         f"{MAX_ROWS} stacked rows, got g {g} and {qmax} rows")
    build.check_contiguous(q_pref=q_pref, q_suf=q_suf, k_rows=k_rows, v_rows=v_rows,
                           ctx_all=ctx_all, route=route)
    ns = ring_slots(k_rows.dtype, qmax, d, csched.tile_size)
    if ns:
        decode_ring.check_aligned("lean_cascade_fused (K5)", k_rows=k_rows, v_rows=v_rows)
    else:
        check_f8_ring("lean_cascade_fused (K5)", k_rows.dtype, qmax, d, csched.tile_size)
    if not ns and g > WALK_MAX_G:
        raise ValueError(f"lean_cascade_fused (K5) at g {g} runs on the decode ring only, which "
                         f"does not fit {qmax} stacked rows at d {d} on pages of "
                         f"{csched.tile_size} ({k_rows.dtype} rows)")
    pre, suf = csched.prefix_sched, csched.suffix_sched
    Ptot = csched.num_pieces_total
    o_p = torch.empty(Ptot + 1, qmax, d, dtype=torch.float32, device=dev)
    m_p = torch.empty(Ptot + 1, qmax, dtype=torch.float32, device=dev)
    l_p = torch.empty(Ptot + 1, qmax, dtype=torch.float32, device=dev)
    arrivals = arrival_counters(csched, (S,), dev)
    o = torch.empty(S, g, d, dtype=torch.float32, device=dev)
    lse = torch.empty(S, g, dtype=torch.float32, device=dev)
    err = _library(CASCADE_SOURCE if ns else CASCADE_WALK_SOURCE).lean_cascade_fused_launch(
        build.dtype_code(q_suf, k_rows), build.ptr(q_pref), build.ptr(q_suf), build.ptr(k_rows),
        build.ptr(v_rows), build.ptr(ks), build.ptr(vs), build.ptr(fdesc.desc), fdesc.desc.shape[1], pre.grid_iters,
        pre.tiles_per_worker, suf.tiles_per_worker, pre.num_workers, build.ptr(ctx_all),
        build.ptr(route), build.ptr(fdesc.tgt_start), build.ptr(fdesc.tgt_count),
        build.ptr(fdesc.pt_start), build.ptr(fdesc.pt_tgt), build.ptr(arrivals),
        build.ptr(o_p), build.ptr(m_p), build.ptr(l_p), build.ptr(o), build.ptr(lse),
        q_pref.shape[0], qmax, g, d, csched.tile_size, float(scale), ns, build.stream(dev),
    )
    build.check_launch(err, "lean_cascade_fused (K5)")
    cascade_launches += 1
    cascade_ring_launches += int(ns > 0)
    return o, lse
