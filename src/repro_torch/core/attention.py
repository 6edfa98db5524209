"""Reference decode/prefill attention (plain PyTorch).

Port of the subset of ``repro.core.attention`` that the paged serving path
runs: the decode oracle, the page-table gather, the two prefill attentions
the model's ``prefill`` uses, and the int8 page helpers (quantize, the
dequantizing gather, and the quantizing scatter that is an int8 pool's
single write point). They are plain tensor code, as in
the reference; no fused library attention stands in for them.

f8 caches (``kv_cache_dtype="f8"``) store ``torch.float8_e4m3fn``. Every
write into one goes through :func:`to_kv`, the reference's cast; torch
has no float8 ``index_copy_``/``masked_fill`` (and its CUDA indexing of
float8 is not relied on), so copies into and out of one move its bytes
(:func:`kv_bytes`); a plain read widens it (:func:`widen_kv`, exact).

Numerics follow the reference. ``einsum(..., preferred_element_type=f32)``
on bf16 operands becomes an einsum of the operands upcast to float32
(products of bf16 values are exact in float32; TF32 must stay off on the
card), and the probabilities are rounded back to the value dtype before the
PV product, as ``p.astype(v.dtype)`` does there.

Decode shapes: ``q (B, Hq, d)``, ``k/v (B, Hkv, S, d)`` with GQA group
``g = Hq // Hkv``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .merge import AttnPartial

NEG_INF = -1e30  # finite mask value: keeps (m, l) stats well-defined


def _default_scale(d: int, scale: Optional[float]) -> float:
    return scale if scale is not None else 1.0 / math.sqrt(d)


def _length_mask(scores: torch.Tensor, ctx_lens: Optional[torch.Tensor]):
    """Mask score positions >= per-batch context length. scores: (B, ..., S)."""
    if ctx_lens is None:
        return scores
    S = scores.shape[-1]
    pos = torch.arange(S, device=scores.device)
    mask = pos[None, :] < ctx_lens.to(scores.device)[:, None]        # (B, S)
    mask = mask.reshape(mask.shape[0], *([1] * (scores.dim() - 2)), S)
    return torch.where(mask, scores, torch.full_like(scores, NEG_INF))


# ------------------------------------------------------------ f8 storage
F8 = torch.float8_e4m3fn
# |x| above this overflows e4m3: 464 lies halfway between 448 (the largest
# finite code) and the next step, and rounds to even, down to 448
F8_OVERFLOW = 464.0


def to_kv(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` cast to a KV cache's storage dtype as the reference casts it
    (``x.astype(dtype)``). For ``float8_e4m3fn`` that is JAX's cast bit for
    bit: round to nearest even, and every ``|x| > 464``, ``+-inf`` and NaN
    to the NaN code of x's sign (0x7f / 0xff), where torch's own cast
    saturates to +-448; in-range values take torch's codes, which equal
    JAX's from bf16 and float32 sources. Cast from the dtype the reference
    casts from: float32 -> e4m3 and float32 -> bf16 -> e4m3 can differ.
    Other dtypes: a plain ``.to``."""
    if dtype != F8:
        return x.to(dtype)
    codes = x.to(F8).view(torch.uint8)
    # torch saturates an overflow to +-448 (0x7e / 0xfe) and keeps NaN's
    # sign; the low seven bits set make either the NaN code of that sign
    return torch.where(x.abs() <= F8_OVERFLOW, codes, codes | 0x7F).view(F8)


def widen_kv(t: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """An e4m3 cache, pool or rows widened to ``dtype`` (exact, NaN kept):
    where the reference reads an f8 cache (``k.astype(compute_dtype)``);
    any other tensor as it is."""
    return t.to(dtype) if t.dtype == F8 else t


def kv_bytes(t: torch.Tensor) -> torch.Tensor:
    """An e4m3 tensor's bytes (a ``uint8`` view) for indexing, index
    assignment and copies; any other tensor as it is."""
    return t.view(torch.uint8) if t.dtype == F8 else t


def kv_write(dst: torch.Tensor, index, vals: torch.Tensor) -> None:
    """``dst[index] = vals`` cast as the reference casts (:func:`to_kv`),
    through the bytes of an e4m3 ``dst``."""
    kv_bytes(dst)[index] = kv_bytes(to_kv(vals, dst.dtype))


def paged_gather_kv(pool: torch.Tensor, page_tbl: torch.Tensor) -> torch.Tensor:
    """Dense per-sequence KV view of a paged pool.

    ``pool: (num_pages, H_kv, page_size, d)``; ``page_tbl: (B, T)`` maps
    logical tile ``t`` of sequence ``b`` to a physical page (null-page
    entries gather garbage that callers mask by context length). Returns
    ``(B, H_kv, T * page_size, d)`` in the pool's dtype (an e4m3 pool's
    bytes are gathered).
    """
    g = kv_bytes(pool)[page_tbl.long()]            # (B, T, H, page, d)
    B, T, H, ps, d = g.shape
    return g.movedim(2, 1).reshape(B, H, T * ps, d).view(pool.dtype)


def null_page_writer_rows(pages: torch.Tensor) -> torch.Tensor:
    """For each write ``pages (M,)`` of a step, the row whose values it
    stores: its own, or, for every row bound for the null page 0 (idle and
    masked slots, chunk padding), the last such row's. Those rows all land
    on one null-page slot; the reference's scatter applies its updates in
    order, so the last one stays. Storing that one value from every such
    row gives the same content on every device and every run: a CUDA
    scatter with duplicate indices lets whichever write lands last stay,
    and the rows that read the slot back (an idle slot's one visible key)
    feed the MoE router, whose capacity couples them to the live rows.
    Every layer of a step writes the same pages, so a step computes this
    index once (:func:`chunk_writer_rows`; ``decode_writer_rows`` in
    ``models/layers.py``) and each layer's write selects with it. Fixed
    shapes, no host sync."""
    null = pages == 0
    rows = torch.arange(pages.shape[0], device=pages.device)
    last = torch.where(null, rows, torch.zeros_like(rows)).max()
    return torch.where(null, last, rows)


def null_page_last_writer(pages: torch.Tensor, vals: torch.Tensor,
                          writer: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``vals (M, ...)`` with every row bound for the null page 0 replaced
    by the last such row (:func:`null_page_writer_rows`; ``writer`` is that
    index when the step has computed it already)."""
    return vals.index_select(0, null_page_writer_rows(pages) if writer is None else writer)


def _chunk_targets(page_tbls, offs, lens, C: int, page_size: int, dev):
    """Where chunk row ``n``'s token ``i`` lands: ``(pages, offsets, valid)``,
    each ``(N, C)``; invalid positions at slot 0 of the null page 0."""
    i = torch.arange(C, device=dev)
    offs, lens = offs.to(dev).long(), lens.to(dev).long()
    tbls = page_tbls.to(dev).long()
    W = tbls.shape[1]
    pos = offs[:, None] + i[None, :]
    valid = i[None, :] < lens[:, None]
    pages = torch.where(valid, torch.gather(tbls, 1, torch.clamp(pos // page_size, 0, W - 1)), 0)
    offsets = torch.where(valid, pos % page_size, 0)
    return pages, offsets, valid


def chunk_writer_rows(page_tbls, offs, lens, C: int, page_size: int, dev) -> torch.Tensor:
    """:func:`null_page_writer_rows` of a chunk step's ``N * C`` writes, once
    for every layer's :func:`paged_scatter_tokens` (``writer=``)."""
    pages, _, _ = _chunk_targets(page_tbls, offs, lens, C, page_size, dev)
    return null_page_writer_rows(pages.reshape(-1))


def paged_scatter_tokens(
    pool: torch.Tensor,         # (num_pages, H, page_size, d)
    page_tbls: torch.Tensor,    # (N, W) int32 page table rows
    offs: torch.Tensor,         # (N,) first logical position of each chunk
    lens: torch.Tensor,         # (N,) valid tokens per chunk
    vals: torch.Tensor,         # (N, C, H, d) new K or V rows
    writer: Optional[torch.Tensor] = None,   # chunk_writer_rows of the step
) -> torch.Tensor:
    """Scatter chunk tokens straight into a paged pool through the page
    table, **in place** (the reference returns an updated pool instead).

    Chunk row ``n`` writes token ``i < lens[n]`` at logical position
    ``offs[n] + i``: page ``page_tbls[n, pos // page_size]``, offset
    ``pos % page_size``. Invalid positions (``i >= lens[n]``: chunk padding,
    pad rows of a pack) write slot 0 of the null page 0, whose contents
    runtime lengths and the causal mask always mask, all with the last such
    row's values (:func:`null_page_last_writer`). Live rows never collide:
    requests hold disjoint pages and a chunk's positions are distinct.
    Returns ``pool``.
    """
    N, C, H, d = vals.shape
    pages, offsets, _ = _chunk_targets(page_tbls, offs, lens, C, pool.shape[2], pool.device)
    rows = null_page_last_writer(pages.reshape(-1), vals.reshape(N * C, H, d), writer)
    kv_write(pool, (pages.reshape(-1), slice(None), offsets.reshape(-1)), rows)
    return pool


# ------------------------------------------------------------ quantized KV
# Symmetric int8 page storage, as in the reference: pool values are
# round(x / scale) with one float32 scale per (page, kv head), or per page
# stored broadcast across the head axis. Scales only grow while a page is
# live; a scale of 0 (a fresh page) dequantizes to exact zeros.

INT8_QMAX = 127.0


def _inv_scale(s: torch.Tensor) -> torch.Tensor:
    """``where(s > 0, 1 / max(s, 1e-30), 0)``, the reference's op order."""
    return torch.where(s > 0, 1.0 / torch.clamp(s, min=1e-30), 0.0)


def _to_int8(x: torch.Tensor) -> torch.Tensor:
    """``clip(round(x), -127, 127)`` as int8; ``torch.round`` rounds half to
    even, as ``jnp.round`` does."""
    return torch.clamp(torch.round(x), -INT8_QMAX, INT8_QMAX).to(torch.int8)


def quantize_kv_blocks(vals: torch.Tensor, per_head: bool = True):
    """Quantize whole KV blocks ``(..., H, P, d)`` to int8 and float32
    scales ``(..., H)``: per (block, head) at ``per_head=True``, else one
    scale per block broadcast across the head axis. Returns ``(q,
    scales)``."""
    vf = vals.float()
    amax = vf.abs().amax(dim=(-2, -1))                       # (..., H)
    if not per_head:
        amax = amax.amax(dim=-1, keepdim=True).expand_as(amax).contiguous()
    scales = amax / INT8_QMAX
    return _to_int8(vf * _inv_scale(scales)[..., None, None]), scales


def paged_gather_kv_dequant(pool: torch.Tensor, scales: torch.Tensor, page_tbl: torch.Tensor,
                            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """:func:`paged_gather_kv` of an int8 pool ``(num_pages, H, page_size,
    d)`` with its scales ``(num_pages, H)``: gather, widen to float32, apply
    each page's per-head scale, cast to ``dtype``. Returns ``(B, H, T *
    page_size, d)``."""
    tbl = page_tbl.long()
    g = pool[tbl].float() * scales[tbl][..., None, None]     # (B, T, H, ps, d)
    B, T, H, ps, d = g.shape
    return g.movedim(2, 1).reshape(B, H, T * ps, d).to(dtype)


def paged_scatter_tokens_quant(
    pool: torch.Tensor,         # (num_pages, H, page_size, d) int8
    scales: torch.Tensor,       # (num_pages, H) float32
    page_tbls: torch.Tensor,    # (N, W) int32 page table rows
    offs: torch.Tensor,         # (N,) first logical position of each chunk
    lens: torch.Tensor,         # (N,) valid tokens per chunk
    vals: torch.Tensor,         # (N, C, H, d) new K or V rows
    per_head: bool = True,
    writer: Optional[torch.Tensor] = None,   # chunk_writer_rows of the step
):
    """The quantizing :func:`paged_scatter_tokens`, the single write point
    of an int8 pool, **in place** (the reference returns new arrays):

    1. scatter-max each token's candidate scale (``amax / 127`` per (token,
       head)) into its page's scale row -- max is exact, so the result does
       not depend on the order of the writes;
    2. requantize what the touched pages already hold by ``round(q * old /
       new)``;
    3. quantize the new tokens at the grown scales and scatter them.

    Invalid positions route to the null page 0 with a candidate of 0, as in
    the fp path, and with the last such row's values. Step 2 visits each row's pages once -- the
    ``(page_size + C - 2) // page_size + 1`` tiles from its first position
    on -- where the reference visits one page per token; a page visited but
    not written keeps ``old == new`` and requantizes to itself, so the pool
    is the same. Returns ``(pool, scales)``."""
    N, C, H, d = vals.shape
    ps = pool.shape[2]
    W = page_tbls.shape[1]
    dev = pool.device
    offs, lens = offs.to(dev).long(), lens.to(dev).long()
    tbls = page_tbls.to(dev).long()
    pages, offsets, valid = _chunk_targets(tbls, offs, lens, C, ps, dev)

    vals = null_page_last_writer(pages.reshape(-1), vals.reshape(N * C, H, d),
                                 writer).reshape(N, C, H, d)
    vf = vals.float()
    cand = vf.abs().amax(dim=-1) / INT8_QMAX                          # (N, C, H)
    if not per_head:
        cand = cand.amax(dim=-1, keepdim=True).expand_as(cand)
    cand = torch.where(valid[..., None], cand, 0.0)

    # the pages each row's tokens land in: tiles t0 .. t0 + J - 1
    J = (ps + C - 2) // ps + 1
    t0 = offs // ps
    tiles = t0[:, None] + torch.arange(J, device=dev)[None, :]        # (N, J)
    last = (offs + lens - 1) // ps
    touched = (tiles <= last[:, None]) & (lens[:, None] > 0)
    rq_pages = torch.where(touched, torch.gather(tbls, 1, torch.clamp(tiles, 0, W - 1)), 0)
    rq_pages = rq_pages.reshape(-1)

    old_s = scales[rq_pages]                                           # (N*J, H)
    scales.scatter_reduce_(0, pages.reshape(-1, 1).expand(-1, H), cand.reshape(N * C, H),
                           reduce="amax")
    new_s = scales[rq_pages]
    factor = torch.where(new_s > 0, old_s / torch.clamp(new_s, min=1e-30), 0.0)
    # a page listed twice gets the same requantized rows from each entry
    pool[rq_pages] = _to_int8(pool[rq_pages].float() * factor[..., None, None])

    inv = _inv_scale(scales[pages])                                    # (N, C, H)
    q = _to_int8(vf * inv[..., None])
    pool[pages.reshape(-1), :, offsets.reshape(-1)] = q.reshape(N * C, H, d)
    return pool, scales


def _softmax_pv(s: torch.Tensor, v: torch.Tensor, eq: str) -> torch.Tensor:
    p = torch.softmax(s, dim=-1)
    return torch.einsum(eq, p.to(v.dtype).float(), v.float())


def mha_decode_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    ctx_lens: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Oracle decode attention (one new token per sequence)."""
    B, Hq, d = q.shape
    _, Hkv, S, _ = k.shape
    g = Hq // Hkv
    scale = _default_scale(d, scale)
    qg = q.reshape(B, Hkv, g, d)
    s = torch.einsum("bhgd,bhsd->bhgs", qg.float(), k.float()) * scale
    s = _length_mask(s, ctx_lens)
    o = _softmax_pv(s, v, "bhgs,bhsd->bhgd")
    return o.reshape(B, Hq, d).to(q.dtype)


def chunk_partial(
    q: torch.Tensor,
    k_chunk: torch.Tensor,
    v_chunk: torch.Tensor,
    scale: float,
    valid_len=None,
) -> AttnPartial:
    """Un-scaled partial attention of ``q`` against one KV chunk (paper
    §IV-A; ``repro/core/attention.py:273``). ``q (..., g, d)``,
    ``k_chunk``/``v_chunk (..., t, d)``; ``valid_len`` an int or a tensor
    broadcastable against the scores ``(..., g, t)``: keys at or past it are
    masked with :data:`NEG_INF`. Returns float32 ``o (..., g, d)``, ``m, l
    (..., g)``. A chunk with no valid key gives ``m = NEG_INF``, finite, as
    in the reference: a merge with any valid chunk scales it to 0."""
    s = torch.einsum("...gd,...td->...gt", q.float(), k_chunk.float()) * scale
    if valid_len is not None:
        pos = torch.arange(s.shape[-1], device=s.device)
        if torch.is_tensor(valid_len):
            valid_len = valid_len.to(s.device)
        s = torch.where(pos < valid_len, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    a = torch.exp(s - m[..., None])
    l = a.sum(dim=-1)
    o = torch.einsum("...gt,...td->...gd", a.to(v_chunk.dtype).float(), v_chunk.float())
    return AttnPartial(o=o, m=m, l=l)


def _prefill_mask(Lq: int, Lk: int, q_offset: int, causal: bool,
                  window: Optional[int], device) -> torch.Tensor:
    qpos = torch.arange(Lq, device=device) + q_offset
    kpos = torch.arange(Lk, device=device)
    ok = torch.ones((Lq, Lk), dtype=torch.bool, device=device)
    if causal:
        ok &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        ok &= kpos[None, :] > qpos[:, None] - window
    return ok


def mha_prefill_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Oracle prefill attention. q: (B, Hq, Lq, d), k/v: (B, Hkv, Lk, d).

    ``window``: sliding-window size (None = global); ``q_offset``: absolute
    position of q[0].
    """
    B, Hq, Lq, d = q.shape
    _, Hkv, Lk, _ = k.shape
    g = Hq // Hkv
    scale = _default_scale(d, scale)
    qg = q.reshape(B, Hkv, g, Lq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) * scale
    ok = _prefill_mask(Lq, Lk, q_offset, causal, window, q.device)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    o = _softmax_pv(s, v, "bhgqk,bhkd->bhgqd")
    return o.reshape(B, Hq, Lq, d).to(q.dtype)


def mha_chunk_prefill_paged_ref(
    q: torch.Tensor,            # (N, Hq, C, d) one prompt chunk per row
    k_pool: torch.Tensor,       # (num_pages, Hkv, page_size, d)
    v_pool: torch.Tensor,
    page_tbls: torch.Tensor,    # (N, W) int32
    offs: torch.Tensor,         # (N,) absolute position of each chunk's q[0]
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Oracle attention for one pack of prefill chunks against paged KV.

    Each chunk row gathers its dense KV view through its page table and
    attends causally from its own absolute offset. Causality doubles as the
    length mask: stale pool data past ``offs[n] + C`` always sits at key
    positions beyond every valid query. Chunk-padding queries give garbage
    rows that callers discard.
    """
    N, Hq, C, d = q.shape
    Hkv = k_pool.shape[1]
    g = Hq // Hkv
    scale = _default_scale(d, scale)
    k = paged_gather_kv(k_pool, page_tbls)                      # (N, Hkv, K, d)
    v = paged_gather_kv(v_pool, page_tbls)
    K = k.shape[2]
    qg = q.reshape(N, Hkv, g, C, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) * scale
    qpos = offs.to(q.device).long()[:, None] + torch.arange(C, device=q.device)[None, :]
    ok = torch.arange(K, device=q.device)[None, None, :] <= qpos[..., None]   # (N, C, K)
    s = torch.where(ok[:, None, None], s, torch.full_like(s, NEG_INF))
    o = _softmax_pv(s, v, "bhgqk,bhkd->bhgqd")
    return o.reshape(N, Hq, C, d).to(q.dtype)


def mha_prefill_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
    q_chunk: int = 512,
) -> torch.Tensor:
    """Exact prefill attention over q chunks of ``q_chunk`` rows, so only
    ``q_chunk * Lk`` scores live at once. The reference scans padded chunks
    (``jax.lax.map``); here a loop walks the rows, which computes each row
    exactly as the padded scan does."""
    B, Hq, Lq, d = q.shape
    _, Hkv, Lk, _ = k.shape
    g = Hq // Hkv
    scale = _default_scale(d, scale)
    kf, out = k.float(), []
    for start in range(0, Lq, q_chunk):
        qc = q[:, :, start : start + q_chunk]
        n = qc.shape[2]
        s = torch.einsum(
            "bhgqd,bhkd->bhgqk", qc.reshape(B, Hkv, g, n, d).float(), kf
        ) * scale
        ok = _prefill_mask(n, Lk, q_offset + start, causal, window, q.device)
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
        out.append(_softmax_pv(s, v, "bhgqk,bhkd->bhgqd").reshape(B, Hq, n, d))
    return torch.cat(out, dim=2).to(q.dtype)
