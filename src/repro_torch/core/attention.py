"""Reference decode/prefill attention (plain PyTorch).

Port of the subset of ``repro.core.attention`` that the paged serving path
runs: the decode oracle, the page-table gather, and the two prefill
attentions the model's ``prefill`` uses. They are plain tensor code, as in
the reference; no fused library attention stands in for them.

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


def paged_gather_kv(pool: torch.Tensor, page_tbl: torch.Tensor) -> torch.Tensor:
    """Dense per-sequence KV view of a paged pool.

    ``pool: (num_pages, H_kv, page_size, d)``; ``page_tbl: (B, T)`` maps
    logical tile ``t`` of sequence ``b`` to a physical page (null-page
    entries gather garbage that callers mask by context length). Returns
    ``(B, H_kv, T * page_size, d)``.
    """
    g = pool[page_tbl.long()]                      # (B, T, H, page, d)
    B, T, H, ps, d = g.shape
    return g.movedim(2, 1).reshape(B, H, T * ps, d)


def paged_scatter_tokens(
    pool: torch.Tensor,         # (num_pages, H, page_size, d)
    page_tbls: torch.Tensor,    # (N, W) int32 page table rows
    offs: torch.Tensor,         # (N,) first logical position of each chunk
    lens: torch.Tensor,         # (N,) valid tokens per chunk
    vals: torch.Tensor,         # (N, C, H, d) new K or V rows
) -> torch.Tensor:
    """Scatter chunk tokens straight into a paged pool through the page
    table, **in place** (the reference returns an updated pool instead).

    Chunk row ``n`` writes token ``i < lens[n]`` at logical position
    ``offs[n] + i``: page ``page_tbls[n, pos // page_size]``, offset
    ``pos % page_size``. Invalid positions (``i >= lens[n]``: chunk padding,
    pad rows of a pack) write the null page 0, whose contents runtime
    lengths and the causal mask always mask; several of them may land on
    the same null-page slot, harmlessly. Live rows never collide: requests
    hold disjoint pages and a chunk's positions are distinct. Returns
    ``pool``.
    """
    N, C, H, d = vals.shape
    ps = pool.shape[2]
    W = page_tbls.shape[1]
    dev = pool.device
    i = torch.arange(C, device=dev)
    pos = offs.to(dev).long()[:, None] + i[None, :]                  # (N, C)
    valid = i[None, :] < lens.to(dev).long()[:, None]
    tile_idx = torch.clamp(pos // ps, 0, W - 1)
    pages = torch.gather(page_tbls.to(dev).long(), 1, tile_idx)
    pages = torch.where(valid, pages, torch.zeros_like(pages))
    offsets = torch.where(valid, pos % ps, torch.zeros_like(pos))
    pool[pages.reshape(-1), :, offsets.reshape(-1)] = vals.reshape(N * C, H, d).to(pool.dtype)
    return pool


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
