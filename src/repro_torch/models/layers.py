"""Transformer building blocks (port of the subset of
``repro.models.layers`` that the paged serving path runs).

Plain functions on tensors and parameter dicts, in the reference's layout:
weights are ``(in, out)`` and activations multiply from the left
(``x @ w``). Matmuls run in bf16 (``COMPUTE_DTYPE``), as the reference's
``x.astype(bf16) @ w.astype(bf16)``; norms and rotary angles are float32.
Layers take rotary positions, the only form the ported architectures use.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.attention import (
    mha_chunk_prefill_paged_ref,
    mha_decode_ref,
    mha_prefill_ref,
    paged_gather_kv,
    paged_scatter_tokens,
)

COMPUTE_DTYPE = torch.bfloat16


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm with the ``(1 + w)`` gain convention (zero-init weights)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + w.float())
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding, half-split convention. x: (..., L, H, hd) with
    positions broadcastable to the L axis. Frequencies and angles are
    float32, as in the reference."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _project_qkv(p, xc, n_heads, n_kv, head_dim):
    B, L, _ = xc.shape
    dt = xc.dtype
    q = (xc @ p["wq"].to(dt)).reshape(B, L, n_heads, head_dim)
    k = (xc @ p["wk"].to(dt)).reshape(B, L, n_kv, head_dim)
    v = (xc @ p["wv"].to(dt)).reshape(B, L, n_kv, head_dim)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return q, k, v


def attn_forward(
    p,
    x: torch.Tensor,                  # (B, L, D)
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    rope_theta: float,
    attn: Callable = mha_prefill_ref,
):
    """Causal self-attention over a whole prompt (prefill). Returns
    ``(out, (k, v))`` with ``k, v: (B, Hkv, L, hd)``. ``attn`` is the
    prefill attention: :func:`mha_prefill_ref`, or the q-chunked
    :func:`repro_torch.core.attention.mha_prefill_chunked` (same result,
    less memory), which the model picks for long prompts."""
    B, L, _ = x.shape
    q, k, v = _project_qkv(p, x.to(COMPUTE_DTYPE), n_heads, n_kv, head_dim)
    pos = torch.arange(L, device=x.device)
    q = rope(q, pos, rope_theta)
    k = rope(k, pos, rope_theta)
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    o = attn(qh, kh, vh, causal=True)
    o = o.transpose(1, 2).reshape(B, L, n_heads * head_dim)
    out = o.to(COMPUTE_DTYPE) @ p["wo"].to(COMPUTE_DTYPE)
    return out.to(x.dtype), (kh, vh)


def attn_decode_paged(
    p,
    x: torch.Tensor,              # (B, 1, D) current token
    k_pool: torch.Tensor,         # (num_pages, Hkv, page_size, hd)
    v_pool: torch.Tensor,
    page_tbl: torch.Tensor,       # (B, pages_per_slot) int32
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    rope_theta: float,
    ctx_lens: torch.Tensor,       # (B,) per-slot lengths
    attn_fn: Optional[Callable] = None,   # f(q, k_pool, v_pool, ctx) -> out
):
    """One decode step of a global-attention layer against the paged pool.

    The new token's K/V are written *in place* into page
    ``page_tbl[b, ctx_b // page_size]`` at offset ``ctx_b % page_size``
    (the reference returns updated pools instead and relies on buffer
    donation); idle slots, whose table rows are all null, write the
    reserved null page, whose contents are always masked. ``attn_fn``
    receives the pools and the visible lengths; without one the pools are
    gathered to dense per-slot KV for the plain reference. Returns
    ``(out, k_pool, v_pool)``.
    """
    B = x.shape[0]
    ps = k_pool.shape[2]
    capacity = page_tbl.shape[1] * ps
    q, k, v = _project_qkv(p, x.to(COMPUTE_DTYPE), n_heads, n_kv, head_dim)
    pos = ctx_lens[:, None]
    q = rope(q, pos, rope_theta)
    k = rope(k, pos, rope_theta)
    write_pos = torch.clamp(ctx_lens, max=capacity - 1).long()
    pages_w = page_tbl[torch.arange(B, device=page_tbl.device), write_pos // ps].long()
    offs = write_pos % ps
    k_pool[pages_w, :, offs] = k[:, 0].to(k_pool.dtype)
    v_pool[pages_w, :, offs] = v[:, 0].to(v_pool.dtype)
    ctx = torch.clamp(ctx_lens + 1, max=capacity).to(torch.int32)
    qd = q.reshape(B, n_heads, head_dim)
    if attn_fn is not None:
        o = attn_fn(qd, k_pool, v_pool, ctx)
    else:
        o = mha_decode_ref(
            qd, paged_gather_kv(k_pool, page_tbl), paged_gather_kv(v_pool, page_tbl),
            ctx_lens=ctx,
        )
    o = o.reshape(B, 1, n_heads * head_dim).to(COMPUTE_DTYPE)
    out = o @ p["wo"].to(COMPUTE_DTYPE)
    return out.to(x.dtype), k_pool, v_pool


def attn_prefill_chunk_paged(
    p,
    x: torch.Tensor,              # (N, C, D) one prompt chunk per row
    k_pool: torch.Tensor,         # (num_pages, Hkv, page_size, hd)
    v_pool: torch.Tensor,
    page_tbls: torch.Tensor,      # (N, W) int32 page table rows
    offs: torch.Tensor,           # (N,) absolute position of chunk[0]
    lens: torch.Tensor,           # (N,) valid tokens per chunk
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    rope_theta: float,
    attn_fn: Optional[Callable] = None,   # f(q, k_pool, v_pool, page_tbls, offs) -> o
):
    """Chunked-prefill attention of a global-attention layer against the
    paged pool: each row is ``C`` positions of one prompt from absolute
    offset ``offs[n]``, of which ``lens[n]`` are valid.

    The chunk's K/V are written into the pools *in place* through the row's
    page table **before** attention reads them, since queries attend to
    their own chunk (causally); pad positions write the null page. Rotary
    positions are absolute, so chunked and whole-prompt prefill fill the
    cache alike. ``attn_fn`` receives ``q (N, Hq, C, hd)``, the pools, the
    tables and the offsets; without one the plain oracle
    :func:`mha_chunk_prefill_paged_ref` runs. Pad rows give garbage confined
    to their own rows. Returns ``(out, k_pool, v_pool)``.
    """
    N, C, _ = x.shape
    q, k, v = _project_qkv(p, x.to(COMPUTE_DTYPE), n_heads, n_kv, head_dim)
    pos = offs.to(x.device).long()[:, None] + torch.arange(C, device=x.device)[None, :]
    q = rope(q, pos, rope_theta)
    k = rope(k, pos, rope_theta)
    paged_scatter_tokens(k_pool, page_tbls, offs, lens, k)
    paged_scatter_tokens(v_pool, page_tbls, offs, lens, v)
    qh = q.transpose(1, 2)                                  # (N, Hq, C, hd)
    if attn_fn is not None:
        o = attn_fn(qh, k_pool, v_pool, page_tbls, offs)
    else:
        o = mha_chunk_prefill_paged_ref(qh, k_pool, v_pool, page_tbls, offs)
    o = o.transpose(1, 2).reshape(N, C, n_heads * head_dim)
    out = o.to(COMPUTE_DTYPE) @ p["wo"].to(COMPUTE_DTYPE)
    return out.to(x.dtype), k_pool, v_pool


def ffn_forward(p, x: torch.Tensor):
    """SwiGLU feed-forward. silu is ``x * (1 / (1 + exp(-x)))`` with every
    op rounded to bf16: the op sequence XLA lowers ``jax.nn.silu`` to,
    which ``torch.sigmoid`` (one rounding) differs from in a third of bf16
    outputs."""
    xc = x.to(COMPUTE_DTYPE)
    g = xc @ p["wg"].to(COMPUTE_DTYPE)
    h = (g * (1 / (1 + torch.exp(-g)))) * (xc @ p["wu"].to(COMPUTE_DTYPE))
    return (h @ p["wd"].to(COMPUTE_DTYPE)).to(x.dtype)
