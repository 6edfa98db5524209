"""Transformer building blocks (port of ``repro.models.layers``: the
attention kinds on dense, ring and paged KV, and the FFN kinds).

Plain functions on tensors and parameter dicts, in the reference's layout:
weights are ``(in, out)`` and activations multiply from the left
(``x @ w``). Matmuls run in bf16 (``COMPUTE_DTYPE``), as the reference's
``x.astype(bf16) @ w.astype(bf16)``; norms, rotary and sinusoidal angles
are float32. ``rope_theta`` None means no rotary embedding (positions are
absolute and sinusoidal, added at the embedding: :func:`sinusoidal_pos`).
The activations write out the bf16 op sequence XLA runs for the
reference's (:func:`silu`, :func:`gelu`), so both round alike.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.core.attention import (
    kv_bytes,
    kv_write,
    mha_chunk_prefill_paged_ref,
    mha_decode_ref,
    mha_prefill_ref,
    null_page_last_writer,
    null_page_writer_rows,
    paged_gather_kv,
    paged_gather_kv_dequant,
    paged_scatter_tokens,
    paged_scatter_tokens_quant,
    to_kv,
    widen_kv,
)

COMPUTE_DTYPE = torch.bfloat16


def remat(fn: Callable, *args):
    """``fn(*args)``, its activations recomputed in the backward pass (the
    reference's ``jax.checkpoint``) where a gradient is being recorded;
    plainly otherwise. The model draws no random numbers, so no RNG state
    is stashed."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             preserve_rng_state=False)


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


def sinusoidal_pos(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """Absolute sinusoidal positions ``(..., d_model)`` in float32: sines of
    the angles then cosines (``repro/models/layers.py:56-60``)."""
    half = d_model // 2
    freqs = 10000.0 ** (-torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _maybe_rope(x: torch.Tensor, positions: torch.Tensor, theta: Optional[float]):
    return x if theta is None else rope(x, positions, theta)


def _project_qkv(p, xc, n_heads, n_kv, head_dim, src=None):
    """q from ``xc (B, L, D)``; k and v from ``src (B, Lk, D)`` (cross
    attention) or ``xc``; the q/k norms where the parameters have them."""
    B, L, _ = xc.shape
    dt = xc.dtype
    src = xc if src is None else src
    q = (xc @ p["wq"].to(dt)).reshape(B, L, n_heads, head_dim)
    k = (src @ p["wk"].to(dt)).reshape(B, src.shape[1], n_kv, head_dim)
    v = (src @ p["wv"].to(dt)).reshape(B, src.shape[1], n_kv, head_dim)
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
    rope_theta: Optional[float],
    causal: bool = True,
    window: Optional[int] = None,
    kv_states: Optional[torch.Tensor] = None,   # cross attention: (B, Lk, D)
    attn: Callable = mha_prefill_ref,
    reduce: Optional[Callable] = None,
):
    """Self-attention over a whole prompt (prefill), causal and optionally
    sliding-window, or with ``kv_states`` cross attention to them
    (non-causal, no rotary). Returns ``(out, (k, v))`` with ``k, v: (B,
    Hkv, Lk, hd)``. ``attn`` is the prefill attention, called on contiguous
    ``(B, H, L, hd)`` tensors with ``causal`` and ``window``:
    :func:`mha_prefill_ref`, the q-chunked
    :func:`repro_torch.core.attention.mha_prefill_chunked` (same result,
    less memory), or the kernel K7
    (:func:`repro_torch.kernels.flash_prefill.flash_prefill`); the model
    picks (:func:`repro_torch.models.transformer.prefill`). The head counts
    are those of the weights' blocks (tensor parallel: this rank's heads),
    and ``reduce`` (tensor parallel: the row-parallel sum over the ranks
    holding the other heads' blocks of ``wo``) takes the ``wo`` product."""
    B, L, _ = x.shape
    xc = x.to(COMPUTE_DTYPE)
    src = None if kv_states is None else kv_states.to(COMPUTE_DTYPE)
    q, k, v = _project_qkv(p, xc, n_heads, n_kv, head_dim, src)
    if src is None and rope_theta is not None:
        pos = torch.arange(L, device=x.device)
        q = rope(q, pos, rope_theta)
        k = rope(k, pos, rope_theta)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    o = attn(qh, kh, vh, causal=causal and src is None, window=window)
    o = o.transpose(1, 2).reshape(B, L, n_heads * head_dim)
    out = _reduced(o.to(COMPUTE_DTYPE) @ p["wo"].to(COMPUTE_DTYPE), reduce)
    return out.to(x.dtype), (kh, vh)


def _reduced(y: torch.Tensor, reduce: Optional[Callable]) -> torch.Tensor:
    """A row-parallel product's partial summed over the ranks (``reduce``),
    or the whole product (None)."""
    return y if reduce is None else reduce(y)


def _shard_write(cache: torch.Tensor, rows: torch.Tensor, local: torch.Tensor,
                 vals: torch.Tensor) -> None:
    """Write ``vals (B, Hkv, hd)`` at block-local positions ``local (B,)``
    of a sequence shard, for the rows whose position lies in it; the other
    rows rewrite their own value at a clamped position (no host sync)."""
    mine = (local >= 0) & (local < cache.shape[2])
    at = (rows, slice(None), local.clamp(0, cache.shape[2] - 1))
    old = kv_bytes(cache)[at]
    kv_bytes(cache)[at] = torch.where(mine[:, None, None], kv_bytes(to_kv(vals, cache.dtype)), old)


def attn_decode(
    p,
    x: torch.Tensor,              # (B, 1, D) current token
    k_cache: torch.Tensor,        # (B, Hkv, S, hd)
    v_cache: torch.Tensor,
    cur_len: Optional[int] = None,
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    rope_theta: Optional[float],
    window: Optional[int] = None,
    attn_fn: Optional[Callable] = None,   # f(q, k_cache, v_cache, ctx) -> out
    ctx_lens: Optional[torch.Tensor] = None,   # (B,) per-slot lengths
    seq_shard: Optional[Tuple[int, int]] = None,   # (offset, full length) of a sequence shard
    reduce: Optional[Callable] = None,   # tensor parallel: the wo product's sum
):
    """One decode step of an attention layer against its dense cache
    (port of ``repro/models/layers.py:129-202``).

    With ``ctx_lens`` every slot goes at its own length: rotary position
    ``ctx_lens[b]``, the new token's K/V written at ``min(ctx_lens[b],
    S - 1)``, ``min(ctx_lens[b] + 1, S)`` keys visible. Without it, every
    slot is at ``cur_len`` (``ctx_lens`` wins where both are given, as in
    the reference). With ``window`` the cache is a ring of ``S`` rows (a
    sliding-window layer's): the token is written at ``ctx % S`` with its
    rotary position applied at the write, and ``min(ctx + 1, S)`` rows are
    visible -- every row of a full ring, in ring order. The caches are
    updated *in place* (index assignment), as the paged pools are; the
    reference returns updated caches instead and relies on buffer
    donation. ``attn_fn`` receives ``q (B, Hq, hd)``, the caches and the
    visible lengths ``(B,)``; without one the plain reference runs.
    An f8 cache (``float8_e4m3fn``) takes the token through the
    reference's cast (:func:`repro_torch.core.attention.to_kv`); ``attn_fn``
    gets it as it is (the kernels widen in-register) and the plain path
    widens it to bf16, where the reference widens every read.
    With ``seq_shard = (offset, S_full)`` the caches are one rank's block of
    a cache of ``S_full`` positions split along the sequence, holding
    positions ``[offset, offset + S)``: positions, clamps and the lengths
    ``attn_fn`` receives are those of the full cache, and the token's K/V is
    written only where its position falls in this block (elsewhere the
    block's row keeps its value; the reference's ``dynamic_update_slice``
    on the sharded global cache). Under tensor parallelism the weights and
    caches are this rank's heads' blocks and ``reduce`` sums the ``wo``
    product over the ranks (:func:`attn_forward`).
    Returns ``(out, k_cache, v_cache)``.
    """
    if ctx_lens is None and cur_len is None:
        raise ValueError("attn_decode needs ctx_lens (per slot) or cur_len")
    B = x.shape[0]
    offset, S = (0, k_cache.shape[2]) if seq_shard is None else seq_shard
    if seq_shard is not None and (window is not None or attn_fn is None):
        raise ValueError("a sequence shard is a global layer's cache, read by an attn_fn "
                         "that merges across the shards")
    q, k, v = _project_qkv(p, x.to(COMPUTE_DTYPE), n_heads, n_kv, head_dim)
    if ctx_lens is not None:
        ctx_lens = ctx_lens.to(x.device)
        pos = ctx_lens[:, None]
        write = (ctx_lens % S if window is not None else torch.clamp(ctx_lens, max=S - 1)).long()
        ctx = torch.clamp(ctx_lens + 1, max=S).to(torch.int32)
    else:
        cur = int(cur_len)
        pos = torch.full((1,), cur, device=x.device)
        at = cur % S if window is not None else min(cur, S - 1)
        write = torch.full((B,), at, dtype=torch.long, device=x.device)
        ctx = torch.full((B,), min(cur + 1, S), dtype=torch.int32, device=x.device)
    q = _maybe_rope(q, pos, rope_theta)
    k = _maybe_rope(k, pos, rope_theta)
    rows = torch.arange(B, device=x.device)
    if seq_shard is None:
        kv_write(k_cache, (rows, slice(None), write), k[:, 0])
        kv_write(v_cache, (rows, slice(None), write), v[:, 0])
    else:
        _shard_write(k_cache, rows, write - offset, k[:, 0])
        _shard_write(v_cache, rows, write - offset, v[:, 0])
    qd = q.reshape(B, n_heads, head_dim)
    if attn_fn is not None:
        o = attn_fn(qd, k_cache, v_cache, ctx)
    else:
        o = mha_decode_ref(qd, widen_kv(k_cache), widen_kv(v_cache), ctx_lens=ctx)
    o = o.reshape(B, 1, n_heads * head_dim).to(COMPUTE_DTYPE)
    out = _reduced(o @ p["wo"].to(COMPUTE_DTYPE), reduce)
    return out.to(x.dtype), k_cache, v_cache


def cross_attn_decode(p, x: torch.Tensor, xk: torch.Tensor, xv: torch.Tensor, *,
                      n_heads: int, head_dim: int, reduce: Optional[Callable] = None
                      ) -> torch.Tensor:
    """The gated cross attention's decode read (``repro/models/
    transformer.py:862-875`` without the gate): the token's query ``x (B,
    1, D)`` (no q norm, as the reference) against every row of the cached
    image K/V ``xk``/``xv (B, Hkv, cross_kv_len, hd)``, through the plain
    oracle as the reference's engine runs it; ``reduce`` as in
    :func:`attn_decode`. Returns ``(B, 1, D)``."""
    B = x.shape[0]
    xc = x.to(COMPUTE_DTYPE)
    q = (xc @ p["wq"].to(COMPUTE_DTYPE)).reshape(B, n_heads, head_dim)
    o = mha_decode_ref(q, widen_kv(xk), widen_kv(xv)).reshape(B, 1, -1).to(COMPUTE_DTYPE)
    return _reduced(o @ p["wo"].to(COMPUTE_DTYPE), reduce).to(x.dtype)


def _decode_pages(page_tbl: torch.Tensor, write_pos: torch.Tensor, page_size: int):
    rows = torch.arange(page_tbl.shape[0], device=page_tbl.device)
    return page_tbl[rows, write_pos // page_size].long()


def decode_writer_rows(page_tbl: torch.Tensor, ctx_lens: torch.Tensor,
                       page_size: int) -> torch.Tensor:
    """:func:`null_page_writer_rows` of a decode step's writes (slot ``b``
    at position ``ctx_lens[b]``), computed once for every paged layer of
    the step (``writer=`` of :func:`attn_decode_paged`)."""
    capacity = page_tbl.shape[1] * page_size
    write_pos = torch.clamp(ctx_lens, max=capacity - 1).long()
    return null_page_writer_rows(_decode_pages(page_tbl, write_pos, page_size))


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
    rope_theta: Optional[float],
    ctx_lens: torch.Tensor,       # (B,) per-slot lengths
    attn_fn: Optional[Callable] = None,   # f(q, k_pool, v_pool, ctx) -> out
    k_scale: Optional[torch.Tensor] = None,   # int8 pools: (num_pages, Hkv) float32
    v_scale: Optional[torch.Tensor] = None,
    scale_per_head: bool = True,
    writer: Optional[torch.Tensor] = None,    # decode_writer_rows of the step
):
    """One decode step of a global-attention layer against the paged pool.

    The new token's K/V are written *in place* into page
    ``page_tbl[b, ctx_b // page_size]`` at offset ``ctx_b % page_size``
    (the reference returns updated pools instead and relies on buffer
    donation); idle slots, whose table rows are all null, write the
    reserved null page, whose contents are always masked, all with the last
    such slot's K/V (:func:`null_page_last_writer`; ``writer``, from
    :func:`decode_writer_rows`, computes its index once for the step's
    layers). ``attn_fn``
    receives the pools and the visible lengths; without one the pools are
    gathered to dense per-slot KV for the plain reference. Returns
    ``(out, k_pool, v_pool)``.

    ``k_scale``/``v_scale`` mark int8 pools (reference
    ``repro/models/layers.py:206-316``): the token write goes through
    :func:`paged_scatter_tokens_quant` (scales grow, touched pages
    requantize, in place), ``attn_fn`` receives the int8 pools with
    ``k_scales=``/``v_scales=``, and the plain path gathers through
    :func:`paged_gather_kv_dequant` to bf16.

    f8 pools (``float8_e4m3fn``): the write is the reference's cast
    (:func:`repro_torch.core.attention.to_kv`), ``attn_fn`` receives the
    e4m3 pools (the kernels widen in-register), and the plain path widens
    the gathered rows to bf16 (the reference widens the pool, then
    gathers: the same values).
    """
    B = x.shape[0]
    ps = k_pool.shape[2]
    capacity = page_tbl.shape[1] * ps
    q, k, v = _project_qkv(p, x.to(COMPUTE_DTYPE), n_heads, n_kv, head_dim)
    pos = ctx_lens[:, None]
    q = _maybe_rope(q, pos, rope_theta)
    k = _maybe_rope(k, pos, rope_theta)
    write_pos = torch.clamp(ctx_lens, max=capacity - 1).long()
    quant = k_scale is not None
    if quant:
        ones = torch.ones(B, dtype=torch.int32, device=x.device)
        paged_scatter_tokens_quant(k_pool, k_scale, page_tbl, write_pos, ones, k, scale_per_head,
                                   writer)
        paged_scatter_tokens_quant(v_pool, v_scale, page_tbl, write_pos, ones, v, scale_per_head,
                                   writer)
    else:
        pages_w = _decode_pages(page_tbl, write_pos, ps)
        at = (pages_w, slice(None), write_pos % ps)
        kv_write(k_pool, at, null_page_last_writer(pages_w, k[:, 0], writer))
        kv_write(v_pool, at, null_page_last_writer(pages_w, v[:, 0], writer))
    ctx = torch.clamp(ctx_lens + 1, max=capacity).to(torch.int32)
    qd = q.reshape(B, n_heads, head_dim)
    if attn_fn is not None:
        sc = dict(k_scales=k_scale, v_scales=v_scale) if quant else {}
        o = attn_fn(qd, k_pool, v_pool, ctx, **sc)
    elif quant:
        o = mha_decode_ref(
            qd, paged_gather_kv_dequant(k_pool, k_scale, page_tbl, dtype=COMPUTE_DTYPE),
            paged_gather_kv_dequant(v_pool, v_scale, page_tbl, dtype=COMPUTE_DTYPE),
            ctx_lens=ctx,
        )
    else:
        o = mha_decode_ref(
            qd, widen_kv(paged_gather_kv(k_pool, page_tbl)),
            widen_kv(paged_gather_kv(v_pool, page_tbl)), ctx_lens=ctx,
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
    rope_theta: Optional[float],
    attn_fn: Optional[Callable] = None,   # f(q, k_pool, v_pool, page_tbls, offs) -> o
    k_scale: Optional[torch.Tensor] = None,   # int8 pools: (num_pages, Hkv) float32
    v_scale: Optional[torch.Tensor] = None,
    scale_per_head: bool = True,
    writer: Optional[torch.Tensor] = None,    # chunk_writer_rows of the step
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

    With ``k_scale``/``v_scale`` (int8 pools, reference
    ``repro/models/layers.py:318-380``) the writes go through
    :func:`paged_scatter_tokens_quant`, ``attn_fn`` receives the int8 pools
    with ``k_scales=``/``v_scales=``, and the plain path dequantizes the
    whole pools to bf16 for the oracle. f8 pools: the writes are the
    reference's cast, ``attn_fn`` receives the e4m3 pools, and the plain
    path widens them to bf16, as the reference does.
    """
    N, C, _ = x.shape
    q, k, v = _project_qkv(p, x.to(COMPUTE_DTYPE), n_heads, n_kv, head_dim)
    pos = offs.to(x.device).long()[:, None] + torch.arange(C, device=x.device)[None, :]
    q = _maybe_rope(q, pos, rope_theta)
    k = _maybe_rope(k, pos, rope_theta)
    quant = k_scale is not None
    if quant:
        paged_scatter_tokens_quant(k_pool, k_scale, page_tbls, offs, lens, k, scale_per_head,
                                   writer)
        paged_scatter_tokens_quant(v_pool, v_scale, page_tbls, offs, lens, v, scale_per_head,
                                   writer)
    else:
        paged_scatter_tokens(k_pool, page_tbls, offs, lens, k, writer)
        paged_scatter_tokens(v_pool, page_tbls, offs, lens, v, writer)
    qh = q.transpose(1, 2)                                  # (N, Hq, C, hd)
    if attn_fn is not None:
        sc = dict(k_scales=k_scale, v_scales=v_scale) if quant else {}
        o = attn_fn(qh, k_pool, v_pool, page_tbls, offs, **sc)
    elif quant:
        o = mha_chunk_prefill_paged_ref(qh, dequant_pool(k_pool, k_scale),
                                        dequant_pool(v_pool, v_scale), page_tbls, offs)
    else:
        o = mha_chunk_prefill_paged_ref(qh, widen_kv(k_pool), widen_kv(v_pool), page_tbls, offs)
    o = o.transpose(1, 2).reshape(N, C, n_heads * head_dim)
    out = o.to(COMPUTE_DTYPE) @ p["wo"].to(COMPUTE_DTYPE)
    return out.to(x.dtype), k_pool, v_pool


def dequant_pool(pool: torch.Tensor, scales: torch.Tensor,
                 dtype: torch.dtype = COMPUTE_DTYPE) -> torch.Tensor:
    """A whole int8 pool ``(num_pages, H, page_size, d)`` widened to float32,
    times its ``(num_pages, H)`` scales, cast to ``dtype`` (the reference's
    plain chunk path and its ``fixed`` chunk attention)."""
    return (pool.float() * scales[:, :, None, None]).to(dtype)


def silu(g: torch.Tensor) -> torch.Tensor:
    """``x * (1 / (1 + exp(-x)))`` with every op rounded to the input's
    dtype: the op sequence XLA lowers ``jax.nn.silu`` to in bf16, which
    ``torch.sigmoid`` (one rounding) differs from in a third of bf16
    outputs."""
    return g * (1 / (1 + torch.exp(-g)))


# jax.nn.gelu's constants as the bf16 operands XLA multiplies by
_GELU_C = float(torch.tensor(math.sqrt(2 / math.pi), dtype=torch.float32).bfloat16())
_GELU_K = float(torch.tensor(0.044715, dtype=torch.float32).bfloat16())


def gelu(h: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh approximation, its default) as XLA runs it
    in bf16: ``x * (0.5 * (1 + tanh(c * (x + k * x*x*x))))`` with every op
    rounded to bf16 and the constants ``c = sqrt(2 / pi)`` and ``k =
    0.044715`` rounded to bf16 first (weakly typed scalars take the array's
    dtype). ``torch.nn.functional.gelu(approximate="tanh")``, which rounds
    once, differs in about 1.5% of bf16 inputs; this sequence in none with
    a normal output (XLA flushes subnormals)."""
    inner = _GELU_C * (h + _GELU_K * (h * h * h))
    return h * (0.5 * (1.0 + torch.tanh(inner)))


def ffn_forward(p, x: torch.Tensor, kind: str = "swiglu",
                compute_dtype: torch.dtype = COMPUTE_DTYPE,
                reduce: Optional[Callable] = None) -> torch.Tensor:
    """The feed-forward kinds of ``repro/models/layers.py:427-439``: SwiGLU
    (``silu(x wg) * (x wu)``), GeLU (``gelu(x wu)``) and squared ReLU
    (``relu(x wu)**2``, Nemotron-4), then ``wd``; the activations in
    ``compute_dtype``, op for op as XLA rounds them. Tensor parallel: the
    weights are this rank's blocks of the hidden width (column-parallel
    ``wg``/``wu``, row-parallel ``wd``) and ``reduce`` sums the ``wd``
    product over the ranks."""
    xc = x.to(compute_dtype)
    if kind == "swiglu":
        h = silu(xc @ p["wg"].to(compute_dtype)) * (xc @ p["wu"].to(compute_dtype))
    elif kind == "gelu":
        h = gelu(xc @ p["wu"].to(compute_dtype))
    elif kind == "squared_relu":
        r = torch.relu(xc @ p["wu"].to(compute_dtype))
        h = r * r
    else:
        raise ValueError(kind)
    return _reduced(h @ p["wd"].to(compute_dtype), reduce).to(x.dtype)
