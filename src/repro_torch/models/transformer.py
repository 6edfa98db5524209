"""Decoder-only transformer for the paged serving path (port of the subset
of ``repro.models.transformer`` that attention-only architectures run).

Parameters are a plain dict: ``embed``, ``final_norm``, optional
``unembed``, and ``layers``, one dict per layer in execution order (the
reference's stacked ``stages`` flattened; ``scan_layers``/``remat`` become a
plain loop and sharding hints disappear). Matmul weights may be stored in
bf16: the reference keeps them in float32 but casts them to bf16 at every
use, so the values multiplied are the same. Norm weights stay float32.

The paged decode cache is a list with one ``{"k", "v"}`` dict of page pools
``(num_pages, Hkv, page_size, hd)`` per layer; :func:`decode_step` and
:func:`prefill_chunks` write new K/V into it in place.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.attention import mha_prefill_chunked, mha_prefill_ref
from repro_torch.device import DeviceLike, resolve_device
from .layers import (
    attn_decode_paged,
    attn_forward,
    attn_prefill_chunk_paged,
    ffn_forward,
    rms_norm,
)


@dataclass(frozen=True)
class ModelConfig:
    """Copy of ``repro.models.transformer.ModelConfig``. The port runs the
    attention-only (``"attn"``) stages with a SwiGLU FFN; other fields are
    kept so configurations read the same, and are refused where used."""

    name: str
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    stages: Tuple[Tuple[Tuple[str, ...], int], ...]
    ffn_kind: str = "swiglu"
    moe: Optional[object] = None
    window: int = 4096
    rope_theta: Optional[float] = 10000.0   # None -> sinusoidal absolute
    qk_norm: bool = False
    cross_kv_len: int = 0
    d_rnn: int = 0
    mlstm_proj_factor: float = 2.0
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    attn_q_chunk: int = 512
    loss_chunk: int = 512
    true_n_heads: int = 0
    remat: bool = True
    scan_layers: bool = True
    unroll_scans: bool = False
    kv_cache_dtype: str = "bf16"            # 'bf16' | 'f8' | 'int8'
    kv_scale_granularity: str = "page_head"

    def __post_init__(self):
        n = sum(len(pat) * reps for pat, reps in self.stages)
        if n != self.n_layers:
            raise ValueError(f"{self.name}: stages give {n} layers")


def check_supported(cfg: ModelConfig) -> None:
    """Refuse what this port does not run yet, naming its ROADMAP item."""
    later = sorted({kind for pattern, _ in cfg.stages for kind in pattern} - {"attn"})
    if later:
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {later} are not ported yet (ROADMAP queue 1, item 14)"
        )
    if cfg.moe is not None or cfg.ffn_kind != "swiglu":
        raise NotImplementedError(
            f"{cfg.name}: MoE / non-SwiGLU FFNs are not ported yet (ROADMAP queue 1, item 14)"
        )
    if cfg.rope_theta is None:
        raise NotImplementedError(
            f"{cfg.name}: sinusoidal positions are not ported yet (ROADMAP queue 1, item 14)"
        )
    if cfg.kv_cache_dtype != "bf16":
        raise NotImplementedError(
            f"{cfg.name}: kv_cache_dtype {cfg.kv_cache_dtype!r} is not ported yet "
            "(ROADMAP queue 1, item 9)"
        )


# ------------------------------------------------------------------ params
def init_params(
    cfg: ModelConfig,
    generator: torch.Generator,
    device: DeviceLike = "cuda",
    dtype: torch.dtype = torch.bfloat16,
) -> Dict:
    """Random weights with the reference's initialisation (normal /
    sqrt(fan_in), embeddings 0.02, norm weights 0), drawn from
    ``generator`` on its device and stored on ``device``: matmul weights in
    ``dtype``, norm weights in float32. (The numbers differ from the JAX
    package's for the same seed; the tests carry weights across with
    :func:`params_from_numpy` instead.)"""
    check_supported(cfg)
    dev = resolve_device(device)
    D, Hq, Hkv, hd, F = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff

    def dense(shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        w = torch.randn(shape, generator=generator, device=generator.device)
        return (w * scale).to(device=dev, dtype=dtype)

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=dev)

    params = {
        "embed": dense((cfg.vocab_size, D), scale=0.02),
        "final_norm": zeros(D),
        "layers": [],
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense((D, cfg.vocab_size))
    for _ in range(cfg.n_layers):
        attn = {
            "wq": dense((D, Hq * hd)), "wk": dense((D, Hkv * hd)),
            "wv": dense((D, Hkv * hd)), "wo": dense((Hq * hd, D)),
        }
        if cfg.qk_norm:
            attn["q_norm"], attn["k_norm"] = zeros(hd), zeros(hd)
        params["layers"].append({
            "ln1": zeros(D), "attn": attn, "ln2": zeros(D),
            "ffn": {"wg": dense((D, F)), "wu": dense((D, F)), "wd": dense((F, D))},
        })
    return params


_NORM_KEYS = ("ln1", "ln2", "q_norm", "k_norm", "final_norm")


def params_from_numpy(tree, cfg: ModelConfig, device: DeviceLike = "cuda") -> Dict:
    """The port's parameters from the JAX parameter tree as numpy
    (``jax.tree.map(np.asarray, params)``): stacked ``stages`` become the
    flat ``layers`` list, matmul weights go to bf16 and norms stay float32,
    so both packages compute the same model."""
    check_supported(cfg)
    dev = resolve_device(device)

    def conv(name, a):
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        return t.to(device=dev, dtype=torch.float32 if name in _NORM_KEYS else torch.bfloat16)

    def walk(name, node):
        if isinstance(node, dict):
            return {k: walk(k, v) for k, v in node.items()}
        return conv(name, node)

    params = {
        "embed": conv("embed", tree["embed"]),
        "final_norm": conv("final_norm", tree["final_norm"]),
        "layers": [],
    }
    if "unembed" in tree:
        params["unembed"] = conv("unembed", tree["unembed"])
    for (pattern, reps), stage in zip(cfg.stages, tree["stages"]):
        for r in range(reps):
            for unit in stage:
                params["layers"].append(
                    walk("", {k: _index(v, r) for k, v in unit.items()})
                )
    return params


def _index(node, r):
    if isinstance(node, dict):
        return {k: _index(v, r) for k, v in node.items()}
    return node[r]


# ------------------------------------------------------------------ caches
def init_paged_cache(
    cfg: ModelConfig, num_pages: int, page_size: int, device: DeviceLike = "cuda"
) -> List[Dict[str, torch.Tensor]]:
    """Paged decode state: per layer, bf16 K and V page pools
    ``(num_pages, H_kv, page_size, head_dim)``. One allocator's page ids
    index every layer's pools. Page 0 is the null page."""
    check_supported(cfg)
    dev = resolve_device(device)
    shape = (num_pages, cfg.n_kv_heads, page_size, cfg.head_dim)
    return [
        {"k": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
         "v": torch.zeros(shape, dtype=torch.bfloat16, device=dev)}
        for _ in range(cfg.n_layers)
    ]


# ------------------------------------------------------------------ forward
def _embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding: the bf16 row times sqrt(d_model) in float32 (the
    reference multiplies by a numpy float64 scalar, which promotes to
    float32), so the residual stream is float32."""
    x = params["embed"][tokens.long()].to(torch.bfloat16).float()
    return x * float(np.float32(np.sqrt(cfg.d_model)))


def _unembed(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return (x.to(torch.bfloat16) @ w.to(torch.bfloat16)).float()


def _ffn_part(p, x, cfg: ModelConfig):
    return x + ffn_forward(p["ffn"], rms_norm(x, p["ln2"], cfg.norm_eps))


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, cache_len: int):
    """Forward over the prompt ``tokens (B, L)`` at its exact length.

    Returns ``(last_logits (B, V) float32, cache, cur_len)`` where
    ``cache[i] = {"k", "v"}`` holds layer ``i``'s K/V ``(B, Hkv, cache_len,
    hd)`` in bf16, zero past ``L``. Prompts longer than ``attn_q_chunk``
    use the q-chunked exact attention, as the reference does.
    """
    check_supported(cfg)
    B, L = tokens.shape
    if L > cache_len:
        raise ValueError(f"prompt of {L} tokens exceeds cache_len {cache_len}")
    attn = mha_prefill_ref
    if cfg.attn_q_chunk and L > cfg.attn_q_chunk:
        attn = functools.partial(mha_prefill_chunked, q_chunk=cfg.attn_q_chunk)
    x = _embed(params, cfg, tokens)
    cache = []
    for lp in params["layers"]:
        h, (kh, vh) = attn_forward(
            lp["attn"], rms_norm(x, lp["ln1"], cfg.norm_eps),
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta, attn=attn,
        )
        x = _ffn_part(lp, x + h, cfg)
        pad = (0, 0, 0, cache_len - L)
        cache.append({
            "k": torch.nn.functional.pad(kh.to(torch.bfloat16), pad),
            "v": torch.nn.functional.pad(vh.to(torch.bfloat16), pad),
        })
    x_last = rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
    return _unembed(params, cfg, x_last), cache, L


def decode_step(
    params,
    cfg: ModelConfig,
    cache,
    tokens: torch.Tensor,           # (B, 1)
    attn_fn: Optional[Callable] = None,
    ctx_lens: Optional[torch.Tensor] = None,   # (B,) per-slot lengths
    page_tbl: Optional[torch.Tensor] = None,   # (B, pages_per_slot)
):
    """One decode step against the paged cache, which is updated in place.
    Returns ``(logits (B, V) float32, cache)``. ``attn_fn`` (optional)
    receives the page pools and the visible lengths."""
    if page_tbl is None:
        raise NotImplementedError(
            "dense-cache decode is not ported yet (ROADMAP queue 1, next slice: "
            "the dense-cache engine); pass page_tbl"
        )
    check_supported(cfg)
    x = _embed(params, cfg, tokens)
    for lp, lc in zip(params["layers"], cache):
        h, lc["k"], lc["v"] = attn_decode_paged(
            lp["attn"], rms_norm(x, lp["ln1"], cfg.norm_eps),
            lc["k"], lc["v"], page_tbl,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta, ctx_lens=ctx_lens, attn_fn=attn_fn,
        )
        x = _ffn_part(lp, x + h, cfg)
    x = rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
    return _unembed(params, cfg, x), cache


def supports_chunked_prefill(cfg: ModelConfig) -> bool:
    """Chunked prefill streams prompt pieces through the paged pool: every
    stage must be a global-attention layer and positions must be rotary.
    Other architectures fall back to blocking admission."""
    return cfg.rope_theta is not None and all(
        kind == "attn" for pattern, _ in cfg.stages for kind in pattern
    )


def _chunk_forward(
    params,
    cfg: ModelConfig,
    cache,
    tokens: torch.Tensor,           # (N, C) one token block per row
    offs: torch.Tensor,             # (N,) tokens already in the cache per row
    lens: torch.Tensor,             # (N,) valid tokens in each block
    page_tbls: torch.Tensor,        # (N, W) page table rows of the blocks
    attn_fn: Optional[Callable] = None,
):
    """Run N token blocks through every layer against the paged cache,
    appending K/V at each row's depth ``offs[n]`` (in place). Returns the
    hidden states ``(N, C, D)``."""
    if not supports_chunked_prefill(cfg):
        raise ValueError(
            f"{cfg.name}: chunked prefill requires all-'attn' stages and rotary "
            "positions (see supports_chunked_prefill)"
        )
    check_supported(cfg)
    x = _embed(params, cfg, tokens)
    for lp, lc in zip(params["layers"], cache):
        h, lc["k"], lc["v"] = attn_prefill_chunk_paged(
            lp["attn"], rms_norm(x, lp["ln1"], cfg.norm_eps),
            lc["k"], lc["v"], page_tbls, offs, lens,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta, attn_fn=attn_fn,
        )
        x = _ffn_part(lp, x + h, cfg)
    return x


def prefill_chunks(
    params,
    cfg: ModelConfig,
    cache,
    tokens: torch.Tensor,           # (N, C) one prompt chunk per row
    offs: torch.Tensor,             # (N,) tokens already prefilled per row
    lens: torch.Tensor,             # (N,) valid tokens in each chunk
    page_tbls: torch.Tensor,        # (N, W) page table rows of the chunks
    attn_fn: Optional[Callable] = None,
):
    """Forward N prompt chunks against the shared paged cache, the
    chunked-prefill sibling of :func:`decode_step`: each row is one chunk of
    one request's prompt at its own depth ``offs[n]``; K/V go straight into
    the page pools (in place) and queries attend causally over the row's
    visible prefix. Returns ``(logits (N, V) float32, cache)``, the logits
    at each row's last valid position: a row that finishes its prompt
    samples its first token from them."""
    N, C = tokens.shape
    lens = lens.to(tokens.device)
    x = _chunk_forward(params, cfg, cache, tokens, offs, lens, page_tbls, attn_fn)
    idx = torch.clamp(lens.long() - 1, 0, C - 1)
    x_last = x[torch.arange(N, device=x.device), idx]
    x_last = rms_norm(x_last, params["final_norm"], cfg.norm_eps)
    return _unembed(params, cfg, x_last), cache
