"""Decoder-only transformer for the serving paths (port of the subset of
``repro.models.transformer`` that attention-only architectures run).

Parameters are a plain dict: ``embed``, ``final_norm``, optional
``unembed``, and ``layers``, one dict per layer in execution order (the
reference's stacked ``stages`` flattened; ``scan_layers``/``remat`` become a
plain loop and sharding hints disappear). Matmul weights may be stored in
bf16: the reference keeps them in float32 but casts them to bf16 at every
use, so the values multiplied are the same. Norm weights stay float32.

A decode cache is a list with one ``{"k", "v"}`` dict per layer: dense
per-slot rows ``(batch, Hkv, cache_len, hd)`` (:func:`init_cache`) or page
pools ``(num_pages, Hkv, page_size, hd)`` (:func:`init_paged_cache`; with
``kv_cache_dtype="int8"`` int8 pools and ``"k_scale"``/``"v_scale"``
``(num_pages, Hkv)`` float32 beside them); :func:`decode_step`,
:func:`prefill_chunks` and :func:`verify_step` write new K/V into it in
place.
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
from repro_torch.kernels.flash_prefill import flash_prefill
from .layers import (
    attn_decode,
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
    if cfg.kv_cache_dtype not in ("bf16", "int8"):
        raise NotImplementedError(
            f"{cfg.name}: kv_cache_dtype {cfg.kv_cache_dtype!r} is not ported yet "
            "(ROADMAP queue 1, item 18)"
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


def cache_from_numpy(tree, cfg: ModelConfig, device: DeviceLike = "cuda"
                     ) -> List[Dict[str, torch.Tensor]]:
    """The port's decode cache from the JAX package's cache tree as numpy
    (``jax.tree.map(np.asarray, cache)``): the stacked ``stages`` become one
    dict per layer; int8 pools stay int8, scales float32, K/V bf16 -- so a
    JAX engine's pools can be compared with, or handed to, the port's."""
    dev = resolve_device(device)

    def conv(name, a):
        a = np.asarray(a)
        if a.dtype == np.int8:
            return torch.from_numpy(a.copy()).to(dev)
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        return t.to(device=dev, dtype=torch.float32 if name.endswith("_scale") else torch.bfloat16)

    layers = []
    for (pattern, reps), stage in zip(cfg.stages, tree):
        for r in range(reps):
            for unit in stage:
                layers.append({k: conv(k, v[r]) for k, v in unit.items()})
    return layers


def _index(node, r):
    if isinstance(node, dict):
        return {k: _index(v, r) for k, v in node.items()}
    return node[r]


# ------------------------------------------------------------------ caches
def init_cache(
    cfg: ModelConfig, batch: int, cache_len: int, device: DeviceLike = "cuda"
) -> List[Dict[str, torch.Tensor]]:
    """Dense decode state (port of ``repro/models/transformer.py:162-217``
    for ``"attn"`` layers): per layer, bf16 K and V rows ``(batch, H_kv,
    cache_len, head_dim)``, one row per slot, zero-filled."""
    check_supported(cfg)
    dev = resolve_device(device)
    shape = (batch, cfg.n_kv_heads, cache_len, cfg.head_dim)
    return [
        {"k": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
         "v": torch.zeros(shape, dtype=torch.bfloat16, device=dev)}
        for _ in range(cfg.n_layers)
    ]


def init_paged_cache(
    cfg: ModelConfig, num_pages: int, page_size: int, device: DeviceLike = "cuda"
) -> List[Dict[str, torch.Tensor]]:
    """Paged decode state: per layer, K and V page pools ``(num_pages,
    H_kv, page_size, head_dim)``, bf16 -- or with ``kv_cache_dtype ==
    "int8"`` int8, with ``"k_scale"``/``"v_scale"`` leaves ``(num_pages,
    H_kv)`` float32, one symmetric scale per (page, kv head), 0 for an
    untouched page (reference ``repro/models/transformer.py:237-280``; all
    writes then go through
    :func:`repro_torch.core.attention.paged_scatter_tokens_quant`). One
    allocator's page ids index every layer's pools. Page 0 is the null
    page."""
    check_supported(cfg)
    dev = resolve_device(device)
    shape = (num_pages, cfg.n_kv_heads, page_size, cfg.head_dim)
    quant = cfg.kv_cache_dtype == "int8"
    dtype = torch.int8 if quant else torch.bfloat16
    cache = []
    for _ in range(cfg.n_layers):
        lc = {"k": torch.zeros(shape, dtype=dtype, device=dev),
              "v": torch.zeros(shape, dtype=dtype, device=dev)}
        if quant:
            for name in ("k_scale", "v_scale"):
                lc[name] = torch.zeros(num_pages, cfg.n_kv_heads, dtype=torch.float32, device=dev)
        cache.append(lc)
    return cache


def _scale_kw(cfg: ModelConfig, lc: Dict[str, torch.Tensor]) -> Dict:
    """The int8 scale operands of one layer's paged cache (none for bf16)."""
    if "k_scale" not in lc:
        return {}
    return dict(k_scale=lc["k_scale"], v_scale=lc["v_scale"],
                scale_per_head=cfg.kv_scale_granularity == "page_head")


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


def _prefill_attn(cfg: ModelConfig, L: int, device: torch.device) -> Callable:
    """The whole-prompt attention: K7 (:func:`flash_prefill`) on CUDA at
    every length; on the CPU what the reference computes --
    :func:`mha_prefill_ref`, or the q-chunked :func:`mha_prefill_chunked`
    above ``attn_q_chunk`` (``repro/models/transformer.py:287-322``)."""
    if device.type == "cuda":
        return flash_prefill
    if cfg.attn_q_chunk and L > cfg.attn_q_chunk:
        return functools.partial(mha_prefill_chunked, q_chunk=cfg.attn_q_chunk)
    return mha_prefill_ref


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, cache_len: int,
            true_len=None, write_kv: Optional[Callable] = None):
    """Forward over the prompt ``tokens (B, L)``.

    Returns ``(last_logits (B, V) float32, cache, cur_len)`` where
    ``cache[i] = {"k", "v"}`` holds layer ``i``'s K/V ``(B, Hkv, cache_len,
    hd)`` in bf16, zero past ``L``. With ``true_len`` (the reference's
    bucketed prefill) ``tokens`` is a prompt padded to a bucket: the logits
    are those of position ``true_len - 1`` and ``cur_len`` is ``true_len``;
    the cache rows past it hold the pad tokens' K/V, as the reference's do.
    ``true_len`` may be an int or a one-element tensor on the tokens'
    device (a captured admission reads it at run time). With ``write_kv``
    each layer's K/V ``(B, Hkv, L, hd)`` in bf16 go to ``write_kv(layer,
    k, v)`` as soon as the layer has run, and ``cache`` is None: only one
    layer's K/V live at a time, never ``cache_len`` rows of every layer.

    The attention is causal with ``q_offset`` 0: on CUDA tensors it runs the
    Hopper kernel K7 (:func:`flash_prefill`) at every prompt length -- the
    same function, computed by the kernel the reference has for it
    (``repro/kernels/flash_prefill.py:24``; its q-chunked path,
    ``transformer.py:287-322``, is what the reference's config calls the
    FlashAttention-2 baseline, ``transformer.py:72-74``). On CPU tensors it
    computes what the reference computes: :func:`mha_prefill_ref`, or the
    q-chunked :func:`mha_prefill_chunked` for prompts longer than
    ``attn_q_chunk`` (:func:`_prefill_attn` picks).
    """
    check_supported(cfg)
    B, L = tokens.shape
    if L > cache_len:
        raise ValueError(f"prompt of {L} tokens exceeds cache_len {cache_len}")
    attn = _prefill_attn(cfg, L, tokens.device)
    x = _embed(params, cfg, tokens)
    cache = None if write_kv is not None else []
    for i, lp in enumerate(params["layers"]):
        h, (kh, vh) = attn_forward(
            lp["attn"], rms_norm(x, lp["ln1"], cfg.norm_eps),
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta, attn=attn,
        )
        x = _ffn_part(lp, x + h, cfg)
        kh, vh = kh.to(torch.bfloat16), vh.to(torch.bfloat16)
        if write_kv is not None:
            write_kv(i, kh, vh)
            continue
        pad = (0, 0, 0, cache_len - L)
        cache.append({"k": torch.nn.functional.pad(kh, pad),
                      "v": torch.nn.functional.pad(vh, pad)})
    if torch.is_tensor(true_len):
        n = true_len.reshape(1)
        x_last = x.index_select(1, (n - 1).long())[:, 0]
    else:
        n = L if true_len is None else int(true_len)
        x_last = x[:, n - 1]
    x_last = rms_norm(x_last, params["final_norm"], cfg.norm_eps)
    return _unembed(params, cfg, x_last), cache, n


def decode_step(
    params,
    cfg: ModelConfig,
    cache,
    tokens: torch.Tensor,           # (B, 1)
    attn_fn: Optional[Callable] = None,
    ctx_lens: Optional[torch.Tensor] = None,   # (B,) per-slot lengths
    page_tbl: Optional[torch.Tensor] = None,   # (B, pages_per_slot)
):
    """One decode step, updating the cache in place. Returns ``(logits (B,
    V) float32, cache)``. With ``page_tbl`` the cache holds page pools
    (:func:`init_paged_cache`) and ``attn_fn`` receives the pools; without
    it the cache is dense (:func:`init_cache`, the branch of
    ``repro/models/transformer.py:843-857``) and ``attn_fn`` receives the
    per-slot K/V. Either way ``attn_fn`` also gets the visible lengths."""
    check_supported(cfg)
    if ctx_lens is None:
        raise ValueError("decode_step needs the per-slot lengths ctx_lens")
    x = _embed(params, cfg, tokens)
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
              rope_theta=cfg.rope_theta, ctx_lens=ctx_lens, attn_fn=attn_fn)
    for lp, lc in zip(params["layers"], cache):
        xn = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if page_tbl is not None:
            h, lc["k"], lc["v"] = attn_decode_paged(lp["attn"], xn, lc["k"], lc["v"], page_tbl,
                                                    **kw, **_scale_kw(cfg, lc))
        else:
            h, lc["k"], lc["v"] = attn_decode(lp["attn"], xn, lc["k"], lc["v"], **kw)
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
            rope_theta=cfg.rope_theta, attn_fn=attn_fn, **_scale_kw(cfg, lc),
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


def verify_step(
    params,
    cfg: ModelConfig,
    cache,
    tokens: torch.Tensor,           # (N, R) [last committed token, k drafts]
    offs: torch.Tensor,             # (N,) committed context per row
    lens: torch.Tensor,             # (N,) valid tokens per row (0 when masked)
    page_tbls: torch.Tensor,        # (N, W) page table rows
    attn_fn: Optional[Callable] = None,
):
    """Speculative verify (``repro/models/transformer.py:760-792``): score
    a block of ``R = k + 1`` stacked tokens per sequence in one forward and
    return the logits of every position. Row ``i``'s K/V land at depth
    ``offs[n] + i`` as a prefill chunk's do, and its logits predict the
    token at depth ``offs[n] + i + 1``: :func:`prefill_chunks` without the
    last-position gather. A rejected tail needs no undo -- the committed
    length never advances over it. Returns ``(logits (N, R, V) float32,
    cache)``."""
    x = _chunk_forward(params, cfg, cache, tokens, offs, lens.to(tokens.device), page_tbls,
                       attn_fn)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(params, cfg, x), cache
