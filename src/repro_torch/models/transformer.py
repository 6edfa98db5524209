"""Decoder-only transformer for the serving and training paths (port of
``repro.models.transformer``): the attention kinds ``attn`` (global),
``win`` (sliding window) and ``xattn`` (self attention plus gated cross
attention to image embeddings), each with a SwiGLU, GeLU or squared-ReLU
FFN or a MoE (:mod:`.moe`), with rotary or absolute sinusoidal positions;
and the recurrent kinds (:mod:`.recurrent`) ``rglru`` (Griffin's RG-LRU,
with the FFN) and ``mlstm`` / ``slstm`` (xLSTM's self-contained blocks,
no FFN).

Parameters are a plain dict: ``embed``, ``final_norm``, optional
``unembed``, and ``layers``, one dict per layer in execution order (the
reference's stacked ``stages`` flattened in stage order, repeat by repeat,
each repeat's pattern in order: :func:`layer_kinds` gives each layer's
kind; ``scan_layers`` becomes a plain loop and sharding hints disappear).
Matmul weights may be stored in bf16 for serving: the reference keeps them
in float32 but casts them to bf16 at every use, so the values multiplied
are the same. Training keeps float32 master weights (``init_params(...,
dtype=torch.float32)``), as the reference does. Norm weights and the
cross-attention gate stay float32. :func:`params_from_numpy` and
:func:`params_to_numpy` carry a tree across in the reference's stacked
layout, :func:`params_for_serving` casts trained weights to what the
engine serves.

Training (``repro/models/transformer.py:354-486``): :func:`forward_hidden`
runs every layer's whole-sequence form, each stage unit checkpointed
(``torch.utils.checkpoint``) where ``cfg.remat`` is set, as
``jax.checkpoint(unit_fn)``; :func:`loss_fn` is the next-token cross entropy
in sequence chunks of ``loss_chunk`` rows, each chunk's logits
rematerialised, plus the MoE layers' load-balancing loss. Its attention is
the plain, differentiable one the reference computes on every device
(:func:`_plain_attn`); ``prefill`` keeps the kernel K7 on CUDA.

A decode cache is a list with one dict per layer. Dense
(:func:`init_cache`): ``"k"``/``"v"`` rows ``(batch, Hkv, S, hd)`` per
slot, ``S`` the cache length or, for a ``win`` layer, its ring of
``min(cache_len, window)`` rows; an ``xattn`` layer adds ``"xk"``/``"xv"``
``(batch, Hkv, cross_kv_len, hd)``. Paged (:func:`init_paged_cache`): the
``attn`` layers hold page pools ``(num_pages, Hkv, page_size, hd)`` (with
``kv_cache_dtype="int8"`` int8 pools and ``"k_scale"``/``"v_scale"``
``(num_pages, Hkv)`` float32 beside them); ``win`` and ``xattn`` layers
keep their dense per-slot rows in bf16, as the reference's paged cache
does. A recurrent layer keeps its per-slot float32 state dense in both:
``rglru`` ``"h"`` ``(batch, d_rnn)`` and ``"conv"`` ``(batch, 3, d_rnn)``;
``mlstm`` ``"C"`` ``(batch, H, hd, hd)``, ``"n"`` ``(batch, H, hd)``, ``"m"``
``(batch, H)`` (``hd`` of the projected width); ``slstm`` ``"c"``, ``"n"``,
``"m"``, ``"h"`` ``(batch, H, d_model / H)``. :func:`decode_step`,
:func:`prefill_chunks` and :func:`verify_step` write new K/V and states
into it in place.

``kv_cache_dtype`` picks the storage as the reference does
(``repro/models/transformer.py:164-167``, ``:245-253``): ``"f8"`` stores
``torch.float8_e4m3fn`` in every K/V leaf -- pools, ``win`` rings,
``xattn`` rows -- written through the reference's cast
(:func:`repro_torch.core.attention.to_kv`); ``"bf16"``, ``"f16"`` and
``"f32"`` store bf16 (the reference's f16 and f32 caches are bf16 arrays,
though its ``KVLayout`` counts them 2 and 4 bytes); ``"int8"`` quantizes
the pools only. Any other value is the reference's ``KVLayout`` refusal
(:func:`check_supported`).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.attention import chunk_writer_rows, mha_prefill_chunked, mha_prefill_ref
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.flash_prefill import flash_prefill
from .layers import (
    attn_decode,
    attn_decode_paged,
    attn_forward,
    attn_prefill_chunk_paged,
    cross_attn_decode,
    decode_writer_rows,
    ffn_forward,
    remat,
    rms_norm,
    sinusoidal_pos,
)
from .moe import MoEConfig, moe_forward, moe_param_shapes
from repro_torch.distributed.hints import hint
from . import recurrent as rec

ATTN_KINDS = ("attn", "win", "xattn")
RECURRENT_KINDS = ("rglru", "mlstm", "slstm")


@dataclass(frozen=True)
class ModelConfig:
    """Copy of ``repro.models.transformer.ModelConfig``. ``scan_layers``
    and ``unroll_scans`` (the reference's XLA lowering choices) are kept so
    configurations read the same; the port's loops are plain."""

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
    moe: Optional[MoEConfig] = None
    window: int = 4096
    rope_theta: Optional[float] = 10000.0   # None -> sinusoidal absolute
    qk_norm: bool = False
    cross_kv_len: int = 0                   # >0 for 'xattn' archs
    d_rnn: int = 0                          # rglru width (0 -> d_model)
    mlstm_proj_factor: float = 2.0
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    attn_q_chunk: int = 512
    loss_chunk: int = 512
    true_n_heads: int = 0                   # pre-padding head count (6ND)
    remat: bool = True
    scan_layers: bool = True
    unroll_scans: bool = False
    kv_cache_dtype: str = "bf16"            # 'bf16' | 'f8' | 'int8'
    kv_scale_granularity: str = "page_head"

    def __post_init__(self):
        n = sum(len(pat) * reps for pat, reps in self.stages)
        if n != self.n_layers:
            raise ValueError(f"{self.name}: stages give {n} layers")

    @property
    def rnn_width(self):
        return self.d_rnn or self.d_model

    @property
    def spec_heads(self):
        return self.true_n_heads or self.n_heads


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """Each layer's kind in execution order: stage by stage, repeat by
    repeat, the stage's pattern in order (the order of ``params["layers"]``
    and of a cache's layers)."""
    return [kind for pattern, reps in cfg.stages for _ in range(reps) for kind in pattern]


# the KV storage dtypes the reference's KVLayout knows, and the torch dtype
# each stores its K/V leaves in (an int8 layout's pools are int8, every
# other leaf bf16)
KV_STORAGE = {"f32": torch.bfloat16, "bf16": torch.bfloat16, "f16": torch.bfloat16,
              "f8": torch.float8_e4m3fn, "int8": torch.bfloat16}


def check_supported(cfg: ModelConfig) -> None:
    """Refuse a KV storage dtype the reference does not know, with its
    ``KVLayout``'s error (``repro/serving/kvpool.py:81-86``)."""
    if cfg.kv_cache_dtype not in KV_STORAGE:
        raise ValueError(f"unknown kv_dtype {cfg.kv_cache_dtype!r} "
                         f"(expected one of {sorted(KV_STORAGE)})")


# ------------------------------------------------------------------ params
def init_params(
    cfg: ModelConfig,
    generator: torch.Generator,
    device: DeviceLike = "cuda",
    dtype: torch.dtype = torch.bfloat16,
    shard: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None,
) -> Dict:
    """Random weights with the reference's initialisation (normal /
    sqrt(fan_in) -- for a stacked expert weight ``(E, ...)`` the reference
    takes ``E`` as the fan-in, and so does the port --, embeddings 0.02, norm
    weights and the cross-attention gate 0; the recurrent blocks' own, of
    :mod:`.recurrent`), drawn from ``generator`` on its device and stored
    on ``device``: matmul weights in ``dtype``, norm weights and the
    recurrent leaves the reference reads as float32 (:data:`F32_KEYS`) in
    float32. (The numbers differ from the JAX
    package's for the same seed; the tests carry weights across with
    :func:`params_from_numpy` instead.)

    ``shard(path, leaf)`` (``path`` as :func:`repro_torch.training.tree.
    flatten` names the leaf) keeps a rank's block of each leaf as soon as
    it is drawn, so only one whole leaf lives at a time (tensor-parallel
    serving: every rank draws the same numbers and keeps its own block).
    On the ``meta`` device nothing is drawn: the leaves' shapes alone (the
    recurrent blocks draw their small vectors on the generator's device)."""
    check_supported(cfg)
    dev = resolve_device(device)
    D, Hq, Hkv, hd, F = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    keep = shard or (lambda path, t: t)

    def dense(path, shape, scale=None):
        if dev.type == "meta":
            return torch.empty(shape, dtype=dtype, device=dev)
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        w = torch.randn(shape, generator=generator, device=generator.device)
        return keep(path, w.mul_(scale).to(device=dev, dtype=dtype))

    def zeros(path, n):
        return keep(path, torch.zeros(n, dtype=torch.float32, device=dev))

    params = {
        "embed": dense("embed", (cfg.vocab_size, D), scale=0.02),
        "final_norm": zeros("final_norm", D),
        "layers": [],
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense("unembed", (D, cfg.vocab_size))

    def attn_params(pre):
        attn = {
            "wq": dense(f"{pre}/wq", (D, Hq * hd)), "wk": dense(f"{pre}/wk", (D, Hkv * hd)),
            "wv": dense(f"{pre}/wv", (D, Hkv * hd)), "wo": dense(f"{pre}/wo", (Hq * hd, D)),
        }
        if cfg.qk_norm:
            attn["q_norm"], attn["k_norm"] = zeros(f"{pre}/q_norm", hd), zeros(f"{pre}/k_norm", hd)
        return attn

    def tree(pre, shapes):
        return {k: tree(f"{pre}/{k}", v) if isinstance(v, dict) else dense(f"{pre}/{k}", v)
                for k, v in shapes.items()}

    def recurrent(pre, block):
        return {k: keep(f"{pre}/{k}", v) for k, v in block.items()}

    for i, kind in enumerate(layer_kinds(cfg)):
        pre = f"layers/{i}"
        layer = {"ln1": zeros(f"{pre}/ln1", D)}
        if kind == "rglru":
            layer["rec"] = recurrent(f"{pre}/rec",
                                     rec.rglru_init(generator, D, cfg.rnn_width, dev, dtype))
        elif kind == "mlstm":
            layer["rec"] = recurrent(f"{pre}/rec", rec.mlstm_init(
                generator, D, Hq, cfg.mlstm_proj_factor, dev, dtype))
        elif kind == "slstm":
            layer["rec"] = recurrent(f"{pre}/rec", rec.slstm_init(generator, D, Hq, dev, dtype))
        else:
            layer["attn"] = attn_params(f"{pre}/attn")
        if kind == "xattn":
            layer["ln_x"] = zeros(f"{pre}/ln_x", D)
            layer["xattn"] = attn_params(f"{pre}/xattn")
            layer["xgate"] = zeros(f"{pre}/xgate", ())
        if kind in ("mlstm", "slstm"):
            pass                        # self-contained blocks: no FFN
        elif cfg.moe is not None:
            layer["ln2"] = zeros(f"{pre}/ln2", D)
            layer["moe"] = tree(f"{pre}/moe", moe_param_shapes(D, cfg.moe))
        elif F > 0:
            # drawn in the order the reference's ffn_init lays them out
            names = ("wg", "wu", "wd") if cfg.ffn_kind == "swiglu" else ("wu", "wd")
            shapes = {"wg": (D, F), "wu": (D, F), "wd": (F, D)}
            layer["ln2"] = zeros(f"{pre}/ln2", D)
            layer["ffn"] = {name: dense(f"{pre}/ffn/{name}", shapes[name]) for name in names}
        params["layers"].append(layer)
    return params


# leaves read as float32: the norms and the gate, and the recurrent
# blocks' lam (recurrent.py:65), b_if (:133), sLSTM's r (:366) and inner
# norms (:315, :385 of repro/models/recurrent.py)
F32_KEYS = ("ln1", "ln2", "ln_x", "xgate", "q_norm", "k_norm", "final_norm",
            "lam", "b_if", "r", "ln_inner")
# a recurrent layer's per-slot state leaves, float32 in every cache
STATE_KEYS = ("h", "conv", "C", "n", "m", "c")


def params_from_numpy(tree, cfg: ModelConfig, device: DeviceLike = "cuda",
                      dtype: torch.dtype = torch.bfloat16) -> Dict:
    """The port's parameters from the JAX parameter tree as numpy
    (``jax.tree.map(np.asarray, params)``, or a restored checkpoint's tree
    of arrays or tensors): stacked ``stages`` become the flat ``layers``
    list (:func:`layer_kinds` order), matmul weights -- the MoE router and
    experts too -- go to ``dtype`` (bf16 for serving, float32 master weights
    for training) and the :data:`F32_KEYS` leaves (norms, the gate, the
    recurrent ``lam``, ``b_if``, ``r``) stay float32, so both packages
    compute the same model. :func:`params_to_numpy` is the inverse."""
    check_supported(cfg)
    dev = resolve_device(device)

    def conv(name, a):
        t = a if torch.is_tensor(a) else torch.from_numpy(np.array(a, dtype=np.float32))
        return t.to(device=dev, dtype=torch.float32 if name in F32_KEYS else dtype)

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


def params_to_numpy(params, cfg: ModelConfig) -> Dict:
    """The reference's parameter tree from the port's parameters, float32
    numpy on the host: ``embed``, ``final_norm``, ``unembed`` where untied,
    and ``stages``, one tuple of unit dicts per stage whose leaves stack the
    stage's repeats, ``(reps, ...)`` (``repro/models/transformer.py:
    134-158``). The inverse of :func:`params_from_numpy`; a checkpoint
    stores this tree, so either package restores the other's."""
    def host(t):
        return t.detach().to(device="cpu", dtype=torch.float32).numpy()

    return stacked_tree(params, cfg, lambda nodes: np.stack([host(n) for n in nodes]), host)


def stacked_tree(params, cfg: ModelConfig, stack: Callable, single: Callable) -> Dict:
    """The reference's stacked layout of a tree in the port's layout
    (parameters, a moment, or their specs): each top-level leaf through
    ``single``, each stacked leaf ``stack(the leaves of its layers)``, in
    the stage's repeat order."""
    slots = layer_slots(cfg)

    def walk(nodes):
        if isinstance(nodes[0], dict):
            return {k: walk([n[k] for n in nodes]) for k in nodes[0]}
        return stack(nodes)

    tree = {k: single(params[k]) for k in ("embed", "final_norm", "unembed") if k in params}
    tree["stages"] = [
        tuple(walk([layer for layer, s in zip(params["layers"], slots) if s == (si, pi)])
              for pi in range(len(pattern)))
        for si, (pattern, _) in enumerate(cfg.stages)
    ]
    return tree


def layer_slots(cfg: ModelConfig) -> List[Tuple[int, int]]:
    """Where each entry of the port's ``layers`` list sits in the
    reference's stacked tree: ``(stage, position in the stage's pattern)``;
    the stage's repeats of one position stack into one leaf."""
    return [(si, pi) for si, (pattern, reps) in enumerate(cfg.stages)
            for _ in range(reps) for pi in range(len(pattern))]


def stacked_leaf(path: str, ndim: int, slots: Sequence = ()) -> Tuple[Hashable, int]:
    """The reference's stacked leaf that the port's leaf at ``path`` (the
    flattened name, ``layers/<i>/<key>`` under a layer) belongs to, and that
    leaf's rank. A top-level leaf is its own, at its own rank; a layer's
    leaf stacks with the same key of every repeat of its stage, one axis
    more. ``slots`` (:func:`layer_slots`) names a layer's stacked leaf; its
    rank needs none."""
    if not path.startswith("layers/"):
        return path, ndim
    _, i, rest = path.split("/", 2)
    return ((slots[int(i)], rest) if slots else None), ndim + 1


def params_for_serving(params) -> Dict:
    """Trained weights as the engine serves them: matmul leaves bf16, the
    :data:`F32_KEYS` leaves float32 -- equal to :func:`params_from_numpy` of
    the same tree (both round float32 to bf16 to nearest even)."""
    def conv(name, t):
        if isinstance(t, dict):
            return {k: conv(k, v) for k, v in t.items()}
        if isinstance(t, list):
            return [conv("", v) for v in t]
        return t.detach().to(torch.float32 if name in F32_KEYS else torch.bfloat16, copy=True)

    return {k: conv(k, v) for k, v in params.items()}


def cache_from_numpy(tree, cfg: ModelConfig, device: DeviceLike = "cuda"
                     ) -> List[Dict[str, torch.Tensor]]:
    """The port's decode cache from the JAX package's cache tree as numpy
    (``jax.tree.map(np.asarray, cache)``): the stacked ``stages`` become one
    dict per layer; int8 pools stay int8, scales and recurrent states
    float32, K/V bf16 -- so a JAX engine's pools can be compared with, or
    handed to, the port's. f8 leaves stay float8_e4m3fn, byte for byte."""
    dev = resolve_device(device)

    def conv(name, a):
        a = np.asarray(a)
        if a.dtype == np.int8:
            return torch.from_numpy(a.copy()).to(dev)
        if a.dtype.name == "float8_e4m3fn":     # ml_dtypes: its bytes, as e4m3
            return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn).to(dev)
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        f32 = name.endswith("_scale") or name in STATE_KEYS
        return t.to(device=dev, dtype=torch.float32 if f32 else torch.bfloat16)

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
def _dense_layer_cache(cfg: ModelConfig, kind: str, batch: int, cache_len: int, dev
                       ) -> Dict[str, torch.Tensor]:
    if kind in RECURRENT_KINDS:
        H = cfg.n_heads
        zeros = lambda *shape: torch.zeros((batch,) + shape, dtype=torch.float32, device=dev)
        if kind == "rglru":
            return {"h": zeros(cfg.rnn_width), "conv": zeros(3, cfg.rnn_width)}
        if kind == "mlstm":
            hd = int(cfg.d_model * cfg.mlstm_proj_factor) // H
            return {"C": zeros(H, hd, hd), "n": zeros(H, hd), "m": zeros(H)}
        hd = cfg.d_model // H
        return {name: zeros(H, hd) for name in ("c", "n", "m", "h")}
    S = min(cache_len, cfg.window) if kind == "win" else cache_len
    shape = (batch, cfg.n_kv_heads, S, cfg.head_dim)
    dt = KV_STORAGE[cfg.kv_cache_dtype]
    lc = {"k": torch.zeros(shape, dtype=dt, device=dev),
          "v": torch.zeros(shape, dtype=dt, device=dev)}
    if kind == "xattn":
        xshape = (batch, cfg.n_kv_heads, cfg.cross_kv_len, cfg.head_dim)
        lc["xk"] = torch.zeros(xshape, dtype=dt, device=dev)
        lc["xv"] = torch.zeros(xshape, dtype=dt, device=dev)
    return lc


def init_cache(
    cfg: ModelConfig, batch: int, cache_len: int, device: DeviceLike = "cuda"
) -> List[Dict[str, torch.Tensor]]:
    """Dense decode state (port of ``repro/models/transformer.py:162-217``):
    per layer K and V rows ``(batch, H_kv, S, head_dim)`` in the storage of
    ``kv_cache_dtype`` (bf16; e4m3 for ``"f8"``: :data:`KV_STORAGE`), one row per
    slot, zero-filled -- ``S`` is ``cache_len``, or ``min(cache_len,
    window)`` for a ``win`` layer's ring; an ``xattn`` layer adds
    ``"xk"``/``"xv"`` rows of ``cross_kv_len``; a recurrent layer holds its
    zero float32 states, one row per slot."""
    check_supported(cfg)
    dev = resolve_device(device)
    return [_dense_layer_cache(cfg, kind, batch, cache_len, dev) for kind in layer_kinds(cfg)]


def init_paged_cache(
    cfg: ModelConfig, num_pages: int, page_size: int, device: DeviceLike = "cuda",
    batch: int = 0, cache_len: int = 0,
) -> List[Dict[str, torch.Tensor]]:
    """Paged decode state (reference ``repro/models/transformer.py:219-
    283``): each ``attn`` layer holds K and V page pools ``(num_pages, H_kv,
    page_size, head_dim)``, bf16 -- or with ``kv_cache_dtype == "int8"``
    int8, with ``"k_scale"``/``"v_scale"`` leaves ``(num_pages, H_kv)``
    float32, one symmetric scale per (page, kv head), 0 for an untouched
    page (all writes then go through
    :func:`repro_torch.core.attention.paged_scatter_tokens_quant`). One
    allocator's page ids index every layer's pools. Page 0 is the null
    page. ``win``, ``xattn`` and recurrent layers keep the dense per-slot
    rows of :func:`init_cache` for ``batch`` slots of ``cache_len`` (bf16
    K/V even beside int8 pools: only the shared pools quantize). With
    ``"f8"`` every pool and dense row is ``float8_e4m3fn``; ``"f16"`` and
    ``"f32"`` are bf16, as in the reference."""
    check_supported(cfg)
    dev = resolve_device(device)
    kinds = layer_kinds(cfg)
    if any(kind != "attn" for kind in kinds) and (batch < 1 or cache_len < 1):
        raise ValueError(f"{cfg.name}: its non-'attn' layers keep dense per-slot caches; "
                         "pass batch and cache_len")
    shape = (num_pages, cfg.n_kv_heads, page_size, cfg.head_dim)
    quant = cfg.kv_cache_dtype == "int8"
    dtype = torch.int8 if quant else KV_STORAGE[cfg.kv_cache_dtype]
    cache = []
    for kind in kinds:
        if kind != "attn":
            cache.append(_dense_layer_cache(cfg, kind, batch, cache_len, dev))
            continue
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
@dataclass(frozen=True)
class LayerShards:
    """What a rank computes of one layer under tensor parallelism (plan
    ``heads``; :meth:`repro_torch.distributed.tensor_parallel.
    TensorParallel.layer` reads it from the leaves' specs): the reduction
    after each row-parallel product -- the self and cross attention's
    ``wo``, the FFN's ``wd``, the MoE's routed combine (EP or expert-TP) and
    its shared expert's ``wd`` -- None where the leaf is whole; the first
    expert held under EP; ``rows``, the context whose
    ``gather_rows``/``own_rows`` give the MoE the global batch where the
    batch splits over the data axes; and ``enter``, the column-parallel
    input op (identity forward, the cotangent summed over ``model``
    backward), applied wherever a replicated tensor meets a split block --
    where the block's reduction is set. :data:`WHOLE`: one rank holds it
    all."""

    attn: Optional[Callable] = None
    xattn: Optional[Callable] = None
    ffn: Optional[Callable] = None
    moe: Optional[Callable] = None
    expert_offset: int = 0
    shared: Optional[Callable] = None
    rows: Optional[object] = None
    enter: Optional[Callable] = None


WHOLE = LayerShards()


def _shards(tp, i: int, lp) -> LayerShards:
    return WHOLE if tp is None else tp.layer(i, lp)


def _entered(x: torch.Tensor, reduce: Optional[Callable], sh: LayerShards) -> torch.Tensor:
    """``x`` through ``sh.enter`` where the block it feeds is split (its
    reduction ``reduce`` is set), else ``x``."""
    return x if reduce is None or sh.enter is None else sh.enter(x)


def _heads(p, cfg: ModelConfig) -> Dict[str, int]:
    """An attention block's head counts, read from its weights' blocks:
    the config's, or this rank's under tensor parallelism."""
    return dict(n_heads=p["wq"].shape[-1] // cfg.head_dim, n_kv=p["wk"].shape[-1] // cfg.head_dim,
                head_dim=cfg.head_dim)


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor, offset=0, tp=None) -> torch.Tensor:
    """Token embedding: the bf16 row times sqrt(d_model) in float32 (the
    reference multiplies by a numpy float64 scalar, which promotes to
    float32), so the residual stream is float32. Without rotary positions
    the float32 sinusoids of positions ``offset + [0, L)`` are added
    (``repro/models/transformer.py:376-383``); ``offset`` is an int or a
    one-element tensor on the tokens' device (a decode step's
    ``max(ctx_lens)``, read on the device). With ``tp`` doing the lookup
    (``tp.looks_up()``: ``embed`` split by vocabulary, or the training
    context's blocks), ``tp.embed`` (exact); the positions are whole on
    every rank."""
    scale = float(np.float32(np.sqrt(cfg.d_model)))
    if tp is not None and tp.looks_up():
        x = tp.embed(params["embed"], tokens, scale)
    else:
        x = params["embed"][tokens.long()].to(torch.bfloat16).float()
        x = x * scale
    if cfg.rope_theta is None:
        pos = torch.arange(tokens.shape[-1], device=x.device)
        pos = pos + (offset.reshape(1).to(x.device) if torch.is_tensor(offset) else int(offset))
        x = x + sinusoidal_pos(pos, cfg.d_model)
    return x


def _unembed(params, cfg: ModelConfig, x: torch.Tensor, tp=None) -> torch.Tensor:
    """The logits, float32: with ``tp`` and the unembedding split by
    vocabulary (``embed``'s rows when tied), each rank's block of columns,
    gathered over ``model``."""
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    if tp is not None and (tp.split("embed", 0) if cfg.tie_embeddings
                           else tp.split("unembed", 1)):
        return tp.logits(x, w)
    return (x.to(torch.bfloat16) @ w.to(torch.bfloat16)).float()


def moe_part(p, xn: torch.Tensor, cfg: ModelConfig, sh: LayerShards = WHOLE) -> torch.Tensor:
    """A layer's MoE (``p``: its ``moe`` leaves) on the normed rows ``xn``.
    Under tensor parallelism (``sh``) with the batch split over the data
    axes, every data rank's rows are gathered first, so the routing, the
    capacity and the drops are the global batch's (the reference's
    ``moe_forward`` sees the global batch), and this rank keeps its rows of
    the output; the experts are this rank's (EP) or its block of each
    expert's hidden width (expert-TP), summed by ``sh.moe``."""
    if sh.rows is not None:
        xn = sh.rows.gather_rows(xn)
    out, _ = moe_forward(p, xn, cfg.moe, expert_offset=sh.expert_offset, reduce=sh.moe,
                         shared_reduce=sh.shared, enter=sh.enter)
    return out if sh.rows is None else sh.rows.own_rows(out)


def _ffn_part(p, x, cfg: ModelConfig, sh: LayerShards = WHOLE):
    """The layer's FFN on the normed residual, added to it: the MoE where
    the layer has one, the ``ffn_kind`` FFN, or nothing (``d_ff`` 0). Under
    tensor parallelism (``sh``) the row-parallel sums, and the MoE routes
    the global batch (:func:`moe_part`)."""
    if "moe" in p:
        return x + moe_part(p["moe"], rms_norm(x, p["ln2"], cfg.norm_eps), cfg, sh)
    if "ffn" in p:
        xn = _entered(rms_norm(x, p["ln2"], cfg.norm_eps), sh.ffn, sh)
        return x + ffn_forward(p["ffn"], xn, kind=cfg.ffn_kind, reduce=sh.ffn)
    return x


def _plain_attn(cfg: ModelConfig, L: int) -> Callable:
    """What the reference computes for a whole sequence's self attention
    (``repro/models/transformer.py:287-322``): :func:`mha_prefill_ref`, or
    the q-chunked :func:`mha_prefill_chunked` above ``attn_q_chunk``. Plain
    and differentiable: the training path's attention on every device."""
    if cfg.attn_q_chunk and L > cfg.attn_q_chunk:
        return functools.partial(mha_prefill_chunked, q_chunk=cfg.attn_q_chunk)
    return mha_prefill_ref


def _prefill_attn(cfg: ModelConfig, L: int, device: torch.device) -> Callable:
    """The whole-prompt self-attention: K7 (:func:`flash_prefill`) on CUDA
    at every length; on the CPU :func:`_plain_attn`."""
    return flash_prefill if device.type == "cuda" else _plain_attn(cfg, L)


def _attn_full(p, x, cfg: ModelConfig, kind: str, img_emb, attn: Callable,
               cross: Optional[Callable] = None, sh: LayerShards = WHOLE):
    """A layer's attention part over the whole prompt
    (``repro/models/transformer.py:287-339``): self attention (``win``:
    sliding-window), and for ``xattn`` the gated cross attention to
    ``img_emb`` through ``cross`` -- by default K7 non-causal on CUDA and
    the plain oracle on the CPU (the reference runs ``attn_forward``).
    Under tensor parallelism over the rank's heads, ``wo`` summed by
    ``sh``. Returns ``(x, (k, v), (xk, xv) or None)``."""
    xn = _entered(rms_norm(x, p["ln1"], cfg.norm_eps), sh.attn, sh)
    h, kv = attn_forward(p["attn"], xn, **_heads(p["attn"], cfg),
                         rope_theta=cfg.rope_theta,
                         window=cfg.window if kind == "win" else None, attn=attn, reduce=sh.attn)
    x = x + h
    xkv = None
    if kind == "xattn":
        if cross is None:
            cross = flash_prefill if x.device.type == "cuda" else mha_prefill_ref
        hx, xkv = attn_forward(p["xattn"], _entered(rms_norm(x, p["ln_x"], cfg.norm_eps),
                                                     sh.xattn, sh),
                               **_heads(p["xattn"], cfg), rope_theta=None, causal=False,
                               kv_states=img_emb, attn=cross, reduce=sh.xattn)
        x = x + torch.tanh(p["xgate"]) * hx
    return x, kv, xkv


def ring_from_prefill(kh: torch.Tensor, vh: torch.Tensor, S: int, true_len=None):
    """A sliding-window layer's ring ``(B, H, S, hd)`` from its prefill K/V
    ``(B, H, L, hd)`` (``repro/models/transformer.py:590-618``): position
    ``pos`` lands in row ``pos % S`` if it is one of the last ``S`` real
    positions ``[n - S, n)``, ``n`` the prompt length -- ``L``, or
    ``true_len`` for a bucketed prompt, whose pad positions never displace
    real K/V; other rows stay zero. ``true_len`` may be an int or a
    one-element tensor on the device; every shape is fixed."""
    B, H, L, hd = kh.shape
    pos = torch.arange(L, device=kh.device)
    if true_len is None:
        n = L
    elif torch.is_tensor(true_len):
        n = true_len.reshape(1).to(kh.device)
    else:
        n = int(true_len)
    valid = (pos < n) & (pos >= n - S)
    slots = torch.where(valid, pos % S, torch.full_like(pos, S))   # S: a row dropped after
    out = []
    for t in (kh, vh):
        ring = torch.zeros(B, H, S + 1, hd, dtype=t.dtype, device=t.device)
        ring[:, :, slots] = t
        out.append(ring[:, :, :S])
    return out[0], out[1]


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, cache_len: int,
            true_len=None, write_kv: Optional[Callable] = None, img_emb=None, tp=None):
    """Forward over the prompt ``tokens (B, L)``.

    Returns ``(last_logits (B, V) float32, cache, cur_len)`` where
    ``cache[i]`` holds layer ``i``'s bf16 K/V as :func:`init_cache` lays
    them out for ``cache_len``: an ``attn`` (or ``xattn``) layer's ``(B,
    Hkv, cache_len, hd)``, zero past ``L``; a ``win`` layer's ring
    (:func:`ring_from_prefill`); an ``xattn`` layer's ``"xk"``/``"xv"``,
    the K/V of ``img_emb (B, cross_kv_len, D)``. With ``true_len`` (the
    reference's bucketed prefill) ``tokens`` is a prompt padded to a
    bucket: the logits are those of position ``true_len - 1`` and
    ``cur_len`` is ``true_len``; an ``attn`` layer's rows past it hold the
    pad tokens' K/V, as the reference's do, and a ring takes only real
    positions. ``true_len`` may be an int or a one-element tensor on the
    tokens' device (a captured admission reads it at run time). With
    ``write_kv`` each layer's cache entry goes to ``write_kv(layer, entry)``
    as soon as the layer has run -- an ``attn`` layer's K/V unpadded, ``(B,
    Hkv, L, hd)`` -- and ``cache`` is None: only one layer's K/V live at a
    time, never ``cache_len`` rows of every layer.

    The self attention is causal with ``q_offset`` 0: on CUDA tensors it
    runs the Hopper kernel K7 (:func:`flash_prefill`) at every prompt length
    -- the same function, computed by the kernel the reference has for it
    (``repro/kernels/flash_prefill.py:24``; its q-chunked path,
    ``transformer.py:287-322``, is what the reference's config calls the
    FlashAttention-2 baseline, ``transformer.py:72-74``). On CPU tensors it
    computes what the reference computes: :func:`mha_prefill_ref`, or the
    q-chunked :func:`mha_prefill_chunked` for prompts longer than
    ``attn_q_chunk`` (:func:`_prefill_attn` picks).

    A recurrent layer (:mod:`.recurrent`) runs its whole-sequence form and
    its entry is its state after the prompt (``repro/models/transformer.py:
    541-561``). The reference scans pad tokens into that state, so it
    refuses ``true_len`` for recurrent kinds, and so does the port
    (``ValueError``, "bucketed prefill"): their prompts are prefilled at
    their exact length.

    With ``tp`` (:func:`repro_torch.distributed.tensor_parallel.
    tensor_parallel`, plan ``heads``) ``params`` are this rank's blocks,
    ``tokens`` (and ``img_emb``) its rows, and every layer runs over its
    heads and hidden block with the reductions of :class:`LayerShards`;
    the cache is this rank's block (its rows, its KV heads) and the logits
    its rows' whole vocabulary, the same bits on every rank of a ``model``
    group.
    """
    check_supported(cfg)
    B, L = tokens.shape
    if true_len is not None:
        bad = sorted(set(layer_kinds(cfg)) - set(ATTN_KINDS))
        if bad:
            raise ValueError(f"bucketed prefill (true_len) unsupported for recurrent stage kinds "
                             f"{bad}: pad tokens would corrupt the carried state")
    if L > cache_len and write_kv is None:
        raise ValueError(f"prompt of {L} tokens exceeds cache_len {cache_len}")
    attn = _prefill_attn(cfg, L, tokens.device)
    x = _embed(params, cfg, tokens, tp=tp)
    cache = None if write_kv is not None else []
    for i, (lp, kind) in enumerate(zip(params["layers"], layer_kinds(cfg))):
        sh = _shards(tp, i, lp)
        if kind in RECURRENT_KINDS:
            h, entry = _recurrent_prefill(lp, rms_norm(x, lp["ln1"], cfg.norm_eps), kind, cfg)
            x = x + h
        else:
            x, (kh, vh), xkv = _attn_full(lp, x, cfg, kind, img_emb, attn, sh=sh)
            kh, vh = kh.to(torch.bfloat16), vh.to(torch.bfloat16)
            if kind == "win":
                kh, vh = ring_from_prefill(kh, vh, min(cache_len, cfg.window), true_len)
            elif write_kv is None:
                pad = (0, 0, 0, cache_len - L)
                kh, vh = torch.nn.functional.pad(kh, pad), torch.nn.functional.pad(vh, pad)
            entry = {"k": kh, "v": vh}
            if xkv is not None:
                entry["xk"], entry["xv"] = xkv[0].to(torch.bfloat16), xkv[1].to(torch.bfloat16)
        x = _ffn_part(lp, x, cfg, sh)
        if write_kv is not None:
            write_kv(i, entry)
        else:
            cache.append(entry)
    if torch.is_tensor(true_len):
        n = true_len.reshape(1)
        x_last = x.index_select(1, (n - 1).long())[:, 0]
    else:
        n = L if true_len is None else int(true_len)
        x_last = x[:, n - 1]
    x_last = rms_norm(x_last, params["final_norm"], cfg.norm_eps)
    return _unembed(params, cfg, x_last, tp), cache, n


def _recurrent_prefill(p, xn: torch.Tensor, kind: str, cfg: ModelConfig):
    """A recurrent layer's block over the normed prompt: its output and its
    state entry after the prompt, float32."""
    if kind == "rglru":
        h, (hT, conv) = rec.rglru_forward(p["rec"], xn)
        return h, {"h": hT, "conv": conv.float()}
    if kind == "mlstm":
        h, (C, n, m) = rec.mlstm_block_forward(p["rec"], xn, cfg.n_heads)
        return h, {"C": C, "n": n, "m": m}
    h, (c, n, m, hs) = rec.slstm_forward(p["rec"], xn, cfg.n_heads)
    return h, {"c": c, "n": n, "m": m, "h": hs}


def _recurrent_step(p, lc: Dict[str, torch.Tensor], xn: torch.Tensor, kind: str,
                    cfg: ModelConfig) -> torch.Tensor:
    """A recurrent layer's decode step over every slot (``repro/models/
    transformer.py:878-899``): its output, its state advanced *in place*
    (``copy_`` into the cache's tensors, so a captured step's replay
    advances the real state)."""
    if kind == "rglru":
        h, hn, conv = rec.rglru_step(p["rec"], xn, lc["h"], lc["conv"])
        new = {"h": hn, "conv": conv}
    elif kind == "mlstm":
        h, (C, n, m) = rec.mlstm_block_step(p["rec"], xn, cfg.n_heads,
                                            (lc["C"], lc["n"], lc["m"]))
        new = {"C": C, "n": n, "m": m}
    else:
        h, (c, n, m, hs) = rec.slstm_step(p["rec"], xn, cfg.n_heads,
                                          (lc["c"], lc["n"], lc["m"], lc["h"]))
        new = {"c": c, "n": n, "m": m, "h": hs}
    for name, t in new.items():
        lc[name].copy_(t)
    return h


def decode_step(
    params,
    cfg: ModelConfig,
    cache,
    tokens: torch.Tensor,           # (B, 1)
    attn_fn: Optional[Callable] = None,
    ctx_lens: Optional[torch.Tensor] = None,   # (B,) per-slot lengths
    page_tbl: Optional[torch.Tensor] = None,   # (B, pages_per_slot)
    cur_len=None,
    seq_shard: Optional[Tuple[int, int]] = None,
    tp=None,
):
    """One decode step, updating the cache in place. Returns ``(logits (B,
    V) float32, cache)``. With ``page_tbl`` the ``attn`` layers' caches are
    page pools (:func:`init_paged_cache`) and ``attn_fn`` receives the
    pools; without it they are dense (:func:`init_cache`, the branch of
    ``repro/models/transformer.py:843-857``) and ``attn_fn`` receives the
    per-slot K/V. Either way ``attn_fn`` also gets the visible lengths.
    ``win`` layers write and read their dense rings through the plain
    oracle, as the reference's engine does (it passes no ``win_attn_fn``);
    ``xattn`` layers add the gated cross attention's
    read of their cached image K/V (:func:`cross_attn_decode`). Sinusoidal
    positions (``rope_theta`` None) are those of ``cur_len`` for every slot
    -- an int or a one-element device tensor; by default ``max(ctx_lens)``,
    what the reference's engine passes. A recurrent layer advances every
    slot's state, masked and idle slots' too, as the reference's step does
    (:func:`_recurrent_step`). With ``seq_shard = (offset, S_full)`` the
    dense caches of the ``attn`` and ``xattn`` layers are this rank's
    blocks of caches split along the sequence (sequence-parallel decode,
    :mod:`repro_torch.launch.serve_step`): each token's K/V lands only in
    the block that holds its position, and ``attn_fn`` merges across the
    blocks (:func:`attn_decode`); ``win`` rings stay whole. With ``tp``
    (plan ``heads``, dense caches) the parameters, caches and rows are this
    rank's blocks, as in :func:`prefill`: the ``attn``, ``win`` and
    ``xattn`` caches hold its KV heads, and it returns its rows' logits."""
    check_supported(cfg)
    if ctx_lens is None:
        raise ValueError("decode_step needs the per-slot lengths ctx_lens")
    if seq_shard is not None and page_tbl is not None:
        raise ValueError("sequence shards are blocks of dense caches, not page pools")
    if cur_len is None and cfg.rope_theta is None:
        cur_len = ctx_lens.max()
    if tp is not None and page_tbl is not None:
        raise ValueError("tensor-parallel decode runs on dense caches, not page pools")
    x = _embed(params, cfg, tokens, offset=cur_len if cur_len is not None else 0, tp=tp)
    writer = None                   # the null-page writes' rows, once for every paged layer
    for i, (lp, lc, kind) in enumerate(zip(params["layers"], cache, layer_kinds(cfg))):
        sh = _shards(tp, i, lp)
        xn = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if kind in RECURRENT_KINDS:
            x = _ffn_part(lp, x + _recurrent_step(lp, lc, xn, kind, cfg), cfg, sh)
            continue
        kw = dict(_heads(lp["attn"], cfg), rope_theta=cfg.rope_theta, ctx_lens=ctx_lens)
        if page_tbl is not None and kind == "attn":
            if writer is None:
                writer = decode_writer_rows(page_tbl, ctx_lens, lc["k"].shape[2])
            h, lc["k"], lc["v"] = attn_decode_paged(lp["attn"], xn, lc["k"], lc["v"], page_tbl,
                                                    attn_fn=attn_fn, writer=writer, **kw,
                                                    **_scale_kw(cfg, lc))
        else:
            win = kind == "win"
            h, lc["k"], lc["v"] = attn_decode(lp["attn"], xn, lc["k"], lc["v"],
                                              window=cfg.window if win else None,
                                              attn_fn=None if win else attn_fn,
                                              seq_shard=None if win else seq_shard,
                                              reduce=sh.attn, **kw)
        x = x + h
        if kind == "xattn":
            hx = cross_attn_decode(lp["xattn"], rms_norm(x, lp["ln_x"], cfg.norm_eps),
                                   lc["xk"], lc["xv"],
                                   n_heads=_heads(lp["xattn"], cfg)["n_heads"],
                                   head_dim=cfg.head_dim, reduce=sh.xattn)
            x = x + torch.tanh(lp["xgate"]) * hx
        x = _ffn_part(lp, x, cfg, sh)
    x = rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
    return _unembed(params, cfg, x, tp), cache


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
    pool = cache[0]["k"]
    writer = chunk_writer_rows(page_tbls, offs, lens, tokens.shape[1], pool.shape[2], pool.device)
    for lp, lc in zip(params["layers"], cache):
        h, lc["k"], lc["v"] = attn_prefill_chunk_paged(
            lp["attn"], rms_norm(x, lp["ln1"], cfg.norm_eps),
            lc["k"], lc["v"], page_tbls, offs, lens,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta, attn_fn=attn_fn, writer=writer, **_scale_kw(cfg, lc),
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


# ------------------------------------------------------------------ training
def _ffn_train(p, x, cfg: ModelConfig, sh: LayerShards = WHOLE):
    """:func:`_ffn_part` with the MoE's load-balancing loss (zero for a
    layer without a MoE): ``(x, aux)``. Under tensor parallelism with the
    batch split (``sh.rows``) the MoE routes the global batch, so every
    rank of the batch's group computes the same aux loss of the global
    routing."""
    if "moe" in p:
        xn = rms_norm(x, p["ln2"], cfg.norm_eps)
        if sh.rows is not None:
            xn = sh.rows.gather_rows(xn)
        out, aux = moe_forward(p["moe"], xn, cfg.moe, aux_loss=True,
                               expert_offset=sh.expert_offset, reduce=sh.moe,
                               shared_reduce=sh.shared, enter=sh.enter)
        return x + (out if sh.rows is None else sh.rows.own_rows(out)), aux
    return _ffn_part(p, x, cfg, sh), torch.zeros((), dtype=torch.float32, device=x.device)


def _layer_forward(p, x: torch.Tensor, kind: str, cfg: ModelConfig, img_emb,
                   attn: Callable, sh: LayerShards = WHOLE):
    """Train-path layer (``repro/models/transformer.py:354-375``): the whole
    sequence through the layer's block -- self attention by ``attn``, cross
    attention by the plain non-causal oracle, a recurrent kind's
    whole-sequence form -- and its FFN, over this rank's heads and hidden
    block under tensor parallelism (``sh``). Returns ``(x, aux)``."""
    if kind in ATTN_KINDS:
        x, _, _ = _attn_full(p, x, cfg, kind, img_emb, attn, cross=mha_prefill_ref, sh=sh)
        return _ffn_train(p, x, cfg, sh)
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "rglru":
        h, _ = rec.rglru_forward(p["rec"], xn)
        return _ffn_train(p, x + h, cfg, sh)
    if kind == "mlstm":
        h, _ = rec.mlstm_block_forward(p["rec"], xn, cfg.n_heads)
    else:
        h, _ = rec.slstm_forward(p["rec"], xn, cfg.n_heads)
    return x + h, torch.zeros((), dtype=torch.float32, device=x.device)


def forward_hidden(params, cfg: ModelConfig, tokens: torch.Tensor, img_emb=None, tp=None):
    """Backbone forward (``repro/models/transformer.py:394-425``) -> (hidden
    ``(B, L, D)`` float32 after the final norm, the summed MoE aux loss).
    Stage by stage, repeat by repeat: each repeat of a stage's pattern (a
    unit) is checkpointed where ``cfg.remat`` is set, as
    ``jax.checkpoint(unit_fn)``.

    With ``tp``, the training context (:class:`repro_torch.distributed.
    fsdp.FSDP`), ``params`` are this rank's float32 blocks under the train
    specs and ``tokens`` (and ``img_emb``) its rows: each unit gathers its
    layers' serve-layout blocks (``tp.use_layer``) inside its checkpoint, so
    the gathered weights live only while the unit runs and are gathered
    again when its backward recomputes it, and every layer runs over this
    rank's heads and hidden block with the collectives of
    :class:`LayerShards`."""
    x = _embed(params, cfg, tokens, tp=tp)
    attn = _plain_attn(cfg, tokens.shape[1])
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    i = 0
    for pattern, reps in cfg.stages:
        for _ in range(reps):
            unit = params["layers"][i:i + len(pattern)]

            def unit_fn(x, unit=unit, pattern=pattern, first=i):
                aux = torch.zeros((), dtype=torch.float32, device=x.device)
                for j, (kind, lp) in enumerate(zip(pattern, unit)):
                    x = hint(x, "dp", None, None)
                    if tp is not None:
                        lp = tp.use_layer(first + j, lp)
                    x, a = _layer_forward(lp, x, kind, cfg, img_emb, attn,
                                          _shards(tp, first + j, lp))
                    aux = aux + a
                return hint(x, "dp", None, None), aux

            x, a = remat(unit_fn, x) if cfg.remat else unit_fn(x)
            aux_total = aux_total + a
            i += len(pattern)
    final = params["final_norm"] if tp is None else \
        tp.use_top(params, ("final_norm",))["final_norm"]
    return rms_norm(x, final, cfg.norm_eps), aux_total


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, img_emb=None):
    """Full forward -> (logits ``(B, L, V)`` float32, aux loss)."""
    x, aux = forward_hidden(params, cfg, tokens, img_emb)
    return _unembed(params, cfg, x), aux


def _chunk_ce(h_c: torch.Tensor, t_c: torch.Tensor, m_c: torch.Tensor, w: torch.Tensor,
              logits: Optional[Callable] = None):
    """Summed cross entropy of one chunk: bf16 logits widened to float32
    (``logits(h_c, w)`` where given: the vocabulary-parallel ones),
    ``logsumexp - logit of the target``, masked."""
    if logits is None:
        lg = (h_c.to(torch.bfloat16) @ w.to(torch.bfloat16)).float()
    else:
        lg = logits(h_c, w)
    true = lg.gather(-1, t_c.long()[..., None])[..., 0]
    return ((torch.logsumexp(lg, dim=-1) - true) * m_c[None, :]).sum()


class _SplitCE(torch.autograd.Function):
    """The chunked cross entropy under the training context ``tp``: the
    sum of :func:`_chunk_ce` over the chunks of ``K`` positions, with the
    unembedding (``embed``'s rows, transposed, where ``tied``) gathered from
    this rank's float32 block ``block`` once, as bf16 -- every chunk casts it
    to bf16, and a cast before the gather gives the same bits -- and
    ``logits`` the vocabulary-parallel ones where it is split. Backward: each
    chunk recomputed in turn, the last first, its bf16 gradient of the
    gathered leaf added in place to one float32 sum (the sum autograd forms
    over the chunks' casts, in its order), which ``tp.grad_bucket`` returns
    to the block. So one bf16 copy of the leaf and one float32 gradient live
    through the loss's backward, where remat over a float32 gather keeps the
    float32 copy, a bf16 cast and two float32 gradients."""

    @staticmethod
    def forward(ctx, tp, name, tied, logits, K, h_in, tgt, mask, block):
        w = tp.gather_bucket([name], [block], dtype=torch.bfloat16)[0]
        ctx.tp, ctx.name, ctx.tied, ctx.logits, ctx.K = tp, name, tied, logits, K
        ctx.save_for_backward(h_in, tgt, mask, w)
        ce_sum = torch.zeros((), dtype=torch.float32, device=h_in.device)
        for c in range(0, h_in.shape[1], K):
            ce_sum = ce_sum + _chunk_ce(h_in[:, c:c + K], tgt[:, c:c + K], mask[c:c + K],
                                        w.T if tied else w, logits)
        return ce_sum

    @staticmethod
    def backward(ctx, g):
        h_in, tgt, mask, w = ctx.saved_tensors
        K = ctx.K
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        dh = torch.empty_like(h_in)
        for c in reversed(range(0, h_in.shape[1], K)):
            with torch.enable_grad():
                hc, wc = h_in[:, c:c + K].detach().requires_grad_(), w.detach().requires_grad_()
                ce = _chunk_ce(hc, tgt[:, c:c + K], mask[c:c + K], wc.T if ctx.tied else wc,
                               ctx.logits)
                gh, gw = torch.autograd.grad(ce, (hc, wc), g)
            dh[:, c:c + K] = gh
            dw.add_(gw)
            del gh, gw
        dblock = ctx.tp.grad_bucket([ctx.name], [dw])[0]
        return None, None, None, None, None, dh, None, None, dblock


def loss_fn(params, cfg: ModelConfig, batch: Dict, tp=None):
    """Next-token cross entropy plus the MoE aux loss (``repro/models/
    transformer.py:434-486``). ``batch``: ``{"tokens": (B, L) int32}`` and,
    for ``xattn`` models, ``"img_emb" (B, cross_kv_len, D)``.

    The cross entropy runs over sequence chunks of ``cfg.loss_chunk`` rows
    (0: one chunk), the last padded and masked; each
    chunk's logits are rematerialised in the backward pass, so the full
    ``(B, L, V)`` float32 logits never exist. Returns ``(ce + aux, {"ce",
    "aux"})``, float32 scalars on the tokens' device.

    With ``tp`` (the training context, :func:`forward_hidden`) ``batch``
    holds this rank's rows, and the values are this rank's shares of the
    global ones, so that their sum over the batch's ranks is the global
    loss and each gradient is counted once: the cross entropy of its rows
    over the global ``B * (L - 1)`` targets (the logits vocabulary-parallel
    where the unembedding splits), and the aux loss of the global routing
    (the same on every rank of the batch's group) over the group's size."""
    tokens = batch["tokens"]
    hidden, aux = forward_hidden(params, cfg, tokens, batch.get("img_emb"), tp=tp)
    B, L, _ = hidden.shape
    Lm = L - 1
    K = cfg.loss_chunk if cfg.loss_chunk > 0 else Lm
    n_chunks = max(1, -(-Lm // K))
    pad = n_chunks * K - Lm
    h_in = torch.nn.functional.pad(hidden[:, :Lm], (0, 0, 0, pad))
    tgt = torch.nn.functional.pad(tokens[:, 1:], (0, pad))
    mask = (torch.arange(n_chunks * K, device=tokens.device) < Lm).float()
    rows = 1
    if tp is None:
        w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
        ce_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for c in range(0, n_chunks * K, K):
            ce_sum = ce_sum + remat(_chunk_ce, h_in[:, c:c + K], tgt[:, c:c + K], mask[c:c + K],
                                    w)
    else:
        name = "embed" if cfg.tie_embeddings else "unembed"
        split = tp.split("embed", 0) if cfg.tie_embeddings else tp.split("unembed", 1)
        ce_sum = _SplitCE.apply(tp, name, cfg.tie_embeddings, tp.logits if split else None, K,
                                h_in, tgt, mask, params[name])
        rows = tp.n_rows
    ce = ce_sum / (B * rows * Lm)
    if rows > 1:
        aux = aux / rows
    return ce + aux, {"ce": ce, "aux": aux}


def count_params(cfg: ModelConfig) -> int:
    """Analytic parameter count (``repro/models/transformer.py:943-978``)."""
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    Hq, Hkv, hd = cfg.spec_heads, cfg.n_kv_heads, cfg.head_dim
    total = V * D + (0 if cfg.tie_embeddings else D * V)
    if cfg.moe is not None:
        E, Fe = cfg.moe.num_experts, cfg.moe.d_ff_expert
        ffn = D * E + 3 * E * D * Fe + (3 * D * cfg.moe.d_ff_shared if cfg.moe.d_ff_shared else 0)
    else:
        ffn = (3 if cfg.ffn_kind == "swiglu" else 2) * D * F
    for kind in layer_kinds(cfg):
        if kind in ATTN_KINDS:
            p = (D * Hq * hd * 2 + D * Hkv * hd * 2) * (2 if kind == "xattn" else 1) + ffn
        elif kind == "rglru":
            W = cfg.rnn_width
            p = 2 * D * W + W * D + 2 * W * W + 5 * W + ffn
        elif kind == "mlstm":
            pd = int(D * cfg.mlstm_proj_factor)
            p = D * 2 * pd + 3 * pd * pd + pd * 2 * cfg.n_heads + pd * D
        else:
            hd_s = D // cfg.n_heads
            p = D * 4 * D + cfg.n_heads * hd_s * 4 * hd_s + D * D
        total += p
    return int(total)


def count_active_params(cfg: ModelConfig) -> int:
    """Parameters active per token (``repro/models/transformer.py:981-991``):
    a MoE model counts ``top_k`` of its routed experts in every layer."""
    if cfg.moe is None:
        return count_params(cfg)
    routed = 3 * cfg.d_model * cfg.moe.d_ff_expert
    return int(count_params(cfg) - cfg.n_layers * routed * (cfg.moe.num_experts - cfg.moe.top_k))
