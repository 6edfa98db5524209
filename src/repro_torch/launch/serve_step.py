"""The serve and prefill step factories (port of ``repro/launch/
serve_step.py``).

The global-attention layers read their caches through K2, LeanAttention's
fused stream-K decode (:func:`repro_torch.kernels.ops.lean_decode`, dense
form; its plain version on CPU tensors), on every plan:

* no mesh: the whole model on one device;
* plan ``heads`` (:func:`repro_torch.distributed.sharding.decode_plan`):
  tensor parallelism, as XLA derives it from the reference's specs. Each
  rank holds its blocks of the parameters (``param_specs(...,
  mode="serve")``), of the caches (``cache_specs``: its rows, its KV heads)
  and of the batch, and runs every layer over its heads and hidden block;
  the row-parallel, vocabulary-parallel and MoE collectives are
  :mod:`repro_torch.distributed.tensor_parallel`'s. K7 prefills and K2
  decodes the rank's heads, whole GQA groups;
* plans ``seq_all`` and ``seq_model``: the mesh-level sequence-parallel
  LeanAttention path. Each rank holds its block of the full-length KV
  caches, its partial by K2, the associative merge as collectives
  (:func:`repro_torch.core.distributed.sp_decode_attention`). That is the
  ``long_500k`` shape, where batch 1 leaves only the context to fill the
  mesh (the paper's §III-D). The weights stay whole on every rank (the
  reference splits them by its specs there too, which computes the same
  function); sliding-window layers keep their rings whole, as the
  reference passes them no ``attn_fn``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.distributed import sp_decode_attention
from repro_torch.core.leantile import ScheduleCache
from repro_torch.distributed.sharding import choose_layout
from repro_torch.distributed.tensor_parallel import tensor_parallel
from repro_torch.launch.mesh import axis_index, axis_size
from repro_torch.models import ModelConfig, decode_step, layer_kinds, prefill


def _tp(cfg: ModelConfig, mesh, plan: Optional[dict], layout: Optional[str]):
    """The tensor-parallel context of plan ``heads`` on a mesh, else None."""
    if mesh is None or plan is None or plan["seq_axes"]:
        return None
    return tensor_parallel(cfg, mesh, plan, layout or choose_layout(cfg))


def _k2_attn(ctx_host, schedules: ScheduleCache):
    """The global layers' decode attention: K2 over this rank's heads and
    rows, every row at ``ctx_host`` visible keys (host ints: K2's schedule
    is built on the host)."""
    from repro_torch.kernels import ops

    def attn_fn(q, k, v, ctx):
        workers = (torch.cuda.get_device_properties(q.device).multi_processor_count
                   if q.device.type == "cuda" else None)
        return ops.lean_decode(q, k, v, ctx_host, num_workers=workers, fused=True,
                               schedule_cache=schedules)

    return attn_fn


def make_serve_step(cfg: ModelConfig, mesh=None, plan: Optional[dict] = None,
                    layout: Optional[str] = None):
    """``serve_step(params, cache, tokens, cur_len, img_emb=None) ->
    (logits, cache)``: every row of ``tokens (B, 1)`` decodes at position
    ``cur_len`` (a host int) against ``cache`` (:func:`repro_torch.models.
    init_cache`'s layout), which it updates in place.

    ``mesh`` None (or no ``plan``): the whole model, its global layers
    through K2. With a mesh, ``plan`` from :func:`repro_torch.distributed.
    sharding.decode_plan` with the same ``layout`` (by default
    :func:`repro_torch.distributed.sharding.choose_layout`'s): this rank
    passes its own blocks -- its rows of ``tokens`` (the plan's
    ``batch_spec``) and its blocks of the caches (``cache_specs``), and
    under ``heads`` its blocks of the parameters (``param_specs(...,
    mode="serve")``, refused otherwise) -- and ``serve_step`` returns its
    rows' logits over the whole vocabulary, the same bits on every rank of
    a ``model`` (or sequence) group. An architecture with no global
    attention layer under a sequence plan runs the whole step on every rank
    (the recurrent ones' window rings and states stay whole). ``img_emb``
    is unused, as in the reference: a cross-attention layer reads its
    cached image K/V."""
    kinds = layer_kinds(cfg)
    # the first layer with a full-length cache: its block length is the shard's
    global_layer = next((i for i, kind in enumerate(kinds) if kind in ("attn", "xattn")), None)
    schedules = ScheduleCache()
    seq = mesh is not None and plan is not None and bool(plan["seq_axes"])
    if not seq or global_layer is None:     # a sequence plan with no cache to split: whole
        tp = _tp(cfg, mesh, plan, layout)

        def serve_step(params, cache, tokens, cur_len, img_emb=None):
            if tp is not None:
                tp.check(params)
            cur = int(cur_len)
            ctx = torch.full((tokens.shape[0],), cur, dtype=torch.int32, device=tokens.device)
            attn_fn = None
            if global_layer is not None:
                S = cache[global_layer]["k"].shape[2]
                attn_fn = _k2_attn([min(cur + 1, S)] * tokens.shape[0], schedules)
            return decode_step(params, cfg, cache, tokens, attn_fn=attn_fn, ctx_lens=ctx,
                               cur_len=cur, tp=tp)

        return serve_step

    seq_axes = tuple(plan["seq_axes"])
    batch_spec = plan["batch_spec"]
    b_axis = (
        batch_spec if isinstance(batch_spec, str) else
        ("data" if batch_spec and "data" in batch_spec else None)
    )
    n_seq, seq_idx = axis_size(mesh, seq_axes), axis_index(mesh, seq_axes)

    def serve_step(params, cache, tokens, cur_len, img_emb=None):
        cur, B = int(cur_len), tokens.shape[0]
        block = cache[global_layer]["k"].shape[2]
        full = block * n_seq
        ctx_host = [min(cur + 1, full)] * B

        def attn_fn(q, k, v, ctx):
            return sp_decode_attention(q, k, v, mesh, seq_axis=seq_axes, head_axis="model",
                                       batch_axis=b_axis, ctx_len=ctx_host,
                                       schedule_cache=schedules)

        ctx = torch.full((B,), cur, dtype=torch.int32, device=tokens.device)
        return decode_step(params, cfg, cache, tokens, attn_fn=attn_fn, ctx_lens=ctx,
                           cur_len=cur, seq_shard=(seq_idx * block, full))

    return serve_step


def make_prefill_step(cfg: ModelConfig, cache_len: int, mesh=None,
                      plan: Optional[dict] = None, layout: Optional[str] = None):
    """``prefill_step(params, tokens, img_emb=None) -> (logits, cache,
    cur_len)``: :func:`repro_torch.models.prefill` into a cache of
    ``cache_len`` positions, its self attention K7 on CUDA. Under plan
    ``heads`` on a mesh (``plan`` and ``layout`` as for
    :func:`make_serve_step`) this rank passes its parameter blocks, its rows
    of ``tokens`` and of ``img_emb``, and gets its rows' logits and its
    block of the cache (``cache_specs``: its rows, its KV heads). Under a
    sequence plan the prefill is whole; cut its cache with
    ``cache_specs``."""
    tp = _tp(cfg, mesh, plan, layout)

    def prefill_step(params, tokens, img_emb=None):
        if tp is not None:
            tp.check(params)
        return prefill(params, cfg, tokens, cache_len=cache_len, img_emb=img_emb, tp=tp)

    return prefill_step
