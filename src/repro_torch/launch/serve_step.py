"""The serve step factory: one decode token against the KV caches (port of
``repro/launch/serve_step.py``).

With a mesh and a sequence plan (:func:`repro_torch.distributed.sharding.
decode_plan`'s ``seq_all`` or ``seq_model``), the global-attention layers go
through the mesh-level sequence-parallel LeanAttention path: each rank's
block of the full-length KV caches (cut by :func:`repro_torch.distributed.
sharding.cache_specs`), its partial by K2, the associative merge as
collectives (:func:`repro_torch.core.distributed.sp_decode_attention`). That
is the ``long_500k`` shape, where batch 1 leaves only the context to fill
the mesh (the paper's §III-D). Sliding-window layers keep their rings whole
on every rank, as the reference passes them no ``attn_fn``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.distributed import sp_decode_attention
from repro_torch.core.leantile import ScheduleCache
from repro_torch.launch.mesh import axis_index, axis_size, mesh_axes
from repro_torch.models import ModelConfig, decode_step, layer_kinds, prefill


def make_serve_step(cfg: ModelConfig, mesh=None, plan: Optional[dict] = None):
    """``serve_step(params, cache, tokens, cur_len, img_emb=None) ->
    (logits, cache)``: every row of ``tokens (B, 1)`` decodes at position
    ``cur_len`` (a host int) against ``cache`` (:func:`repro_torch.models.
    init_cache`'s layout), which it updates in place.

    ``mesh`` None (or no ``plan``): the plain :func:`decode_step`, the
    reference's path on one device. Plans ``seq_all`` and ``seq_model``
    (``plan`` from :func:`repro_torch.distributed.sharding.decode_plan`):
    this rank passes its own blocks -- its rows of ``tokens`` and of the
    caches, the batch split over the ``data`` axis under ``seq_model`` --
    and the global layers' caches are its block of the sequence;
    ``serve_step`` returns its rows' logits, and every rank of a sequence
    group computes the same bits. Plan ``heads`` on more than one rank is
    the reference's tensor-parallel layout, which XLA derives from the
    parameters' specs; the port has no tensor-parallel execution yet
    (``NotImplementedError``). An architecture with no global attention
    layer (the recurrent ones' window rings and states stay whole) runs
    the plain step on every rank. ``img_emb`` is unused, as in the
    reference: a cross-attention layer reads its cached image K/V."""
    kinds = layer_kinds(cfg)
    # the first layer with a full-length cache: its block length is the shard's
    global_layer = next((i for i, kind in enumerate(kinds) if kind in ("attn", "xattn")), None)
    sp = mesh is not None and plan is not None
    if sp and not plan["seq_axes"]:
        if axis_size(mesh, tuple(mesh_axes(mesh))) > 1:
            raise NotImplementedError(
                "plan 'heads' on a mesh of more than one rank needs tensor-parallel "
                "execution of the parameters (ROADMAP item 16, its tensor-parallel half)")
        sp = False
    if not sp or global_layer is None:      # no cache to split: every rank runs it whole
        def serve_step(params, cache, tokens, cur_len, img_emb=None):
            ctx = torch.full((tokens.shape[0],), int(cur_len), dtype=torch.int32,
                             device=tokens.device)
            return decode_step(params, cfg, cache, tokens, ctx_lens=ctx, cur_len=int(cur_len))

        return serve_step

    seq_axes = tuple(plan["seq_axes"])
    batch_spec = plan["batch_spec"]
    b_axis = (
        batch_spec if isinstance(batch_spec, str) else
        ("data" if batch_spec and "data" in batch_spec else None)
    )
    n_seq, seq_idx = axis_size(mesh, seq_axes), axis_index(mesh, seq_axes)
    schedules = ScheduleCache()

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


def make_prefill_step(cfg: ModelConfig, cache_len: int):
    """``prefill_step(params, tokens, img_emb=None) -> (logits, cache,
    cur_len)``: :func:`repro_torch.models.prefill` into a cache of
    ``cache_len`` positions."""

    def prefill_step(params, tokens, img_emb=None):
        return prefill(params, cfg, tokens, cache_len=cache_len, img_emb=img_emb)

    return prefill_step
