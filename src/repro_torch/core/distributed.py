"""Distributed (mesh-level) LeanAttention: sequence-parallel decode (port
of ``repro/core/distributed.py``).

The paper's multi-GPU story (§III-D, Fig. 9) shards attention across
devices and combines the partial outputs with the associative re-scaling
reduction:

  * the KV cache is split along the *sequence* over one or more mesh axes
    (each rank owns an equal, contiguous range of positions: the stream-K
    partition at device granularity),
  * every rank computes a partial ``(o, m, l)`` over its local chunk -- on
    the card with its own stream-K decode, K2
    (:func:`repro_torch.kernels.ops.lean_decode`, dense form): stream-K
    inside the device, the merge across devices,
  * the merge runs as collectives: one ``all_reduce(MAX)`` of ``m``, then
    one ``all_reduce(SUM)`` of the re-scaled ``l`` and ``o`` together
    (:func:`lean_merge_collective`).

The reference expresses this with ``shard_map`` over global arrays; here
each rank runs :func:`sp_decode_attention` on its own shards, as the
reference's per-device ``local`` does, and :func:`sp_specs` with
:func:`shard_of` cut a rank's shards out of global tensors by the
reference's specs. Used by :func:`repro_torch.launch.serve_step.
make_serve_step` for the ``long_500k`` shape (batch 1: only the context
can fill the mesh).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.leantile import ScheduleCache
from repro_torch.core.merge import AttnPartial, identity_like
from repro_torch.distributed.sharding import P
from repro_torch.launch.mesh import axis_group, axis_index, axis_size, mesh_axes


def lean_merge_collective(part: AttnPartial, group=None) -> torch.Tensor:
    """Reduce partial triples across the ranks of ``group`` (None: every
    rank) and finalize: ``o_glob / l_glob``, float32. Exact by
    associativity (paper §IV-A): the reductions evaluate the same operator
    as any sequential merge order. A partial with ``m = -inf`` (a rank with
    no key for that row) scales to 0, and the global maximum is read as 0
    where every rank's is -inf (the reference's guard). ``l`` and ``o``
    travel in one buffer, so the merge is two collectives; every rank ends
    with the same bits."""
    m_glob = part.m.float().clone()
    dist.all_reduce(m_glob, op=dist.ReduceOp.MAX, group=group)
    neg_inf = lambda x: torch.isinf(x) & (x < 0)
    safe = torch.where(neg_inf(m_glob), torch.zeros_like(m_glob), m_glob)
    scale = torch.where(neg_inf(part.m), torch.zeros_like(m_glob), torch.exp(part.m - safe))
    both = torch.cat([(scale * part.l)[..., None], scale[..., None] * part.o], dim=-1)
    dist.all_reduce(both, op=dist.ReduceOp.SUM, group=group)
    return both[..., 1:] / both[..., :1]


def _seq_axes(seq_axis, mesh) -> tuple:
    axes = (seq_axis,) if isinstance(seq_axis, str) else tuple(seq_axis)
    return tuple(a for a in axes if a in mesh_axes(mesh))


def sp_specs(mesh, B: int, Hq: int, Hkv: int, seq_axis="data",
             head_axis: Optional[str] = "model", batch_axis=None) -> dict:
    """The reference's specs of :func:`sp_decode_attention`'s operands
    (``repro/core/distributed.py:76-88``, ``:107-113``) for global ``q (B,
    Hq, d)``, ``k``/``v (B, Hkv, S, d)`` and ``ctx_len (B,)``: ``"q"``,
    ``"kv"``, ``"ctx"`` and ``"out"``. Heads split over ``head_axis`` only
    when both ``Hq`` and ``Hkv`` divide it and it carries neither the
    sequence nor the batch; the batch splits over ``batch_axis`` when it
    divides."""
    sizes = mesh_axes(mesh)
    seq_axes = _seq_axes(seq_axis, mesh)
    both = (
        head_axis
        and head_axis not in seq_axes
        and head_axis != batch_axis
        and Hq % sizes[head_axis] == 0
        and Hkv % sizes[head_axis] == 0
    )
    h_spec = head_axis if both else None
    nb = sizes.get(batch_axis, 1) if batch_axis else 1
    b_spec = batch_axis if (batch_axis and B % nb == 0 and B >= nb) else None
    s_spec = seq_axes if len(seq_axes) > 1 else seq_axes[0]
    return {"q": P(b_spec, h_spec, None), "kv": P(b_spec, h_spec, s_spec, None),
            "ctx": P(b_spec), "out": P(b_spec, h_spec, None)}


def shard_of(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` under ``spec``: each
    dimension split evenly over its axes (a tuple of axes row-major, as
    ``NamedSharding`` splits), the others whole. A view."""
    for dim, axes in enumerate(tuple(spec)):
        if axes is None:
            continue
        n = axis_size(mesh, axes)
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split over {axes} "
                             f"({n} ranks)")
        size = x.shape[dim] // n
        x = x.narrow(dim, axis_index(mesh, axes) * size, size)
    return x


def _host_lens(ctx_len, B: int, total: int) -> np.ndarray:
    if ctx_len is None:
        return np.full(B, total, dtype=np.int64)
    if torch.is_tensor(ctx_len):
        ctx_len = ctx_len.cpu()      # a CUDA tensor: one host sync
    lens = np.asarray(ctx_len, dtype=np.int64).reshape(-1)
    if lens.shape != (B,):
        raise ValueError(f"ctx_len holds {lens.size} lengths for {B} local batch rows")
    return lens


def local_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid: np.ndarray,
                  schedule_cache: Optional[ScheduleCache] = None) -> AttnPartial:
    """One rank's partial over its KV chunk: ``q (B, Hq, d)``, ``k``/``v
    (B, Hkv, t, d)``, ``valid (B,)`` host counts of valid keys. K2 (its
    plain version on CPU tensors) returns each row's normalized output and
    log-sum-exp in float32, which enter the merge as ``(o, m = lse, l =
    1)``; a row with no valid key is the identity ``(0, -inf, 0)``, and K2
    is not launched when no row has one (it sees such a row as one key, its
    result replaced)."""
    from repro_torch.kernels import ops

    B, Hq, d = q.shape
    has = valid > 0
    if not has.any():
        return identity_like((B, Hq, d), device=q.device)
    workers = (torch.cuda.get_device_properties(q.device).multi_processor_count
               if q.device.type == "cuda" else None)
    o, lse = ops.lean_decode(q, k, v, [max(1, int(n)) for n in valid], num_workers=workers,
                             fused=True, return_lse=True, out_dtype=torch.float32,
                             schedule_cache=schedule_cache)
    if has.all():
        return AttnPartial(o=o, m=lse, l=torch.ones_like(lse))
    r = torch.as_tensor(has, device=q.device)[:, None]
    ident = identity_like((B, Hq, d), device=q.device)
    return AttnPartial(o=torch.where(r[..., None], o, ident.o), m=torch.where(r, lse, ident.m),
                       l=torch.where(r, torch.ones_like(lse), ident.l))


def sp_decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    seq_axis="data",
    head_axis: Optional[str] = "model",
    batch_axis=None,
    ctx_len=None,
    scale: Optional[float] = None,
    schedule_cache: Optional[ScheduleCache] = None,
) -> torch.Tensor:
    """Sequence-parallel exact decode attention, on this rank's shards.

    ``q (B, Hq, d)``, ``k``/``v (B, Hkv, t, d)`` and ``ctx_len (B,)`` are
    this rank's blocks of the reference's global operands under
    :func:`sp_specs` (the same ``seq_axis``, ``head_axis``, ``batch_axis``):
    the sequence split over ``seq_axis`` (a name or a tuple of names, e.g.
    ``("data", "model")`` for batch-1 long-context decode, the paper's
    Fig. 9), the batch over ``batch_axis`` when given, heads over
    ``head_axis`` when both head counts divide it. ``ctx_len`` holds the
    global context lengths of the local rows, host ints or a tensor (a CUDA
    tensor costs one host sync: K2's schedule is built on the host); None
    means every key. This rank's chunk starts at ``axis_index(seq_axes) *
    t``; its keys at or past ``ctx_len`` are masked. Returns this rank's
    block of the output, ``(B, Hq, d)`` in ``q``'s dtype; every rank of a
    sequence group returns the same bits. ``scale`` must be ``1/sqrt(d)``,
    the scale K2 computes with."""
    B, Hq, d = q.shape
    Bk, Hkv, t, _ = k.shape
    if Bk != B or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} are not one decode batch")
    if scale is not None and not math.isclose(scale, 1.0 / math.sqrt(d), rel_tol=1e-12):
        raise ValueError(f"sp_decode_attention computes at scale 1/sqrt(d), not {scale}")
    seq_axes = _seq_axes(seq_axis, mesh)
    if not seq_axes:
        raise ValueError(f"none of the sequence axes {seq_axis} is in the mesh")
    n_seq = axis_size(mesh, seq_axes)
    offset = axis_index(mesh, seq_axes) * t
    lens = _host_lens(ctx_len, B, t * n_seq)
    valid = np.clip(lens - offset, 0, t)
    part = local_partial(q, k, v, valid, schedule_cache)
    out = lean_merge_collective(part, axis_group(mesh, seq_axes))
    return out.to(q.dtype)
