"""Softmax re-scaling as an associative reduction operator (paper §IV-A).

PyTorch port of ``repro.core.merge``. A partial attention triple
``(o, m, l)`` summarises exact attention over a contiguous chunk of KV:

    m' = max(m_x, m_y)
    l' = exp(m_x - m') l_x + exp(m_y - m') l_y
    o' = exp(m_x - m') o_x + exp(m_y - m') o_y

and ``o_total / l_total`` is the exact attention. Shapes: ``o: (..., d)``,
``m, l: (...)``. The ``-inf`` identity guards of the reference are kept, so
merging two identities gives zeros, not NaN.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class AttnPartial(NamedTuple):
    """Un-scaled partial attention output plus softmax statistics."""

    o: torch.Tensor  # (..., d)   un-scaled output
    m: torch.Tensor  # (...)      running row max
    l: torch.Tensor  # (...)      running exp-sum

    @property
    def dtype(self):
        return self.o.dtype


def _is_neg_inf(x: torch.Tensor) -> torch.Tensor:
    return torch.isinf(x) & (x < 0)


def _guarded_scale(m: torch.Tensor, m_ref: torch.Tensor) -> torch.Tensor:
    """``exp(m - m_ref)`` with 0 where ``m`` is -inf and ``m_ref`` read as 0
    where it is -inf (the reference's guarded exp)."""
    safe = torch.where(_is_neg_inf(m_ref), torch.zeros_like(m_ref), m_ref)
    return torch.where(_is_neg_inf(m), torch.zeros_like(m), torch.exp(m - safe))


def identity_like(o_shape, dtype=torch.float32, device=None) -> AttnPartial:
    """The merge's identity, ``o = 0, m = -inf, l = 0``:
    ``merge(identity, x) == x``."""
    stat_shape = tuple(o_shape)[:-1]
    return AttnPartial(
        o=torch.zeros(o_shape, dtype=dtype, device=device),
        m=torch.full(stat_shape, float("-inf"), dtype=dtype, device=device),
        l=torch.zeros(stat_shape, dtype=dtype, device=device),
    )


def merge(x: AttnPartial, y: AttnPartial) -> AttnPartial:
    """The paper's softmax re-scaling operator f(x, y)."""
    m_new = torch.maximum(x.m, y.m)
    ax = _guarded_scale(x.m, m_new)
    ay = _guarded_scale(y.m, m_new)
    l_new = ax * x.l + ay * y.l
    o_new = ax[..., None] * x.o + ay[..., None] * y.o
    return AttnPartial(o=o_new, m=m_new, l=l_new)


def finalize(p: AttnPartial) -> torch.Tensor:
    """Turn a fully reduced partial into the exact attention output o / l."""
    return p.o / p.l[..., None]


def merge_n(partials: AttnPartial) -> AttnPartial:
    """Reduce a stacked AttnPartial (leading axis = chunks) in one pass."""
    m_star = partials.m.amax(dim=0)
    scale = _guarded_scale(partials.m, m_star)
    l_star = (scale * partials.l).sum(dim=0)
    o_star = (scale[..., None] * partials.o).sum(dim=0)
    return AttnPartial(o=o_star, m=m_star, l=l_star)


def tree_merge(partials: AttnPartial) -> AttnPartial:
    """Reduce a stacked AttnPartial (leading axis = chunks) by a binary tree
    of :func:`merge` (log depth), pairing halves as the reference does
    (``repro/core/merge.py:98``): the first half with the second, an odd
    chunk carried to the next level."""
    n = partials.o.shape[0]
    p = partials
    while n > 1:
        half = n // 2
        merged = merge(AttnPartial(*(a[:half] for a in p)),
                       AttnPartial(*(a[half:2 * half] for a in p)))
        if n % 2:
            merged = AttnPartial(*(torch.cat([a, b[2 * half:n]], dim=0)
                                   for a, b in zip(merged, p)))
        p = merged
        n = (n + 1) // 2
    return AttnPartial(*(a[0] for a in p))


class MergeGrid(NamedTuple):
    """Where :func:`segment_merge` lays each piece in its ``(segments + 1,
    width)`` grid: piece ``order[i]`` goes to row ``sid[i]``, column
    ``rank[i]``. ``ids`` are the clamped segment ids (padding ->
    ``num_segments``)."""

    ids: torch.Tensor     # (P,) long
    order: torch.Tensor   # (P,) long
    sid: torch.Tensor     # (P,) long
    rank: torch.Tensor    # (P,) long
    width: int


def merge_grid_arrays(segment_ids: np.ndarray, num_segments: int):
    """:func:`segment_merge`'s grid computed on the host from host segment
    ids: ``(ids, order, sid, rank)`` as int64 arrays and the width, the
    values its device path derives."""
    ids = np.asarray(segment_ids, dtype=np.int64)
    ids = np.where((ids < 0) | (ids >= num_segments), num_segments, ids)
    order = np.argsort(ids, kind="stable")
    sid = ids[order]
    counts = np.bincount(ids, minlength=num_segments + 1)
    starts = np.cumsum(counts) - counts
    rank = np.arange(ids.size) - starts[sid]
    width = max(int(counts.max()) if ids.size else 0, 1)
    return ids, order, sid, rank, width


def merge_grid(segment_ids: np.ndarray, num_segments: int,
               device: torch.device) -> MergeGrid:
    """:func:`merge_grid_arrays` of host segment ids (a schedule's
    ``piece_seg``) uploaded to ``device``: a caller that holds it merges
    with no host sync."""
    *arrays, width = merge_grid_arrays(segment_ids, num_segments)
    up = lambda a: torch.as_tensor(a, dtype=torch.long).to(device)
    return MergeGrid(*map(up, arrays), width=width)


def segment_merge(
    partials: AttnPartial, segment_ids: torch.Tensor, num_segments: int,
    grid: Optional[MergeGrid] = None,
) -> AttnPartial:
    """Merge P partial triples into S segments (the decode fix-up phase).

    ``segment_ids: (P,)`` maps each piece to its output tile; pieces with
    ``segment_id >= num_segments`` (padding) are dropped and empty segments
    get ``m = -inf``, as ``jax.ops.segment_max``/``segment_sum`` give.

    Deterministic: a scatter-add sums in atomic (run-dependent) order on
    CUDA, so each segment's pieces are first laid out in a
    ``(segments, max pieces)`` grid, in their original order, and reduced
    along the grid axis. Computing the grid on the device costs one host
    sync (its width); a caller with host ids passes ``grid``
    (:func:`merge_grid` of the same ids) and the merge syncs nothing, with
    the same grid and so the same bits.
    """
    o, m, l = partials
    dev = m.device
    if grid is None:
        ids = segment_ids.to(device=dev, dtype=torch.long)
        ids = torch.where(
            (ids < 0) | (ids >= num_segments), torch.full_like(ids, num_segments), ids
        )
        order = torch.argsort(ids, stable=True)
        sid = ids[order]
        counts = torch.bincount(ids, minlength=num_segments + 1)
        starts = torch.cumsum(counts, 0) - counts
        rank = torch.arange(ids.numel(), device=dev) - starts[sid]
        width = max(int(counts.max()) if ids.numel() else 0, 1)
    else:
        ids, order, sid, rank, width = grid

    def lay_out(x, fill):
        g = torch.full((num_segments + 1, width) + tuple(x.shape[1:]), fill,
                       dtype=x.dtype, device=dev)
        g[sid, rank] = x[order]
        return g

    m_seg = lay_out(m, float("-inf")).amax(dim=1)
    scale = _guarded_scale(m, m_seg[ids])
    l_seg = lay_out(scale * l, 0.0).sum(dim=1)
    o_seg = lay_out(scale[..., None] * o, 0.0).sum(dim=1)
    return AttnPartial(
        o=o_seg[:num_segments], m=m_seg[:num_segments], l=l_seg[:num_segments]
    )
