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

from typing import NamedTuple

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


def segment_merge(
    partials: AttnPartial, segment_ids: torch.Tensor, num_segments: int
) -> AttnPartial:
    """Merge P partial triples into S segments (the decode fix-up phase).

    ``segment_ids: (P,)`` maps each piece to its output tile; pieces with
    ``segment_id >= num_segments`` (padding) are dropped and empty segments
    get ``m = -inf``, as ``jax.ops.segment_max``/``segment_sum`` give.

    Deterministic: a scatter-add sums in atomic (run-dependent) order on
    CUDA, so each segment's pieces are first laid out in a
    ``(segments, max pieces)`` grid, in their original order, and reduced
    along the grid axis. Reading the grid width costs one host sync.
    """
    o, m, l = partials
    dev = m.device
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

    def grid(x, fill):
        g = torch.full((num_segments + 1, width) + tuple(x.shape[1:]), fill,
                       dtype=x.dtype, device=dev)
        g[sid, rank] = x[order]
        return g

    m_seg = grid(m, float("-inf")).amax(dim=1)
    scale = _guarded_scale(m, m_seg[ids])
    l_seg = grid(scale * l, 0.0).sum(dim=1)
    o_seg = grid(scale[..., None] * o, 0.0).sum(dim=1)
    return AttnPartial(
        o=o_seg[:num_segments], m=m_seg[:num_segments], l=l_seg[:num_segments]
    )

