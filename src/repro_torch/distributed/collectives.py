"""Explicit collective building blocks of the distributed layer (port of
``repro/distributed/collectives.py``).

* :func:`compressed_psum` -- an int8-quantized all-reduce: each rank
  quantizes its block with the group's shared scale (the maximum of the
  ranks' ``amax / 127``), the int32 sum crosses the links, one
  quantization error per element.
* :func:`lean_merge_collective` -- re-exported from
  :mod:`repro_torch.core.distributed`: the associative softmax re-scaling
  reduction as collectives (the paper's operator at mesh scale).

The reference runs each under ``shard_map`` over the stacked per-shard view
``(n, ...)``; here each rank passes its own block and gets its block of the
result.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.distributed import lean_merge_collective  # noqa: F401
from repro_torch.launch.mesh import axis_group, axis_size


def compressed_psum(x: torch.Tensor, mesh, axis: str = "pod") -> torch.Tensor:
    """All-reduce ``x`` (this rank's block) over ``axis``, moving int8
    values: quantized symmetrically with the shared scale, summed in int32,
    returned as float32 times the scale."""
    group = axis_group(mesh, axis)
    a = x.float().abs().amax() + 1e-12
    dist.all_reduce(a, op=dist.ReduceOp.MAX, group=group)
    scale = a / 127.0
    q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int32)
    dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
    return q.float() * scale


def psum_mean(x: torch.Tensor, mesh, axis: str = "pod") -> torch.Tensor:
    return compressed_psum(x, mesh, axis) / axis_size(mesh, axis)
