"""GPipe-style pipeline parallelism over one mesh axis (port of
``repro/distributed/pipeline.py``).

The stages hold contiguous slices of the layer stack; the global batch is
split into ``M`` micro-batches; over ``P`` stages the schedule runs ``M +
P - 1`` ticks, stage ``p`` working on micro-batch ``t - p`` at tick ``t``
while that index is in ``[0, M)``: the bubble is ``(P - 1) / (M + P -
1)`` of the ticks (:func:`bubble_fraction`). The reference runs the ticks
as a ``lax.scan`` under ``shard_map`` with a ``ppermute`` of every
stage's boundary activation each tick; here each rank runs its own stage
and sends its output to the next stage only on the ticks it is active
(``isend``/``recv`` between neighbours over the process group), which is
the data the reference's permutation moves. The last stage's outputs then
reach every rank of the axis (one ``broadcast``). Forward only, as in the
reference. Over ``gloo`` a CUDA activation is sent from, and received
into, a host copy: gloo's point-to-point transport reads host memory.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import axis_group, axis_index, axis_size


def _host_staged(x: torch.Tensor) -> bool:
    return x.is_cuda and dist.get_backend() == "gloo"


def pipeline_forward(fn_stage: Callable, stage_params, x: torch.Tensor, mesh,
                     axis: str = "pod") -> torch.Tensor:
    """Run ``fn_stage(stage_params, x, stage_idx) -> x`` pipelined over
    ``axis``: this rank is stage ``axis_index(mesh, axis)`` and passes its
    own stage's parameters (the reference's ``P(axis)`` block of the
    stacked stage parameters); ``x`` is the micro-batched input ``(M, mb,
    ...)``, which only stage 0 reads. Returns the last stage's outputs
    ``(M, mb, ...)`` (its function keeps the input's shape) on every rank
    of the axis. Every rank of the mesh calls it."""
    n = axis_size(mesh, axis)
    stage = axis_index(mesh, axis) if n > 1 else 0
    M = x.shape[0]
    out = torch.zeros_like(x)
    if n == 1:
        for m in range(M):
            out[m] = fn_stage(stage_params, x[m], 0)
        return out
    group = axis_group(mesh, axis)
    prev = dist.get_global_rank(group, stage - 1) if stage > 0 else None
    nxt = dist.get_global_rank(group, stage + 1) if stage < n - 1 else None
    pending = None
    for t in range(M + n - 1):
        m = t - stage
        if not 0 <= m < M:
            continue
        if prev is None:
            x_in = x[m]
        else:
            x_in = torch.empty_like(x[m], device="cpu" if _host_staged(x) else x.device)
            dist.recv(x_in, src=prev)
            x_in = x_in.to(x.device)
        y = fn_stage(stage_params, x_in, stage).contiguous()
        if nxt is None:
            out[m] = y
        else:
            if pending is not None:
                pending[0].wait()
            y = y.cpu() if _host_staged(y) else y
            pending = (dist.isend(y, dst=nxt), y)     # y lives until the send is done
    if pending is not None:
        pending[0].wait()
    dist.broadcast(out, src=dist.get_global_rank(group, n - 1), group=group)
    return out


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """The share of the ``M + P - 1`` ticks a stage idles: ``(P - 1) / (M +
    P - 1)``."""
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
