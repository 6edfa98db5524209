"""Activation sharding hints (port of ``repro/distributed/hints.py``).

In the reference the launcher installs a mesh here and the model drops
``hint(x, "dp", None, "model")`` constraints at activation boundaries;
XLA then lays each activation out by them. Without an installed mesh the
calls are no-ops.

Axis vocabulary: ``"dp"`` -> ``("pod", "data")`` when the mesh has a pod
axis, else ``("data",)``, or the axes :func:`activation_mesh` was given
(the pure-DP layout passes ``("data", "model")``); ``"data"``/``"model"``
-> themselves; None -> replicated. A dimension its axes do not divide is
replicated.

In the port every rank holds its own blocks, so there is nothing for a
hint to lay out: the layout of an activation is whatever block the rank
computed, and the collectives that move blocks are explicit
(:mod:`repro_torch.distributed.tensor_parallel`,
:mod:`repro_torch.distributed.fsdp`). :func:`hint` keeps the reference's
check of its arguments (the rank of ``x`` against the axes given) and
returns ``x``. What the port reads from here is the batch's axes: the
train step installs ``activation_mesh(mesh, dp=dp_axes(mesh, layout))``
and the training context splits each micro-batch over
``_resolve("dp", mesh, rows)``.
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from typing import Optional

from repro_torch.launch.mesh import mesh_axes

_state = threading.local()


def set_activation_mesh(mesh, dp=None) -> None:
    """Install ``mesh`` and the axes ``"dp"`` hints map to (``dp=None``:
    the default ``(pod, data)``)."""
    _state.mesh = mesh
    _state.dp = dp


def get_activation_mesh():
    return getattr(_state, "mesh", None)


def get_dp_axes(mesh) -> tuple:
    """The axes ``"dp"`` maps to on ``mesh``: those installed, or ``(pod,
    data)``, kept where the mesh has them."""
    names = mesh_axes(mesh)
    dp = getattr(_state, "dp", None)
    if dp is None:
        dp = tuple(a for a in ("pod", "data") if a in names)
    return tuple(a for a in dp if a in names)


@contextmanager
def activation_mesh(mesh, dp=None):
    """Install ``mesh`` (and ``dp``) for the block, then restore what was
    installed before."""
    prev = (get_activation_mesh(), getattr(_state, "dp", None))
    set_activation_mesh(mesh, dp)
    try:
        yield
    finally:
        set_activation_mesh(*prev)


def _dp_candidates(mesh) -> list:
    """Axis combinations for ``"dp"``, largest first (``best_dp_spec``'s
    order)."""
    dp = get_dp_axes(mesh)
    cands = [dp]
    if "model" in dp:
        cands.append(tuple(a for a in dp if a != "model"))
    if cands[-1] != ("data",) and "data" in mesh_axes(mesh):
        cands.append(("data",))
    return [c for c in cands if c]


def _resolve(axis, mesh, dim: int):
    """What ``axis`` of a hint means for a dimension of size ``dim``: an
    axis name, a tuple of names, or None (replicated)."""
    if axis is None:
        return None
    sizes = mesh_axes(mesh)
    if axis == "dp":
        for names in _dp_candidates(mesh):
            size = math.prod(sizes[a] for a in names)
            if size > 1 and dim % size == 0 and dim >= size:
                return names if len(names) > 1 else names[0]
        return None
    if axis in get_dp_axes(mesh):        # consumed by DP (pure-DP layout)
        return None
    if axis in sizes:
        size = sizes[axis]
        if size > 1 and dim % size == 0 and dim >= size:
            return axis
    return None


def hint(x, *axes):
    """The reference's ``with_sharding_constraint`` hint: with a mesh
    installed, ``ValueError`` unless one axis is given per dimension of
    ``x``; ``x`` itself in every case (a rank's activation is already its
    block)."""
    mesh: Optional[object] = get_activation_mesh()
    if mesh is not None and len(axes) != x.ndim:
        raise ValueError(f"hint rank mismatch: {axes} vs {tuple(x.shape)}")
    return x
