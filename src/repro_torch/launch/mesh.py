"""Device meshes over ``torch.distributed`` (port of ``repro/launch/
mesh.py``), with the reference's axis names: ``data`` and ``model``, and a
leading ``pod`` when there are several pods.

The reference builds a ``jax.sharding.Mesh`` over the devices it sees; here
a :class:`~torch.distributed.device_mesh.DeviceMesh` lays the ranks of the
running process group out row-major over the axes (rank ``r`` of a
``(data, model)`` mesh sits at ``(r // model, r % model)``), so a rank's
index over a tuple of axes is row-major in the tuple's order, as
``jax.lax.axis_index`` of a tuple is (:func:`axis_index`). Nothing tells a
program of a cluster: :func:`init_distributed` takes the address, the world
size and the rank.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

Axes = Union[str, Sequence[str]]

# the reference's production meshes: one v5e pod of 256 chips, or two
PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def init_distributed(rank: int, world_size: int, port: int, backend: str = "gloo") -> None:
    """Join the process group at ``tcp://localhost:<port>`` as ``rank`` of
    ``world_size`` (``gloo`` on the CPU, or for several ranks on one card;
    ``nccl`` for one rank per card)."""
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world_size, rank=rank)


def make_mesh(shape: Sequence[int], axes: Sequence[str], device_type: str = "cuda"
              ) -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over every rank of the running
    process group; raises unless the group holds exactly ``prod(shape)``
    ranks."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; the process group "
                         f"has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """The reference's production mesh: ``(data=16, model=16)``, or
    ``(pod=2, data=16, model=16)`` across pods; raises unless the process
    group holds 256 or 512 ranks to match."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return make_mesh(shape, axes, device_type)


def make_host_mesh(shape=(2, 4), axes=("data", "model")) -> DeviceMesh:
    """A small CPU mesh for tests, over a ``gloo`` process group."""
    return make_mesh(shape, axes, "cpu")


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a :class:`DeviceMesh`, or of any object
    with a ``shape`` dict (the reference's ``jax.sharding.Mesh`` and its
    tests' ``FakeMesh``)."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(mesh.shape)


def _axes(axes: Axes, mesh) -> Tuple[str, ...]:
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    missing = [a for a in names if a not in mesh_axes(mesh)]
    if missing:
        raise ValueError(f"axes {missing} are not in the mesh {mesh_axes(mesh)}")
    return names


def axis_size(mesh, axes: Axes) -> int:
    """The number of ranks along ``axes`` (a name or a tuple of names)."""
    sizes = mesh_axes(mesh)
    return math.prod(sizes[a] for a in _axes(axes, mesh))


def axis_index(mesh: DeviceMesh, axes: Axes) -> int:
    """This rank's index along ``axes``: row-major over the tuple's order
    (``jax.lax.axis_index``)."""
    idx = 0
    for a in _axes(axes, mesh):
        idx = idx * mesh.size(mesh.mesh_dim_names.index(a)) + mesh.get_local_rank(a)
    return idx


def axis_group(mesh: DeviceMesh, axes: Axes) -> dist.ProcessGroup:
    """The process group of the ranks that share this rank's coordinates
    off ``axes``: the group a reduction over ``axes`` runs in. Building
    the group of several axes is collective (every rank calls it in the
    same order, as SPMD code does); it is built once per mesh."""
    names = _axes(axes, mesh)
    ordered = tuple(a for a in mesh.mesh_dim_names if a in names)
    if len(ordered) == 1:
        return mesh.get_group(ordered[0])
    groups = mesh.__dict__.setdefault("_axis_groups", {})
    if ordered not in groups:
        if ordered == tuple(mesh.mesh_dim_names) and mesh.mesh.numel() == dist.get_world_size():
            groups[ordered] = dist.group.WORLD
        else:
            groups[ordered] = mesh[ordered]._flatten().get_group()
    return groups[ordered]
