"""Checkpoints in the reference's on-disk layout (port of
``repro/training/checkpoint.py``), so either package restores the other's:

    <dir>/step_<n:08d>/manifest.json + arrays.npz      (+ .tmp-<n> staging)

``arrays.npz`` holds the leaves of the saved tree as ``a0``, ``a1``, ...
in JAX's flatten order (dict keys sorted, sequences in order); the
manifest holds ``step``, ``num_leaves``, each leaf's ``paths`` string,
``extra`` and ``time``. A training state is saved as the reference's tree
-- ``{"params": params_to_numpy(params, cfg), "opt":
opt_state_to_numpy(opt, cfg)}``, stacked stages in float32 and an int32
``step`` -- and restored through ``params_from_numpy`` /
``opt_state_from_numpy``.

Properties, as in the reference: a save stages into ``.tmp-<step>`` and
commits with one ``rename``, so a crash never leaves a partial checkpoint
under a step's name; keep-last-k retention; an asynchronous save copies
the leaves to the host first, then writes on a thread while training goes
on.

Elastic, as in the reference: the arrays are saved whole, so a checkpoint
restores onto any mesh shape. On a mesh (``shardings``: a tree of
:class:`repro_torch.distributed.sharding.P` matching the state, its leaves
this rank's blocks) :func:`save_checkpoint` gathers each leaf whole on
rank 0, one leaf at a time and from one replica of each block, and rank 0
writes it -- the same arrays a one-device save
writes -- and :func:`restore_checkpoint` gives each rank its block under
the specs of the mesh it restores onto, reading one array at a time.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zipfile
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device
from .tree import flatten, unflatten


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def save_checkpoint(ckpt_dir, step: int, state: Any, *, extra: Optional[dict] = None,
                    keep: int = 3, block: bool = True, shardings: Any = None,
                    mesh=None) -> Optional[threading.Thread]:
    """Atomically persist ``state`` (a tree of arrays or tensors) at
    ``step``. With ``block=False`` the write runs on a thread, which is
    returned (join it before the next save); the leaves are copied to the
    host before this returns.

    With ``shardings`` (a tree of specs matching ``state``) and ``mesh``
    every rank calls: ``state``'s leaves are this rank's blocks (or
    functions of no argument returning them, called one at a time), each
    is gathered whole to rank 0 in turn (:func:`_whole_on_writer`) and
    written there, so the whole state never lives on a device; the call
    returns on every rank once the checkpoint is committed. Blocking only."""
    if shardings is not None:
        if not block:
            raise ValueError("a sharded save is collective and blocks")
        return _save_sharded(Path(ckpt_dir), step, state, extra, keep, shardings, mesh)
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f".tmp-{step}"
    final = ckpt_dir / f"step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    paths, leaves = flatten(state)
    host = [_host(x) for x in leaves]

    def write():
        np.savez(tmp / "arrays.npz", **{f"a{i}": x for i, x in enumerate(host)})
        manifest = {"step": step, "num_leaves": len(host), "paths": paths,
                    "extra": extra or {}, "time": time.time()}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)                      # atomic commit
        _gc(ckpt_dir, keep)

    if block:
        write()
        return None
    t = threading.Thread(target=write, daemon=True)
    t.start()
    return t


def _whole_on_writer(x: torch.Tensor, spec, mesh):
    """The whole leaf on rank 0 (numpy, on the host) from the ranks' blocks
    under ``spec``, None on the other ranks. The blocks are gathered to rank
    0 (``gather``) over the axes the leaf splits on, from the ranks that
    share rank 0's coordinates off those axes: one replica of each block
    moves, once. Over NCCL they stay on their device and rank 0 copies the
    whole leaf to the host; gloo gathers host tensors, so there a CUDA
    block is copied to the host first (as the pipeline's sends are). Rank
    0 puts each block at its coordinates. A leaf no axis splits is rank
    0's own. Every rank calls, in the same order (a group of several axes
    is built collectively on first use)."""
    from repro_torch.distributed.tensor_parallel import _axes
    from repro_torch.launch.mesh import axis_group, axis_index, axis_size, mesh_axes

    sizes, names = mesh_axes(mesh), mesh.mesh_dim_names
    used = {a for e in tuple(spec) for a in _axes(e)}
    split = tuple(a for a in names if a in used and sizes[a] > 1)
    mine = dist.get_rank() == 0
    if not split:
        return _host(x) if mine else None
    group = axis_group(mesh, split)
    if any(axis_index(mesh, a) for a in names if a not in split):
        return None                                # another replica of rank 0's blocks
    blk = x.detach().contiguous()
    if blk.is_cuda and dist.get_backend(group) == "gloo":
        blk = blk.cpu()
    n = axis_size(mesh, split)
    buf = torch.empty((n,) + tuple(blk.shape), dtype=blk.dtype, device=blk.device) if mine \
        else None
    dist.gather(blk, list(buf.unbind(0)) if mine else None, dst=0, group=group)
    if not mine:
        return None
    whole = torch.empty([m * (axis_size(mesh, a) if a else 1) for m, a in zip(blk.shape, spec)],
                        dtype=blk.dtype, device=blk.device)
    for j in range(n):
        where = (mesh.mesh == dist.get_global_rank(group, j)).nonzero()[0]
        coord = dict(zip(names, (int(i) for i in where)))
        at = []
        for m, a in zip(blk.shape, spec):
            idx = 0
            for ax in _axes(a):
                idx = idx * sizes[ax] + coord[ax]
            at.append(slice(idx * m, (idx + 1) * m) if a else slice(None))
        whole[tuple(at)] = buf[j]
    del buf
    return _host(whole)


def _save_sharded(ckpt_dir: Path, step: int, state: Any, extra, keep: int, shardings,
                  mesh) -> None:
    from repro_torch.distributed.sharding import spec_paths

    writer = dist.get_rank() == 0
    tmp, final = ckpt_dir / f".tmp-{step}", ckpt_dir / f"step_{step:08d}"
    if writer:
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
    paths, leaves = flatten(state)
    specs = spec_paths(shardings)
    # the members np.savez writes: uncompressed .npy entries a0, a1, ...
    zf = zipfile.ZipFile(tmp / "arrays.npz", mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) if writer else None
    try:
        for i, (path, leaf) in enumerate(zip(paths, leaves)):
            leaf = leaf() if callable(leaf) else leaf
            whole = _whole_on_writer(leaf, specs[path], mesh) if torch.is_tensor(leaf) \
                else leaf
            del leaf
            if writer:
                with zf.open(f"a{i}.npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, _host(whole), allow_pickle=False)
            del whole
    finally:
        if zf is not None:
            zf.close()
    if writer:
        manifest = {"step": step, "num_leaves": len(paths), "paths": paths,
                    "extra": extra or {}, "time": time.time()}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)                      # atomic commit
        _gc(ckpt_dir, keep)
    dist.barrier()


def _gc(ckpt_dir: Path, keep: int):
    for old in sorted(ckpt_dir.glob("step_*"))[:-keep]:
        shutil.rmtree(old, ignore_errors=True)


def latest_step(ckpt_dir) -> Optional[int]:
    """The newest committed step under ``ckpt_dir``, or None."""
    ckpt_dir = Path(ckpt_dir)
    steps = sorted(ckpt_dir.glob("step_*")) if ckpt_dir.exists() else []
    return int(steps[-1].name.split("_")[1]) if steps else None


def restore_checkpoint(ckpt_dir, state_like: Any, step: Optional[int] = None,
                       device: DeviceLike = "cuda", shardings: Any = None, mesh=None):
    """Restore the checkpoint at ``step`` (the latest by default) into the
    structure of ``state_like`` (only its structure is read). Returns
    ``(state, extra)``: the leaves as tensors on ``device``, in their saved
    dtypes. Raises ``FileNotFoundError`` without a checkpoint and
    ``ValueError`` where the saved leaves' paths are not ``state_like``'s.

    With ``shardings`` (a tree of specs matching ``state_like``) and
    ``mesh`` -- any mesh, not that of the save -- each leaf is this rank's
    block of the saved array under its spec (the reference's
    ``device_put`` with ``NamedSharding``): each array is read whole on
    the host, one at a time, and only the block is put on the device."""
    dev = resolve_device(device)
    ckpt_dir = Path(ckpt_dir)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    paths, _ = flatten(state_like)
    if manifest["paths"] != paths:
        bad = next((a, b) for a, b in zip(manifest["paths"] + [None], paths + [None]) if a != b)
        raise ValueError(f"checkpoint has {manifest['num_leaves']} leaves, expected {len(paths)}; "
                         f"first differing path: saved {bad[0]!r}, expected {bad[1]!r}")
    if shardings is not None:
        from repro_torch.core.distributed import shard_of
        from repro_torch.distributed.sharding import spec_paths

        specs = spec_paths(shardings)
        leaves = []
        with np.load(d / "arrays.npz") as data:
            for i, path in enumerate(paths):
                whole = torch.from_numpy(data[f"a{i}"])
                leaves.append(shard_of(whole, specs[path], mesh).to(dev, copy=True).contiguous())
                del whole
        return unflatten(state_like, leaves), manifest["extra"]
    with np.load(d / "arrays.npz") as data:
        leaves = [torch.from_numpy(data[f"a{i}"]).to(dev) for i in range(len(paths))]
    return unflatten(state_like, leaves), manifest["extra"]
