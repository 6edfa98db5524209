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
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from .tree import flatten, unflatten


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def save_checkpoint(ckpt_dir, step: int, state: Any, *, extra: Optional[dict] = None,
                    keep: int = 3, block: bool = True) -> Optional[threading.Thread]:
    """Atomically persist ``state`` (a tree of arrays or tensors) at
    ``step``. With ``block=False`` the write runs on a thread, which is
    returned (join it before the next save); the leaves are copied to the
    host before this returns."""
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


def _gc(ckpt_dir: Path, keep: int):
    for old in sorted(ckpt_dir.glob("step_*"))[:-keep]:
        shutil.rmtree(old, ignore_errors=True)


def latest_step(ckpt_dir) -> Optional[int]:
    """The newest committed step under ``ckpt_dir``, or None."""
    ckpt_dir = Path(ckpt_dir)
    steps = sorted(ckpt_dir.glob("step_*")) if ckpt_dir.exists() else []
    return int(steps[-1].name.split("_")[1]) if steps else None


def restore_checkpoint(ckpt_dir, state_like: Any, step: Optional[int] = None,
                       device: DeviceLike = "cuda"):
    """Restore the checkpoint at ``step`` (the latest by default) into the
    structure of ``state_like`` (only its structure is read). Returns
    ``(state, extra)``: the leaves as tensors on ``device``, in their saved
    dtypes. Raises ``FileNotFoundError`` without a checkpoint and
    ``ValueError`` where the saved leaves' paths are not ``state_like``'s."""
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
    with np.load(d / "arrays.npz") as data:
        leaves = [torch.from_numpy(data[f"a{i}"]).to(dev) for i in range(len(paths))]
    return unflatten(state_like, leaves), manifest["extra"]
