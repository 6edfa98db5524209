"""AdamW with decoupled weight decay, a cosine learning-rate schedule with
linear warm-up, and global-norm clipping (port of ``repro/training/
optimizer.py``). Plain functions over the port's parameter dicts; the
arithmetic is float32, op for op as the reference writes it.

The one rule that reads a parameter's shape -- weight decay on matrices
only, ``p.ndim >= 2`` (``optimizer.py:69``) -- is the reference's rule on
its *stacked* leaves: every leaf of a layer has a leading ``reps`` axis
there, so a layer's norms (``ln1``, ``ln2``, ``q_norm``, ``lam``, ``b_if``,
...: ``(reps, D)``) are decayed and only the 0-d ``xgate`` (``(reps,)``)
and the top-level ``final_norm`` ``(D,)`` are not. The port's ``layers``
list has no such axis, so :func:`adamw_update` reads each leaf's rank in
the stacked tree (:func:`repro_torch.models.transformer.stacked_leaf`).

Unlike the reference, which returns new trees, :func:`adamw_update`
updates the parameters and the moments in place (under ``no_grad``), as a
step with donated buffers does: at full width the state is 16 bytes a
parameter, and a second copy of it would not fit the card.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.transformer import (
    ModelConfig,
    params_from_numpy,
    params_to_numpy,
    stacked_leaf,
)
from .tree import flatten


@dataclass(frozen=True)
class OptConfig:
    """Copy of ``repro.training.optimizer.OptConfig``."""

    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000


def adamw_init(params) -> Dict:
    """``{"m", "v"}``: float32 zeros shaped like every parameter (the
    reference's ``zeros_like`` of its float32 master weights), and
    ``"step"``, a 0-d int32 tensor, on the parameters' device."""
    def zeros(node):
        if isinstance(node, dict):
            return {k: zeros(v) for k, v in node.items()}
        if isinstance(node, list):
            return [zeros(v) for v in node]
        return torch.zeros(node.shape, dtype=torch.float32, device=node.device)

    dev = flatten(params)[1][0].device
    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a 0-d integer tensor), float32:
    linear warm-up over ``warmup_steps``, then a cosine from ``lr`` down to
    a tenth of it at ``total_steps``."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree, shards=None) -> torch.Tensor:
    """``sqrt(sum of every element squared)`` over the tree, float32, the
    leaves' sums added in flatten order.

    With ``shards`` (the training context, :class:`repro_torch.distributed.
    fsdp.FSDP`) the leaves are this rank's blocks: each rank sums the
    squares of the blocks it owns (``shards.owns(path)``: an element that
    several ranks hold -- a whole norm, a dimension that does not split --
    counts once, on the first of its replicas), then one ``all_reduce``
    over every rank (``shards.sum_world``) gives the global norm, the same
    on every rank."""
    if shards is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in flatten(tree)[1]))
    paths, leaves = flatten(tree)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for path, x in zip(paths, leaves):
        if shards.owns(path):
            total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(shards.sum_world(total))


@torch.no_grad()
def adamw_update(grads, opt_state: Dict, params, cfg: OptConfig, shards=None):
    """One AdamW step (``repro/training/optimizer.py:53-77``): the gradients
    clipped to ``clip_norm`` by their global norm, the moments advanced,
    the bias-corrected update plus ``weight_decay * p`` on the leaves whose
    stacked rank is at least 2, times the step's learning rate. Updates
    ``params`` and ``opt_state`` in place and returns ``(params, opt_state,
    {"lr", "grad_norm"})``. The parameters are float32 master weights.
    With ``shards`` (the training context) every tree holds this rank's
    blocks: the update is elementwise, so it runs on them unchanged, and
    the clip reads the global norm (:func:`global_norm`)."""
    step = opt_state["step"] + 1
    lr = lr_at(cfg, step)
    gnorm = global_norm(grads, shards)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - torch.pow(b1, step.to(torch.float32))
    c2 = 1.0 - torch.pow(b2, step.to(torch.float32))
    paths, ps = flatten(params)
    for path, p, g, m, v in zip(paths, ps, flatten(grads)[1], flatten(opt_state["m"])[1],
                                flatten(opt_state["v"])[1]):
        # each in-place op rounds as the reference's out-of-place one
        gs = g.float() * scale
        m.mul_(b1).add_((1 - b1) * gs)
        t = (1 - b2) * gs
        v.mul_(b2).add_(t.mul_(gs))
        del gs
        t = torch.div(v, c2).sqrt_().add_(cfg.eps)
        delta = torch.div(m, c1).div_(t)
        del t
        assert p.dtype == torch.float32, f"{path}: {p.dtype} is not a float32 master weight"
        if stacked_leaf(path, p.ndim)[1] >= 2:   # decoupled weight decay on matrices only
            delta.add_(cfg.weight_decay * p)
        p.sub_(delta.mul_(lr))
    opt_state["step"] = step
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}


def opt_state_to_numpy(opt_state: Dict, cfg: ModelConfig) -> Dict:
    """The reference's optimizer state tree on the host: ``m`` and ``v`` in
    its stacked layout (:func:`repro_torch.models.params_to_numpy`),
    ``step`` a 0-d int32 array."""
    return {"m": params_to_numpy(opt_state["m"], cfg), "v": params_to_numpy(opt_state["v"], cfg),
            "step": np.asarray(int(opt_state["step"]), dtype=np.int32)}


def opt_state_from_numpy(tree, cfg: ModelConfig, device: DeviceLike = "cuda") -> Dict:
    """The port's optimizer state from the reference's tree (numpy arrays
    or tensors), float32 moments on ``device``."""
    dev = resolve_device(device)
    step = tree["step"]
    step = step if torch.is_tensor(step) else torch.from_numpy(np.asarray(step))
    return {"m": params_from_numpy(tree["m"], cfg, dev, dtype=torch.float32),
            "v": params_from_numpy(tree["v"], cfg, dev, dtype=torch.float32),
            "step": step.to(device=dev, dtype=torch.int32)}
