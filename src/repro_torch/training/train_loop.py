"""Train-step factory (port of ``repro/training/train_loop.py``): the
loss's value and gradients by autograd, gradient accumulation over
micro-batches in float32, optional int8 gradient compression, and the
AdamW update.

The reference's ``grad_specs`` (the accumulator's sharding on a mesh)
belongs to the distributed port and is left out.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.transformer import (
    ModelConfig,
    init_params,
    layer_slots,
    loss_fn,
    params_from_numpy,
    params_to_numpy,
    stacked_leaf,
)
from .optimizer import (
    OptConfig,
    adamw_init,
    adamw_update,
    opt_state_from_numpy,
    opt_state_to_numpy,
)
from .tree import flatten, unflatten


def make_loss(cfg: ModelConfig) -> Callable:
    """``f(params, batch) -> (loss, {"ce", "aux"})``."""
    def f(params, batch):
        return loss_fn(params, cfg, batch)

    return f


def value_and_grad(loss: Callable, params, batch):
    """``((loss, metrics), grads)``: ``loss(params, batch)`` and its
    gradient with respect to every parameter (``jax.value_and_grad(...,
    has_aux=True)``), a tree of ``params``'s structure (zeros for a leaf the
    loss does not reach). The parameters themselves carry no gradient
    state: the loss runs on detached views of them."""
    _, leaves = flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        value, metrics = loss(unflatten(params, live), batch)
        grads = torch.autograd.grad(value, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(live, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (value.detach(), metrics), unflatten(params, grads)


def quantize_grads_int8(grads, cfg: ModelConfig):
    """Symmetric int8 quantization with one scale per stacked leaf of the
    reference's tree (``repro/training/train_loop.py:24-41``): ``amax / 127``
    with ``amax`` taken over every repeat of the leaf's stage, so the
    layers of one stage share their scale. Returns ``(q, scales)``, trees of
    ``grads``'s structure: int8 values and 0-d float32 scales."""
    slots = layer_slots(cfg)
    paths, gs = flatten(grads)
    keys = [stacked_leaf(p, g.ndim, slots)[0] for p, g in zip(paths, gs)]
    amax: Dict = {}
    for key, g in zip(keys, gs):
        a = torch.max(torch.abs(g))
        amax[key] = a if key not in amax else torch.maximum(amax[key], a)
    scales = {key: (a + 1e-12) / 127.0 for key, a in amax.items()}
    q = [torch.clamp(torch.round(g / scales[key]), -127, 127).to(torch.int8)
         for key, g in zip(keys, gs)]
    return unflatten(grads, q), unflatten(grads, [scales[key] for key in keys])


def dequantize_grads(qg, scales):
    """``q * scale`` per leaf, float32."""
    return unflatten(qg, [q.float() * s for q, s in zip(flatten(qg)[1], flatten(scales)[1])])


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[OptConfig] = None, grad_accum: int = 1,
                    compress_grads: bool = False) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``. ``grad_accum > 1`` splits the batch into that many
    micro-batches run one after another, their float32 gradients summed and
    averaged (metrics then ``{"ce": mean loss, "aux": 0}``, as the
    reference's). ``compress_grads`` passes the gradients through
    :func:`quantize_grads_int8` and back before the update. The parameters
    and the optimizer state are updated in place (:func:`adamw_update`);
    ``metrics`` (``ce``, ``aux``, ``loss``, ``lr``, ``grad_norm``) are 0-d
    tensors on the device, read by nothing on the host."""
    opt_cfg = opt_cfg or OptConfig()
    loss = make_loss(cfg)

    def train_step(params, opt_state, batch):
        if grad_accum == 1:
            (l, metrics), grads = value_and_grad(loss, params, batch)
        else:
            mb = batch["tokens"].shape[0] // grad_accum
            acc, lsum = None, torch.zeros((), dtype=torch.float32,
                                          device=batch["tokens"].device)
            for i in range(grad_accum):
                mbatch = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                (l, _), g = value_and_grad(loss, params, mbatch)
                g = flatten(g)[1]
                if acc is None:
                    acc = [torch.zeros(x.shape, dtype=torch.float32, device=x.device) for x in g]
                acc = [a + x.float() for a, x in zip(acc, g)]
                lsum = lsum + l
            grads = unflatten(params, [a / grad_accum for a in acc])
            l = lsum / grad_accum
            metrics = {"ce": l, "aux": torch.zeros_like(l)}
        if compress_grads:
            grads = dequantize_grads(*quantize_grads_int8(grads, cfg))
        params, opt_state, opt_metrics = adamw_update(grads, opt_state, params, opt_cfg)
        return params, opt_state, dict(metrics, loss=l, **opt_metrics)

    return train_step


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     device: DeviceLike = "cuda"):
    """Float32 master weights drawn from ``generator``
    (:func:`repro_torch.models.init_params`) and their zero AdamW state."""
    params = init_params(cfg, generator, device=resolve_device(device), dtype=torch.float32)
    return params, adamw_init(params)


def train_state_to_numpy(params, opt_state: Dict, cfg: ModelConfig) -> Dict:
    """``{"params", "opt"}`` in the reference's layout on the host: the tree
    a checkpoint stores (``repro/launch/train.py`` saves the same)."""
    return {"params": params_to_numpy(params, cfg), "opt": opt_state_to_numpy(opt_state, cfg)}


def train_state_from_numpy(tree: Dict, cfg: ModelConfig, device: DeviceLike = "cuda"):
    """``(params, opt_state)`` on ``device`` from a :func:`train_state_to_numpy`
    tree (or a restored checkpoint's): float32 master weights and moments."""
    dev = resolve_device(device)
    return (params_from_numpy(tree["params"], cfg, dev, dtype=torch.float32),
            opt_state_from_numpy(tree["opt"], cfg, dev))
