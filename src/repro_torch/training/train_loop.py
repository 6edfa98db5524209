"""Train-step factory (port of ``repro/training/train_loop.py``): the
loss's value and gradients by autograd, gradient accumulation over
micro-batches in float32, optional int8 gradient compression, and the
AdamW update.

On a mesh (``make_train_step(..., mesh=, layout=)``) the step is the
reference's sharded one, ``jax.jit`` of the same step with its inputs
placed by the train specs and ``grad_specs`` pinning the float32
accumulator to the parameters' blocks (``repro/training/train_loop.py:
50-120``): each rank holds its blocks of the parameters and both moments
(:class:`repro_torch.distributed.fsdp.FSDP`), each micro-batch's gradients
are reduce-scattered into float32 block accumulators, and the update runs
on the blocks. ``grad_specs`` names that placement; the port accepts only
the parameters' train specs, the one placement its gradients take.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.transformer import (
    ModelConfig,
    init_params,
    layer_slots,
    loss_fn,
    params_from_numpy,
    params_to_numpy,
    stacked_leaf,
    stacked_tree,
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


def quantize_grads_int8(grads, cfg: ModelConfig, shards=None):
    """Symmetric int8 quantization with one scale per stacked leaf of the
    reference's tree (``repro/training/train_loop.py:24-41``): ``amax / 127``
    with ``amax`` taken over every repeat of the leaf's stage, so the
    layers of one stage share their scale. Returns ``(q, scales)``, trees of
    ``grads``'s structure: int8 values and 0-d float32 scales. With
    ``shards`` (the training context) the leaves are this rank's blocks and
    each ``amax`` is the global one: the ranks' maxima reduced by one
    ``all_reduce(MAX)`` over every rank."""
    slots = layer_slots(cfg)
    paths, gs = flatten(grads)
    keys = [stacked_leaf(p, g.ndim, slots)[0] for p, g in zip(paths, gs)]
    amax: Dict = {}
    for key, g in zip(keys, gs):
        a = torch.max(torch.abs(g))
        amax[key] = a if key not in amax else torch.maximum(amax[key], a)
    if shards is not None:
        glob = shards.sum_world(torch.stack(list(amax.values())), op=dist.ReduceOp.MAX)
        amax = dict(zip(amax, glob.unbind()))
    scales = {key: (a + 1e-12) / 127.0 for key, a in amax.items()}
    q = [torch.clamp(torch.round(g / scales[key]), -127, 127).to(torch.int8)
         for key, g in zip(keys, gs)]
    return unflatten(grads, q), unflatten(grads, [scales[key] for key in keys])


def dequantize_grads(qg, scales):
    """``q * scale`` per leaf, float32."""
    return unflatten(qg, [q.float() * s for q, s in zip(flatten(qg)[1], flatten(scales)[1])])


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[OptConfig] = None, grad_accum: int = 1,
                    compress_grads: bool = False, grad_specs=None, mesh=None,
                    layout: Optional[str] = None) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``. ``grad_accum > 1`` splits the batch into that many
    micro-batches run one after another, their float32 gradients summed and
    averaged (metrics then ``{"ce": mean loss, "aux": 0}``, as the
    reference's). ``compress_grads`` passes the gradients through
    :func:`quantize_grads_int8` and back before the update. The parameters
    and the optimizer state are updated in place (:func:`adamw_update`);
    ``metrics`` (``ce``, ``aux``, ``loss``, ``lr``, ``grad_norm``) are 0-d
    tensors on the device, read by nothing on the host.

    With ``mesh`` (and ``layout``, by default :func:`repro_torch.
    distributed.sharding.choose_layout`'s) the step is the sharded one:
    ``params`` and ``opt_state``'s moments are this rank's float32 blocks
    under ``param_specs(..., mode="train")`` (:meth:`repro_torch.
    distributed.fsdp.FSDP.block`; others are refused), ``batch`` is the
    global batch, the same on every rank, and each micro-batch runs on this
    rank's rows of it (``_resolve("dp", ...)`` under ``activation_mesh(mesh,
    dp=dp_axes(mesh, layout))``). Each micro-batch's gradients arrive
    reduce-scattered into this rank's blocks and are summed into float32
    block accumulators; the clip reads the global norm, the compressed
    path's scales are global, and the metrics are the global values, the
    same on every rank. ``grad_specs``, where given, must be those train
    specs (a tree of :class:`repro_torch.distributed.sharding.P`), else
    ``ValueError``. A recurrent layer kind under ``"2d"`` with ``model``
    larger than 1 raises ``NotImplementedError``. Without a mesh nothing
    of this runs and ``grad_specs`` must be None."""
    opt_cfg = opt_cfg or OptConfig()
    if mesh is None:
        if grad_specs is not None:
            raise ValueError("grad_specs places the gradients on a mesh; no mesh was given")
        return _step(cfg, opt_cfg, grad_accum, compress_grads, make_loss(cfg), None, None)
    from repro_torch.distributed.fsdp import FSDP
    from repro_torch.distributed.hints import activation_mesh
    from repro_torch.distributed.sharding import choose_layout, dp_axes, spec_paths

    layout = layout or choose_layout(cfg)
    probe = FSDP(cfg, mesh, layout)          # refuses what the port cannot shard
    if grad_specs is not None and spec_paths(grad_specs) != probe.train:
        raise ValueError("grad_specs must be the parameters' train specs "
                         "(param_specs(..., mode='train')): the gradients' blocks are theirs")
    contexts: Dict[int, FSDP] = {}

    def context(rows: int) -> FSDP:
        if rows not in contexts:
            contexts[rows] = FSDP(cfg, mesh, layout, rows)
        return contexts[rows]

    def train_step(params, opt_state, batch):
        with activation_mesh(mesh, dp=dp_axes(mesh, layout)):
            ctx = context(batch["tokens"].shape[0] // grad_accum)
            ctx.check(params)
            return _step(cfg, opt_cfg, grad_accum, compress_grads,
                         lambda p, b: loss_fn(p, cfg, b, tp=ctx), ctx,
                         ctx.own_batch)(params, opt_state, batch)

    return train_step


def _step(cfg: ModelConfig, opt_cfg: OptConfig, grad_accum: int, compress_grads: bool,
          loss: Callable, shards, rows: Optional[Callable]) -> Callable:
    """The step on one device (``shards`` None) or on this rank's blocks
    (``shards`` the training context, ``rows`` cutting its rows of each
    micro-batch, the metrics summed over the batch's ranks)."""
    def train_step(params, opt_state, batch):
        if grad_accum == 1:
            (l, metrics), grads = value_and_grad(loss, params, batch if rows is None
                                                 else rows(batch))
        else:
            mb = batch["tokens"].shape[0] // grad_accum
            acc, lsum = None, torch.zeros((), dtype=torch.float32,
                                          device=batch["tokens"].device)
            for i in range(grad_accum):
                mbatch = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                (l, _), g = value_and_grad(loss, params, mbatch if rows is None
                                           else rows(mbatch))
                g = flatten(g)[1]
                if acc is None:
                    acc = [torch.zeros(x.shape, dtype=torch.float32, device=x.device) for x in g]
                for a, x in zip(acc, g):       # in place: one float32 copy of the gradients
                    a.add_(x.float())
                del g
                lsum = lsum + l
            grads = unflatten(params, [a / grad_accum for a in acc])
            l = lsum / grad_accum
            metrics = {"ce": l, "aux": torch.zeros_like(l)}
        if shards is not None:
            total = shards.sum_rows(torch.stack([l, metrics["ce"], metrics["aux"]]))
            l, metrics = total[0], {"ce": total[1], "aux": total[2]}
        if compress_grads:
            grads = dequantize_grads(*quantize_grads_int8(grads, cfg, shards))
        params, opt_state, opt_metrics = adamw_update(grads, opt_state, params, opt_cfg, shards)
        return params, opt_state, dict(metrics, loss=l, **opt_metrics)

    return train_step


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     device: DeviceLike = "cuda", shard: Optional[Callable] = None):
    """Float32 master weights drawn from ``generator``
    (:func:`repro_torch.models.init_params`) and their zero AdamW state.
    With ``shard(path, leaf)`` (a rank's :meth:`repro_torch.distributed.
    fsdp.FSDP.block`) each leaf is drawn whole, its block kept and the rest
    freed, one leaf at a time: the rank's blocks and their moments."""
    params = init_params(cfg, generator, device=resolve_device(device), dtype=torch.float32,
                         shard=shard)
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


def train_state_shardings(params, opt_state: Dict, cfg: ModelConfig, specs):
    """A rank's training state for a sharded checkpoint: ``(state,
    shardings)`` in the reference's layout (:func:`train_state_to_numpy`'s
    tree), ``state``'s leaves functions returning this rank's block of
    each stacked leaf (its layers' blocks stacked when called, so one
    stacked block lives at a time) and ``shardings`` their specs: a layer's
    train spec (``specs``, the port's tree of
    :class:`repro_torch.distributed.sharding.P`) behind the repeats'
    ``None``. Save it with ``save_checkpoint(..., shardings=, mesh=)``;
    ``restore_checkpoint`` with the specs of another mesh gives that mesh's
    blocks, which :func:`train_state_from_numpy` turns back into the port's
    layout."""
    from repro_torch.distributed.sharding import P

    def thunks(tree):
        return stacked_tree(tree, cfg, lambda nodes: (lambda: torch.stack(nodes)),
                            lambda t: (lambda: t))

    moments = stacked_tree(specs, cfg, lambda nodes: P(None, *nodes[0]), lambda s: s)
    state = {"params": thunks(params),
             "opt": {"m": thunks(opt_state["m"]), "v": thunks(opt_state["v"]),
                     "step": lambda: opt_state["step"]}}
    return state, {"params": moments, "opt": {"m": moments, "v": moments, "step": P()}}
