"""Tensor-parallel serving (plan ``heads``): the collectives XLA derives
from the reference's parameter specs, on ``torch.distributed``.

In the reference the serve cells are ``jax.jit`` of ``make_prefill_step``
and ``make_serve_step`` with the parameters placed by ``param_specs(...,
mode="serve")`` (``repro/launch/dryrun.py:134-169``), and XLA shards the
step Megatron-style from those specs: column-parallel ``wq``/``wk``/``wv``
and FFN up-projections, row-parallel ``wo``/``wd``, the vocabulary split
over ``model``, the experts split over ``model`` where they divide it (EP)
or their hidden width where they do not (expert-TP). Here each rank runs
the model on its own blocks (:func:`repro_torch.distributed.sharding.
shard_tree`) and calls the collectives below where XLA would insert them:

* :meth:`TensorParallel.row_sum` -- the row-parallel reduction of a
  partial product over the ``model`` group;
* :meth:`TensorParallel.embed` -- the vocabulary-parallel lookup;
* :meth:`TensorParallel.logits` -- the vocabulary-parallel unembedding,
  its column blocks gathered over ``model``;
* :meth:`TensorParallel.gather_rows` / :meth:`TensorParallel.own_rows` --
  the MoE's routing over the global batch where the batch splits over the
  data axes.

What a rank computes is read from the spec of each leaf
(:meth:`TensorParallel.layer`): a leaf that the policy leaves whole (its
dimension does not divide ``model``) is computed whole and not reduced.
With no mesh the model takes ``tp=None`` and none of these runs.

Training (:mod:`repro_torch.distributed.fsdp`) differentiates through the
same collectives, so each is a ``torch.autograd.Function`` with the
backward rule of the function it computes. Every rank of a ``model`` group
holds the same replicated loss and starts its backward from it; a rule that
summed the cotangent over ``model`` again (as ``torch.distributed.nn.
functional.all_reduce``'s backward does) would count every tensor-parallel
gradient ``model`` times. The rules:

* :meth:`TensorParallel.row_sum` -- forward the sum, backward the identity
  (each partial's cotangent is the sum's);
* :meth:`TensorParallel.enter` -- a replicated activation entering
  column-parallel weights: forward the identity, backward the sum over
  ``model`` of the ranks' partial cotangents;
* :meth:`TensorParallel.embed` -- forward the sum, backward the identity,
  so each rank's lookup sends its rows' gradient;
* :meth:`TensorParallel.logits` -- forward the gather of the column
  blocks, backward the rank's own block (its input enters by
  :meth:`TensorParallel.enter`);
* :meth:`TensorParallel.gather_rows` -- forward the gather over the batch's
  axes, backward the reduce-scatter sum;
* :meth:`TensorParallel.own_rows` -- forward a slice, backward zero-padded
  (``narrow``'s own rule).

Serving runs them forward only: their forwards are the serving
collectives, bit for bit.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import param_specs, spec_paths
from repro_torch.launch.mesh import axis_group, axis_index, axis_size, mesh_axes
from repro_torch.models import LayerShards, ModelConfig, init_params
from repro_torch.training.tree import flatten


# Instrumentation of the training collectives: None (off), or a dict that
# :func:`timed` fills with ``{category: [calls, bytes, seconds]}`` -- each
# collective between two device syncs on the host clock, its bytes those
# of the tensor it was handed (an all-gather's output, a reduce-scatter's
# input, an all-reduce's tensor).
collective_stats: Optional[dict] = None


def timed(category: str, nbytes: int, fn: Callable, *args, **kw):
    """``fn(*args, **kw)``, counted under ``category`` in
    :data:`collective_stats` where it is set."""
    if collective_stats is None:
        return fn(*args, **kw)
    import time

    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    sync()
    entry = collective_stats.setdefault(category, [0, 0, 0.0])
    entry[0] += 1
    entry[1] += int(nbytes)
    entry[2] += time.perf_counter() - t0
    return out


def _all_reduce(x: torch.Tensor, group) -> None:
    timed("tp", x.numel() * x.element_size(), dist.all_reduce, x, op=dist.ReduceOp.SUM,
          group=group)


class _Sum(torch.autograd.Function):
    """Forward: ``x`` widened to float32 (a copy) and summed over ``group``
    by one ``all_reduce``. Backward: the identity."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.dtype = x.dtype
        y = x.to(torch.float32, copy=True)
        _all_reduce(y, group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


class _Enter(torch.autograd.Function):
    """Forward: the identity. Backward: the cotangent summed over
    ``group`` (float32, one ``all_reduce``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _all_reduce(g, ctx.group)
        return g, None


class _Gather(torch.autograd.Function):
    """Forward: the ranks' blocks of ``x`` along ``dim`` gathered over
    ``group`` in rank order (``all_gather``). Backward: this rank's block of
    the cotangent along ``dim``, summed over the group first where ``sum``
    is set (``reduce_scatter``), else sliced."""

    @staticmethod
    def forward(ctx, x, group, n, index, dim, sum_):
        ctx.group, ctx.n, ctx.index, ctx.dim, ctx.sum = group, n, index, dim, sum_
        return timed("tp", x.numel() * x.element_size() * n, all_gather, x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum:
            g = timed("tp", g.numel() * g.element_size(), reduce_scatter, g, ctx.group, ctx.n,
                      ctx.dim)
        else:
            g = g.narrow(ctx.dim, ctx.index * (g.shape[ctx.dim] // ctx.n),
                         g.shape[ctx.dim] // ctx.n)
        return g, None, None, None, None, None


def all_gather(x: torch.Tensor, group, n: int, dim: int = 0) -> torch.Tensor:
    """The ``n`` ranks' blocks of ``x`` over ``group``, concatenated along
    ``dim`` in rank order: gathered into one buffer, which along the first
    dimension is the result itself."""
    x = x.contiguous()
    out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    dist.all_gather(list(out.unbind(0)), x, group=group)
    if dim % x.ndim == 0:
        return out.flatten(0, 1)
    return torch.cat(out.unbind(0), dim=dim)


def reduce_scatter(x: torch.Tensor, group, n: int, dim: int = 0) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``x`` over ``group``
    (``n`` ranks): one ``reduce_scatter_tensor`` on the dimension moved to
    the front."""
    if dim != 0:
        x = x.movedim(dim, 0)
    x = x.contiguous()
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim) if dim != 0 else out


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class TensorParallel:
    """One rank's tensor-parallel context: the mesh, the whole model's
    parameter shapes (``like``, e.g. :func:`abstract_params`), their specs
    (``param_specs(..., mode="serve")``) and the batch's spec (the plan's
    ``batch_spec``). Build it with :func:`tensor_parallel`."""

    def __init__(self, mesh, like, specs, batch_spec):
        self.paths = spec_paths(specs)
        # each leaf's block shape, in flatten order
        self.blocks = {path: tuple(n // (axis_size(mesh, _axes(a)) if a else 1)
                                   for n, a in zip(leaf.shape, self.paths[path]))
                       for path, leaf in zip(*flatten(like))}
        sizes = mesh_axes(mesh)
        self.n_model = sizes.get("model", 1)
        self.model_index = axis_index(mesh, "model") if self.n_model > 1 else 0
        self.model_group = axis_group(mesh, "model") if self.n_model > 1 else None
        self.row_axes = _axes(batch_spec)
        self.n_rows = axis_size(mesh, self.row_axes) if self.row_axes else 1
        self.row_index = axis_index(mesh, self.row_axes) if self.n_rows > 1 else 0
        self.row_group = axis_group(mesh, self.row_axes) if self.n_rows > 1 else None
        # the gathers place each rank's block by its rank in the group: it
        # must be its index along the axes (row-major, as shard_of cuts)
        for group, index in ((self.model_group, self.model_index),
                             (self.row_group, self.row_index)):
            if group is not None and dist.get_rank(group) != index:
                raise RuntimeError(f"rank {dist.get_rank()} is {dist.get_rank(group)} in its "
                                   f"group but at index {index} along the mesh's axes")

    # ------------------------------------------------------------ specs
    def split(self, path: str, dim: int) -> bool:
        """Whether dimension ``dim`` of the leaf at ``path`` splits over
        ``model`` (on more than one rank)."""
        return self.n_model > 1 and "model" in _axes(self.paths[path][dim])

    def _sum_if(self, path: str, dim: int) -> Optional[Callable]:
        return self.row_sum if path in self.paths and self.split(path, dim) else None

    def layer(self, i: int, p: dict) -> LayerShards:
        """Layer ``i``'s :class:`LayerShards` (``p``: its parameters, for
        the number of experts this rank holds)."""
        pre = f"layers/{i}"
        kw = dict(attn=self._sum_if(f"{pre}/attn/wo", 0), xattn=self._sum_if(f"{pre}/xattn/wo", 0),
                  ffn=self._sum_if(f"{pre}/ffn/wd", 0),
                  shared=self._sum_if(f"{pre}/moe/shared/wd", 0),
                  rows=self if self.n_rows > 1 else None,
                  enter=self.enter if self.n_model > 1 else None)
        if "moe" in p:
            ep = self.split(f"{pre}/moe/wg", 0)
            if ep or self.split(f"{pre}/moe/wg", 2):
                kw["moe"] = self.row_sum
            if ep:
                kw["expert_offset"] = self.model_index * p["moe"]["wg"].shape[0]
        return LayerShards(**kw)

    def check(self, params) -> None:
        """Refuse parameters whose leaves are not this rank's blocks of the
        whole model's under the specs: a leaf the spec splits must not
        arrive whole."""
        paths, leaves = flatten(params)
        if paths != list(self.blocks):
            raise ValueError("the parameters' tree differs from the specs'")
        for path, leaf in zip(paths, leaves):
            if tuple(leaf.shape) != self.blocks[path]:
                raise ValueError(f"{path}: {tuple(leaf.shape)} is not this rank's block "
                                 f"{self.blocks[path]} under {self.paths[path]}")

    # ------------------------------------------------------- collectives
    def row_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The row-parallel reduction: each rank holds a partial product
        over its block of the contracted dimension; the partials (bf16
        products, or the MoE's float32 combine) are widened to float32,
        summed in float32 by one ``all_reduce`` over the ``model`` group,
        and rounded once to ``x``'s dtype. Every rank of the group gets the
        same bits. Backward: the identity."""
        return _Sum.apply(x, self.model_group).to(x.dtype)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated tensor entering this rank's column-parallel block
        (the normed residual before ``wq``/``wk``/``wv`` or an FFN's
        ``wg``/``wu``, the MoE's expert input and routing weights, the
        hidden state before the vocabulary-parallel logits, a whole
        ``q_norm`` applied to this rank's heads): ``x`` itself; its
        gradient, each rank's partial, summed over ``model``."""
        return _Enter.apply(x, self.model_group)

    def embed(self, w: torch.Tensor, tokens: torch.Tensor, scale: float) -> torch.Tensor:
        """The vocabulary-parallel lookup times ``scale``, float32: this
        rank gathers the rows of ``w`` (its block of the vocabulary) that
        the tokens hit and writes zero for the others, then one
        ``all_reduce(SUM)`` over ``model``. Each element's sum has one
        non-zero term, so it is exact. Backward: each rank's rows get the
        whole cotangent of their tokens."""
        start = self.model_index * w.shape[0]
        local = tokens.long() - start
        mine = (local >= 0) & (local < w.shape[0])
        x = w[local.clamp(0, w.shape[0] - 1)].to(torch.bfloat16).float() * scale
        x = torch.where(mine[..., None], x, torch.zeros((), device=x.device))
        return _Sum.apply(x, self.model_group)

    def logits(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """The vocabulary-parallel logits: ``x @ w`` over this rank's block
        of columns in bf16, widened to float32, then the blocks gathered
        over ``model`` in rank order (``all_gather``) into the whole
        vocabulary. Backward: this rank's columns of the cotangent, and
        ``x``'s partial summed over ``model`` (:meth:`enter`)."""
        part = (self.enter(x).to(torch.bfloat16) @ w.to(torch.bfloat16)).float()
        return _Gather.apply(part, self.model_group, self.n_model, self.model_index, -1, False)

    def looks_up(self) -> bool:
        """Whether :meth:`embed` does the token lookup (the embedding
        split by vocabulary), rather than indexing a whole table."""
        return self.split("embed", 0)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every data rank's rows of ``x`` in the global batch's order
        (``all_gather`` over the batch's axes): the MoE routes, drops and
        fills its capacity over the global batch, as the reference's
        ``moe_forward`` sees it. Backward: the cotangents of the global
        rows summed over the batch's ranks, each rank keeping its rows'
        (``reduce_scatter``)."""
        return _Gather.apply(x, self.row_group, self.n_rows, self.row_index, 0, True)

    def own_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global-batch tensor (the inverse of
        :meth:`gather_rows`); its backward pads the cotangent with zeros."""
        n = x.shape[0] // self.n_rows
        return x.narrow(0, self.row_index * n, n)


def abstract_params(cfg: ModelConfig):
    """The whole model's parameter shapes as ``meta`` tensors (bf16 matmul
    weights): what the specs are computed on, drawing nothing."""
    return init_params(cfg, torch.Generator(), device="meta")


def tensor_parallel(cfg: ModelConfig, mesh, plan: dict, layout: str) -> TensorParallel:
    """The context of plan ``heads`` (``plan`` from :func:`repro_torch.
    distributed.sharding.decode_plan` with the same ``layout``): the
    parameters' serve specs on the whole model's shapes. Under ``heads``
    every attention block's q and KV heads split into whole heads over
    ``model`` (both counts divide it), so each rank holds whole GQA groups;
    anything else is refused."""
    if plan["mode"] != "heads":
        raise ValueError(f"tensor-parallel execution is plan 'heads', not {plan['mode']!r}")
    m = mesh_axes(mesh).get("model", 1)
    if cfg.n_heads % m or cfg.n_kv_heads % m:
        raise ValueError(f"{cfg.name}: {cfg.n_heads} q and {cfg.n_kv_heads} KV heads do not "
                         f"split into whole heads over model={m}")
    like = abstract_params(cfg)
    return TensorParallel(mesh, like, param_specs(like, mesh, cfg, layout, mode="serve"),
                          plan["batch_spec"])
