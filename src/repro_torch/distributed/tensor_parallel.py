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
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import param_specs, spec_paths
from repro_torch.launch.mesh import axis_group, axis_index, axis_size, mesh_axes
from repro_torch.models import LayerShards, ModelConfig, init_params
from repro_torch.training.tree import flatten


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
                  rows=self if self.n_rows > 1 else None)
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
        same bits."""
        y = x.to(torch.float32, copy=True)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=self.model_group)
        return y.to(x.dtype)

    def embed(self, w: torch.Tensor, tokens: torch.Tensor, scale: float) -> torch.Tensor:
        """The vocabulary-parallel lookup times ``scale``, float32: this
        rank gathers the rows of ``w`` (its block of the vocabulary) that
        the tokens hit and writes zero for the others, then one
        ``all_reduce(SUM)`` over ``model``. Each element's sum has one
        non-zero term, so it is exact."""
        start = self.model_index * w.shape[0]
        local = tokens.long() - start
        mine = (local >= 0) & (local < w.shape[0])
        x = w[local.clamp(0, w.shape[0] - 1)].to(torch.bfloat16).float() * scale
        x = torch.where(mine[..., None], x, torch.zeros((), device=x.device))
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.model_group)
        return x

    def logits(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """The vocabulary-parallel logits: ``x @ w`` over this rank's block
        of columns in bf16, widened to float32, then the blocks gathered
        over ``model`` in rank order (``all_gather``) into the whole
        vocabulary."""
        part = (x.to(torch.bfloat16) @ w.to(torch.bfloat16)).float().contiguous()
        blocks = [torch.empty_like(part) for _ in range(self.n_model)]
        dist.all_gather(blocks, part, group=self.model_group)
        return torch.cat(blocks, dim=-1)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every data rank's rows of ``x`` in the global batch's order
        (``all_gather`` over the batch's axes): the MoE routes, drops and
        fills its capacity over the global batch, as the reference's
        ``moe_forward`` sees it."""
        x = x.contiguous()
        blocks = [torch.empty_like(x) for _ in range(self.n_rows)]
        dist.all_gather(blocks, x, group=self.row_group)
        return torch.cat(blocks, dim=0)

    def own_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global-batch tensor (the inverse of
        :meth:`gather_rows`)."""
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
