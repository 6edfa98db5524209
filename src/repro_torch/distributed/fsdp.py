"""FSDP x TP training: what XLA derives from the reference's train specs,
on ``torch.distributed``.

In the reference the sharded train step is ``jax.jit(make_train_step(...,
grad_specs=to_named(pspec, mesh)))`` with the float32 parameters and both
AdamW moments placed by ``param_specs(params, mesh, cfg, layout)`` (mode
``"train"``: FSDP puts each leaf's largest non-TP dimension over ``data``,
TP puts heads, ``d_ff``, the vocabulary or the experts over ``model``;
norms stay whole) and the batch by ``batch_specs`` (``repro/launch/
dryrun.py:110-132``). Here each rank holds its float32 block of every leaf,
and of ``m`` and ``v``, under those specs (:meth:`FSDP.block`), and the
model runs on the serve-layout blocks -- the train spec with ``data``
stripped, exactly what :class:`~repro_torch.distributed.tensor_parallel.
TensorParallel` computes with:

* at use, :meth:`FSDP.use_bucket` gathers the leaves' ``data`` blocks
  (one ``all_gather`` of a layer's blocks). The model gathers each stage
  unit's layers inside the unit's checkpoint (:func:`repro_torch.models.
  forward_hidden`), so the gathered weights live only while the unit runs
  and are gathered again when the backward recomputes the unit; nothing
  gathers the whole model at the start of a step;
* the gather's backward turns the gradient of the serve-layout block into
  the float32 gradient of this rank's block: summed over the axes the
  **batch** splits on and scattered over the axes the **leaf** splits on
  (:meth:`FSDP.grad_bucket`). A TP block is never summed over ``model``;
  a leaf that is whole (a norm) is summed over the batch's axes only. That
  is what ``grad_specs`` asks of XLA: each micro-batch's gradients
  reduce-scattered into the FSDP blocks;
* the matmul weights (:data:`BF16_GATHER`) are gathered as bf16: each is
  cast to bf16 exactly once where it is used (``w.to(bf16)`` before its one
  matmul or einsum), and a cast before the gather gives the same bits as
  one after it, at half the bytes. The embedding's lookup gathers only
  the rows its tokens hit, in float32 (:meth:`FSDP.embed`: the gradient
  sums repeated tokens in float32, as on one device). The unembedding is
  gathered once for the loss, as bf16, and its chunks' bf16 gradients are
  summed into one float32 gradient (:class:`repro_torch.models.
  transformer._SplitCE`), the sum that each chunk's cast gives on one
  device;
* the layouts: ``"2d"`` (FSDP over ``data`` x TP over ``model``, the batch
  over ``data``) and ``"dp_only"`` (no TP; the batch over ``(data,
  model)`` where it divides, each leaf over ``data`` on its largest
  dimension, ``repro/distributed/sharding.py:70-81``). Each micro-batch's
  rows split over ``_resolve("dp", mesh, rows)``
  (:mod:`repro_torch.distributed.hints`), as the reference's
  ``best_dp_spec``; rows that do not split run on every rank, and then no
  gradient is summed.

Where the collectives could go wrong, and what holds them:

* the backward rules of the tensor-parallel collectives
  (:mod:`repro_torch.distributed.tensor_parallel`); a whole ``q_norm`` or
  ``k_norm`` applied to this rank's heads enters the parallel region like
  an activation (:meth:`FSDP.use_layer`);
* remat: a unit's gathers run again in its backward, so every rank issues
  the same collectives in the same order; the ranks run one program, and
  nothing here branches on a value;
* recurrent blocks (RG-LRU, mLSTM, sLSTM) have no tensor-parallel form
  yet: under ``"2d"`` with ``model`` larger than 1 the context refuses
  them (``NotImplementedError``, ROADMAP queue 1 item 16.4); under
  ``"dp_only"`` every configuration runs.

``collective_stats`` (:mod:`repro_torch.distributed.tensor_parallel`)
times the gathers (``"gather"``), the gradient reductions (``"grad"``) and
the tensor-parallel collectives (``"tp"``) where it is set; the gathers and
reductions of the vocabulary's leaves (``embed``, ``unembed``) count apart,
as ``"gather_vocab"`` and ``"grad_vocab"`` (:func:`_category`).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.distributed import tensor_parallel as tpm
from repro_torch.distributed.hints import _resolve, activation_mesh
from repro_torch.distributed.sharding import P, dp_axes, param_specs, shard_tree, spec_paths
from repro_torch.distributed.tensor_parallel import (TensorParallel, _axes, abstract_params,
                                                     all_gather, reduce_scatter)
from repro_torch.launch.mesh import axis_group, axis_index, axis_size, mesh_axes
from repro_torch.models import ModelConfig, layer_kinds
from repro_torch.models.transformer import RECURRENT_KINDS
from repro_torch.training.tree import flatten, unflatten

# matmul weights: each use casts the leaf to bf16 once, before its one
# product; gathered as bf16
BF16_GATHER = frozenset({"wq", "wk", "wv", "wo", "wg", "wu", "wd", "router", "wa", "wi", "wy",
                         "wx", "conv_w", "w_out", "w_if", "w_up", "w_down", "w_in"})
_VOCAB = ("embed", "unembed")
# whole leaves applied inside the attention's tensor-parallel region
_HEAD_NORMS = ("q_norm", "k_norm")
RECURRENT_TP_ITEM = "ROADMAP queue 1, item 16.4 (RG-LRU, mLSTM and sLSTM blocks under TP)"


def _category(kind: str, paths) -> str:
    """``kind`` (``"gather"`` or ``"grad"``) for a bucket of layer leaves,
    ``kind + "_vocab"`` for the vocabulary's leaves."""
    return kind + "_vocab" if any(p in _VOCAB for p in paths) else kind


class _Use(torch.autograd.Function):
    """Forward: the serve-layout blocks of a bucket of leaves
    (:meth:`FSDP.gather_bucket`). Backward: their gradients as this rank's
    float32 blocks (:meth:`FSDP.grad_bucket`)."""

    @staticmethod
    def forward(ctx, fsdp, paths, *blocks):
        ctx.fsdp, ctx.paths = fsdp, paths
        return tuple(fsdp.gather_bucket(paths, blocks))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + tuple(ctx.fsdp.grad_bucket(ctx.paths, [g.float() for g in grads]))


class FSDP(TensorParallel):
    """One rank's training context on ``mesh`` under ``layout``: the
    train specs of ``cfg``'s parameters (:attr:`train_specs`), and, for
    micro-batches of ``rows`` rows (None: unsplit), the batch's axes and the
    tensor-parallel context on the serve-layout blocks. Build the groups
    on every rank in the same order (the constructor is collective where a
    flattened group is new)."""

    def __init__(self, cfg: ModelConfig, mesh, layout: str, rows: Optional[int] = None):
        sizes = mesh_axes(mesh)
        if layout == "2d" and sizes.get("model", 1) > 1:
            bad = sorted(set(layer_kinds(cfg)) & set(RECURRENT_KINDS))
            if bad:
                raise NotImplementedError(
                    f"{cfg.name}: layer kinds {bad} have no tensor-parallel form for layout '2d' "
                    f"on model={sizes['model']}; train them with layout 'dp_only' "
                    f"({RECURRENT_TP_ITEM})")
        like = abstract_params(cfg)
        self.cfg, self.mesh, self.layout = cfg, mesh, layout
        self.train_specs = param_specs(like, mesh, cfg, layout, mode="train")
        batch_spec = None
        if rows is not None:
            with activation_mesh(mesh, dp=dp_axes(mesh, layout)):
                batch_spec = _resolve("dp", mesh, rows)
        super().__init__(mesh, like, param_specs(like, mesh, cfg, layout, mode="serve"),
                         batch_spec)
        self.batch_spec = batch_spec
        self.train = spec_paths(self.train_specs)
        self.n_data = sizes.get("data", 1)
        self.data_index = axis_index(mesh, "data") if self.n_data > 1 else 0
        self.data_group = axis_group(mesh, "data") if self.n_data > 1 else None
        # each leaf's data dimension (None: not split over data)
        self.data_dim = {path: next((d for d, a in enumerate(spec) if "data" in _axes(a)), None)
                         if self.n_data > 1 else None for path, spec in self.train.items()}
        self.train_blocks = {
            path: tuple(n // (axis_size(mesh, _axes(a)) if a else 1)
                        for n, a in zip(leaf.shape, self.train[path]))
            for path, leaf in zip(*flatten(like))}
        self.data_rows = self.n_rows > 1 and "data" in self.row_axes
        rest = tuple(a for a in self.row_axes if a != "data")
        self.rest_group = (axis_group(mesh, rest) if rest and axis_size(mesh, rest) > 1
                           else None)
        # a leaf counts in the global norm on the first of its replicas: the
        # rank at index 0 on every axis the leaf does not split over
        coord = {a: axis_index(mesh, a) for a in sizes}
        self.owned = {path: all(coord[a] == 0 for a in sizes
                                if a not in {x for e in spec for x in _axes(e)})
                      for path, spec in self.train.items()}
        if self.data_group is not None and dist.get_rank(self.data_group) != self.data_index:
            raise RuntimeError(f"rank {dist.get_rank()} is {dist.get_rank(self.data_group)} in "
                               f"its data group but at index {self.data_index}")

    # --------------------------------------------------------- layouts
    def block(self, path: str, leaf: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole leaf at ``path`` under its train
        spec, copied out (``init_params(..., shard=fsdp.block)``)."""
        from repro_torch.core.distributed import shard_of

        return shard_of(leaf, self.train[path], self.mesh).clone()

    def shard(self, tree):
        """This rank's blocks of a whole parameter tree (or of ``m`` or
        ``v``) under the train specs."""
        return shard_tree(tree, self.train_specs, self.mesh)

    def check(self, params) -> None:
        """Refuse parameters that are not this rank's blocks under the
        train specs: a leaf the spec splits must not arrive whole."""
        paths, leaves = flatten(params)
        if paths != list(self.train_blocks):
            raise ValueError("the parameters' tree differs from the specs'")
        for path, leaf in zip(paths, leaves):
            if tuple(leaf.shape) != self.train_blocks[path]:
                raise ValueError(f"{path}: {tuple(leaf.shape)} is not this rank's block "
                                 f"{self.train_blocks[path]} under {self.train[path]}")

    def own_batch(self, batch: dict) -> dict:
        """This rank's rows of a micro-batch (every leaf split on its first
        dimension over the batch's axes; whole where they do not split)."""
        from repro_torch.core.distributed import shard_of

        if self.batch_spec is None:
            return batch
        return {k: shard_of(v, P(self.batch_spec, *([None] * (v.ndim - 1))), self.mesh)
                .contiguous() for k, v in batch.items()}

    # ----------------------------------------------------- collectives
    def _dtype(self, path: str, block: torch.Tensor) -> torch.dtype:
        """What the leaf at ``path`` is gathered in: bf16 for
        :data:`BF16_GATHER` where it splits over ``data``, else its own."""
        if path.rsplit("/", 1)[-1] in BF16_GATHER and self.data_dim[path] is not None:
            return torch.bfloat16
        return block.dtype

    def gather_bucket(self, paths, blocks, dtype: Optional[torch.dtype] = None) -> list:
        """The serve-layout blocks of the leaves ``paths`` from this rank's
        ``blocks`` (in ``dtype`` where given, else :meth:`_dtype`'s): the
        leaves split over ``data`` gathered by one ``all_gather`` per dtype
        of their flattened blocks, each rebuilt by concatenating the ranks'
        blocks along its data dimension -- a view of the gathered buffer for
        a leaf alone in it split on its first dimension; the others as they
        are (a view, or a cast)."""
        out = [None] * len(paths)
        by_dtype = {}
        for k, (path, b) in enumerate(zip(paths, blocks)):
            dt = dtype or self._dtype(path, b)
            if self.data_dim[path] is None:
                out[k] = b.view_as(b) if b.dtype == dt else b.to(dt)
            else:
                by_dtype.setdefault(dt, []).append(k)
        for dt, ks in by_dtype.items():
            flat = torch.cat([blocks[k].to(dt).reshape(-1) for k in ks])
            full = tpm.timed(_category("gather", paths),
                             flat.numel() * flat.element_size() * self.n_data, all_gather, flat,
                             self.data_group, self.n_data, 0)
            del flat
            full = full.view(self.n_data, -1)
            if len(ks) == 1 and self.data_dim[paths[ks[0]]] == 0:
                b = blocks[ks[0]]
                out[ks[0]] = full.view((self.n_data * b.shape[0],) + tuple(b.shape[1:]))
                continue
            off = 0
            for k in ks:
                b, d = blocks[k], self.data_dim[paths[k]]
                n = b.numel()
                out[k] = torch.cat([full[r, off:off + n].view(b.shape) for r in range(self.n_data)],
                                   dim=d)
                off += n
        return out

    def grad_bucket(self, paths, grads) -> list:
        """The float32 gradients of this rank's blocks from ``grads``, the
        gradients of the serve-layout blocks from its own rows: summed over
        the batch's axes, each kept as this rank's block along its data
        dimension. With the rows split over ``data``, one
        ``reduce_scatter`` of the leaves split over ``data`` (each laid out
        rank-major along its data dimension) does both over ``data``, then
        one ``all_reduce`` over the batch's other axes; the leaves that are
        whole over ``data``, and every leaf where the rows do not split over
        it, are summed by one ``all_reduce`` over the batch's axes (none
        where the rows do not split)."""
        out = [None] * len(paths)
        split = [k for k, p in enumerate(paths) if self.data_dim[p] is not None]
        rest = [k for k in range(len(paths)) if self.data_dim[paths[k]] is None]
        if self.data_rows and split:
            n = self.n_data
            parts, shapes = [], []
            for k in split:
                g, d = grads[k], self.data_dim[paths[k]]
                shapes.append(g.shape[:d] + (g.shape[d] // n,) + g.shape[d + 1:])
                parts.append(g.reshape(g.shape[:d] + (n, g.shape[d] // n) + g.shape[d + 1:])
                             .movedim(d, 0).reshape(n, -1))
            flat = parts[0].contiguous() if len(parts) == 1 else torch.cat(parts, dim=1)
            mine = tpm.timed(_category("grad", paths), flat.numel() * flat.element_size(),
                             reduce_scatter, flat, self.data_group, n, 0)[0]
            if self.rest_group is not None:
                tpm.timed(_category("grad", paths), mine.numel() * mine.element_size(),
                          dist.all_reduce, mine, op=dist.ReduceOp.SUM, group=self.rest_group)
            off = 0
            for k, shape in zip(split, shapes):
                size = math.prod(shape)
                out[k] = mine[off:off + size].view(shape)
                off += size
        else:
            for k in split:
                g, d = grads[k], self.data_dim[paths[k]]
                m = g.shape[d] // self.n_data
                grads[k] = g.narrow(d, self.data_index * m, m)
            rest = rest + split
        if rest:
            if self.row_group is None:
                for k in rest:     # a copy: a slice must not pin the whole leaf's gradient
                    out[k] = grads[k].clone(memory_format=torch.contiguous_format)
            else:
                flat = torch.cat([grads[k].reshape(-1) for k in rest])
                tpm.timed(_category("grad", paths), flat.numel() * flat.element_size(),
                          dist.all_reduce, flat, op=dist.ReduceOp.SUM, group=self.row_group)
                off = 0
                for k in rest:
                    size = grads[k].numel()
                    out[k] = flat[off:off + size].view(grads[k].shape)
                    off += size
        return out

    def use_bucket(self, paths, blocks) -> list:
        """The leaves ``paths`` as the model computes with them, from this
        rank's ``blocks``: gathered together (:meth:`gather_bucket`), their
        gradients returned to the blocks together (:meth:`grad_bucket`)."""
        return list(_Use.apply(self, tuple(paths), *blocks))

    def looks_up(self) -> bool:
        """The lookup always runs through :meth:`embed`, on the block."""
        return True

    def embed(self, w: torch.Tensor, tokens: torch.Tensor, scale: float) -> torch.Tensor:
        """The token lookup times ``scale`` from ``w``, this rank's float32
        block of ``embed``, as :meth:`TensorParallel.embed` computes it on
        the serve-layout block (or the plain lookup where the vocabulary is
        whole). Where the block splits the width over ``data`` (layout
        ``"2d"``), only the rows the data group's tokens hit are gathered:
        the tokens are gathered over ``data`` (where the rows split there),
        the hit rows of the block (one set, sorted, the same on every rank
        of the group) go through :meth:`use_bucket` as a leaf of their own,
        and the lookup indexes them. Their gradient is reduce-scattered as
        the whole leaf's would be, and added into the block's rows. So a
        step moves the rows of at most the batch's tokens instead of the
        vocabulary's. Elsewhere the block is gathered whole."""
        vocab = self.split("embed", 0)
        if self.data_dim["embed"] != 1:
            w = self.use_bucket(["embed"], [w])[0]
            if vocab:
                return super().embed(w, tokens, scale)
            return w[tokens.long()].to(torch.bfloat16).float() * scale
        start = self.model_index * w.shape[0] if vocab else 0
        ids = tokens.reshape(-1)
        if self.data_rows:
            ids = tpm.timed("gather_vocab", ids.numel() * ids.element_size() * self.n_data,
                            all_gather, ids, self.data_group, self.n_data, 0)
        ids = ids.long() - start
        hit = torch.unique(torch.cat([ids[(ids >= 0) & (ids < w.shape[0])], ids.new_zeros(1)]))
        rows = self.use_bucket(["embed"], [w.index_select(0, hit)])[0]
        local = tokens.long() - start
        mine = (local >= 0) & (local < w.shape[0])
        at = torch.searchsorted(hit, local.clamp(0, w.shape[0] - 1)).clamp(max=hit.numel() - 1)
        x = rows[at].to(torch.bfloat16).float() * scale
        if not vocab:
            return x
        x = torch.where(mine[..., None], x, torch.zeros((), device=x.device))
        return tpm._Sum.apply(x, self.model_group)

    def use_layer(self, i: int, p: dict) -> dict:
        """Layer ``i``'s leaves as the model computes with them, one bucket
        (:meth:`use_bucket`); under tensor parallelism a whole ``q_norm`` /
        ``k_norm`` applied to this rank's heads also enters the parallel
        region (:meth:`TensorParallel.enter`), so its gradient, partial on
        each rank of ``model``, is summed there."""
        paths, blocks = flatten(p)
        paths = [f"layers/{i}/{path}" for path in paths]
        used = self.use_bucket(paths, blocks)
        for k, path in enumerate(paths):
            parts = path.split("/")
            if parts[-1] in _HEAD_NORMS and self.split("/".join(parts[:-1] + ["wq"]), 1):
                used[k] = self.enter(used[k])
        return unflatten(p, used)

    def use_top(self, params: dict, names) -> dict:
        """The top-level leaves ``names`` as the model computes with them,
        one bucket (:meth:`use_bucket`)."""
        return dict(zip(names, self.use_bucket(list(names), [params[k] for k in names])))

    # ------------------------------------------------------- optimizer
    def owns(self, path: str) -> bool:
        """Whether this rank counts the leaf at ``path`` in a global sum
        over the leaves' elements (:func:`repro_torch.training.
        global_norm`): the first of its replicas does."""
        return self.owned[path]

    def sum_world(self, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``x`` reduced over every rank (a copy; ``op`` SUM or MAX)."""
        x = x.clone()
        dist.all_reduce(x, op=op)
        return x

    def sum_rows(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the batch's ranks (a copy): a metric's global
        value from each rank's share."""
        x = x.clone()
        if self.row_group is not None:
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.row_group)
        return x

