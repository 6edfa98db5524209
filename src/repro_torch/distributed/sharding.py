"""Parameter / activation / cache sharding policy (FSDP x TP x EP x SP),
port of ``repro/distributed/sharding.py``.

Mesh axes:
  pod    (multi-pod only) -- pure data parallel across pods; gradients
         cross the slow links once per step. Params are replicated across
         pods.
  data   -- batch DP + FSDP: every param's non-TP large dim is sharded
         here, so optimizer state is fully sharded.
  model  -- tensor parallel: heads / d_ff / vocab / experts.

Rules are name-keyed with a size-aware generic fallback; dims that do not
divide their axis are replicated (e.g. kv-heads < 16 stay replicated, the
standard MQA treatment).

A spec is a :class:`P`: one entry per tensor dimension, ``None``, an axis
name or a tuple of names, as ``jax.sharding.PartitionSpec``. The policy
reads a mesh through :func:`repro_torch.launch.mesh.mesh_axes`: a
``DeviceMesh``, or any object with a ``shape`` dict of axis sizes (the
reference's tests' ``FakeMesh``). The port's parameters and caches hold
one entry per layer where the reference stacks a stage's repeats, so a
layer's spec is the reference's stacked spec without its leading ``None``
(the repeats axis); the rules are the reference's. The serving path
(:mod:`repro_torch.launch.serve_step`) executes :func:`decode_plan`,
:func:`cache_specs` and, under plan ``heads``, :func:`param_specs` with
``mode="serve"`` (:mod:`repro_torch.distributed.tensor_parallel`);
:func:`shard_tree` cuts a rank's blocks of a whole tree, as the
reference's ``jax.device_put`` with ``NamedSharding`` places it. The
sharded train step (:mod:`repro_torch.distributed.fsdp`) executes
:func:`param_specs` with ``mode="train"`` and the batch's split of
:func:`best_dp_spec`.
"""
from __future__ import annotations

import math
import re
from typing import Any

from repro_torch.launch.mesh import mesh_axes
from repro_torch.models import ModelConfig
from repro_torch.training.tree import flatten, unflatten


class P(tuple):
    """A partition spec: ``P("data", None)``, ``P(("data", "model"))``; a
    tuple, so it compares with the reference's ``PartitionSpec`` through
    ``tuple(spec)``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self)) + ")"


def choose_layout(cfg: ModelConfig) -> str:
    """'2d' = FSDP(data) x TP(model); 'dp_only' = batch over every axis
    (small models that cannot profitably tensor-parallelize -- the model
    axis would idle or add pure overhead)."""
    from repro_torch.models import count_params

    return "dp_only" if count_params(cfg) < 2_000_000_000 else "2d"


def dp_axes(mesh, layout: str = "2d"):
    base = ("pod", "data") if "pod" in mesh_axes(mesh) else ("data",)
    if layout == "dp_only":
        base = base + ("model",)
    return base


def _div(n: int, mesh, axis: str) -> bool:
    sizes = mesh_axes(mesh)
    return axis in sizes and n % sizes[axis] == 0 and n >= sizes[axis]


def best_dp_spec(dim: int, mesh, layout: str = "2d"):
    """Largest axis combination that divides a batch-like dim."""
    sizes = mesh_axes(mesh)
    full = dp_axes(mesh, layout)
    cands = [full]
    if "model" in full:
        cands.append(tuple(a for a in full if a != "model"))
    if len(cands[-1]) > 1:
        cands.append(("data",))
    for c in cands:
        size = math.prod(sizes[a] for a in c)
        if dim % size == 0 and dim >= size:
            return c if len(c) > 1 else c[0]
    return None


def _leaf_spec(path: str, shape, mesh, cfg: ModelConfig, layout: str = "2d") -> P:
    """The spec of one parameter leaf of ``shape`` (a layer's leaf
    unstacked) at ``path``, its keys joined by '/'."""
    d = len(shape)

    if layout == "dp_only":
        # pure DP: FSDP over 'data' only (sharding weights across the model
        # axis would make each matmul re-gather its activations)
        spec = [None] * d
        if d >= 2:
            i = sorted(range(d), key=lambda i: -shape[i])[0]
            if _div(shape[i], mesh, "data"):
                spec[i] = "data"
        return P(*spec)

    def last_model_rest_data(*, model_dim=-1, data_dim=None):
        spec = [None] * d
        md = model_dim % d
        if _div(shape[md], mesh, "model"):
            spec[md] = "model"
        if data_dim is None:
            # largest remaining dim
            cands = sorted((i for i in range(d) if i != md), key=lambda i: -shape[i])
            dd = cands[0] if cands else None
        else:
            dd = data_dim % d
        if dd is not None and _div(shape[dd], mesh, "data"):
            spec[dd] = "data"
        return P(*spec)

    if re.search(r"(^|/)embed$", path):
        return P("model", "data")      # vocab -> model, d_model -> data
    if re.search(r"(^|/)unembed$", path):
        return P("data", "model")
    if re.search(r"/(ln1|ln2|ln_x|ln_inner|q_norm|k_norm|final_norm|lam|b_if|b|xgate)$", path):
        return P(*([None] * d))
    if re.search(r"/moe/(wg|wu)$", path):           # (E, D, F)
        if _div(shape[0], mesh, "model"):           # EP
            return P("model", "data", None)
        return P(None, "data", "model")             # expert-TP
    if re.search(r"/moe/wd$", path):                # (E, F, D)
        if _div(shape[0], mesh, "model"):
            return P("model", None, "data")
        return P(None, "model", "data")
    if re.search(r"/moe/router$", path):
        return P("data", None)
    if re.search(r"/(wo|wd|w_out|w_down)$", path):  # row-parallel (down)
        return last_model_rest_data(model_dim=-2, data_dim=-1)
    if d >= 2:
        return last_model_rest_data()               # col-parallel (up) default
    return P(*([None] * d))


def _strip_data(spec: P) -> P:
    def fix(ax):
        if ax == "data":
            return None
        if isinstance(ax, tuple):
            kept = tuple(a for a in ax if a != "data")
            return kept if len(kept) > 1 else (kept[0] if kept else None)
        return ax

    return P(*(fix(a) for a in spec))


def param_specs(params: Any, mesh, cfg: ModelConfig, layout: str = "2d", mode: str = "train"):
    """A tree of :class:`P` matching ``params`` (the port's tree: a layer's
    spec is the reference's stacked one without its leading ``None``).

    mode='train': FSDP over 'data' + TP over 'model' (ZeRO-style).
    mode='serve': TP over 'model' only -- params replicate across 'data'
    (re-gathering FSDP shards every decode step would swamp the links)."""
    paths, leaves = flatten(params)
    specs = []
    for path, leaf in zip(paths, leaves):
        spec = _leaf_spec(path, tuple(leaf.shape), mesh, cfg, layout)
        specs.append(_strip_data(spec) if mode == "serve" else spec)
    return unflatten(params, specs)


def decode_plan(cfg: ModelConfig, mesh, batch: int, layout: str) -> dict:
    """How decode attention parallelizes for this (arch, batch, mesh):

      heads     -- kv heads shard over 'model', batch over dp (classic TP)
      seq_model -- kv heads don't divide 'model': the KV sequence shards
                   over 'model' and partials merge with the lean operator
      seq_all   -- batch too small for 'data': the KV sequence shards over
                   ('data', 'model') -- full-mesh sequence-parallel decode
                   (the paper's multi-GPU regime)
    """
    model = mesh_axes(mesh).get("model", 1)
    bdp = best_dp_spec(batch, mesh, layout)
    kv_ok = (
        layout != "dp_only"
        and cfg.n_kv_heads % model == 0
        and cfg.n_heads % model == 0
    )
    if bdp is not None and kv_ok:
        return {"mode": "heads", "seq_axes": None, "batch_spec": bdp}
    if bdp is not None:
        return {"mode": "seq_model", "seq_axes": ("model",), "batch_spec": bdp}
    return {"mode": "seq_all", "seq_axes": ("data", "model"), "batch_spec": None}


def cache_specs(cache: Any, mesh, batch: int, layout: str = "2d", plan=None,
                cache_len: int = 0):
    """Decode-cache specs consistent with :func:`decode_plan`, for the
    port's dense cache (one dict per layer; a layer's spec is the
    reference's stacked one without its leading ``None``): full-length KV
    (``S == cache_len``) takes the plan's sequence split; bounded window
    rings stay local."""
    sizes = mesh_axes(mesh)
    bdp = best_dp_spec(batch, mesh, layout)
    use_model = layout != "dp_only" and not (
        isinstance(bdp, tuple) and "model" in bdp
    ) and bdp != "model"
    seq_axes = plan["seq_axes"] if plan else None

    def seq_spec_for(S):
        if seq_axes is None or S != cache_len or S <= 1:
            return None
        if S % math.prod(sizes[a] for a in seq_axes):
            return None
        return seq_axes if len(seq_axes) > 1 else seq_axes[0]

    def spec_for(name, shape):
        d = len(shape)
        spec = [None] * d
        if name in ("k", "v", "xk", "xv"):          # (B, Hkv, S, hd)
            if bdp is not None:
                spec[0] = bdp
            if name in ("k", "v"):
                spec[2] = seq_spec_for(shape[2])
            if (
                spec[2] is None
                and use_model
                and plan is not None
                and plan["mode"] == "heads"
                and _div(shape[1], mesh, "model")
            ):
                spec[1] = "model"
        elif name == "C":                           # (B, H, hd, hd)
            if bdp is not None:
                spec[0] = bdp
            if use_model:
                if _div(shape[1], mesh, "model"):
                    spec[1] = "model"
                elif _div(shape[2], mesh, "model"):
                    spec[2] = "model"
        elif name in ("n", "h", "c", "m"):
            if bdp is not None:
                spec[0] = bdp
            if use_model and d >= 2 and _div(shape[-1], mesh, "model"):
                spec[-1] = "model"
        elif name == "conv":                        # (B, 3, W)
            if bdp is not None:
                spec[0] = bdp
            if use_model and _div(shape[-1], mesh, "model"):
                spec[-1] = "model"
        return P(*spec)

    paths, leaves = flatten(cache)
    return unflatten(cache, [spec_for(p.rsplit("/", 1)[-1], tuple(t.shape))
                             for p, t in zip(paths, leaves)])


def batch_specs(mesh, batch: int, has_img: bool = False, layout: str = "2d") -> dict:
    bspec = best_dp_spec(batch, mesh, layout)
    out = {"tokens": P(bspec, None)}
    if has_img:
        out["img_emb"] = P(bspec, None, None)
    return out


def to_named(tree_specs, mesh):
    """Each spec of ``tree_specs`` as DTensor placements on the
    ``DeviceMesh`` (the reference's ``NamedSharding``): per mesh dimension,
    ``Shard(i)`` where tensor dimension ``i`` splits over it, else
    ``Replicate()``. A dimension split over a tuple of axes must name them
    in the mesh's order (DTensor nests the mesh dimensions in that
    order; ``NamedSharding`` in the tuple's)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)

    def placements(spec: P):
        out = [Replicate()] * len(names)
        for dim, axes in enumerate(spec):
            if axes is None:
                continue
            axes = (axes,) if isinstance(axes, str) else tuple(axes)
            idx = [names.index(a) for a in axes]
            if idx != sorted(idx):
                raise ValueError(f"{spec}: axes {axes} out of the mesh's order {names}")
            for i in idx:
                out[i] = Shard(dim)
        return tuple(out)

    return _map_specs(placements, tree_specs)


def spec_paths(specs) -> dict:
    """``{path: spec}`` of a tree of :class:`P` (the paths of
    :func:`repro_torch.training.tree.flatten` of the tree it matches)."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, P):
            out["/".join(prefix)] = node
        elif isinstance(node, dict):
            for k in node:
                walk(node[k], prefix + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, prefix + (str(i),))

    walk(specs, ())
    return out


def shard_tree(tree, specs, mesh):
    """This rank's block of every leaf of ``tree`` under ``specs`` (a tree
    of :class:`P` matching it, e.g. :func:`param_specs` or
    :func:`cache_specs`): :func:`repro_torch.core.distributed.shard_of` of
    each leaf, copied out of the whole leaf so that the whole can be freed.
    A dimension split over an axis it does not divide raises
    (``shard_of``); the policy leaves such a dimension whole."""
    from repro_torch.core.distributed import shard_of

    if isinstance(specs, P):
        return shard_of(tree, specs, mesh).clone()
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_tree(v, s, mesh) for v, s in zip(tree, specs, strict=True))
    raise TypeError(f"no spec for a leaf of type {type(tree).__name__}")


def _map_specs(fn, tree):
    if isinstance(tree, P):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_specs(fn, v) for v in tree)
    return tree
