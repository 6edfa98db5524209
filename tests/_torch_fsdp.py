"""Shared parts of the port's sharded-training and pipeline tests
(``test_torch_fsdp_train.py``, ``test_torch_pipeline.py``): the cases and
their seeded inputs, and what the ranks of one spawned ``gloo`` group run
(``tests/_torch_dist.py``'s ``run_ranks``). The JAX side is the ``train``
and ``pipe`` cases of ``tests/_torch_dist_ref.py``.

Numpy only at import: the JAX subprocess imports the inputs from here, and
the spawned ranks import this module and torch, never JAX.
"""
import contextlib
import dataclasses
import os

import numpy as np

# case -> (architecture, mesh shape over (data, model), layout). Layout "2d"
# on the smoke configs (they pick dp_only): FSDP over data x TP over model;
# qwen3-moe's 8 experts over model=2 are EP, qwen2-moe's 6 over model=4
# expert-TP; "dp_only" for the recurrent ones (no TP form yet)
TRAIN_CASES = {
    "mistral-nemo": ("mistral-nemo-12b", (4, 2), "2d"),
    "gemma3": ("gemma3-4b", (4, 2), "2d"),
    "llama-vision": ("llama-3.2-vision-11b", (4, 2), "2d"),
    "qwen3-moe": ("qwen3-moe-30b-a3b", (4, 2), "2d"),
    "qwen2-moe": ("qwen2-moe-a2.7b", (2, 4), "2d"),
    "xlstm": ("xlstm-350m", (4, 2), "dp_only"),
    "recurrentgemma": ("recurrentgemma-9b", (4, 2), "dp_only"),
}
# the case whose checks are widened to JAX's own gap between its sharded
# and its one-device step (measured in the JAX subprocess):
# llama-3.2-vision (its loss parts by 2.5e-4 in JAX, against 2e-4); the
# others are held to tests/_torch_train.py's tolerances as they are
WIDENED = ("llama-vision",)
# the MoE cases: every step of either package takes the expert choices the
# port's sharded step recorded (:func:`routing`; the JAX side patches its
# ``jax.lax.top_k`` in the test's subprocess, ``tests/_torch_dist_ref.py``),
# so that no router near-tie flipped by a summation order decides a check
REPLAYED = ("qwen3-moe", "qwen2-moe")
# the recorded calls of one step the JAX side takes, padded with -1
ROUTES_MAX = 64
# a batch of 8 x 24 tokens in two micro-batches of 4 rows: under "2d" each
# of data=4 ranks takes one row (2 on data=2); under "dp_only" 4 rows do
# not split over (data, model) = 8, so they split over data alone. The
# compressed step takes the batch whole (grad_accum 1): its 8 rows split
# over (data, model) under "dp_only", and its metrics carry the MoE's aux
# loss (the reference reports 0 for it under accumulation)
TRAIN_BATCH, TRAIN_SEQ, GRAD_ACCUM = 8, 24, 2
ACCUM = {"s1": GRAD_ACCUM, "s2": GRAD_ACCUM, "c": 1}
OPT_KW = dict(lr=1e-2, warmup_steps=1, weight_decay=0.1)
# the leaf whose gradient the planted fault also sums over model
PLANTED_LEAF = "layers/0/ln1"
# pipeline_forward: the reference's test shapes (tests/test_distributed.py:
# 134), four stages over pod of a (pod=4, data=2) mesh
PIPE_SHAPE = (4, 6, 2, 8, 16)          # stages, micro-batches, mb, L, D


def train_config(name: str, get_smoke_config):
    """The case's smoke config (either package's registry), with
    ``attn_q_chunk`` and ``loss_chunk`` 16, so that the q-chunked attention
    and the chunked cross entropy run (as in ``tests/_torch_train.py``)."""
    return dataclasses.replace(get_smoke_config(TRAIN_CASES[name][0]), attn_q_chunk=16,
                               loss_chunk=16)


def carried_state(pn: dict, seed: int) -> dict:
    """A second step's starting point: the weights ``pn`` (the reference's
    tree of numpy arrays) moved by one seeded step of ``lr``, and seeded
    moments of a first step's size (``m = 0.1 g``, ``v = 0.05 g^2`` for ``g``
    of 0.02): AdamW's step count is then 1."""
    rng = np.random.default_rng(seed)

    def each(fn, tree):
        if isinstance(tree, dict):
            return {k: each(fn, v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(each(fn, v) for v in tree)
        return fn(tree)

    def grad(a):
        return (0.02 * rng.standard_normal(a.shape)).astype(np.float32)

    g = each(grad, pn)
    params = each(lambda a: a.copy(), pn)
    flat_p, flat_g = [], []

    def collect(p, q):
        if isinstance(p, dict):
            for k in p:
                collect(p[k], q[k])
        elif isinstance(p, (list, tuple)):
            for x, y in zip(p, q):
                collect(x, y)
        else:
            flat_p.append(p)
            flat_g.append(q)

    collect(params, g)
    for p, q in zip(flat_p, flat_g):
        p -= (OPT_KW["lr"] * np.sign(q)).astype(np.float32)
    return {"params": params, "m": each(lambda a: (0.1 * a).astype(np.float32), g),
            "v": each(lambda a: (0.05 * a * a).astype(np.float32), g)}


def train_inputs(names, ckpt: str) -> dict:
    """Each training case's weights, drawn by the port's ``init_params``
    from seed 0 in float32 and carried to the reference's tree (numpy),
    every all-zero leaf -- norms, the cross-attention gate -- perturbed by
    N(0, 0.1) so that weight decay on them shows (``tests/_torch_train.py``
    does the same); its carried state; the checkpoint directory the ranks
    save into."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params, params_to_numpy

    out = {}
    for i, name in enumerate(names):
        cfg = train_config(name, get_smoke_config)
        rng = np.random.default_rng(0)
        pn = params_to_numpy(init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                                         dtype=torch.float32), cfg)

        def perturb(a):
            if isinstance(a, dict):
                return {k: perturb(v) for k, v in a.items()}
            if isinstance(a, (list, tuple)):
                return type(a)(perturb(v) for v in a)
            return a if a.any() else (0.1 * rng.standard_normal(a.shape)).astype(np.float32)

        pn = perturb(pn)
        out[name] = {"params": pn, "state": carried_state(pn, 100 + i), "ckpt": ckpt}
    return {"cases": out, "routes": ckpt + "_routes"}


def routes_path(inputs: dict, name: str, key: str) -> str:
    """Where the rank that ran step ``key`` of case ``name`` leaves the
    expert choices of its sharded step's MoE calls."""
    return os.path.join(inputs["routes"], f"{name}_{key}.npy")


def write_routes(path: str, calls) -> None:
    """The recorded choices ``calls`` (each ``(G, Tg, K)``), stacked,
    padded with -1 to ``ROUTES_MAX`` calls, written whole at once."""
    calls = np.stack([np.asarray(c, dtype=np.int32) for c in calls])
    if len(calls) > ROUTES_MAX:
        raise ValueError(f"{len(calls)} MoE calls recorded, more than {ROUTES_MAX}")
    pad = np.full((ROUTES_MAX - len(calls),) + calls.shape[1:], -1, np.int32)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path + ".tmp", "wb") as f:
        np.save(f, np.concatenate([calls, pad]))
    os.replace(path + ".tmp", path)


def read_routes(path: str, timeout: float = 600.0) -> np.ndarray:
    """The choices :func:`write_routes` left at ``path``, waiting for them."""
    import time

    end = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > end:
            raise TimeoutError(f"no recorded routes at {path} after {timeout} s")
        time.sleep(0.1)
    return np.load(path)


def pipe_inputs():
    """The stages' weights ``(P, D, D)`` and the micro-batched input
    ``(M, mb, L, D)``, float32."""
    P_, M, mb, L, D = PIPE_SHAPE
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((P_, D, D)) * 0.1).astype(np.float32)
    x = rng.standard_normal((M, mb, L, D)).astype(np.float32)
    return ws, x


# ------------------------------------------------------------ rank cases
def _np_tree(tree) -> dict:
    from repro_torch.training.tree import flatten

    return {p: t.detach().float().cpu().numpy().copy() for p, t in zip(*flatten(tree))}


def _port_state(tree, cfg, step: int):
    """The port's float32 parameters and AdamW state (on the CPU) from the
    reference's trees of numpy arrays."""
    import torch

    from repro_torch.models import params_from_numpy

    p = params_from_numpy(tree["params"], cfg, "cpu", dtype=torch.float32)
    opt = {k: params_from_numpy(tree[k], cfg, "cpu", dtype=torch.float32) for k in ("m", "v")}
    opt["step"] = torch.tensor(step, dtype=torch.int32)
    return p, opt


def _record(params, opt, metrics) -> dict:
    """A step's metrics, parameters and moments (blocks), as numpy."""
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "params": _np_tree(params),
            "m": _np_tree(opt["m"]), "v": _np_tree(opt["v"])}


def train_case(rank: int, name: str, inputs: dict, meshes: dict) -> dict:
    """One case on this rank: its blocks (``FSDP.shard`` of the train
    specs) through the sharded step -- step 1 from the weights, step 2 from
    the carried state, one compressed step from the weights -- then the
    sharded save of step 2's state and its restore onto the transposed
    mesh; for mistral-nemo the planted fault's step 1; and the same steps
    on one device, each on one of ranks 0-2."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.distributed import fsdp as fsdp_mod
    from repro_torch.distributed.fsdp import FSDP
    from repro_torch.launch.mesh import axis_index
    from repro_torch.training import (OptConfig, make_train_step, restore_checkpoint,
                                      save_checkpoint, train_state_shardings)

    inp = inputs["cases"][name]
    _, shape, layout = TRAIN_CASES[name]
    cfg = train_config(name, get_smoke_config)
    mesh, other = meshes[shape], meshes[shape[::-1]]
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                    seed=5, img_tokens=cfg.cross_kv_len, d_model=cfg.d_model)
    batch = {k: torch.from_numpy(v) for k, v in batch_at(dc, 3).items()}
    zeros = {k: _zeros_like(inp["params"]) for k in ("m", "v")}
    starts = {"s1": (dict(params=inp["params"], **zeros), 0), "s2": (inp["state"], 1),
              "c": (dict(params=inp["params"], **zeros), 0)}
    oc = OptConfig(**OPT_KW)
    fs = FSDP(cfg, mesh, layout)
    out = {"coord": (axis_index(mesh, "data"), axis_index(mesh, "model")),
           "specs": {p: tuple(s) for p, s in fs.train.items()}}
    steps = {k: make_train_step(cfg, oc, ACCUM[k], compress_grads=k == "c", mesh=mesh,
                                layout=layout) for k in ("s1", "c")}
    steps["s2"] = steps["s1"]
    kept, routes = None, {}
    for r, (key, (tree, count)) in enumerate(starts.items()):
        p, opt = _port_state(tree, cfg, count)
        pb, ob = fs.shard(p), {"m": fs.shard(opt["m"]), "v": fs.shard(opt["v"]),
                               "step": opt["step"]}
        with routing(record=routes.setdefault(key, []) if rank == r else None):
            pb, ob, m = steps[key](pb, ob, batch)
        if rank == r and name in REPLAYED:
            write_routes(routes_path(inputs, name, key), [i.numpy() for i in routes[key]])
        out[key] = _record(pb, ob, m)
        if key == "s2":
            kept = (pb, ob)
    if name == "mistral-nemo":
        # the planted fault: a whole norm's gradient summed over model as well
        base = fsdp_mod.FSDP.grad_bucket

        def planted(self, paths, grads):
            got = base(self, paths, grads)
            if PLANTED_LEAF in paths and self.model_group is not None:
                k = paths.index(PLANTED_LEAF)
                g = got[k].clone()
                torch.distributed.all_reduce(g, group=self.model_group)
                got[k] = g
            return got

        fsdp_mod.FSDP.grad_bucket = planted
        try:
            p, opt = _port_state(starts["s1"][0], cfg, 0)
            pb, ob, m = steps["s1"]({k: v for k, v in fs.shard(p).items()},
                                    {"m": fs.shard(opt["m"]), "v": fs.shard(opt["v"]),
                                     "step": opt["step"]}, batch)
            out["planted"] = _record(pb, ob, m)
        finally:
            fsdp_mod.FSDP.grad_bucket = base
    # the sharded save of step 2's state, restored onto the other mesh
    ckpt = os.path.join(inp["ckpt"], name)
    state, shardings = train_state_shardings(*kept, cfg, fs.train_specs)
    out["save_sent"] = []
    with counted_gathers(out["save_sent"]):
        save_checkpoint(ckpt, 2, state, shardings=shardings, mesh=mesh, extra={"data_step": 2})
    fo = FSDP(cfg, other, layout)
    _, other_specs = train_state_shardings(*kept, cfg, fo.train_specs)
    restored, extra = restore_checkpoint(ckpt, state, device="cpu", shardings=other_specs,
                                         mesh=other)
    out["restored"] = {"tree": _np_tree(restored), "extra": extra,
                       "coord": (axis_index(other, "data"), axis_index(other, "model"))}
    # the one-device steps, one on each of ranks 0-2, each MoE call taking
    # the experts its sharded step chose
    for r, (key, (tree, count)) in enumerate(starts.items()):
        if rank == r:
            step = make_train_step(cfg, oc, ACCUM[key], compress_grads=key == "c")
            flips = []
            with routing(replay=routes[key], flips=flips):
                out["one"] = {key: _record(*step(*_port_state(tree, cfg, count), batch))}
            out["one"][key]["routing"] = (sum(f[0] for f in flips), sum(f[1] for f in flips),
                                          len(flips))
    return out


@contextlib.contextmanager
def counted_gathers(sent: list):
    """Each ``torch.distributed.gather`` this rank joins: (elements it
    sends, their device)."""
    import torch.distributed as dist

    base = dist.gather

    def counted(tensor, *args, **kw):
        sent.append((tensor.numel(), tensor.device.type))
        return base(tensor, *args, **kw)

    dist.gather = counted
    try:
        yield
    finally:
        dist.gather = base


@contextlib.contextmanager
def routing(record=None, replay=None, flips=None):
    """Record each MoE call's expert choices (``top_k``'s indices), or
    replay recorded ones in the same order -- each call's weights then the
    probabilities of the replayed experts -- counting the token-expert
    pairs whose own choice differs (``flips``: per call, (pairs that
    differ, pairs))."""
    from repro_torch.models import moe

    base = moe.top_k
    calls = iter(replay or ())

    def patched(probs, k):
        vals, idx = base(probs, k)
        if record is not None:
            record.append(idx.clone())
        if replay is not None:
            want = next(calls)
            flips.append((int((want.sort(-1).values != idx.sort(-1).values).sum()), idx.numel()))
            idx, vals = want, probs.gather(-1, want)
        return vals, idx

    moe.top_k = patched
    try:
        yield
    finally:
        moe.top_k = base


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zeros_like(v) for v in tree)
    return np.zeros_like(tree)


def train_rank(rank: int, inputs: dict) -> dict:
    """Every training case on this rank (both mesh shapes built once),
    and the refusals: a recurrent config under "2d" and ``grad_specs``
    other than the train specs."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import P
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training import make_train_step

    torch.manual_seed(0)
    meshes = {s: make_host_mesh(s) for s in ((4, 2), (2, 4))}
    # the MoE cases first: the JAX side waits for their recorded routes
    names = sorted(inputs["cases"], key=lambda n: n not in REPLAYED)
    out = {name: train_case(rank, name, inputs, meshes) for name in names}
    refused = {}
    try:
        make_train_step(get_smoke_config("recurrentgemma-9b"), mesh=meshes[(4, 2)], layout="2d")
    except NotImplementedError as exc:
        refused["recurrent_2d"] = str(exc)
    cfg = get_smoke_config("mistral-nemo-12b")
    try:
        make_train_step(cfg, mesh=meshes[(4, 2)], layout="2d",
                        grad_specs={"embed": P("data", None)})
    except ValueError as exc:
        refused["grad_specs"] = str(exc)
    try:
        make_train_step(cfg, grad_specs={"embed": P("data", None)})
    except ValueError as exc:
        refused["no_mesh"] = str(exc)
    out["refused"] = refused
    return out


def _rule_checks(mesh) -> dict:
    """Each backward rule of the tensor-parallel collectives against
    one-rank autograd of the whole computation, float32 (the logits' bf16
    product aside): this rank's gradients and their blocks of the whole
    ones. Every rank of a model group holds the same replicated loss and
    starts its backward from it; a data rank's loss is its rows' share."""
    import torch

    from repro_torch.core.distributed import shard_of
    from repro_torch.distributed.tensor_parallel import TensorParallel
    from repro_torch.launch.mesh import axis_index

    tp = TensorParallel(mesh, {}, {}, "data")
    g = torch.Generator().manual_seed(7)
    B, D, F, V, L = 8, 16, 32, 64, 6
    dr, mr = axis_index(mesh, "data"), axis_index(mesh, "model")
    out = {}

    def leaf(*shape):
        return torch.randn(*shape, generator=g)

    # column-parallel in (enter), row-parallel out (row_sum): Megatron's MLP
    x, A, Bw, w = leaf(B, D), leaf(D, F), leaf(F, D), leaf(B, D)
    xl = x.clone().requires_grad_()
    Al = shard_of(A, (None, "model"), mesh).clone().requires_grad_()
    Bl = shard_of(Bw, ("model", None), mesh).clone().requires_grad_()
    (w * tp.row_sum(torch.tanh(tp.enter(xl) @ Al) @ Bl)).sum().backward()
    xw, Aw, Bww = (t.clone().requires_grad_() for t in (x, A, Bw))
    (w * (torch.tanh(xw @ Aw) @ Bww)).sum().backward()
    out["mlp"] = max((xl.grad - xw.grad).abs().max().item(),
                     (Al.grad - shard_of(Aw.grad, (None, "model"), mesh)).abs().max().item(),
                     (Bl.grad - shard_of(Bww.grad, ("model", None), mesh)).abs().max().item())
    # vocabulary-parallel lookup and logits, cross entropy over the vocabulary
    emb = leaf(V, D)
    tok = torch.randint(0, V, (2, L), generator=g)
    tgt = torch.randint(0, V, (2, L), generator=g)
    el = shard_of(emb, ("model", None), mesh).clone().requires_grad_()
    h = tp.embed(el, tok, 2.0)
    lg = tp.logits(torch.tanh(h), el.T)
    torch.nn.functional.cross_entropy(lg.reshape(-1, V), tgt.reshape(-1)).backward()
    ew = emb.clone().requires_grad_()
    hw = ew[tok].to(torch.bfloat16).float() * 2.0
    lw = (torch.tanh(hw).to(torch.bfloat16) @ ew.T.to(torch.bfloat16)).float()
    torch.nn.functional.cross_entropy(lw.reshape(-1, V), tgt.reshape(-1)).backward()
    out["vocab"] = (el.grad - shard_of(ew.grad, ("model", None), mesh)).abs().max().item()
    out["vocab_scale"] = ew.grad.abs().max().item()
    # the MoE's rows: gathered over data, mixed across rows, own rows kept;
    # the global loss is the sum of the data ranks' shares
    X, W = leaf(B, D), leaf(B, D)
    xr = shard_of(X, ("data", None), mesh).clone().requires_grad_()
    ga = tp.gather_rows(xr)
    y = torch.softmax(ga @ ga.T / D, dim=-1) @ ga
    (shard_of(W, ("data", None), mesh) * tp.own_rows(y)).sum().backward()
    Xw = X.clone().requires_grad_()
    (W * (torch.softmax(Xw @ Xw.T / D, dim=-1) @ Xw)).sum().backward()
    out["rows"] = (xr.grad - shard_of(Xw.grad, ("data", None), mesh)).abs().max().item()
    # the all-reduce whose backward sums the cotangent again (torch.distributed.nn)
    # counts the row-parallel gradient model times: the rule the port does not use
    from torch.distributed.nn.functional import all_reduce as nn_all_reduce

    Bl2 = shard_of(Bw, ("model", None), mesh).clone().requires_grad_()
    part = torch.tanh(x @ shard_of(A, (None, "model"), mesh)) @ Bl2
    (w * nn_all_reduce(part, group=tp.model_group)).sum().backward()
    out["nn_all_reduce"] = (Bl2.grad - shard_of(Bww.grad, ("model", None), mesh)).abs().max().item()
    out["coord"] = (dr, mr)
    return out


def pipe_rank(rank: int, inputs: dict) -> dict:
    """``pipeline_forward`` on a ``(pod=4, data=2)`` mesh, each rank its
    stage's weights (``tanh(x @ w)``), against the stages run in sequence;
    then the backward rules on a ``(data=4, model=2)`` mesh."""
    import torch

    from repro_torch.distributed.pipeline import bubble_fraction, pipeline_forward
    from repro_torch.launch.mesh import axis_index, make_host_mesh, make_mesh

    mesh = make_mesh((4, 2), ("pod", "data"), "cpu")
    ws, x = (torch.from_numpy(a) for a in pipe_inputs())
    stage = axis_index(mesh, "pod")
    got = pipeline_forward(lambda w, h, s: torch.tanh(h @ w), ws[stage], x, mesh, axis="pod")
    seq = x
    for w in ws:
        seq = torch.tanh(seq @ w)
    return {"pipe": got.numpy(), "sequential": seq.numpy(), "stage": stage,
            "bubble": bubble_fraction(4, 6), "rules": _rule_checks(make_host_mesh((4, 2)))}
