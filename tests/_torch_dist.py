"""Shared parts of the port's distributed tests (``test_torch_sp_decode.py``,
``test_torch_serve_step.py``, ``test_torch_tp_*.py``): the seeded inputs both packages read, the
JAX side run in a subprocess on eight host devices
(``tests/_torch_dist_ref.py``), and the port's side run by the ranks of one
spawned ``gloo`` group on the CPU, each rank on its own shards.

Numpy only at import: the JAX subprocess imports the inputs from here, and
the spawned ranks import this module and torch, never JAX.
"""
import dataclasses
import os
import pickle
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent

# sequence-parallel attention: the reference's test shapes
# (tests/test_distributed.py:30-34), float32
SP_SHAPE = (8, 4, 2, 64, 16)       # B, Hq, Hkv, S, d
# the reference's three plans: the sequence over model with the batch over
# data; over data with the heads over model; over both
SP_PLANS = (
    dict(seq_axis=("model",), batch_axis="data"),
    dict(seq_axis=("data",), batch_axis=None),
    dict(seq_axis=("data", "model"), batch_axis=None),
)
# the smoke gemma3's serve step: a 52-token prompt in a 64-position cache,
# so under a 4-way sequence split the last block holds 4 valid positions
# and takes every decoded token's K/V
CACHE, PROMPT, NEW_TOKENS = 64, 52, 4
PROMPT_SEED = 3
# name -> (mesh shape over (data, model), batch); decode_plan picks the
# plan: batch 3 does not split over data=2 (seq_all), and the smoke
# model's 2 KV heads do not split over model=4 (seq_model)
SERVE_CASES = {"seq_all": ((2, 2), 3), "seq_model": ((2, 4), 4)}


# tensor-parallel serving (plan ``heads``): case -> (architecture, mesh
# shape over (data, model), MoE capacity factor or None for the config's).
# Layout "2d" on the smoke configs (they pick dp_only); batch 8 splits over
# data, both head counts over model. qwen2's 6 experts over model=4: expert-TP;
# qwen3's 8 over 2: EP. "qwen3-drops" (TP_MOE_ONLY) is the first layer's MoE
# alone on seeded inputs, with a capacity that binds
TP_LAYOUT, TP_BATCH, TP_PROMPT, TP_CACHE, TP_STEPS = "2d", 8, 12, 16, 4
TP_SEED = 11
TP_CASES = {
    "mistral-nemo": ("mistral-nemo-12b", (4, 2), None),
    "qwen3-moe": ("qwen3-moe-30b-a3b", (4, 2), None),
    "qwen3-drops": ("qwen3-moe-30b-a3b", (4, 2), 1.0),
    "gemma3": ("gemma3-4b", (4, 2), None),
    "llama-vision": ("llama-3.2-vision-11b", (4, 2), None),
    "qwen2-moe": ("qwen2-moe-a2.7b", (4, 2), None),
    "musicgen": ("musicgen-large", (4, 2), None),
    "nemotron": ("nemotron-4-15b", (4, 2), None),
    "yi": ("yi-34b", (4, 2), None),
    "musicgen-2x4": ("musicgen-large", (2, 4), None),
    "qwen2-moe-2x4": ("qwen2-moe-a2.7b", (2, 4), None),
}
TP_CASES["qwen2-moe-alone-2x4"] = ("qwen2-moe-a2.7b", (2, 4), None)
TP_MOE_ONLY = ("qwen3-drops", "qwen2-moe-alone-2x4")


def tp_config(name: str, get_smoke_config):
    """The case's smoke config from either package's registry."""
    arch, _, cf = TP_CASES[name]
    cfg = get_smoke_config(arch)
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    return cfg


def tp_prompts(cfg):
    """The case's prompts ``(TP_BATCH, TP_PROMPT)`` and, for a
    cross-attention model, its image embeddings (else None)."""
    rng = np.random.default_rng(TP_SEED)
    toks = rng.integers(0, cfg.vocab_size, (TP_BATCH, TP_PROMPT)).astype(np.int32)
    img = None
    if cfg.cross_kv_len:
        img = rng.standard_normal((TP_BATCH, cfg.cross_kv_len, cfg.d_model)).astype(np.float32)
    return toks, img


def tp_moe_input(cfg):
    """A MoE-only case's input rows ``(TP_BATCH, TP_PROMPT, d_model)``."""
    rng = np.random.default_rng(TP_SEED + 1)
    return rng.standard_normal((TP_BATCH, TP_PROMPT, cfg.d_model)).astype(np.float32)


# the serve step's logits: one bf16 step of their scale, as the smoke
# parity tests hold the single-device step (tests/test_torch_archs.py)
BF16 = dict(rtol=2**-7, atol=2**-7)
# a greedy stream may part from the reference's only below this top-2 gap
NEAR_TIE = 2**-6


def block(x, spec, coord, sizes={"data": 4, "model": 2}):
    """Rank ``coord``'s block of the global ``x`` under ``spec``, as
    ``NamedSharding`` lays it out (a tuple of axes row-major)."""
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        n, idx = 1, 0
        for a in axes:
            idx = idx * sizes[a] + coord[a]
            n *= sizes[a]
        size = x.shape[dim] // n
        x = np.take(x, range(idx * size, (idx + 1) * size), axis=dim)
    return x


def held_to(got, want, want_logits, what, near_tie=NEAR_TIE):
    """Greedy streams ``(T, B)`` equal, or parting first where the
    reference's top-2 gap is below ``near_tie``."""
    top2 = np.sort(want_logits, -1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]                  # (T, B)
    for b in range(want.shape[1]):
        diff = np.nonzero(got[:, b] != want[:, b])[0]
        if diff.size:
            t = diff[0]
            assert t > 0 and gap[t - 1, b] < near_tie, (what, b, t, gap[:, b])


def sp_inputs():
    rng = np.random.default_rng(0)
    B, Hq, Hkv, S, d = SP_SHAPE
    q = rng.standard_normal((B, Hq, d)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, d)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, d)).astype(np.float32)
    ctx = rng.integers(1, S + 1, B).astype(np.int32)
    return q, k, v, ctx


def psum_input():
    return np.random.default_rng(4).standard_normal((4, 33)).astype(np.float32)


def merge_partials(n: int = 4):
    """``n`` ranks' partials ``(o (2, 3, 16), m, l (2, 3))``, one row of
    rank 1 empty (``m = -inf``, ``l = 0``, where there is a rank 1) and one
    row empty on every rank but the last."""
    rng = np.random.default_rng(6)
    o = rng.standard_normal((n, 2, 3, 16)).astype(np.float32)
    m = rng.standard_normal((n, 2, 3)).astype(np.float32)
    l = rng.uniform(0.5, 4.0, (n, 2, 3)).astype(np.float32)
    for rank, (b, h) in [(1, (0, 0))][:n - 1] + [(r, (1, 2)) for r in range(n - 1)]:
        o[rank, b, h], m[rank, b, h], l[rank, b, h] = 0.0, -np.inf, 0.0
    return o, m, l


def run_both(case: str, world: int, tmp: Path):
    """Both sides of ``case``: the weights and prefill cache made here
    (JAX, one device), then the JAX subprocess on eight host devices and
    the port's ``world`` gloo ranks at the same time, each reading them.
    Returns ``(inputs, reference outputs, each rank's outputs)``."""
    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_dist_ref import serve_inputs

    inputs = serve_inputs("seq_model" if case == "sp" else "seq_all")
    in_path, out_path = tmp / "inputs.pkl", tmp / "ref.pkl"
    with open(in_path, "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(ROOT / "src")
    proc = subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_dist_ref.py"), case,
                             str(in_path), str(out_path)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    try:
        ranks = run_ranks(case, world, in_path)
    finally:
        log, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, log
    with open(out_path, "rb") as f:
        return inputs, pickle.load(f), ranks


def run_tp(names, tmp: Path):
    """Both sides of the tensor-parallel cases ``names``: the weights made
    here (JAX, one device), then the JAX subprocess on eight host devices
    and the port's eight gloo ranks at the same time. Returns ``(inputs,
    {case: reference outputs}, each rank's {case: outputs})``."""
    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_dist_ref import tp_inputs

    inputs = tp_inputs(names)
    in_path, out_path = tmp / "inputs.pkl", tmp / "ref.pkl"
    with open(in_path, "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(ROOT / "src")
    proc = subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_dist_ref.py"), "tp",
                             str(in_path), str(out_path)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    try:
        ranks = run_ranks("tp", 8, in_path)
    finally:
        log, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, log
    with open(out_path, "rb") as f:
        return inputs, pickle.load(f), ranks


def _jax_ref(case: str, in_path: Path, out_path: Path, threads: int = 0) -> subprocess.Popen:
    """The JAX side of ``case`` started in a subprocess on eight host
    devices (with ``threads`` 1: XLA's host computations on one thread, so
    that several such subprocesses and the ranks share the cores)."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8" + (
        " --xla_cpu_multi_thread_eigen=false" if threads == 1
        else "")
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(ROOT / "src")
    return subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_dist_ref.py"), case,
                             str(in_path), str(out_path)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)


def run_train(names, tmp: Path, jax_procs: int = 3):
    """Both sides of the sharded-training cases ``names``: the weights made
    here (the port's draw, as numpy), then ``jax_procs`` JAX subprocesses (the cases
    dealt out among them) and the port's eight gloo ranks at the same time;
    the JAX side of a MoE case waits for the routes the ranks record first.
    Returns ``(inputs, {case: reference outputs}, each rank's outputs)``."""
    from _torch_fsdp import train_inputs

    inputs = train_inputs(names, str(tmp / "ckpt"))
    in_path = tmp / "inputs.pkl"
    with open(in_path, "wb") as f:
        pickle.dump(inputs, f)
    groups = [list(names)[i::jax_procs] for i in range(jax_procs)]
    groups = [g for g in groups if g]
    procs = [(_jax_ref("train:" + ",".join(g), in_path, tmp / f"ref{i}.pkl", threads=1),
              tmp / f"ref{i}.pkl") for i, g in enumerate(groups)]
    try:
        ranks = run_ranks("train", 8, in_path)
    except BaseException:
        for p, _ in procs:             # nothing left waiting for the ranks' routes
            p.kill()
        raise
    finally:
        logs = [(p.communicate(timeout=900)[0], p.returncode) for p, _ in procs]
    ref = {}
    for (log, rc), (_, path) in zip(logs, procs):
        assert rc == 0, log
        with open(path, "rb") as f:
            ref.update(pickle.load(f))
    return inputs, ref, ranks


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank: int, world: int, port: int, case: str, in_path: str, out_dir: str):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_distributed

    init_distributed(rank, world, port, "gloo")
    try:
        with open(in_path, "rb") as f:
            inputs = pickle.load(f)
        res = RANK_CASES[case](rank, inputs)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def run_ranks(case: str, world: int, in_path: Path) -> list:
    """Spawn ``world`` gloo ranks running ``RANK_CASES[case]``; their
    results, by rank. A rank that raises fails the call."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as out:
        mp.spawn(_entry, args=(world, _free_port(), case, str(in_path), out), nprocs=world)
        res = []
        for r in range(world):
            with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
                res.append(pickle.load(f))
        return res


# ------------------------------------------------------------ rank cases
def _np(t):
    return t.detach().float().cpu().numpy()


def serve_run(inputs: dict, mesh, plan, cfg, batch_spec, layout) -> dict:
    """The smoke gemma3 served from the JAX prefill's cache (``inputs``): this rank's
    blocks of the cache (``cache_specs``) and of the batch, greedy from the
    prefill's logits for ``NEW_TOKENS`` steps; its logits and tokens."""
    import torch

    from repro_torch.core.distributed import shard_of
    from repro_torch.distributed.sharding import P, cache_specs
    from repro_torch.launch.serve_step import make_serve_step
    from repro_torch.models import cache_from_numpy, params_from_numpy

    params = params_from_numpy(inputs["params"], cfg, device="cpu")
    full = cache_from_numpy(inputs["cache"], cfg, device="cpu")
    batch = full[0]["k"].shape[0]
    if mesh is None:
        cache, rows = full, P(None)
    else:
        specs = cache_specs(full, mesh, batch, layout, plan, cache_len=CACHE)
        cache = [{k: shard_of(t, s[k], mesh).clone() for k, t in lc.items()}
                 for lc, s in zip(full, specs)]
        rows = P(batch_spec)
    step = make_serve_step(cfg, mesh, plan)
    first = torch.from_numpy(np.asarray(inputs["first"]))
    tok = shard_of(first.argmax(-1)[:, None].to(torch.int32), rows, mesh) if mesh is not None \
        else first.argmax(-1)[:, None].to(torch.int32)
    logits, tokens = [], []
    for t in range(NEW_TOKENS):
        lg, cache = step(params, cache, tok, PROMPT + t)
        tokens.append(tok[:, 0].numpy().copy())
        logits.append(_np(lg))
        tok = lg.argmax(-1)[:, None].to(torch.int32)
    return {"logits": np.stack(logits), "tokens": np.stack(tokens),
            "cache": [{k: _np(t) for k, t in lc.items()} for lc in cache]}


def _serve_rank(inputs: dict, name: str) -> dict:
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import choose_layout, decode_plan
    from repro_torch.launch.mesh import make_host_mesh

    shape, batch = SERVE_CASES[name]
    mesh = make_host_mesh(shape)
    cfg = get_smoke_config("gemma3-4b")
    layout = choose_layout(cfg)
    plan = decode_plan(cfg, mesh, batch, layout)
    out = {"plan": plan, "sp": serve_run(inputs, mesh, plan, cfg, plan["batch_spec"], layout)}
    out["plain"] = serve_run(inputs, None, None, cfg, None, layout)
    return out


def _sp_rank(rank: int, inputs: dict) -> dict:
    import torch
    import torch.distributed as dist

    from repro_torch.core.distributed import (lean_merge_collective, shard_of,
                                              sp_decode_attention, sp_specs)
    from repro_torch.core.merge import AttnPartial
    from repro_torch.distributed.collectives import compressed_psum, psum_mean
    from repro_torch.launch.mesh import (axis_group, axis_index, make_host_mesh,
                                         make_production_mesh)

    mesh = make_host_mesh((4, 2))
    refused = []
    for multi_pod in (False, True):
        try:
            make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        except ValueError as exc:
            refused.append(str(exc))
    q, k, v, ctx = (torch.from_numpy(a) for a in sp_inputs())
    B, Hq, Hkv, S, d = SP_SHAPE
    out = {"coord": (axis_index(mesh, "data"), axis_index(mesh, "model")), "refused": refused}
    for i, kw in enumerate(SP_PLANS):
        sp = sp_specs(mesh, B, Hq, Hkv, head_axis="model", **kw)
        got = sp_decode_attention(shard_of(q, sp["q"], mesh), shard_of(k, sp["kv"], mesh),
                                  shard_of(v, sp["kv"], mesh), mesh, head_axis="model",
                                  ctx_len=shard_of(ctx, sp["ctx"], mesh), **kw)
        out[f"plan{i}"] = (_np(got), tuple(sp["out"]))
    # the merge over the data axis: 4 ranks, each with its own partials
    o, m, l = merge_partials(4)
    i = axis_index(mesh, "data")
    part = AttnPartial(*(torch.from_numpy(a[i]) for a in (o, m, l)))
    out["merge"] = _np(lean_merge_collective(part, axis_group(mesh, "data")))
    x = torch.from_numpy(psum_input())
    out["psum"] = _np(compressed_psum(shard_of(x, ("data",), mesh), mesh, axis="data"))
    out["psum_mean"] = _np(psum_mean(shard_of(x, ("data",), mesh), mesh, axis="data"))
    dist.barrier()
    out.update(_serve_rank(inputs, "seq_model"))
    return out


def _recurrent_rank() -> bool:
    """recurrentgemma's smoke model has no global attention layer: under
    ``decode_plan``'s ``seq_all`` every rank runs the whole step, equal to
    the ``mesh=None`` step."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import choose_layout, decode_plan
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve_step import make_serve_step
    from repro_torch.models import init_cache, init_params

    cfg = get_smoke_config("recurrentgemma-9b")
    mesh = make_host_mesh(SERVE_CASES["seq_all"][0])
    batch = SERVE_CASES["seq_all"][1]
    plan = decode_plan(cfg, mesh, batch, choose_layout(cfg))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tok = torch.arange(batch, dtype=torch.int32)[:, None]
    out = []
    for step in (make_serve_step(cfg, mesh, plan), make_serve_step(cfg)):
        cache = init_cache(cfg, batch, CACHE, device="cpu")
        out.append(step(params, cache, tok, 0)[0])
    return plan["mode"] == "seq_all" and torch.equal(out[0], out[1])


def _seq_all_rank(rank: int, inputs: dict) -> dict:
    out = _serve_rank(inputs, "seq_all")
    out["recurrent_whole"] = _recurrent_rank()
    return out


def router_stats(p, x, cfg):
    """A MoE call's routing recomputed as :func:`repro_torch.models.moe.
    moe_forward` does it: the token-expert pairs dropped (each group's
    pairs past an expert's capacity), and each batch row's smallest router
    margin (the k-th largest probability less the (k+1)-th: below a
    rounding's reach, the choice can flip between two computations that
    round differently)."""
    import torch

    from repro_torch.models.moe import _auto_groups, capacity, top_k

    B, L, D = x.shape
    T = B * L
    G = _auto_groups(T)
    while T % G:
        G //= 2
    xt = x.reshape(G, T // G, D).to(torch.bfloat16)
    probs = torch.softmax((xt @ p["router"].to(torch.bfloat16)).float(), dim=-1)
    vals, idx = top_k(probs, cfg.top_k + 1)
    counts = torch.nn.functional.one_hot(idx[..., :cfg.top_k], cfg.num_experts).sum((1, 2))
    drops = int((counts - capacity(cfg, T // G)).clamp(min=0).sum())
    margin = (vals[..., -2] - vals[..., -1]).reshape(B, L).amin(1)
    return drops, margin.numpy()


def tp_serve(cfg, params, inputs, mesh=None, plan=None) -> dict:
    """A case served from its prompts: ``make_prefill_step`` then
    ``TP_STEPS`` greedy ``make_serve_step`` steps, on this rank's rows
    (``mesh``/``plan``) or whole (None); the first logits, the prefill's
    cache, each step's logits and tokens."""
    import torch

    from repro_torch.core.distributed import shard_of
    from repro_torch.distributed.sharding import P
    from repro_torch.launch.serve_step import make_prefill_step, make_serve_step

    toks = torch.from_numpy(inputs["tokens"])
    img = None if inputs["img"] is None else torch.from_numpy(inputs["img"])
    if mesh is not None:
        rows = plan["batch_spec"]
        toks = shard_of(toks, P(rows, None), mesh)
        img = None if img is None else shard_of(img, P(rows, None, None), mesh)
    first, cache, cur = make_prefill_step(cfg, TP_CACHE, mesh, plan, TP_LAYOUT)(params, toks, img)
    out = {"first": _np(first), "cache": [{k: _np(t) for k, t in lc.items()} for lc in cache]}
    step = make_serve_step(cfg, mesh, plan, TP_LAYOUT)
    tok = first.argmax(-1)[:, None].to(torch.int32)
    logits, tokens = [], []
    for t in range(TP_STEPS):
        lg, cache = step(params, cache, tok, cur + t)
        tokens.append(tok[:, 0].numpy().copy())
        logits.append(_np(lg))
        tok = lg.argmax(-1)[:, None].to(torch.int32)
    out.update(logits=np.stack(logits), tokens=np.stack(tokens))
    return out


def tp_moe(rank: int, cfg, whole, specs, inp, mesh, plan) -> dict:
    """A MoE-only case: the first layer's MoE on this rank's rows of the
    input (its experts, the global batch's routing), the same with each
    data rank routing only its own rows (the control), and on rank 0 the
    MoE whole on one device with its drops."""
    import dataclasses

    import torch

    from repro_torch.core.distributed import shard_of
    from repro_torch.distributed.sharding import P, shard_tree
    from repro_torch.distributed.tensor_parallel import tensor_parallel
    from repro_torch.models.transformer import moe_part

    tp = tensor_parallel(cfg, mesh, plan, TP_LAYOUT)
    local = {"moe": shard_tree(whole["layers"][0]["moe"], specs["layers"][0]["moe"], mesh)}
    sh = tp.layer(0, local)
    x = torch.from_numpy(inp["x"])
    rows = shard_of(x, P(plan["batch_spec"], None, None), mesh)
    out = {"moe": _np(moe_part(local["moe"], rows, cfg, sh)),
           "local_routing": _np(moe_part(local["moe"], rows, cfg,
                                         dataclasses.replace(sh, rows=None))),
           "expert_offset": sh.expert_offset}
    if rank == 0:
        p0 = whole["layers"][0]["moe"]
        out["one"] = {"moe": _np(moe_part(p0, x, cfg)), "drops": router_stats(p0, x, cfg.moe)[0]}
    return out


def tree_cut(tree, cfg, specs, local, mesh) -> dict:
    """``shard_tree``'s blocks against numpy's: each leaf of the JAX tree
    (in the port's layout, ``params_from_numpy``) cut by :func:`block` at
    this rank's coordinates under its spec. The leaves that differ (none
    expected), and how many leaves the specs split."""
    from repro_torch.distributed.sharding import spec_paths
    from repro_torch.launch.mesh import axis_index, mesh_axes
    from repro_torch.models import params_from_numpy
    from repro_torch.training.tree import flatten

    sizes = mesh_axes(mesh)
    coord = {a: axis_index(mesh, a) for a in sizes}
    paths, leaves = flatten(params_from_numpy(tree, cfg, device="cpu"))
    got = dict(zip(*flatten(local)))
    spec = spec_paths(specs)
    bad = [p for p, leaf in zip(paths, leaves)
           if not np.array_equal(block(leaf.float().numpy(), spec[p], coord, sizes),
                                 got[p].float().numpy())]
    return {"bad": bad, "split": sum(any(a is not None for a in spec[p]) for p in paths),
            "leaves": len(paths)}


def drawn_blocks(cfg, mesh) -> bool:
    """``init_params`` with a ``shard`` hook (each leaf's block kept as it
    is drawn) gives ``shard_tree`` of the whole draw, and the specs of
    ``abstract_params`` (meta shapes) are the whole draw's."""
    import torch

    from repro_torch.core.distributed import shard_of
    from repro_torch.distributed.sharding import param_specs, shard_tree, spec_paths
    from repro_torch.distributed.tensor_parallel import abstract_params
    from repro_torch.models import init_params
    from repro_torch.training.tree import flatten

    full = init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    specs = param_specs(full, mesh, cfg, TP_LAYOUT, mode="serve")
    by = spec_paths(specs)
    if by != spec_paths(param_specs(abstract_params(cfg), mesh, cfg, TP_LAYOUT, mode="serve")):
        return False
    drawn = init_params(cfg, torch.Generator().manual_seed(5), device="cpu",
                        shard=lambda path, t: shard_of(t, by[path], mesh).clone())
    a, b = flatten(drawn), flatten(shard_tree(full, specs, mesh))
    return a[0] == b[0] and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))


def _tp_rank(rank: int, inputs: dict) -> dict:
    """Every case on this rank: its blocks of the parameters
    (``shard_tree`` by ``param_specs(mode="serve")``), its rows, served
    under ``decode_plan``'s plan; rank 0 also serves each case whole on one
    device, with each MoE call's drops and per-row router margins."""
    import repro_torch.models.transformer as tf
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import decode_plan, param_specs, shard_tree
    from repro_torch.launch.mesh import axis_index, make_host_mesh
    from repro_torch.models import params_from_numpy

    meshes, out = {}, {}
    for name, inp in inputs.items():
        cfg = tp_config(name, get_smoke_config)
        shape = TP_CASES[name][1]
        mesh = meshes.setdefault(shape, make_host_mesh(shape))
        plan = decode_plan(cfg, mesh, TP_BATCH, TP_LAYOUT)
        whole = params_from_numpy(inp["params"], cfg, device="cpu")
        specs = param_specs(whole, mesh, cfg, TP_LAYOUT, mode="serve")
        if name in TP_MOE_ONLY:
            res = tp_moe(rank, cfg, whole, specs, inp, mesh, plan)
        else:
            local = shard_tree(whole, specs, mesh)
            res = tp_serve(cfg, local, inp, mesh, plan)
            res["cut"] = tree_cut(inp["params"], cfg, specs, local, mesh)
            res["drawn"] = drawn_blocks(cfg, mesh)
        res.update(plan=plan, coord=(axis_index(mesh, "data"), axis_index(mesh, "model")))
        if rank == 0 and name not in TP_MOE_ONLY:
            stats, moe = [], tf.moe_forward

            def counted(p, x, mcfg, **kw):
                stats.append(router_stats(p, x, mcfg))
                return moe(p, x, mcfg, **kw)

            tf.moe_forward = counted
            try:
                res["one"] = tp_serve(cfg, whole, inp)
            finally:
                tf.moe_forward = moe
            res["one"]["drops"] = [d for d, _ in stats]
            # (calls, B): the prefill's MoE calls, then each step's
            res["one"]["router_margins"] = np.stack([m for _, m in stats]) if stats else None
        out[name] = res
    return out


def _train_rank(rank: int, inputs: dict) -> dict:
    from _torch_fsdp import train_rank

    return train_rank(rank, inputs)


def _pipe_rank(rank: int, inputs: dict) -> dict:
    from _torch_fsdp import pipe_rank

    return pipe_rank(rank, inputs)


RANK_CASES = {"sp": _sp_rank, "seq_all": _seq_all_rank, "tp": _tp_rank, "train": _train_rank,
              "pipe": _pipe_rank}


# ------------------------------------------------------------ tensor-parallel checks
# The tensor-parallel logits against JAX's sharded steps and the port's
# one-device steps: 2**-4 relative plus 2**-4 absolute (eight bf16 steps of
# their scale). Each rank's wo/wd product is a bf16 partial, so a sharded
# step rounds where the one-device step does not: on these inputs JAX's own
# sharded steps part from its one-device steps by up to 4.4 of the smoke
# parity tests' steps (BF16) on the dense models, and the port's by 4.5.
TP_TOL = dict(rtol=2**-4, atol=2**-4)
# a MoE row's logits are held against the one-device step, and its decode
# steps against any run, only while every routing of it so far (on one
# device) kept its k-th expert this far above the (k+1)-th: closer, the
# sharded step's rounding (and K2's against the reference's plain decode)
# may flip the choice. The smoke routers' probabilities tie exactly in bf16
# in many rows; flips were seen at margins up to 0.0028
ROUTER_MARGIN = 2**-7
# a greedy stream may part from another's where the top-2 gap is below
# this: the sharded steps' logits move by up to about 0.04 on these inputs
TP_NEAR_TIE = 2**-4


def tp_coord(res, name):
    """A rank's coordinates, the mesh's sizes and the batch's spec."""
    shape = TP_CASES[name][1]
    return (dict(zip(("data", "model"), res["coord"])), {"data": shape[0], "model": shape[1]},
            res["plan"]["batch_spec"])


def tp_held(ranks, name):
    """Which global rows a case holds at its prefill and at each decode
    step, ``(1 + TP_STEPS, TP_BATCH)``: every row of a model without a MoE;
    a MoE row while every routing of it so far kept ROUTER_MARGIN."""
    m = ranks[0][name]["one"]["router_margins"]
    if m is None:
        return np.ones((1 + TP_STEPS, TP_BATCH), bool)
    per = len(m) // (1 + TP_STEPS)               # MoE calls a forward
    return np.stack([m[:per * (t + 1)].min(0) >= ROUTER_MARGIN for t in range(1 + TP_STEPS)])


def tp_against(res, want, name, held, what, first_all=False):
    """A rank's first logits and greedy steps against a global run
    (``want``: ``first``, ``logits``, ``tokens``) where ``held``
    (:func:`tp_held`; ``first_all``: the first logits on every row): the
    first logits within TP_TOL, the streams equal or parting at a near tie,
    each step's logits within TP_TOL while the streams agree. Returns how
    many (step, row) logits it held."""
    coord, sizes, bdp = tp_coord(res, name)
    held = block(held, (None, bdp), coord, sizes)
    rows = np.ones_like(held[0]) if first_all else held[0]
    first = block(want["first"], (bdp, None), coord, sizes)
    np.testing.assert_allclose(res["first"][rows], first[rows], **TP_TOL, err_msg=what)
    tokens = block(want["tokens"], (None, bdp), coord, sizes)
    logits = block(want["logits"], (None, bdp, None), coord, sizes)
    # a stream from its first token (the prefill's argmax) up to the step
    # its rows stop being held; a row of zeros ahead of the streams puts
    # each token after the logits it was chosen from
    n = 0
    for b in np.nonzero(held[0])[0]:
        T = int(np.argmin(held[1:, b])) if not held[1:, b].all() else len(tokens)
        pad = np.zeros((1, 1), tokens.dtype)
        held_to(np.concatenate([pad, res["tokens"][:T + 1, b:b + 1]]),
                np.concatenate([pad, tokens[:T + 1, b:b + 1]]),
                np.concatenate([first[None, b:b + 1], logits[:T, b:b + 1]]), what, TP_NEAR_TIE)
        agree = int(np.argmin(res["tokens"][:, b] == tokens[:, b])) if (
            res["tokens"][:, b] != tokens[:, b]).any() else len(tokens)
        upto = min(T, agree)
        np.testing.assert_allclose(res["logits"][:upto, b], logits[:upto, b], **TP_TOL,
                                   err_msg=f"{what} row {b}")
        n += upto
    return n


def tp_model_groups_equal(ranks, name):
    """The ranks of each ``model`` group (one data coordinate) hold the same
    rows and return the same bits: their reductions and gathers end alike."""
    groups = {}
    for r, res in enumerate(ranks):
        groups.setdefault(res[name]["coord"][0], []).append(res[name])
    for data, group in groups.items():
        for res in group[1:]:
            for key in ("first", "logits", "tokens"):
                assert np.array_equal(res[key], group[0][key]), (name, data, key)
    return len(groups)


def tp_cache_blocks(ref, ranks, name):
    """Each rank's prefill cache (its rows, its KV heads; window rings and
    cross K/V too) against its block of JAX's sharded prefill cache under
    the port's ``cache_specs``: the first layer's within BF16 (its K/V come
    from the embeddings, before any reduction), the others within TP_TOL."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import cache_specs, decode_plan, spec_paths
    from repro_torch.models import cache_from_numpy

    cfg = tp_config(name, get_smoke_config)
    want = cache_from_numpy(ref[name]["cache"], cfg, device="cpu")
    for i, r in enumerate(ranks):
        coord, sizes, bdp = tp_coord(r[name], name)
        mesh = type("FakeMesh", (), {"shape": sizes})()
        plan = decode_plan(cfg, mesh, TP_BATCH, TP_LAYOUT)
        specs = spec_paths(cache_specs(want, mesh, TP_BATCH, TP_LAYOUT, plan, cache_len=TP_CACHE))
        for layer, (got, lc) in enumerate(zip(r[name]["cache"], want)):
            for key, t in got.items():
                spec = specs[f"{layer}/{key}"]
                assert spec[0] == bdp and spec[1] == "model", (name, layer, key, spec)
                np.testing.assert_allclose(t, block(lc[key].float().numpy(), spec, coord, sizes),
                                           **(BF16 if layer == 0 else TP_TOL),
                                           err_msg=f"{name} rank {i} layer {layer} {key}")
