"""Shared parts of the port's distributed tests (``test_torch_sp_decode.py``,
``test_torch_serve_step.py``): the seeded inputs both packages read, the
JAX side run in a subprocess on eight host devices
(``tests/_torch_dist_ref.py``), and the port's side run by the ranks of one
spawned ``gloo`` group on the CPU, each rank on its own shards.

Numpy only at import: the JAX subprocess imports the inputs from here, and
the spawned ranks import this module and torch, never JAX.
"""
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


def held_to(got, want, want_logits, what):
    """Greedy streams ``(T, B)`` equal, or parting first where the
    reference's top-2 gap is below NEAR_TIE."""
    top2 = np.sort(want_logits, -1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]                  # (T, B)
    for b in range(want.shape[1]):
        diff = np.nonzero(got[:, b] != want[:, b])[0]
        if diff.size:
            t = diff[0]
            assert t > 0 and gap[t - 1, b] < NEAR_TIE, (what, b, t, gap[:, b])


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
    from repro_torch.launch.serve_step import make_serve_step

    shape, batch = SERVE_CASES[name]
    mesh = make_host_mesh(shape)
    cfg = get_smoke_config("gemma3-4b")
    layout = choose_layout(cfg)
    plan = decode_plan(cfg, mesh, batch, layout)
    out = {"plan": plan, "sp": serve_run(inputs, mesh, plan, cfg, plan["batch_spec"], layout)}
    out["plain"] = serve_run(inputs, None, None, cfg, None, layout)
    try:
        make_serve_step(cfg, mesh, {"mode": "heads", "seq_axes": None, "batch_spec": "data"})
        out["heads"] = None
    except NotImplementedError as exc:
        out["heads"] = str(exc)
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


RANK_CASES = {"sp": _sp_rank, "seq_all": _seq_all_rank}
