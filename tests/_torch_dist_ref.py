"""The JAX side of the port's distributed tests, run in a subprocess on a
host mesh of eight CPU devices (the device count is fixed before JAX
starts, as ``tests/test_distributed.py`` does).

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python tests/_torch_dist_ref.py CASE INPUTS.pkl OUT.pkl

``CASE`` is ``sp`` (sequence-parallel attention on the reference's three
plans, the int8 all-reduce, the smoke gemma3's serve step under
``seq_model`` on a ``(2, 4)`` mesh), ``seq_all`` (its serve step under
``seq_all`` on a ``(2, 2)`` mesh), ``tp`` (tensor-parallel serving:
the prefill and serve steps of the smoke configurations in ``INPUTS.pkl``
under plan ``heads``, :func:`tp_case`), ``train:NAME,NAME`` (the sharded
train steps of those cases of ``INPUTS.pkl``, :func:`train_case`) or
``pipe`` (``pipeline_forward``, :func:`pipe_case`). The attention inputs come from numpy
generators with the seeds of ``tests/_torch_dist.py``; the weights and the
prefill's cache from ``INPUTS.pkl`` (:func:`serve_inputs`, made by the
test's own process, which hands the same file to the port's ranks); the
outputs go to ``OUT.pkl``.
"""
import contextlib
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from _torch_fsdp import (  # noqa: E402
    ACCUM,
    OPT_KW,
    REPLAYED,
    TRAIN_BATCH,
    TRAIN_CASES,
    TRAIN_SEQ,
    WIDENED,
    pipe_inputs,
    read_routes,
    routes_path,
    train_config,
)
from _torch_dist import (  # noqa: E402
    CACHE,
    NEW_TOKENS,
    PROMPT,
    PROMPT_SEED,
    SERVE_CASES,
    SP_PLANS,
    TP_BATCH,
    TP_CACHE,
    TP_CASES,
    TP_LAYOUT,
    TP_MOE_ONLY,
    TP_PROMPT,
    TP_STEPS,
    psum_input,
    sp_inputs,
    tp_config,
    tp_moe_input,
    tp_prompts,
)


def np_tree(t):
    return jax.tree.map(np.asarray, t)


def sp_case() -> dict:
    from repro.core.attention import mha_decode_ref
    from repro.core.distributed import sp_decode_attention
    from repro.distributed.collectives import compressed_psum

    mesh = jax.make_mesh((4, 2), ("data", "model"))
    q, k, v, ctx = (jnp.asarray(a) for a in sp_inputs())
    out = {"ref": np.asarray(mha_decode_ref(q, k, v, ctx_lens=ctx))}
    for i, kw in enumerate(SP_PLANS):
        fn = jax.jit(lambda *a, kw=kw: sp_decode_attention(*a[:3], mesh, head_axis="model",
                                                           ctx_len=a[3], **kw))
        out[f"plan{i}"] = np.asarray(fn(q, k, v, ctx))
    psum = jax.jit(lambda x: compressed_psum(x, mesh, axis="data"))
    out["psum"] = np.asarray(psum(jnp.asarray(psum_input())))
    return out


def serve_inputs(name: str) -> dict:
    """The smoke gemma3's weights and the cache of its prompts' prefill (on
    one device: the caller's process), and the first token's logits."""
    from repro.configs import get_smoke_config
    from repro.models import init_params, prefill

    _, batch = SERVE_CASES[name]
    cfg = get_smoke_config("gemma3-4b")
    params = init_params(jax.random.PRNGKey(0), cfg)
    toks = np.random.default_rng(PROMPT_SEED).integers(0, cfg.vocab_size, (batch, PROMPT))
    first, cache, _ = jax.jit(lambda p, t: prefill(p, cfg, t, cache_len=CACHE))(
        params, jnp.asarray(toks, jnp.int32))
    return {"params": np_tree(params), "cache": np_tree(cache), "first": np.asarray(first)}


def auto_mesh(shape):
    """A ``(data, model)`` mesh of the first devices with Auto axes, as the
    reference's meshes were before JAX made Explicit the default: under
    Explicit axes the step's reshape of the sharded attention output is
    refused."""
    n = int(np.prod(shape))
    return jax.make_mesh(shape, ("data", "model"), devices=jax.devices()[:n],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def tp_inputs(names) -> dict:
    """Each tensor-parallel case's weights (``init_params`` of key 0, on
    the caller's one device), prompts and image embeddings (the vision
    model's), as numpy."""
    from repro.configs import get_smoke_config
    from repro.models import init_params

    out = {}
    for name in names:
        cfg = tp_config(name, get_smoke_config)
        toks, img = tp_prompts(cfg)
        out[name] = {"params": np_tree(init_params(jax.random.PRNGKey(0), cfg)),
                     "tokens": toks, "img": img}
        if name in TP_MOE_ONLY:
            out[name]["x"] = tp_moe_input(cfg)
    return out


def tp_moe_case(name: str, inputs: dict) -> dict:
    """A MoE-only case: the first layer's ``moe_forward`` under
    ``jax.jit``, its leaves placed by ``param_specs(mode="serve")`` and the
    input rows by the plan's batch spec."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.configs import get_smoke_config
    from repro.distributed.sharding import decode_plan, param_specs, to_named
    from repro.models.moe import moe_forward

    cfg = tp_config(name, get_smoke_config)
    mesh = auto_mesh(TP_CASES[name][1])
    plan = decode_plan(cfg, mesh, TP_BATCH, TP_LAYOUT)
    params = jax.tree.map(jnp.asarray, inputs["params"])
    pspec = param_specs(params, mesh, cfg, TP_LAYOUT, mode="serve")["stages"][0][0]["moe"]
    p = jax.tree.map(lambda a: a[0], params["stages"][0][0]["moe"])
    spec = jax.tree.map(lambda s: P(*s[1:]), pspec, is_leaf=lambda s: isinstance(s, P))
    p = jax.device_put(p, to_named(spec, mesh))
    x = jax.device_put(jnp.asarray(inputs["x"]), NamedSharding(mesh, P(plan["batch_spec"], None,
                                                                        None)))
    out = jax.jit(lambda p, x: moe_forward(p, x, cfg.moe)[0])(p, x)
    return {"plan": plan, "moe": np.asarray(out)}


def tp_case(name: str, inputs: dict) -> dict:
    """The reference's sharded prefill and serve steps (``repro/launch/
    dryrun.py:134-169``) for one case: parameters placed by
    ``param_specs(mode="serve")``, the prompts and image embeddings by the
    plan's batch spec, the prefill's cache by ``cache_specs``, both steps
    under ``jax.jit``; greedy for ``TP_STEPS`` tokens from the prefill's
    logits."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.configs import get_smoke_config
    from repro.distributed.sharding import cache_specs, decode_plan, param_specs, to_named
    from repro.launch.serve_step import make_prefill_step, make_serve_step

    cfg = tp_config(name, get_smoke_config)
    mesh = auto_mesh(TP_CASES[name][1])
    plan = decode_plan(cfg, mesh, TP_BATCH, TP_LAYOUT)
    bdp = plan["batch_spec"]
    params = jax.tree.map(jnp.asarray, inputs["params"])
    params = jax.device_put(params, to_named(param_specs(params, mesh, cfg, TP_LAYOUT,
                                                         mode="serve"), mesh))
    tok = jax.device_put(jnp.asarray(inputs["tokens"], jnp.int32), NamedSharding(mesh, P(bdp, None)))
    args = [params, tok]
    if inputs["img"] is not None:
        args.append(jax.device_put(jnp.asarray(inputs["img"]),
                                   NamedSharding(mesh, P(bdp, None, None))))
    first, cache, cur = jax.jit(make_prefill_step(cfg, TP_CACHE))(*args)
    cache = jax.device_put(cache, to_named(cache_specs(cache, mesh, TP_BATCH, TP_LAYOUT, plan=plan,
                                                       cache_len=TP_CACHE), mesh))
    out = {"plan": plan, "first": np.asarray(first), "cache": np_tree(cache)}
    step = jax.jit(make_serve_step(cfg, mesh, plan))
    tok = jnp.argmax(first, -1)[:, None].astype(jnp.int32)
    logits, tokens = [], []
    for t in range(TP_STEPS):
        lg, cache = step(params, cache, tok, jnp.asarray(TP_PROMPT + t, jnp.int32))
        tokens.append(np.asarray(tok)[:, 0])
        logits.append(np.asarray(lg))
        tok = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
    out.update(logits=np.stack(logits), tokens=np.stack(tokens))
    return out


def serve_case(name: str, inputs: dict) -> dict:
    """``make_serve_step`` under ``decode_plan``'s plan for the case's mesh
    and batch, greedy from the prefill's logits."""
    from repro.configs import get_smoke_config
    from repro.distributed.sharding import choose_layout, decode_plan
    from repro.launch.serve_step import make_serve_step

    shape, batch = SERVE_CASES[name]
    mesh = auto_mesh(shape)
    cfg = get_smoke_config("gemma3-4b")
    params = jax.tree.map(jnp.asarray, inputs["params"])
    plan = decode_plan(cfg, mesh, batch, choose_layout(cfg))
    step = jax.jit(make_serve_step(cfg, mesh, plan))
    c = jax.tree.map(jnp.asarray, inputs["cache"])
    tok, logits, tokens = jnp.argmax(inputs["first"], -1)[:, None].astype(jnp.int32), [], []
    for t in range(NEW_TOKENS):
        lg, c = step(params, c, tok, jnp.asarray(PROMPT + t, jnp.int32))
        tokens.append(np.asarray(tok)[:, 0])
        logits.append(np.asarray(lg))
        tok = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
    return {"plan": plan, "logits": np.stack(logits), "tokens": np.stack(tokens),
            "cache": np_tree(c)}


def _step_out(p, o, m) -> dict:
    return {"metrics": {k: float(v) for k, v in m.items()}, "params": np_tree(p),
            "m": np_tree(o["m"]), "v": np_tree(o["v"])}


@contextlib.contextmanager
def replayed_top_k(recorded):
    """``jax.lax.top_k`` -- which the reference's MoE routes with -- patched
    in this process while the steps are traced: each call takes, of the
    recorded calls ``recorded`` (arrays ``(C, G, Tg, K)``, one per token
    count, padded with -1), the one that agrees with its own choice on the
    most tokens, and returns those experts and their probabilities (the
    port's replay, ``tests/_torch_fsdp.py::routing``). Choosing by
    agreement needs no call order: the scanned layers and micro-batches
    and the rematerialized forward each find their own record."""
    base = jax.lax.top_k

    def patched(probs, k):
        _, idx = base(probs, k)
        for rec in recorded:
            if rec.shape[1:] == idx.shape:
                own = jnp.sort(idx, axis=-1)
                score = (jnp.sort(rec, axis=-1) == own[None]).all(-1).sum(
                    axis=tuple(range(1, idx.ndim)))
                pick = rec[jnp.argmax(score)].astype(idx.dtype)
                return jnp.take_along_axis(probs, pick, axis=-1), pick
        raise ValueError(f"no recorded routes for a top_k of {idx.shape}")

    jax.lax.top_k = patched
    try:
        yield
    finally:
        jax.lax.top_k = base


def train_case(name: str, inputs: dict) -> dict:
    """The reference's sharded train step (``repro/launch/dryrun.py:
    110-132``) for one case: ``make_train_step(..., grad_accum,
    grad_specs=to_named(pspec, mesh))`` with the parameters and both
    moments placed by ``param_specs`` (mode "train") and the batch by
    ``batch_specs``, under ``activation_mesh(mesh, dp=dp_axes(mesh,
    layout))`` on an Auto mesh: step 1 from the weights, step 2 from the
    carried state (``grad_accum`` 2), and the compressed step from the
    weights (``grad_accum`` 1); and for the ``WIDENED`` cases the same steps
    on one device (plain ``jax.jit``), whose gap from the sharded ones is
    as far as the port may widen a tolerance. The plain and the
    compressed step are jitted as one program (one compile; each output is
    its step's, bit for bit). A ``REPLAYED`` (MoE) case waits for the
    expert choices the port's sharded steps recorded and routes by them
    (:func:`replayed_top_k`)."""
    from jax.sharding import NamedSharding

    from repro.configs import get_smoke_config
    from repro.data.pipeline import DataConfig, batch_at
    from repro.distributed.hints import activation_mesh
    from repro.distributed.sharding import batch_specs, dp_axes, param_specs, to_named
    from repro.training.optimizer import OptConfig, adamw_init
    from repro.training.train_loop import make_train_step

    inp = inputs["cases"][name]
    _, shape, layout = TRAIN_CASES[name]
    cfg = train_config(name, get_smoke_config)
    mesh = auto_mesh(shape)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                    seed=5, img_tokens=cfg.cross_kv_len, d_model=cfg.d_model)
    batch = {k: jnp.asarray(v) for k, v in batch_at(dc, 3).items()}
    params = jax.tree.map(jnp.asarray, inp["params"])
    opt = OptConfig(**OPT_KW)
    state = inp["state"]
    starts = {"s1": (params, adamw_init(params)),
              "s2": (jax.tree.map(jnp.asarray, state["params"]),
                     {"m": jax.tree.map(jnp.asarray, state["m"]),
                      "v": jax.tree.map(jnp.asarray, state["v"]),
                      "step": jnp.asarray(1, jnp.int32)})}
    named = to_named(param_specs(params, mesh, cfg, layout), mesh)
    bspec = batch_specs(mesh, TRAIN_BATCH, has_img="img_emb" in batch, layout=layout)
    placed = {k: jax.device_put(v, NamedSharding(mesh, bspec[k])) for k, v in batch.items()}
    out = {"one": {}}
    # the MoE cases take the port's sharded steps' expert choices: step s1's
    # and s2's for the plain step, c's for the compressed one
    routes = ({k: read_routes(routes_path(inputs, name, k)) for k in ("s1", "s2", "c")}
              if name in REPLAYED else {})

    def jitted(plain, comp):
        """The plain and the compressed step as one program, called with
        the step's key (its routes where the case replays them)."""
        if not routes:
            step = jax.jit(lambda p, o, b: (plain(p, o, b), comp(p, o, b)))
            return lambda p, o, b, key: step(p, o, b)
        step = jax.jit(lambda p, o, b, rp, rc: _replayed(plain, comp, p, o, b, rp, rc))
        return lambda p, o, b, key: step(p, o, b, routes[key], routes["c"])

    with activation_mesh(mesh, dp=dp_axes(mesh, layout)):
        plain, comp = (make_train_step(cfg, opt, grad_accum=ACCUM[k], compress_grads=k == "c",
                                       grad_specs=named) for k in ("s1", "c"))
        both = jitted(plain, comp)
        for key in ("s1", "s2"):
            p, o = starts[key]
            o = {"m": jax.device_put(o["m"], named), "v": jax.device_put(o["v"], named),
                 "step": o["step"]}
            res, res_c = both(jax.device_put(p, named), o, placed, key)
            out[key] = _step_out(*res)
            if key == "s1":
                out["c"] = _step_out(*res_c)
    if name not in WIDENED:
        return out
    plain, comp = (make_train_step(cfg, opt, grad_accum=ACCUM[k], compress_grads=k == "c")
                   for k in ("s1", "c"))
    one = jitted(plain, comp)
    for key in ("s1", "s2"):
        res, res_c = one(*starts[key], batch, key)
        out["one"][key] = _step_out(*res)
        if key == "s1":
            out["one"]["c"] = _step_out(*res_c)
    return out


def _replayed(plain, comp, p, o, b, rp, rc):
    with replayed_top_k([rp, rc]):
        return plain(p, o, b), comp(p, o, b)


def pipe_case() -> dict:
    """``pipeline_forward`` of the reference's test (``tests/
    test_distributed.py:134``) on a ``(pod=4, data=2)`` Auto mesh."""
    from repro.distributed.pipeline import bubble_fraction, pipeline_forward

    ws, x = pipe_inputs()
    mesh = jax.make_mesh((4, 2), ("pod", "data"), devices=jax.devices()[:8],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = pipeline_forward(lambda w, h, s: jnp.tanh(h @ w), jnp.asarray(ws), jnp.asarray(x),
                           mesh, axis="pod")
    return {"out": np.asarray(out), "bubble": bubble_fraction(4, 6)}


if __name__ == "__main__":
    case, inputs_path, path = sys.argv[1:4]
    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    if case == "tp":
        res = {name: (tp_moe_case if name in TP_MOE_ONLY else tp_case)(name, inp)
               for name, inp in inputs.items()}
    elif case.startswith("train:"):
        res = {name: train_case(name, inputs) for name in case[6:].split(",")}
    elif case == "pipe":
        res = pipe_case()
    else:
        res = sp_case() if case == "sp" else {}
        res["serve"] = serve_case("seq_model" if case == "sp" else "seq_all", inputs)
    with open(path, "wb") as f:
        pickle.dump(res, f)
