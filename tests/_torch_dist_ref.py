"""The JAX side of the port's distributed tests, run in a subprocess on a
host mesh of eight CPU devices (the device count is fixed before JAX
starts, as ``tests/test_distributed.py`` does).

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python tests/_torch_dist_ref.py CASE INPUTS.pkl OUT.pkl

``CASE`` is ``sp`` (sequence-parallel attention on the reference's three
plans, the int8 all-reduce, the smoke gemma3's serve step under
``seq_model`` on a ``(2, 4)`` mesh), ``seq_all`` (its serve step under
``seq_all`` on a ``(2, 2)`` mesh) or ``tp`` (tensor-parallel serving:
the prefill and serve steps of the smoke configurations in ``INPUTS.pkl``
under plan ``heads``, :func:`tp_case`). The attention inputs come from numpy
generators with the seeds of ``tests/_torch_dist.py``; the weights and the
prefill's cache from ``INPUTS.pkl`` (:func:`serve_inputs`, made by the
test's own process, which hands the same file to the port's ranks); the
outputs go to ``OUT.pkl``.
"""
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, __file__.rsplit("/", 1)[0])
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


if __name__ == "__main__":
    case, inputs_path, path = sys.argv[1:4]
    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    if case == "tp":
        res = {name: (tp_moe_case if name in TP_MOE_ONLY else tp_case)(name, inp)
               for name, inp in inputs.items()}
    else:
        res = sp_case() if case == "sp" else {}
        res["serve"] = serve_case("seq_model" if case == "sp" else "seq_all", inputs)
    with open(path, "wb") as f:
        pickle.dump(res, f)
