"""The JAX side of the port's distributed tests, run in a subprocess on a
host mesh of eight CPU devices (the device count is fixed before JAX
starts, as ``tests/test_distributed.py`` does).

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python tests/_torch_dist_ref.py CASE INPUTS.pkl OUT.pkl

``CASE`` is ``sp`` (sequence-parallel attention on the reference's three
plans, the int8 all-reduce, the smoke gemma3's serve step under
``seq_model`` on a ``(2, 4)`` mesh) or ``seq_all`` (its serve step under
``seq_all`` on a ``(2, 2)`` mesh). The attention inputs come from numpy
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
    psum_input,
    sp_inputs,
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


def serve_case(name: str, inputs: dict) -> dict:
    """``make_serve_step`` under ``decode_plan``'s plan for the case's mesh
    and batch, greedy from the prefill's logits."""
    from repro.configs import get_smoke_config
    from repro.distributed.sharding import choose_layout, decode_plan
    from repro.launch.serve_step import make_serve_step

    shape, batch = SERVE_CASES[name]
    n = int(np.prod(shape))
    # Auto axes, as the reference's meshes were before JAX made Explicit
    # the default: under Explicit axes the step's reshape of the sharded
    # attention output is refused
    mesh = jax.make_mesh(shape, ("data", "model"), devices=jax.devices()[:n],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
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
    res = sp_case() if case == "sp" else {}
    res["serve"] = serve_case("seq_model" if case == "sp" else "seq_all", inputs)
    with open(path, "wb") as f:
        pickle.dump(res, f)
