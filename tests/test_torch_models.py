"""The port's model layers and forward passes against the JAX reference on
the smoke configuration, with the same weights (carried across by
``params_from_numpy``) and the same token inputs.

bf16 tolerance: both sides round matmul outputs, activations and the KV
cache to bf16 at the same places (the port reproduces XLA's op sequence,
e.g. for silu), so on this CPU they agree to the bit or to float32
summation order. A float32-order difference can still move one bf16
rounding, so outputs are held to one bf16 step of their scale: 2**-7
relative plus 2**-7 absolute on unit-scale activations and logits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import decode_step as jdecode, init_params as jinit  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.leantile import make_schedule  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import decode_step, init_paged_cache, params_from_numpy, prefill  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

BF16 = dict(rtol=2**-7, atol=2**-7)


@pytest.fixture(scope="module")
def model():
    cfg_j = jax_smoke("mistral-nemo-12b")
    cfg = get_smoke_config("mistral-nemo-12b")
    pj = jinit(jax.random.PRNGKey(0), cfg_j)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), cfg, device="cpu")
    return cfg_j, cfg, pj, pt


def _f(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope_match(dtype):
    """float32: within float32 rounding (rsqrt/cos/sin differ in the last
    bit); bf16: one bf16 step."""
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else BF16
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    w = (rng.standard_normal(16) * 0.1).astype(np.float32)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    np.testing.assert_allclose(
        _f(tlayers.rms_norm(xt, torch.from_numpy(w))), _f(jlayers.rms_norm(xj, jnp.asarray(w))),
        **tol)
    pos = np.arange(5) + 123
    np.testing.assert_allclose(
        _f(tlayers.rope(xt, torch.from_numpy(pos), 1e6)),
        _f(jlayers.rope(xj, jnp.asarray(pos), 1e6)), **tol)


def test_params_carried_across(model):
    cfg_j, cfg, pj, pt = model
    assert len(pt["layers"]) == cfg.n_layers
    np.testing.assert_array_equal(
        pt["layers"][1]["attn"]["wq"].float().numpy(),
        np.asarray(pj["stages"][0][0]["attn"]["wq"][1].astype(jnp.bfloat16).astype(jnp.float32)))
    assert pt["layers"][0]["ln1"].dtype == torch.float32


def test_prefill_matches(model):
    cfg_j, cfg, pj, pt = model
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 23)).astype(np.int32)
    lj, cj, _ = jprefill(pj, cfg_j, jnp.asarray(toks), cache_len=32)
    lt, ct, cur = prefill(pt, cfg, torch.from_numpy(toks), cache_len=32)
    assert cur == 23
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **BF16)
    for i in range(cfg.n_layers):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                ct[i][name].float().numpy(), _f(cj[0][0][name][i]), **BF16)


def test_prefill_chunked_attention_matches(model):
    """Prompts longer than attn_q_chunk take the q-chunked attention."""
    import dataclasses

    cfg_j, cfg, pj, pt = model
    cfg_j = dataclasses.replace(cfg_j, attn_q_chunk=8)
    cfg = dataclasses.replace(cfg, attn_q_chunk=8)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 21)).astype(np.int32)
    lj, _, _ = jprefill(pj, cfg_j, jnp.asarray(toks), cache_len=32)
    lt, _, _ = prefill(pt, cfg, torch.from_numpy(toks), cache_len=32)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **BF16)


def _paged_state(cfg, rng, num_pages=9, page=8):
    """Random bf16 pools (identical on both sides) and a 2-slot batch: slot
    0 mid-sequence on shuffled pages, slot 1 idle on the null page."""
    shape = (cfg.n_layers, num_pages, cfg.n_kv_heads, page, cfg.head_dim)
    kv = [(rng.standard_normal(shape) * 0.5).astype(np.float32) for _ in range(2)]
    tbl = np.zeros((2, 4), np.int32)
    tbl[0, :3] = [5, 2, 7]
    ctx = np.array([19, 0], np.int32)
    return kv, tbl, ctx


@pytest.mark.parametrize("backend", ["ref", "lean-fused", "lean-two-phase"])
def test_decode_step_matches(model, backend):
    cfg_j, cfg, pj, pt = model
    rng = np.random.default_rng(3)
    (k_np, v_np), tbl, ctx = _paged_state(cfg, rng)
    toks = np.array([[17], [3]], np.int32)
    fused = backend == "lean-fused"
    lens = np.minimum(ctx + 1, tbl.shape[1] * 8).tolist()
    sched_args = (lens, cfg.n_kv_heads, 8, 3)

    jattn = tattn = None
    if backend != "ref":
        jsched = jops.make_schedule(*sched_args)
        tsched = make_schedule(*sched_args)

        def jattn(q, kp, vp, c):
            return jops.lean_decode_paged_from_schedule(
                q, kp, vp, jnp.repeat(c, cfg.n_kv_heads), jnp.asarray(tbl), jsched,
                fused=fused, interpret=True)

        def tattn(q, kp, vp, c):
            return tops.lean_decode_paged_from_schedule(
                q, kp, vp, c.repeat_interleave(cfg.n_kv_heads), torch.from_numpy(tbl), tsched,
                fused=fused)

    jcache = [({"k": jnp.asarray(k_np).astype(jnp.bfloat16),
                "v": jnp.asarray(v_np).astype(jnp.bfloat16)},)]
    lj, cj = jdecode(pj, cfg_j, jcache, jnp.asarray(toks), jnp.asarray(19), attn_fn=jattn,
                     ctx_lens=jnp.asarray(ctx), page_tbl=jnp.asarray(tbl))
    tcache = init_paged_cache(cfg, 9, 8, device="cpu")
    for i, lc in enumerate(tcache):
        lc["k"].copy_(torch.from_numpy(k_np[i]))
        lc["v"].copy_(torch.from_numpy(v_np[i]))
    lt, ct = decode_step(pt, cfg, tcache, torch.from_numpy(toks), attn_fn=tattn,
                         ctx_lens=torch.from_numpy(ctx), page_tbl=torch.from_numpy(tbl))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **BF16)
    for i in range(cfg.n_layers):      # the token's K/V landed in the same slots
        np.testing.assert_allclose(ct[i]["k"].float().numpy(), _f(cj[0][0]["k"][i]), **BF16)
        np.testing.assert_allclose(ct[i]["v"].float().numpy(), _f(cj[0][0]["v"][i]), **BF16)


@pytest.mark.parametrize("attn", ["plain", "lean"])
def test_attn_decode_paged_matches(model, attn):
    """One layer's paged decode step (token write, rotary, attention,
    output projection) against the reference's. The lean kernels keep the
    probabilities in float32 where the oracle rounds them to bf16, so the
    lean case is held to two bf16 steps."""
    cfg_j, cfg, pj, pt = model
    rng = np.random.default_rng(4)
    (k_np, v_np), tbl, ctx = _paged_state(cfg, rng)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
              rope_theta=cfg.rope_theta)
    pj0 = jax.tree.map(lambda a: a[0], pj["stages"][0][0]["attn"])
    out_j, kp_j, _ = jlayers.attn_decode_paged(
        pj0, jnp.asarray(x), jnp.asarray(k_np[0]).astype(jnp.bfloat16),
        jnp.asarray(v_np[0]).astype(jnp.bfloat16), jnp.asarray(tbl), 19,
        ctx_lens=jnp.asarray(ctx), **kw)
    attn_fn = None
    if attn == "lean":
        sched = make_schedule(np.minimum(ctx + 1, 32).tolist(), cfg.n_kv_heads, 8, 2)

        def attn_fn(q, kp, vp, c):
            return tops.lean_decode_paged_from_schedule(
                q, kp, vp, c.repeat_interleave(cfg.n_kv_heads), torch.from_numpy(tbl), sched)

    out_t, kp_t, _ = tlayers.attn_decode_paged(
        pt["layers"][0]["attn"], torch.from_numpy(x), torch.from_numpy(k_np[0]).bfloat16(),
        torch.from_numpy(v_np[0]).bfloat16(), torch.from_numpy(tbl),
        ctx_lens=torch.from_numpy(ctx), attn_fn=attn_fn, **kw)
    tol = BF16 if attn == "plain" else dict(rtol=2**-6, atol=2**-6)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **tol)
    np.testing.assert_allclose(kp_t.float().numpy(), _f(kp_j), **BF16)
