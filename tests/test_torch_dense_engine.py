"""The port's dense-cache engine (``PagedConfig(enabled=False)``, the
reference's default) against the JAX package's on the smoke configuration:
``init_cache``, ``attn_decode`` and the dense ``decode_step`` on ragged
lengths, the engine on ``lean``, ``fixed`` and ``ref`` and with the legacy
per-tick step, the engine against the port's paged one, the ``Scheduler``
over a dense engine, and the reference's refusals.

Tolerances: one bf16 step of the values' scale (``BF16``, as
tests/test_torch_models.py) where both sides compute the same function; the
kernels keep the softmax probabilities in float32 where the plain oracle
rounds them to bf16, so a kernel backend's logits against the oracle's are
held to ``BACKEND_TOL`` = 2**-5 (tests/test_torch_scheduler.py). Token
streams are compared on ``PROMPT_SEED``'s prompts, whose oracle picks all
win by more than 2**-4 (tests/test_torch_scheduler.py,
``test_oracle_margin``), so every backend within those tolerances picks
alike.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import decode_step as jdecode, init_cache as jinit_cache  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.serving.config import EngineConfig as JConfig, PagedConfig as JPaged  # noqa: E402
from repro.serving.engine import DecodeEngine as JEngine, Request as JRequest  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.leantile import fixed_split_factor, make_schedule  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import decode_step, init_cache, params_from_numpy  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402
from repro_torch.serving.config import EngineConfig, PagedConfig  # noqa: E402
from repro_torch.serving.engine import DecodeEngine, Request  # noqa: E402

BF16 = dict(rtol=2**-7, atol=2**-7)
BACKEND_TOL = dict(rtol=2**-5, atol=2**-5)
PROMPT_SEED = 25
COMMON = dict(max_batch=2, cache_len=64, num_workers=8)
S = 16                      # dense cache length of the layer-level tests


@pytest.fixture(scope="module")
def model():
    cfg_j = jax_smoke("mistral-nemo-12b")
    cfg = get_smoke_config("mistral-nemo-12b")
    pj = jinit(jax.random.PRNGKey(0), cfg_j)
    return cfg_j, cfg, pj, params_from_numpy(jax.tree.map(np.asarray, pj), cfg, device="cpu")


def _f(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x).astype(jnp.float32))


def _dense_state(cfg, rng, B=3):
    """Random bf16 caches (identical on both sides) for ``B`` slots: one
    mid-sequence, one at capacity (its token overwrites the last row), one
    idle."""
    shape = (cfg.n_layers, B, cfg.n_kv_heads, S, cfg.head_dim)
    kv = [(rng.standard_normal(shape) * 0.5).astype(np.float32) for _ in range(2)]
    return kv, np.array([9, S, 0], np.int32)[:B]


def test_init_cache_matches_jax(model):
    cfg_j, cfg, _, _ = model
    cache = init_cache(cfg, 3, S, device="cpu")
    ref = jinit_cache(cfg_j, 3, S)
    assert len(cache) == cfg.n_layers
    for i, lc in enumerate(cache):
        for name in ("k", "v"):
            want = ref[0][0][name][i]
            assert tuple(lc[name].shape) == want.shape and lc[name].dtype == torch.bfloat16
            assert not lc[name].any()


@pytest.mark.parametrize("form", ["ctx_lens", "cur_len"])
def test_attn_decode_matches_jax(model, form):
    """One layer's dense decode step (rotary position, the token's K/V
    written in place, attention over the visible keys, output projection)
    against the reference's, per slot on ragged lengths with a slot at
    capacity, or every slot at one ``cur_len``."""
    cfg_j, cfg, pj, pt = model
    rng = np.random.default_rng(5)
    (k_np, v_np), ctx = _dense_state(cfg, rng)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
              rope_theta=cfg.rope_theta)
    if form == "ctx_lens":
        jkw, tkw = dict(ctx_lens=jnp.asarray(ctx)), dict(ctx_lens=torch.from_numpy(ctx))
        cur = 0
    else:
        jkw, tkw, cur = {}, {}, 11
    pj0 = jax.tree.map(lambda a: a[0], pj["stages"][0][0]["attn"])
    out_j, kc_j, vc_j = jlayers.attn_decode(
        pj0, jnp.asarray(x), jnp.asarray(k_np[0]).astype(jnp.bfloat16),
        jnp.asarray(v_np[0]).astype(jnp.bfloat16), cur, **jkw, **kw)
    kc, vc = torch.from_numpy(k_np[0]).bfloat16(), torch.from_numpy(v_np[0]).bfloat16()
    out_t, kc_t, vc_t = tlayers.attn_decode(pt["layers"][0]["attn"], torch.from_numpy(x), kc, vc,
                                            cur if form == "cur_len" else None, **tkw, **kw)
    assert kc_t is kc and vc_t is vc              # in place
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **BF16)
    np.testing.assert_allclose(kc_t.float().numpy(), _f(kc_j), **BF16)
    np.testing.assert_allclose(vc_t.float().numpy(), _f(vc_j), **BF16)
    # a 'win' layer's ring: S = 32 rows written at ctx % S (slot 1, at
    # capacity, wraps to row 0), every row of a full ring visible
    kr, vr = torch.from_numpy(k_np[0]).bfloat16(), torch.from_numpy(v_np[0]).bfloat16()
    out_j, kc_j, _ = jlayers.attn_decode(
        pj0, jnp.asarray(x), jnp.asarray(k_np[0]).astype(jnp.bfloat16),
        jnp.asarray(v_np[0]).astype(jnp.bfloat16), cur, window=S, **jkw, **kw)
    out_t, kr_t, _ = tlayers.attn_decode(pt["layers"][0]["attn"], torch.from_numpy(x), kr, vr,
                                         cur if form == "cur_len" else None, window=S, **tkw,
                                         **kw)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **BF16)
    np.testing.assert_allclose(kr_t.float().numpy(), _f(kc_j), **BF16)


@pytest.mark.parametrize("backend", ["ref", "lean-fused", "lean-two-phase", "fixed"])
def test_dense_decode_step_matches_jax(model, backend):
    """The whole model's dense decode step on ragged lengths with a slot at
    capacity, through each backend's attention over the dense rows, against
    the reference's: logits within one bf16 step (``BACKEND_TOL`` for the
    kernels against the oracle), the tokens' K/V in the same rows."""
    cfg_j, cfg, pj, pt = model
    rng = np.random.default_rng(6)
    (k_np, v_np), ctx = _dense_state(cfg, rng)
    toks = np.array([[17], [3], [40]], np.int32)
    lens = np.minimum(ctx + 1, S).tolist()
    tile, workers = 8, 3
    jattn = tattn = None
    if backend.startswith("lean"):
        fused = backend == "lean-fused"
        jsc, tsc = jops.make_schedule(lens, cfg.n_kv_heads, tile, workers), make_schedule(
            lens, cfg.n_kv_heads, tile, workers)

        def jattn(q, k, v, c):
            return jops.lean_decode_from_schedule(q, k, v, jnp.repeat(c, cfg.n_kv_heads), jsc,
                                                  fused=fused, interpret=True)

        def tattn(q, k, v, c):
            return tops.lean_decode_from_schedule(q, k, v, c.repeat_interleave(cfg.n_kv_heads),
                                                  tsc, fused=fused)
    elif backend == "fixed":
        splits = fixed_split_factor(max(lens), 3 * cfg.n_kv_heads, tile, workers)

        def jattn(q, k, v, c):
            return jops.flash_decode_from_lens(q, k, v, jnp.repeat(c, cfg.n_kv_heads),
                                               num_splits=splits, tile=tile, interpret=True)

        def tattn(q, k, v, c):
            return tops.flash_decode_from_lens(q, k, v, c.repeat_interleave(cfg.n_kv_heads),
                                               num_splits=splits, tile=tile)

    jcache = [({"k": jnp.asarray(k_np).astype(jnp.bfloat16),
                "v": jnp.asarray(v_np).astype(jnp.bfloat16)},)]
    lj, cj = jdecode(pj, cfg_j, jcache, jnp.asarray(toks), jnp.asarray(int(ctx.max())),
                     attn_fn=jattn, ctx_lens=jnp.asarray(ctx))
    tcache = init_cache(cfg, 3, S, device="cpu")
    for i, lc in enumerate(tcache):
        lc["k"].copy_(torch.from_numpy(k_np[i]))
        lc["v"].copy_(torch.from_numpy(v_np[i]))
    lt, ct = decode_step(pt, cfg, tcache, torch.from_numpy(toks), attn_fn=tattn,
                         ctx_lens=torch.from_numpy(ctx))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **BF16)
    if backend != "ref":
        lo, _ = jdecode(pj, cfg_j, jcache, jnp.asarray(toks), jnp.asarray(int(ctx.max())),
                        ctx_lens=jnp.asarray(ctx))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lo), **BACKEND_TOL)
    for i in range(cfg.n_layers):
        np.testing.assert_allclose(ct[i]["k"].float().numpy(), _f(cj[0][0]["k"][i]), **BF16)
        np.testing.assert_allclose(ct[i]["v"].float().numpy(), _f(cj[0][0]["v"][i]), **BF16)


# ------------------------------------------------------------------ engine
def _prompts(vocab, n=4):
    rng = np.random.default_rng(PROMPT_SEED)
    return [rng.integers(0, vocab, 8 + 7 * i) for i in range(n)]


def _engine(model, side, backend, fast=True, paged=False, page_size=None):
    cfg_j, cfg, pj, pt = model
    kw = dict(attn_backend=backend, use_fast_path=fast, **COMMON)
    if side == "jax":
        return JEngine(cfg_j, pj, JConfig(paged=JPaged(enabled=paged, page_size=page_size), **kw))
    return DecodeEngine(cfg, pt, EngineConfig(paged=PagedConfig(enabled=paged,
                                                                page_size=page_size), **kw),
                        device="cpu")


class _Logits:
    """Wraps a port engine's ticks, keeping each tick's logits."""

    def __init__(self, eng):
        self.eng, self.rows = eng, []

    def run(self, max_ticks=200):
        eng = self.eng
        while (eng.queue or any(eng.slot_req)) and eng.stats.ticks < max_ticks:
            eng.tick()
            self.rows.append(eng.last_logits.clone())
        return eng.stats


def _serve(eng, prompts, side, keep_logits=False):
    R = JRequest if side == "jax" else Request
    reqs = [R(uid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    rec = _Logits(eng) if keep_logits else None
    if rec is not None:
        rec.run()
    else:
        eng.run_to_completion(max_ticks=200)
    return [tuple(r.generated) for r in reqs], rec


@pytest.fixture(scope="module")
def jax_runs(model):
    """The JAX dense engine on the fast path per backend, and its legacy
    step on ``lean`` (the slowest under Pallas interpret)."""
    prompts = _prompts(model[0].vocab_size)
    out = {"prompts": prompts}
    for backend, fast in (("ref", True), ("lean", True), ("fixed", True), ("lean", False)):
        eng = _engine(model, "jax", backend, fast)
        out[(backend, fast)] = (_serve(eng, prompts, "jax")[0], eng.stats)
    return out


@pytest.mark.parametrize("backend,fast", [("ref", True), ("lean", True), ("fixed", True),
                                          ("lean", False), ("fixed", False), ("ref", False)])
def test_dense_engine_streams_match_jax(model, jax_runs, backend, fast):
    """Greedy streams equal to the JAX dense engine's on the same backend
    (``fixed`` and ``ref`` with the legacy step: the JAX fast path's, whose
    streams equal every backend's on these prompts), with the same ticks,
    prefills and schedule records (the legacy step records its own
    schedule, from the active lengths)."""
    eng = _engine(model, "port", backend, fast)
    got, _ = _serve(eng, jax_runs["prompts"], "port")
    want, jstats = jax_runs.get((backend, fast), jax_runs[(backend, True)])
    assert got == want == jax_runs[("ref", True)][0]
    assert eng.pool is None and eng.page_tbl is None
    assert (eng.stats.ticks, eng.stats.prefills) == (jstats.ticks, jstats.prefills) == (10, 4)
    if (backend, fast) in jax_runs:
        assert eng.stats.schedules == jstats.schedules
    assert eng.stats.tokens_generated == 4 * 5


def test_dense_engine_equals_paged_engine(model, jax_runs):
    """The port's dense engine against its paged one with pages as large as
    the dense tile (so both walk one schedule per tick): the same streams,
    and every tick's logits equal -- the same plain kernels over the same
    values, dense rows or pages."""
    prompts = jax_runs["prompts"]
    dense = _engine(model, "port", "lean")
    paged = _engine(model, "port", "lean", paged=True, page_size=dense.tile)
    a, ra = _serve(dense, prompts, "port", keep_logits=True)
    b, rb = _serve(paged, prompts, "port", keep_logits=True)
    assert a == b
    assert len(ra.rows) == len(rb.rows) == 10
    for x, y in zip(ra.rows, rb.rows):
        assert torch.equal(x, y)
    assert dense.stats.schedules == paged.stats.schedules
    paged.pool.check()
    assert paged.pool.num_allocated == 0


def test_scheduler_serves_dense_engine(model, jax_runs):
    """The ``Scheduler`` over a dense engine falls back to blocking
    admission (no chunked prefill without a pool): streams equal to the
    engine's own, callbacks in order, every request DECODING then
    FINISHED; asking for chunked prefill is refused."""
    prompts = jax_runs["prompts"]
    eng = _engine(model, "port", "lean")
    assert not eng.supports_chunked_prefill()
    with pytest.raises(ValueError, match="chunked prefill"):
        tsched.Scheduler(eng, tsched.SchedulerConfig(chunked=True))
    sch = tsched.Scheduler(eng, tsched.SchedulerConfig(chunk_size=8, prefill_pack=2,
                                                       token_budget=16))
    assert not sch.chunked
    streams = {}
    hs = [sch.submit(p, 6, uid=i, on_token=lambda u, t, d: streams.setdefault(u, []).append(
        (t, d))) for i, p in enumerate(prompts)]
    states = set()
    while sch.pending and sch.stats.steps < 100:
        sch.step()
        states |= {h.state for h in hs}
    assert [tuple(h.generated) for h in hs] == jax_runs[("lean", True)][0]
    assert tsched.RequestState.DECODING in states and tsched.RequestState.PREFILLING not in states
    assert all(h.state is tsched.RequestState.FINISHED for h in hs)
    for h in hs:
        assert [t for t, _ in streams[h.uid]] == h.generated
        assert [d for _, d in streams[h.uid]] == [False] * 5 + [True]


def test_reference_refusals(model):
    """The reference's refusals, on both sides: a paged engine needs the
    fast path, the prefix cache needs paged KV, a dense engine has no
    chunked prefill and no preemption, and the legacy step masks no
    slots."""
    cases = [dict(paged=True, use_fast_path=False), dict(paged=False, prefix_cache=True)]
    for kw in cases:
        jkw, tkw = dict(COMMON), dict(COMMON)
        paged = dict(enabled=kw["paged"], prefix_cache=kw.get("prefix_cache", False))
        fast = kw.get("use_fast_path", True)
        with pytest.raises(ValueError):
            JEngine(model[0], model[2], JConfig(paged=JPaged(**paged), use_fast_path=fast, **jkw))
        with pytest.raises(ValueError, match="paged"):
            DecodeEngine(model[1], model[3], EngineConfig(paged=PagedConfig(**paged),
                                                          use_fast_path=fast, **tkw),
                         device="cpu")
    for side in ("jax", "port"):
        eng = _engine(model, side, "ref")
        assert not eng.supports_chunked_prefill()
        R = JRequest if side == "jax" else Request
        eng.submit(R(uid=0, prompt=np.arange(5), max_new_tokens=3))
        eng.tick()
        with pytest.raises(RuntimeError, match="paged"):
            eng.preempt_slot(0)
        with pytest.raises(RuntimeError, match="chunked prefill"):
            eng.prefill_chunks_tick([(1, np.arange(3), 0)], pack_width=1, chunk_cap=4)
    legacy = _engine(model, "port", "ref", fast=False)
    legacy.submit(Request(uid=0, prompt=np.arange(5), max_new_tokens=3))
    legacy.tick()
    with pytest.raises(RuntimeError, match="fast path"):
        legacy.decode_tick(exclude=[1])
