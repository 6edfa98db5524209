"""int8 paged KV in the port against the JAX package: the quantizing helpers,
the int8 forms of K1, K2, K4 and K5 (their plain versions, which CPU
tensors run), the page accounting, and the int8 engine on the smoke
configuration -- blocking, under the Scheduler with chunked prefill, and
with prefix sharing and cascade decode.

Tolerances:
  * the helpers (``quantize_kv_blocks``, ``paged_scatter_tokens_quant``,
    ``paged_gather_kv_dequant``) use the reference's op order and
    ``torch.round`` rounds half to even as ``jnp.round`` does, so the int8
    pools and the scales equal JAX's (run eagerly) bit for bit;
  * the kernels: 2e-5 absolute and relative against the JAX kernels in
    interpret mode, the reference's own contract for int8 kernels against
    the dequantized oracle (tests/test_quant_kv.py:204-206): both read the
    same int8 values and scales and compute the same float32 online softmax;
  * a page whose scale is 0 dequantizes to exact zeros;
  * engines: greedy streams equal on ``PROMPT_SEED``'s prompts (their
    margin, tests/test_torch_scheduler.py), and the int8 pools and scales
    those of the JAX engine, the null page 0 aside (idle slots and masked
    positions write it in an order neither package fixes): scales within
    one float32 ulp and int8 values within 1. The JAX engine runs jitted,
    and XLA computes the candidate scale ``amax / 127`` as ``amax * (1 /
    127)``, one ulp off ``amax / 127`` in about 5% of elements (uniform
    values on the CPU); an int8
    value quantized at such a scale can round the other way at a .5 tie.
    The port keeps the reference's ``amax / 127`` (what JAX computes
    eagerly).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core import attention as ja  # noqa: E402
from repro.core.leantile import make_chunk_schedule as jmake_chunk  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.serving.config import EngineConfig as JConfig, PagedConfig as JPaged  # noqa: E402
from repro.serving.engine import DecodeEngine as JEngine, Request as JRequest  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import attention as ta  # noqa: E402
from repro_torch.core.leantile import make_chunk_schedule  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import cache_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402
from repro_torch.serving.config import CascadeConfig, EngineConfig, PagedConfig  # noqa: E402
from repro_torch.serving.engine import DecodeEngine, Request  # noqa: E402
from repro_torch.serving.kvpool import KVLayout  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
PROMPT_SEED = 25                 # tests/test_torch_scheduler.py's margin prompts
PS = 8                           # page size of the kernel and prefix-sharing tests
ENGINE_PS = 16                   # of the engines held to the JAX int8 engine


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs several
    workers at once, and their thread pools oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ helpers
@pytest.mark.parametrize("per_head", [True, False], ids=["page_head", "page"])
def test_quantize_kv_blocks_matches_jax(per_head):
    rng = np.random.default_rng(0)
    vals = rng.standard_normal((5, 3, 8, 16)).astype(np.float32)
    vals[1] = 0.0                                     # an all-zero block: scale 0
    qj, sj = ja.quantize_kv_blocks(jnp.asarray(vals), per_head=per_head)
    qt, st = ta.quantize_kv_blocks(_t(vals), per_head=per_head)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert not st[1].any() and not qt[1].any()


@pytest.mark.parametrize("per_head", [True, False], ids=["page_head", "page"])
def test_scatter_quant_sequence_matches_jax(per_head):
    """Three writes through the single write point, growing magnitudes into
    the same pages (scales grow, old content requantizes), with chunk
    padding and a row of no valid tokens routed to the null page: pools
    and scales bit-equal to JAX's after every write, and the dequantizing
    gather equal too."""
    rng = np.random.default_rng(2)
    N, W, H, ps, d, C = 2, 4, 3, 8, 16, 7
    tbls = np.array([[1, 2, 0, 0], [3, 4, 5, 0]], np.int32)
    pool_j, sc_j = jnp.zeros((7, H, ps, d), jnp.int8), jnp.zeros((7, H), jnp.float32)
    pool_t, sc_t = torch.zeros((7, H, ps, d), dtype=torch.int8), torch.zeros((7, H))
    offs, grown = np.array([0, 3]), 0
    for lens, mag in (([5, 7], 0.5), ([6, 0], 2.0), ([3, 4], 4.0)):
        lens = np.asarray(lens)
        vals = (mag * rng.standard_normal((N, C, H, d))).astype(np.float32)
        before = sc_t.clone()
        pool_j, sc_j = ja.paged_scatter_tokens_quant(
            pool_j, sc_j, jnp.asarray(tbls), jnp.asarray(offs, jnp.int32),
            jnp.asarray(lens, jnp.int32), jnp.asarray(vals), per_head=per_head)
        ta.paged_scatter_tokens_quant(pool_t, sc_t, _t(tbls), _t(offs), _t(lens), _t(vals),
                                      per_head)
        np.testing.assert_array_equal(pool_t.numpy()[1:], np.asarray(pool_j)[1:])
        np.testing.assert_array_equal(sc_t.numpy(), np.asarray(sc_j))
        assert bool((sc_t >= before).all())
        grown += int((sc_t > before).any())
        offs = offs + lens
    assert grown == 3
    assert not pool_t[6].any() and not sc_t[6].any()      # never routed to
    tbl = np.array([[1, 2], [3, 4]], np.int32)
    np.testing.assert_array_equal(
        ta.paged_gather_kv_dequant(pool_t, sc_t, _t(tbl)).numpy(),
        np.asarray(ja.paged_gather_kv_dequant(pool_j, sc_j, jnp.asarray(tbl))))


def test_layout_page_bytes_accounts_scales_and_halves_footprint():
    """tests/test_quant_kv.py's accounting on the port's KVLayout, and at
    Mistral-NeMo-12B (40 layers, Hkv 8, d 128, page 128) 1.9995x the pages
    of bf16 in the same memory."""
    mk = lambda dt, **kw: KVLayout(kv_dtype=dt, **{**dict(
        n_kv_heads=8, head_dim=128, page_size=16, n_attn_layers=32), **kw})
    bf16, int8 = mk("bf16"), mk("int8")
    assert int8.quantized and int8.elem_bytes == 1 and not bf16.quantized
    assert int8.scale_bytes_per_page == 2 * 4 * 8 * 32
    assert int8.page_bytes == bf16.page_bytes // 2 + int8.scale_bytes_per_page
    assert mk("int8", scale_granularity="page").scale_bytes_per_page == 2 * 4 * 32
    nemo = dict(page_size=128, n_attn_layers=40)
    b, i = mk("bf16", **nemo), mk("int8", **nemo)
    assert (b.page_bytes, i.page_bytes) == (20_971_520, 10_488_320)
    assert round(b.page_bytes / i.page_bytes, 4) == 1.9995


# ------------------------------------------------------------------ kernels
def _int8_pools(rng, num_pages, Hkv, ps, d, zero_pages=()):
    """Random float pools quantized per (page, head); ``zero_pages`` get
    scale 0 with nonzero int8 content, which must still read as zeros."""
    out = []
    for _ in range(2):
        pool = rng.standard_normal((num_pages, Hkv, ps, d)).astype(np.float32)
        q, s = ja.quantize_kv_blocks(jnp.asarray(pool))
        s = np.asarray(s).copy()
        s[list(zero_pages)] = 0.0
        out += [np.asarray(q), s]
    return out


def _decode_problem(lens, Hq=8, Hkv=2, d=16, ps=PS, seed=0, zero_pages=()):
    rng = np.random.default_rng(seed)
    n = [-(-L // ps) for L in lens]
    num_pages = 1 + sum(n) + 2
    perm = rng.permutation(np.arange(1, num_pages))
    tbl = np.zeros((len(lens), max(n) + 1), np.int32)
    k = 0
    for b, m in enumerate(n):
        tbl[b, :m] = perm[k:k + m]
        k += m
    q = rng.standard_normal((len(lens), Hq, d)).astype(np.float32)
    zp = [int(tbl[b, t]) for b, t in zero_pages]
    return (q, *_int8_pools(rng, num_pages, Hkv, ps, d, zp), tbl)


@pytest.mark.parametrize("fused", [True, False], ids=["K2", "K1+merge"])
def test_int8_decode_matches_pallas(fused):
    """K2-int8, and K1-int8 + merge, through ``lean_decode_paged`` on
    permuted pages against the JAX kernels in interpret mode. The last
    sequence's pages all have scale 0: it attends over exact zeros, so its
    output is exactly 0 (its softmax weights sum to 1 over zero V rows)."""
    lens = [19, 50, 12]
    q, kq, ks, vq, vs, tbl = _decode_problem(lens, zero_pages=[(2, 0), (2, 1)])
    want = np.asarray(jops.lean_decode_paged(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), tbl, lens, num_workers=5,
        fused=fused, k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs), interpret=True))
    got = tops.lean_decode_paged(_t(q), _t(kq), _t(vq), tbl, lens, num_workers=5, fused=fused,
                                 k_scales=_t(ks), v_scales=_t(vs))
    assert not want[2].any() and not got[2].any()
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_int8_chunk_prefill_matches_pallas():
    """K4-int8 through ``lean_prefill_chunks``: a pack of three chunks at
    their own offsets (one of a single token), real rows against JAX."""
    rng = np.random.default_rng(4)
    Hq, Hkv, d, W = 4, 2, 16, 6
    offs, lens = np.array([0, 9, 3]), np.array([5, 8, 1])
    N, C = len(offs), int(lens.max())
    num_pages = 1 + N * W
    kq, ks, vq, vs = _int8_pools(rng, num_pages, Hkv, PS, d)
    tbls = np.zeros((N, W), np.int32)
    for n in range(N):
        npages = -(-int(offs[n] + lens[n]) // PS)
        tbls[n, :npages] = 1 + n * W + np.arange(npages)
    q = rng.standard_normal((N, Hq, C, d)).astype(np.float32)
    visible = [int(o + l) for o, l in zip(offs, lens)]
    ctx, qs = np.repeat(visible, Hkv).astype(np.int32), np.repeat(offs, Hkv).astype(np.int32)
    want = jops.lean_prefill_chunks(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(ctx), jnp.asarray(qs),
        jnp.asarray(tbls), jmake_chunk(visible, Hkv, PS, 4, max_len=W * PS),
        k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs), interpret=True)
    got = tops.lean_prefill_chunks(
        _t(q), _t(kq), _t(vq), _t(ctx), _t(qs), _t(tbls),
        make_chunk_schedule(visible, Hkv, PS, 4, max_len=W * PS),
        k_scales=_t(ks), v_scales=_t(vs))
    for n in range(N):
        np.testing.assert_allclose(got[n, :, :lens[n]].numpy(),
                                   np.asarray(want)[n, :, :lens[n]], **TOL)


def test_int8_cascade_matches_pallas():
    """K5-int8 through the cascade plan: three sequences sharing three
    pages."""
    rng = np.random.default_rng(6)
    Hq, Hkv, d, pp = 4, 2, 16, 3
    lens = [pp * PS + s for s in (5, 20, 13)]
    W = max(-(-L // PS) for L in lens) + 1
    num_pages = 1 + sum(-(-L // PS) for L in lens) + 4
    kq, ks, vq, vs = _int8_pools(rng, num_pages, Hkv, PS, d)
    free = list(rng.permutation(np.arange(1, num_pages)))
    shared = [int(free.pop()) for _ in range(pp)]
    tbl = np.zeros((len(lens), W), np.int32)
    for b, L in enumerate(lens):
        tbl[b, :pp] = shared
        tbl[b, pp:-(-L // PS)] = [int(free.pop()) for _ in range(-(-L // PS) - pp)]
    q = rng.standard_normal((len(lens), Hq, d)).astype(np.float32)
    groups, pps = [[0, 1, 2]], [pp]
    want = jops.lean_decode_cascade(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), tbl, lens, groups, pps,
        num_workers=6, k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs), interpret=True)
    got = tops.lean_decode_cascade(_t(q), _t(kq), _t(vq), tbl, lens, groups, pps, num_workers=6,
                                   k_scales=_t(ks), v_scales=_t(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_scales_come_with_int8_rows_only():
    lens = [9]
    q, kq, ks, vq, vs, tbl = _decode_problem(lens)
    with pytest.raises(ValueError, match="int8"):
        tops.lean_decode_paged(_t(q), _t(kq), _t(vq), tbl, lens, num_workers=2)
    with pytest.raises(ValueError, match="int8"):
        tops.lean_decode_paged(_t(q), _t(kq).float(), _t(vq).float(), tbl, lens, num_workers=2,
                               k_scales=_t(ks), v_scales=_t(vs))
    with pytest.raises(ValueError, match="together"):
        tops.lean_decode_paged(_t(q), _t(kq), _t(vq), tbl, lens, num_workers=2, k_scales=_t(ks))


# ------------------------------------------------------------------ engines
@pytest.fixture(scope="module")
def model():
    cfg_j = jax_smoke("mistral-nemo-12b")
    cfg = get_smoke_config("mistral-nemo-12b")
    pj = jinit(jax.random.PRNGKey(0), cfg_j)
    return cfg_j, cfg, pj, params_from_numpy(jax.tree.map(np.asarray, pj), cfg, device="cpu")


def _prompts(vocab, n=4, seed=PROMPT_SEED, base=8, step=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, base + step * i) for i in range(n)]


COMMON = dict(max_batch=4, cache_len=64, num_workers=8)


def _port(model, backend="lean", cls=DecodeEngine, paged=None, cascade=None, **kw):
    _, cfg, _, pt = model
    paged = paged or dict(enabled=True, page_size=ENGINE_PS, kv_dtype="int8")
    return cls(cfg, pt, EngineConfig(attn_backend=backend, paged=PagedConfig(**paged),
                                     cascade=CascadeConfig(**(cascade or {})),
                                     **{**COMMON, **kw}), device="cpu")


def _jax_cache(model, eng):
    """The JAX engine's cache as the port's per-layer dicts, in numpy."""
    return [{k: v.numpy() for k, v in lc.items()}
            for lc in cache_from_numpy(jax.tree.map(np.asarray, eng.cache), model[1],
                                       device="cpu")]


def _assert_pools_match(port_cache, jax_cache):
    """Scales within one float32 ulp, int8 values within 1 (module
    docstring), pages from 1 on."""
    assert len(port_cache) == len(jax_cache)
    for lc, jc in zip(port_cache, jax_cache):
        assert sorted(lc) == ["k", "k_scale", "v", "v_scale"]
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(lc[name][1:].numpy(), jc[name][1:], rtol=2**-23, atol=0,
                                       err_msg=name)
        for name in ("k", "v"):
            diff = np.abs(lc[name][1:].numpy().astype(np.int32) - jc[name][1:].astype(np.int32))
            assert diff.max() <= 1, (name, diff.max())


@pytest.fixture(scope="module")
def jax_int8(model):
    """The JAX int8 lean engine on ``PROMPT_SEED``'s prompts, blocking
    admission: its pools after the first admissions and after the run, and
    its streams (the oracle of every engine test here)."""
    cfg_j, _, pj, _ = model
    eng = JEngine(cfg_j, pj, JConfig(attn_backend="lean", **COMMON, paged=JPaged(
        enabled=True, page_size=ENGINE_PS, kv_dtype="int8")))
    reqs = [JRequest(uid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(_prompts(cfg_j.vocab_size))]
    for r in reqs:
        eng.submit(r)
    eng._admit()
    admitted = _jax_cache(model, eng)
    eng.run_to_completion()
    return {"streams": [tuple(r.generated) for r in reqs], "admitted": admitted,
            "final": _jax_cache(model, eng)}


def _serve_blocking(eng, prompts):
    reqs = [Request(uid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    return [tuple(r.generated) for r in reqs]


def test_int8_lean_engine_matches_jax(model, jax_int8):
    """The port's int8 lean engine (K7 admissions, quantizing page writes,
    K2-int8 decode): pools and scales match JAX's after admission and after
    the run, streams equal, the pool checks clean with its scales and holds
    nothing after the drain."""
    eng = _port(model)
    assert eng.quant and eng.pool.layout.quantized
    prompts = _prompts(model[1].vocab_size)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng._admit()
    _assert_pools_match(eng.cache, jax_int8["admitted"])
    eng.run_to_completion()
    assert [tuple(r.generated) for r in reqs] == jax_int8["streams"]
    _assert_pools_match(eng.cache, jax_int8["final"])
    eng.pool.check(scales=eng._kv_scale_arrays())
    assert len(eng._kv_scale_arrays()) == 2 * model[1].n_layers
    assert eng.pool.num_allocated == 0


@pytest.mark.parametrize("backend,fused,gran", [
    ("lean", False, "page_head"), ("fixed", True, "page_head"), ("ref", True, "page_head"),
    ("lean", True, "page"),
], ids=["lean-two-phase", "fixed", "ref", "lean-per-page"])
def test_int8_backends_match_jax_streams(model, jax_int8, backend, fused, gran):
    """K1-int8 + merge, ``fixed`` (K6 on pages dequantized to float32, K8
    on pools widened to bf16) and ``ref`` (the dequantizing gather) emit the
    JAX int8 engine's streams; with ``kv_scale_granularity="page"`` (one
    scale a page) the pools hold one scale across the heads."""
    cfg_j, cfg, pj, pt = model
    model = (cfg_j, dataclasses.replace(cfg, kv_scale_granularity=gran), pj, pt)
    eng = _port(model, backend, fused=fused)
    got = _serve_blocking(eng, _prompts(cfg.vocab_size))
    if gran == "page_head":
        assert got == jax_int8["streams"]
    else:
        sc = eng.cache[0]["k_scale"]
        assert bool((sc == sc[:, :1]).all()) and bool((sc > 0).any())
    eng.pool.check(scales=eng._kv_scale_arrays())
    assert eng.pool.num_allocated == 0


def test_int8_requires_paged(model):
    _, cfg, _, pt = model
    with pytest.raises(ValueError, match="paged"):
        DecodeEngine(cfg, pt, EngineConfig(attn_backend="lean", paged=PagedConfig(
            enabled=False, kv_dtype="int8"), **COMMON), device="cpu")


def test_int8_scheduler_chunked_matches_jax_streams(model, jax_int8):
    """The Scheduler with chunked prefill on ``lean`` (K4-int8 chunks through
    the quantizing scatter, K2-int8 decode) emits the JAX int8 engine's
    streams."""
    eng = _port(model)
    sch = tsched.Scheduler(eng, tsched.SchedulerConfig(chunk_size=8, prefill_pack=2,
                                                       token_budget=16))
    hs = [sch.submit(p, 6, uid=i) for i, p in enumerate(_prompts(model[1].vocab_size))]
    sch.run_to_completion(max_steps=400)
    assert sch.stats.chunks > 0
    assert [tuple(h.generated) for h in hs] == jax_int8["streams"]
    eng.pool.check(scales=eng._kv_scale_arrays())
    assert eng.pool.num_allocated == 0


class _CowRecorder(DecodeEngine):
    """Checks that every copy-on-write clone carries the page's int8 content
    and its scales verbatim."""

    copies = 0

    def _copy_page(self, src, dst):
        super()._copy_page(src, dst)
        for lc in self.cache:
            for name in ("k", "v", "k_scale", "v_scale"):
                assert torch.equal(lc[name][dst], lc[name][src])
        type(self).copies += 1


def test_int8_prefix_sharing_and_cascade(model):
    """Prefix sharing on int8 pages: two waves sharing a 24-token prefix
    through the Scheduler with the radix cache and cascade decode (K5-int8)
    emit the streams of the JAX int8 engine serving the same prompts one by
    one; shared pages keep their scales (the pool checks clean with them)."""
    cfg_j, cfg, pj, _ = model
    rng = np.random.default_rng(PROMPT_SEED)
    shared = rng.integers(0, cfg.vocab_size, 24)
    waves = [[np.concatenate([shared, rng.integers(0, cfg.vocab_size, 5 + 3 * i)])
              for i in range(2)],
             [np.concatenate([shared, rng.integers(0, cfg.vocab_size, 4 + 2 * i)])
              for i in range(4)]]
    flat = [p for w in waves for p in w]
    jeng = JEngine(cfg_j, pj, JConfig(attn_backend="ref", max_batch=4, cache_len=64,
                                      num_workers=4, paged=JPaged(enabled=True, page_size=PS,
                                                                  kv_dtype="int8")))
    jreqs = [JRequest(uid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(flat)]
    for r in jreqs:
        jeng.submit(r)
    jeng.run_to_completion()
    eng = _port(model, paged=dict(enabled=True, page_size=PS, kv_dtype="int8",
                                  prefix_cache=True),
                cascade=dict(enabled=True, stable_ticks=1), max_batch=4, num_workers=4)
    sch = tsched.Scheduler(eng, tsched.SchedulerConfig(chunk_size=8, prefill_pack=2,
                                                       token_budget=32))
    got = []
    for wave in waves:
        hs = [sch.submit(p, max_new_tokens=4) for p in wave]
        sch.run_to_completion(max_steps=500)
        got += [tuple(h.generated) for h in hs]
    assert got == [tuple(r.generated) for r in jreqs]
    assert eng.stats.cascade_fused_ticks > 0 and eng.stats.prefix_matched_tokens >= 4 * 24
    eng.pool.check(scales=eng._kv_scale_arrays())
    eng.prefix_cache.check()


def test_int8_copy_on_write_carries_scales(model):
    """A request that extends a cached sequence into its partial last page
    copies that page first: the clone carries the int8 content and the
    scales verbatim, and the streams equal those with the cache off."""
    vocab = model[1].vocab_size
    rng = np.random.default_rng(7)
    base = rng.integers(0, vocab, 11)                 # one full page + 3 tokens
    tail = rng.integers(0, vocab, 6)
    paged = dict(enabled=True, page_size=PS, kv_dtype="int8")
    streams = {}
    for on in (False, True):
        eng = _port(model, "ref", cls=_CowRecorder, paged={**paged, "prefix_cache": on})
        sch = tsched.Scheduler(eng, tsched.SchedulerConfig(chunk_size=8, prefill_pack=2,
                                                           token_budget=16))
        first = sch.submit(base, max_new_tokens=4)
        sch.run_to_completion(max_steps=200)
        cont = np.concatenate([base, np.asarray(first.generated[:3]), tail])
        h = sch.submit(cont, max_new_tokens=4)
        sch.run_to_completion(max_steps=200)
        streams[on] = (tuple(first.generated), tuple(h.generated))
        eng.pool.check(scales=eng._kv_scale_arrays())
    assert streams[True] == streams[False]
    assert _CowRecorder.copies >= 1
