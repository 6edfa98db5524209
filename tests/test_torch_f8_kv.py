"""f8, f16 and f32 KV caches in the port against the JAX package: the
reference's e4m3 cast, the f8 forms' plain versions (which CPU tensors
run), the f8 engine on the smoke configuration on every path the JAX
engine serves f8 on, and the f16 and f32 caches, which the reference
stores as bf16.

Tolerances:
  * the cast (``to_kv``) is JAX's eager ``astype(float8_e4m3fn)`` bit for
    bit, NaN codes included; widening back is exact in both;
  * the f8 forms' plain versions widen the e4m3 rows and run the bf16
    forms' plain versions; the reference widens the pool and runs its
    kernel (Pallas, interpret mode). Both compute float32 online softmax
    from the same values: 2e-5 absolute and relative, the int8 forms'
    tolerance (tests/test_torch_quant_kv.py);
  * engines: the pools' e4m3 bytes equal the JAX engine's (the null page 0
    aside: idle slots and masked positions write it in an order neither
    package fixes), and every path's greedy streams equal the JAX engine's
    on the same path, on ``PROMPT_SEED``'s prompts (their margin,
    tests/test_torch_scheduler.py). The paths do not all give one stream
    (e4m3 rounding moves near ties), so no path is held to another's. The
    chunked Scheduler meets an exact tie on those prompts (request 0's 5th
    token: the port's top-2 logits equal; the jitted JAX step rounds them
    apart), so its streams are held to the near-tie rule of
    tests/test_torch_arch_engine.py: equal to JAX's, or leaving them where
    the port's own top-2 gap is below ``NEAR_TIE`` = 2**-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core import attention as ja  # noqa: E402
from repro.core.leantile import make_chunk_schedule as jmake_chunk  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.flash_prefill import flash_prefill_paged as jflash_paged  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro.serving.config import CascadeConfig as JCascade  # noqa: E402
from repro.serving.config import EngineConfig as JConfig, PagedConfig as JPaged  # noqa: E402
from repro.serving.engine import DecodeEngine as JEngine, Request as JRequest  # noqa: E402
from repro.serving.kvpool import KVLayout as JLayout  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import attention as ta  # noqa: E402
from repro_torch.core.leantile import make_chunk_schedule  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.flash_prefill import flash_prefill_paged  # noqa: E402
from repro_torch.models import cache_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402
from repro_torch.serving.config import CascadeConfig, EngineConfig, PagedConfig  # noqa: E402
from repro_torch.serving.engine import DecodeEngine, Request  # noqa: E402
from repro_torch.serving.kvpool import KVLayout  # noqa: E402

F8 = torch.float8_e4m3fn
TOL = dict(rtol=2e-5, atol=2e-5)
PROMPT_SEED = 25                 # tests/test_torch_scheduler.py's margin prompts
PS = 8                           # page size of the kernel and prefix-sharing tests
ENGINE_PS = 16                   # of the engines held to the JAX f8 engine
COMMON = dict(max_batch=4, cache_len=64, num_workers=8)
NEW = 6
NEAR_TIE = 2**-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _codes(t):
    """A port tensor's e4m3 codes as numpy."""
    return t.view(torch.uint8).numpy()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs several
    workers at once, and their thread pools oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ the cast
EDGES = [0.0, -0.0, 448.0, -448.0, 464.0, -464.0, 464.0001, -464.0001, 465.0, -480.0, 1e6,
         np.inf, -np.inf, np.nan, -np.nan, 2.0**-6, 2.0**-9, -2.0**-9, 2.0**-10,
         1.5 * 2.0**-10, 3 * 2.0**-11, 2.0**-7 * 1.0625, 1e-30, 240.0, 248.0, 256.0]


def test_cast_matches_jax_from_bf16_and_float32():
    """Every bf16 bit pattern, and float32 edges and a sweep (N(0, 1) at four
    scales), cast as JAX casts them; e4m3 -> bf16 and float32 widening
    equal JAX's on every code."""
    bf_bits = np.arange(2**16, dtype=np.uint32).astype(np.uint16)
    jbf = jax.lax.bitcast_convert_type(jnp.asarray(bf_bits), jnp.bfloat16)
    tbf = _t(bf_bits.view(np.int16)).view(torch.bfloat16)
    want = np.asarray(jbf.astype(jnp.float8_e4m3fn)).view(np.uint8)
    np.testing.assert_array_equal(_codes(ta.to_kv(tbf, F8)), want)
    rng = np.random.default_rng(0)
    f32 = np.concatenate([np.asarray(EDGES, np.float32)]
                         + [rng.standard_normal(50_000).astype(np.float32) * s
                            for s in (1e-3, 1.0, 30.0, 300.0)])
    f32 = np.concatenate([f32, -f32])
    want = np.asarray(jnp.asarray(f32).astype(jnp.float8_e4m3fn)).view(np.uint8)
    got = _codes(ta.to_kv(_t(f32), F8))
    np.testing.assert_array_equal(got, want)
    assert (got[np.abs(f32) > 464] & 0x7F == 0x7F).all()      # NaN, sign kept
    # widening: every finite code bit for bit; the NaN codes 0x7f / 0xff NaN
    # (torch and JAX set a NaN's sign bit differently)
    codes = np.arange(256, dtype=np.uint8)
    nan = (codes & 0x7F) == 0x7F
    jf8 = jax.lax.bitcast_convert_type(jnp.asarray(codes), jnp.float8_e4m3fn)
    tf8 = _t(codes).view(F8)
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        w = np.asarray(jf8.astype(jdt).astype(jnp.float32))
        g = ta.widen_kv(tf8, tdt).float().numpy()
        np.testing.assert_array_equal(g[~nan].view(np.uint32), w[~nan].view(np.uint32))
        assert np.isnan(g[nan]).all() and np.isnan(w[nan]).all()
    assert ta.widen_kv(tbf) is tbf


def test_overflow_writes_nan_in_both_packages():
    """A K value above 464 scattered into an f8 page reads NaN in both
    packages (torch's own cast would saturate to 448); the rest of the
    write is bit-equal."""
    rng = np.random.default_rng(1)
    N, C, H, d = 2, 5, 2, 16
    tbls = np.array([[1, 2], [3, 0]], np.int32)
    offs, lens = np.array([0, 2], np.int32), np.array([5, 3], np.int32)
    vals = rng.standard_normal((N, C, H, d)).astype(np.float32)
    vals[0, 1, 0, 3], vals[1, 0, 1, 7] = 500.0, -470.0
    vb = jnp.asarray(vals).astype(jnp.bfloat16)
    pj = ja.paged_scatter_tokens(jnp.zeros((5, H, PS, d), jnp.float8_e4m3fn),
                                 jnp.asarray(tbls), jnp.asarray(offs), jnp.asarray(lens), vb)
    pt = ta.paged_scatter_tokens(torch.zeros((5, H, PS, d), dtype=F8), _t(tbls), _t(offs),
                                 _t(lens), _t(np.asarray(vb.astype(jnp.float32))).bfloat16())
    np.testing.assert_array_equal(_codes(pt)[1:], np.asarray(pj).view(np.uint8)[1:])
    wide = ta.widen_kv(pt, torch.float32)
    assert bool(torch.isnan(wide[1, 0, 1, 3])) and bool(torch.isnan(wide[3, 1, 2, 7]))
    assert int(torch.isnan(wide).sum()) == 2
    assert np.isnan(np.asarray(pj.astype(jnp.float32))).sum() == 2
    assert float(torch.tensor(500.0).to(F8).float()) == 448.0      # torch alone saturates


# ------------------------------------------------------------------ kernels
def _f8_pools(rng, num_pages, Hkv, ps, d):
    """Random e4m3 pools: the JAX pool (ml_dtypes) and the port's."""
    out = []
    for _ in range(2):
        x = jnp.asarray(rng.standard_normal((num_pages, Hkv, ps, d)).astype(np.float32))
        j = x.astype(jnp.bfloat16).astype(jnp.float8_e4m3fn)
        out.append((j, _t(np.asarray(j).view(np.uint8)).view(F8)))
    return out


def _wide(j):
    """The reference's read of an f8 pool: widened (here to float32, exact,
    as the float32 queries' kernels read it)."""
    return j.astype(jnp.float32)


def _paged_problem(lens, Hq=8, Hkv=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    n = [-(-L // PS) for L in lens]
    num_pages = 1 + sum(n) + 2
    perm = rng.permutation(np.arange(1, num_pages))
    tbl = np.zeros((len(lens), max(n) + 1), np.int32)
    k = 0
    for b, m in enumerate(n):
        tbl[b, :m] = perm[k:k + m]
        k += m
    q = rng.standard_normal((len(lens), Hq, d)).astype(np.float32)
    (kj, kt), (vj, vt) = _f8_pools(rng, num_pages, Hkv, PS, d)
    return q, kj, kt, vj, vt, tbl


@pytest.mark.parametrize("fused", [True, False], ids=["K2", "K1+merge"])
def test_f8_decode_matches_pallas(fused):
    """K2-f8, and K1-f8 + merge, through ``lean_decode_paged`` on permuted
    e4m3 pages against the JAX kernels in interpret mode on the widened
    pools."""
    lens = [19, 50, 12]
    q, kj, kt, vj, vt, tbl = _paged_problem(lens)
    want = jops.lean_decode_paged(jnp.asarray(q), _wide(kj), _wide(vj), tbl, lens,
                                  num_workers=5, fused=fused, interpret=True)
    got = tops.lean_decode_paged(_t(q), kt, vt, tbl, lens, num_workers=5, fused=fused)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_f8_fixed_decode_matches_pallas():
    """K6-f8 through ``flash_decode`` on dense e4m3 rows (the pages the
    ``fixed`` backend gathers) against the JAX K6 on the widened rows."""
    lens = [19, 50, 12]
    q, kj, kt, vj, vt, tbl = _paged_problem(lens, seed=3)
    kd, vd = (ta.paged_gather_kv(p, _t(tbl)) for p in (kt, vt))
    assert kd.dtype == F8
    kdj, vdj = (_wide(ja.paged_gather_kv(p, jnp.asarray(tbl))) for p in (kj, vj))
    want = jops.flash_decode(jnp.asarray(q), kdj, vdj, lens, num_splits=3, tile=PS,
                             interpret=True)
    got = tops.flash_decode(_t(q), kd, vd, lens, num_splits=3, tile=PS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _chunk_problem(seed=4):
    rng = np.random.default_rng(seed)
    Hq, Hkv, d, W = 4, 2, 16, 6
    offs, lens = np.array([0, 9, 3]), np.array([5, 8, 1])
    N, C = len(offs), int(lens.max())
    (kj, kt), (vj, vt) = _f8_pools(rng, 1 + N * W, Hkv, PS, d)
    tbls = np.zeros((N, W), np.int32)
    for n in range(N):
        tbls[n, :-(-int(offs[n] + lens[n]) // PS)] = 1 + n * W + np.arange(
            -(-int(offs[n] + lens[n]) // PS))
    q = rng.standard_normal((N, Hq, C, d)).astype(np.float32)
    return q, kj, kt, vj, vt, tbls, offs, lens, Hkv, W


def test_f8_chunk_prefill_matches_pallas():
    """The fused K4-f8 through ``lean_prefill_chunks`` (a pack of three
    chunks, one of a single token), real rows against JAX's K4."""
    q, kj, kt, vj, vt, tbls, offs, lens, Hkv, W = _chunk_problem()
    visible = [int(o + n) for o, n in zip(offs, lens)]
    ctx, qs = np.repeat(visible, Hkv).astype(np.int32), np.repeat(offs, Hkv).astype(np.int32)
    want = jops.lean_prefill_chunks(
        jnp.asarray(q), _wide(kj), _wide(vj), jnp.asarray(ctx), jnp.asarray(qs),
        jnp.asarray(tbls), jmake_chunk(visible, Hkv, PS, 4, max_len=W * PS), interpret=True)
    got = tops.lean_prefill_chunks(_t(q), kt, vt, _t(ctx), _t(qs), _t(tbls),
                                   make_chunk_schedule(visible, Hkv, PS, 4, max_len=W * PS))
    for n in range(len(offs)):
        np.testing.assert_allclose(got[n, :, :lens[n]].numpy(),
                                   np.asarray(want)[n, :, :lens[n]], **TOL)


def test_f8_paged_prefill_matches_pallas():
    """K8-f8 through ``flash_prefill_paged`` against the JAX K8 on the
    widened pools, real rows."""
    q, kj, kt, vj, vt, tbls, offs, lens, Hkv, W = _chunk_problem(seed=5)
    want = jflash_paged(jnp.asarray(q), _wide(kj), _wide(vj), jnp.asarray(tbls),
                        jnp.asarray(offs.astype(np.int32)), interpret=True)
    got = flash_prefill_paged(_t(q), kt, vt, _t(tbls), _t(offs.astype(np.int32)))
    for n in range(len(offs)):
        np.testing.assert_allclose(got[n, :, :lens[n]].numpy(),
                                   np.asarray(want)[n, :, :lens[n]], **TOL)


def test_f8_cascade_matches_pallas():
    """K5-f8 through the cascade plan: three sequences sharing three
    pages."""
    rng = np.random.default_rng(6)
    Hq, Hkv, d, pp = 4, 2, 16, 3
    lens = [pp * PS + s for s in (5, 20, 13)]
    W = max(-(-L // PS) for L in lens) + 1
    num_pages = 1 + sum(-(-L // PS) for L in lens) + 4
    (kj, kt), (vj, vt) = _f8_pools(rng, num_pages, Hkv, PS, d)
    free = list(rng.permutation(np.arange(1, num_pages)))
    shared = [int(free.pop()) for _ in range(pp)]
    tbl = np.zeros((len(lens), W), np.int32)
    for b, L in enumerate(lens):
        tbl[b, :pp] = shared
        tbl[b, pp:-(-L // PS)] = [int(free.pop()) for _ in range(-(-L // PS) - pp)]
    q = rng.standard_normal((len(lens), Hq, d)).astype(np.float32)
    want = jops.lean_decode_cascade(jnp.asarray(q), _wide(kj), _wide(vj), tbl, lens, [[0, 1, 2]],
                                    [pp], num_workers=6, interpret=True)
    got = tops.lean_decode_cascade(_t(q), kt, vt, tbl, lens, [[0, 1, 2]], [pp], num_workers=6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


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


def _jax_cache(model, eng):
    return cache_from_numpy(jax.tree.map(np.asarray, eng.cache), model[1], device="cpu")


def _assert_pools_equal(port_cache, jax_cache, dtype=F8):
    """Every K/V leaf in ``dtype``, byte for byte from page (or row) 1 on."""
    assert len(port_cache) == len(jax_cache)
    for lc, jc in zip(port_cache, jax_cache):
        assert sorted(lc) == sorted(jc) == ["k", "v"]
        for name in ("k", "v"):
            assert lc[name].dtype == jc[name].dtype == dtype
            a, b = (ta.kv_bytes(t)[1:] for t in (lc[name], jc[name]))
            assert torch.equal(a, b), name


def _jax_engine(model, backend="lean", paged=True, kv_dtype="f8", page_size=ENGINE_PS, **kw):
    cfg_j, _, pj, _ = model
    cfg = {**COMMON, **kw}
    return JEngine(cfg_j, pj, JConfig(attn_backend=backend, **cfg, paged=JPaged(
        enabled=paged, page_size=page_size, kv_dtype=kv_dtype)))


def _port(model, backend="lean", paged=None, cascade=None, cls=DecodeEngine, **kw):
    _, cfg, _, pt = model
    paged = paged or dict(enabled=True, page_size=ENGINE_PS, kv_dtype="f8")
    return cls(cfg, pt, EngineConfig(attn_backend=backend, paged=PagedConfig(**paged),
                                     cascade=CascadeConfig(**(cascade or {})),
                                     **{**COMMON, **kw}), device="cpu")


def _serve(eng, prompts, jax_side=False):
    R = JRequest if jax_side else Request
    reqs = [R(uid=i, prompt=p, max_new_tokens=NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    return [tuple(r.generated) for r in reqs]


@pytest.fixture(scope="module")
def jax_f8(model):
    """The JAX f8 lean engine, blocking admission: its pools after the first
    admissions and after the run, and its streams."""
    eng = _jax_engine(model)
    prompts = _prompts(model[1].vocab_size)
    reqs = [JRequest(uid=i, prompt=p, max_new_tokens=NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng._admit()
    admitted = _jax_cache(model, eng)
    eng.run_to_completion()
    return {"streams": [tuple(r.generated) for r in reqs], "admitted": admitted,
            "final": _jax_cache(model, eng)}


def test_f8_lean_engine_matches_jax(model, jax_f8):
    """The port's f8 lean engine (K7 admissions written through the cast,
    K2-f8 decode): e4m3 pools byte-equal to the JAX engine's after
    admission and after the run, streams equal, pages at half of bf16's
    bytes, the pool clean and empty after the drain."""
    eng = _port(model)
    assert eng.cache[0]["k"].dtype == F8 and not eng.quant
    assert eng.pool.layout.page_bytes * 2 == KVLayout(**{
        **eng.pool.layout.__dict__, "kv_dtype": "bf16"}).page_bytes
    prompts = _prompts(model[1].vocab_size)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng._admit()
    _assert_pools_equal(eng.cache, jax_f8["admitted"])
    eng.run_to_completion()
    assert [tuple(r.generated) for r in reqs] == jax_f8["streams"]
    _assert_pools_equal(eng.cache, jax_f8["final"])
    eng.pool.check()
    assert eng.pool.num_allocated == 0


@pytest.mark.parametrize("backend,fused,paged", [
    ("lean", False, True), ("fixed", True, True), ("ref", True, True), ("lean", True, False),
], ids=["lean-two-phase", "fixed", "ref", "dense-lean"])
def test_f8_paths_match_jax_streams(model, backend, fused, paged):
    """K1-f8 + merge, ``fixed`` (K6-f8 on the gathered e4m3 pages, K8-f8),
    ``ref`` (the gathered pages widened to bf16) and the dense f8 engine
    (e4m3 per-slot rows, K2-f8 on the dense rows): the JAX engine's
    streams on the same path, and its final e4m3 caches."""
    prompts = _prompts(model[1].vocab_size)
    jeng = _jax_engine(model, backend, paged=paged, fused=fused)
    want = _serve(jeng, prompts, jax_side=True)
    eng = _port(model, backend, paged=dict(enabled=paged, page_size=ENGINE_PS, kv_dtype="f8"),
                fused=fused)
    assert _serve(eng, prompts) == want
    _assert_pools_equal(eng.cache, _jax_cache(model, jeng))
    if paged:
        eng.pool.check()
        assert eng.pool.num_allocated == 0


class _Rows(DecodeEngine):
    """The port's engine, recording per request the logits row each emitted
    token was picked from: the chunk that ends its prompt, then each decode
    tick."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.rows, self.pass_rows = {}, {}

    def prefill_chunks_tick(self, work, pack_width, chunk_cap):
        toks = super().prefill_chunks_tick(work, pack_width, chunk_cap)
        for i, (slot, chunk, off) in enumerate(work):
            req = self.slot_req[slot]
            if off + len(chunk) == len(req.prompt):
                self.rows.setdefault(req.uid, []).append(
                    self.last_prefill_logits[i].float().numpy())
        return toks

    def _decode_pass(self, level, slots, active, exclude):
        logits = super()._decode_pass(level, slots, active, exclude)
        self.pass_rows.update({s: logits[s].float().numpy() for s in slots})
        return logits

    def _emit_tokens(self, results, guard_on, spec=None):
        for slots, _, _ in results:
            for s in slots:
                self.rows.setdefault(self.slot_req[s].uid, []).append(self.pass_rows[s])
        return super()._emit_tokens(results, guard_on, spec)


@pytest.mark.parametrize("backend", ["lean", "fixed"])
def test_f8_scheduler_chunked_matches_jax_streams(model, backend):
    """The Scheduler with chunked prefill: fused K4-f8 chunks (``lean``) or
    K8-f8 (``fixed``) through the cast's scatter, then decode, against the
    JAX Scheduler on the same backend, under the near-tie rule (module
    docstring): at most request 0 leaves JAX's stream, at its exact tie."""
    prompts = _prompts(model[1].vocab_size)
    streams = []
    port = _port(model, backend, cls=_Rows)
    for m, eng in ((jsched, _jax_engine(model, backend)), (tsched, port)):
        sch = m.Scheduler(eng, m.SchedulerConfig(chunk_size=8, prefill_pack=2, token_budget=16))
        hs = [sch.submit(p, NEW, uid=i) for i, p in enumerate(prompts)]
        sch.run_to_completion(max_steps=400)
        assert sch.stats.chunks > 0
        streams.append([tuple(h.generated) for h in hs])
    left = []
    for uid, (want, got) in enumerate(zip(*streams)):
        k = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
        if k is not None:
            top = np.sort(port.rows[uid][k])
            assert top[-1] - top[-2] < NEAR_TIE, (uid, k, want, got)
            left.append(uid)
    assert left in ([], [0]), left
    port.pool.check()
    assert port.pool.num_allocated == 0


class _CowRecorder(DecodeEngine):
    """Checks that every copy-on-write clone carries the page's e4m3 bytes."""

    copies = 0

    def _copy_page(self, src, dst):
        super()._copy_page(src, dst)
        for lc in self.cache:
            for name in ("k", "v"):
                assert lc[name].dtype == F8
                assert torch.equal(ta.kv_bytes(lc[name][dst]), ta.kv_bytes(lc[name][src]))
        type(self).copies += 1


def test_f8_prefix_sharing_and_cascade_match_jax(model):
    """Prefix sharing on f8 pages: two waves sharing a 24-token prefix
    through the Scheduler with the radix cache and cascade decode (K5-f8),
    against the JAX engine on the same path."""
    cfg = model[1]
    rng = np.random.default_rng(PROMPT_SEED)
    shared = rng.integers(0, cfg.vocab_size, 24)
    waves = [[np.concatenate([shared, rng.integers(0, cfg.vocab_size, 5 + 3 * i)])
              for i in range(2)],
             [np.concatenate([shared, rng.integers(0, cfg.vocab_size, 4 + 2 * i)])
              for i in range(4)]]
    paged = dict(enabled=True, page_size=PS, kv_dtype="f8", prefix_cache=True)
    cfg_j, _, pj, _ = model
    engines = [
        (jsched, JEngine(cfg_j, pj, JConfig(attn_backend="lean", max_batch=4, cache_len=64,
                                            num_workers=4, paged=JPaged(**paged),
                                            cascade=JCascade(enabled=True, stable_ticks=1)))),
        (tsched, _port(model, paged=paged, cascade=dict(enabled=True, stable_ticks=1),
                       num_workers=4)),
    ]
    streams = []
    for m, eng in engines:
        sch = m.Scheduler(eng, m.SchedulerConfig(chunk_size=8, prefill_pack=2, token_budget=32))
        got = []
        for wave in waves:
            hs = [sch.submit(p, max_new_tokens=4) for p in wave]
            sch.run_to_completion(max_steps=500)
            got += [tuple(h.generated) for h in hs]
        streams.append(got)
        assert eng.stats.cascade_fused_ticks > 0 and eng.stats.prefix_matched_tokens >= 4 * 24
    assert streams[1] == streams[0]
    eng.pool.check()
    eng.prefix_cache.check()


def test_f8_copy_on_write_carries_bytes(model):
    """A request that extends a cached sequence into its partial last page
    copies that page first: the clone carries the e4m3 bytes, and the
    streams equal those with the cache off."""
    vocab = model[1].vocab_size
    rng = np.random.default_rng(7)
    base = rng.integers(0, vocab, 11)                 # one full page + 3 tokens
    tail = rng.integers(0, vocab, 6)
    paged = dict(enabled=True, page_size=PS, kv_dtype="f8")
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
        eng.pool.check()
    assert streams[True] == streams[False]
    assert _CowRecorder.copies >= 1


def test_gemma3_f8_pages_and_rings_match_jax():
    """gemma3-4b's smoke model on f8 pages (blocking admission): the ``attn``
    layer's pool and the five ``win`` layers' rings are e4m3 in both
    packages, the rings read by the plain path widened; the streams and
    the caches equal the JAX engine's."""
    cfg_j, cfg = jax_smoke("gemma3-4b"), get_smoke_config("gemma3-4b")
    pj = jinit(jax.random.PRNGKey(0), cfg_j)
    gmodel = (cfg_j, cfg, pj, params_from_numpy(jax.tree.map(np.asarray, pj), cfg, device="cpu"))
    prompts = [np.random.default_rng(4).integers(0, cfg.vocab_size, n) for n in (21, 13, 5)]
    kw = dict(max_batch=3, cache_len=48, num_workers=4)
    jeng = _jax_engine(gmodel, page_size=PS, **kw)
    want = _serve(jeng, prompts, jax_side=True)
    eng = _port(gmodel, paged=dict(enabled=True, page_size=PS, kv_dtype="f8"), **kw)
    assert {lc["k"].dtype for lc in eng.cache} == {F8}
    assert _serve(eng, prompts) == want
    _assert_pools_equal(eng.cache, _jax_cache(gmodel, jeng))
    eng.pool.check()


@pytest.mark.parametrize("kv_dtype", ["f16", "f32"])
def test_f16_f32_caches_are_bf16_like_the_reference(model, jax_f8, kv_dtype):
    """The reference stores f16 and f32 caches as bf16 arrays (its
    ``KVLayout`` still counts 2 and 4 bytes): bf16 pools in both packages,
    the JAX engine's streams (the bf16 engine's), and the reference's
    page bytes."""
    prompts = _prompts(model[1].vocab_size)
    jeng = _jax_engine(model, "ref", kv_dtype=kv_dtype)
    want = _serve(jeng, prompts, jax_side=True)
    assert want == _serve(_jax_engine(model, "ref", kv_dtype="bf16"), prompts, jax_side=True)
    eng = _port(model, "ref", paged=dict(enabled=True, page_size=ENGINE_PS, kv_dtype=kv_dtype))
    assert _serve(eng, prompts) == want
    _assert_pools_equal(eng.cache, _jax_cache(model, jeng), dtype=torch.bfloat16)
    for dt in ("f32", "bf16", "f16", "f8", "int8"):
        lay = dict(kv_dtype=dt, n_kv_heads=8, head_dim=128, page_size=128, n_attn_layers=40)
        assert KVLayout(**lay).page_bytes == JLayout(**lay).page_bytes
    assert KVLayout(kv_dtype=kv_dtype).elem_bytes == {"f16": 2, "f32": 4}[kv_dtype]


def test_mistral_nemo_f8_page_bytes():
    """At Mistral-NeMo-12B (40 layers, Hkv 8, d 128, page 128) an f8 page
    holds 10,485,760 bytes, half of a bf16 page: 2.0000x the pages in the
    same memory."""
    mk = lambda dt: KVLayout(kv_dtype=dt, n_kv_heads=8, head_dim=128, page_size=128,
                             n_attn_layers=40)
    assert mk("f8").page_bytes == 10_485_760 and mk("f8").scale_bytes_per_page == 0
    assert mk("bf16").page_bytes == 2 * mk("f8").page_bytes
