"""The port's chunked prefill against the JAX package: the scatter and the
chunk oracle, the plain versions of K4 (stream-K chunk partials), K8 (paged
FA-2 chunk prefill) and K6 (fixed-split decode) against the Pallas kernels
in interpret mode, and the model's chunk forward against JAX's and against
its own blocking prefill.

Tolerance: 2e-5 absolute and relative in float32, the reference's contract
(tests/test_paged_invariants.py:177-180); both sides compute the same
float32 online softmax in another summation order.
"""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core import attention as jatt  # noqa: E402
from repro.core.leantile import make_chunk_schedule as jchunk  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import attention as tatt  # noqa: E402
from repro_torch.core.leantile import ScheduleCache, make_chunk_schedule  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.kernels import flash_prefill as tfp  # noqa: E402
from repro_torch.kernels import lean_prefill as tlp  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

jlp = importlib.import_module("repro.kernels.lean_prefill")
jfd = importlib.import_module("repro.kernels.flash_decode")
jfp = importlib.import_module("repro.kernels.flash_prefill")

TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pack(rng, Hq, Hkv, d, ps, W, offs, lens):
    """Pools, shuffled disjoint page tables and chunk queries of a pack; a
    row with ``lens = 0`` is a pad row (all-null table)."""
    N = len(offs)
    num_pages = 1 + N * W
    kp = rng.standard_normal((num_pages, Hkv, ps, d)).astype(np.float32)
    vp = rng.standard_normal((num_pages, Hkv, ps, d)).astype(np.float32)
    perm = rng.permutation(np.arange(1, num_pages))
    tbls = np.zeros((N, W), np.int32)
    k = 0
    for n in range(N):
        npages = -(-int(offs[n] + lens[n]) // ps)
        tbls[n, :npages] = perm[k:k + npages]
        k += npages
    C = int(max(max(lens), 1))
    q = rng.standard_normal((N, Hq, C, d)).astype(np.float32)
    return kp, vp, tbls, q


# (Hq, Hkv) x chunk cap x offsets: fresh, mid-page and page-aligned rows,
# one pad row; workers 4 and 7
GEOMS = [(4, 2), (4, 1), (2, 2)]
PACKS = {
    "cap5": dict(offs=[0, 9, 16, 0], lens=[5, 3, 5, 0], workers=4),
    "cap8": dict(offs=[8, 3, 0, 0], lens=[8, 8, 2, 0], workers=7),
}


def _pack_case(geom, pack, seed=0):
    Hq, Hkv = geom
    p = PACKS[pack]
    d, ps, W = 16, 8, 4
    rng = np.random.default_rng(seed)
    offs, lens = np.asarray(p["offs"]), np.asarray(p["lens"])
    kp, vp, tbls, q = _pack(rng, Hq, Hkv, d, ps, W, offs, lens)
    visible = [max(1, int(o + n)) for o, n in zip(offs, lens)]
    return dict(q=q, kp=kp, vp=vp, tbls=tbls, offs=offs, lens=lens, visible=visible,
                Hkv=Hkv, ps=ps, W=W, workers=p["workers"])


def test_paged_scatter_tokens_matches_jax():
    """Every live page equal to JAX's bit for bit, pad rows and a ``lens =
    0`` row included. Pad positions all write offset 0 of the null page in
    an unspecified order, so the null page is checked for what it may hold:
    zeros past offset 0, and at offset 0 one of the pad values."""
    rng = np.random.default_rng(2)
    d, ps, W, H = 4, 8, 4, 2
    tbls = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]], np.int32)
    offs = np.asarray([5, 0, 0], np.int32)
    lens = np.asarray([6, 4, 0], np.int32)
    vals = rng.standard_normal((3, 6, H, d)).astype(np.float32)
    pool = np.zeros((9, H, ps, d), np.float32)
    ref = np.asarray(jatt.paged_scatter_tokens(jnp.asarray(pool), jnp.asarray(tbls),
                                               jnp.asarray(offs), jnp.asarray(lens),
                                               jnp.asarray(vals)))
    out_pool = _t(pool)
    out = tatt.paged_scatter_tokens(out_pool, _t(tbls), _t(offs), _t(lens), _t(vals))
    assert out is out_pool                                 # in place
    np.testing.assert_array_equal(out.numpy()[1:], ref[1:])
    assert not out.numpy()[0, :, 1:].any()
    pads = [vals[n, i] for n in range(3) for i in range(6) if i >= lens[n]]
    assert any(np.array_equal(out.numpy()[0, :, 0], v) for v in pads)


@pytest.mark.parametrize("geom", GEOMS, ids=lambda g: f"{g[0]}q{g[1]}kv")
def test_chunk_oracle_matches_jax(geom):
    c = _pack_case(geom, "cap5")
    ref = jatt.mha_chunk_prefill_paged_ref(
        jnp.asarray(c["q"]), jnp.asarray(c["kp"]), jnp.asarray(c["vp"]),
        jnp.asarray(c["tbls"]), jnp.asarray(c["offs"], jnp.int32))
    out = tatt.mha_chunk_prefill_paged_ref(_t(c["q"]), _t(c["kp"]), _t(c["vp"]),
                                           _t(c["tbls"]), _t(c["offs"]))
    for n, L in enumerate(c["lens"]):
        np.testing.assert_allclose(out.numpy()[n, :, :L], np.asarray(ref)[n, :, :L], **TOL)


@pytest.mark.parametrize("pack", sorted(PACKS))
@pytest.mark.parametrize("geom", GEOMS, ids=lambda g: f"{g[0]}q{g[1]}kv")
def test_k4_plain_matches_pallas(geom, pack):
    """K4's per-piece partials, operand for operand, against the Pallas
    kernel in interpret mode, and ``ops.lean_prefill_chunks`` against the
    JAX entry point (valid rows)."""
    c = _pack_case(geom, pack)
    Hkv, ps, W, G = c["Hkv"], c["ps"], c["W"], c["workers"]
    N, Hq, C, d = c["q"].shape
    g = Hq // Hkv
    sj = jchunk(c["visible"], Hkv, ps, G, max_len=W * ps)
    st = make_chunk_schedule(c["visible"], Hkv, ps, G, max_len=W * ps)
    assert np.array_equal(sj.packed_descriptors(), st.packed_descriptors())
    seg_ctx = np.repeat(np.asarray(c["visible"], np.int32), Hkv)
    seg_qs = np.repeat(c["offs"].astype(np.int32), Hkv)
    q_seg = c["q"].reshape(N, Hkv, g, C, d).reshape(N * Hkv, g * C, d)
    rows_k, rows_v = c["kp"].reshape(-1, ps, d), c["vp"].reshape(-1, ps, d)
    route_t = tops._paged_route(st, _t(c["tbls"]), Hkv)
    route_j = jops._paged_route(sj, jnp.asarray(c["tbls"]), Hkv, fused=False)
    np.testing.assert_array_equal(route_t.numpy(), np.asarray(route_j))
    scale = 1.0 / np.sqrt(d)
    parts_j = jlp.lean_prefill_chunk_partials(
        jnp.asarray(q_seg), jnp.asarray(rows_k), jnp.asarray(rows_v), jnp.asarray(seg_ctx),
        jnp.asarray(seg_qs), route_j, sj, scale, chunk_cap=C, interpret=True)
    before = tlp.launches
    parts_t = tlp.lean_prefill_chunk_partials(
        _t(q_seg), _t(rows_k), _t(rows_v), _t(seg_ctx), _t(seg_qs), route_t, st, scale,
        chunk_cap=C)
    assert tlp.launches == before                       # plain runs do not count
    for a, b in zip(parts_t, parts_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)

    out_j = jops.lean_prefill_chunks(
        jnp.asarray(c["q"]), jnp.asarray(c["kp"]), jnp.asarray(c["vp"]),
        jnp.asarray(seg_ctx), jnp.asarray(seg_qs), jnp.asarray(c["tbls"]), sj, interpret=True)
    out_t = tops.lean_prefill_chunks(_t(c["q"]), _t(c["kp"]), _t(c["vp"]), _t(seg_ctx),
                                     _t(seg_qs), _t(c["tbls"]), st)
    for n, L in enumerate(c["lens"]):
        np.testing.assert_allclose(out_t.numpy()[n, :, :L], np.asarray(out_j)[n, :, :L], **TOL)


def test_k4_masked_piece_gets_zero_weight():
    """A row that sees no key of a piece flushes m = -1e30, l = 0, and the
    merge weighs that piece 0: with many workers the offset-0 row of a long
    segment ends in pieces past its position, and still matches the oracle."""
    c = _pack_case((4, 2), "cap8")
    Hkv, ps, W = c["Hkv"], c["ps"], c["W"]
    st = make_chunk_schedule(c["visible"], Hkv, ps, 16, max_len=W * ps)
    seg_ctx = _t(np.repeat(np.asarray(c["visible"], np.int32), Hkv))
    seg_qs = _t(np.repeat(c["offs"].astype(np.int32), Hkv))
    N, Hq, C, d = c["q"].shape
    q_seg = _t(c["q"].reshape(N * Hkv, (Hq // Hkv) * C, d))
    k_rows, v_rows = tops._pool_rows(_t(c["kp"]), _t(c["vp"]))
    route = tops._paged_route(st, _t(c["tbls"]), Hkv)
    o_p, m_p, l_p = tlp.lean_prefill_chunk_partials(q_seg, k_rows, v_rows, seg_ctx, seg_qs,
                                                    route, st, 0.25, chunk_cap=C)
    empty = l_p == 0
    assert empty.any()
    assert torch.all(m_p[empty] == -1e30)
    ref = tatt.mha_chunk_prefill_paged_ref(_t(c["q"]), _t(c["kp"]), _t(c["vp"]),
                                           _t(c["tbls"]), _t(c["offs"]))
    out = tops.lean_prefill_chunks(_t(c["q"]), _t(c["kp"]), _t(c["vp"]), seg_ctx, seg_qs,
                                   _t(c["tbls"]), st)
    for n, L in enumerate(c["lens"]):
        np.testing.assert_allclose(out.numpy()[n, :, :L], ref.numpy()[n, :, :L], **TOL)


@pytest.mark.parametrize("pack", sorted(PACKS))
@pytest.mark.parametrize("geom", GEOMS, ids=lambda g: f"{g[0]}q{g[1]}kv")
def test_k8_plain_matches_pallas(geom, pack):
    c = _pack_case(geom, pack, seed=1)
    ref = jfp.flash_prefill_paged(
        jnp.asarray(c["q"]), jnp.asarray(c["kp"]), jnp.asarray(c["vp"]),
        jnp.asarray(c["tbls"]), jnp.asarray(c["offs"], jnp.int32), interpret=True)
    before = tfp.launches
    out = tfp.flash_prefill_paged(_t(c["q"]), _t(c["kp"]), _t(c["vp"]), _t(c["tbls"]),
                                  _t(c["offs"].astype(np.int32)))
    assert tfp.launches == before and out.dtype == torch.float32
    for n, L in enumerate(c["lens"]):
        np.testing.assert_allclose(out.numpy()[n, :, :L], np.asarray(ref)[n, :, :L], **TOL)


DECODE = {
    "ragged": dict(lens=[37, 1, 20, 0], splits=3, tile=8),
    "one-split": dict(lens=[40, 9], splits=1, tile=8),
    "more-splits-than-tiles": dict(lens=[12, 3], splits=7, tile=8),
}


@pytest.mark.parametrize("case", sorted(DECODE))
def test_k6_plain_and_flash_decode_match_pallas(case):
    """K6's per-(segment, split) partials against the Pallas kernel, and
    ``ops.flash_decode_from_lens`` / ``ops.flash_decode`` against JAX's."""
    c = DECODE[case]
    rng = np.random.default_rng(3)
    lens, splits, tile = c["lens"], c["splits"], c["tile"]
    B, Hq, Hkv, d, S = len(lens), 4, 2, 16, 40
    q = rng.standard_normal((B, Hq, d)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, d)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, d)).astype(np.float32)
    seg = np.repeat(np.asarray(lens, np.int32), Hkv)
    scale = 1.0 / np.sqrt(d)
    q_seg, k_seg, v_seg = q.reshape(B * Hkv, 2, d), k.reshape(B * Hkv, S, d), v.reshape(B * Hkv, S, d)
    ref = jfd.flash_decode_partials(jnp.asarray(q_seg), jnp.asarray(k_seg), jnp.asarray(v_seg),
                                    jnp.asarray(seg), splits, tile, scale, interpret=True)
    before = tfd.launches
    out = tfd.flash_decode_partials(_t(q_seg), _t(k_seg), _t(v_seg), _t(seg), splits, tile,
                                    scale)
    assert tfd.launches == before
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    live = np.asarray(lens) > 0
    oj = jops.flash_decode_from_lens(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(seg), num_splits=splits, tile=tile,
                                     interpret=True)
    ot = tops.flash_decode_from_lens(_t(q), _t(k), _t(v), _t(seg), num_splits=splits,
                                     tile=tile)
    np.testing.assert_allclose(ot.numpy()[live], np.asarray(oj)[live], **TOL)
    if live.all():
        oj = jops.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lens,
                               num_workers=5, interpret=True)
        ot = tops.flash_decode(_t(q), _t(k), _t(v), lens, num_workers=5)
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **TOL)


def test_chunk_schedules_hit_the_cache():
    """Nearby visible lengths share one bucketed schedule, and the bucketed
    schedule still computes the exact answer (runtime masking)."""
    c = _pack_case((4, 2), "cap5", seed=4)
    Hkv, ps, W = c["Hkv"], c["ps"], c["W"]
    cache = ScheduleCache()
    seen = [make_chunk_schedule([v + s for v in c["visible"]], Hkv, ps, 4, max_len=W * ps,
                                cache=cache) for s in (0, 1)]
    assert cache.stats.misses == 1 and cache.stats.hits == 1 and seen[0] is seen[1]
    ref = tatt.mha_chunk_prefill_paged_ref(_t(c["q"]), _t(c["kp"]), _t(c["vp"]),
                                           _t(c["tbls"]), _t(c["offs"]))
    out = tops.lean_prefill_chunks(
        _t(c["q"]), _t(c["kp"]), _t(c["vp"]),
        _t(np.repeat(np.asarray(c["visible"], np.int32), Hkv)),
        _t(np.repeat(c["offs"].astype(np.int32), Hkv)), _t(c["tbls"]), seen[1])
    for n, L in enumerate(c["lens"]):
        np.testing.assert_allclose(out.numpy()[n, :, :L], ref.numpy()[n, :, :L], **TOL)


@pytest.mark.parametrize("kind,fields,msg", [
    ("flash", dict(num_splits=None, tile=8), "num_splits and tile"),
    ("verify", dict(spec_rows=0, sched=make_chunk_schedule([8], 1, 8, 1)), "spec_rows"),
    ("paged", dict(), "need a schedule"),
])
def test_plan_validation(kind, fields, msg):
    with pytest.raises(ValueError, match=msg):
        tops.DecodePlan(kind=kind, **fields)


# ------------------------------------------------------------------ model
BF16 = dict(rtol=2**-7, atol=2**-7)      # one bf16 step, as tests/test_torch_models.py


@pytest.fixture(scope="module")
def model():
    cfg_j = jax_smoke("mistral-nemo-12b")
    cfg = get_smoke_config("mistral-nemo-12b")
    pj = jinit(jax.random.PRNGKey(0), cfg_j)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), cfg, device="cpu")
    return cfg_j, cfg, pj, pt


def _f(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _chunk_attn(kind, cfg, offs, lens, ps, W, jax_side):
    """The engine's chunk attention closures on either side: the oracle
    (None), lean (K4 + merge) or fixed (K8)."""
    if kind == "oracle":
        return None
    visible = [max(1, int(o + n)) for o, n in zip(offs, lens)]
    seg_ctx = np.repeat(np.asarray(visible, np.int32), cfg.n_kv_heads)
    seg_qs = np.repeat(np.asarray(offs, np.int32), cfg.n_kv_heads)
    if jax_side:
        sched = jchunk(visible, cfg.n_kv_heads, ps, 3, max_len=W * ps)
        if kind == "lean":
            return lambda q, kp, vp, t, o: jops.lean_prefill_chunks(
                q, kp, vp, jnp.asarray(seg_ctx), jnp.asarray(seg_qs), t, sched, interpret=True)
        return lambda q, kp, vp, t, o: jfp.flash_prefill_paged(q, kp, vp, t, o, interpret=True)
    sched = make_chunk_schedule(visible, cfg.n_kv_heads, ps, 3, max_len=W * ps)
    if kind == "lean":
        return lambda q, kp, vp, t, o: tops.lean_prefill_chunks(
            q, kp, vp, _t(seg_ctx), _t(seg_qs), t, sched)
    return lambda q, kp, vp, t, o: tfp.flash_prefill_paged(q, kp, vp, t, o.to(torch.int32))


@pytest.mark.parametrize("attn", ["oracle", "lean", "fixed"])
def test_attn_prefill_chunk_paged_matches(model, attn):
    """One layer's chunk step (projection, rotary, K/V append into the pool
    before attention, attention, output projection) against the
    reference's, on identical random pools: a fresh chunk, one mid-page and
    a pad row. The kernels keep probabilities in float32 where the oracle
    rounds them to bf16, so they are held to two bf16 steps."""
    cfg_j, cfg, pj, pt = model
    rng = np.random.default_rng(5)
    ps, W, C = 8, 4, 5
    shape = (13, cfg.n_kv_heads, ps, cfg.head_dim)
    k_np, v_np = [(rng.standard_normal(shape) * 0.5).astype(np.float32) for _ in range(2)]
    tbl = np.asarray([[3, 0, 0, 0], [7, 2, 0, 0], [0, 0, 0, 0]], np.int32)
    offs, lens = np.asarray([0, 9, 0], np.int32), np.asarray([5, 3, 0], np.int32)
    x = rng.standard_normal((3, C, cfg.d_model)).astype(np.float32)
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
              rope_theta=cfg.rope_theta)
    pj0 = jax.tree.map(lambda a: a[0], pj["stages"][0][0]["attn"])
    out_j, kp_j, vp_j = jlayers.attn_prefill_chunk_paged(
        pj0, jnp.asarray(x), jnp.asarray(k_np).astype(jnp.bfloat16),
        jnp.asarray(v_np).astype(jnp.bfloat16), jnp.asarray(tbl), jnp.asarray(offs),
        jnp.asarray(lens), attn_fn=_chunk_attn(attn, cfg, offs, lens, ps, W, True), **kw)
    kp_t, vp_t = _t(k_np).bfloat16(), _t(v_np).bfloat16()
    out_t, kp_o, vp_o = tlayers.attn_prefill_chunk_paged(
        pt["layers"][0]["attn"], _t(x), kp_t, vp_t, _t(tbl), _t(offs), _t(lens),
        attn_fn=_chunk_attn(attn, cfg, offs, lens, ps, W, False), **kw)
    assert kp_o is kp_t and vp_o is vp_t                  # pools updated in place
    tol = BF16 if attn == "oracle" else dict(rtol=2**-6, atol=2**-6)
    for n, L in enumerate(lens):
        np.testing.assert_allclose(out_t.numpy()[n, :L], np.asarray(out_j)[n, :L], **tol)
    np.testing.assert_allclose(kp_t.float().numpy()[1:], _f(kp_j)[1:], **BF16)
    np.testing.assert_allclose(vp_t.float().numpy()[1:], _f(vp_j)[1:], **BF16)


def _stream(prefill_fn, prompts, C, ps, W):
    """Stream ``prompts`` through chunk steps of a pack as wide as the
    prompts, one chunk per prompt and step (a finished prompt rides as a
    pad row). Returns each prompt's first-token logits."""
    N = len(prompts)
    tbl = np.zeros((N, W), np.int32)
    for n in range(N):
        tbl[n] = 1 + n * W + np.arange(W)
    first = [None] * N
    for off in range(0, max(map(len, prompts)), C):
        toks = np.zeros((N, C), np.int32)
        lens = np.zeros(N, np.int32)
        offs = np.zeros(N, np.int32)
        for n, p in enumerate(prompts):
            chunk = p[off:off + C]
            if len(chunk):
                toks[n, :len(chunk)], lens[n], offs[n] = chunk, len(chunk), off
        logits = prefill_fn(toks, offs, lens, tbl)
        for n, p in enumerate(prompts):
            if len(p[off:off + C]) and off + C >= len(p):
                first[n] = logits[n]
    return first, tbl


def test_prefill_chunks_matches_jax(model):
    """Two prompts streamed through ``prefill_chunks`` in packs of two
    (oracle attention): first-token logits and the pools, gathered through
    the tables, against the reference's."""
    cfg_j, cfg, pj, pt = model
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (13, 7)]
    C, ps, W = 5, 8, 4
    num_pages = 1 + len(prompts) * W
    jc = [jtf.init_paged_cache(cfg_j, len(prompts), W * ps, num_pages, ps)]

    def jstep(toks, offs, lens, tbl):
        logits, jc[0] = jtf.prefill_chunks(pj, cfg_j, jc[0], jnp.asarray(toks), jnp.asarray(offs),
                                           jnp.asarray(lens), jnp.asarray(tbl))
        return np.asarray(logits)

    tc = ttf.init_paged_cache(cfg, num_pages, ps, device="cpu")

    def tstep(toks, offs, lens, tbl):
        logits, _ = ttf.prefill_chunks(pt, cfg, tc, _t(toks), _t(offs), _t(lens), _t(tbl))
        return logits.numpy()

    first_j, tbl = _stream(jstep, prompts, C, ps, W)
    first_t, _ = _stream(tstep, prompts, C, ps, W)
    for a, b in zip(first_t, first_j):
        np.testing.assert_allclose(a, b, **BF16)
    for i in range(cfg.n_layers):
        for key in ("k", "v"):
            dj = _f(jatt.paged_gather_kv(jc[0][0][0][key][i], jnp.asarray(tbl)))
            dt = tatt.paged_gather_kv(tc[i][key], _t(tbl)).float().numpy()
            for n, p in enumerate(prompts):
                np.testing.assert_allclose(dt[n, :, :len(p)], dj[n, :, :len(p)], **BF16)


def _chunked_vs_blocking(cfg, params, plen, C, ps, W, seed=7):
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, cfg.vocab_size, plen).astype(np.int64)
    logits_b, cache_b, _ = ttf.prefill(params, cfg, torch.from_numpy(prompt[None]),
                                       cache_len=W * ps)
    cache_c = ttf.init_paged_cache(cfg, 1 + W, ps, device="cpu")

    def step(toks, offs, lens, tbl):
        logits, _ = ttf.prefill_chunks(params, cfg, cache_c, _t(toks), _t(offs), _t(lens),
                                       _t(tbl))
        return logits

    first, tbl = _stream(step, [prompt], C, ps, W)
    return logits_b[0], cache_b, first[0], cache_c, tbl


@pytest.mark.parametrize("mqa", [False, True], ids=["gqa", "mqa"])
def test_chunked_prefill_matches_blocking(model, mqa):
    """The reference's contract (tests/test_chunked_prefill.py:159-181): the
    KV a prompt leaves in the pool chunk by chunk and its first-token logits
    equal the whole-prompt prefill's, bit for bit -- the same ops on the
    same rows (rotary at absolute positions, masked keys contributing exact
    zeros)."""
    cfg_j, cfg, pj, pt = model
    if mqa:
        cfg = dataclasses.replace(cfg, name="smoke-mqa", n_kv_heads=1)
        cfg_j = dataclasses.replace(cfg_j, name="smoke-mqa", n_kv_heads=1)
        pt = params_from_numpy(jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(1), cfg_j)),
                               cfg, device="cpu")
    assert ttf.supports_chunked_prefill(cfg)
    plen = 11 if mqa else 13
    lb, cache_b, lc, cache_c, tbl = _chunked_vs_blocking(cfg, pt, plen, C=4 if mqa else 5,
                                                         ps=8, W=4)
    assert torch.equal(lb, lc)
    for lcb, lcc in zip(cache_b, cache_c):
        for key in ("k", "v"):
            gathered = tatt.paged_gather_kv(lcc[key], _t(tbl))[0, :, :plen]
            assert torch.equal(lcb[key][0, :, :plen], gathered)


def test_chunked_prefill_rejects_unsupported_arch(model):
    _, cfg, _, pt = model
    cfg = dataclasses.replace(cfg, rope_theta=None)
    assert not ttf.supports_chunked_prefill(cfg)
    with pytest.raises(ValueError, match="chunked prefill"):
        ttf.prefill_chunks(pt, cfg, [], torch.zeros(1, 4, dtype=torch.int64),
                           torch.zeros(1), torch.ones(1), torch.zeros(1, 1, dtype=torch.int32))
