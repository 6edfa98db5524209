"""Cascade (prefix-grouped) decode and the merge kernel in the port, against
the JAX package on the same numpy inputs.

  * K5's plain version against the Pallas ``lean_cascade_fused`` in
    interpret mode, operand for operand, and ``ops.lean_decode_cascade``
    (fused and two-call) against the JAX entry point, on one-level and
    two-level groupings over GQA, MQA and MHA geometries: float32 within
    2e-5 (tests/test_cascade.py's contract). The same cascade over
    duplicated pages is bit-identical to the one over shared pages.
  * K3's plain version against ``lean_merge_pallas``, and
    ``DecodePlan(merge_impl="pallas")`` against ``"xla"`` on the dense,
    paged and verify two-phase paths.
  * The port's ``Scheduler`` with ``prefix_cache`` and ``cascade`` on the
    smoke config: the reference engine's prefix and cascade counters on
    tests/test_cascade.py's waves, the streams of the port's unshared lean
    run on waves of margin prompts (``PROMPT_SEED``, as
    tests/test_torch_scheduler.py), and copy-on-write on a partial-page
    divergence.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core import leantile as jlt  # noqa: E402
from repro.kernels.lean_decode import lean_cascade_fused as jcascade  # noqa: E402
from repro.kernels.lean_decode import lean_merge_pallas  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro.serving.config import CascadeConfig as JCascade  # noqa: E402
from repro.serving.config import EngineConfig as JConfig, PagedConfig as JPaged  # noqa: E402
from repro.serving.engine import DecodeEngine as JEngine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import leantile as tlt  # noqa: E402
from repro_torch.kernels import lean_decode as tld  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402
from repro_torch.serving.config import CascadeConfig, EngineConfig, PagedConfig  # noqa: E402
from repro_torch.serving.engine import DecodeEngine  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
GEOMS = [(4, 2, 16), (4, 1, 16), (3, 3, 8)]     # GQA / MQA / MHA: (Hq, Hkv, d)
PS = 8
# grouped passes (members, page_start, pages) and per-sequence suffixes:
# one level (3 of 4 share 3 pages), two levels (4 share 2, 2 of them 2 more)
LEVELS = {
    "one-level": ([((0, 1, 2), 0, 3)], [5, 20, 33, 11]),
    "two-level": ([((0, 1, 2, 3), 0, 2), ((1, 2), 2, 2)], [3, 9, 17, 30]),
}
PROMPT_SEED = 25          # margin prompts, as tests/test_torch_scheduler.py


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _problem(geom, level, seed=0):
    """Pools, tables and queries where the passes' members alias shared
    pages; every other page is private and the pages are shuffled. Also
    returns a copy in which every member past a pass's first reads its own
    duplicate of the shared pages."""
    Hq, Hkv, d = geom
    passes, suffixes = LEVELS[level]
    rng = np.random.default_rng(seed)
    B = len(suffixes)
    cover = [0] * B
    for mem, st, cnt in passes:
        for b in mem:
            cover[b] = max(cover[b], st + cnt)
    lens = [cover[b] * PS + suffixes[b] for b in range(B)]
    n_pages = [-(-L // PS) for L in lens]
    W = max(n_pages) + 1
    dup = sum(cnt * (len(mem) - 1) for mem, _, cnt in passes)
    num_pages = 1 + sum(n_pages) + dup + 2
    kp = rng.standard_normal((num_pages, Hkv, PS, d)).astype(np.float32)
    vp = rng.standard_normal((num_pages, Hkv, PS, d)).astype(np.float32)
    q = rng.standard_normal((B, Hq, d)).astype(np.float32)
    free = [int(p) for p in rng.permutation(np.arange(1, num_pages))]
    tbl = np.zeros((B, W), np.int32)
    k2, v2, tbl2 = kp.copy(), vp.copy(), None
    shared = []
    for mem, st, cnt in passes:
        pages = [free.pop() for _ in range(cnt)]
        shared.append((mem, st, pages))
        for b in mem:
            tbl[b, st:st + cnt] = pages
    for b in range(B):
        for t in range(cover[b], n_pages[b]):
            tbl[b, t] = free.pop()
    tbl2 = tbl.copy()
    for mem, st, pages in shared:
        for b in mem[1:]:
            copy = [free.pop() for _ in pages]
            k2[copy], v2[copy] = kp[pages], vp[pages]
            tbl2[b, st:st + len(pages)] = copy
    groups = [list(m) for m, _, _ in passes]
    counts = [c for _, _, c in passes]
    starts = [s for _, s, _ in passes]
    return dict(q=q, kp=kp, vp=vp, tbl=tbl, k2=k2, v2=v2, tbl2=tbl2, lens=lens,
                groups=groups, counts=counts, starts=starts, Hkv=Hkv)


def _cascade(side, c, fused, workers=6, dup=False):
    kp, vp, tbl = (c["k2"], c["v2"], c["tbl2"]) if dup else (c["kp"], c["vp"], c["tbl"])
    args = (c["lens"], c["groups"], c["counts"])
    kw = dict(page_starts=c["starts"], num_workers=workers, fused=fused, return_lse=True)
    if side == "jax":
        o, lse = jops.lean_decode_cascade(jnp.asarray(c["q"]), jnp.asarray(kp), jnp.asarray(vp),
                                          tbl, *args, interpret=True, **kw)
        return np.asarray(o), np.asarray(lse)
    o, lse = tops.lean_decode_cascade(_t(c["q"]), _t(kp), _t(vp), tbl, *args, **kw)
    return o.numpy(), lse.numpy()


@pytest.mark.parametrize("level", sorted(LEVELS))
@pytest.mark.parametrize("geom", GEOMS, ids=lambda g: f"{g[0]}q{g[1]}kv")
def test_k5_plain_matches_pallas(geom, level):
    """K5's plain version against the Pallas fused cascade kernel, operand
    for operand: same schedule, descriptors and routes."""
    c = _problem(geom, level)
    Hq, Hkv, d = geom
    g, B = Hq // Hkv, len(c["lens"])
    max_len = c["tbl"].shape[1] * PS
    kw = dict(page_starts=c["starts"], max_len=max_len)
    sj, bj = jlt.make_cascade_schedule(c["lens"], c["groups"], c["counts"], Hkv, PS, 6, **kw)
    st, bt = tlt.make_cascade_schedule(c["lens"], c["groups"], c["counts"], Hkv, PS, 6, **kw)
    desc = tlt.cascade_fused_descriptors(st, bt)
    np.testing.assert_array_equal(desc, jlt.cascade_fused_descriptors(sj, bj))
    ptbl, stbl = tops.cascade_tables(c["tbl"], bt)
    nmax, NP = st.group_size, st.num_groups
    mem = np.clip(bt.members, 0, None)
    q_pref = np.moveaxis(c["q"].reshape(B, Hkv, g, d)[mem], 2, 1).reshape(NP * Hkv, nmax * g, d)
    q_suf = c["q"].reshape(B * Hkv, g, d)
    suffix = np.asarray(c["lens"]) - bt.seq_prefix_len
    ctx_all = np.concatenate([np.repeat(bt.prefix_lens, Hkv), np.repeat(suffix, Hkv)])
    ctx_all = ctx_all.astype(np.int32)
    route = torch.cat([tops.paged_route(st.prefix_sched, _t(ptbl), Hkv),
                       tops.paged_route(st.suffix_sched, _t(stbl), Hkv)]).numpy()
    rows_k, rows_v = c["kp"].reshape(-1, PS, d), c["vp"].reshape(-1, PS, d)
    scale = 1.0 / math.sqrt(d)
    q_stack = np.concatenate([q_pref, np.pad(q_suf, ((0, 0), (0, nmax * g - g), (0, 0)))])
    route_j = np.concatenate([route, np.zeros(sj.fused_merge_iters, np.int32)])
    o_j, lse_j = jcascade(
        jnp.asarray(q_stack), jnp.asarray(rows_k), jnp.asarray(rows_v), jnp.asarray(ctx_all),
        jnp.asarray(route_j), jnp.asarray(desc), sj, scale, g, interpret=True)
    before = tld.cascade_launches
    o_t, lse_t = tld.lean_cascade_fused(
        _t(q_pref), _t(q_suf), _t(rows_k), _t(rows_v), _t(ctx_all), _t(route),
        tld.cascade_fused_desc(desc, st, torch.device("cpu")), st, scale)
    assert tld.cascade_launches == before                # plain runs do not count
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **TOL)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("level", sorted(LEVELS))
@pytest.mark.parametrize("geom", GEOMS, ids=lambda g: f"{g[0]}q{g[1]}kv")
def test_cascade_decode_matches_jax(geom, level, fused):
    """``ops.lean_decode_cascade`` against the JAX entry point, K5 (fused)
    and K1 x 2 + segment_merge (two-call); and against the port's unshared
    paged decode, which walks every shared page once per sequence."""
    c = _problem(geom, level)
    o_t, lse_t = _cascade("torch", c, fused)
    o_j, lse_j = _cascade("jax", c, fused)
    np.testing.assert_allclose(o_t, o_j, **TOL)
    np.testing.assert_allclose(lse_t, lse_j, **TOL)
    o_p = tops.lean_decode_paged(_t(c["q"]), _t(c["kp"]), _t(c["vp"]), c["tbl"], c["lens"],
                                 num_workers=6)
    np.testing.assert_allclose(o_t, o_p.numpy(), **TOL)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("level", sorted(LEVELS))
def test_cascade_shared_equals_duplicated_bitwise(level, fused):
    """The reference's contract: the same cascade over duplicated pages
    gives the same bits as over shared ones."""
    c = _problem((4, 2, 16), level, seed=3)
    for a, b in zip(_cascade("torch", c, fused), _cascade("torch", c, fused, dup=True)):
        assert np.array_equal(a, b)


def test_cascade_plan_takes_a_cascade_schedule():
    lean = tlt.make_schedule([8], 1, 8, 1)
    csched, _ = tlt.make_cascade_schedule([20, 20], [[0, 1]], [2], 1, 8, 2)
    assert tops.DecodePlan(kind="cascade", sched=csched).kind == "cascade"
    for kind, sched in (("cascade", lean), ("paged", csched)):
        with pytest.raises(ValueError, match="CascadeSchedule"):
            tops.DecodePlan(kind=kind, sched=sched)
    with pytest.raises(ValueError, match="merge_impl"):
        tops.DecodePlan(kind="paged", sched=lean, merge_impl="triton")


# ----------------------------------------------------------------------- K3
@pytest.mark.parametrize("lens,workers", [([37, 1, 20], 4), ([48, 17, 3], 40), ([9], 1)])
def test_k3_plain_matches_pallas(lens, workers):
    """K3's plain version against ``lean_merge_pallas`` on random partials
    laid out by a schedule (pieces contiguous per segment)."""
    sched_j = jlt.make_schedule(lens, 2, 8, workers)
    sched_t = tlt.make_schedule(lens, 2, 8, workers)
    rng = np.random.default_rng(1)
    P, gq, d = sched_t.num_pieces, 4, 16
    o_p = rng.standard_normal((P, gq, d)).astype(np.float32)
    m_p = rng.standard_normal((P, gq)).astype(np.float32) * 3
    l_p = rng.uniform(0.5, 4.0, (P, gq)).astype(np.float32)
    o_j, lse_j = lean_merge_pallas(jnp.asarray(o_p), jnp.asarray(m_p), jnp.asarray(l_p),
                                       sched_j, interpret=True)
    before = tld.merge_launches
    o_t, lse_t = tld.lean_merge(_t(o_p), _t(m_p), _t(l_p), sched_t)
    assert tld.merge_launches == before
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **TOL)


def test_k3_guards_neg_inf_pieces():
    """A piece whose max is -inf weighs 0 (core/merge.py's guards)."""
    sched = tlt.make_schedule([24], 1, 8, 3)           # one segment, 3 pieces
    o_p = torch.randn(3, 2, 4)
    m_p = torch.tensor([[0.5, float("-inf")], [float("-inf"), 1.0], [0.25, -2.0]])
    l_p = torch.tensor([[2.0, 0.0], [0.0, 3.0], [1.0, 1.0]])
    o, lse = tld.lean_merge(o_p, m_p, l_p, sched)
    keep = [[0, 2], [1, 2]]
    for r, ps in enumerate(keep):
        m = m_p[ps, r].max()
        w = torch.exp(m_p[ps, r] - m)
        ref = (w[:, None] * o_p[ps, r]).sum(0) / (w * l_p[ps, r]).sum()
        torch.testing.assert_close(o[0, r], ref, **TOL)
        torch.testing.assert_close(lse[0, r], m + torch.log((w * l_p[ps, r]).sum()), **TOL)


def test_merge_impl_pallas_matches_xla_and_jax():
    """``merge_impl="pallas"`` (K3) against ``"xla"`` (segment_merge) on the
    dense, paged and verify two-phase paths, and against the JAX package's
    ``"pallas"`` on the paged path."""
    rng = np.random.default_rng(2)
    lens, Hq, Hkv, d, W = [37, 1, 20], 4, 2, 16, 6
    B = len(lens)
    n_pages = [-(-L // PS) for L in lens]
    num_pages = 1 + sum(n_pages) + 2
    kp = rng.standard_normal((num_pages, Hkv, PS, d)).astype(np.float32)
    vp = rng.standard_normal((num_pages, Hkv, PS, d)).astype(np.float32)
    q = rng.standard_normal((B, Hq, d)).astype(np.float32)
    perm = rng.permutation(np.arange(1, num_pages))
    tbl = np.zeros((B, W), np.int32)
    k = 0
    for b, n in enumerate(n_pages):
        tbl[b, :n] = perm[k:k + n]
        k += n
    out = {}
    for impl in ("xla", "pallas"):
        out[impl] = tops.lean_decode_paged(_t(q), _t(kp), _t(vp), tbl, lens, num_workers=4,
                                           fused=False, merge_impl=impl, return_lse=True)
        dense_k = _t(np.moveaxis(kp[tbl], 2, 1).reshape(B, Hkv, W * PS, d))
        dense_v = _t(np.moveaxis(vp[tbl], 2, 1).reshape(B, Hkv, W * PS, d))
        out[impl + "-dense"] = tops.lean_decode(_t(q), dense_k, dense_v, lens, num_workers=4,
                                                tile=PS, merge_impl=impl, return_lse=True)
    for a, b in zip(out["pallas"], out["xla"]):
        torch.testing.assert_close(a, b, **TOL)
    for a, b in zip(out["pallas-dense"], out["xla-dense"]):
        torch.testing.assert_close(a, b, **TOL)
    o_j, lse_j = jops.lean_decode_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), tbl,
                                        lens, num_workers=4, fused=False, merge_impl="pallas",
                                        interpret=True, return_lse=True)
    np.testing.assert_allclose(out["pallas"][0].numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(out["pallas"][1].numpy(), np.asarray(lse_j), **TOL)

    # verify: a pack of two chunks, g * C rows per segment
    offs, clens, C = np.array([9, 0]), np.array([5, 3]), 5
    visible = [int(o + n) for o, n in zip(offs, clens)]
    sched = tlt.make_chunk_schedule(visible, Hkv, PS, 4, max_len=W * PS)
    qc = _t(rng.standard_normal((2, Hq, C, d)).astype(np.float32))
    seg_ctx = _t(np.repeat(np.asarray(visible, np.int32), Hkv))
    seg_qs = _t(np.repeat(offs.astype(np.int32), Hkv))
    # the two-phase verify plan (fused=False; a fused plan merges in its launch)
    res = [tops.decode(qc, (_t(kp), _t(vp)),
                       plan=tops.DecodePlan(kind="verify", sched=sched, fused=False,
                                            merge_impl=impl, spec_rows=C),
                       ctx=seg_ctx, page_tbl=_t(tbl[:2]), qstart=seg_qs)
           for impl in ("xla", "pallas")]
    for n, L in enumerate(clens):
        torch.testing.assert_close(res[1][n, :, :L], res[0][n, :, :L], **TOL)


# ------------------------------------------------------------------ serving
SCHED = dict(chunk_size=8, prefill_pack=2, token_budget=32)
COUNTERS = ("prefix_matched_tokens", "prefix_attach_count", "cascade_ticks",
            "cascade_fused_ticks", "cascade_grouped_passes")


@pytest.fixture(scope="module")
def model():
    cfg_j = jax_smoke("mistral-nemo-12b")
    cfg = get_smoke_config("mistral-nemo-12b")
    pj = jinit(jax.random.PRNGKey(0), cfg_j)
    return cfg_j, cfg, pj, params_from_numpy(jax.tree.map(np.asarray, pj), cfg, device="cpu")


def _waves(vocab, seed=0):
    """tests/test_cascade.py's waves: two requests and then four sharing a
    24-token (three-page) prompt prefix, with tails of their own."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 24)
    w1 = [np.concatenate([shared, rng.integers(0, vocab, 5 + 3 * i)]) for i in range(2)]
    w2 = [np.concatenate([shared, rng.integers(0, vocab, 4 + 2 * i)]) for i in range(4)]
    return [w1, w2]


def _serve(model, side, waves, *, prefix_cache, cascade, backend="lean", new=4, fused=True,
           **ckw):
    """Serve the waves one after another through the Scheduler; returns the
    streams and the engine, whose pool and radix cache must check clean."""
    cfg_j, cfg, pj, pt = model
    common = dict(max_batch=4, cache_len=64, attn_backend=backend, num_workers=4)
    casc = dict(enabled=cascade, stable_ticks=1, **ckw)
    if side == "jax":
        eng = JEngine(cfg_j, pj, JConfig(paged=JPaged(enabled=True, page_size=PS,
                                                      prefix_cache=prefix_cache),
                                         cascade=JCascade(fused=fused, **casc), **common))
        m = jsched
    else:
        eng = DecodeEngine(cfg, pt, EngineConfig(
            paged=PagedConfig(enabled=True, page_size=PS, prefix_cache=prefix_cache),
            cascade=CascadeConfig(fused=fused, **casc), **common), device="cpu")
        m = tsched
    sch = m.Scheduler(eng, m.SchedulerConfig(**SCHED))
    out = []
    for wave in waves:
        hs = [sch.submit(p, max_new_tokens=new) for p in wave]
        sch.run_to_completion(max_steps=500)
        out.extend(tuple(h.generated) for h in hs)
    eng.pool.check()
    if eng.prefix_cache is not None:
        eng.prefix_cache.check()
    return out, eng


def test_cascade_scheduler_counters_match_jax(model):
    """On the reference's waves the port's cascade Scheduler attaches,
    matches and groups exactly as the JAX engine does."""
    waves = _waves(model[1].vocab_size)
    _, ej = _serve(model, "jax", waves, prefix_cache=True, cascade=True)
    _, et = _serve(model, "torch", waves, prefix_cache=True, cascade=True)
    got = {k: getattr(et.stats, k) for k in COUNTERS}
    assert got == {k: getattr(ej.stats, k) for k in COUNTERS}
    assert got["prefix_attach_count"] >= 4 and got["cascade_fused_ticks"] > 0
    assert et.stats.cascade_last == ej.stats.cascade_last


def test_cascade_mixed_depth_counters_match_jax(model):
    """Requests matching 1, 3 and 5 pages of one cached chain: LCP grouping
    stacks a deeper pass for the deeper pair (tests/test_cascade.py's
    mixed-depth case); counters and levels equal the JAX engine's."""
    vocab = model[1].vocab_size
    rng = np.random.default_rng(21)
    chain = rng.integers(0, vocab, 40)
    waves = [[np.concatenate([chain, [3]])], [
        np.concatenate([chain[:8], rng.integers(0, vocab, 4)]),
        np.concatenate([chain[:24], rng.integers(0, vocab, 5)]),
        np.concatenate([chain[:40], rng.integers(0, vocab, 3)]),
    ]]
    _, ej = _serve(model, "jax", waves, prefix_cache=True, cascade=True)
    _, et = _serve(model, "torch", waves, prefix_cache=True, cascade=True)
    for k in COUNTERS + ("cascade_levels_max", "cascade_grouped_slots"):
        assert getattr(et.stats, k) == getattr(ej.stats, k), k
    assert et.stats.cascade_levels_max >= 2


@pytest.mark.parametrize("fused", [True, False])
def test_cascade_streams_equal_unshared_lean(model, fused):
    """Margin prompts: the cascade Scheduler (K5, or K1 x 2 + merge) emits
    the unshared lean Scheduler's streams, while sharing pages and running
    cascade ticks."""
    waves = _waves(model[1].vocab_size, seed=PROMPT_SEED)
    base, eb = _serve(model, "torch", waves, prefix_cache=False, cascade=False)
    casc, ec = _serve(model, "torch", waves, prefix_cache=True, cascade=True, fused=fused)
    assert casc == base
    assert ec.stats.cascade_ticks > 0
    assert ec.stats.cascade_fused_ticks == (ec.stats.cascade_ticks if fused else 0)
    assert ec.stats.prefix_matched_tokens >= 4 * 24
    assert ec.stats.prefill_tokens < eb.stats.prefill_tokens
    assert ec.pool.stats.pages_shared > 0


def test_cow_on_partial_page_divergence(model):
    """A request that extends a cached sequence into its partial last page
    must copy that page before writing (tests/test_cascade.py's case): same
    streams with the cache on and off, and as many copies as the JAX
    engine makes."""
    vocab = model[1].vocab_size
    rng = np.random.default_rng(7)
    base_prompt = rng.integers(0, vocab, 11)          # one full page + 3 tokens
    first, _ = _serve(model, "torch", [[base_prompt]], prefix_cache=False, cascade=False,
                      backend="ref")
    cont = np.asarray(first[0][:3], dtype=base_prompt.dtype)
    waves = [[base_prompt]] + [[np.concatenate([base_prompt, cont,
                                                rng.integers(0, vocab, 6)])] for _ in range(2)]
    off, _ = _serve(model, "torch", waves, prefix_cache=False, cascade=False, backend="ref")
    on, et = _serve(model, "torch", waves, prefix_cache=True, cascade=False, backend="ref")
    _, ej = _serve(model, "jax", waves, prefix_cache=True, cascade=False, backend="ref")
    assert on == off
    assert et.stats.cow_copies >= 1
    assert (et.stats.cow_copies, et.stats.prefix_matched_tokens) == (
        ej.stats.cow_copies, ej.stats.prefix_matched_tokens)


def test_cascade_configuration_errors(model):
    _, cfg, _, pt = model
    for kw, msg in ((dict(paged=PagedConfig(enabled=True)), "requires prefix_cache"),
                    (dict(paged=PagedConfig(enabled=True, prefix_cache=True),
                          attn_backend="ref"), "lean-kernel path")):
        with pytest.raises(ValueError, match=msg):
            DecodeEngine(cfg, pt, EngineConfig(cascade=CascadeConfig(enabled=True), **kw),
                         device="cpu")
