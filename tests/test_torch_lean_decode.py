"""The port's stream-K decode (the plain versions of K1 and K2 on CPU
tensors) against the JAX kernels run in Pallas interpret mode.

Tolerance: 2e-5 absolute and relative in float32, the reference's own
contract (tests/test_paged_invariants.py:177-180). Both sides compute the
same float32 online softmax; only summation order differs.
"""
import importlib
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

jld = importlib.import_module("repro.kernels.lean_decode")
from repro.kernels import ops as jops  # noqa: E402
from repro.core.leantile import ScheduleCache as JCache  # noqa: E402
from repro.core.leantile import make_schedule as jmake  # noqa: E402
from repro_torch.core.leantile import ScheduleCache, make_cascade_schedule, make_schedule  # noqa: E402
from repro_torch.kernels import build, lean_decode as tld  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.serving.config import EngineConfig, PagedConfig  # noqa: E402
from repro_torch.serving.engine import DecodeEngine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


def _problem(lens, Hq=8, Hkv=2, d=16, tile=8, width=6, seed=0, null_rows=()):
    """Random q and shuffled pages; rows in ``null_rows`` keep an all-null
    page-table row (idle slots)."""
    rng = np.random.default_rng(seed)
    B = len(lens)
    n_pages = [0 if b in null_rows else -(-L // tile) for b, L in enumerate(lens)]
    num_pages = 1 + sum(n_pages) + 2
    perm = rng.permutation(np.arange(1, num_pages))
    tbl = np.zeros((B, width), np.int32)
    k = 0
    for b, n in enumerate(n_pages):
        tbl[b, :n] = perm[k:k + n]
        k += n
    q = rng.standard_normal((B, Hq, d)).astype(np.float32)
    kp = rng.standard_normal((num_pages, Hkv, tile, d)).astype(np.float32)
    vp = rng.standard_normal((num_pages, Hkv, tile, d)).astype(np.float32)
    return q, kp, vp, tbl


def _dense(pool, tbl):
    g = pool[tbl]                               # (B, T, H, ps, d)
    B, T, H, ps, d = g.shape
    return np.ascontiguousarray(np.moveaxis(g, 2, 1).reshape(B, H, T * ps, d))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


CASES = {
    "ragged": dict(lens=[37, 1, 20], workers=4),
    "ctx1": dict(lens=[1, 1], workers=3),
    "idle-null-slot": dict(lens=[30, 1, 12], workers=5, null_rows=(1,)),
    "one-worker": dict(lens=[45, 9], workers=1),
    "many-workers": dict(lens=[48, 17, 3], workers=40),
}


@pytest.mark.parametrize("kind", ["paged", "dense"])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_matches_jax(case, fused, kind):
    c = CASES[case]
    lens, G = c["lens"], c["workers"]
    q, kp, vp, tbl = _problem(lens, null_rows=c.get("null_rows", ()))
    Hkv, tile = kp.shape[1], kp.shape[2]
    seg_ctx = np.repeat(np.asarray(lens, np.int32), Hkv)
    jsched, tsched = jmake(lens, Hkv, tile, G), make_schedule(lens, Hkv, tile, G)
    if kind == "paged":
        kv_j, kv_t = (jnp.asarray(kp), jnp.asarray(vp)), (_t(kp), _t(vp))
        extra_j, extra_t = dict(page_tbl=jnp.asarray(tbl)), dict(page_tbl=_t(tbl))
    else:
        kd, vd = _dense(kp, tbl), _dense(vp, tbl)
        kv_j, kv_t = (jnp.asarray(kd), jnp.asarray(vd)), (_t(kd), _t(vd))
        extra_j = extra_t = {}
    oj, lj = jops.decode(
        jnp.asarray(q), kv_j, ctx=jnp.asarray(seg_ctx), **extra_j,
        plan=jops.DecodePlan(kind=kind, sched=jsched, fused=fused,
                             interpret=True, return_lse=True),
    )
    ot, lt = tops.decode(
        _t(q), kv_t, ctx=_t(seg_ctx), **extra_t,
        plan=tops.DecodePlan(kind=kind, sched=tsched, fused=fused, return_lse=True),
    )
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **TOL)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_kernels_match_pallas_kernels(case):
    """K1's per-piece partials and K2's (o, lse), kernel operand for kernel
    operand, against the Pallas kernels the port replaces."""
    c = CASES[case]
    lens, G = c["lens"], c["workers"]
    q, kp, vp, tbl = _problem(lens, null_rows=c.get("null_rows", ()))
    num_pages, Hkv, tile, d = kp.shape
    gq = q.shape[1] // Hkv
    sched_j, sched_t = jmake(lens, Hkv, tile, G), make_schedule(lens, Hkv, tile, G)
    seg_ctx = np.repeat(np.asarray(lens, np.int32), Hkv)
    q_seg = q.reshape(-1, gq, d)
    rows_k, rows_v = kp.reshape(-1, tile, d), vp.reshape(-1, tile, d)
    route_t = tops.paged_route(sched_t, _t(tbl), Hkv)
    route_j = jops._paged_route(sched_j, jnp.asarray(tbl), Hkv, fused=False)
    np.testing.assert_array_equal(route_t.numpy(), np.asarray(route_j))
    scale = 1.0 / np.sqrt(d)
    jargs = (jnp.asarray(q_seg), jnp.asarray(rows_k), jnp.asarray(rows_v), jnp.asarray(seg_ctx))
    targs = (_t(q_seg), _t(rows_k), _t(rows_v), _t(seg_ctx), route_t, sched_t, scale)
    parts_j = jld.lean_decode_paged_partials(*jargs, route_j, sched_j, scale, interpret=True)
    parts_t = tld.lean_decode_partials(*targs)
    for a, b in zip(parts_t, parts_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    route_jf = jops._paged_route(sched_j, jnp.asarray(tbl), Hkv, fused=True)
    fused_j = jld.lean_decode_paged_fused(*jargs, route_jf, sched_j, scale, interpret=True)
    fused_t = tld.lean_decode_fused(*targs)
    for a, b in zip(fused_t, fused_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_bucketed_schedule_cache_stays_exact():
    """A ScheduleCache schedule walks bucketed (longer) lengths; runtime
    masking keeps the result equal to the reference's."""
    lens = [19, 50, 3]
    q, kp, vp, tbl = _problem(lens, width=8, seed=5)
    ref = jops.lean_decode_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), tbl, lens, num_workers=5,
        schedule_cache=JCache(), interpret=True, return_lse=True,
    )
    cache = ScheduleCache()
    for fused in (True, False):
        out = tops.lean_decode_paged(
            _t(q), _t(kp), _t(vp), tbl, lens, num_workers=5, fused=fused,
            schedule_cache=cache, return_lse=True,
        )
        for a, b in zip(out, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert cache.stats.misses == 1 and cache.stats.hits == 1
    sched = cache.get(lens, kp.shape[1], kp.shape[2], 5, max_len=8 * kp.shape[2])
    assert sched.total_tiles > sum(-(-L // kp.shape[2]) for L in lens) * kp.shape[1]


@pytest.mark.parametrize("fused", [True, False])
def test_dense_and_paged_bit_identical(fused):
    lens = [37, 1, 20]
    q, kp, vp, tbl = _problem(lens, seed=7)
    Hkv, tile = kp.shape[1], kp.shape[2]
    sched = make_schedule(lens, Hkv, tile, 4)
    seg_ctx = _t(np.repeat(np.asarray(lens, np.int32), Hkv))
    paged = tops.lean_decode_paged_from_schedule(
        _t(q), _t(kp), _t(vp), seg_ctx, _t(tbl), sched, fused=fused, return_lse=True)
    dense = tops.lean_decode_from_schedule(
        _t(q), _t(_dense(kp, tbl)), _t(_dense(vp, tbl)), seg_ctx, sched,
        fused=fused, return_lse=True)
    assert all(torch.equal(a, b) for a, b in zip(paged, dense))


def test_dense_convenience_matches_jax():
    lens = [37, 1, 20]
    q, kp, vp, tbl = _problem(lens, seed=8)
    kd, vd = _dense(kp, tbl), _dense(vp, tbl)
    ref = jops.lean_decode(jnp.asarray(q), jnp.asarray(kd), jnp.asarray(vd), lens,
                           num_workers=4, tile=8, interpret=True)
    out = tops.lean_decode(_t(q), _t(kd), _t(vd), lens, num_workers=4, tile=8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("kind", ["cascade"])
def test_unported_plan_kinds_raise(kind):
    """Every plan kind of the reference is ported now, the cascade kind
    last (held against JAX in tests/test_torch_cascade.py): it builds with
    its own schedule, and only a kind the reference lacks is refused."""
    csched, _ = make_cascade_schedule([20, 20], [[0, 1]], [2], 1, 8, 2)
    assert tops.DecodePlan(kind=kind, sched=csched).kind == kind
    with pytest.raises(ValueError, match="unknown plan kind"):
        tops.DecodePlan(kind="dense-" + kind, sched=make_schedule([8], 1, 8, 1))


def test_cuda_entry_points_raise_without_cuda():
    """No silent CPU fallback: asking for the card where there is none is an
    error, and so is building the kernels without nvcc."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = get_smoke_config("mistral-nemo-12b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DecodeEngine(cfg, {}, EngineConfig(paged=PagedConfig(enabled=True)), device="cuda")
    from repro_torch.models import init_params

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg, torch.Generator(), device="cuda")
    if shutil.which("nvcc") is None and not build.Path("/usr/local/cuda/bin/nvcc").exists():
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build._nvcc()


def test_wrapper_rejects_mixed_devices_and_scales():
    lens = [9]
    q, kp, vp, tbl = _problem(lens)
    sched = make_schedule(lens, 2, 8, 2)
    d = q.shape[-1]
    args = (_t(q.reshape(-1, 4, d)), _t(kp.reshape(-1, 8, d)), _t(vp.reshape(-1, 8, d)),
            _t(np.repeat(np.asarray(lens, np.int32), 2)),
            tops.paged_route(sched, _t(tbl), 2), sched, 0.25)
    with pytest.raises(ValueError, match="int8"):
        tld.lean_decode_fused(*args, k_scales=torch.ones(1), v_scales=torch.ones(1))
    with pytest.raises(ValueError, match="segments"):
        tld.lean_decode_partials(args[0][:1], *args[1:])


def test_out_of_range_inputs_are_refused():
    """What the kernels would read out of bounds is refused on the host."""
    lens = [20, 9]
    q, kp, vp, tbl = _problem(lens)
    bad = tbl.copy()
    bad[0, 0] = kp.shape[0]                      # one past the pool
    with pytest.raises(ValueError, match="page ids"):
        tops.lean_decode_paged(_t(q), _t(kp), _t(vp), bad, lens, num_workers=2)
    kd, vd = _dense(kp, tbl)[:, :, :16], _dense(vp, tbl)[:, :, :16]
    sched = make_schedule([24, 9], kp.shape[1], kp.shape[2], 2)   # walks 24 > 16
    with pytest.raises(ValueError, match="cache holds 16"):
        tops.lean_decode_from_schedule(
            _t(q), _t(kd), _t(vd), _t(np.repeat(np.asarray([16, 9], np.int32), 2)), sched)
