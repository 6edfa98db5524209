"""The fused chunk-prefill kernel's CPU side, against the JAX package:

* ``segment_merge`` with its grid from the schedule (``merge_grid``, the
  two-phase merge's path) against the grid it computes on the device: the
  same bits, and the JAX package's ``segment_merge`` within 2e-5; under
  ``torch.profiler`` the two-phase merge records no ``aten::item`` (host
  sync) when the schedule gives the grid;
* ``lean_prefill_fused_plain`` -- the plain version of the fused K4 --
  against the JAX package's K4 partials (Pallas, interpret mode) merged by
  its ``segment_merge``, float and int8 pools, full and ragged packs, 2e-5
  in float32 (the reference's contract, tests/test_paged_invariants.py:
  177-180);
* the int8 algebra of the tensor-core K4 (``csrc/lean_prefill_tc.cu``)
  emulated in numpy: int8 K/V converted to bf16 as they are (exact), the
  scores multiplied by the page's K scale, P by its V scale before the
  split into two bf16 halves, against the reference's widened float32
  (``k * scale`` before the products), within the bound the tensor-core
  K7/K8 are held to (tests/test_torch_prefill_numerics.py): one bf16 step
  of the output (2**-7 of |ref|) plus 2e-5.
"""
import importlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.leantile import make_chunk_schedule as jchunk  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core.leantile import make_chunk_schedule, make_schedule  # noqa: E402
from repro_torch.kernels import lean_decode as tld  # noqa: E402
from repro_torch.kernels import lean_prefill as tlp  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

jm = importlib.import_module("repro.core.merge")
tm = importlib.import_module("repro_torch.core.merge")   # the package exports merge()
jlp = importlib.import_module("repro.kernels.lean_prefill")

TOL = dict(rtol=2e-5, atol=2e-5)
BF16_STEP = 2.0 ** -7


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _partials(rng, P, rows=3, d=8, empty=(), masked=()):
    """Random partials; ``empty`` pieces are identities (m = -inf), and
    ``masked`` ones what a kernel flushes for rows that saw no key (m =
    -1e30, l = 0)."""
    o = rng.standard_normal((P, rows, d)).astype(np.float32)
    m = rng.standard_normal((P, rows)).astype(np.float32)
    l = (rng.random((P, rows)) + 0.1).astype(np.float32)
    for i in empty:
        o[i], m[i], l[i] = 0.0, -np.inf, 0.0
    for i in masked:
        o[i], m[i], l[i] = 0.0, -1e30, 0.0
    return o, m, l


# ---------------------------------------------------- the schedule's grid
SCHEDULES = {
    # name: (lens, Hkv, tile, workers, chunk schedule)
    "decode-ragged": ([300, 1, 77, 129], 2, 16, 24, False),
    "decode-one-worker": ([40, 9], 2, 8, 1, False),
    "chunk-pack": ([2304, 293], 8, 128, 132, True),
    "chunk-many-workers": ([20, 7, 33], 2, 8, 64, True),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_grid_is_the_device_grid(name):
    """The schedule's host grid gives ``segment_merge`` the bits of its
    device grid, and the JAX merge's values within 2e-5."""
    lens, Hkv, tile, workers, chunk = SCHEDULES[name]
    make = make_chunk_schedule if chunk else make_schedule
    sched = make(lens, Hkv, tile, workers)
    P, S = sched.num_pieces, sched.num_segments
    rng = np.random.default_rng(len(name))
    p = _partials(rng, P, empty=(0,) if P > 2 else (), masked=(P - 1,) if P > 3 else ())
    st = tld.schedule_tensors(sched, torch.device("cpu"))
    ids = st["piece_seg"]
    device_grid = tm.segment_merge(tm.AttnPartial(*map(_t, p)), ids, S)
    host_grid = tm.segment_merge(tm.AttnPartial(*map(_t, p)), ids, S, grid=st["merge_grid"])
    assert all(torch.equal(a, b) for a, b in zip(host_grid, device_grid))
    ref = jm.segment_merge(jm.AttnPartial(*map(jnp.asarray, p)), jnp.asarray(sched.piece_seg), S)
    for a, b in zip(host_grid, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("ids", [[3, 0, 3, 1, 0, 2], [0, 0, 2, 2, 2, 5, 4], [-1, 1, 1]])
def test_host_grid_of_any_ids(ids):
    """``merge_grid`` of unsorted ids, empty segments and padding ids (out
    of range: dropped) is the device path's grid, bit for bit."""
    S = 5
    rng = np.random.default_rng(7)
    p = tm.AttnPartial(*map(_t, _partials(rng, len(ids), empty=(1,))))
    ids_np = np.asarray(ids, np.int32)
    grid = tm.merge_grid(ids_np, S, torch.device("cpu"))
    a = tm.segment_merge(p, _t(ids_np), S, grid=grid)
    b = tm.segment_merge(p, _t(ids_np), S)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _item_calls(fn) -> int:
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    return sum(1 for e in prof.events() if e.name == "aten::item")


def test_two_phase_merge_makes_no_host_sync():
    """``ops._merge_two_phase`` (the ``fused=False`` paths' merge) takes the
    grid from the schedule: no ``aten::item`` under the profiler, where
    ``segment_merge``'s own grid makes one."""
    sched = make_chunk_schedule([300, 37], 2, 16, 24)
    rng = np.random.default_rng(3)
    o, m, l = map(_t, _partials(rng, sched.num_pieces, rows=6))
    st = tld.schedule_tensors(sched, torch.device("cpu"))
    assert _item_calls(lambda: tops._merge_two_phase(o, m, l, sched, "xla", True)) == 0
    assert _item_calls(lambda: tm.segment_merge(tm.AttnPartial(o, m, l), st["piece_seg"],
                                                sched.num_segments)) > 0


# ------------------------------------------------------- fused K4, plain
def _pack(rng, Hq, Hkv, d, ps, offs, lens, int8):
    """A pack of chunks (lens[n] <= C = max(lens): a ragged pack when they
    differ) on shuffled disjoint pages, and its K4 operands."""
    N, C = len(offs), max(lens)
    n_pages = [-(-(o + n) // ps) for o, n in zip(offs, lens)]
    W = max(n_pages) + 1
    num_pages = 1 + sum(n_pages)
    perm = rng.permutation(np.arange(1, num_pages))
    tbls = np.zeros((N, W), np.int32)
    k = 0
    for n, npg in enumerate(n_pages):
        tbls[n, :npg] = perm[k:k + npg]
        k += npg
    kp = rng.standard_normal((num_pages, Hkv, ps, d)).astype(np.float32)
    vp = rng.standard_normal((num_pages, Hkv, ps, d)).astype(np.float32)
    scales = {}
    if int8:
        for name, pool in (("k", kp), ("v", vp)):
            s = np.abs(pool).max(axis=(2, 3)) / 127.0
            s[1] = 0.0                                  # a zero-scale page reads zeros
            q8 = np.clip(np.round(pool / np.where(s > 0, s, 1)[..., None, None]), -127, 127)
            scales[name] = s.astype(np.float32).reshape(-1)
            if name == "k":
                kp = q8.astype(np.int8)
            else:
                vp = q8.astype(np.int8)
    q = rng.standard_normal((N, Hq, C, d)).astype(np.float32)
    visible = [int(o + n) for o, n in zip(offs, lens)]
    g = Hq // Hkv
    return dict(
        q_seg=q.reshape(N, Hkv, g, C, d).reshape(N * Hkv, g * C, d),
        rows_k=kp.reshape(-1, ps, d), rows_v=vp.reshape(-1, ps, d), tbls=tbls, W=W,
        seg_ctx=np.repeat(np.asarray(visible, np.int32), Hkv),
        seg_qs=np.repeat(np.asarray(offs, np.int32), Hkv), visible=visible, C=C, **scales)


PACKS = {
    # (Hq, Hkv, d, page, offs, lens, workers)
    "full": (4, 2, 16, 8, [9, 0, 33], [5, 5, 5], 7),
    "ragged": (8, 2, 32, 16, [40, 3], [12, 7], 24),
    "one-token-chunk": (4, 1, 16, 8, [17, 0], [1, 6], 5),
}


@pytest.mark.parametrize("pool", ["float", "int8"])
@pytest.mark.parametrize("pack", sorted(PACKS))
def test_fused_plain_matches_pallas_and_merge(pack, pool):
    """The fused K4's plain version against the JAX K4 partials (interpret
    mode) merged by JAX's ``segment_merge``, every row of the pack (rows
    past a short chunk's length included: they see the chunk's keys); the
    wrapper runs it on CPU tensors and launches nothing."""
    Hq, Hkv, d, ps, offs, lens, workers = PACKS[pack]
    c = _pack(np.random.default_rng(len(pack)), Hq, Hkv, d, ps, offs, lens, pool == "int8")
    sj = jchunk(c["visible"], Hkv, ps, workers, max_len=c["W"] * ps)
    st = make_chunk_schedule(c["visible"], Hkv, ps, workers, max_len=c["W"] * ps)
    route_j = jops._paged_route(sj, jnp.asarray(c["tbls"]), Hkv, fused=False)
    route_t = tops.paged_route(st, _t(c["tbls"]), Hkv)
    scale = 1.0 / math.sqrt(d)
    sc_j, sc_t = {}, {}
    if pool == "int8":
        sc_j = dict(k_scales=jnp.asarray(c["k"][:, None]), v_scales=jnp.asarray(c["v"][:, None]))
        sc_t = dict(k_scales=_t(c["k"]), v_scales=_t(c["v"]))
    parts = jlp.lean_prefill_chunk_partials(
        jnp.asarray(c["q_seg"]), jnp.asarray(c["rows_k"]), jnp.asarray(c["rows_v"]),
        jnp.asarray(c["seg_ctx"]), jnp.asarray(c["seg_qs"]), route_j, sj, scale,
        chunk_cap=c["C"], interpret=True, **sc_j)
    want = jm.finalize(jm.segment_merge(jm.AttnPartial(*parts), jnp.asarray(sj.piece_seg),
                                        sj.num_segments))
    args = (_t(c["q_seg"]), _t(c["rows_k"]), _t(c["rows_v"]), _t(c["seg_ctx"]),
            _t(c["seg_qs"]), route_t, st, scale, c["C"])
    tlp.reset_launch_counts()
    got = tlp.lean_prefill_fused(*args, **sc_t)
    assert (tlp.fused_launches, tlp.fused_tc_launches, tlp.launches) == (0, 0, 0)
    assert torch.equal(got, tlp.lean_prefill_fused_plain(*args, **sc_t))
    assert got.dtype == torch.float32 and got.shape == c["q_seg"].shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if pool == "int8":   # rows of the zero-scale page's keys weigh in with zero values
        assert np.isfinite(got.numpy()).all()


# ------------------------------------------------ the int8 algebra, emulated
def _bf16(x):
    """float32 -> the nearest bf16 (ties to even), as float32."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    r = ((u >> 16) & 1) + np.uint32(0x7FFF)
    return ((u + r) & np.uint32(0xFFFF0000)).view(np.float32)


def _emulate_int8(q, k8, v8, ks, vs, visible, scale, page, tile=128):
    """The tensor-core K4's arithmetic on int8 pages: ``q (R, d)`` bf16
    values, ``k8/v8 (K, d)`` int8, one scale per page of ``page`` keys,
    ``visible (R, K)``. Key tiles of at most 128 keys, each within one page,
    in order; returns the bf16 output ``(R, d)``."""
    R, K = visible.shape
    acc = np.zeros((R, q.shape[1]), np.float32)
    m = np.full(R, -1e30, np.float32)
    l = np.zeros(R, np.float32)
    sl = np.float32(scale * 1.4426950408889634)
    for k0 in range(0, K, min(page, tile)):
        k1 = min(k0 + min(page, tile), K)
        pg = k0 // page
        kt = k8[k0:k1].astype(np.float32)            # int8 in bf16: exact
        vt = v8[k0:k1].astype(np.float32)
        s = (q @ kt.T).astype(np.float32) * ks[pg]    # the page's K scale
        s = np.where(visible[:, k0:k1], s, -np.inf).astype(np.float32)
        m_new = np.maximum(m, s.max(axis=1) * sl)
        alpha = np.exp2(m - m_new).astype(np.float32)
        p = np.exp2(s * sl - m_new[:, None]).astype(np.float32)
        l = alpha * l + p.sum(axis=1, dtype=np.float32)
        pv = (p * vs[pg]).astype(np.float32)           # the page's V scale, before the split
        hi = _bf16(pv)
        lo = _bf16(pv - hi)
        acc = alpha[:, None] * acc + (hi @ vt).astype(np.float32) + (lo @ vt).astype(np.float32)
        m = m_new
    return _bf16(acc / np.maximum(l, 1e-30)[:, None])


INT8_CASES = [
    # (rows C, keys before the chunk, d, page)
    (64, 200, 64, 128),
    (96, 300, 128, 16),
    (40, 500, 128, 256),     # a page of two 128-key sub-tiles
]


@pytest.mark.parametrize("case", INT8_CASES)
def test_int8_algebra_within_one_bf16_step(case):
    """Scales applied to S and to P (int8 converted to bf16 as it is, P in
    two bf16 halves) against the reference's widened float32 (``k * scale``
    and ``v * scale`` before the products, an exact softmax): within one
    bf16 step of the output plus 2e-5, the tensor-core K7/K8 bound."""
    C, off, d, page = case
    rng = np.random.default_rng(C + off)
    K = off + C
    n_pages = -(-K // page)
    q = _bf16(rng.standard_normal((C, d)).astype(np.float32))
    kf = rng.standard_normal((n_pages * page, d)).astype(np.float32) * 2.0
    vf = rng.standard_normal((n_pages * page, d)).astype(np.float32)
    ks = (np.abs(kf).reshape(n_pages, page, d).max(axis=(1, 2)) / 127).astype(np.float32)
    vs = (np.abs(vf).reshape(n_pages, page, d).max(axis=(1, 2)) / 127).astype(np.float32)
    ks[0] = vs[0] = 0.0                                 # a fresh page: scale 0 reads zeros
    rep = lambda s: np.repeat(np.where(s > 0, s, 1), page)[:, None]
    k8 = np.clip(np.round(kf / rep(ks)), -127, 127).astype(np.int8)
    v8 = np.clip(np.round(vf / rep(vs)), -127, 127).astype(np.int8)
    visible = np.arange(n_pages * page)[None, :] <= off + np.arange(C)[:, None]
    scale = 1.0 / math.sqrt(d)
    got = _emulate_int8(q, k8, v8, ks, vs, visible, scale, page)
    # the reference: widen, scale, then float32 attention
    kw = k8.astype(np.float32) * np.repeat(ks, page)[:, None]
    vw = v8.astype(np.float32) * np.repeat(vs, page)[:, None]
    s = np.where(visible, (q @ kw.T) * np.float32(scale), -np.inf).astype(np.float32)
    p = np.exp(s - s.max(axis=1, keepdims=True)).astype(np.float32)
    ref = _bf16((p @ vw) / p.sum(axis=1, keepdims=True))
    diff = np.abs(got - ref)
    assert (diff <= BF16_STEP * np.abs(ref) + 2e-5).all(), diff.max()
