"""The CUDA kernels K1-K8 against their plain PyTorch versions, on the
card. Marked ``cuda``: they skip where there is no CUDA
card and run on the card with

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

They cover what ``chip_smoke.py`` does not: every row bucket the decode
kernels are instantiated for, float32 and bf16, other tile, head and chunk
sizes, grids of more workers than SMs, K5's determinism, K7 on the
reference's prefill cases and the dense-cache engine against the paged one,
the tensor-core K7/K8 (bf16 at d 64 and 128): their edges, keys past a
chunk holding NaN, their launch counters and refusals; the pages the
engine can pick that the kernels once refused (12 and 100 rows, and 256
at d 128, on K8, K4 and K6); and the int8 forms of K1, K2, K4 and K5 (bf16
queries, int8 rows, a float32 scale per row, a zero-scale page reading
exact zeros) and the int8 engine on the card against the CPU; the f8 forms of K1,
K2, K4 (fused and partials), K5, K6 and K8 (bf16 queries, e4m3 rows)
against their bf16 forms on the widened rows, bit for bit, and their plain
versions, a NaN element in an f8 page, the f8 cast on the card against the
CPU's, and the f8 engine on the card against the CPU; the fused
K4 (stream-K pieces merged in the launch, bf16 and int8 pages on the
tensor cores, float32 and other pages on the CUDA cores) against its plain
version, launch against launch, and against the two-phase path; K1 and K2
on the decode ring at every row bucket, page and dtype, with its counters;
and every kernel at the geometries of the attention-family architectures
(gq 1, 6 and 8, head dims 64, 128 and 256, K7's window of 1024 at d 256
and its non-causal cross attention), and K7 at recurrentgemma-9b's gq 16
over one KV head at d 256 with windows; and the recurrent smoke models'
captured admission and decode steps against eager ones. Tolerance 2e-5: kernel and plain version both compute in float32 from the
same inputs (K7's and K8's bf16 output: one bf16 step plus 2e-5, since both
round a float32 result; the tensor-core kernel keeps P to about 16 bits by
putting it through PV as two bf16 halves, which holds it to that bound --
tests/test_torch_prefill_numerics.py).
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.leantile import fixed_split_factor, make_chunk_schedule, make_schedule  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import flash_prefill as fp  # noqa: E402
from repro_torch.kernels import lean_decode as ld  # noqa: E402
from repro_torch.kernels import lean_prefill as lp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(dev, lens, gq, Hkv, d, tile, workers, dtype, seed=0):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    width = max(-(-L // tile) for L in lens) + 1
    n_pages = [-(-L // tile) for L in lens]
    num_pages = 1 + sum(n_pages) + 2
    perm = (torch.randperm(num_pages - 1, generator=gen, device=dev) + 1).cpu()
    tbl = torch.zeros(len(lens), width, dtype=torch.int32)
    k = 0
    for b, n in enumerate(n_pages):
        tbl[b, :n] = perm[k:k + n]
        k += n
    kp = torch.randn(num_pages, Hkv, tile, d, generator=gen, device=dev).to(dtype)
    vp = torch.randn(num_pages, Hkv, tile, d, generator=gen, device=dev).to(dtype)
    q = torch.randn(len(lens) * Hkv, gq, d, generator=gen, device=dev).to(dtype)
    sched = make_schedule(lens, Hkv, tile, workers)
    seg_ctx = torch.tensor([L for L in lens for _ in range(Hkv)], dtype=torch.int32, device=dev)
    k_rows, v_rows = ops._pool_rows(kp, vp)
    route = ops.paged_route(sched, tbl.to(dev), Hkv)
    return (q, k_rows, v_rows, seg_ctx, route, sched, 1.0 / math.sqrt(d))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gq", ld.KERNEL_GQ)
def test_kernels_match_plain_every_gq(cuda, gq, dtype):
    args = _operands(cuda, [300, 1, 77, 129], gq, 2, 64, 16, 24, getattr(torch, dtype))
    before = (ld.partials_launches, ld.fused_launches)
    o, lse = ld.lean_decode_fused(*args)
    parts = ld.lean_decode_partials(*args)
    torch.cuda.synchronize()
    assert (ld.partials_launches, ld.fused_launches) == (before[0] + 1, before[1] + 1)
    o_ref, lse_ref = ld.lean_decode_fused_plain(*args)
    torch.testing.assert_close(o, o_ref, **TOL)
    torch.testing.assert_close(lse, lse_ref, **TOL)
    for a, b in zip(parts, ld.lean_decode_partials_plain(*args)):
        torch.testing.assert_close(a, b, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("workers", [1, 7, 132, 1000])
@pytest.mark.parametrize("tile,d", [(128, 128), (64, 256), (8, 32)])
def test_fused_kernel_any_grid(cuda, workers, tile, d):
    """More workers than SMs, one worker, and odd shapes: the last-arriver
    fix-up never waits, so every grid completes and merges exactly."""
    args = _operands(cuda, [2000, 513, 1], 4, 4, d, tile, workers, torch.bfloat16, seed=1)
    o, lse = ld.lean_decode_fused(*args)
    o_ref, lse_ref = ld.lean_decode_fused_plain(*args)
    torch.testing.assert_close(o, o_ref, **TOL)
    torch.testing.assert_close(lse, lse_ref, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("gq", [1, 3, 12, 16, 40, 64])
def test_decode_kernels_take_stacked_rows(cuda, gq):
    """Row counts between the buckets (zero rows padded in the CTA) and the
    cascade's stacked member rows: K1 and K2 against their plain versions."""
    args = _operands(cuda, [300, 1, 77], gq, 2, 64, 16, 24, torch.bfloat16, seed=gq)
    o, lse = ld.lean_decode_fused(*args)
    parts = ld.lean_decode_partials(*args)
    o_ref, lse_ref = ld.lean_decode_fused_plain(*args)
    torch.testing.assert_close(o, o_ref, **TOL)
    torch.testing.assert_close(lse, lse_ref, **TOL)
    for a, b in zip(parts, ld.lean_decode_partials_plain(*args)):
        torch.testing.assert_close(a, b, **TOL)


# K1 and K2 on the decode ring, and on the walk over device memory where the
# rule gives no slots: every row bucket, pages that are not a multiple of 8
# (12, 100), the main path's 128 and 256, d 64 and 128, float32, bf16 and
# int8 rows (bf16 queries)
RING_PAGES = [12, 100, 128, 256]


def _k12_operands(dev, rows, d, page, kind, seed=0):
    dt = torch.float32 if kind == "float32" else torch.bfloat16
    args = list(_operands(dev, [300, 1, 2 * page + 5, 129], rows, 2, d, page, 24, dt, seed=seed))
    sc = {}
    if kind == "int8":
        kq, ks, vq, vs = _quantized(args[1], args[2])
        args[1], args[2] = kq, vq
        sc = dict(k_scales=ks, v_scales=vs)
    return args, sc


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("page", RING_PAGES)
@pytest.mark.parametrize("rows", [2, 4, 8, 16, 32, 64])
def test_k1_k2_on_the_ring_match_plain(cuda, rows, page, d, kind):
    """K1 and K2 against their plain versions; the ring counters follow
    ``ld.ring_slots`` (the walk over device memory only for float32 pages
    of 256 at d 128, and bf16 ones beside the 64-row bucket)."""
    args, sc = _k12_operands(cuda, rows, d, page, kind, seed=rows + page)
    ring = ld.ring_slots(args[1].dtype, rows, d, page) > 0
    assert ring == (not (d == 128 and page == 256 and
                         (kind == "float32" or (kind == "bfloat16" and rows == 64))))
    before = (ld.partials_launches, ld.fused_launches, ld.partials_ring_launches,
              ld.fused_ring_launches)
    o, lse = ld.lean_decode_fused(*args, **sc)
    parts = ld.lean_decode_partials(*args, **sc)
    torch.cuda.synchronize()
    assert (ld.partials_launches, ld.fused_launches, ld.partials_ring_launches,
            ld.fused_ring_launches) == (before[0] + 1, before[1] + 1, before[2] + ring,
                                        before[3] + ring)
    o_ref, lse_ref = ld.lean_decode_fused_plain(*args, **sc)
    torch.testing.assert_close(o, o_ref, **TOL)
    torch.testing.assert_close(lse, lse_ref, **TOL)
    for a, b in zip(parts, ld.lean_decode_partials_plain(*args, **sc)):
        torch.testing.assert_close(a, b, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("page", [128, 12, 256])
def test_k1_k2_same_bits_twice(cuda, page, kind):
    """K2's last arriver folds each segment's pieces in piece order, so two
    launches (and two of K1) give the same bits."""
    args, sc = _k12_operands(cuda, 4, 128, page, kind, seed=11)
    a, b = ld.lean_decode_fused(*args, **sc), ld.lean_decode_fused(*args, **sc)
    p, q = ld.lean_decode_partials(*args, **sc), ld.lean_decode_partials(*args, **sc)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a + p, b + q))


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [1, 9])
def test_k1_k2_refuse_a_ring_that_does_not_fit(cuda, monkeypatch, slots):
    """A slot count the ring kernel does not take (one slot, more than
    eight) is refused and the wrapper raises; nothing falls back."""
    args, _ = _k12_operands(cuda, 4, 128, 128, "bfloat16")
    monkeypatch.setattr(ld, "ring_slots", lambda *a: slots)
    with pytest.raises(RuntimeError, match="cudaError_t"):
        ld.lean_decode_fused(*args)
    with pytest.raises(RuntimeError, match="cudaError_t"):
        ld.lean_decode_partials(*args)


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_cannot_take(cuda):
    args = _operands(cuda, [40], ld.MAX_ROWS + 1, 1, 32, 16, 4, torch.float32)
    with pytest.raises(ValueError, match="query rows"):
        ld.lean_decode_fused(*args)
    args = _operands(cuda, [40], 4, 1, 32, 16, 4, torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ld.lean_decode_fused(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False])
def test_engine_on_card_matches_cpu(cuda, fused):
    """The smoke-config engine on the card (CUDA kernels, cuBLAS) against the
    same engine on the CPU (plain versions): first decode tick's logits
    within bf16 noise (2**-5 on unit-scale logits: the GEMMs round in
    another order), every request served, pool clean, and every decode
    step ran one kernel launch per layer."""
    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.serving.config import EngineConfig, PagedConfig
    from repro_torch.serving.engine import DecodeEngine, Request

    cfg = get_smoke_config("mistral-nemo-12b")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    logits = {}
    for dev in ("cpu", "cuda"):
        p = {k: v.to(dev) if torch.is_tensor(v) else v for k, v in params.items()}
        p["layers"] = [{k: ({kk: vv.to(dev) for kk, vv in v.items()} if isinstance(v, dict)
                            else v.to(dev)) for k, v in layer.items()}
                       for layer in params["layers"]]
        eng = DecodeEngine(cfg, p, EngineConfig(
            max_batch=2, cache_len=32, num_workers=4, attn_backend="lean", fused=fused,
            paged=PagedConfig(enabled=True, page_size=8)), device=dev)
        rng = np.random.default_rng(0)
        reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, 8 + 7 * i),
                        max_new_tokens=4) for i in range(3)]
        for r in reqs:
            eng.submit(r)
        ld.reset_launch_counts()
        eng.tick()
        logits[dev] = eng.last_logits.float().cpu()
        eng.run_to_completion(max_ticks=40)
        assert all(r.done for r in reqs)
        eng.pool.check()
        assert eng.pool.num_allocated == 0
        launches = ld.fused_launches if fused else ld.partials_launches
        assert launches == (cfg.n_layers * eng.stats.ticks if dev == "cuda" else 0)
    torch.testing.assert_close(logits["cuda"], logits["cpu"], rtol=2**-5, atol=2**-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-350m"])
def test_recurrent_steps_captured_equal_eager(cuda, arch):
    """The recurrent smoke models on the card, an engine whose steps run
    eagerly against one that captures them, served the same rounds: every
    prompt length comes twice, so admissions (the exact-length prefill:
    the RG-LRU scan, the chunked mLSTM with its masks built on the card, the
    sLSTM's steps) and decode steps replay their graphs; the logits of
    every tick and the streams are bit for bit the eager engine's."""
    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.serving.config import EngineConfig, PagedConfig
    from repro_torch.serving.engine import DecodeEngine, Request

    cfg = get_smoke_config(arch)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    params = init_params(cfg, gen, device=cuda)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (13, 13, 21, 21)]
    runs = {}
    for captured in (False, True):
        eng = DecodeEngine(cfg, params, EngineConfig(
            max_batch=2, cache_len=48, num_workers=4, attn_backend="lean",
            paged=PagedConfig(enabled=True, page_size=8)), device=cuda)
        eng.capture_decode = captured
        reqs = [Request(uid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
        rows = []
        for pair in (reqs[:2], reqs[2:]):
            for r in pair:
                eng.submit(r)
            while eng.queue or any(eng.slot_req):
                eng.tick()
                rows.append(eng.last_logits.clone())
        runs[captured] = (rows, [r.generated for r in reqs], eng.stats)
    (eager, s_eager, _), (graph, s_graph, st) = runs[False], runs[True]
    assert st.admit_replays > 0 and st.decode_replays > 0
    assert s_graph == s_eager and len(graph) == len(eager)
    assert all(torch.equal(a, b) for a, b in zip(graph, eager))


@pytest.mark.cuda
def test_exact_admission_graphs_bounded(cuda):
    """An engine that admits at the exact prompt length captures one
    admission per distinct length; it holds at most ``EXACT_ADMIT_GRAPHS``
    of them, dropping the least recently used: six lengths admitted in
    three rounds are captured in the second, the first two are dropped and
    warm up again in the third, the last four replay, and every admission's
    logits equal the eager engine's bit for bit."""
    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.serving.config import EngineConfig, PagedConfig
    from repro_torch.serving.engine import EXACT_ADMIT_GRAPHS, DecodeEngine, Request

    cfg = get_smoke_config("xlstm-350m")
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    params = init_params(cfg, gen, device=cuda)
    rng = np.random.default_rng(2)
    lens = range(5, 5 + EXACT_ADMIT_GRAPHS + 2)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    class Logged(DecodeEngine):
        def _run_prompt_prefill(self, prompt, slot, pages):
            out = super()._run_prompt_prefill(prompt, slot, pages)
            logits.setdefault(self.capture_decode, []).append(out.clone())
            return out

    logits = {}
    for captured in (False, True):
        eng = Logged(cfg, params, EngineConfig(
            max_batch=2, cache_len=48, num_workers=4, attn_backend="lean",
            paged=PagedConfig(enabled=True, page_size=8)), device=cuda)
        eng.capture_decode = captured
        for _ in range(3):
            for i, p in enumerate(prompts):
                assert eng.admit_blocking(Request(uid=i, prompt=p, max_new_tokens=1), 0)
                eng.release_slot(0)
    held = [k for k, (_, g) in eng._graphs.items() if g is not None and k[0][1] == "admit"]
    assert len(held) == EXACT_ADMIT_GRAPHS
    assert eng.stats.admit_captures == len(prompts)
    assert eng.stats.admit_replays == len(prompts) + EXACT_ADMIT_GRAPHS
    assert len(logits[True]) == len(logits[False]) == 3 * len(prompts)
    assert all(torch.equal(a, b) for a, b in zip(logits[True], logits[False]))


def _chunk_operands(dev, offs, lens, Hq, Hkv, d, tile, dtype, seed=0):
    """A pack of chunks (``lens = 0``: a pad row) on shuffled pages."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    N = len(offs)
    n_pages = [-(-(o + n) // tile) for o, n in zip(offs, lens)]
    width = max(max(n_pages), 1) + 1
    num_pages = 1 + sum(n_pages) + 2
    perm = (torch.randperm(num_pages - 1, generator=gen, device=dev) + 1).cpu()
    tbl = torch.zeros(N, width, dtype=torch.int32)
    k = 0
    for n, npg in enumerate(n_pages):
        tbl[n, :npg] = perm[k:k + npg]
        k += npg
    kp = torch.randn(num_pages, Hkv, tile, d, generator=gen, device=dev).to(dtype)
    vp = torch.randn(num_pages, Hkv, tile, d, generator=gen, device=dev).to(dtype)
    q = torch.randn(N, Hq, max(lens), d, generator=gen, device=dev).to(dtype)
    return q, kp, vp, tbl.to(dev)


CHUNK_CASES = {
    # (Hq, Hkv, d, tile, offs, lens, workers)
    "gqa-c5": (4, 2, 64, 16, [0, 9, 33, 0], [5, 3, 5, 0], 7),
    "nemo-c100": (32, 8, 128, 128, [300, 0], [100, 37], 132),
    "mqa-c64-many-workers": (8, 1, 128, 64, [130, 5], [64, 64], 500),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_chunk_kernels_match_plain(cuda, case, dtype):
    """K4's partials and K8's output against their plain versions; row
    blocks that span two heads (C not a multiple of 64) included."""
    Hq, Hkv, d, tile, offs, lens, workers = CHUNK_CASES[case]
    dt = getattr(torch, dtype)
    q, kp, vp, tbl = _chunk_operands(cuda, offs, lens, Hq, Hkv, d, tile, dt)
    N, _, C, _ = q.shape
    visible = [max(1, o + n) for o, n in zip(offs, lens)]
    sched = make_chunk_schedule(visible, Hkv, tile, workers, max_len=tbl.shape[1] * tile)
    seg_ctx = torch.tensor([v for v in visible for _ in range(Hkv)], dtype=torch.int32,
                           device=cuda)
    seg_qs = torch.tensor([o for o in offs for _ in range(Hkv)], dtype=torch.int32, device=cuda)
    k_rows, v_rows = ops._pool_rows(kp, vp)
    args = (q.reshape(N * Hkv, (Hq // Hkv) * C, d).contiguous(), k_rows, v_rows, seg_ctx,
            seg_qs, ops.paged_route(sched, tbl, Hkv), sched, 1.0 / math.sqrt(d), C)
    before = (lp.launches, fp.launches)
    parts = lp.lean_prefill_chunk_partials(*args)
    q_off = torch.tensor(offs, dtype=torch.int32, device=cuda)
    o8 = fp.flash_prefill_paged(q, kp, vp, tbl, q_off)
    torch.cuda.synchronize()
    assert (lp.launches, fp.launches) == (before[0] + 1, before[1] + 1)
    for a, b in zip(parts, lp.lean_prefill_partials_plain(*args)):
        torch.testing.assert_close(a, b, **TOL)
    ref = fp.flash_prefill_paged_plain(q, kp, vp, tbl, q_off, 1.0 / math.sqrt(d))
    for n, L in enumerate(lens):
        if dtype == "float32":
            torch.testing.assert_close(o8[n, :, :L], ref[n, :, :L], **TOL)
        else:
            # one bf16 step (both round a float32 result), plus the float32
            # tolerance where the output nears zero and its sum cancels
            diff = (o8[n, :, :L].float() - ref[n, :, :L].float()).abs()
            assert bool((diff <= 2.0 ** -7 * ref[n, :, :L].float().abs() + TOL["atol"]).all())


# K6's walks: (lens, splits) from the tile. A segment of length 0 gives
# splits with no visible key (m = -1e30, l = 0) and one of length 1 a
# single visible key; 9 splits of a 40-token batch give tps 1; 7 tiles in 3
# splits give a last split of 1 tile against tps 3.
K6_WALKS = {
    "fixed-factor": lambda tile: ([300, 1, 77, 0], None),
    "one-split": lambda tile: ([2000, 513, 1], 1),
    "tps-1": lambda tile: ([40, 9], 9),
    "short-last-split": lambda tile: ([7 * tile - 5, tile + 1, 1, 0], 3),
}
# (tile, d): the kernel phase's 128 x 128, the pages the engine can pick
# that are not a multiple of 8 (12, 100), a page of 256 (bf16 on the ring,
# float32 on the walk over device memory), and small tiles at d 64
K6_TILES = [(16, 64), (128, 128), (12, 128), (100, 64), (256, 128)]


def _k6_args(dev, walk, gq, dtype, tile, d, seed=3):
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    lens, splits = K6_WALKS[walk](tile)
    Hkv = 2
    S = Hkv * len(lens)
    s_pad = -(-max(lens) // tile) * tile
    splits = splits or fixed_split_factor(max(lens), S, tile, 132)
    q = torch.randn(S, gq, d, generator=gen, device=dev).to(dt)
    k = torch.randn(S, s_pad, d, generator=gen, device=dev).to(dt)
    v = torch.randn(S, s_pad, d, generator=gen, device=dev).to(dt)
    seg = torch.tensor([L for L in lens for _ in range(Hkv)], dtype=torch.int32, device=dev)
    return (q, k, v, seg, splits, tile, 1.0 / math.sqrt(d))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gq", ld.KERNEL_GQ)
@pytest.mark.parametrize("tile,d", K6_TILES)
@pytest.mark.parametrize("walk", sorted(K6_WALKS))
def test_fixed_split_kernel_matches_plain(cuda, gq, dtype, tile, d, walk):
    """K6 against its plain version on every walk and tile, on the ring
    where the path rule puts it (counted) and on the walk over device
    memory elsewhere."""
    args = _k6_args(cuda, walk, gq, dtype, tile, d)
    if walk == "short-last-split":
        n_tiles = args[1].shape[1] // tile
        tps = fd.split_geometry(args[1].shape[1], 3, tile)
        assert n_tiles - 2 * tps < tps
    ring = fd.ring_slots(getattr(torch, dtype), gq, d, tile) > 0
    assert ring == (dtype == "bfloat16" or tile <= 128)
    before, before_ring = fd.launches, fd.ring_launches
    out = fd.flash_decode_partials(*args)
    torch.cuda.synchronize()
    assert fd.launches == before + 1
    assert fd.ring_launches == before_ring + ring
    for a, b in zip(out, fd.flash_decode_partials_plain(*args)):
        torch.testing.assert_close(a, b, **TOL)
    seg_lens = args[3]
    if int(seg_lens.min()) == 0:   # a segment with no key: every split m = -1e30, l = 0
        empty = seg_lens == 0
        assert bool((out[1][empty] == -1e30).all()) and bool((out[2][empty] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tile,d", [(128, 128), (12, 128), (256, 128)])
def test_fixed_split_kernel_same_bits_twice(cuda, dtype, tile, d):
    args = _k6_args(cuda, "fixed-factor", 4, dtype, tile, d)
    a, b = fd.flash_decode_partials(*args), fd.flash_decode_partials(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["lean", "fixed"])
def test_scheduler_on_card_runs_the_kernels(cuda, backend):
    """The smoke-config scheduler on the card: every request served, pool
    clean, the chunk kernel (fused K4 or K8) launched once per layer and
    chunk step and the decode kernel (K2 or K6) once per layer and decode
    tick."""
    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.serving.config import EngineConfig, PagedConfig
    from repro_torch.serving.engine import DecodeEngine
    from repro_torch.serving.scheduler import Scheduler, SchedulerConfig

    cfg = get_smoke_config("mistral-nemo-12b")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    eng = DecodeEngine(cfg, params, EngineConfig(
        max_batch=2, cache_len=64, num_workers=8, attn_backend=backend,
        paged=PagedConfig(enabled=True, page_size=16)), device="cuda")
    sch = Scheduler(eng, SchedulerConfig(chunk_size=8, prefill_pack=2, token_budget=16))
    rng = np.random.default_rng(0)
    hs = [sch.submit(rng.integers(0, cfg.vocab_size, 8 + 7 * i), 6, uid=i) for i in range(4)]
    for m in (ld, lp, fd, fp):
        m.reset_launch_counts()
    sch.run_to_completion(max_steps=400)
    assert all(h.done and len(h.generated) == 6 for h in hs)
    eng.pool.check()
    assert eng.pool.num_allocated == 0
    chunk_steps, ticks = len(eng.stats.tick_prefill_tokens), eng.stats.ticks
    chunk_k, decode_k = (lp.fused_launches, ld.fused_launches) if backend == "lean" else (
        fp.launches, fd.launches)
    assert chunk_k == cfg.n_layers * chunk_steps > 0
    assert decode_k == cfg.n_layers * ticks > 0
    assert lp.launches == 0                 # the chunk path runs the fused K4, not partials


# ------------------------------------------------------------------ K3, K5
CASCADES = {
    # (Hq, Hkv, d, page, workers, passes (members, start, pages), suffixes)
    "gqa-one-level": (8, 2, 64, 16, 24, [((0, 1, 2), 0, 3)], [5, 40, 33, 11]),
    "gqa-two-level": (8, 2, 64, 16, 7, [((0, 1, 2, 3), 0, 2), ((1, 2), 2, 2)], [3, 9, 17, 30]),
    "nemo-two-level": (32, 8, 128, 128, 132, [((0, 1, 2, 3), 0, 8), ((0, 1), 8, 8)],
                       [700, 300, 129, 1]),
    "g2-eight-members": (4, 2, 64, 16, 1000, [(tuple(range(8)), 0, 4)], list(range(1, 80, 10))),
    # the ring's row buckets and pages: 4 stacked rows on pages of 12, 8
    # rows on pages of 100 at d 64, 64 rows (float32: two slots), and pages
    # of 256 (float32 keeps the walk over device memory)
    "g2-two-members-page12": (4, 2, 128, 12, 24, [((0, 1), 0, 3)], [5, 30, 1]),
    "g2-three-members-page100": (4, 2, 64, 100, 40, [((0, 1, 2), 0, 3)], [50, 130, 1]),
    # the attention-family geometries: g 8 (qwen3-moe, yi), 6 (nemotron),
    # 1 (qwen2-moe, musicgen) -- g rows padded to their bucket
    "g8-four-members": (32, 4, 128, 128, 132, [((0, 1, 2, 3), 0, 4)], [300, 129, 17, 1]),
    "g6-three-members": (48, 8, 128, 128, 132, [((0, 1, 2), 0, 3)], [90, 1, 200]),
    "g1-three-members": (16, 16, 128, 64, 40, [((0, 1, 2), 0, 2)], [5, 70, 1]),
    "g4-sixteen-members": (8, 2, 128, 128, 132, [(tuple(range(16)), 0, 2)],
                           [7 * i + 1 for i in range(16)]),
    "nemo-page256": (32, 8, 128, 256, 132, [((0, 1, 2, 3), 0, 4)], [700, 300, 129, 1]),
}


def _k5_ring(args, kv_dtype) -> bool:
    q_pref, d, tile = args[0], args[0].shape[2], args[7].tile_size
    return ld.ring_slots(kv_dtype, q_pref.shape[1], d, tile) > 0


def _cascade_problem(dev, case, dtype, seed=0):
    """A case's pools, queries and two page tables: in ``tbl`` the passes'
    members alias shared pages; in ``dup`` every member past a pass's first
    reads its own copy of them. Private pages elsewhere, all shuffled."""
    import numpy as np

    Hq, Hkv, d, ps, workers, passes, suffixes = CASCADES[case]
    rng = np.random.default_rng(seed)
    B = len(suffixes)
    cover = [0] * B
    for mem, st, cnt in passes:
        for b in mem:
            cover[b] = max(cover[b], st + cnt)
    lens = [cover[b] * ps + suffixes[b] for b in range(B)]
    n_pages = [-(-L // ps) for L in lens]
    W = max(n_pages) + 1
    num_pages = 1 + sum(n_pages) + sum(c * len(m) for m, _, c in passes) + 2
    free = [int(p) for p in rng.permutation(np.arange(1, num_pages))]
    tbl = np.zeros((B, W), np.int32)
    for mem, st, cnt in passes:
        pages = [free.pop() for _ in range(cnt)]
        for b in mem:
            tbl[b, st:st + cnt] = pages
    for b in range(B):
        for t in range(cover[b], n_pages[b]):
            tbl[b, t] = free.pop()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    kp = torch.randn(num_pages, Hkv, ps, d, generator=gen, device=dev).to(dtype)
    vp = torch.randn(num_pages, Hkv, ps, d, generator=gen, device=dev).to(dtype)
    q = torch.randn(B, Hq, d, generator=gen, device=dev).to(dtype)
    dup = tbl.copy()
    for mem, st, cnt in passes:
        for b in mem[1:]:
            copy = [free.pop() for _ in range(cnt)]
            src = torch.as_tensor(tbl[b, st:st + cnt]).long()
            kp[copy], vp[copy] = kp[src], vp[src]
            dup[b, st:st + cnt] = copy
    return dict(q=q, kp=kp, vp=vp, tbl=tbl, dup=dup, lens=lens, workers=workers,
                groups=[list(m) for m, _, _ in passes], counts=[c for _, _, c in passes],
                starts=[st for _, st, _ in passes])


def _cascade_args(c, tbl):
    """K5's operands over page table ``tbl``, as ``ops`` builds them."""
    import numpy as np

    from repro_torch.core.leantile import cascade_fused_descriptors, make_cascade_schedule

    q, dev = c["q"], c["q"].device
    B, Hq, d = q.shape
    Hkv, ps = c["kp"].shape[1], c["kp"].shape[2]
    g = Hq // Hkv
    csched, binding = make_cascade_schedule(c["lens"], c["groups"], c["counts"], Hkv, ps,
                                            c["workers"], page_starts=c["starts"],
                                            max_len=tbl.shape[1] * ps)
    ptbl, stbl = ops.cascade_tables(tbl, binding)
    mem = torch.as_tensor(binding.members).long().clamp(min=0).to(dev)
    nmax, NP = csched.group_size, csched.num_groups
    q_pref = q.reshape(B, Hkv, g, d)[mem].movedim(2, 1).reshape(NP * Hkv, nmax * g, d)
    suffix = np.asarray(c["lens"]) - binding.seq_prefix_len
    ctx_all = np.concatenate([np.repeat(binding.prefix_lens, Hkv), np.repeat(suffix, Hkv)])
    route = torch.cat([ops.paged_route(csched.prefix_sched, torch.as_tensor(ptbl).to(dev), Hkv),
                       ops.paged_route(csched.suffix_sched, torch.as_tensor(stbl).to(dev), Hkv)])
    k_rows, v_rows = ops._pool_rows(c["kp"], c["vp"])
    return (q_pref.contiguous(), q.reshape(B * Hkv, g, d).contiguous(), k_rows, v_rows,
            torch.as_tensor(ctx_all.astype(np.int32)).to(dev), route.contiguous(),
            ld.cascade_fused_desc(cascade_fused_descriptors(csched, binding), csched, dev),
            csched, 1.0 / math.sqrt(d))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASCADES))
def test_k5_matches_plain_and_is_deterministic(cuda, case, dtype):
    """K5 against its plain version; two launches give the same bits, and
    so does the same cascade over duplicated pages (the reference's
    contract); the two-call path (K1 x 2 + merge) agrees within 2e-5."""
    c = _cascade_problem(cuda, case, getattr(torch, dtype))
    args = _cascade_args(c, c["tbl"])
    before, before_ring = ld.cascade_launches, ld.cascade_ring_launches
    o, lse = ld.lean_cascade_fused(*args)
    o2, lse2 = ld.lean_cascade_fused(*args)
    torch.cuda.synchronize()
    assert ld.cascade_launches == before + 2
    ring = _k5_ring(args, getattr(torch, dtype))
    assert ring == (case != "nemo-page256" or dtype == "bfloat16")
    assert ld.cascade_ring_launches == before_ring + 2 * ring
    o_ref, lse_ref = ld.lean_cascade_fused_plain(*args)
    torch.testing.assert_close(o, o_ref, **TOL)
    torch.testing.assert_close(lse, lse_ref, **TOL)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    o3, lse3 = ld.lean_cascade_fused(*_cascade_args(c, c["dup"]))
    assert torch.equal(o, o3) and torch.equal(lse, lse3)
    B, Hq, d = c["q"].shape
    two = ops.lean_decode_cascade(c["q"], c["kp"], c["vp"], c["tbl"], c["lens"], c["groups"],
                                  c["counts"], page_starts=c["starts"],
                                  num_workers=c["workers"], fused=False, return_lse=True)
    torch.testing.assert_close(two[0].float(), o.reshape(B, Hq, d).to(c["q"].dtype).float(),
                               **TOL)
    torch.testing.assert_close(two[1], lse.reshape(B, Hq), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [4, 12, 1024])
def test_k3_matches_plain_and_segment_merge(cuda, rows):
    """K3 on K1's partials (rows 4 and 12) and on random partials of a
    chunk segment (g * C = 1024 rows) against its plain version and
    segment_merge."""
    from repro_torch.core.merge import AttnPartial, finalize, segment_merge

    if rows <= 64:
        args = _operands(cuda, [300, 1, 77, 129], rows, 2, 64, 16, 24, torch.float32)
        parts = ld.lean_decode_partials(*args)
        sched = args[5]
    else:
        sched = make_schedule([300, 1, 77], 2, 16, 24)
        gen = torch.Generator(device=cuda)
        gen.manual_seed(5)
        P = sched.num_pieces
        parts = (torch.randn(P, rows, 64, generator=gen, device=cuda),
                 torch.randn(P, rows, generator=gen, device=cuda) * 3,
                 torch.rand(P, rows, generator=gen, device=cuda) + 0.5)
    before = ld.merge_launches
    o, lse = ld.lean_merge(*parts, sched)
    torch.cuda.synchronize()
    assert ld.merge_launches == before + 1
    o_ref, lse_ref = ld.merge_pieces_plain(*parts, sched)
    torch.testing.assert_close(o, o_ref, **TOL)
    torch.testing.assert_close(lse, lse_ref, **TOL)
    seg = segment_merge(AttnPartial(*parts), ld.schedule_tensors(sched, cuda)["piece_seg"],
                        sched.num_segments)
    torch.testing.assert_close(o, finalize(seg), **TOL)


@pytest.mark.cuda
def test_cascade_scheduler_on_card_runs_k5(cuda):
    """The smoke-config Scheduler with the prefix cache and the cascade on
    the card: every request served, pool and radix cache clean, K5 launched
    once per layer and cascade tick, K2 once per layer and other tick."""
    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.serving.config import CascadeConfig, EngineConfig, PagedConfig
    from repro_torch.serving.engine import DecodeEngine
    from repro_torch.serving.scheduler import Scheduler, SchedulerConfig

    cfg = get_smoke_config("mistral-nemo-12b")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    eng = DecodeEngine(cfg, params, EngineConfig(
        max_batch=4, cache_len=64, num_workers=8, attn_backend="lean",
        paged=PagedConfig(enabled=True, page_size=8, prefix_cache=True),
        cascade=CascadeConfig(enabled=True, stable_ticks=1)), device="cuda")
    sch = Scheduler(eng, SchedulerConfig(chunk_size=8, prefill_pack=2, token_budget=32))
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, 24)
    ld.reset_launch_counts()
    for n in (2, 4):
        hs = [sch.submit(np.concatenate([shared, rng.integers(0, cfg.vocab_size, 4 + 2 * i)]),
                         4) for i in range(n)]
        sch.run_to_completion(max_steps=400)
        assert all(h.done for h in hs)
    eng.pool.check()
    eng.prefix_cache.check()
    st = eng.stats
    assert st.prefix_attach_count >= 4 and st.cascade_fused_ticks > 0
    assert ld.cascade_launches == cfg.n_layers * st.cascade_fused_ticks
    assert ld.fused_launches == cfg.n_layers * (st.ticks - st.cascade_ticks)


# ------------------------------------------------------------------------ K7
# the reference's PREFILL_CASES (tests/test_kernels.py:130-136) and two at
# Mistral-NeMo-12B's attention widths: (B, Hq, Hkv, Lq, Lk, d, causal,
# window, block_kv)
K7_CASES = [
    (2, 4, 2, 64, 64, 64, True, None, 32),
    (1, 4, 4, 100, 100, 64, True, 32, 32),
    (2, 2, 1, 37, 150, 128, False, None, 32),
    (1, 8, 2, 128, 256, 32, True, None, 32),
    (1, 2, 2, 65, 65, 16, True, 16, 32),
    (1, 32, 8, 333, 333, 128, True, None, 128),
    (1, 32, 8, 300, 700, 128, True, 128, 128),
]


def _bf16_close(out, ref):
    diff = (out.float() - ref.float()).abs()
    return bool((diff <= 2.0 ** -7 * ref.float().abs() + TOL["atol"]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", K7_CASES)
def test_k7_matches_plain(cuda, case, dtype):
    """K7 against its plain version (the reference's block walk) on the
    prefill cases: causal with a query offset, sliding windows, non-causal
    with Lq != Lk, row blocks that span two query heads."""
    B, Hq, Hkv, Lq, Lk, d, causal, window, block_kv = case
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(Lq + Lk)
    q = torch.randn(B, Hq, Lq, d, generator=gen, device=cuda).to(dt)
    k = torch.randn(B, Hkv, Lk, d, generator=gen, device=cuda).to(dt)
    v = torch.randn(B, Hkv, Lk, d, generator=gen, device=cuda).to(dt)
    kw = dict(causal=causal, window=window, q_offset=Lk - Lq if causal else 0,
              block_q=block_kv, block_kv=block_kv)
    before = (fp.dense_launches, fp.launches)
    out = fp.flash_prefill(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (fp.dense_launches, fp.launches) == (before[0] + 1, before[1])
    ref = fp.flash_prefill_plain(q, k, v, **kw)
    assert out.dtype == dt and out.shape == q.shape
    if dtype == "float32":
        torch.testing.assert_close(out, ref, **TOL)
    else:
        assert _bf16_close(out, ref)


@pytest.mark.cuda
def test_k7_rows_that_see_no_key_and_refusals(cuda):
    """Queries before position 0 give 0, as the plain version; what the
    kernel cannot take raises."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    q = torch.randn(1, 4, 70, 16, generator=gen, device=cuda)
    k = torch.randn(1, 1, 50, 16, generator=gen, device=cuda)
    out = fp.flash_prefill(q, k, k, q_offset=-20)
    torch.testing.assert_close(out, fp.flash_prefill_plain(q, k, k, q_offset=-20), **TOL)
    with pytest.raises(ValueError, match="contiguous"):
        fp.flash_prefill(q.transpose(2, 3).transpose(2, 3)[:, :, ::2], k, k)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fp.flash_prefill(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="shared memory"):
        fp.flash_prefill(torch.zeros(1, 1, 8, 512, device=cuda),
                         torch.zeros(1, 1, 8, 512, device=cuda),
                         torch.zeros(1, 1, 8, 512, device=cuda))


# ------------------------------------------------ tensor-core K7 and K8
# bf16 at d 64 and 128 runs on the tensor-core kernel (fp.tensor_core_path),
# and so does K7 at d 256 (key tiles of 64): K7_CASES at the three head
# dims, and (B, Hq, Hkv, Lq, Lk, d, causal, window, q_offset) cases for its
# edges: rows that see no key (q_offset < 0), row blocks that straddle two
# query heads (Lq not a multiple of 64), ragged tails (Lk not a multiple of
# the key tile), a window over several tiles, a window narrower than one
K7_TC_EDGES = [
    (1, 4, 1, 70, 50, 128, True, None, -20),
    (1, 4, 1, 100, 100, 128, True, None, 0),
    (1, 8, 2, 200, 300, 128, True, None, 100),
    (1, 8, 2, 200, 300, 64, False, None, 0),
    (1, 8, 2, 333, 333, 128, True, 100, 0),
    (1, 4, 1, 70, 50, 256, True, None, -20),
    (1, 4, 1, 100, 100, 256, True, None, 0),
    (1, 8, 2, 200, 300, 256, True, None, 100),
    (1, 8, 2, 200, 300, 256, False, None, 0),
    (1, 8, 2, 333, 333, 256, True, 100, 0),
    (1, 4, 2, 150, 150, 256, True, 40, 0),
    # recurrentgemma-9b's window layers: MQA, 16 query heads over one KV
    # head (row blocks of one head's rows), windows shorter and longer
    # than the prompt
    (1, 16, 1, 333, 333, 256, True, 100, 0),
    (1, 16, 1, 700, 700, 256, True, 256, 0),
    (1, 16, 1, 300, 300, 256, True, 2048, 0),
]


def _k7_tc(cuda, B, Hq, Hkv, Lq, Lk, d, causal, window, q_offset, **blocks):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(Lq + Lk + d)
    q = torch.randn(B, Hq, Lq, d, generator=gen, device=cuda).bfloat16()
    k = torch.randn(B, Hkv, Lk, d, generator=gen, device=cuda).bfloat16()
    v = torch.randn(B, Hkv, Lk, d, generator=gen, device=cuda).bfloat16()
    kw = dict(causal=causal, window=window, q_offset=q_offset, **blocks)
    before = (fp.dense_launches, fp.dense_tc_launches)
    out = fp.flash_prefill(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (fp.dense_launches, fp.dense_tc_launches) == (before[0] + 1, before[1] + 1)
    ref = fp.flash_prefill_plain(q, k, v, **kw)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert _bf16_close(out, ref)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("case", K7_CASES)
def test_k7_tensor_core_matches_plain(cuda, case, d):
    """The tensor-core K7 against the plain version on the reference's
    prefill cases at its three head dims; block sizes change nothing."""
    B, Hq, Hkv, Lq, Lk, _, causal, window, block_kv = case
    _k7_tc(cuda, B, Hq, Hkv, Lq, Lk, d, causal, window, Lk - Lq if causal else 0,
           block_q=block_kv, block_kv=block_kv)


@pytest.mark.cuda
@pytest.mark.parametrize("case", K7_TC_EDGES,
                         ids=[f"d{c[5]}-{c[3]}x{c[4]}-w{c[7]}-off{c[8]}" for c in K7_TC_EDGES])
def test_k7_tensor_core_edges(cuda, case):
    out = _k7_tc(cuda, *case)
    q_offset = case[8]
    if q_offset < 0:   # rows before position 0 see no key and write 0
        assert not out[:, :, :-q_offset].float().any()


@pytest.mark.cuda
@pytest.mark.parametrize("d,Lk", [(128, 300), (256, 300), (256, 100)])
def test_k7_tensor_core_ignores_keys_past_lk(cuda, d, Lk):
    """k and v the first Lk rows of buffers whose rows past Lk hold NaN:
    the tile past Lk reads zeros (the tensor map ends at Lk), so the output
    equals the one from zeros there, bit for bit, and is finite."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(d + Lk)
    q = torch.randn(1, 4, Lk, d, generator=gen, device=cuda).bfloat16()
    kb = torch.randn(1, 1, Lk + 128, d, generator=gen, device=cuda).bfloat16()
    vb = torch.randn(1, 1, Lk + 128, d, generator=gen, device=cuda).bfloat16()
    zero = fp.flash_prefill(q, kb[:, :, :Lk].clone(), vb[:, :, :Lk].clone())
    kb[:, :, Lk:] = float("nan")
    vb[:, :, Lk:] = float("nan")
    k, v = kb[:, :, :Lk], vb[:, :, :Lk]
    assert k.is_contiguous() and v.is_contiguous()
    nan = fp.flash_prefill(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(zero, nan) and bool(torch.isfinite(nan).all())
    assert _bf16_close(nan, fp.flash_prefill_plain(q, k, v))


# (Hq, Hkv, d, page, offs, C): pages of 16, 128, 24 (not a divisor of the
# key tile) and 256 (two tiles a page)
K8_TC_CASES = [
    (4, 2, 64, 16, (0, 9, 33), 5),
    (32, 8, 128, 128, (300, 37), 100),
    (8, 2, 128, 24, (50, 3), 40),
    (8, 2, 64, 256, (300, 0), 100),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", K8_TC_CASES)
def test_k8_tensor_core_ignores_rows_past_each_chunk(cuda, case):
    """Every pool row past each chunk's last position NaN gives the same
    output, bit for bit, as zeros there: keys no row sees add nothing, not
    even 0 * NaN. Both agree with the plain version on the zero pools."""
    Hq, Hkv, d, page, offs, C = case
    q, kp, vp, tbl = _chunk_operands(cuda, list(offs), [C] * len(offs), Hq, Hkv, d, page,
                                     torch.bfloat16, seed=page)
    q_off = torch.tensor(offs, dtype=torch.int32, device=cuda)
    past = torch.zeros(kp.shape[:1] + kp.shape[2:3], dtype=torch.bool, device=cuda)
    for n, o in enumerate(offs):
        for jb, pg in enumerate(tbl[n].tolist()):
            if pg:
                past[pg] = torch.arange(page, device=cuda) + jb * page > o + C - 1
    kp[past[:, None, :].expand(kp.shape[:3])] = 0
    vp[past[:, None, :].expand(vp.shape[:3])] = 0
    before = (fp.launches, fp.tc_launches)
    zero = fp.flash_prefill_paged(q, kp, vp, tbl, q_off)
    kp[past[:, None, :].expand(kp.shape[:3])] = float("nan")
    vp[past[:, None, :].expand(vp.shape[:3])] = float("nan")
    nan = fp.flash_prefill_paged(q, kp, vp, tbl, q_off)
    torch.cuda.synchronize()
    assert (fp.launches, fp.tc_launches) == (before[0] + 2, before[1] + 2)
    assert torch.equal(zero, nan)
    kp[past[:, None, :].expand(kp.shape[:3])] = 0
    vp[past[:, None, :].expand(vp.shape[:3])] = 0
    assert _bf16_close(zero, fp.flash_prefill_paged_plain(q, kp, vp, tbl, q_off,
                                                          1.0 / math.sqrt(d)))


@pytest.mark.cuda
def test_tensor_core_counters_follow_the_path_rule(cuda):
    """dense_launches / launches count every launch, dense_tc_launches /
    tc_launches only bf16 at d 64 or 128 -- and K7's also bf16 at d 256,
    where K8 keeps the CUDA cores."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    for dtype, d, tc7, tc8 in ((torch.float32, 128, 0, 0), (torch.bfloat16, 32, 0, 0),
                               (torch.bfloat16, 128, 1, 1), (torch.bfloat16, 256, 1, 0),
                               (torch.float32, 256, 0, 0)):
        assert (fp.tensor_core_path(dtype, d), fp.tensor_core_path(dtype, d, 16)) == (tc7, tc8)
        q = torch.randn(1, 4, 40, d, generator=gen, device=cuda).to(dtype)
        k = torch.randn(1, 2, 40, d, generator=gen, device=cuda).to(dtype)
        fp.reset_launch_counts()
        fp.flash_prefill(q, k, k)
        qc, kp, vp, tbl = _chunk_operands(cuda, [20], [8], 4, 2, d, 16, dtype)
        fp.flash_prefill_paged(qc, kp, vp, tbl, torch.tensor([20], dtype=torch.int32,
                                                             device=cuda))
        torch.cuda.synchronize()
        assert (fp.dense_launches, fp.launches) == (1, 1)
        assert (fp.dense_tc_launches, fp.tc_launches) == (tc7, tc8)


@pytest.mark.cuda
def test_tensor_core_refusals(cuda):
    """A page that is not a multiple of 8 is no refusal: the path rule sends
    it to the CUDA-core kernel. An operand TMA cannot address raises before
    any launch."""
    qc, kp, vp, tbl = _chunk_operands(cuda, [0], [8], 4, 2, 128, 12, torch.bfloat16)
    off = torch.zeros(1, dtype=torch.int32, device=cuda)
    fp.reset_launch_counts()
    fp.flash_prefill_paged(qc, kp, vp, tbl, off)
    torch.cuda.synchronize()
    assert (fp.launches, fp.tc_launches) == (1, 0)
    fp.reset_launch_counts()
    for d in (128, 256):
        k = torch.zeros(1, 2, 16, d, dtype=torch.bfloat16, device=cuda)
        flat = torch.zeros(1 + 4 * 16 * d, dtype=torch.bfloat16, device=cuda)
        q = flat[1:].view(1, 4, 16, d)           # contiguous, 2 bytes off alignment
        with pytest.raises(ValueError, match="aligned"):
            fp.flash_prefill(q, k, k)
        with pytest.raises(ValueError, match="aligned"):
            fp.flash_prefill(k.repeat(1, 2, 1, 1), q[:, :2], q[:, 2:])
    assert (fp.dense_launches, fp.launches) == (0, 0)


@pytest.mark.cuda
def test_dense_engine_on_card_matches_paged(cuda):
    """The smoke-config dense-cache engine on the card against the paged
    one (pages as large as the dense engine's tile, so both walk one
    schedule): the same greedy streams, decode logits within bf16 noise,
    K7 launched once per layer and admission in both, K2 once per layer and
    decode tick."""
    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.serving.config import EngineConfig, PagedConfig
    from repro_torch.serving.engine import DecodeEngine, Request

    cfg = get_smoke_config("mistral-nemo-12b")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    runs = {}
    for paged in (False, True):
        eng = DecodeEngine(cfg, params, EngineConfig(
            max_batch=2, cache_len=64, num_workers=8, attn_backend="lean",
            paged=PagedConfig(enabled=paged, page_size=64 if paged else None)), device="cuda")
        rng = np.random.default_rng(25)
        reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, 8 + 7 * i),
                        max_new_tokens=6) for i in range(4)]
        for r in reqs:
            eng.submit(r)
        for m in (ld, lp, fd, fp):
            m.reset_launch_counts()
        rows = []
        while eng.queue or any(eng.slot_req):
            eng.tick()
            rows.append(eng.last_logits.float().cpu())
        assert all(r.done for r in reqs)
        assert fp.dense_launches == cfg.n_layers * eng.stats.prefills == cfg.n_layers * 4
        assert ld.fused_launches == cfg.n_layers * eng.stats.ticks
        runs[paged] = ([r.generated for r in reqs], rows)
    assert runs[False][0] == runs[True][0]
    for a, b in zip(runs[False][1], runs[True][1]):
        torch.testing.assert_close(a, b, rtol=2**-5, atol=2**-5)


# ------------------------------------------------------- page sizes (fault 1)
# (page, d, dtypes): pages the engine can pick that are not a multiple of 8
# (12, and 100 for a 100-token cache: min(default_tile_size, cache_len)),
# and a page of 256 keys at d 128, whose float32 tile does not fit the
# row-block kernel's shared memory in one piece (walked in sub-tiles of 128)
PAGE_CASES = [(12, 128, ["bfloat16"]), (100, 128, ["bfloat16"]),
              (256, 128, ["float32", "bfloat16"])]


@pytest.mark.cuda
@pytest.mark.parametrize("page,d,dtypes", PAGE_CASES, ids=lambda c: str(c))
def test_fixed_and_lean_take_any_page(cuda, page, d, dtypes):
    """K8 (``fixed`` chunks) on every case, and K4 (``lean`` chunks) and K6
    (``fixed`` decode) on the same pages, against their plain versions."""
    Hq, Hkv, offs, lens = 8, 2, [300, 5], [100, 37]
    for dtype in dtypes:
        dt = getattr(torch, dtype)
        q, kp, vp, tbl = _chunk_operands(cuda, offs, lens, Hq, Hkv, d, page, dt, seed=page)
        N, _, C, _ = q.shape
        q_off = torch.tensor(offs, dtype=torch.int32, device=cuda)
        before = fp.launches
        o8 = fp.flash_prefill_paged(q, kp, vp, tbl, q_off)
        torch.cuda.synchronize()
        assert fp.launches == before + 1
        ref = fp.flash_prefill_paged_plain(q, kp, vp, tbl, q_off, 1.0 / math.sqrt(d))
        for n, L in enumerate(lens):
            assert _bf16_close(o8[n, :, :L], ref[n, :, :L]) if dt == torch.bfloat16 else \
                torch.allclose(o8[n, :, :L], ref[n, :, :L], **TOL)
        visible = [o + n for o, n in zip(offs, lens)]
        sched = make_chunk_schedule(visible, Hkv, page, 24, max_len=tbl.shape[1] * page)
        k_rows, v_rows = ops._pool_rows(kp, vp)
        args = (q.reshape(N * Hkv, (Hq // Hkv) * C, d).contiguous(), k_rows, v_rows,
                torch.tensor([v for v in visible for _ in range(Hkv)], dtype=torch.int32,
                             device=cuda),
                torch.tensor([o for o in offs for _ in range(Hkv)], dtype=torch.int32,
                             device=cuda),
                ops.paged_route(sched, tbl, Hkv), sched, 1.0 / math.sqrt(d), C)
        for a, b in zip(lp.lean_prefill_chunk_partials(*args),
                        lp.lean_prefill_partials_plain(*args)):
            torch.testing.assert_close(a, b, **TOL)
        dq, _, _, seg = _operands(cuda, [700, 1, 257], Hq // Hkv, Hkv, d, page, 24, dt,
                                  seed=page)[:4]
        s_pad = -(-700 // page) * page
        kd = torch.randn(dq.shape[0], s_pad, d, device=cuda).to(dt)
        vd = torch.randn(dq.shape[0], s_pad, d, device=cuda).to(dt)
        fargs = (dq, kd, vd, seg, 3, page, 1.0 / math.sqrt(d))
        for a, b in zip(fd.flash_decode_partials(*fargs), fd.flash_decode_partials_plain(*fargs)):
            torch.testing.assert_close(a, b, **TOL)


# ------------------------------------------------------------------ int8 K/V
def _quantized(k_rows, v_rows, zero_rows=()):
    """int8 rows and per-row float32 scales of float rows (the engine's
    quantizer over each row, a (page, head)); ``zero_rows`` get scale 0."""
    from repro_torch.core.attention import quantize_kv_blocks

    out = []
    for rows in (k_rows, v_rows):
        q, s = quantize_kv_blocks(rows[:, None].float())
        s = s.reshape(-1).clone()
        s[list(zero_rows)] = 0.0
        out += [q[:, 0].contiguous(), s]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("gq,d,tile", [(2, 64, 16), (4, 128, 128), (12, 64, 16), (64, 128, 16),
                                       (4, 128, 100)])
def test_int8_decode_kernels_match_plain(cuda, gq, d, tile):
    """K1-int8 and K2-int8 (bf16 queries, int8 rows, a float32 scale per
    row) against their plain versions; a sequence whose pages all have
    scale 0 reads exact zeros."""
    Hkv = 2
    args = list(_operands(cuda, [300, 1, 77, 40], gq, Hkv, d, tile, 24, torch.bfloat16,
                          seed=gq))
    sched, route = args[5], args[4]
    # every pool row the last sequence (40 tokens) reads has scale 0
    st = ld.schedule_tensors(sched, cuda)
    last = route[: sched.grid_iters][(st["kv_batch"] == 3) & st["kv_ok"]].unique().tolist()
    kq, ks, vq, vs = _quantized(args[1], args[2], last)
    args[1], args[2] = kq, vq
    sc = dict(k_scales=ks, v_scales=vs)
    before = (ld.partials_launches, ld.fused_launches)
    o, lse = ld.lean_decode_fused(*args, **sc)
    parts = ld.lean_decode_partials(*args, **sc)
    torch.cuda.synchronize()
    assert (ld.partials_launches, ld.fused_launches) == (before[0] + 1, before[1] + 1)
    o_ref, lse_ref = ld.lean_decode_fused_plain(*args, **sc)
    torch.testing.assert_close(o, o_ref, **TOL)
    torch.testing.assert_close(lse, lse_ref, **TOL)
    for a, b in zip(parts, ld.lean_decode_partials_plain(*args, **sc)):
        torch.testing.assert_close(a, b, **TOL)
    assert not o[3 * Hkv:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_int8_chunk_kernel_matches_plain(cuda, case):
    """K4-int8 against its plain version on the chunk cases."""
    Hq, Hkv, d, tile, offs, lens, workers = CHUNK_CASES[case]
    q, kp, vp, tbl = _chunk_operands(cuda, offs, lens, Hq, Hkv, d, tile, torch.bfloat16)
    N, _, C, _ = q.shape
    visible = [max(1, o + n) for o, n in zip(offs, lens)]
    sched = make_chunk_schedule(visible, Hkv, tile, workers, max_len=tbl.shape[1] * tile)
    kq, ks, vq, vs = _quantized(*ops._pool_rows(kp, vp))
    args = (q.reshape(N * Hkv, (Hq // Hkv) * C, d).contiguous(), kq, vq,
            torch.tensor([v for v in visible for _ in range(Hkv)], dtype=torch.int32,
                         device=cuda),
            torch.tensor([o for o in offs for _ in range(Hkv)], dtype=torch.int32, device=cuda),
            ops.paged_route(sched, tbl, Hkv), sched, 1.0 / math.sqrt(d), C)
    before = lp.launches
    parts = lp.lean_prefill_chunk_partials(*args, k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    assert lp.launches == before + 1
    for a, b in zip(parts, lp.lean_prefill_partials_plain(*args, k_scales=ks, v_scales=vs)):
        torch.testing.assert_close(a, b, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASCADES))
def test_int8_cascade_matches_plain(cuda, case):
    """K5-int8 against its plain version (on the ring at every case); two
    launches, and shared and duplicated pages, give the same bits."""
    c = _cascade_problem(cuda, case, torch.bfloat16)
    args = list(_cascade_args(c, c["tbl"]))
    kq, ks, vq, vs = _quantized(args[2], args[3])
    args[2], args[3] = kq, vq
    before, before_ring = ld.cascade_launches, ld.cascade_ring_launches
    o, lse = ld.lean_cascade_fused(*args, k_scales=ks, v_scales=vs)
    o2, lse2 = ld.lean_cascade_fused(*args, k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    assert ld.cascade_launches == before + 2
    assert _k5_ring(args, torch.int8) and ld.cascade_ring_launches == before_ring + 2
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    o_ref, lse_ref = ld.lean_cascade_fused_plain(*args, k_scales=ks, v_scales=vs)
    torch.testing.assert_close(o, o_ref, **TOL)
    torch.testing.assert_close(lse, lse_ref, **TOL)
    dup = list(_cascade_args(c, c["dup"]))
    kd, ksd, vd, vsd = _quantized(dup[2], dup[3])
    dup[2], dup[3] = kd, vd
    o3, lse3 = ld.lean_cascade_fused(*dup, k_scales=ksd, v_scales=vsd)
    assert torch.equal(o, o3) and torch.equal(lse, lse3)


@pytest.mark.cuda
def test_int8_refusals(cuda):
    """int8 rows take bf16 queries and a head dim that is a multiple of 16."""
    args = list(_operands(cuda, [40], 4, 1, 64, 16, 4, torch.float32))
    kq, ks, vq, vs = _quantized(args[1], args[2])
    args[1], args[2] = kq, vq
    with pytest.raises(TypeError, match="bf16 queries"):
        ld.lean_decode_fused(*args, k_scales=ks, v_scales=vs)
    args = list(_operands(cuda, [40], 4, 1, 24, 16, 4, torch.bfloat16))
    kq, ks, vq, vs = _quantized(args[1], args[2])
    args[1], args[2] = kq, vq
    with pytest.raises(ValueError, match="multiple of 16"):
        ld.lean_decode_fused(*args, k_scales=ks, v_scales=vs)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["lean", "fixed"])
def test_int8_engine_on_card_matches_cpu(cuda, backend):
    """The smoke-config int8 engine under the Scheduler with chunked prefill
    on the card (fused K4-int8 / K2-int8 on ``lean``; K8 / K6 on dequantized K/V
    on ``fixed``) against the same on the CPU: every request served, the
    int8 pools and scales within one int8 step of the CPU's (bf16 GEMMs
    round in another order on the card), pool clean with its scales, each
    kernel launched once per layer and step."""
    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.serving.config import EngineConfig, PagedConfig
    from repro_torch.serving.engine import DecodeEngine
    from repro_torch.serving.scheduler import Scheduler, SchedulerConfig

    cfg = get_smoke_config("mistral-nemo-12b")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    first = {}
    for dev in ("cpu", "cuda"):
        p = {k: v.to(dev) if torch.is_tensor(v) else v for k, v in params.items()}
        p["layers"] = [{k: ({kk: vv.to(dev) for kk, vv in v.items()} if isinstance(v, dict)
                            else v.to(dev)) for k, v in layer.items()}
                       for layer in params["layers"]]
        eng = DecodeEngine(cfg, p, EngineConfig(
            max_batch=2, cache_len=64, num_workers=8, attn_backend=backend,
            paged=PagedConfig(enabled=True, page_size=16, kv_dtype="int8")), device=dev)
        sch = Scheduler(eng, SchedulerConfig(chunk_size=8, prefill_pack=2, token_budget=16))
        rng = np.random.default_rng(0)
        hs = [sch.submit(rng.integers(0, cfg.vocab_size, 8 + 7 * i), 6, uid=i)
              for i in range(4)]
        for m in (ld, lp, fd, fp):
            m.reset_launch_counts()
        sch.step()
        first[dev] = [lc["k_scale"].cpu().clone() for lc in eng.cache]
        sch.run_to_completion(max_steps=400)
        assert all(h.done and len(h.generated) == 6 for h in hs)
        eng.pool.check(scales=eng._kv_scale_arrays())
        assert eng.pool.num_allocated == 0
        if dev == "cuda":
            chunk_steps, ticks = len(eng.stats.tick_prefill_tokens), eng.stats.ticks
            chunk_k, decode_k = (lp.fused_launches, ld.fused_launches) if backend == "lean" \
                else (fp.launches, fd.launches)
            assert chunk_k == cfg.n_layers * chunk_steps > 0
            assert decode_k == cfg.n_layers * ticks > 0
    for a, b in zip(first["cuda"], first["cpu"]):
        torch.testing.assert_close(a, b, rtol=2**-6, atol=1e-6)


# ------------------------------------------------------------- fused K4
# (page, C): pages of one tile, of two sub-tiles (256), smaller than a tile
# (16), and pages the path rule sends to the CUDA cores (12, 100); chunks of
# 256 and 96 (a row block of 128 spans two query heads at C 96)
FUSED_CASES = [(128, 256), (256, 256), (16, 96), (12, 96), (100, 256), (128, 96)]


def _fused_operands(dev, page, C, dtype, Hq=32, Hkv=8, d=128, workers=132, seed=0):
    """A ragged pack at Mistral-NeMo-12B attention shapes (the second
    chunk shorter than C) and the fused K4's operands; ``dtype`` "int8":
    bf16 queries, int8 rows and their scales."""
    offs, lens = [300, 37], [C, C - 5]
    dt = torch.bfloat16 if dtype == "int8" else getattr(torch, dtype)
    q, kp, vp, tbl = _chunk_operands(dev, offs, lens, Hq, Hkv, d, page, dt, seed=seed)
    N = len(offs)
    visible = [o + n for o, n in zip(offs, lens)]
    sched = make_chunk_schedule(visible, Hkv, page, workers, max_len=tbl.shape[1] * page)
    k_rows, v_rows = ops._pool_rows(kp, vp)
    sc = {}
    if dtype == "int8":
        k_rows, ks, v_rows, vs = _quantized(k_rows, v_rows)
        sc = dict(k_scales=ks, v_scales=vs)
    args = (q.reshape(N * Hkv, (Hq // Hkv) * C, d).contiguous(), k_rows, v_rows,
            torch.tensor([v for v in visible for _ in range(Hkv)], dtype=torch.int32, device=dev),
            torch.tensor([o for o in offs for _ in range(Hkv)], dtype=torch.int32, device=dev),
            ops.paged_route(sched, tbl, Hkv), sched, 1.0 / math.sqrt(d), C)
    return args, sc, (q, kp, vp, tbl)


@pytest.mark.cuda
@pytest.mark.parametrize("page,C,dtype",
                         [(p, c, dt) for dt in ("bfloat16", "int8") for p, c in FUSED_CASES]
                         + [(128, 256, "float32"), (12, 96, "float32")])
def test_fused_k4_matches_plain(cuda, page, C, dtype):
    """The fused K4 against its plain version (the partials folded in piece
    order): bf16 and int8 within one bf16 step of the output plus 2e-5
    (both round a float32 result; the tensor-core kernel puts P through PV
    as two bf16 halves), float32 within 2e-5. The path rule picks the
    kernel, and the counters say which ran."""
    args, sc, _ = _fused_operands(cuda, page, C, dtype)
    tc = fp.tensor_core_path(args[0].dtype, args[0].shape[2], page)
    lp.reset_launch_counts()
    out = lp.lean_prefill_fused(*args, **sc)
    torch.cuda.synchronize()
    assert (lp.fused_launches, lp.fused_tc_launches, lp.launches) == (1, int(tc), 0)
    ref = lp.lean_prefill_fused_plain(*args, **sc)
    assert out.dtype == ref.dtype == args[0].dtype and out.shape == ref.shape
    if dtype == "float32":
        torch.testing.assert_close(out, ref, **TOL)
    else:
        assert _bf16_close(out, ref), (out.float() - ref.float()).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("page,C", [(128, 256), (100, 96)])
def test_fused_k4_same_bits_twice(cuda, page, C, dtype):
    """The fix-up folds a segment's pieces in piece order whichever CTA
    arrives last: two launches on the same inputs give the same bits."""
    args, sc, _ = _fused_operands(cuda, page, C, dtype, seed=1)
    a = lp.lean_prefill_fused(*args, **sc)
    b = lp.lean_prefill_fused(*args, **sc)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("page,C", [(128, 256), (256, 96), (12, 96)])
def test_fused_k4_matches_two_phase(cuda, page, C, dtype):
    """The verify plan fused (one launch) against fused=False (K4 partials
    and segment_merge): one bf16 step of the output plus 2e-5 apart."""
    args, sc, (q, kp, vp, tbl) = _fused_operands(cuda, page, C, dtype, seed=2)
    kv = (kp, vp)
    if dtype == "int8":   # the pools and (page, head) scales of the int8 rows
        kv = (args[1].view(kp.shape), args[2].view(kp.shape))
        sc = {k: v.view(kp.shape[:2]) for k, v in sc.items()}
    outs = {}
    for fused in (True, False):
        plan = ops.DecodePlan(kind="verify", sched=args[6], fused=fused, spec_rows=C)
        lp.reset_launch_counts()
        outs[fused] = ops.decode(q, kv, plan=plan, ctx=args[3], page_tbl=tbl, qstart=args[4],
                                 **sc)
        torch.cuda.synchronize()
        assert (lp.fused_launches, lp.launches) == ((1, 0) if fused else (0, 1))
    assert _bf16_close(outs[True], outs[False])


# ------------------------------------------- attention-family geometries
# (gq, d, tile): musicgen (1, 64), qwen2-moe (1, 128), nemotron (6, 128),
# qwen3-moe and yi (8, 128), gemma3 (4, 256) on pages of 128 and 16
ARCH_DECODE = [(1, 64, 128), (1, 128, 128), (6, 128, 128), (8, 128, 128), (4, 256, 128),
               (4, 256, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gq,d,tile", ARCH_DECODE)
def test_decode_kernels_at_arch_geometries(cuda, gq, d, tile, dtype):
    """K1, K2 and K6 against their plain versions where a segment's rows
    are padded to their bucket (gq 1 -> 2, 6 -> 8) and at d 256: the pad
    rows never write (outputs hold exactly gq rows, equal to the plain
    version's), and the ring or the walk runs as the path rule says."""
    dt = getattr(torch, dtype)
    args = _operands(cuda, [1500, 1, 300, 129], gq, 2, d, tile, 132, dt, seed=gq + d)
    ring = ld.ring_slots(dt, gq, d, tile) > 0
    before = (ld.fused_ring_launches, ld.partials_ring_launches)
    o, lse = ld.lean_decode_fused(*args)
    parts = ld.lean_decode_partials(*args)
    torch.cuda.synchronize()
    assert (ld.fused_ring_launches, ld.partials_ring_launches) == (before[0] + ring,
                                                                  before[1] + ring)
    assert o.shape[1] == gq
    o_ref, lse_ref = ld.lean_decode_fused_plain(*args)
    torch.testing.assert_close(o, o_ref, **TOL)
    torch.testing.assert_close(lse, lse_ref, **TOL)
    for a, b in zip(parts, ld.lean_decode_partials_plain(*args)):
        torch.testing.assert_close(a, b, **TOL)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(gq)
    lens = [1500, 1, 300, 0]
    S, s_pad = 2 * len(lens), -(-1500 // tile) * tile
    q = torch.randn(S, gq, d, generator=gen, device=cuda).to(dt)
    k = torch.randn(S, s_pad, d, generator=gen, device=cuda).to(dt)
    v = torch.randn(S, s_pad, d, generator=gen, device=cuda).to(dt)
    seg = torch.tensor([L for L in lens for _ in range(2)], dtype=torch.int32, device=cuda)
    k6 = (q, k, v, seg, fixed_split_factor(1500, S, tile, 132), tile, 1.0 / math.sqrt(d))
    before = fd.ring_launches
    out = fd.flash_decode_partials(*k6)
    torch.cuda.synchronize()
    assert fd.ring_launches == before + (fd.ring_slots(dt, gq, d, tile) > 0)
    for a, b in zip(out, fd.flash_decode_partials_plain(*k6)):
        assert a.shape == b.shape and a.shape[2] == gq
        torch.testing.assert_close(a, b, **TOL)


@pytest.mark.cuda
def test_k5_refuses_the_walk_at_g_8(cuda, monkeypatch):
    """K5 at g 5-8 runs on the decode ring only: where the ring would not
    fit, the wrapper refuses, naming the kernel and the shape."""
    c = _cascade_problem(cuda, "g8-four-members", torch.bfloat16)
    args = _cascade_args(c, c["tbl"])
    monkeypatch.setattr(ld, "ring_slots", lambda *a: 0)
    with pytest.raises(ValueError, match="K5.*g 8"):
        ld.lean_cascade_fused(*args)


@pytest.mark.cuda
def test_k6_refuses_more_rows_than_its_buckets(cuda):
    args = _k6_args(cuda, "fixed-factor", fd.MAX_GQ + 1, "bfloat16", 128, 128)
    with pytest.raises(ValueError, match="K6"):
        fd.flash_decode_partials(*args)


# (Hq, Hkv, d): qwen3-moe, nemotron, qwen2-moe, musicgen, yi
ARCH_CHUNK = [(32, 4, 128), (48, 8, 128), (16, 16, 128), (32, 32, 64), (64, 8, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("Hq,Hkv,d", ARCH_CHUNK)
def test_chunk_kernels_at_arch_geometries(cuda, Hq, Hkv, d):
    """The fused K4 (tensor cores) and K8 on a pack of two 256-token chunks
    at each chunked architecture's heads, against their plain versions."""
    args, sc, (q, kp, vp, tbl) = _fused_operands(cuda, 128, 256, "bfloat16", Hq=Hq, Hkv=Hkv,
                                                  d=d)
    lp.reset_launch_counts()
    out = lp.lean_prefill_fused(*args)
    q_off = torch.tensor([300, 37], dtype=torch.int32, device=cuda)
    o8 = fp.flash_prefill_paged(q, kp, vp, tbl, q_off)
    torch.cuda.synchronize()
    assert (lp.fused_launches, lp.fused_tc_launches) == (1, 1)
    assert _bf16_close(out, lp.lean_prefill_fused_plain(*args))
    ref = fp.flash_prefill_paged_plain(q, kp, vp, tbl, q_off, 1.0 / math.sqrt(d))
    for n, L in enumerate([256, 251]):
        assert _bf16_close(o8[n, :, :L], ref[n, :, :L])


# K7 at gemma3's sliding window and global layers (d 256: the tensor cores
# in bf16, on 64-key tiles), llama-3.2-vision's cross attention (non-causal,
# 1601 image rows) and musicgen's heads; float32 keeps the CUDA cores
ARCH_K7 = [(1, 16, 4, 1500, 1500, 256, True, 1024), (1, 16, 4, 700, 700, 256, True, None),
           (1, 32, 8, 37, 1601, 128, False, None), (1, 32, 32, 300, 300, 64, True, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ARCH_K7)
def test_k7_at_arch_geometries(cuda, case, dtype):
    B, Hq, Hkv, Lq, Lk, d, causal, window = case
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(Lq + d)
    q = torch.randn(B, Hq, Lq, d, generator=gen, device=cuda).to(dt)
    k = torch.randn(B, Hkv, Lk, d, generator=gen, device=cuda).to(dt)
    v = torch.randn(B, Hkv, Lk, d, generator=gen, device=cuda).to(dt)
    fp.reset_launch_counts()
    out = fp.flash_prefill(q, k, v, causal=causal, window=window)
    ref = fp.flash_prefill_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert (fp.dense_launches, fp.dense_tc_launches) == (1, int(dtype == "bfloat16"))
    if dtype == "float32":
        torch.testing.assert_close(out, ref, **TOL)
    else:
        assert _bf16_close(out, ref)


# ------------------------------------------------------------------ f8 K/V
# The f8 forms (bf16 queries, e4m3 rows, no scales) widen each element in
# registers; e4m3 -> bf16 is exact, so each must give its bf16 form's bits
# on the rows widened to bf16, and match its plain version (which widens
# first) at the bf16 form's tolerance.
def _to_f8(*ts):
    from repro_torch.core.attention import F8, to_kv

    return [to_kv(t.bfloat16(), F8) for t in ts]


def _wide(*ts):
    return [t.to(torch.bfloat16) for t in ts]


def _same_bits(a, b):
    """Equal bit for bit, NaN where NaN (a NaN's payload aside)."""
    nan = torch.isnan(a)
    if a.dtype != b.dtype or not torch.equal(nan, torch.isnan(b)):
        return False
    bits = torch.int32 if a.element_size() == 4 else torch.int16
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    return torch.equal(torch.where(nan, zero, a).view(bits), torch.where(nan, zero, b).view(bits))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("page", RING_PAGES)
@pytest.mark.parametrize("rows", [2, 4, 8, 16, 32, 64])
def test_f8_k1_k2_equal_bf16_on_widened_rows(cuda, rows, page, d):
    """K1-f8 and K2-f8 on the ring (every row bucket and page: a 1-byte
    tile always leaves the ring two slots) equal K1/K2 on the widened rows
    bit for bit, and their plain versions within 2e-5."""
    args, _ = _k12_operands(cuda, rows, d, page, "bfloat16", seed=rows + page)
    args[1], args[2] = _to_f8(args[1], args[2])
    wide = list(args)
    wide[1], wide[2] = _wide(args[1], args[2])
    assert ld.ring_slots(args[1].dtype, rows, d, page) >= 2
    before = (ld.fused_ring_launches, ld.partials_ring_launches)
    f8 = ld.lean_decode_fused(*args) + ld.lean_decode_partials(*args)
    torch.cuda.synchronize()
    assert (ld.fused_ring_launches, ld.partials_ring_launches) == (before[0] + 1, before[1] + 1)
    bf = ld.lean_decode_fused(*wide) + ld.lean_decode_partials(*wide)
    assert all(_same_bits(a, b) for a, b in zip(f8, bf))
    for a, b in zip(f8, ld.lean_decode_fused_plain(*args) + ld.lean_decode_partials_plain(*args)):
        torch.testing.assert_close(a, b, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("gq", ld.KERNEL_GQ)
@pytest.mark.parametrize("tile,d", K6_TILES)
@pytest.mark.parametrize("walk", sorted(K6_WALKS))
def test_f8_k6_equals_bf16_on_widened_rows(cuda, gq, tile, d, walk):
    """K6-f8 (the ring only) equals K6 on the widened K/V bit for bit and
    its plain version within 2e-5."""
    args = list(_k6_args(cuda, walk, gq, "bfloat16", tile, d))
    args[1], args[2] = _to_f8(args[1], args[2])
    wide = list(args)
    wide[1], wide[2] = _wide(args[1], args[2])
    before = fd.ring_launches
    out = fd.flash_decode_partials(*args)
    torch.cuda.synchronize()
    assert fd.ring_launches == before + 1
    assert all(_same_bits(a, b) for a, b in zip(out, fd.flash_decode_partials(*wide)))
    for a, b in zip(out, fd.flash_decode_partials_plain(*args)):
        torch.testing.assert_close(a, b, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASCADES))
def test_f8_k5_equals_bf16_on_widened_rows(cuda, case):
    """K5-f8 on the ring equals K5 on the widened rows bit for bit, its
    plain version within 2e-5, and shared pages equal duplicated ones."""
    c = _cascade_problem(cuda, case, torch.bfloat16)
    args = list(_cascade_args(c, c["tbl"]))
    args[2], args[3] = _to_f8(args[2], args[3])
    wide = list(args)
    wide[2], wide[3] = _wide(args[2], args[3])
    before = ld.cascade_ring_launches
    o, lse = ld.lean_cascade_fused(*args)
    torch.cuda.synchronize()
    assert ld.cascade_ring_launches == before + 1
    ow, lsew = ld.lean_cascade_fused(*wide)
    assert _same_bits(o, ow) and _same_bits(lse, lsew)
    o_ref, lse_ref = ld.lean_cascade_fused_plain(*args)
    torch.testing.assert_close(o, o_ref, **TOL)
    torch.testing.assert_close(lse, lse_ref, **TOL)
    dup = list(_cascade_args(c, c["dup"]))
    dup[2], dup[3] = _to_f8(dup[2], dup[3])
    o3, lse3 = ld.lean_cascade_fused(*dup)
    assert torch.equal(o, o3) and torch.equal(lse, lse3)


@pytest.mark.cuda
@pytest.mark.parametrize("page,C", FUSED_CASES)
def test_f8_fused_k4_equals_bf16_on_widened_rows(cuda, page, C):
    """The fused K4-f8 (tensor cores where the path rule says, staged and
    widened by the producer warpgroup; CUDA cores elsewhere) equals the
    fused K4 on the widened rows bit for bit, and its plain version within
    one bf16 step of the output plus 2e-5."""
    args, _, _ = _fused_operands(cuda, page, C, "bfloat16")
    args = list(args)
    args[1], args[2] = _to_f8(args[1], args[2])
    wide = list(args)
    wide[1], wide[2] = _wide(args[1], args[2])
    tc = fp.tensor_core_path(args[0].dtype, args[0].shape[2], page)
    lp.reset_launch_counts()
    out = lp.lean_prefill_fused(*args)
    torch.cuda.synchronize()
    assert (lp.fused_launches, lp.fused_tc_launches) == (1, int(tc))
    assert _same_bits(out, lp.lean_prefill_fused(*wide))
    assert _bf16_close(out, lp.lean_prefill_fused_plain(*args))
    parts = lp.lean_prefill_chunk_partials(*args)
    for a, b in zip(parts, lp.lean_prefill_chunk_partials(*wide)):
        assert _same_bits(a, b)


# K8's cases: the tensor-core ones, and pages of 12 and 100 (the CUDA cores)
K8_F8_CASES = K8_TC_CASES + [(8, 2, 128, 12, (50, 3), 40), (8, 2, 64, 100, (150, 0), 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", K8_F8_CASES)
def test_f8_k8_equals_bf16_on_widened_pools(cuda, case):
    """K8-f8 equals K8 on the widened pools bit for bit (rows past each
    chunk's last position NaN in both: keys no row sees add nothing) and
    its plain version within one bf16 step plus 2e-5; the counters follow
    the path rule."""
    Hq, Hkv, d, page, offs, C = case
    q, kp, vp, tbl = _chunk_operands(cuda, list(offs), [C] * len(offs), Hq, Hkv, d, page,
                                     torch.bfloat16, seed=page)
    q_off = torch.tensor(offs, dtype=torch.int32, device=cuda)
    kf, vf = _to_f8(kp, vp)
    tc = fp.tensor_core_path(q.dtype, d, page)
    before = (fp.launches, fp.tc_launches)
    out = fp.flash_prefill_paged(q, kf, vf, tbl, q_off)
    torch.cuda.synchronize()
    assert (fp.launches, fp.tc_launches) == (before[0] + 1, before[1] + int(tc))
    assert _same_bits(out, fp.flash_prefill_paged(q, *_wide(kf, vf), tbl, q_off))
    assert _bf16_close(out, fp.flash_prefill_paged_plain(q, kf, vf, tbl, q_off,
                                                         1.0 / math.sqrt(d)))


@pytest.mark.cuda
def test_f8_nan_element_reads_as_in_bf16(cuda):
    """The guards' NaN contract on f8 pages: one NaN element in a page (e4m3
    code 0x7f) gives K2-f8 and the fused K4-f8 the output the bf16 kernels
    give with the same element NaN -- the victim's rows NaN, every other
    row finite and equal."""
    from repro_torch.core.attention import F8

    args, _ = _k12_operands(cuda, 4, 128, 128, "bfloat16", seed=5)
    args[1], args[2] = _to_f8(args[1], args[2])
    row = int(args[4][0])                       # the pool row of column 0
    args[1].view(torch.uint8)[row, 3, 7] = 0x7F
    wide = list(args)
    wide[1], wide[2] = _wide(args[1], args[2])
    o, lse = ld.lean_decode_fused(*args)
    ow, lsew = ld.lean_decode_fused(*wide)
    torch.cuda.synchronize()
    assert bool(torch.isnan(o).any()) and bool(torch.isfinite(o).any())
    assert _same_bits(o, ow) and _same_bits(lse, lsew)
    fargs, _, _ = _fused_operands(cuda, 128, 256, "bfloat16", seed=5)
    fargs = list(fargs)
    fargs[1], fargs[2] = _to_f8(fargs[1], fargs[2])
    fargs[2].view(torch.uint8)[int(fargs[5][0]), 5, 3] = 0x7F
    fwide = list(fargs)
    fwide[1], fwide[2] = _wide(fargs[1], fargs[2])
    out = lp.lean_prefill_fused(*fargs)
    assert bool(torch.isnan(out).any()) and bool(torch.isfinite(out).any())
    assert _same_bits(out, lp.lean_prefill_fused(*fwide))
    assert fargs[1].dtype == F8


@pytest.mark.cuda
def test_f8_cast_on_card_gives_cpu_codes(cuda):
    """``to_kv`` on the card gives the CPU's e4m3 codes (JAX's: NaN above
    464) from bf16 and float32, on every bf16 bit pattern and a sweep of
    float32 values."""
    from repro_torch.core.attention import F8, to_kv

    bf = torch.arange(-2**15, 2**15, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    f32 = torch.cat([torch.randn(200_000, generator=gen) * s for s in (1e-3, 1.0, 30.0, 300.0)])
    for x in (bf, f32):
        cpu = to_kv(x, F8).view(torch.uint8)
        card = to_kv(x.to(cuda), F8).view(torch.uint8).cpu()
        assert torch.equal(cpu, card)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["lean", "fixed"])
def test_f8_engine_on_card_matches_cpu(cuda, backend):
    """The smoke-config f8 engine under the Scheduler with chunked prefill
    on the card (fused K4-f8 / K2-f8 on ``lean``, K8-f8 / K6-f8 on
    ``fixed``) against the same on the CPU: every request served, each f8
    kernel launched once per layer and step, the pools' e4m3 codes after
    the first step within one e4m3 step of the CPU's (bf16 GEMMs round in
    another order on the card)."""
    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.serving.config import EngineConfig, PagedConfig
    from repro_torch.serving.engine import DecodeEngine
    from repro_torch.serving.scheduler import Scheduler, SchedulerConfig

    cfg = get_smoke_config("mistral-nemo-12b")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    first = {}
    for dev in ("cpu", "cuda"):
        p = {k: v.to(dev) if torch.is_tensor(v) else v for k, v in params.items()}
        p["layers"] = [{k: ({kk: vv.to(dev) for kk, vv in v.items()} if isinstance(v, dict)
                            else v.to(dev)) for k, v in layer.items()}
                       for layer in params["layers"]]
        eng = DecodeEngine(cfg, p, EngineConfig(
            max_batch=2, cache_len=64, num_workers=8, attn_backend=backend,
            paged=PagedConfig(enabled=True, page_size=16, kv_dtype="f8")), device=dev)
        assert eng.cache[0]["k"].dtype == torch.float8_e4m3fn
        sch = Scheduler(eng, SchedulerConfig(chunk_size=8, prefill_pack=2, token_budget=16))
        rng = np.random.default_rng(0)
        hs = [sch.submit(rng.integers(0, cfg.vocab_size, 8 + 7 * i), 6, uid=i)
              for i in range(4)]
        for m in (ld, lp, fd, fp):
            m.reset_launch_counts()
        sch.step()
        first[dev] = [lc["k"][1:].float().cpu().clone() for lc in eng.cache]
        sch.run_to_completion(max_steps=400)
        assert all(h.done and len(h.generated) == 6 for h in hs)
        eng.pool.check()
        assert eng.pool.num_allocated == 0
        if dev == "cuda":
            chunk_steps, ticks = len(eng.stats.tick_prefill_tokens), eng.stats.ticks
            chunk_k, decode_k = (lp.fused_launches, ld.fused_launches) if backend == "lean" \
                else (fp.launches, fd.launches)
            assert chunk_k == cfg.n_layers * chunk_steps > 0
            assert decode_k == cfg.n_layers * ticks > 0
    for a, b in zip(first["cuda"], first["cpu"]):
        torch.testing.assert_close(a, b, rtol=2**-3, atol=2**-9)
