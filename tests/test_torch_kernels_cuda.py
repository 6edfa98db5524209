"""The CUDA kernels K1, K2, K4, K6 and K8 against their plain PyTorch
versions, on the card. Marked ``cuda``: they skip where there is no CUDA
card and run on the card with

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

They cover what ``chip_smoke.py`` does not: every query-group width the
kernels are instantiated for, float32 and bf16, other tile, head and chunk
sizes, and grids of more workers than SMs. Tolerance 2e-5: kernel and plain
version both compute in float32 from the same inputs (K8's bf16 output:
one bf16 step plus 2e-5, since both round a float32 result).
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
    route = ops._paged_route(sched, tbl.to(dev), Hkv)
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
def test_wrapper_refuses_what_the_kernel_cannot_take(cuda):
    args = _operands(cuda, [40], 3, 1, 32, 16, 4, torch.float32)
    with pytest.raises(ValueError, match="gq"):
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
            seg_qs, ops._paged_route(sched, tbl, Hkv), sched, 1.0 / math.sqrt(d), C)
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gq", ld.KERNEL_GQ)
@pytest.mark.parametrize("lens,splits", [([300, 1, 77, 0], None), ([2000, 513, 1], 1),
                                         ([40, 9], 9)])
def test_fixed_split_kernel_matches_plain(cuda, gq, dtype, lens, splits):
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    Hkv, d, tile = 2, 64, 16
    S = Hkv * len(lens)
    s_pad = -(-max(lens) // tile) * tile
    splits = splits or fixed_split_factor(max(lens), S, tile, 132)
    q = torch.randn(S, gq, d, generator=gen, device=cuda).to(dt)
    k = torch.randn(S, s_pad, d, generator=gen, device=cuda).to(dt)
    v = torch.randn(S, s_pad, d, generator=gen, device=cuda).to(dt)
    seg = torch.tensor([L for L in lens for _ in range(Hkv)], dtype=torch.int32, device=cuda)
    args = (q, k, v, seg, splits, tile, 1.0 / math.sqrt(d))
    before = fd.launches
    out = fd.flash_decode_partials(*args)
    torch.cuda.synchronize()
    assert fd.launches == before + 1
    for a, b in zip(out, fd.flash_decode_partials_plain(*args)):
        torch.testing.assert_close(a, b, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["lean", "fixed"])
def test_scheduler_on_card_runs_the_kernels(cuda, backend):
    """The smoke-config scheduler on the card: every request served, pool
    clean, the chunk kernel (K4 or K8) launched once per layer and chunk
    step and the decode kernel (K2 or K6) once per layer and decode tick."""
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
    chunk_k, decode_k = (lp.launches, ld.fused_launches) if backend == "lean" else (
        fp.launches, fd.launches)
    assert chunk_k == cfg.n_layers * chunk_steps > 0
    assert decode_k == cfg.n_layers * ticks > 0
