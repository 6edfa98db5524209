"""The CUDA kernels K1 and K2 against their plain PyTorch versions, on the
card. Marked ``cuda``: they skip where there is no CUDA card (this CPU
sandbox) and run on the card with

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

They cover what ``chip_smoke.py`` does not: every query-group width the
kernels are instantiated for, float32 and bf16, other tile and head sizes,
and grids of more workers than SMs. Tolerance 2e-5: kernel and plain
version both compute in float32 from the same inputs.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.leantile import make_schedule  # noqa: E402
from repro_torch.kernels import lean_decode as ld  # noqa: E402
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
