"""The port's paged serving engine against the JAX engine on the smoke
configuration (mirrors tests/test_paged_engine.py:21-60): same weights,
same requests, blocking admission, lean backend with max_batch=2,
cache_len=32, num_workers=4, page_size=8.

Greedy streams must be equal. Where one differs, the test fails unless the
JAX logits at the first differing step have a top-2 gap below
``NEAR_TIE``: the port matches the reference's bf16 rounding op for op, so
only float32 summation order separates them, and that can flip an argmax
only between near-tied logits (one bf16 step of unit-scale logits).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.serving.config import EngineConfig as JConfig, PagedConfig as JPaged  # noqa: E402
from repro.serving.engine import DecodeEngine as JEngine, Request as JRequest  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.serving.config import CascadeConfig, EngineConfig, PagedConfig  # noqa: E402
from repro_torch.serving.engine import DecodeEngine, PoisonError, Request  # noqa: E402

NEAR_TIE = 2**-7


class _RecordingJaxEngine(JEngine):
    """The JAX engine, recording the logits row behind every generated
    token (admission prefill or decode tick), per request, in order."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.rows = {}
        self._prefill_row = None

    def _run_prompt_prefill(self, prompt):
        logits, cache1 = super()._run_prompt_prefill(prompt)
        self._prefill_row = np.asarray(logits[0])
        return logits, cache1

    def _admit_blocking_inner(self, req, slot):
        ok = super()._admit_blocking_inner(req, slot)
        if ok:
            self.rows.setdefault(req.uid, []).append(self._prefill_row)
        return ok

    def _decode_pass_main(self, active, ctx_np, ptbl_np):
        logits = super()._decode_pass_main(active, ctx_np, ptbl_np)
        lg = np.asarray(logits)
        for s in active:
            self.rows.setdefault(self.slot_req[s].uid, []).append(lg[s])
        return logits


@pytest.fixture(scope="module")
def model():
    cfg_j = jax_smoke("mistral-nemo-12b")
    cfg = get_smoke_config("mistral-nemo-12b")
    pj = jinit(jax.random.PRNGKey(0), cfg_j)
    return cfg_j, cfg, pj, params_from_numpy(jax.tree.map(np.asarray, pj), cfg, device="cpu")


def _requests(R, vocab, n=3, seed=0, plen=lambda i: 8 + 7 * i, new=4):
    rng = np.random.default_rng(seed)
    return [R(uid=i, prompt=rng.integers(0, vocab, plen(i)), max_new_tokens=new)
            for i in range(n)]


SMALL = dict(max_batch=2, cache_len=32, num_workers=4)


def _run_jax(model, backend, num_pages=None, **req_kw):
    cfg_j, _, pj, _ = model
    reqs = _requests(JRequest, cfg_j.vocab_size, **req_kw)
    eng = _RecordingJaxEngine(cfg_j, pj, JConfig(
        attn_backend=backend, paged=JPaged(enabled=True, page_size=8, num_pages=num_pages),
        **SMALL))
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion(max_ticks=80)
    return eng, reqs


def _run_port(model, backend, fused=True, num_pages=None, **req_kw):
    _, cfg, _, pt = model
    reqs = _requests(Request, cfg.vocab_size, **req_kw)
    eng = DecodeEngine(cfg, pt, EngineConfig(
        attn_backend=backend, fused=fused,
        paged=PagedConfig(enabled=True, page_size=8, num_pages=num_pages), **SMALL),
        device="cpu")
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion(max_ticks=80)
    return eng, reqs


def _assert_streams_match(port_reqs, jax_eng, jax_reqs, what):
    for rp, rj in zip(port_reqs, jax_reqs):
        a, b = list(rp.generated), list(rj.generated)
        if a == b:
            continue
        k = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        row = np.sort(jax_eng.rows[rj.uid][k])
        gap = float(row[-1] - row[-2])
        assert gap < NEAR_TIE, (
            f"{what}: request {rp.uid} diverges at token {k} ({a} vs {b}); the "
            f"JAX top-2 logit gap there is {gap:.4g}, not a near tie (< {NEAR_TIE})"
        )


@pytest.fixture(scope="module")
def jax_runs(model):
    return {backend: _run_jax(model, backend) for backend in ("lean", "ref")}


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("against", ["lean", "ref"])
def test_lean_streams_match_jax(model, jax_runs, fused, against):
    eng, reqs = _run_port(model, "lean", fused=fused)
    jeng, jreqs = jax_runs[against]
    _assert_streams_match(reqs, jeng, jreqs, f"port lean (fused={fused}) vs JAX {against}")
    assert all(r.done for r in reqs)
    eng.pool.check()
    assert eng.pool.num_allocated == 0
    assert eng.stats.ticks == jeng.stats.ticks
    assert eng.stats.schedules == jeng.stats.schedules


def test_ref_streams_match_jax(model, jax_runs):
    eng, reqs = _run_port(model, "ref")
    jeng, jreqs = jax_runs["ref"]
    _assert_streams_match(reqs, jeng, jreqs, "port ref vs JAX ref")
    eng.pool.check()
    assert eng.pool.num_allocated == 0


def test_undersized_pool_preempts_like_jax(model):
    """4 usable pages of 8 tokens for 3 requests of 8/15/22 prompt tokens
    and 8 new tokens each: the pool fills, slots preempt and resume by
    recompute, and the port does so exactly when the reference does."""
    kw = dict(num_pages=5, new=8)
    jeng, jreqs = _run_jax(model, "lean", **kw)
    eng, reqs = _run_port(model, "lean", **kw)
    assert eng.stats.preemptions > 0
    assert eng.stats.preemptions == jeng.stats.preemptions
    _assert_streams_match(reqs, jeng, jreqs, "port vs JAX, undersized pool")
    assert all(r.done for r in reqs)
    eng.pool.check()
    assert eng.pool.num_allocated == 0


def test_unservable_request_is_refused(model):
    _, cfg, _, pt = model
    eng = DecodeEngine(cfg, pt, EngineConfig(
        paged=PagedConfig(enabled=True, page_size=8, num_pages=3), **SMALL), device="cpu")
    eng.submit(Request(uid=0, prompt=np.zeros(20, np.int64), max_new_tokens=2))
    with pytest.raises(PoisonError, match="usable pages"):
        eng.run_to_completion(max_ticks=4)


@pytest.mark.parametrize("change", [
    dict(paged=PagedConfig(enabled=False)),
    dict(cascade=CascadeConfig(enabled=True)),
    dict(use_fast_path=False),
    dict(paged=PagedConfig(enabled=True, kv_dtype="int8")),
    dict(paged=PagedConfig(enabled=True, prefix_cache=True)),
])
def test_unported_configurations_raise(model, change):
    _, cfg, _, pt = model
    kw = dict(paged=PagedConfig(enabled=True, page_size=8))
    kw.update(change)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DecodeEngine(cfg, pt, EngineConfig(**kw), device="cpu")
