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
from repro_torch.obs import MetricsRegistry, Tracer  # noqa: E402
from repro_torch.serving.config import EngineConfig, ObsConfig, PagedConfig  # noqa: E402
from repro_torch.serving.engine import DecodeEngine, PoisonError, Request  # noqa: E402
from repro_torch.serving.faults import FaultInjector, FaultSpec  # noqa: E402
from repro_torch.serving.guards import GuardConfig  # noqa: E402

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


# the prefix cache and cascade decode, once cases 1 and 4, are ported
# (tests/test_torch_cascade.py), and so are the dense-cache engine and
# use_fast_path=False, once cases 1 and 3 (tests/test_torch_dense_engine.py;
# with a paged engine use_fast_path=False is now the reference's
# ValueError). Speculative decode, once case 2, is ported too
# (tests/test_torch_speculative.py). The observability sinks, once two cases
# here, are ported: test_observability_sinks_serve. Guards and fault
# injection, once two cases here, are ported: test_guards_require_paged and
# test_guards_and_faults_serve (tests/test_torch_chaos.py holds them against
# the JAX engine). f8, f16 and f32 pools, once this case, are ported
# (tests/test_torch_f8_kv.py): what is left is a KV dtype the reference does
# not know, which both engines refuse with its KVLayout's ValueError.
@pytest.mark.parametrize("change", [
    dict(paged=PagedConfig(enabled=True, kv_dtype="fp4")),
])
def test_unported_configurations_raise(model, change):
    cfg_j, cfg, pj, pt = model
    kw = dict(paged=PagedConfig(enabled=True, page_size=8))
    kw.update(change)
    with pytest.raises(ValueError, match="unknown kv_dtype"):
        DecodeEngine(cfg, pt, EngineConfig(**kw), device="cpu")
    with pytest.raises(ValueError, match="unknown kv_dtype"):
        JEngine(cfg_j, pj, JConfig(paged=JPaged(enabled=True, page_size=8,
                                                kv_dtype=change["paged"].kv_dtype)))
    f8 = DecodeEngine(cfg, pt, EngineConfig(paged=PagedConfig(enabled=True, page_size=8,
                                                              kv_dtype="f8")), device="cpu")
    assert f8.cache[0]["k"].dtype == torch.float8_e4m3fn


def test_guards_require_paged(model):
    """tests/test_guards.py:test_guards_require_paged on the port."""
    _, cfg, _, pt = model
    with pytest.raises(ValueError, match="require paged"):
        DecodeEngine(cfg, pt, EngineConfig(max_batch=2, cache_len=32, guards=GuardConfig()),
                     device="cpu")


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_guards_and_faults_serve(model, kv_dtype):
    """A guarded engine with an injector that fires: every request
    finishes, the guard counters move, the audits pass (int8: with the
    scales) and the pool drains."""
    _, cfg, _, pt = model
    inj = FaultInjector({"nan_output": FaultSpec(rate=1.0, start=2, stop=4)}, seed=9)
    eng = DecodeEngine(cfg, pt, EngineConfig(
        paged=PagedConfig(enabled=True, page_size=8, kv_dtype=kv_dtype), faults=inj,
        guards=GuardConfig(heal_after=2, audit_interval=2), **SMALL), device="cpu")
    reqs = _requests(Request, cfg.vocab_size, new=6)
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion(max_ticks=80)
    assert all(r.done for r in reqs)
    assert inj.fires["nan_output"] == 2 and eng.stats.nan_ticks == 2
    assert eng.stats.degrade_escalations >= 1 and eng.stats.audits_run > 0
    assert eng.stats.audit_failures == 0 and eng.degraded_gauge.value == 0
    assert eng.stats.faults["points"]["nan_output"]["fires"] == 2
    eng.pool.check(scales=eng._kv_scale_arrays())
    assert eng.pool.num_allocated == 0


@pytest.mark.parametrize("sink", ["metrics", "tracer"])
def test_observability_sinks_serve(model, sink):
    """A metrics registry or a tracer given to the engine: it serves, the
    registry holds the engine's counters, the tracer one ``tick`` span per
    tick with a ``decode_kernel`` span carrying the schedule's cost."""
    _, cfg, _, pt = model
    obj = MetricsRegistry() if sink == "metrics" else Tracer()
    eng = DecodeEngine(cfg, pt, EngineConfig(
        paged=PagedConfig(enabled=True, page_size=8), obs=ObsConfig(**{sink: obj}), **SMALL),
        device="cpu")
    reqs = [Request(uid=i, prompt=np.arange(5 + 3 * i) % cfg.vocab_size, max_new_tokens=3)
            for i in range(2)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion(max_ticks=20)
    assert all(r.done for r in reqs)
    if sink == "metrics":
        assert eng.metrics is obj and eng.tracer.spans == []
        d = obj.as_dict()
        assert d["engine_ticks"] == eng.stats.ticks > 0 and d["engine_prefills"] == 2
        assert d["kvpool_pages_in_use"] == eng.pool.num_allocated == 0
    else:
        assert eng.tracer is obj
        names = [s["name"] for s in obj.spans]
        assert names.count("tick") == names.count("decode_kernel") == eng.stats.ticks
        assert names.count("admit") == 2
        dk = [s for s in obj.spans if s["name"] == "decode_kernel"]
        assert all(s["meta"]["path"] == "fast" and s["meta"]["kv_bytes"] > 0 for s in dk)
