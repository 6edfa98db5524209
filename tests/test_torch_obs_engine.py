"""The port's observability wiring against the JAX package's on the CPU: the
traced Scheduler workload of tests/test_obs.py:297 (smoke config, lean,
paged, page 8, ``SchedulerConfig(chunk_size=8, prefill_pack=2,
token_budget=16)``) served by both engines on the same weights
(``params_from_numpy``) with a ``Tracer`` and a perf watchdog holding one
SLO class, and held span for span, event for event and counter for
counter. None of these depends on the tokens sampled, so near-ties between
the two engines do not enter.

The roofline cost meta on each ``decode_kernel`` span agrees in bytes,
flops and tiles; its predicted times differ by the ratio of the two
packages' peaks (TPU v5e against the H100), exactly.

The rest (untraced engines, the blocking, speculative, cascade and
preemption spans and events, the flight recorder) runs on the port alone.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.obs.trace import Tracer as JTracer  # noqa: E402
from repro.obs.watch import PerfWatchdog as JWatchdog, SLOConfig as JSLO  # noqa: E402
from repro.roofline import analysis as jroof  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro.serving.config import EngineConfig as JConfig, ObsConfig as JObs  # noqa: E402
from repro.serving.config import PagedConfig as JPaged  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    NULL_TRACER, FlightRecorder, MetricsRegistry, PerfWatchdog, SLOConfig, Tracer,
    load_flight_dump, parse_prometheus,
)
from repro_torch.roofline import analysis as troof  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402
from repro_torch.serving.config import (  # noqa: E402
    CascadeConfig, EngineConfig, ObsConfig, PagedConfig, SpecConfig,
)

ENGINE = dict(max_batch=2, cache_len=64, num_workers=4, attn_backend="lean")
SCHED = dict(chunk_size=8, prefill_pack=2, token_budget=16)
# targets no CPU run misses (the JAX engine's first ticks compile): the
# budgets then count the same observations and no breach on both sides
SLO = dict(name="interactive", ttft_target_s=600.0, tpot_target_s=600.0, budget=0.05)
COST_KEYS = ("kv_tokens", "kv_bytes", "tile_kv_bytes", "flops", "total_tiles",
             "num_segments", "num_pieces")


@pytest.fixture(scope="module")
def model():
    cfg_j = jax_smoke("mistral-nemo-12b")
    cfg = get_smoke_config("mistral-nemo-12b")
    pj = jinit(jax.random.PRNGKey(0), cfg_j)
    return cfg_j, cfg, pj, params_from_numpy(jax.tree.map(np.asarray, pj), cfg, device="cpu")


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, 6 + 3 * i) for i in range(3)]


def _serve(model, side, traced=True):
    """tests/test_obs.py:297's workload on ``side``'s engine, with a tracer
    (``traced``) and a watchdog holding the SLO class ``SLO``; each request
    submitted in that class."""
    cfg_j, cfg, pj, pt = model
    if side == "jax":
        obs = JObs(tracer=JTracer()) if traced else JObs()
        eng = jengine.DecodeEngine(cfg_j, pj, JConfig(paged=JPaged(enabled=True, page_size=8),
                                                      obs=obs, **ENGINE))
        JWatchdog(eng, slos=[JSLO(**SLO)])
        sch = jsched.Scheduler(eng, jsched.SchedulerConfig(**SCHED))
    else:
        obs = ObsConfig(tracer=Tracer()) if traced else ObsConfig()
        eng = tengine.DecodeEngine(cfg, pt, EngineConfig(paged=PagedConfig(enabled=True,
                                                                           page_size=8),
                                                         obs=obs, **ENGINE), device="cpu")
        PerfWatchdog(eng, slos=[SLOConfig(**SLO)])
        sch = tsched.Scheduler(eng, tsched.SchedulerConfig(**SCHED))
    hs = [sch.submit(p, 3, slo_class=SLO["name"]) for p in _prompts(cfg.vocab_size)]
    sch.run_to_completion(max_steps=100)
    assert all(h.done for h in hs)
    return eng, sch, hs


@pytest.fixture(scope="module")
def served(model):
    return {side: _serve(model, side) for side in ("jax", "port")}


def _names_by_tick(tracer):
    out = {}
    for sp in tracer.spans:
        out.setdefault(sp["tick"], []).append((sp["name"], sp["depth"]))
    return out


def test_span_names_per_tick_match_jax(served):
    j, t = served["jax"][0].tracer, served["port"][0].tracer
    assert _names_by_tick(t) == _names_by_tick(j)
    assert t.tick_index == j.tick_index > 0
    names = {s["name"] for s in t.spans}
    assert {"tick", "prefill_chunk", "schedule_build", "decode_kernel"} <= names
    # annotations other than timings: the schedules' work summaries, the
    # chunk packs, the decode passes' path, level and slots
    meta = lambda tr: [(s["name"], {k: v for k, v in (s.get("meta") or {}).items()
                                    if not k.startswith("pred_")}) for s in tr.spans]
    assert meta(t) == meta(j)


def test_request_events_match_jax(served):
    (je, _, jh), (te, _, th) = served["jax"], served["port"]
    assert [h.uid for h in th] == [h.uid for h in jh]
    for h in th:
        ev = lambda tr: [(e["state"], e["tick"], e.get("meta"))
                         for e in tr.request_summary(h.uid)["events"]]
        assert ev(te.tracer) == ev(je.tracer)
        assert [e[0] for e in ev(te.tracer)] == ["QUEUED", "PREFILLING", "DECODING",
                                                  "FIRST_TOKEN", "FINISHED"]
        s = te.tracer.request_summary(h.uid)
        assert s["tokens"] == len(h.generated) == 3 and s["tpot_s"]["gaps"] == 2
        assert s["ttft_s"] >= s["queue_wait_s"] >= 0


def test_engine_counters_match_jax(served):
    (je, jsch, _), (te, tsch, _) = served["jax"], served["port"]
    jd, td = je.metrics.as_dict(), te.metrics.as_dict()
    for name in jengine._STAT_COUNTERS:
        assert td[f"engine_{name}"] == jd[f"engine_{name}"], name
    # the port's capture counters: no step is captured on the CPU
    for kind in tengine.STEP_KINDS:
        assert td[f"engine_{kind}_captures"] == td[f"engine_{kind}_replays"] == 0
    assert td["engine_ticks"] == te.stats.ticks > 0
    for name in ("engine_ttft_seconds", "engine_tpot_seconds", "engine_queue_wait_seconds"):
        assert td[name]["count"] == jd[name]["count"] > 0
    for name in ("scheduler_queue_depth", "scheduler_active_slots", "scheduler_pending",
                 "kvpool_pages_in_use", "kvpool_live_sequences", "engine_degraded_slots",
                 "schedule_cache_hit_rate"):
        assert td[name] == jd[name], name
    prom = parse_prometheus(te.metrics.to_prometheus())
    assert prom[("engine_ticks", ())] == te.stats.ticks
    assert prom[("engine_ttft_seconds_count", ())] == 3
    # Scheduler.telemetry(): the same snapshot, the latency histograms
    # aside (wall clock)
    drop = ("ttft", "tpot", "queue_wait")
    tt, jt = tsch.telemetry(), jsch.telemetry()
    assert {k: v for k, v in tt.items() if k not in drop} == \
        {k: v for k, v in jt.items() if k not in drop}
    assert tt["slo"]["interactive"]["events"] == 3 + 3 * 2
    assert tt["watchdog"]["total_fires"] == 0


def test_decode_kernel_cost_meta_matches_jax(served):
    j = [s for s in served["jax"][0].tracer.spans if s["name"] == "decode_kernel"]
    t = [s for s in served["port"][0].tracer.spans if s["name"] == "decode_kernel"]
    assert len(t) == len(j) > 0
    for a, b in zip(t, j):
        assert "sync_ms" in a
        for k in COST_KEYS + ("path", "level", "slots"):
            assert a["meta"][k] == b["meta"][k], k
        mem = jroof.HBM_BW / troof.HBM_BW
        cmp = jroof.PEAK_FLOPS / troof.PEAK_FLOPS
        assert a["meta"]["pred_mem_ms"] == pytest.approx(b["meta"]["pred_mem_ms"] * mem,
                                                         rel=1e-12)
        assert a["meta"]["pred_compute_ms"] == pytest.approx(
            b["meta"]["pred_compute_ms"] * cmp, rel=1e-12)


def test_untraced_engine_records_nothing(model):
    eng, sch, hs = _serve(model, "port", traced=False)
    assert eng.tracer is NULL_TRACER
    assert eng.tracer.spans == [] and eng.tracer.request_uids() == []
    # the registry, the flight recorder and the watchdog stay on
    assert eng.metrics.as_dict()["engine_ticks"] == eng.stats.ticks > 0
    assert eng.stats.ttft.count == len(hs)
    assert [e["kind"] for e in eng.flight.events()].count("tick") == eng.stats.ticks
    assert sch.telemetry()["slo"]["interactive"]["events"] == 3 + 3 * 2


def _port(model, **kw):
    _, cfg, _, pt = model
    return tengine.DecodeEngine(cfg, pt, EngineConfig(**{**ENGINE, **kw}), device="cpu")


def test_every_obs_sink_serves_and_dumps(model, tmp_path):
    """Every ``ObsConfig`` sink at once, blocking admission: the ``admit``
    spans, the flight recorder's ring and dump directory, and the CLI's
    renderers on what it wrote."""
    from repro_torch.obs.__main__ import main as cli

    reg, fr = MetricsRegistry(), FlightRecorder()
    eng = _port(model, paged=PagedConfig(enabled=True, page_size=8),
                obs=ObsConfig(tracer=Tracer(), metrics=reg, flight=fr,
                              flight_dir=str(tmp_path / "fl"), watchdog=True))
    assert eng.metrics is reg and eng.flight is fr and eng.watchdog is not None
    assert fr.dump_dir == str(tmp_path / "fl")
    sch = tsched.Scheduler(eng, tsched.SchedulerConfig(chunked=False))
    hs = [sch.submit(p, 3) for p in _prompts(eng.cfg.vocab_size)]
    sch.run_to_completion(max_steps=50)
    assert all(h.done for h in hs)
    admits = [s for s in eng.tracer.spans if s["name"] == "admit"]
    assert sorted(s["meta"]["uid"] for s in admits) == [0, 1, 2]
    assert reg.as_dict()["engine_prefills"] == 3
    eng._flight_dump("check")
    dump = load_flight_dump(fr.last_dump_path)
    assert dump["reason"] == "check" and dump["events"][-1]["kind"] == "tick"
    trace = tmp_path / "trace.json"
    eng.tracer.save(trace, extra={"metrics": reg.as_dict(),
                                  "watchdog": eng.watchdog.as_dict()})
    calib = tmp_path / "calib.json"
    assert cli(["report", str(trace)]) == 0
    assert cli(["calibrate", str(trace), "--out", str(calib)]) == 0
    assert json.loads(calib.read_text())["samples"]["fast"] == eng.stats.ticks
    assert cli(["report", str(trace), "--calib", str(calib)]) == 0
    assert cli(["flight", fr.last_dump_path]) == 0
    assert cli(["report", str(tmp_path / "missing.json")]) == 2


def test_preemption_is_recorded(model):
    """An undersized pool preempts: the flight recorder's ``preempt`` event
    and the tracer's requeue and PREEMPTED events (in the reference's
    order: the scheduler requeues the request inside the engine's
    preemption, which records PREEMPTED last)."""
    eng = _port(model, paged=PagedConfig(enabled=True, page_size=8, num_pages=6),
                obs=ObsConfig(tracer=Tracer()))
    sch = tsched.Scheduler(eng, tsched.SchedulerConfig(**SCHED))
    rng = np.random.default_rng(3)
    hs = [sch.submit(rng.integers(0, eng.cfg.vocab_size, 12), 14) for _ in range(2)]
    sch.run_to_completion(max_steps=200)
    assert all(h.done for h in hs) and eng.stats.preemptions > 0
    kinds = [e["kind"] for e in eng.flight.events()]
    assert kinds.count("preempt") == eng.stats.preemptions
    events = [e for h in hs for e in eng.tracer.request_summary(h.uid)["events"]]
    states = [e["state"] for e in events]
    assert states.count("PREEMPTED") == eng.stats.preemptions
    i = states.index("PREEMPTED")
    assert states[i - 1] == "QUEUED" and events[i - 1]["meta"]["requeue"]
    assert states[i + 1] == "PREFILLING"


def test_spec_and_cascade_spans(model):
    """The ``spec_verify`` span of speculative decode, and the
    ``cascade_group`` span with the cascade path's cost meta."""
    eng = _port(model, paged=PagedConfig(enabled=True, page_size=8),
                spec=SpecConfig(enabled=True, k=2), obs=ObsConfig(tracer=Tracer()))
    sch = tsched.Scheduler(eng, tsched.SchedulerConfig(**SCHED))
    sch.submit(np.tile(np.arange(5), 4), 8)
    sch.run_to_completion(max_steps=50)
    sv = [s for s in eng.tracer.spans if s["name"] == "spec_verify"]
    assert len(sv) == eng.stats.spec_ticks > 0
    assert all("sync_ms" in s and s["meta"]["rows"] == 3 for s in sv)

    eng = _port(model, max_batch=3, paged=PagedConfig(enabled=True, page_size=8,
                                                      prefix_cache=True),
                cascade=CascadeConfig(enabled=True, stable_ticks=1),
                obs=ObsConfig(tracer=Tracer()))
    sch = tsched.Scheduler(eng, tsched.SchedulerConfig(**SCHED))
    prefix = np.random.default_rng(4).integers(0, eng.cfg.vocab_size, 24)
    sch.submit(prefix, 2)
    sch.run_to_completion(max_steps=50)
    for i in range(2):
        sch.submit(np.concatenate([prefix, [i + 1, i + 2]]), 6)
    sch.run_to_completion(max_steps=100)
    assert eng.stats.cascade_ticks > 0
    names = [s["name"] for s in eng.tracer.spans]
    assert names.count("cascade_group") >= eng.stats.cascade_ticks
    paths = [s["meta"]["path"] for s in eng.tracer.spans if s["name"] == "decode_kernel"]
    assert paths.count("cascade") == eng.stats.cascade_ticks
    assert eng.metrics.as_dict()["prefix_cache_hit_rate"] > 0


def test_schedule_costs_go_with_their_schedules(model):
    """The ``decode_kernel`` cost meta is memoized per schedule; a schedule
    the cache evicts takes its entry along, so no dead schedule stays
    alive in the memo."""
    eng = _port(model, schedule_cache_entries=2, paged=PagedConfig(enabled=True, page_size=8),
                obs=ObsConfig(tracer=Tracer()))
    sch = tsched.Scheduler(eng, tsched.SchedulerConfig(**SCHED))
    for p in _prompts(eng.cfg.vocab_size):
        sch.submit(p, 6)
    sch.run_to_completion(max_steps=100)
    assert eng.sched_cache.stats.evictions > 0
    live = list(eng.sched_cache._entries.values())
    assert eng._sched_costs and all(any(s is c for c in live) for s in eng._sched_costs)
    dk = [s for s in eng.tracer.spans if s["name"] == "decode_kernel"]
    assert len(dk) == eng.stats.ticks and all("kv_bytes" in s["meta"] for s in dk)


@pytest.mark.parametrize("spec", [False, True])
def test_stats_do_not_keep_the_engine_alive(model, spec):
    """What a caller keeps of a finished run -- the stats, the registry --
    holds no reference to the engine or its scheduler: the registry's
    callbacks read the schedule cache, the stats, the queue and the slot
    map, so the engine's pools and graphs go with the engine."""
    import gc
    import weakref

    kw = dict(spec=SpecConfig(enabled=True, k=2)) if spec else {}
    eng = _port(model, paged=PagedConfig(enabled=True, page_size=8, prefix_cache=True), **kw)
    sch = tsched.Scheduler(eng, tsched.SchedulerConfig(**SCHED))
    for p in _prompts(eng.cfg.vocab_size):
        sch.submit(p, 3)
    sch.run_to_completion(max_steps=100)
    stats, reg, cache = eng.stats, eng.metrics, weakref.ref(eng.cache[0]["k"])
    refs = (weakref.ref(eng), weakref.ref(sch))
    del eng, sch
    gc.collect()
    assert all(r() is None for r in refs) and cache() is None
    d = reg.as_dict()
    assert d["engine_ticks"] == stats.ticks > 0 and d["scheduler_pending"] == 0
