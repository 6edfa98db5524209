"""The port's self-healing engine under fault injection, against the JAX
engine on the CPU: the port's side of ``tests/test_chaos.py`` and of the
engine cases of ``tests/test_guards.py``.

Setup: the smoke ``mistral-nemo-12b`` on the same weights
(``params_from_numpy``), paged with page 8, ``lean``, 4 slots. The port
engine runs the kernels' plain versions on CPU tensors; the JAX engine
runs its Pallas kernels in interpret mode, as its own tests do. With the
same ``GuardConfig`` and the same injector seed both engines must give
equal token streams, equal guard and fault counters, equal injector
records (``as_dict``) and equal flight-dump reasons, for every point of the
reference's fault matrix, for ``force_degrade`` to each level of the chain,
for each ``audit_action``, and for speculative decode under
``nan_output`` (the verify step's verdict). The rest runs on the port
alone: a healthy guarded engine gives the unguarded one's tokens, the
victims of ``nan_output`` and ``nan_kv`` finish with their fault-free
streams, and ``force_degrade`` (called directly, and by the watchdog's
``degrade_on_collapse``) records its cause.
"""
import importlib.util
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.obs.flight import load_flight_dump  # noqa: E402
from repro.serving import config as jconfig  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import faults as jfaults  # noqa: E402
from repro.serving import guards as jguards  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.serving import config as tconfig  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import faults as tfaults  # noqa: E402
from repro_torch.serving import guards as tguards  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

SIDES = {
    "jax": SimpleNamespace(config=jconfig, engine=jengine, faults=jfaults, guards=jguards,
                           sched=jsched),
    "torch": SimpleNamespace(config=tconfig, engine=tengine, faults=tfaults, guards=tguards,
                             sched=tsched),
}
COUNTERS = ("nan_ticks", "degrade_escalations", "degrade_heals", "poisoned_slots", "preemptions",
            "audits_run", "audit_failures", "audit_repairs", "donation_aborts", "tokens_generated",
            "ticks", "spec_ticks", "spec_draft_tokens", "spec_accepted_tokens")

# tests/test_chaos.py's FAULT_MATRIX (held equal to it below)
FAULT_MATRIX = [
    ("page_alloc", dict(rate=0.5, start=2, stop=40, burst=2)),
    ("cow_clone", dict(rate=0.7, start=2, stop=40)),
    ("nan_output", dict(rate=1.0, start=6, stop=8)),
    ("nan_kv", dict(rate=1.0, start=6, max_fires=1)),
    ("trie_corrupt", dict(rate=0.5, start=2, stop=40)),
    ("preempt_storm", dict(rate=1.0, start=5, max_fires=1, magnitude=2)),
    ("tick_latency", dict(rate=1.0, start=2, stop=5, magnitude=0.001)),
]


@pytest.fixture(scope="module")
def model():
    cfg_j = jax_smoke("mistral-nemo-12b")
    cfg = get_smoke_config("mistral-nemo-12b")
    pj = jinit(jax.random.PRNGKey(0), cfg_j)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), cfg, device="cpu")
    return {"jax": (cfg_j, pj), "torch": (cfg, pt)}


def _engine(model, side, *, faults=None, guards=None, flight_dir=None, prefix_cache=False,
            spec=None, **kw):
    """tests/test_chaos.py's ``_mk_engine`` on ``side``: lean, paged, page 8."""
    ns = SIDES[side]
    cfg, params = model[side]
    c = ns.config
    conf = dict(max_batch=4, cache_len=32, num_workers=4, attn_backend="lean")
    conf.update(kw)
    conf = c.EngineConfig(paged=c.PagedConfig(enabled=True, page_size=8, prefix_cache=prefix_cache),
                          faults=faults, guards=guards, obs=c.ObsConfig(flight_dir=flight_dir),
                          spec=spec if spec is not None else c.SpecConfig(), **conf)
    if side == "jax":
        return ns.engine.DecodeEngine(cfg, params, conf)
    return ns.engine.DecodeEngine(cfg, params, conf, device="cpu")


def _injector(side, specs, seed):
    f = SIDES[side].faults
    return f.FaultInjector({p: f.FaultSpec(**kw) for p, kw in specs.items()}, seed=seed)


def _requests(side, vocab, n=4, new=12, seed=0):
    R = SIDES[side].engine.Request
    rng = np.random.default_rng(seed)
    return [R(uid=i, prompt=rng.integers(0, vocab, 5 + 4 * i), max_new_tokens=new)
            for i in range(n)]


def _record(eng, streams, flight_dir=None) -> dict:
    """What the two engines are held equal on."""
    out = {"streams": streams, "counters": {k: getattr(eng.stats, k) for k in COUNTERS},
           "degraded_peak": eng.degraded_gauge.peak}
    if eng.faults is not None:
        out["faults"] = eng.faults.as_dict()
    if flight_dir is not None:
        docs = sorted((load_flight_dump(f) for f in Path(flight_dir).glob("flight-*.json")),
                      key=lambda d: d["dump_index"])
        out["dumps"] = [d["reason"] for d in docs]
        out["dump_points"] = [sorted({ev["point"] for ev in d["events"][-64:]
                                      if ev["kind"] == "fault_fire"}) for d in docs]
    return out


def _assert_recovered(eng):
    """tests/test_chaos.py's post-recovery contracts."""
    eng.pool.check()
    cached = len(eng.prefix_cache._pages) if eng.prefix_cache is not None else 0
    assert eng.pool.num_allocated == cached
    assert eng.degraded_gauge.value == 0
    if eng.prefix_cache is not None:
        eng.prefix_cache.check()


def _quiesce(eng, ticks=8):
    if eng.faults is not None:
        eng.faults.stop_all()
    for _ in range(ticks):
        eng.tick()


# ------------------------------------------------------------ fault matrix
def test_fault_matrix_is_the_reference_s():
    path = Path(__file__).with_name("test_chaos.py")
    spec = importlib.util.spec_from_file_location("_reference_chaos", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert FAULT_MATRIX == mod.FAULT_MATRIX


def _matrix_run(model, side, point, spec, flight_dir):
    """tests/test_chaos.py:test_fault_matrix_every_point_recovers on ``side``:
    a donor wave fills the radix cache, four continuations of its chain
    (sharing its partial tail page, so their first writes copy it) run
    through the Scheduler with backoff and deadlines, then quiesce."""
    cfg = model[side][0]
    inj = _injector(side, {point: spec}, seed=6)
    eng = _engine(model, side, prefix_cache=True, faults=inj, flight_dir=str(flight_dir),
                  guards=SIDES[side].guards.GuardConfig(heal_after=2, audit_interval=3,
                                                        audit_action="repair"))
    S = SIDES[side].sched
    sch = S.Scheduler(eng, S.SchedulerConfig(chunk_size=8, prefill_pack=2, token_budget=32,
                                             retry_backoff=1, deadline_steps=150,
                                             max_preemptions=30))
    rng = np.random.default_rng(11)
    shared = rng.integers(0, cfg.vocab_size, 12)
    tails = [rng.integers(0, cfg.vocab_size, 2 + i) for i in range(4)]
    donor = sch.submit(np.concatenate([shared, [1]]), 2)
    sch.run_to_completion(max_steps=200)
    assert donor.done
    chain = np.concatenate([shared, [1], donor.generated])
    hs = [sch.submit(np.concatenate([chain, t]), max_new_tokens=8) for t in tails]
    sch.run_to_completion(max_steps=800)
    assert all(h.done for h in hs)
    assert inj.total_fires >= 1, f"{point} never fired"
    _quiesce(eng)
    _assert_recovered(eng)
    rec = _record(eng, [list(h.generated) for h in [donor] + hs], flight_dir)
    rec["scheduler_poisoned"] = sch.stats.poisoned
    return rec, eng


@pytest.mark.parametrize("point,spec", FAULT_MATRIX, ids=[p for p, _ in FAULT_MATRIX])
def test_fault_matrix_matches_reference(model, point, spec, tmp_path):
    ref, _ = _matrix_run(model, "jax", point, spec, tmp_path / "jax")
    got, eng = _matrix_run(model, "torch", point, spec, tmp_path / "torch")
    assert got == ref
    # the postmortem contract: a dump whose trailing events name the point
    assert got["dumps"] and any(point in pts for pts in got["dump_points"])
    if point in ("nan_output", "nan_kv"):
        assert got["counters"]["nan_ticks"] >= 1 and got["counters"]["degrade_escalations"] >= 1
    if point == "nan_kv":
        assert got["counters"]["poisoned_slots"] == 1 and "poison" in got["dumps"]
    if point == "trie_corrupt":
        assert got["counters"]["audit_repairs"] >= 1


# ----------------------------------------------------------- force_degrade
class _KeyLog:
    """Records every step key an engine runs (decode keys only)."""

    def __init__(self, eng):
        self.keys = []
        run = eng._run_step

        def logged(step):
            if step.kind == "decode":
                self.keys.append(step.key)
            return run(step)

        eng._run_step = logged


def _force_run(model, side, level):
    cfg = model[side][0]
    eng = _engine(model, side, guards=SIDES[side].guards.GuardConfig(heal_after=2))
    log = _KeyLog(eng) if side == "torch" else None
    reqs = _requests(side, cfg.vocab_size)
    for r in reqs:
        eng.submit(r)
    for _ in range(3):
        eng.tick()
    moved = eng.force_degrade(levels=level, cause="manual")
    assert moved == sum(1 for r in eng.slot_req if r is not None) > 0
    eng.run_to_completion(max_ticks=200)
    assert all(r.done for r in reqs)
    rec = _record(eng, [list(r.generated) for r in reqs])
    rec["moved"] = moved
    rec["cause_manual"] = eng._degrade_cause.labels(cause="manual").value
    return rec, eng, log


@pytest.mark.parametrize("level", [1, 2, 3])
def test_force_degrade_matches_reference(model, level):
    ref, _, _ = _force_run(model, "jax", level)
    got, eng, log = _force_run(model, "torch", level)
    assert got == ref
    assert got["counters"]["degrade_escalations"] == got["moved"] == got["cause_manual"]
    assert got["counters"]["degrade_heals"] >= level
    _assert_recovered(eng)
    # the degraded passes ran the level's step: K2 (fused, no cascade), K1 +
    # merge (fused False), the ref step
    layout = ("paged", "bf16")
    want = {1: ("lean", True), 2: ("lean", False), 3: ("ref", True)}[level]
    assert any(k[0] == layout and (k[1], k[3]) == want for k in log.keys)
    assert level == 1 or all((k[1], k[3]) != want for k in log.keys[:3])


def test_force_degrade_needs_guards_and_a_cause(model):
    eng = _engine(model, "torch")
    with pytest.raises(ValueError, match="requires guards"):
        eng.force_degrade()
    eng = _engine(model, "torch", guards=tguards.GuardConfig())
    with pytest.raises(ValueError, match="unknown degrade cause"):
        eng.force_degrade(cause="gremlins")
    assert eng.force_degrade(cause="watchdog") == 0          # no active slot


# ------------------------------------------------------------------ audits
def _audit_run(model, side, action):
    """tests/test_guards.py's audit cases: a guarded engine auditing every
    tick, one request ticked twice, a refcount corrupted, one more tick."""
    cfg = model[side][0]
    eng = _engine(model, side, max_batch=2, prefix_cache=True,
                  guards=SIDES[side].guards.GuardConfig(audit_interval=1, audit_action=action))
    rng = np.random.default_rng(0)
    req = SIDES[side].engine.Request(uid=0, prompt=rng.integers(0, cfg.vocab_size, 9),
                                     max_new_tokens=8)
    eng.submit(req)
    eng.tick()
    eng.tick()
    assert eng.stats.audits_run == 2 and eng.stats.audit_failures == 0
    pages = eng.pool.pages_of(0)
    eng.pool._refcount[pages[0]] += 1
    outcome = "ok"
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            eng.tick()
        except SIDES[side].guards.FatalInvariantError:
            outcome = "fatal"
    outcome += "+warned" if any("audit failed" in str(w.message) for w in caught) else ""
    if action == "repair":
        assert eng.pool.pages_of(0) == pages
        eng.run_to_completion(max_ticks=40)
        eng.pool.check()
    return {"outcome": outcome, **_record(eng, [list(req.generated)])}


@pytest.mark.parametrize("action", ["raise", "repair", "log"])
def test_audit_action_matches_reference(model, action):
    ref = _audit_run(model, "jax", action)
    got = _audit_run(model, "torch", action)
    assert got == ref
    assert got["outcome"] == {"raise": "fatal", "repair": "ok", "log": "ok+warned"}[action]
    assert got["counters"]["audit_failures"] >= 1
    assert got["counters"]["audit_repairs"] == (1 if action == "repair" else 0)


# -------------------------------------------------- speculative nan_output
def _spec_run(model, side):
    cfg = model[side][0]
    c = SIDES[side].config
    inj = _injector(side, {"nan_output": dict(rate=1.0, start=3, stop=6)}, seed=1)
    eng = _engine(model, side, faults=inj, spec=c.SpecConfig(enabled=True, k=3),
                  guards=SIDES[side].guards.GuardConfig(heal_after=2))
    reqs = _requests(side, cfg.vocab_size, new=10)
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion(max_ticks=200)
    assert all(r.done for r in reqs)
    return _record(eng, [list(r.generated) for r in reqs]), eng


def test_spec_nan_output_matches_reference(model):
    ref, _ = _spec_run(model, "jax")
    got, eng = _spec_run(model, "torch")
    assert got == ref
    assert got["faults"]["points"]["nan_output"]["fires"] == 3
    assert got["counters"]["nan_ticks"] == 3 and got["counters"]["spec_ticks"] > 0
    _assert_recovered(eng)


# ------------------------------------------------------------ port alone
def _plain_run(model, **kw):
    cfg = model["torch"][0]
    eng = _engine(model, "torch", **kw)
    reqs = _requests("torch", cfg.vocab_size)
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion(max_ticks=400)
    assert all(r.done for r in reqs), "requests wedged under faults"
    return [list(r.generated) for r in reqs], eng


@pytest.fixture(scope="module")
def fault_free(model):
    return _plain_run(model)[0]


def test_healthy_guarded_engine_gives_unguarded_tokens(model, fault_free):
    got, eng = _plain_run(model, faults=tfaults.FaultInjector({}, enabled=False),
                          guards=tguards.GuardConfig(audit_interval=2))
    assert got == fault_free
    assert eng.stats.nan_ticks == 0 and eng.stats.audits_run > 0
    assert eng.degraded_gauge.peak == 0


def test_nan_output_victim_heals_with_its_stream(model, fault_free):
    """tests/test_chaos.py:test_nan_output_quarantine_degrade_heal_token_identical."""
    inj = tfaults.FaultInjector({"nan_output": tfaults.FaultSpec(rate=1.0, start=4, stop=7)},
                                seed=1)
    got, eng = _plain_run(model, faults=inj, guards=tguards.GuardConfig(
        heal_after=2, audit_interval=4, audit_action="repair"))
    assert got == fault_free
    assert inj.fires["nan_output"] == 3 and eng.stats.nan_ticks >= 3
    assert eng.stats.degrade_heals >= 1 and eng.degraded_gauge.peak >= 1
    assert eng.stats.poisoned_slots == 0
    _assert_recovered(eng)


def test_nan_kv_victim_is_poisoned_and_recomputes(model, fault_free, tmp_path):
    """tests/test_chaos.py:test_nan_kv_corruption_poisons_and_recomputes:
    real NaN K/V rides the chain to the bottom, is scrubbed and recomputed,
    and every dump's trailing events name the injected point."""
    inj = tfaults.FaultInjector({"nan_kv": tfaults.FaultSpec(rate=1.0, start=3, max_fires=1)},
                                seed=2)
    got, eng = _plain_run(model, faults=inj, flight_dir=str(tmp_path),
                          guards=tguards.GuardConfig(heal_after=2, poison_after=2))
    assert got == fault_free
    assert inj.fires["nan_kv"] == 1 and eng.stats.poisoned_slots == 1
    assert eng.stats.degrade_escalations >= 3 and eng.stats.preemptions >= 1
    _assert_recovered(eng)
    docs = [load_flight_dump(f) for f in sorted(tmp_path.glob("flight-*.json"))]
    assert docs and {"poison", "degrade"} <= {d["reason"] for d in docs}
    for d in docs:
        fires = [ev for ev in d["events"] if ev["kind"] == "fault_fire"]
        assert fires and all(ev["point"] == "nan_kv" for ev in fires)
    assert eng.flight.dumps == len(docs)


def test_force_degrade_is_observable(model):
    """tests/test_watchdog.py:test_force_degrade_is_observable on the port:
    the flight event, the cause counter and the gauge record the cause."""
    eng = _engine(model, "torch", guards=tguards.GuardConfig())
    eng.submit(tengine.Request(uid=0, prompt=np.array([3, 1, 4], np.int32), max_new_tokens=4))
    eng.tick()
    assert eng.force_degrade(cause="watchdog") == 1
    assert eng.degraded_gauge.value == 1
    ev = [e for e in eng.flight.events() if e["kind"] == "degrade"]
    assert ev and ev[-1]["cause"] == "watchdog" and ev[-1]["backend"] == "lean-fused"
    assert eng.metrics.as_dict()["engine_degrade_cause_total"]["cause=watchdog"] == 1


def test_watchdog_collapse_forces_degrade(model):
    """``WatchConfig(degrade_on_collapse=True)``: an occupancy collapse (a
    calibration that puts every tick out of band) calls
    ``force_degrade(cause="watchdog")`` once; the slots heal back to 0."""
    from repro_torch.obs import Tracer
    from repro_torch.obs.calib import Calibration
    from repro_torch.obs.watch import PerfWatchdog, WatchConfig

    cfg = model["torch"][0]
    eng = _engine(model, "torch", guards=tguards.GuardConfig(heal_after=2))
    eng.tracer = Tracer()
    wd = PerfWatchdog(eng, WatchConfig(degrade_on_collapse=True, warmup_ticks=0,
                                       occupancy_consecutive=2, cooldown_ticks=10_000),
                      calibration=Calibration(default=1e-9))
    assert eng.watchdog is wd
    reqs = _requests("torch", cfg.vocab_size, n=3, new=8)
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion(max_ticks=100)
    assert all(r.done for r in reqs)
    assert wd.fire_counts()["occupancy_collapse"] == 1
    assert eng._degrade_cause.labels(cause="watchdog").value == len(reqs)
    assert [e["cause"] for e in eng.flight.events() if e["kind"] == "degrade"] == \
        ["watchdog"] * len(reqs)
    assert eng.stats.degrade_heals == len(reqs) and eng.degraded_gauge.value == 0
    _assert_recovered(eng)
