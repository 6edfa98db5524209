"""The port's ``repro_torch.obs`` and ``repro_torch.roofline`` against the JAX
package's ``repro.obs`` and ``repro.roofline`` (both pure Python): the same
inputs through each side give the same Prometheus text and registry dicts,
histogram percentiles, merges and rebucketings, detector firings, fitted
calibrations, rendered reports and flight dumps, and tracer documents. The
roofline cost of one ``LeanSchedule`` agrees in bytes, flops and tiles;
its predicted times scale by the ratio of the peaks (the reference's TPU
v5e against the port's H100 SXM5) exactly.

Rendered reports are compared on trace documents whose spans carry their
predicted times (``pred_*_ms``), so that the peaks do not enter.
"""
import json
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.obs.calib as jcalib  # noqa: E402
import repro.obs.metrics as jmetrics  # noqa: E402
import repro.obs.report as jreport  # noqa: E402
import repro.obs.trace as jtrace  # noqa: E402
import repro.obs.watch as jwatch  # noqa: E402
import repro.roofline.analysis as jroof  # noqa: E402
import repro_torch.obs.calib as tcalib  # noqa: E402
import repro_torch.obs.metrics as tmetrics  # noqa: E402
import repro_torch.obs.report as treport  # noqa: E402
import repro_torch.obs.trace as ttrace  # noqa: E402
import repro_torch.obs.watch as twatch  # noqa: E402
import repro_torch.roofline.analysis as troof  # noqa: E402
from repro.core.leantile import make_schedule as jmake  # noqa: E402
from repro_torch.core.leantile import make_schedule as tmake  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _observations(seed=0, n=300):
    rng = np.random.default_rng(seed)
    return [float(v) for v in rng.lognormal(-4.0, 2.0, n)]


def _fill(m, seed=0):
    """One observation sequence into a registry of module ``m``: counters
    (plain and labeled), gauges, a callback gauge, histograms on default
    and custom bounds."""
    reg = m.MetricsRegistry()
    c = reg.counter("engine_ticks", help="ticks")
    lc = reg.counter("watchdog_fires_total", help="fires", labelnames=("detector",))
    g = reg.gauge("engine_degraded_slots", help="degraded")
    h = reg.histogram("engine_ttft_seconds", help="ttft")
    hc = reg.histogram("engine_tpot_seconds", help="tpot", bounds=[0.001, 0.01, 0.1, 1.0])
    lh = reg.histogram("lat_seconds", help="by class", labelnames=("klass",))
    reg.gauge_fn("schedule_cache_hit_rate", lambda: 0.625, help="hit rate")
    rng = np.random.default_rng(seed)
    for i, v in enumerate(_observations(seed)):
        c.inc()
        lc.labels(detector=("tick_spike", "retrace_storm")[i % 2]).inc(int(rng.integers(1, 3)))
        g.set(int(rng.integers(0, 5)))
        h.observe(v)
        hc.observe(v / 10)
        lh.labels(klass=("a", "b", "c")[i % 3]).observe(v)
    return reg


def test_registry_exports_equal():
    t, j = _fill(tmetrics), _fill(jmetrics)
    assert t.to_prometheus() == j.to_prometheus()
    assert t.as_dict() == j.as_dict()
    assert tmetrics.parse_prometheus(t.to_prometheus()) == \
        jmetrics.parse_prometheus(j.to_prometheus())
    assert t.names() == j.names()


@pytest.mark.parametrize("bounds", [None, [0.01, 0.1, 1.0, 10.0]])
def test_histogram_percentile_merge_rebucket_equal(bounds):
    th, jh = tmetrics.Histogram(bounds), jmetrics.Histogram(bounds)
    t2, j2 = tmetrics.Histogram(bounds), jmetrics.Histogram(bounds)
    for v in _observations(1):
        th.observe(v)
        jh.observe(v)
    for v in _observations(2, 50):
        t2.observe(v)
        j2.observe(v)
    for p in (0, 1, 25, 50, 90, 99, 99.9, 100, -5, 150):
        assert th.percentile(p) == jh.percentile(p)
    th.merge(t2)
    jh.merge(j2)
    assert th.as_dict() == jh.as_dict() and th.counts == jh.counts
    new = tmetrics.default_bounds(1e-3, 10.0, 3)
    assert new == jmetrics.default_bounds(1e-3, 10.0, 3)
    tr, jr = th.rebucket(new), jh.rebucket(new)
    assert tr.counts == jr.counts and tr.as_dict() == jr.as_dict()
    assert tmetrics.Histogram().percentile(50) == jmetrics.Histogram().percentile(50) == 0.0
    with pytest.raises(ValueError):
        th.merge(tmetrics.Histogram([1.0]))


def _series(seed=0, n=200):
    """Synthetic per-tick series: tick ms with spikes and compile ticks,
    cumulative retrace / preemption counters in bursts, measured vs
    predicted decode ms with a collapse, prefix-cache hits and lookups with
    a drop, a flapping degrade gauge."""
    rng = np.random.default_rng(seed)
    tick = [float(v) for v in rng.normal(12.0, 1.0, n)]
    for i in (60, 61, 90, 140, 170):
        tick[i] *= 8
    explained = [bool(i % 37 == 5) for i in range(n)]
    retr = np.cumsum([int(rng.integers(0, 3)) if 100 < i < 130 else int(i % 29 == 0)
                      for i in range(n)]).tolist()
    pre = np.cumsum([int(rng.integers(0, 2)) if 40 < i < 60 else 0 for i in range(n)]).tolist()
    meas = [float(v) * (6.0 if 120 < i < 140 else 1.0)
            for i, v in enumerate(rng.normal(2.0, 0.1, n))]
    pred = [0.02] * n
    lookups = np.cumsum(rng.integers(1, 4, n)).tolist()
    hits = np.cumsum([int(rng.integers(0, 2)) if i > 150 else 2 for i in range(n)]).tolist()
    hits = [min(h, lk) for h, lk in zip(hits, lookups)]
    gauge = [int(i % 3 == 0) if 80 < i < 110 else 0 for i in range(n)]
    return tick, explained, retr, pre, meas, pred, hits, lookups, gauge


def _firings(w, cfg_kw, calibration=None):
    cfg = w.WatchConfig(**cfg_kw)
    dets = {
        "tick": w.TickSpikeDetector(cfg), "retrace": w.RetraceStormDetector(cfg),
        "preempt": w.PreemptChurnDetector(cfg), "occ": w.OccupancyDetector(cfg, calibration),
        "hit": w.HitRateDropDetector(cfg), "flap": w.FlapDetector(cfg),
    }
    tick, explained, retr, pre, meas, pred, hits, lookups, gauge = _series()
    out = []
    for t in range(len(tick)):
        out += [
            dets["tick"].observe(t, tick[t], explained=explained[t]),
            dets["retrace"].observe(t, retr[t]),
            dets["preempt"].observe(t, pre[t]),
            dets["occ"].observe(t, meas[t], pred[t], "fast"),
            dets["hit"].observe(t, hits[t], lookups[t]),
            dets["flap"].observe(t, gauge[t]),
        ]
    return [f for f in out if f], {k: d.fires for k, d in dets.items()}


@pytest.mark.parametrize("cfg_kw", [
    dict(),
    dict(warmup_ticks=8, window=8, cooldown_ticks=4, retrace_threshold=4,
         preempt_threshold=3, occupancy_consecutive=2, flap_threshold=3),
])
def test_detectors_fire_alike(cfg_kw):
    tf, tn = _firings(twatch, cfg_kw)
    jf, jn = _firings(jwatch, cfg_kw)
    assert tf == jf and tn == jn
    assert sum(tn.values()) > 0
    # with a fitted calibration as the occupancy baseline
    tc = tcalib.Calibration(factors={"fast": 50.0}, default=80.0)
    jc = jcalib.Calibration(factors={"fast": 50.0}, default=80.0)
    assert _firings(twatch, cfg_kw, tc) == _firings(jwatch, cfg_kw, jc)


def test_error_budget_alike():
    slo = dict(name="interactive", ttft_target_s=0.05, tpot_target_s=0.01, budget=0.1,
               window=16)
    tb = twatch.ErrorBudget(twatch.SLOConfig(**slo))
    jb = jwatch.ErrorBudget(jwatch.SLOConfig(**slo))
    for i, v in enumerate(_observations(3, 120)):
        kind = ("ttft", "tpot")[i % 2]
        assert tb.observe(kind, v) == jb.observe(kind, v)
        assert tb.burn_rate() == jb.burn_rate()
    assert tb.as_dict() == jb.as_dict() and tb.breaches > 0
    for bad in (dict(budget=0.0), dict(window=0), dict(ttft_target_s=-1.0)):
        with pytest.raises(ValueError):
            twatch.SLOConfig(**bad)


def _trace_doc(m, mm, seed=0, ticks=12):
    """A trace document from trace module ``m``'s tracer (metrics from ``mm``): per tick a
    ``schedule_build``, a ``decode_kernel`` carrying cost meta with its
    predicted times, sometimes a ``prefill_chunk`` and a cascade pass;
    three requests' lifecycles; a metrics snapshot and a watchdog snapshot
    in ``meta``. Span and request times are set afterwards, from the seed,
    so both sides' documents are equal."""
    rng = np.random.default_rng(seed)
    tr = m.Tracer()
    for uid in range(3):
        tr.request_event(uid, "QUEUED", prompt_tokens=10 + uid)
    for t in range(ticks):
        if t % 4 == 1:
            with tr.span("prefill_chunk", chunks=1, tokens=8):
                pass
        with tr.span("tick"):
            with tr.span("decode_kernel", level=0, slots=2) as sp:
                with tr.span("schedule_build", total_tiles=6):
                    pass
                path = "cascade" if t % 5 == 3 else "fast"
                if path == "cascade":
                    with tr.span("cascade_group", engaged=True):
                        pass
                sp.annotate(path=path, kv_bytes=3072.0 * (t + 1), flops=6144.0 * (t + 1),
                            pred_mem_ms=1e-3 * (t + 1), pred_compute_ms=1e-5 * (t + 1),
                            total_tiles=6)
                sp.add_sync(0.001)
        for uid in range(3):
            if t == uid:
                tr.request_event(uid, "PREFILLING", slot=uid % 2)
                tr.request_event(uid, "DECODING", slot=uid % 2)
                tr.request_event(uid, "FIRST_TOKEN")
            if uid <= t < uid + 4:
                tr.request_token(uid)
            if t == uid + 4:
                tr.request_event(uid, "FINISHED", tokens=4)
    doc = json.loads(json.dumps(tr.to_dict(extra={
        "metrics": _fill(mm, seed).as_dict(),
        "watchdog": {"format": 1, "ticks": ticks, "total_fires": 1,
                     "fire_counts": {"tick_spike": 1, "retrace_storm": 0},
                     "fires": [{"detector": "tick_spike", "tick": 5, "value_ms": 90.0,
                                "threshold_ms": 60.0}],
                     "config": {}, "slo": {"interactive": {
                         "class": "interactive", "ttft_target_s": 1.0, "tpot_target_s": 0.25,
                         "budget": 0.01, "events": 9, "breaches": 1,
                         "breach_kinds": {"ttft": 1, "tpot": 0}, "budget_remaining": 0.0,
                         "burn_rate": 11.1, "recent_window": 9}},
                     "calibration": None},
    })))
    for sp in doc["spans"]:
        sp["ms"] = float(rng.uniform(0.5, 20.0))
    for i, r in enumerate(doc["requests"].values()):
        for k, ev in enumerate(r["events"]):
            ev["t"] = 0.01 * (i + k)
        r["queue_wait_s"], r["ttft_s"] = 0.01 * i, 0.02 + 0.01 * i
        r["tpot_s"] = {"mean": 0.005, "min": 0.004, "max": 0.007, "gaps": 3}
    return doc


def test_tracer_documents_alike():
    t, j = _trace_doc(ttrace, tmetrics), _trace_doc(jtrace, jmetrics)
    assert t == j
    assert {s["name"] for s in t["spans"]} == {"tick", "decode_kernel", "schedule_build",
                                               "prefill_chunk", "cascade_group"}
    tt, jt = ttrace.Tracer(), jtrace.Tracer()
    for tr in (tt, jt):
        with tr.span("tick"):
            tr.annotate(a=1)
        tr.request_token(7)
    strip = lambda d: [{k: v for k, v in s.items() if k != "ms"} for s in d["spans"]]
    assert strip(tt.to_dict()) == strip(jt.to_dict())
    assert tt.tick_spans() == tt.spans and ttrace.NULL_TRACER.span("x").__bool__() is False


def test_calibration_fits_alike(tmp_path):
    t, j = _trace_doc(ttrace, tmetrics), _trace_doc(jtrace, jmetrics)
    for min_samples in (1, 3, 5):
        tc = tcalib.fit_calibration(t, min_samples=min_samples)
        jc = jcalib.fit_calibration(j, min_samples=min_samples)
        assert tc.as_dict() == jc.as_dict()
    tc.save(tmp_path / "c.json")
    assert tcalib.load_calibration(tmp_path / "c.json").as_dict() == \
        jcalib.load_calibration(tmp_path / "c.json").as_dict()
    with pytest.raises(ValueError):
        tcalib.fit_calibration({"spans": []})


@pytest.mark.parametrize("calibrated", [False, True])
def test_report_renders_alike(calibrated):
    t, j = _trace_doc(ttrace, tmetrics), _trace_doc(jtrace, jmetrics)
    tc = tcalib.fit_calibration(t) if calibrated else None
    jc = jcalib.fit_calibration(j) if calibrated else None
    out = treport.render_report(t, limit=8, calib=tc)
    assert out == jreport.render_report(j, limit=8, calib=jc)
    assert "FINISHED" in out and "tick_spike" in out and "interactive" in out


def test_flight_sample_renders_alike():
    doc = json.loads((ROOT / "FLIGHT_sample.json").read_text())
    for tail in (5, 20):
        assert treport.render_flight(doc, tail=tail) == jreport.render_flight(doc, tail=tail)


@pytest.mark.parametrize("lens,tile,elem,q_rows", [
    ([4000, 1500, 700, 1], 128, 2, 1),
    ([37, 9, 128, 300, 1], 16, 1, 1),
    ([16384, 512, 256, 17], 128, 4, 5),
])
def test_schedule_decode_cost_scales_by_the_peaks(lens, tile, elem, q_rows):
    kw = dict(n_q_heads=32, n_kv_heads=8, head_dim=128, kv_elem_bytes=elem, q_rows=q_rows)
    tc = troof.schedule_decode_cost(tmake(lens, 8, tile, 132), **kw)
    jc = jroof.schedule_decode_cost(jmake(lens, 8, tile, 132), **kw)
    for k in ("kv_tokens", "kv_bytes", "tile_kv_bytes", "flops", "total_tiles",
              "num_segments", "num_pieces"):
        assert tc[k] == jc[k], k
    assert (troof.PEAK_FLOPS, troof.HBM_BW) == (989e12, 3.35e12)
    assert tc["pred_mem_ms"] == pytest.approx(jc["pred_mem_ms"] * 819e9 / 3.35e12, rel=1e-12)
    assert tc["pred_compute_ms"] == pytest.approx(jc["pred_compute_ms"] * 197e12 / 989e12,
                                                  rel=1e-12)
    for f in (0.5, 40.0):
        a, b = troof.calibrated_cost(tc, f), jroof.calibrated_cost(jc, f)
        assert a["calib_factor"] == b["calib_factor"] == f
        assert a["pred_mem_ms"] == pytest.approx(tc["pred_mem_ms"] * f, rel=1e-12)
