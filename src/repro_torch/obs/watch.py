"""Perf watchdog: streaming anomaly detectors + SLO error budgets (port of
``repro.obs.watch``).

The serving stack's *instruments* -- tracer spans, a metrics registry, a
flight recorder -- record; nothing in them watches: occupancy could
collapse, the prefix cache could stop hitting, or TTFT could blow its
target for an hour and the first sign would be a user complaint. This
module closes the loop: a :class:`PerfWatchdog` attached to a
:class:`~repro_torch.serving.engine.DecodeEngine` consumes the registry and the
tracer's spans once per decode tick, runs a small set of **streaming
detectors** over bounded windows, and arms a flight-recorder postmortem
(reason ``watchdog-<detector>``) the moment an *emergent* pathology is
detected — naming the firing detector and the exact metric window that
tripped it, so the bundle is diagnosable without a live debugger.

Detectors (all windowed, all warmup-gated so steady-state compile/churn
noise cannot fire them):

  * ``tick_spike`` — tick wall time vs the trailing median (catches
    latency injections, GC stalls, host interference);
  * ``retrace_storm`` — schedule-cache misses + cascade retraces + CUDA
    graph captures per window (admission churn defeating the schedule,
    cascade and captured-step caches);
  * ``preempt_churn`` — preemptions per window (pool-pressure thrash or
    a preemption storm);
  * ``occupancy_collapse`` — measured ``decode_kernel`` ms diverging
    from the roofline-predicted ms beyond a *calibrated* band (traced
    runs only; the band is fit from measurements — see
    :mod:`repro_torch.obs.calib` — never hardcoded);
  * ``prefix_hit_drop`` — recent prefix-cache hit rate dropping below
    the long-run baseline;
  * ``degrade_flap`` — the degraded-slots gauge oscillating (slots
    bouncing down/up the fallback chain instead of settling);
  * ``slo_burn`` — an SLO error budget burning faster than its allowed
    rate (``burn >= cfg.burn_alert``).

SLO tracking: :class:`SLOConfig` declares per-request-class TTFT/TPOT
targets and an allowed breach fraction (the error budget);
:class:`ErrorBudget` counts breaches, exposes budget-remaining and
burn-rate callback gauges through the registry, and the scheduler feeds
it from ``submit(..., slo_class=...)`` request classes.

Zero overhead when absent: the engine's per-tick hook is one ``is None``
attribute test. The occupancy detector additionally requires an enabled
tracer (measured kernel ms only exists in spans); every other detector
runs untraced.
"""
from __future__ import annotations

import re
import statistics
from collections import deque
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

__all__ = [
    "WatchConfig",
    "SLOConfig",
    "ErrorBudget",
    "PerfWatchdog",
]


@dataclass
class WatchConfig:
    """Detector thresholds and windows: the reference's defaults (its
    false-positive sweep is in EXPERIMENTS.md; none was run on a card).

    ``warmup_ticks`` suppresses every detector early on: startup is a
    legitimate storm of compiles, schedule-cache misses, and admission
    churn. ``cooldown_ticks`` bounds postmortem spam — a sustained
    pathology re-arms one bundle per cooldown, not one per tick.
    """

    warmup_ticks: int = 32
    window: int = 16
    cooldown_ticks: int = 32
    # tick_spike: tick wall ms > max(floor, factor * trailing median)
    tick_spike_factor: float = 5.0
    tick_spike_floor_ms: float = 10.0
    # retrace_storm: schedule-cache misses + cascade retraces + graph
    # captures per window
    retrace_threshold: int = 6
    # preempt_churn: preemptions per window
    preempt_threshold: int = 2
    # occupancy_collapse: measured/predicted decode ratio vs calibrated
    # baseline (self-calibrated from the warmup window when no fitted
    # Calibration is supplied)
    occupancy_band: float = 4.0
    occupancy_consecutive: int = 4
    # prefix_hit_drop: recent window rate < long-run baseline - drop
    hit_rate_drop: float = 0.3
    hit_rate_min_lookups: int = 8
    # degrade_flap: gauge value changes per window
    flap_threshold: int = 4
    # slo_burn: recent breach rate / budget >= burn_alert
    burn_alert: float = 2.0
    slo_min_events: int = 8
    # reactions
    dump: bool = True                  # arm flight postmortems on fire
    degrade_on_collapse: bool = False  # occupancy fire -> force_degrade

    def __post_init__(self):
        if self.warmup_ticks < 0 or self.window < 2:
            raise ValueError("warmup_ticks >= 0 and window >= 2 required")
        if self.cooldown_ticks < 1:
            raise ValueError("cooldown_ticks must be >= 1")
        for name in ("tick_spike_factor", "occupancy_band", "burn_alert"):
            if getattr(self, name) <= 1.0:
                raise ValueError(f"{name} must be > 1.0")
        if not 0.0 < self.hit_rate_drop <= 1.0:
            raise ValueError("hit_rate_drop must be in (0, 1]")


# ------------------------------------------------------------- detectors


class _Detector:
    """Shared firing bookkeeping: warmup gate + per-detector cooldown.

    Subclasses implement ``_check(...) -> Optional[dict]`` returning the
    firing payload (value / threshold / tripping window); ``observe``
    wraps it with the gates and stamps the detector name."""

    name = "detector"

    def __init__(self, cfg: WatchConfig):
        self.cfg = cfg
        self.fires = 0
        self._last_fire = None      # watchdog tick of the last firing

    def _gated(self, tick: int) -> bool:
        if tick < self.cfg.warmup_ticks:
            return True
        return (
            self._last_fire is not None
            and tick - self._last_fire < self.cfg.cooldown_ticks
        )

    def _fire(self, tick: int, payload: dict) -> dict:
        self.fires += 1
        self._last_fire = tick
        return {"detector": self.name, "tick": tick, **payload}


def _round_window(values) -> List[float]:
    return [round(float(v), 4) for v in values]


class TickSpikeDetector(_Detector):
    """Tick wall time vs its own trailing median: a spike beyond
    ``max(floor_ms, factor * median)`` is a latency anomaly. The spike
    sample still enters the window afterwards, so a *sustained* slowdown
    re-baselines instead of firing forever (cooldown bounds the bundles
    in between)."""

    name = "tick_spike"

    def __init__(self, cfg: WatchConfig):
        super().__init__(cfg)
        self.window = deque(maxlen=cfg.window)

    def observe(self, tick: int, tick_ms: float,
                explained: bool = False) -> Optional[dict]:
        # a tick that rebuilt a schedule or captured a graph is slow for
        # a *known* reason — exclude it entirely (checking it would
        # false-positive on every new batch geometry; windowing it would
        # poison the median). Storms of such ticks are retrace_storm's
        # beat, not this detector's.
        if explained:
            return None
        out = None
        if len(self.window) >= self.cfg.window // 2 and not self._gated(tick):
            med = statistics.median(self.window)
            thr = max(self.cfg.tick_spike_floor_ms,
                      self.cfg.tick_spike_factor * med)
            if tick_ms > thr:
                out = self._fire(tick, {
                    "value_ms": round(tick_ms, 4),
                    "threshold_ms": round(thr, 4),
                    "median_ms": round(med, 4),
                    "window": _round_window(self.window),
                })
        self.window.append(tick_ms)
        return out


class _WindowSumDetector(_Detector):
    """Counter-delta detector: per-tick deltas of a cumulative counter,
    firing when the window's sum crosses a threshold. The window clears
    on fire so one storm yields one bundle, not ``window`` of them."""

    threshold_attr = ""

    def __init__(self, cfg: WatchConfig):
        super().__init__(cfg)
        self.window = deque(maxlen=cfg.window)
        self._prev: Optional[int] = None

    def observe(self, tick: int, cumulative: int) -> Optional[dict]:
        delta = 0 if self._prev is None else max(0, cumulative - self._prev)
        self._prev = cumulative
        self.window.append(delta)
        if self._gated(tick):
            return None
        total = sum(self.window)
        thr = getattr(self.cfg, self.threshold_attr)
        if total >= thr:
            payload = {
                "count": total,
                "threshold": thr,
                "window": list(self.window),
            }
            self.window.clear()
            return self._fire(tick, payload)
        return None


class RetraceStormDetector(_WindowSumDetector):
    name = "retrace_storm"
    threshold_attr = "retrace_threshold"


class PreemptChurnDetector(_WindowSumDetector):
    name = "preempt_churn"
    threshold_attr = "preempt_threshold"


class OccupancyDetector(_Detector):
    """Measured ``decode_kernel`` ms vs roofline-predicted ms.

    The raw ratio is platform-dependent (a CPU run sits orders of
    magnitude above the card's bound, and the span times the whole decode
    step where the prediction counts its attention), so the detector never
    compares to 1.0: the band is relative to a *calibrated baseline* — either a
    fitted per-path factor (:class:`repro_torch.obs.calib.Calibration`) or,
    absent one, the median ratio observed during warmup. A tick is
    out-of-band when its ratio exceeds ``baseline * occupancy_band``;
    ``occupancy_consecutive`` such ticks in a row fire."""

    name = "occupancy_collapse"

    def __init__(self, cfg: WatchConfig, calibration=None):
        super().__init__(cfg)
        self.calibration = calibration
        self._warm: List[float] = []
        self._baseline: Optional[float] = None
        self._streak = 0
        self._streak_ratios: deque = deque(maxlen=cfg.window)

    def observe(self, tick: int, meas_ms: float, pred_ms: float,
                path: str = "fast") -> Optional[dict]:
        if pred_ms <= 0 or meas_ms <= 0:
            return None
        ratio = meas_ms / pred_ms
        if self.calibration is not None:
            baseline = self.calibration.factor(path)
        else:
            if tick < self.cfg.warmup_ticks:
                self._warm.append(ratio)
                return None
            if self._baseline is None:
                self._baseline = (
                    statistics.median(self._warm) if self._warm else ratio
                )
            baseline = self._baseline
        band = baseline * self.cfg.occupancy_band
        self._streak_ratios.append(ratio)
        if ratio > band:
            self._streak += 1
        else:
            self._streak = 0
        if self._streak >= self.cfg.occupancy_consecutive \
                and not self._gated(tick):
            payload = {
                "ratio": round(ratio, 3),
                "band": round(band, 3),
                "baseline": round(baseline, 3),
                "consecutive": self._streak,
                "path": path,
                "window": _round_window(self._streak_ratios),
            }
            self._streak = 0
            return self._fire(tick, payload)
        return None


class HitRateDropDetector(_Detector):
    """Recent prefix-cache hit rate vs the long-run baseline. Both sides
    need ``hit_rate_min_lookups`` lookups before a verdict — an idle
    cache can't drop."""

    name = "prefix_hit_drop"

    def __init__(self, cfg: WatchConfig):
        super().__init__(cfg)
        self.window = deque(maxlen=cfg.window)   # (d_hits, d_lookups)
        self._prev = (0, 0)

    def observe(self, tick: int, hits: int, lookups: int) -> Optional[dict]:
        ph, pl = self._prev
        self._prev = (hits, lookups)
        self.window.append((max(0, hits - ph), max(0, lookups - pl)))
        if self._gated(tick):
            return None
        wh = sum(h for h, _ in self.window)
        wl = sum(n for _, n in self.window)
        base_l = lookups - wl
        if wl < self.cfg.hit_rate_min_lookups \
                or base_l < self.cfg.hit_rate_min_lookups:
            return None
        base_rate = (hits - wh) / base_l
        recent = wh / wl
        if recent < base_rate - self.cfg.hit_rate_drop:
            payload = {
                "recent_rate": round(recent, 3),
                "baseline_rate": round(base_rate, 3),
                "drop": round(base_rate - recent, 3),
                "window_lookups": wl,
                "window": [[h, n] for h, n in self.window],
            }
            self.window.clear()
            return self._fire(tick, payload)
        return None


class FlapDetector(_Detector):
    """Degraded-gauge oscillation: more than ``flap_threshold`` value
    *changes* inside the window means slots are bouncing on and off the
    fallback chain — healing that doesn't stick (distinct from one clean
    degrade-and-heal cycle, which is two transitions)."""

    name = "degrade_flap"

    def __init__(self, cfg: WatchConfig):
        super().__init__(cfg)
        self.window = deque(maxlen=cfg.window)

    def observe(self, tick: int, gauge_value: int) -> Optional[dict]:
        self.window.append(int(gauge_value))
        if self._gated(tick):
            return None
        flips = sum(
            1 for a, b in zip(self.window, list(self.window)[1:]) if a != b
        )
        if flips >= self.cfg.flap_threshold:
            payload = {
                "transitions": flips,
                "threshold": self.cfg.flap_threshold,
                "window": list(self.window),
            }
            self.window.clear()
            return self._fire(tick, payload)
        return None


# ------------------------------------------------------------ SLO budgets


@dataclass(frozen=True)
class SLOConfig:
    """Per-request-class SLO: latency targets + an error budget.

    ``budget`` is the allowed breach fraction (SRE-style: a 1% budget
    means 1 in 100 latency observations may miss its target before the
    budget is spent). ``window`` sizes the recent-observation window the
    burn rate is computed over: ``burn = recent_breach_rate / budget``,
    so burn 1.0 spends the budget exactly on schedule and
    ``cfg.burn_alert`` (default 2x) flags paying it down too fast."""

    name: str = "default"
    ttft_target_s: Optional[float] = 1.0
    tpot_target_s: Optional[float] = 0.25
    budget: float = 0.01
    window: int = 64

    def __post_init__(self):
        if not 0.0 < self.budget <= 1.0:
            raise ValueError("budget must be in (0, 1]")
        if self.window < 1:
            raise ValueError("window must be >= 1")
        for f in ("ttft_target_s", "tpot_target_s"):
            v = getattr(self, f)
            if v is not None and v <= 0:
                raise ValueError(f"{f} must be positive (or None)")


class ErrorBudget:
    """Streaming breach accounting for one :class:`SLOConfig`."""

    def __init__(self, cfg: SLOConfig):
        self.cfg = cfg
        self.events = 0
        self.breaches = 0
        self.breach_kinds: Dict[str, int] = {"ttft": 0, "tpot": 0}
        self.recent: deque = deque(maxlen=cfg.window)

    def observe(self, kind: str, seconds: float) -> bool:
        """Record one latency observation; returns True on breach."""
        target = getattr(self.cfg, f"{kind}_target_s")
        if target is None:
            return False
        self.events += 1
        breached = seconds > target
        self.recent.append(1 if breached else 0)
        if breached:
            self.breaches += 1
            self.breach_kinds[kind] += 1
        return breached

    def budget_remaining(self) -> float:
        """Fraction of the error budget left (1.0 untouched, 0.0 spent)."""
        if not self.events:
            return 1.0
        allowed = self.events * self.cfg.budget
        return max(0.0, 1.0 - self.breaches / allowed) if allowed else 0.0

    def burn_rate(self) -> float:
        """Recent breach rate relative to the allowed rate (1.0 = on
        budget; 2.0 = burning twice as fast as allowed)."""
        if not self.recent:
            return 0.0
        return (sum(self.recent) / len(self.recent)) / self.cfg.budget

    def as_dict(self) -> dict:
        return {
            "class": self.cfg.name,
            "ttft_target_s": self.cfg.ttft_target_s,
            "tpot_target_s": self.cfg.tpot_target_s,
            "budget": self.cfg.budget,
            "events": self.events,
            "breaches": self.breaches,
            "breach_kinds": dict(self.breach_kinds),
            "budget_remaining": round(self.budget_remaining(), 4),
            "burn_rate": round(self.burn_rate(), 4),
            "recent_window": len(self.recent),
        }


def _metric_suffix(name: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_]", "_", name)


# -------------------------------------------------------------- watchdog

_FIRE_LOG_CAP = 256


class PerfWatchdog:
    """Streaming anomaly detection over one engine's instruments.

    Construction attaches to the engine (``engine.watchdog = self``) so
    :meth:`DecodeEngine.decode_tick` invokes :meth:`on_tick` once per
    tick. Detector fires are (1) appended to :attr:`fires`, (2) counted
    in the registry (``watchdog_fires_total{detector=...}``), (3)
    recorded as ``watchdog`` flight-ring events, and (4) — with
    ``cfg.dump`` — armed as full postmortem bundles via the engine's
    flight recorder, reason ``watchdog-<detector>``, context naming the
    detector and the tripping metric window.
    """

    def __init__(self, engine, config: Optional[WatchConfig] = None, *,
                 slos: Optional[List[SLOConfig]] = None, calibration=None):
        self.engine = engine
        self.cfg = config or WatchConfig()
        self.calibration = calibration
        self.ticks = 0
        self.fires: List[dict] = []
        self.total_fires = 0
        self._prev_retraces: Optional[int] = None

        self.tick_spike = TickSpikeDetector(self.cfg)
        self.retrace_storm = RetraceStormDetector(self.cfg)
        self.preempt_churn = PreemptChurnDetector(self.cfg)
        self.occupancy = OccupancyDetector(self.cfg, calibration)
        self.prefix_hit = HitRateDropDetector(self.cfg)
        self.degrade_flap = FlapDetector(self.cfg)
        self._detectors = (
            self.tick_spike, self.retrace_storm, self.preempt_churn,
            self.occupancy, self.prefix_hit, self.degrade_flap,
        )
        # slo_burn shares the firing bookkeeping but is driven by budget
        # state, not a windowed metric of its own
        self._slo_det = _Detector(self.cfg)
        self._slo_det.name = "slo_burn"

        self.budgets: Dict[str, ErrorBudget] = {}
        metrics = engine.metrics
        self._fires_counter = metrics.counter(
            "watchdog_fires_total", help="detector firings",
            labelnames=("detector",),
        )
        self._breach_counter = metrics.counter(
            "slo_breaches_total", help="SLO latency breaches",
            labelnames=("klass", "kind"),
        )
        self._event_counter = metrics.counter(
            "slo_events_total", help="SLO latency observations",
            labelnames=("klass",),
        )
        for slo in slos or []:
            self.add_slo(slo)
        if calibration is not None:
            calibration.register_gauges(metrics)
        engine.watchdog = self

    # ------------------------------------------------------------- SLOs
    def add_slo(self, slo: SLOConfig) -> ErrorBudget:
        if slo.name in self.budgets:
            raise ValueError(f"duplicate SLO class {slo.name!r}")
        budget = self.budgets[slo.name] = ErrorBudget(slo)
        suffix = _metric_suffix(slo.name)
        self.engine.metrics.gauge_fn(
            f"slo_budget_remaining_{suffix}", budget.budget_remaining,
            help=f"error budget left for class {slo.name!r}",
        )
        self.engine.metrics.gauge_fn(
            f"slo_burn_rate_{suffix}", budget.burn_rate,
            help=f"budget burn rate for class {slo.name!r}",
        )
        return budget

    def observe_latency(self, klass: str, kind: str, seconds: float) -> bool:
        """Scheduler hook: one TTFT/TPOT observation for a request class.
        Unknown classes are ignored (the scheduler always reports; only
        declared SLOs are budgeted). Returns True on breach."""
        budget = self.budgets.get(klass)
        if budget is None:
            return False
        self._event_counter.labels(klass=klass).inc()
        breached = budget.observe(kind, seconds)
        if breached:
            self._breach_counter.labels(klass=klass, kind=kind).inc()
            self.engine.flight.record(
                "slo_breach", klass=klass, metric=kind,
                seconds=round(seconds, 6),
                target=getattr(budget.cfg, f"{kind}_target_s"),
            )
        return breached

    # ------------------------------------------------------------- ticks
    def on_tick(self, tick_ms: float) -> List[dict]:
        """Engine hook, once per decode tick. Returns this tick's
        firings (usually empty)."""
        eng = self.engine
        t = self.ticks
        self.ticks += 1
        fired: List[dict] = []

        # the port's counterpart of a retrace is also a CUDA graph capture:
        # a step key's second sighting (a schedule-cache hit) captures its
        # graph, which costs a tick 100-300 ms on the card
        retraces = (
            eng.sched_cache.stats.misses + eng.stats.cascade_retraces
            + eng.stats.step_captures
        )
        explained = (
            self._prev_retraces is not None
            and retraces > self._prev_retraces
        )
        self._prev_retraces = retraces

        f = self.tick_spike.observe(t, tick_ms, explained=explained)
        if f:
            fired.append(f)

        f = self.retrace_storm.observe(t, retraces)
        if f:
            fired.append(f)

        f = self.preempt_churn.observe(t, eng.stats.preemptions)
        if f:
            fired.append(f)

        if eng.tracer.enabled:
            meas, pred, path = self._decode_cost_of_last_tick()
            f = self.occupancy.observe(t, meas, pred, path)
            if f:
                fired.append(f)
                if self.cfg.degrade_on_collapse and eng.guard_cfg is not None:
                    eng.force_degrade(cause="watchdog")

        if eng.prefix_cache is not None:
            pc = eng.prefix_cache.stats
            f = self.prefix_hit.observe(
                t, int(pc.hits), int(pc.hits + pc.misses)
            )
            if f:
                fired.append(f)

        f = self.degrade_flap.observe(t, eng.degraded_gauge.value)
        if f:
            fired.append(f)

        for klass, budget in self.budgets.items():
            if len(budget.recent) < self.cfg.slo_min_events:
                continue
            burn = budget.burn_rate()
            if burn >= self.cfg.burn_alert and not self._slo_det._gated(t):
                fired.append(self._slo_det._fire(t, {
                    "klass": klass,
                    "burn_rate": round(burn, 3),
                    "threshold": self.cfg.burn_alert,
                    "budget_remaining": round(budget.budget_remaining(), 4),
                    "window": list(budget.recent),
                }))

        for f in fired:
            self._on_fire(f)
        return fired

    def _decode_cost_of_last_tick(self):
        """Measured vs predicted decode ms for the tick that just closed,
        summed over its ``decode_kernel`` spans (a tick can run several
        fallback passes). Path label: the first span's, they share a tick."""
        meas = pred = 0.0
        path = "fast"
        for sp in self.engine.tracer.tick_spans():
            if sp["name"] != "decode_kernel":
                continue
            meta = sp.get("meta") or {}
            meas += sp.get("ms", 0.0)
            pred += (
                float(meta.get("pred_mem_ms") or 0.0)
                + float(meta.get("pred_compute_ms") or 0.0)
            )
            path = meta.get("path", path)
        return meas, pred, path

    def _on_fire(self, firing: dict):
        self.total_fires += 1
        self.fires.append(firing)
        if len(self.fires) > _FIRE_LOG_CAP:
            del self.fires[:-_FIRE_LOG_CAP]
        det = firing["detector"]
        self._fires_counter.labels(detector=det).inc()
        eng = self.engine
        eng.flight.record(
            "watchdog", detector=det, watch_tick=firing["tick"],
            tick=int(eng.stats.ticks),
        )
        if self.cfg.dump:
            ctx = {k: v for k, v in firing.items() if k != "detector"}
            eng._flight_dump(f"watchdog-{det}", detector=det, **ctx)

    # ---------------------------------------------------------- exports
    def fire_counts(self) -> Dict[str, int]:
        out = {d.name: d.fires for d in self._detectors}
        out[self._slo_det.name] = self._slo_det.fires
        return out

    def as_dict(self) -> dict:
        """JSON snapshot — embed under a trace's ``meta.watchdog`` (via
        ``tracer.save(extra={"watchdog": wd.as_dict()})``) so ``python
        -m repro_torch.obs report`` renders the detector timeline and budget
        table."""
        return {
            "format": 1,
            "ticks": self.ticks,
            "total_fires": self.total_fires,
            "fire_counts": self.fire_counts(),
            "fires": list(self.fires),
            "config": asdict(self.cfg),
            "slo": {k: b.as_dict() for k, b in self.budgets.items()},
            "calibration": (
                self.calibration.as_dict()
                if self.calibration is not None else None
            ),
        }
