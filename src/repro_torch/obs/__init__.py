"""Serving-wide observability (port of ``repro.obs``): tracing, metrics
registry, flight recorder, perf watchdog, roofline calibration.

  * :mod:`repro_torch.obs.trace` -- a structured tracer with nestable
    spans (``tick`` > ``schedule_build`` / ``decode_kernel`` / ...),
    per-request lifecycle timelines (QUEUED -> PREFILLING -> DECODING ->
    FINISHED with TTFT/TPOT/queue-wait per uid), and a JSON trace-file
    format that :mod:`repro_torch.obs.report` renders;
  * :mod:`repro_torch.obs.metrics` -- a labeled metrics registry
    (Counter / Gauge / Histogram) with JSON and Prometheus-text exporters;
    the engine, scheduler, kvpool and prefix cache register into it;
  * :mod:`repro_torch.obs.flight` -- a bounded ring of recent serving
    events, dumped to a JSON postmortem bundle on demand and on every
    watchdog fire;
  * :mod:`repro_torch.obs.watch` -- the perf watchdog: streaming anomaly
    detectors (tick spikes, retrace and capture storms, occupancy
    collapse, prefix hit-rate drops, degrade flapping) plus per-class SLO
    error budgets with burn-rate alerting;
  * :mod:`repro_torch.obs.calib` -- fitted measured/predicted roofline
    correction factors for the watchdog's occupancy band and the report.

Disabled, each costs the engine one attribute check per hook. On the card
a live ``decode_kernel``, ``prefill_chunk`` or ``spec_verify`` span
synchronises the stream after its step to time the device; spans never
run inside a captured step's body.

``python -m repro_torch.obs report TRACE`` renders per-tick predicted-vs-
measured attribution and per-request timelines from a recorded trace;
``python -m repro_torch.obs flight DUMP`` a flight bundle;
``python -m repro_torch.obs calibrate TRACE --out calib.json`` fits the
correction factors.
"""
from repro_torch.obs.calib import Calibration, fit_calibration, load_calibration
from repro_torch.obs.flight import FlightRecorder, load_flight_dump
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_bounds,
    parse_prometheus,
)
from repro_torch.obs.trace import NULL_TRACER, Tracer, load_trace
from repro_torch.obs.watch import (
    ErrorBudget,
    PerfWatchdog,
    SLOConfig,
    WatchConfig,
)

__all__ = [
    "Calibration",
    "fit_calibration",
    "load_calibration",
    "ErrorBudget",
    "PerfWatchdog",
    "SLOConfig",
    "WatchConfig",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_bounds",
    "parse_prometheus",
    "Tracer",
    "NULL_TRACER",
    "load_trace",
    "FlightRecorder",
    "load_flight_dump",
]
