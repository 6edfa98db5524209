"""Unified labeled metrics registry for the serving stack (port of
``repro.obs.metrics``).

:class:`Histogram`, :class:`Gauge` and :class:`Counter` stream their
observations; a :class:`MetricsRegistry` names, labels, and exports them.

The registry is the single sink the engine, scheduler, kvpool and prefix
cache register into -- instead of each subsystem hand-rolling its own
stats dict shape, a metric is created once
(``registry.counter("engine_ticks")``) and every consumer (the
``EngineStats`` attributes, the Prometheus exporter, the obs report CLI)
reads the same object. Recording stays O(1) and allocation-free on the
hot path; the exporters do all formatting work at read time.

Exporters:

  * :meth:`MetricsRegistry.as_dict` — JSON-friendly nested dict (the
    shape ``EngineStats``-style consumers expect);
  * :meth:`MetricsRegistry.to_prometheus` — Prometheus text exposition
    format (``# TYPE`` headers, ``{label="v"}`` series, cumulative
    ``_bucket``/``_sum``/``_count`` histogram series);
  * :func:`parse_prometheus` — the inverse of ``to_prometheus``, used by
    the exporter round-trip tests (and handy for scraping in tests).
"""
from __future__ import annotations

import bisect
import math
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_bounds",
    "parse_prometheus",
]


class Gauge:
    """A current-value gauge with peak and time-above-zero tracking.

    Used for the engine's degraded-mode gauge: ``value`` is the number of
    slots currently off the fast path, ``peak`` the worst simultaneous
    degradation seen, and ``ticks_nonzero`` how many updates observed a
    non-zero value (moved by the guards,
    :mod:`repro_torch.serving.guards`)."""

    def __init__(self):
        self.value = 0
        self.peak = 0
        self.updates = 0
        self.ticks_nonzero = 0

    def set(self, value: int) -> None:
        self.value = int(value)
        self.peak = max(self.peak, self.value)
        self.updates += 1
        if self.value:
            self.ticks_nonzero += 1

    def as_dict(self) -> dict:
        return {
            "value": self.value,
            "peak": self.peak,
            "updates": self.updates,
            "ticks_nonzero": self.ticks_nonzero,
        }

    def __repr__(self):
        return (
            f"Gauge(value={self.value}, peak={self.peak}, "
            f"nonzero={self.ticks_nonzero}/{self.updates})"
        )


class Counter:
    """A monotonically-increasing count. ``inc`` is the public API; the
    EngineStats compat shim also assigns ``value`` directly to preserve
    ``stats.field += n`` call sites."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def as_dict(self) -> dict:
        return {"value": self.value}

    def __repr__(self):
        return f"Counter(value={self.value})"


def default_bounds(
    lo: float = 1e-4, hi: float = 100.0, per_decade: int = 5
) -> List[float]:
    """Geometric bucket upper bounds covering [lo, hi] (seconds by default:
    0.1 ms .. 100 s, 5 buckets per decade ~ 58% resolution)."""
    n = int(math.ceil(math.log10(hi / lo) * per_decade)) + 1
    return [lo * 10 ** (i / per_decade) for i in range(n)]


class Histogram:
    """Fixed-bucket streaming histogram (+ exact count/sum/min/max).

    Observations above the last bound land in an overflow bucket whose
    "upper edge" is the max ever seen; below the first bound, in the first
    bucket. O(log B) per observe (bisect), O(B) memory, mergeable.
    """

    def __init__(self, bounds: Optional[Sequence[float]] = None):
        self.bounds = list(bounds) if bounds is not None else default_bounds()
        self.counts = [0] * (len(self.bounds) + 1)   # +1 overflow
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        self.count += 1
        self.sum += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        self.counts[bisect.bisect_left(self.bounds, value)] += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """Approximate p-th percentile: linear interpolation inside the
        winning bucket, clamped to the exact [min, max]. Empty histograms
        report 0.0 (never the ±inf sentinels in ``min``/``max``), and ``p``
        is clamped into [0, 100]."""
        if not self.count:
            return 0.0
        rank = min(max(p, 0.0), 100.0) / 100.0 * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if acc + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else self.min
                hi = self.bounds[i] if i < len(self.bounds) else self.max
                frac = (rank - acc) / c
                val = lo + (hi - lo) * frac
                return min(max(val, self.min), self.max)
            acc += c
        return self.max

    def merge(self, other: "Histogram") -> "Histogram":
        """Accumulate ``other`` into ``self``. The bucket arrays only add
        meaningfully when both sides used the same bounds — merging
        mismatched-bounds histograms would silently misalign every bucket
        (count N of "under 1ms" landing in "under 10ms"), so that case is
        a ``ValueError``; :meth:`rebucket` converts a histogram onto new
        bounds first when cross-bounds aggregation is genuinely wanted."""
        if other.bounds != self.bounds:
            raise ValueError(
                f"histogram bucket bounds differ "
                f"({len(self.bounds)} bounds vs {len(other.bounds)}); "
                "rebucket() one side onto the other's bounds first"
            )
        self.counts = [a + b for a, b in zip(self.counts, other.counts)]
        self.count += other.count
        self.sum += other.sum
        # min/max are ±inf sentinels on an empty side; plain min/max keeps
        # them correct, and a doubly-empty merge stays the empty histogram
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    def rebucket(self, bounds: Sequence[float]) -> "Histogram":
        """A NEW histogram over ``bounds`` carrying this one's
        observations: exact ``count``/``sum``/``min``/``max`` transfer
        verbatim; bucket counts redistribute by each source bucket's
        representative value (its midpoint, clamped to the observed
        [min, max]) — approximate by construction, like the percentiles,
        but it makes cross-bounds :meth:`merge` legal and honest."""
        out = Histogram(bounds)
        if not self.count:
            return out
        out.count = self.count
        out.sum = self.sum
        out.min = self.min
        out.max = self.max
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            lo = self.bounds[i - 1] if i > 0 else self.min
            hi = self.bounds[i] if i < len(self.bounds) else self.max
            rep = min(max((lo + hi) / 2.0, self.min), self.max)
            out.counts[bisect.bisect_left(out.bounds, rep)] += c
        return out

    def as_dict(self) -> dict:
        """JSON-friendly summary (for EngineStats and telemetry dumps)."""
        if not self.count:
            return {"count": 0}
        return {
            "count": self.count,
            "mean": self.mean,
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
        }

    def __repr__(self):
        if not self.count:
            return "Histogram(empty)"
        return (
            f"Histogram(n={self.count}, mean={self.mean:.4g}, "
            f"p50={self.percentile(50):.4g}, p99={self.percentile(99):.4g})"
        )


# --------------------------------------------------------------- registry

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Family:
    """One named metric family: the set of children keyed by label values.

    Families created with no ``labelnames`` are transparent — the registry
    hands back the single unlabeled child directly, so
    ``registry.histogram("ttft")`` *is* a :class:`Histogram` and existing
    ``.observe()/.as_dict()`` call sites keep working unchanged."""

    def __init__(self, name: str, kind: str, help: str,
                 labelnames: Sequence[str], make: Callable):
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self._make = make
        self.children: Dict[LabelKey, object] = {}

    def labels(self, **labels):
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labelnames}, "
                f"got {tuple(labels)}"
            )
        key = _label_key(labels)
        child = self.children.get(key)
        if child is None:
            child = self.children[key] = self._make()
        return child


class MetricsRegistry:
    """Named, labeled Counter/Gauge/Histogram registry with exporters.

    Creation is idempotent: asking for an existing name returns the same
    object (with a kind/label check), so subsystems can register in any
    order. ``gauge_fn`` registers a zero-storage *callback* gauge —
    sampled at export time — which is how the kvpool/prefix-cache/
    schedule-cache publish their live occupancy numbers without a
    per-tick copy."""

    def __init__(self):
        self._families: Dict[str, _Family] = {}
        self._callbacks: Dict[str, Tuple[str, Callable[[], float]]] = {}

    # ------------------------------------------------------------- creation
    def _family(self, name: str, kind: str, help: str,
                labelnames: Sequence[str], make: Callable) -> _Family:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        if name in self._callbacks:
            raise ValueError(f"{name!r} is already a callback gauge")
        fam = self._families.get(name)
        if fam is None:
            fam = self._families[name] = _Family(
                name, kind, help, labelnames, make
            )
        elif fam.kind != kind or fam.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind} "
                f"with labels {fam.labelnames}"
            )
        return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()):
        fam = self._family(name, "counter", help, labelnames, Counter)
        return fam if fam.labelnames else fam.labels()

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()):
        fam = self._family(name, "gauge", help, labelnames, Gauge)
        return fam if fam.labelnames else fam.labels()

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  bounds: Optional[Sequence[float]] = None):
        make = lambda: Histogram(bounds)
        fam = self._family(name, "histogram", help, labelnames, make)
        return fam if fam.labelnames else fam.labels()

    def gauge_fn(self, name: str, fn: Callable[[], float],
                 help: str = "") -> None:
        """Register a callback gauge: ``fn`` is called at export time."""
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        if name in self._families:
            raise ValueError(f"{name!r} is already a stored metric")
        self._callbacks[name] = (help, fn)

    # ------------------------------------------------------------ accessors
    def get(self, name: str):
        """The family (or unlabeled child) registered under ``name``, or
        None. Callback gauges return their current sampled value."""
        if name in self._callbacks:
            return float(self._callbacks[name][1]())
        fam = self._families.get(name)
        if fam is None:
            return None
        return fam if fam.labelnames else fam.labels()

    def names(self) -> List[str]:
        return sorted([*self._families, *self._callbacks])

    # ------------------------------------------------------------ exporters
    def as_dict(self) -> dict:
        """JSON-friendly snapshot. Unlabeled metrics flatten to their
        scalar/summary value; labeled families nest one entry per child
        keyed ``k=v,k=v``."""
        out: dict = {}
        for name, fam in sorted(self._families.items()):
            def render(child):
                if fam.kind == "counter":
                    return child.value
                return child.as_dict()

            if not fam.labelnames:
                out[name] = render(fam.labels())
            else:
                out[name] = {
                    ",".join(f"{k}={v}" for k, v in key): render(child)
                    for key, child in sorted(fam.children.items())
                }
        for name, (_, fn) in sorted(self._callbacks.items()):
            out[name] = float(fn())
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format."""
        lines: List[str] = []
        for name, fam in sorted(self._families.items()):
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            children = (
                sorted(fam.children.items())
                if fam.labelnames else [((), fam.labels())]
            )
            for key, child in children:
                base = dict(key)
                if fam.kind == "counter":
                    lines.append(_series(name, base, child.value))
                elif fam.kind == "gauge":
                    lines.append(_series(name, base, child.value))
                else:
                    acc = 0
                    for i, b in enumerate(child.bounds):
                        acc += child.counts[i]
                        lines.append(_series(
                            f"{name}_bucket", {**base, "le": _fmt(b)}, acc
                        ))
                    lines.append(_series(
                        f"{name}_bucket", {**base, "le": "+Inf"}, child.count
                    ))
                    lines.append(_series(f"{name}_sum", base, child.sum))
                    lines.append(_series(f"{name}_count", base, child.count))
        for name, (help, fn) in sorted(self._callbacks.items()):
            if help:
                lines.append(f"# HELP {name} {help}")
            lines.append(f"# TYPE {name} gauge")
            lines.append(_series(name, {}, float(fn())))
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    return repr(float(v))


def _series(name: str, labels: Dict[str, str], value) -> str:
    val = _fmt(value) if isinstance(value, float) else value
    if labels:
        body = ",".join(
            f'{k}="{v}"' for k, v in sorted(labels.items())
        )
        return f"{name}{{{body}}} {val}"
    return f"{name} {val}"


_SERIES_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"')


def parse_prometheus(text: str) -> Dict[Tuple[str, LabelKey], float]:
    """Parse Prometheus exposition text back into
    ``{(series_name, ((label, value), ...)): value}`` — the inverse of
    :meth:`MetricsRegistry.to_prometheus`, used for round-trip tests."""
    out: Dict[Tuple[str, LabelKey], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SERIES_RE.match(line)
        if not m:
            raise ValueError(f"unparseable series line: {line!r}")
        labels = tuple(sorted(_LABEL_RE.findall(m.group("labels") or "")))
        out[(m.group("name"), labels)] = float(m.group("value"))
    return out
