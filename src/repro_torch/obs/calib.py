"""Roofline calibration: fit measured/predicted correction factors (port
of ``repro.obs.calib``).

The roofline model (:mod:`repro_torch.roofline.analysis`) predicts decode-tick
cost from the NVIDIA H100 SXM5's published peaks (``PEAK_FLOPS``,
``HBM_BW``). Those constants are *hardware* bounds: on the CPU (the
kernels' plain versions) measured ``decode_kernel`` span times sit orders
of magnitude above the prediction, on the card the span times the whole
decode step where the prediction counts one attention pass, and each
dispatch path (two-call vs fused vs cascade) carries its own launch and
layout overhead. A hardcoded
"measured/predicted should be ~1" band is therefore useless for anomaly
detection.

This module fits per-path correction factors from an actual trace:

    factor(path) = median over that path's decode_kernel spans of
                   measured_ms / (pred_mem_ms + pred_compute_ms)

and persists them as a small JSON document (``obs/calib.json`` by
convention). Consumers:

  * :class:`repro_torch.obs.watch.OccupancyDetector` uses ``factor(path)`` as
    the baseline its occupancy band multiplies — calibrated, not
    hardcoded;
  * ``python -m repro_torch.obs report --calib calib.json`` renders the
    attribution occupancy column as measured vs *calibrated* prediction;
  * :meth:`Calibration.register_gauges` exports each factor as a
    registry callback gauge (``roofline_calib_factor_<path>``).

Path labels come from the engine's span annotations: ``fast`` (batched
fast path), ``cascade`` (shared-prefix suffix schedule), ``legacy``
(per-tick schedule), ``fallback`` (the guards' degraded passes at levels
1 and 2).
"""
from __future__ import annotations

import json
import statistics
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

__all__ = [
    "CALIB_FORMAT_VERSION",
    "Calibration",
    "fit_calibration",
    "load_calibration",
]

CALIB_FORMAT_VERSION = 1


@dataclass
class Calibration:
    """Per-path measured/predicted correction factors.

    ``default`` (the all-path median) answers for paths absent from the
    fitting trace, so a cascade-free calibration still gives the cascade
    path a sane platform-scale baseline."""

    factors: Dict[str, float] = field(default_factory=dict)
    default: float = 1.0
    platform: str = ""
    samples: Dict[str, int] = field(default_factory=dict)

    def factor(self, path: str) -> float:
        return self.factors.get(path, self.default)

    def calibrated_ms(self, pred_ms: float, path: str) -> float:
        """Scale a raw roofline prediction into measured-time units."""
        return pred_ms * self.factor(path)

    def as_dict(self) -> dict:
        return {
            "format": CALIB_FORMAT_VERSION,
            "platform": self.platform,
            "default": self.default,
            "factors": dict(self.factors),
            "samples": dict(self.samples),
        }

    @classmethod
    def from_dict(cls, doc: dict) -> "Calibration":
        if doc.get("format") != CALIB_FORMAT_VERSION:
            raise ValueError(
                f"unsupported calibration format {doc.get('format')!r} "
                f"(expected {CALIB_FORMAT_VERSION})"
            )
        return cls(
            factors={k: float(v) for k, v in doc.get("factors", {}).items()},
            default=float(doc.get("default", 1.0)),
            platform=str(doc.get("platform", "")),
            samples={k: int(v) for k, v in doc.get("samples", {}).items()},
        )

    def save(self, path) -> None:
        Path(path).write_text(json.dumps(self.as_dict(), indent=2) + "\n")

    def register_gauges(self, registry) -> None:
        """Export factors as callback gauges (floats survive — stored
        gauges are integer-valued)."""
        for p, v in sorted(self.factors.items()):
            registry.gauge_fn(
                f"roofline_calib_factor_{p}", lambda v=v: v,
                help=f"measured/predicted decode ms factor for path {p!r}",
            )


def fit_calibration(doc: dict, min_samples: int = 3) -> Calibration:
    """Fit factors from a trace document (``Tracer.to_dict`` /
    ``load_trace``). Paths with fewer than ``min_samples`` spans fall
    back to the global default rather than pinning a noisy median."""
    by_path: Dict[str, List[float]] = {}
    for sp in doc.get("spans", []):
        if sp.get("name") != "decode_kernel":
            continue
        meta = sp.get("meta") or {}
        pred = (
            float(meta.get("pred_mem_ms") or 0.0)
            + float(meta.get("pred_compute_ms") or 0.0)
        )
        meas = float(sp.get("ms") or 0.0)
        if pred <= 0.0 or meas <= 0.0:
            continue
        by_path.setdefault(meta.get("path", "fast"), []).append(meas / pred)
    all_ratios = [r for rs in by_path.values() for r in rs]
    if not all_ratios:
        raise ValueError(
            "no decode_kernel spans with roofline predictions in trace "
            "(was the tracer enabled?)"
        )
    default = statistics.median(all_ratios)
    factors = {
        p: statistics.median(rs)
        for p, rs in by_path.items()
        if len(rs) >= min_samples
    }
    platform = str((doc.get("meta") or {}).get("platform", ""))
    return Calibration(
        factors=factors,
        default=default,
        platform=platform,
        samples={p: len(rs) for p, rs in by_path.items()},
    )


def load_calibration(path) -> Calibration:
    return Calibration.from_dict(json.loads(Path(path).read_text()))
