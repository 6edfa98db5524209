"""Low-overhead structured tracer for the decode serving loop (port of
``repro.obs.trace``).

Two complementary views of one serving run:

  * **Spans** — nestable timed regions (``tick`` > ``schedule_build`` /
    ``prefill_chunk`` / ``decode_kernel`` / ``merge`` / ``cascade_group``
    / ``cow`` / ``audit`` / ``admit``). Each finished span records wall
    time, optional device-sync time (the portion spent waiting for the
    card: a CUDA stream synchronisation), its nesting depth, the tick index it ran in,
    and free-form metadata (schedule tiles/segments/KV bytes, degrade
    level, ...) that :mod:`repro_torch.obs.report` attributes against the
    roofline cost model.
  * **Request timelines** — per-uid lifecycle events
    (QUEUED -> PREFILLING -> DECODING -> FINISHED) plus an O(1)
    streaming token-gap accumulator, from which :meth:`request_summary`
    derives TTFT, TPOT, and queue wait without storing per-token events.

Overhead discipline: a disabled tracer (``enabled=False``, or the module
singleton :data:`NULL_TRACER`) does no timing, no allocation, and no
dict building — every public method early-outs and :meth:`span` returns
a shared no-op context manager whose truthiness is ``False``, so callers
can gate optional work (e.g. an extra stream synchronisation for sync
attribution) with ``if sp:``.
"""
from __future__ import annotations

import json
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["Tracer", "NULL_TRACER", "load_trace"]

TRACE_FORMAT_VERSION = 1


class _NullSpan:
    """Shared do-nothing span: context manager, falsy, inert methods."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def annotate(self, **meta):
        pass

    def add_sync(self, seconds: float) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    """A live span. Created only by an enabled :class:`Tracer`."""

    __slots__ = ("tracer", "name", "meta", "depth", "tick",
                 "_t0", "sync_s")

    def __init__(self, tracer: "Tracer", name: str, meta: dict):
        self.tracer = tracer
        self.name = name
        self.meta = meta
        self.depth = 0
        self.tick = tracer.tick_index
        self._t0 = 0.0
        self.sync_s = 0.0

    def __bool__(self):
        return True

    def __enter__(self):
        tr = self.tracer
        if self.name == "tick" and not tr._stack:
            tr.tick_index += 1
            self.tick = tr.tick_index
        self.depth = len(tr._stack)
        tr._stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        ms = (time.perf_counter() - self._t0) * 1e3
        tr = self.tracer
        if tr._stack and tr._stack[-1] is self:
            tr._stack.pop()
        rec = {
            "name": self.name,
            "tick": self.tick,
            "depth": self.depth,
            "ms": ms,
        }
        if self.sync_s:
            rec["sync_ms"] = self.sync_s * 1e3
        if self.meta:
            rec["meta"] = self.meta
        tr._spans.append(rec)
        return False

    def annotate(self, **meta) -> None:
        self.meta.update(meta)

    def add_sync(self, seconds: float) -> None:
        """Attribute ``seconds`` of this span's wall time to device sync:
        the host waiting on the card in a CUDA stream synchronisation
        (``torch.cuda.current_stream(device).synchronize()``), which the
        engine runs after a step only while the span is live."""
        self.sync_s += seconds


class _ReqTimeline:
    __slots__ = ("events", "tokens", "first_token_t", "last_token_t",
                 "gap_sum", "gap_min", "gap_max")

    def __init__(self):
        self.events: List[dict] = []
        self.tokens = 0
        self.first_token_t: Optional[float] = None
        self.last_token_t: Optional[float] = None
        self.gap_sum = 0.0
        self.gap_min = float("inf")
        self.gap_max = 0.0


class Tracer:
    """Structured tracer; see module docstring.

    Parameters
    ----------
    enabled:
        When False every method is a no-op (``NULL_TRACER`` is a module-
        wide disabled instance; prefer it over constructing your own).
    capacity:
        Max finished spans retained (ring buffer; oldest dropped).
    """

    def __init__(self, enabled: bool = True, capacity: int = 65536):
        self.enabled = bool(enabled)
        self.tick_index = -1
        self._spans: deque = deque(maxlen=int(capacity))
        self._stack: List[_Span] = []
        self._requests: Dict[Any, _ReqTimeline] = {}
        self._epoch = time.perf_counter()

    # --------------------------------------------------------------- spans
    def span(self, name: str, **meta):
        """Open a nestable span: ``with tracer.span("tick"): ...``."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, meta)

    def annotate(self, **meta) -> None:
        """Attach metadata to the innermost open span (no-op when
        disabled or no span is open) — lets a callee annotate the span
        its caller opened without threading the span object through."""
        if self._stack:
            self._stack[-1].meta.update(meta)

    def current_span(self):
        """Innermost open span, or the shared null span."""
        return self._stack[-1] if self._stack else _NULL_SPAN

    @property
    def spans(self) -> List[dict]:
        return list(self._spans)

    # ----------------------------------------------------- request timeline
    def _now(self) -> float:
        return time.perf_counter() - self._epoch

    def request_event(self, uid, state: str, **meta) -> None:
        """Record a lifecycle transition (QUEUED/PREFILLING/DECODING/
        FIRST_TOKEN/PREEMPTED/FINISHED/FAILED/CANCELLED) for ``uid``."""
        if not self.enabled:
            return
        tl = self._requests.get(uid)
        if tl is None:
            tl = self._requests[uid] = _ReqTimeline()
        ev = {"t": self._now(), "state": state, "tick": self.tick_index}
        if meta:
            ev["meta"] = meta
        tl.events.append(ev)

    def request_token(self, uid) -> None:
        """O(1) per-token accounting: streams inter-token gaps into
        sum/min/max so TPOT derives without per-token event storage."""
        if not self.enabled:
            return
        tl = self._requests.get(uid)
        if tl is None:
            tl = self._requests[uid] = _ReqTimeline()
        t = self._now()
        tl.tokens += 1
        if tl.first_token_t is None:
            tl.first_token_t = t
        else:
            gap = t - tl.last_token_t
            tl.gap_sum += gap
            tl.gap_min = min(tl.gap_min, gap)
            tl.gap_max = max(tl.gap_max, gap)
        tl.last_token_t = t

    def request_summary(self, uid) -> Optional[dict]:
        """TTFT / TPOT / queue-wait summary for one request, derived
        from its lifecycle events and token-gap accumulator. None if the
        uid was never seen."""
        tl = self._requests.get(uid)
        if tl is None:
            return None
        t_of = {}
        for ev in tl.events:
            t_of.setdefault(ev["state"], ev["t"])   # first occurrence
        out: dict = {
            "uid": uid,
            "events": list(tl.events),
            "tokens": tl.tokens,
        }
        q, a = t_of.get("QUEUED"), t_of.get("PREFILLING")
        if q is not None and a is not None:
            out["queue_wait_s"] = a - q
        if q is not None and tl.first_token_t is not None:
            out["ttft_s"] = tl.first_token_t - q
        gaps = tl.tokens - 1
        if gaps > 0:
            out["tpot_s"] = {
                "mean": tl.gap_sum / gaps,
                "min": tl.gap_min,
                "max": tl.gap_max,
                "gaps": gaps,
            }
        return out

    def request_uids(self) -> list:
        return list(self._requests)

    def tick_spans(self, tick: Optional[int] = None) -> list:
        """Finished spans of one tick (default: the latest), in record
        order. Walks the ring from the right and stops at the first
        older span, so per-tick consumers (the perf watchdog) pay for
        the tick's spans, not the whole capacity-65536 ring."""
        if not self.enabled:
            return []
        t = self.tick_index if tick is None else int(tick)
        out = []
        for sp in reversed(self._spans):
            if sp["tick"] > t:
                continue
            if sp["tick"] < t:
                break
            out.append(sp)
        out.reverse()
        return out

    # ----------------------------------------------------------------- io
    def to_dict(self, extra: Optional[dict] = None) -> dict:
        doc = {
            "format": TRACE_FORMAT_VERSION,
            "ticks": self.tick_index + 1,
            "spans": list(self._spans),
            "requests": {
                str(uid): self.request_summary(uid)
                for uid in self._requests
            },
        }
        if extra:
            doc["meta"] = extra
        return doc

    def save(self, path, extra: Optional[dict] = None) -> dict:
        """Write the trace as JSON (the format ``python -m repro_torch.obs
        report`` consumes); returns the document."""
        doc = self.to_dict(extra=extra)
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, default=str)
        return doc


def load_trace(path) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if doc.get("format") != TRACE_FORMAT_VERSION:
        raise ValueError(
            f"unsupported trace format {doc.get('format')!r} in {path}"
        )
    return doc


NULL_TRACER = Tracer(enabled=False, capacity=1)
"""Module-wide disabled tracer: the default everywhere tracing is
optional, so hot paths pay one attribute check and nothing else."""
