"""Flight recorder: a bounded ring of recent serving events + postmortem
dumps (port of ``repro.obs.flight``).

The engine records one compact event per tick (and one per preemption)
into a fixed-capacity ring buffer -- cheap enough to stay on in
production. When something goes wrong, :meth:`dump` snapshots the ring
plus a reason and context into a JSON postmortem bundle: "what happened
in the last N ticks before this", answerable after the fact with no
tracing enabled. The perf watchdog dumps on every detector fire; the
self-healing guards dump on a degrade, a poison and a failed audit, and
the engine on a tick whose fault injector fired (each fire is a
``fault_fire`` event).
"""
from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import List, Optional

__all__ = ["FlightRecorder", "load_flight_dump"]

FLIGHT_FORMAT_VERSION = 1


class FlightRecorder:
    """Bounded ring buffer of serving events with JSON postmortem dumps.

    Parameters
    ----------
    capacity:
        Max events retained; oldest are evicted. 256 covers well over
        100 ticks of context at one tick event + occasional extras.
    dump_dir:
        When set, :meth:`dump` also writes ``flight-<reason>-t<tick>-
        <n>.json`` files here (directory created on first dump).
    """

    def __init__(self, capacity: int = 256,
                 dump_dir: Optional[str] = None):
        self._ring: deque = deque(maxlen=int(capacity))
        self.dump_dir = dump_dir
        self.dumps = 0
        self.last_dump: Optional[dict] = None
        self.last_dump_path: Optional[str] = None
        self._seq = 0
        self._epoch = time.perf_counter()

    @property
    def capacity(self) -> int:
        return self._ring.maxlen

    def record(self, kind: str, **data) -> None:
        """Append one event. ``kind`` is a short tag (``tick``,
        ``fault_fire``, ``degrade``, ``poison``, ``audit_failure``, ...);
        ``data`` must be JSON-serializable."""
        self._seq += 1
        ev = {
            "seq": self._seq,
            "t": time.perf_counter() - self._epoch,
            "kind": kind,
        }
        if data:
            ev.update(data)
        self._ring.append(ev)

    def events(self) -> List[dict]:
        return list(self._ring)

    def dump(self, reason: str, path: Optional[str] = None,
             extra: Optional[dict] = None) -> dict:
        """Snapshot the ring into a postmortem bundle.

        Always returns the bundle and keeps it as :attr:`last_dump`;
        writes JSON to ``path`` if given, else to :attr:`dump_dir` (if
        configured) under a generated name. Never raises on I/O — a
        postmortem writer must not take down the serving loop — but
        records the write error in the bundle."""
        self.dumps += 1
        bundle = {
            "format": FLIGHT_FORMAT_VERSION,
            "reason": reason,
            "dump_index": self.dumps,
            "wall_time": time.time(),
            "events": list(self._ring),
        }
        if extra:
            bundle["context"] = extra
        if path is None and self.dump_dir is not None:
            tick = bundle.get("context", {}).get("tick", "x")
            safe = "".join(
                c if c.isalnum() or c in "-_" else "-" for c in reason
            )
            path = os.path.join(
                self.dump_dir,
                f"flight-{safe}-t{tick}-{self.dumps}.json",
            )
        if path is not None:
            try:
                d = os.path.dirname(str(path))
                if d:
                    os.makedirs(d, exist_ok=True)
                with open(path, "w") as f:
                    json.dump(bundle, f, indent=1, default=str)
                self.last_dump_path = str(path)
            except OSError as e:
                bundle["write_error"] = repr(e)
        self.last_dump = bundle
        return bundle

    def as_dict(self) -> dict:
        return {
            "capacity": self.capacity,
            "events": len(self._ring),
            "dumps": self.dumps,
            "last_dump_path": self.last_dump_path,
        }


def load_flight_dump(path) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if doc.get("format") != FLIGHT_FORMAT_VERSION:
        raise ValueError(
            f"unsupported flight-dump format {doc.get('format')!r} "
            f"in {path}"
        )
    return doc
