"""Deterministic, seedable fault injection for the serving stack (copy of
``repro.serving.faults``; numpy only).

A production decode service fails in ways unit tests rarely construct:
allocation storms under memory pressure, NaN tiles out of a miscompiled
kernel, host-memory corruption of the radix trie, latency spikes, and
preemption cascades. This module gives the engine *named injection points*
it can consult at the exact places those failures would surface, so the
chaos tests (``tests/test_torch_chaos.py``) can drive reproducible fault
schedules against the real recovery machinery in
:mod:`repro_torch.serving.guards` / :class:`repro_torch.serving.engine.DecodeEngine`.

Design constraints:

  * **deterministic** — every injection point draws from its own
    ``numpy`` generator seeded from ``(seed, point)``, so firing patterns
    are independent of call-order changes at *other* points and a fixed
    seed replays the exact same fault schedule;
  * **zero-overhead when disabled** — an engine built without an injector
    pays one ``is None`` check per hook; an attached-but-disabled injector
    returns from :meth:`FaultInjector.fire` before touching any counter
    or generator;
  * **windowed** — each :class:`FaultSpec` can restrict firing to a tick
    window (``start``/``stop``), burst several consecutive opportunities
    per trigger, and cap total fires, so tests can assert recovery *after*
    the faults stop.

Injection points (consulted by the engine/scheduler hooks):

  ==============  ========================================================
  point           simulates
  ==============  ========================================================
  page_alloc      :class:`~repro_torch.serving.kvpool.KVPagePool` exhaustion —
                  ``_pool_alloc`` returns ``None`` as if no page were free
  cow_clone       copy-on-write clone failure (``_cow_tile`` -> False)
  nan_output      non-finite decode logits for one victim slot (the guard
                  must quarantine it; no device state is corrupted)
  nan_kv          real device-side corruption: one private KV page of a
                  victim slot is overwritten with NaN
  trie_corrupt    host-memory corruption of a radix-trie node (caught by
                  ``prefix_cache.check()`` audits)
  tick_latency    an artificial latency spike at the top of a tick
  preempt_storm   forced preemption of ``magnitude`` active slots
  ==============  ========================================================
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["FaultSpec", "FaultInjector", "FAULT_POINTS", "corrupt_trie_node"]

FAULT_POINTS = (
    "page_alloc",
    "cow_clone",
    "nan_output",
    "nan_kv",
    "trie_corrupt",
    "tick_latency",
    "preempt_storm",
)


@dataclass(frozen=True)
class FaultSpec:
    """One injection point's firing policy.

    ``rate`` is the per-opportunity fire probability inside the active
    window. ``start``/``stop`` bound the window in injector ticks
    (``stop=None`` = forever; the window is ``[start, stop)``).
    ``burst > 1`` makes every trigger fire that many *consecutive
    opportunities* (an allocation storm rather than scattered failures).
    ``magnitude`` is point-specific: sleep seconds for ``tick_latency``,
    victim count for ``preempt_storm``. ``max_fires`` caps total fires.
    """

    rate: float
    start: int = 0
    stop: Optional[int] = None
    burst: int = 1
    magnitude: float = 0.0
    max_fires: Optional[int] = None

    def __post_init__(self):
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")
        if self.burst < 1:
            raise ValueError("burst must be >= 1")
        if self.stop is not None and self.stop < self.start:
            raise ValueError("stop must be >= start")


class FaultInjector:
    """Named, windowed, seed-deterministic fault source.

    The engine advances the injector clock once per tick
    (:meth:`advance`) and consults :meth:`fire` at each hook. Points
    without a spec never fire and cost one dict miss per opportunity.
    """

    def __init__(self, specs: Optional[Dict[str, FaultSpec]] = None, *,
                 seed: int = 0, enabled: bool = True):
        specs = dict(specs or {})
        for point in specs:
            if point not in FAULT_POINTS:
                raise ValueError(
                    f"unknown injection point {point!r} "
                    f"(known: {', '.join(FAULT_POINTS)})"
                )
        self.specs = specs
        self.seed = int(seed)
        self.enabled = enabled
        self.tick = 0
        self.opportunities: Dict[str, int] = {p: 0 for p in specs}
        self.fires: Dict[str, int] = {p: 0 for p in specs}
        self._burst_left: Dict[str, int] = {p: 0 for p in specs}
        # one generator per point: firing at point A never perturbs the
        # draw stream of point B, so schedules stay reproducible under
        # unrelated engine changes
        self._rngs: Dict[str, np.random.Generator] = {
            p: np.random.default_rng([self.seed, i])
            for i, p in enumerate(FAULT_POINTS) if p in specs
        }
        # extra generator for victim selection (choose), same isolation
        self._choice_rng = np.random.default_rng(
            [self.seed, len(FAULT_POINTS)]
        )
        self.last_fire_tick = -1
        # optional FlightRecorder (repro_torch.obs.flight): every fire logs a
        # ``fault_fire`` event, so a postmortem dump's trailing events
        # always name the injected point. The engine wires this up when
        # it owns both the injector and a recorder.
        self.recorder = None

    # ------------------------------------------------------------------ clock
    def advance(self) -> int:
        """Advance the injector clock (the engine calls this once per
        decode tick, before consulting any point)."""
        self.tick += 1
        return self.tick

    # ------------------------------------------------------------------- fire
    def spec(self, point: str) -> Optional[FaultSpec]:
        return self.specs.get(point)

    def fire(self, point: str) -> bool:
        """One opportunity at ``point``: True = inject the fault now."""
        if not self.enabled:
            return False
        sp = self.specs.get(point)
        if sp is None:
            return False
        self.opportunities[point] += 1
        if self._burst_left[point] > 0:
            self._burst_left[point] -= 1
            self._count_fire(point)
            return True
        if self.tick < sp.start or (
            sp.stop is not None and self.tick >= sp.stop
        ):
            return False
        if sp.max_fires is not None and self.fires[point] >= sp.max_fires:
            return False
        if self._rngs[point].random() >= sp.rate:
            return False
        self._burst_left[point] = sp.burst - 1
        self._count_fire(point)
        return True

    def _count_fire(self, point: str):
        self.fires[point] += 1
        self.last_fire_tick = self.tick
        if self.recorder is not None:
            self.recorder.record(
                "fault_fire", point=point, injector_tick=self.tick,
                fires=self.fires[point],
            )

    def rng(self, point: str) -> np.random.Generator:
        """The point's private generator — for fault *payloads* that need
        randomness beyond the fire decision (e.g. which trie node to
        corrupt), keeping the same per-point stream isolation."""
        return self._rngs[point]

    def choose(self, candidates: Sequence, n: int = 1) -> List:
        """Deterministically pick ``n`` distinct victims (order-stable for
        a fixed seed and call history)."""
        cands = list(candidates)
        if not cands or n <= 0:
            return []
        n = min(n, len(cands))
        idx = self._choice_rng.choice(len(cands), size=n, replace=False)
        return [cands[int(i)] for i in np.sort(idx)]

    def stop_all(self):
        """Disable every point (recovery-phase switch for chaos tests)."""
        self.enabled = False
        for p in self._burst_left:
            self._burst_left[p] = 0

    @property
    def total_fires(self) -> int:
        return sum(self.fires.values())

    def as_dict(self) -> dict:
        return {
            "enabled": self.enabled,
            "seed": self.seed,
            "tick": self.tick,
            "total_fires": self.total_fires,
            "last_fire_tick": self.last_fire_tick,
            "points": {
                p: {
                    "opportunities": self.opportunities[p],
                    "fires": self.fires[p],
                    "rate": self.specs[p].rate,
                }
                for p in self.specs
            },
        }


def corrupt_trie_node(cache, rng: np.random.Generator) -> bool:
    """Simulate host-memory corruption of one radix-trie node: flip the
    node's ``block`` tokens out from under its parent's child key. The
    trie keeps *matching* normally (children are keyed by the dict key,
    not the node attribute) but ``cache.check()`` detects the divergence
    — exactly the class of silent drift periodic audits exist to catch.
    Returns False when the trie has no nodes to corrupt."""
    nodes = []

    def walk(node):
        for child in node.children.values():
            nodes.append(child)
            walk(child)

    walk(cache.root)
    if not nodes:
        return False
    victim = nodes[int(rng.integers(len(nodes)))]
    victim.block = tuple(int(t) + 1 for t in victim.block)
    return True
