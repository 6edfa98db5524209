"""Self-healing policy for the serving engine: error taxonomy + guard knobs
(copy of ``repro.serving.guards``; no imports beyond the standard library).

The serving stack distinguishes three failure classes, because they demand
three different reactions:

  * **retryable** — transient resource pressure (pool exhaustion, CoW
    alloc failure, a missed deadline). React with bounded exponential
    backoff and retry; the work is still valid.
  * **poison** — the *request* (or its slot state) is the problem: a
    prompt that can never fit, a slot that stays non-finite at the bottom
    of the degraded-mode chain, a request that missed its deadline too
    many times. Retrying forever would wedge a slot; fail the request and
    move on. :class:`PoisonError` subclasses ``RuntimeError`` so existing
    fail-fast call sites keep their contract.
  * **fatal** — the *engine's* shared state is the problem: a pool/trie
    invariant audit failed. Depending on
    :attr:`GuardConfig.audit_action` the engine raises
    (:class:`FatalInvariantError`), repairs in place, or logs and
    continues.

:class:`GuardConfig` is the engine-side knob block for the NaN/Inf output
guard, the degraded-mode fallback chain, and periodic invariant audits.
The degraded-mode chain steps a quarantined slot down progressively less
aggressive decode paths while healthy slots stay on the fast path:

  level 0   configured fast path (fused cascade / fused lean kernel)
  level 1   vanilla paged lean, fused single-kernel (no cascade grouping)
  level 2   paged lean two-call: K1 + ``segment_merge`` (least in-kernel
            machinery)
  level 3   the plain PyTorch oracle (the ``ref`` backend's step)

(The chain isolates per slot: a degraded slot leaves the cascade grouping
rather than dragging healthy groupmates off the fused kernel.) A slot
that stays non-finite for :attr:`GuardConfig.poison_after` consecutive
ticks at the bottom of the chain is *poisoned*: its KV state is presumed
corrupt, its pages are scrubbed and freed, and the request recomputes
from its prompt (recompute-resume) — which is what actually recovers
from real KV corruption, where no alternate kernel can help.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = [
    "ServingError",
    "RetryableError",
    "PoisonError",
    "FatalError",
    "FatalInvariantError",
    "GuardConfig",
    "DEGRADE_LEVELS",
    "DEGRADE_CAUSES",
    "classify",
]


class ServingError(RuntimeError):
    """Base class of the serving error taxonomy."""


class RetryableError(ServingError):
    """Transient failure — retry with (bounded, backed-off) patience."""


class PoisonError(ServingError):
    """The request/slot is unserviceable — fail it, don't retry forever."""


class FatalError(ServingError):
    """Engine-level shared state is compromised."""


class FatalInvariantError(FatalError):
    """A periodic pool/trie invariant audit failed (audit_action='raise')."""


def classify(exc: BaseException) -> str:
    """Taxonomy bucket of an exception: 'retryable' | 'poison' | 'fatal'
    | 'unknown' (plain errors outside the taxonomy)."""
    if isinstance(exc, RetryableError):
        return "retryable"
    if isinstance(exc, PoisonError):
        return "poison"
    if isinstance(exc, FatalError):
        return "fatal"
    return "unknown"


# human-readable names of the degraded-mode chain, by level
DEGRADE_LEVELS = (
    "fast-path",
    "lean-fused",
    "lean-two-call",
    "ref-oracle",
)
MAX_DEGRADE = len(DEGRADE_LEVELS) - 1

# Why a slot moved down the chain. Every escalation carries one of these
# on its flight-recorder "degrade" event and on the
# ``engine_degrade_cause_total{cause=...}`` counter, so a postmortem
# distinguishes the NaN guard reacting to bad logits from the perf
# watchdog reacting to an occupancy collapse (``DecodeEngine.
# force_degrade``) without inferring it from surrounding events.
DEGRADE_CAUSES = (
    "nan_guard",   # non-finite logits tripped the per-tick NaN guard
    "watchdog",    # a perf-watchdog detector forced the degrade
    "manual",      # operator/test called force_degrade directly
)


@dataclass
class GuardConfig:
    """Engine self-healing knobs (attach via ``DecodeEngine(guards=...)``).

    ``nan_guard`` screens every decode tick's logits for non-finite rows;
    an affected slot emits no token that tick (its context does not
    advance, so the retry re-executes the same step) and escalates one
    level down the degraded-mode chain. ``heal_after`` consecutive finite
    ticks step it back up one level; ``poison_after`` consecutive bad
    ticks at ``max_degrade`` poison the slot (scrub + recompute-resume).

    ``audit_interval > 0`` runs ``pool.check()`` / ``prefix_cache.check()``
    every N ticks; ``audit_action`` picks the reaction to a failed audit:
    'raise' (:class:`FatalInvariantError`), 'repair' (rebuild refcounts /
    reset the trie in place), or 'log' (count and continue).
    """

    nan_guard: bool = True
    heal_after: int = 3
    poison_after: int = 2
    max_degrade: int = MAX_DEGRADE
    audit_interval: int = 0
    audit_action: str = "raise"

    def __post_init__(self):
        if self.heal_after < 1:
            raise ValueError("heal_after must be >= 1")
        if self.poison_after < 1:
            raise ValueError("poison_after must be >= 1")
        if not 0 <= self.max_degrade <= MAX_DEGRADE:
            raise ValueError(f"max_degrade must be in [0, {MAX_DEGRADE}]")
        if self.audit_interval < 0:
            raise ValueError("audit_interval must be >= 0")
        if self.audit_action not in ("raise", "repair", "log"):
            raise ValueError(
                f"audit_action must be 'raise' | 'repair' | 'log', "
                f"got {self.audit_action!r}"
            )
