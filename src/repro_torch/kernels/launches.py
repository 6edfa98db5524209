"""The kernels' launch counters taken together: the module-level ints of
:mod:`.lean_decode`, :mod:`.lean_prefill`, :mod:`.flash_decode` and
:mod:`.flash_prefill` whose names end in ``launches``, each bumped by its
wrapper where it launches its kernel.

A captured CUDA graph runs the wrappers' Python once, at capture, when no
kernel launches; every replay launches them all and runs no Python. The
engine therefore takes the counters' change over a capture back out
(:func:`snapshot`, :func:`delta`, :func:`restore`) and adds it on each
replay (:func:`add`), so that the counters go on counting launches on the
device.
"""
from __future__ import annotations

from typing import Dict, Tuple

from . import flash_decode, flash_prefill, lean_decode, lean_prefill

_MODULES = (lean_decode, lean_prefill, flash_decode, flash_prefill)

Counts = Dict[Tuple[object, str], int]


def snapshot() -> Counts:
    """Every launch counter's value, keyed by (module, name)."""
    return {(m, name): value for m in _MODULES for name, value in vars(m).items()
            if name.endswith("launches") and type(value) is int}


def delta(after: Counts, before: Counts) -> Counts:
    """The counters that moved from ``before`` to ``after``, by how much."""
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def restore(counts: Counts) -> None:
    for (m, name), value in counts.items():
        setattr(m, name, value)


def add(counts: Counts) -> None:
    for (m, name), n in counts.items():
        setattr(m, name, getattr(m, name) + n)
