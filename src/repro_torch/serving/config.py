"""Copy of ``repro.serving.config``. The port's engine reads the same tree
and raises ``NotImplementedError`` for the parts its slice does not run yet.

Typed engine configuration: the one constructor argument of
:class:`repro.serving.engine.DecodeEngine`.

The engine grew ~22 loose keyword knobs across nine PRs; this module
replaces them with a nested frozen-dataclass tree::

    EngineConfig(
        max_batch=8, attn_backend="lean",
        paged=PagedConfig(enabled=True, page_size=16, kv_dtype="int8"),
        cascade=CascadeConfig(enabled=True),
        spec=SpecConfig(enabled=True, k=4),
        obs=ObsConfig(tracer=tracer),
    )

Grouping follows the engine's own subsystem boundaries: paged-KV pool,
cascade (prefix-grouped) decode, speculative draft-verify decode, and
observability sinks. Top-level fields are the knobs every engine has
regardless of mode.

Legacy keyword construction (``DecodeEngine(cfg, params, paged=True, ...)``)
still works through :meth:`EngineConfig.from_legacy` — the engine emits a
single :class:`DeprecationWarning` per such construction and builds the
equivalent nest, so old-style and new-style constructors are state-identical
(pinned by ``tests/test_engine_config.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

__all__ = [
    "PagedConfig",
    "CascadeConfig",
    "SpecConfig",
    "ObsConfig",
    "EngineConfig",
]


@dataclass(frozen=True)
class PagedConfig:
    """Paged-KV pool knobs (``enabled=False`` keeps the dense per-slot
    cache). ``kv_dtype='int8'`` turns on quantized pools — per-(page, head)
    f32 scales with in-kernel dequant."""

    enabled: bool = False
    page_size: Optional[int] = None      # None -> engine tile size
    num_pages: Optional[int] = None      # None -> dense-equivalent capacity
    prefix_cache: bool = False           # radix prompt-prefix sharing
    kv_dtype: Optional[str] = None       # None -> model config's dtype


@dataclass(frozen=True)
class CascadeConfig:
    """Prefix-grouped (cascade) decode knobs — requires
    ``PagedConfig.prefix_cache`` and the lean backend."""

    enabled: bool = False
    fused: bool = True                   # single-kernel merge when VMEM fits
    grouping: str = "lcp"                # 'lcp' | 'identical'
    multi_level: bool = True             # stack one pass per trie level
    stable_ticks: int = 2                # grouping-stability guard


@dataclass(frozen=True)
class SpecConfig:
    """Draft-verify speculative decode: one stream-K sweep scores ``k``
    draft tokens per sequence (k+1 stacked query rows through the chunked
    prefill kernels). Requires a paged engine whose architecture supports
    chunked prefill. ``proposer`` is any
    :class:`repro.serving.speculative.DraftProposer`; ``None`` selects the
    in-tree prompt-lookup :class:`~repro.serving.speculative.NGramProposer`.
    """

    enabled: bool = False
    k: int = 4
    proposer: Any = None


@dataclass(frozen=True)
class ObsConfig:
    """Observability sinks: structured tracer, metrics registry, flight
    recorder (+ postmortem dump dir), perf watchdog (``True`` or a
    ``WatchConfig``)."""

    tracer: Any = None
    metrics: Any = None
    flight: Any = None
    flight_dir: Optional[str] = None
    watchdog: Any = None


# legacy keyword -> where it lives in the nest (top-level names map 1:1)
_TOP_KEYS = frozenset(
    (
        "max_batch",
        "cache_len",
        "attn_backend",
        "num_workers",
        "rng_seed",
        "use_fast_path",
        "fused",
        "interpret",
        "schedule_cache_entries",
        "faults",
        "guards",
    )
)
_PAGED_KEYS = frozenset(("page_size", "num_pages", "prefix_cache", "kv_dtype"))
_CASCADE_KEYS = frozenset(("fused", "grouping", "multi_level", "stable_ticks"))
_OBS_KEYS = frozenset(("tracer", "metrics", "flight", "flight_dir", "watchdog"))


@dataclass(frozen=True)
class EngineConfig:
    """The full engine configuration tree. Construct directly for new code;
    :meth:`from_legacy` maps the deprecated loose-kwarg surface onto it."""

    max_batch: int = 4
    cache_len: int = 256
    attn_backend: str = "ref"
    num_workers: int = 16
    rng_seed: int = 0
    use_fast_path: bool = True
    fused: bool = True
    interpret: Optional[bool] = None     # None -> auto (CPU hosts interpret)
    schedule_cache_entries: int = 128
    paged: PagedConfig = field(default_factory=PagedConfig)
    cascade: CascadeConfig = field(default_factory=CascadeConfig)
    spec: SpecConfig = field(default_factory=SpecConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)
    faults: Any = None                   # FaultInjector
    guards: Any = None                   # GuardConfig

    @classmethod
    def from_legacy(cls, **kw) -> "EngineConfig":
        """Build the nest from ``DecodeEngine``'s legacy keyword surface
        (``paged=True, page_size=..., cascade_fused=..., tracer=...``).
        Unknown keywords raise ``TypeError`` exactly like the old
        signature did."""
        top, paged, cascade, obs = {}, {}, {}, {}
        for name, val in kw.items():
            if name in _TOP_KEYS:
                top[name] = val
            elif name == "paged":
                paged["enabled"] = bool(val)
            elif name in _PAGED_KEYS:
                paged[name] = val
            elif name == "cascade":
                cascade["enabled"] = bool(val)
            elif name.startswith("cascade_") and name[8:] in _CASCADE_KEYS:
                cascade[name[8:]] = val
            elif name in _OBS_KEYS:
                obs[name] = val
            else:
                raise TypeError(
                    f"DecodeEngine got an unexpected keyword {name!r}"
                )
        return cls(
            paged=PagedConfig(**paged),
            cascade=CascadeConfig(**cascade),
            obs=ObsConfig(**obs),
            **top,
        )
