"""Continuous-batching decode engine with LeanAttention scheduling (port of
``repro.serving.engine``: the paged and the dense-cache engine).

The engine owns a fixed pool of sequence slots and provides the mechanisms
a server is built from (:mod:`repro_torch.serving.scheduler` is the policy
on top): blocking admission (whole-prompt prefill, copy-on-admit into KV
pages), a packed chunked-prefill step that streams prompt chunks straight
into the pool (:meth:`DecodeEngine.prefill_chunks_tick`), and one decode
step over all active slots per tick, with slots still prefilling masked out
(``decode_tick(exclude=...)``). Context lengths are ragged -- the regime of
paper §IV-C/Fig. 6.

  * With ``PagedConfig(enabled=True)`` KV lives in a page pool
    ``(num_pages, H_kv, page_size, d)`` per layer, managed by
    :class:`~repro_torch.serving.kvpool.KVPagePool`; admission takes only
    the pages a prompt needs, decode grows sequences page by page, a
    finished request returns its pages at once, and an undersized pool
    preempts (evict + recompute-resume) only when it actually fills.
  * With ``PagedConfig(enabled=False)`` -- the reference's default -- KV
    lives in dense per-slot rows ``(max_batch, H_kv, cache_len, d)`` per
    layer: admission is blocking only (whole-prompt prefill through K7 on
    the card, its row copied into the slot), there is no pool, no chunked
    prefill, no preemption. Decode runs the same kernels over the dense
    rows (lean: K2, or K1 + merge; fixed: K6 + ``merge_n``), and
    ``use_fast_path=False`` runs the reference's legacy per-tick step (the
    schedule built from the host lengths each tick, K1 + merge on
    ``lean``), its fast-versus-legacy baseline.
  * Each tick's stream-K schedule comes from a :class:`ScheduleCache` over
    bucketed lengths (``max_len`` = the padded cache length, as the
    reference), so schedules -- and therefore the kernels' reduction order
    -- match the reference's tick for tick.
  * Backend ``'lean'`` runs attention through the stream-K kernels: K2
    (fused) by default, K1 + merge with ``fused=False``; chunked prefill
    through K4 + merge. Backend ``'fixed'`` is the paper's baseline: decode
    gathers the pages and runs fixed-split FlashDecoding (K6 + ``merge_n``),
    chunked prefill runs paged FA-2 (K8). Backend ``'ref'`` runs the plain
    oracles.
  * With ``PagedConfig(prefix_cache=True)`` a radix cache
    (:class:`~repro_torch.serving.prefix_cache.RadixPrefixCache`) keeps the
    KV pages of finished requests: a later prompt that starts with the same
    tokens shares them (refcounted) and prefills only its tail; a KV write
    into a shared page copies it first (copy-on-write); under pool pressure
    unreferenced cached pages are evicted, least recently used first. With
    ``CascadeConfig(enabled=True)`` (lean only) slots sharing page runs are
    grouped at their longest common prefixes, and once a grouping has held
    for ``stable_ticks`` ticks, decode runs the cascade: shared pages walked
    once per group (K5, or K1 on each pass + merge with ``fused=False``).

With ``PagedConfig(kv_dtype="int8")`` (or a model config whose
``kv_cache_dtype`` is ``"int8"``) the page pools hold int8 with one float32
scale per (page, kv head) -- twice the pages of a bf16 pool in the same
memory. Admission quantizes whole pages and sets their scales; chunk and
decode writes go through the quantizing scatter, whose scales only grow;
copy-on-write copies the int8 content and its scales verbatim. ``lean``
runs the int8 kernels (K2, K1, K4, K5 dequantize each tile with its row's
scale); ``fixed`` dequantizes first -- decode gathers the pages to float32
and runs K6 on them (with the queries widened to float32, as the
reference's K6 widens everything inside), chunks widen the pools to bf16
for K8; ``ref`` gathers through the dequantizing gather. int8 needs the
paged pools: on a dense cache it is a ValueError, as in the reference.

With ``kv_dtype="f8"`` the pools (and dense rows and rings) hold
``float8_e4m3fn``, written through the reference's cast
(:func:`repro_torch.core.attention.to_kv`) as bytes: admission's page and
row writes, copy-on-write and ``_fill_page`` move ``uint8``. Every backend
hands the e4m3 pools to its kernels as they are (``fixed`` gathers e4m3
pages for K6); ``ref`` widens what it reads. ``"f16"`` and ``"f32"`` are
bf16 pools, as in the reference.

With ``SpecConfig(enabled=True, k=...)`` (paged engines that chunk-prefill)
decode is speculative: a proposer
(:mod:`repro_torch.serving.speculative`) drafts up to ``k`` tokens per
slot, and one verify step scores ``[last token, drafts]`` as a prefill
chunk of ``k + 1`` rows (the fused K4 on ``lean``, K8 on ``fixed``); the
longest prefix of drafts the model agrees with is emitted, plus one token
of its own, so the streams equal plain greedy decode. Slots without room
for the block decode one token that tick. Rollback is the reference's:
``ctx_lens`` advances by the tokens emitted, and the page-table tail past
it is dead.

Where the reference jits each step with the KV cache donated, the port
updates the page pools and the dense rows in place (index assignment). On
the card every step the reference jits on the fast path runs as a captured
CUDA graph, keyed as the reference keys its jit: the decode step (backend,
schedule, ``fused``, the fixed split, the cascade schedule), the chunk step
(backend, chunk schedule, pack width, chunk cap), the verify step (backend,
verify schedule, rows) and blocking admission (bucket length), each also on
the pool's layout and dtype. A key's first sighting runs eagerly (its
warm-up: every schedule operand is uploaded then), its second captures the
step and replays it, every later one replays it. A step copies what changes
between calls (tokens, lengths, page tables, a cascade's binding, an
admission's pages or slot) into the graph's one input buffer, replays it
and copies the logits out; the argmax and its copy to the host stay
outside. A graph lives as long as its schedule stays in the
:class:`ScheduleCache`. ``capture_decode = False`` runs every step eagerly
on the card (the captured steps' oracle); CPU engines run them eagerly
always. A capture or replay that fails raises. The legacy step
(``use_fast_path=False``) runs eagerly, as the reference does not jit it.
Blocking prefill runs at the reference's bucket length
(:func:`bucket_length`, ``stats.prefill_compiles`` counts the buckets):
the pad tokens' K/V land in the tail of the last page (on an int8 pool
they count in its scale) or of the dense row, masked by every read; each
layer's K/V go into the pages or the row as soon as the layer has run.
An architecture with recurrent layers (``rglru``, ``mlstm``, ``slstm``)
is prefilled at the exact prompt length, as the reference's is, and each
recurrent layer's state goes into the slot's row; its decode step
advances every slot's state, as the reference's does.
Observability (:mod:`repro_torch.obs`, ``EngineConfig.obs``) is wired as
the reference wires it. A :class:`~repro_torch.obs.metrics.MetricsRegistry`
(always on) holds every :class:`EngineStats` counter as ``engine_<name>``
-- the captured steps' ``engine_<kind>_captures`` / ``_replays`` among
them -- and the TTFT, TPOT and queue-wait histograms the scheduler
observes; the KV pool, the radix cache and the schedule cache publish
gauges into it. A :class:`~repro_torch.obs.flight.FlightRecorder` (always
on) records each tick and preemption. A tracer (``NULL_TRACER`` by
default) records the spans ``tick``, ``schedule_build``, ``decode_kernel``
(with the execution path and the roofline cost of its schedule,
:func:`~repro_torch.roofline.analysis.schedule_decode_cost` on the H100's
peaks), ``prefill_chunk``, ``admit``, ``cow``, ``cascade_group`` and
``spec_verify``, and the scheduler's request events; a perf watchdog
(``ObsConfig.watchdog``) runs after each tick. Spans wrap a step and the
host code around it, never a captured step's body (which runs only at its
warm-up and capture); a live ``decode_kernel``, ``prefill_chunk`` or
``spec_verify`` span synchronises the stream after the step and charges
the wait to its ``sync_ms``, as the reference blocks on its jitted step.
Tracing changes no step key.

Self-healing and fault injection (:mod:`repro_torch.serving.guards`,
:mod:`repro_torch.serving.faults`; ``EngineConfig.guards`` / ``faults``,
paged engines only) are the reference's. With a :class:`GuardConfig`
every decode pass's logits are screened (the argmax and a per-row
``all(isfinite)``, one device-to-host copy); a slot with a non-finite row
emits nothing that tick and steps down the degraded-mode chain, one pass
per level with every other slot masked as ``exclude`` masks them: level 0
is the configured path (the cascade included), level 1 the paged lean
step with K2 and no cascade, level 2 the same with K1 + ``segment_merge``,
level 3 the ``ref`` step (a non-lean backend goes from 0 straight to 3).
Each level's step is keyed by its backend and ``fused`` as any other
step, and captured alike. ``heal_after`` finite ticks climb one level
back; ``poison_after`` non-finite ticks at ``max_degrade`` poison the slot:
its private pages are zero-filled in place, its shared pages withdrawn
from the radix cache, and it is preempted to recompute. Periodic audits
(``audit_interval``) check the pool (with the int8 scales) and the radix
cache and raise, repair or log. A :class:`FaultInjector` is consulted at
the reference's points: ``page_alloc`` and ``cow_clone`` where pages are
taken, ``nan_output``, ``nan_kv``, ``trie_corrupt``, ``tick_latency`` and
``preempt_storm`` once a tick, and a failed radix insert counts
``donation_aborts``.

Architectures. Every configuration whose layers are all attention kinds is
served (:mod:`repro_torch.models.transformer`): MoE FFNs run in every step
as any FFN does; on a paged engine only the ``attn`` layers are paged, and
``win`` (sliding-window) layers keep dense per-slot rings, written at
admission beside the page scatter, as the reference's
``_write_slot_paged`` does. A sliding-window layer's decode attention reads
its ring through the plain PyTorch oracle on every backend and device: the
reference's engine passes no ``win_attn_fn`` and runs ``mha_decode_ref``
there (``repro/models/transformer.py:853``), so the plain ring read is the
counterpart of what the reference runs, not a fallback from a kernel.
Architectures with windowed layers or sinusoidal positions do not
chunk-prefill (:func:`~repro_torch.models.transformer.supports_chunked_prefill`):
they admit by blocking whole-prompt prefill and refuse speculative decode,
as the reference does. Sinusoidal positions go in at ``max(ctx_lens)`` for
every slot of a decode step, as the reference's fast step embeds them
(a known problem of the reference, kept: the port matches its oracle).
Admission of an ``xattn`` architecture raises ``NotImplementedError``: the
reference's engine passes no image embeddings and cannot place the cross
K/V it computes from the prompt (ROADMAP queue 3). Recurrent layer kinds
keep per-slot float32 states and admit at the exact prompt length; f8
pools hold e4m3 K/V that the kernels widen in registers, and f16/f32
pools are bf16, as the reference stores them.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import math
import time
import warnings
import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.attention import (
    F8,
    kv_bytes,
    paged_gather_kv,
    paged_gather_kv_dequant,
    quantize_kv_blocks,
    to_kv,
)
from repro_torch.core.leantile import (
    CascadeBinding,
    CascadeSchedule,
    LeanSchedule,
    ScheduleCache,
    bucket_length,
    cascade_fused_descriptors,
    default_tile_size,
    fixed_split_factor,
    make_chunk_schedule,
    make_schedule,
    make_spec_schedule,
)
from repro_torch.core.merge import MergeGrid, merge_grid_arrays
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import launches
from repro_torch.kernels.flash_prefill import flash_prefill_paged
from repro_torch.kernels.lean_decode import CascadeFusedDesc, cascade_fused_desc_arrays
from repro_torch.kernels.ops import (
    cascade_merge_ids,
    cascade_routing,
    cascade_tables,
    flash_decode,
    flash_decode_from_lens,
    lean_decode,
    lean_decode_cascade_from_schedule,
    lean_decode_from_schedule,
    lean_decode_paged_from_schedule,
    lean_prefill_chunks,
    paged_route,
)
from repro_torch.models.layers import dequant_pool
from repro_torch.models.transformer import (
    ATTN_KINDS,
    RECURRENT_KINDS,
    ModelConfig,
    check_supported,
    decode_step,
    init_cache,
    init_paged_cache,
    layer_kinds,
    prefill,
    prefill_chunks,
    supports_chunked_prefill,
    verify_step,
)
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.roofline.analysis import schedule_decode_cost
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.faults import corrupt_trie_node
from repro_torch.serving.guards import (  # noqa: F401  (PoisonError: re-exported)
    DEGRADE_CAUSES,
    DEGRADE_LEVELS,
    FatalInvariantError,
    PoisonError,
)
from repro_torch.serving.kvpool import KVLayout, KVPagePool
from repro_torch.serving.prefix_cache import RadixPrefixCache, lcp_group_passes
from repro_torch.serving.speculative import NGramProposer


@dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (L,) int32
    max_new_tokens: int
    generated: List[int] = field(default_factory=list)
    # generated tokens already folded into ``prompt`` by recompute-resume
    # preemption -- keeps a second preemption from folding them twice
    folded: int = 0

    @property
    def done(self):
        return len(self.generated) >= self.max_new_tokens


# Counter-valued EngineStats fields, published to the metrics registry as
# ``engine_<name>`` counters (the reference's names)
_STAT_COUNTERS = (
    "ticks",
    "tokens_generated",
    "prefills",
    "chunk_prefills",
    "prefill_tokens",
    "preemptions",
    "prefill_compiles",
    "prefix_matched_tokens",
    "prefix_attach_count",
    "cow_copies",
    "cascade_ticks",
    "cascade_grouped_slots",
    "cascade_grouped_passes",
    "cascade_fused_ticks",
    "cascade_retraces",
    "cascade_stability_skips",
    "cascade_levels_max",
    "nan_ticks",
    "degrade_escalations",
    "degrade_heals",
    "poisoned_slots",
    "donation_aborts",
    "audits_run",
    "audit_failures",
    "audit_repairs",
    "spec_ticks",
    "spec_draft_tokens",
    "spec_accepted_tokens",
)


# the steps run through _run_step: the fast-path decode step (the cascade's
# too), the chunk step, the speculative verify step, blocking admission
STEP_KINDS = ("decode", "chunk", "verify", "admit")
# captured admissions held at once by an engine that admits at the exact
# prompt length (one key per distinct length, which no bucket bounds): the
# least recently used goes back to its warm-up
EXACT_ADMIT_GRAPHS = 4


class EngineStats:
    """Engine telemetry, backed by a :class:`~repro_torch.obs.metrics.
    MetricsRegistry`: counters read and assign as plain ints but live in
    the registry as ``engine_<name>`` counters, and ``ttft``, ``tpot`` and
    ``queue_wait`` are its histograms ``engine_ttft_seconds``,
    ``engine_tpot_seconds`` and ``engine_queue_wait_seconds`` (seconds,
    observed by the scheduler). ``<kind>_captures`` counts the steps of a
    kind (``decode``, ``chunk``, ``verify``, ``admit``) captured as CUDA
    graphs -- the port's counterpart of the reference's retraces of its
    jitted steps -- and ``<kind>_replays`` the steps that replayed one.
    Beside them: the per-tick schedule and token logs, the last pool and
    cache snapshots, the last cascade tick's grouping."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        names = _STAT_COUNTERS + tuple(f"{kind}_{what}" for kind in STEP_KINDS
                                       for what in ("captures", "replays"))
        self._counters = {name: self.registry.counter(f"engine_{name}") for name in names}
        self.schedules: List[dict] = []
        self.schedule_cache: dict = {}
        self.kv_pool: dict = {}
        self.prefix_cache: dict = {}
        self.cascade_last: dict = {}
        self.degraded: dict = {}          # the guards' degraded-slots gauge snapshot
        self.faults: dict = {}            # the injector's as_dict()
        self.tick_decode_tokens: List[int] = []
        self.tick_prefill_tokens: List[int] = []
        self.ttft = self.registry.histogram("engine_ttft_seconds", help="time to first token")
        self.tpot = self.registry.histogram("engine_tpot_seconds", help="inter-token latency")
        self.queue_wait = self.registry.histogram("engine_queue_wait_seconds",
                                                  help="submit-to-admit wait")

    # counters masquerade as plain int attributes: __getattr__ only fires
    # for names not in __dict__, i.e. exactly the routed counter fields
    def __getattr__(self, name):
        counters = self.__dict__.get("_counters")
        if counters is not None and name in counters:
            return counters[name].value
        raise AttributeError(name)

    def __setattr__(self, name, value):
        counters = self.__dict__.get("_counters")
        if counters is not None and name in counters:
            counters[name].value = int(value)
        else:
            object.__setattr__(self, name, value)

    @property
    def step_captures(self) -> int:
        """CUDA graph captures of every step kind."""
        return sum(self._counters[f"{kind}_captures"].value for kind in STEP_KINDS)

    def latency_dict(self) -> dict:
        return {
            "ttft": self.ttft.as_dict(),
            "tpot": self.tpot.as_dict(),
            "queue_wait": self.queue_wait.as_dict(),
        }


class _Step(NamedTuple):
    """One step, split as a captured graph needs it: ``host`` holds the
    int32 inputs that change between calls, ``body`` computes the logits
    from them on the device (a dict of the same names) and updates the
    cache in place, ``key`` is what a graph of the step is keyed on (its
    second entry names the kind, or the backend of a decode step), ``sched``
    the schedule it runs (kept alive by the graph, None for none), ``kind``
    one of :data:`STEP_KINDS`."""

    key: tuple
    host: Dict[str, np.ndarray]
    body: Callable[[Dict[str, torch.Tensor]], torch.Tensor]
    sched: object
    kind: str = "decode"


_ALIGN = 16     # int32 elements: each packed input starts 64-byte aligned


def _pack(host: Dict[str, np.ndarray]) -> Tuple[np.ndarray, tuple]:
    """The step's host inputs in one int32 array, and their layout
    ``((name, offset, shape), ...)``: one copy moves them all."""
    layout, off = [], 0
    for name, a in host.items():
        layout.append((name, off, tuple(a.shape)))
        off += -(-a.size // _ALIGN) * _ALIGN
    flat = np.zeros(max(off, 1), dtype=np.int32)
    for (_, o, _), a in zip(layout, host.values()):
        flat[o:o + a.size] = a.reshape(-1)
    return flat, tuple(layout)


def _unpack(flat: torch.Tensor, layout: tuple) -> Dict[str, torch.Tensor]:
    return {name: flat[o:o + math.prod(shape)].view(shape) for name, o, shape in layout}


@dataclass
class _StepGraph:
    """A captured step: its graph, its input buffer on the device with a
    pinned host buffer to fill it from, its output, the launch counts one
    replay adds, and what it captured (schedule, cache tensors,
    parameters), which it keeps alive."""

    graph: "torch.cuda.CUDAGraph"
    kind: str
    inputs: torch.Tensor
    staging: torch.Tensor
    copied: "torch.cuda.Event"
    logits: torch.Tensor
    launches: dict
    sched: object
    params: object
    cache: list
    cache_ptrs: tuple


def _bump(stats: EngineStats, name: str) -> None:
    setattr(stats, name, getattr(stats, name) + 1)


def _weak_hook(method: Callable) -> Callable:
    """``method`` called through a weak reference to its object, doing
    nothing once the object is gone: a hook that does not keep the object
    alive (the schedule cache, which the metrics registry reads, must not
    keep its engine's pools and graphs)."""
    ref = weakref.WeakMethod(method)

    def hook(*args):
        bound = ref()
        if bound is not None:
            bound(*args)

    return hook


def _screen_logits(logits: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """Guarded sampling (reference ``_screen_logits``, and the verdict of
    its ``_spec_verify_step``): the greedy tokens of ``logits (B, ..., V)``
    and, per slot, whether all its logits are finite, moved to the host in
    one copy."""
    tok = logits.argmax(dim=-1)
    fin = torch.isfinite(logits).flatten(1).all(dim=1)
    both = torch.cat((tok.flatten(), fin.long())).cpu().numpy()
    return both[:tok.numel()].reshape(tuple(tok.shape)), both[tok.numel():].astype(bool)


def _cache_ptrs(cache) -> tuple:
    return tuple(t.data_ptr() for lc in cache for t in lc.values())




XATTN_ADMISSION = (
    "admission of an 'xattn' architecture: the reference's engine passes no image "
    "embeddings, so its prefill computes the cross-attention K/V over the prompt and "
    "its slot write cannot place them (repro/serving/engine.py:302-340; ROADMAP queue 3)"
)


class DecodeEngine:
    """The continuous-batching engine, paged or dense
    (``config.paged.enabled``).

    ``config`` is the reference's :class:`EngineConfig`; ``device`` is
    where the pools live and the model runs (``params`` must be there
    already). It defaults to CUDA and raises when CUDA is missing.
    """

    SCHEDULE_LOG_CAP = 512

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        config: Optional[EngineConfig] = None,
        *,
        device: DeviceLike = "cuda",
    ):
        config = config if config is not None else EngineConfig()
        self.device = resolve_device(device)
        if config.attn_backend not in ("lean", "fixed", "ref"):
            raise ValueError(f"unknown attn_backend {config.attn_backend!r}")
        if config.interpret is not None:
            raise ValueError(
                "interpret is a Pallas setting; the port runs kernels on CUDA "
                "tensors and their plain versions on CPU tensors"
            )
        self.paged = config.paged.enabled
        # kv_dtype overrides the model config's KV storage dtype for this
        # engine; 'int8' turns on the quantized page pools
        kv_dtype = config.paged.kv_dtype
        if kv_dtype is not None and kv_dtype != cfg.kv_cache_dtype:
            cfg = dataclasses.replace(cfg, kv_cache_dtype=kv_dtype)
        self.quant = self.paged and cfg.kv_cache_dtype == "int8"
        if cfg.kv_cache_dtype == "int8" and not self.paged:
            raise ValueError(
                "kv_dtype='int8' quantizes the paged pools and requires paged=True "
                "(dense caches stay bf16)"
            )
        self.use_fast_path = config.use_fast_path
        if self.paged and not self.use_fast_path:
            raise ValueError("paged KV requires the fast path (use_fast_path=True)")
        if config.paged.prefix_cache and not self.paged:
            raise ValueError("prefix_cache=True requires paged=True")
        if config.cascade.enabled:
            if not config.paged.prefix_cache:
                raise ValueError("cascade=True requires prefix_cache=True")
            if config.attn_backend != "lean":
                raise ValueError("cascade decode is a lean-kernel path (attn_backend='lean')")
        if config.cascade.grouping not in ("lcp", "identical"):
            raise ValueError("cascade_grouping must be 'lcp' or 'identical'")
        check_supported(cfg)
        self.cfg = cfg
        self.params = params
        self.max_batch = config.max_batch
        self.layer_kinds = layer_kinds(cfg)

        # observability: the tracer (NULL_TRACER, the disabled one, costs a
        # hook one attribute check), the metrics registry the stats live in,
        # and the always-on flight recorder
        obs = config.obs
        self.tracer = obs.tracer if obs.tracer is not None else NULL_TRACER
        self.metrics = obs.metrics if obs.metrics is not None else MetricsRegistry()
        self.stats = EngineStats(registry=self.metrics)
        self.flight = (obs.flight if obs.flight is not None
                       else FlightRecorder(dump_dir=obs.flight_dir))
        if obs.flight is not None and obs.flight_dir is not None:
            self.flight.dump_dir = obs.flight_dir
        self._sched_costs: dict = {}    # schedule -> roofline cost meta
        self._tick_dumped = False       # one injected-fault dump per tick
        self._fires_dumped = 0          # injector fires already dumped

        # fault injection and the self-healing guards, both off by default:
        # then every hook below is one ``is None`` test
        self.faults = config.faults
        if self.faults is not None and self.faults.recorder is None:
            # every fire logs a fault_fire event, so a dump names its point
            self.faults.recorder = self.flight
        if config.guards is not None and not self.paged:
            raise ValueError(
                "guards (self-healing) require paged=True: quarantining a slot masks "
                "it via null page-table rows, and poison recovery is recompute-resume "
                "preemption -- both are paged mechanisms"
            )
        self.guard_cfg = config.guards
        # each slot's place on the degraded-mode chain (guards.DEGRADE_LEVELS)
        # and its runs of consecutive bad and good ticks
        self._slot_degrade = [0] * config.max_batch
        self._slot_bad = [0] * config.max_batch
        self._slot_good = [0] * config.max_batch
        self.degraded_gauge = self.metrics.gauge(
            "engine_degraded_slots", help="live slots off the fast path")
        self._degrade_cause = self.metrics.counter(
            "engine_degrade_cause_total",
            help="degrade escalations by cause (see guards.DEGRADE_CAUSES)",
            labelnames=("cause",))
        self._audit_clock = 0

        self.cache_len = config.cache_len
        self.attn_backend = config.attn_backend
        self.num_workers = config.num_workers
        self.fused = config.fused

        # lean tiles map 1:1 onto KV pages
        page_size = config.paged.page_size
        if self.paged and page_size is not None:
            self.tile = int(page_size)
        else:
            self.tile = min(default_tile_size(cfg.head_dim), max(8, self.cache_len))
        self.pages_per_slot = -(-self.cache_len // self.tile)
        if self.paged:
            num_pages = config.paged.num_pages
            if num_pages is None:       # dense-equivalent capacity + null page
                num_pages = 1 + self.max_batch * self.pages_per_slot
            layout = KVLayout(
                kv_dtype=cfg.kv_cache_dtype, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim, page_size=self.tile,
                n_attn_layers=self.layer_kinds.count("attn"),
                scale_granularity=cfg.kv_scale_granularity,
            )
            self.pool = KVPagePool(num_pages, self.tile, layout=layout)
            self.pool.register_metrics(self.metrics)
            self.page_tbl = np.zeros((self.max_batch, self.pages_per_slot), dtype=np.int32)
            self.cache = init_paged_cache(cfg, num_pages, self.tile, device=self.device,
                                          batch=self.max_batch, cache_len=self.cache_len)
        else:
            self.pool = None
            self.page_tbl = None
            self.cache = init_cache(cfg, self.max_batch, self.cache_len, device=self.device)

        # prefix sharing: the radix cache over the pool, and per slot which
        # logical tiles are shared (immutable: copy-on-write before any KV
        # write lands in one) and how many leading full shared pages form
        # its cascade prefix
        self.prefix_cache = RadixPrefixCache(self.pool) if config.paged.prefix_cache else None
        if self.prefix_cache is not None:
            self.prefix_cache.register_metrics(self.metrics)
        self._slot_shared_tiles: List[set] = [set() for _ in range(self.max_batch)]
        self._slot_prefix_full: List[int] = [0] * self.max_batch
        # cascade decode: fused K5, trie-path grouping ('lcp' groups at
        # longest common prefixes, stacking one pass per trie level with
        # multi_level; 'identical' groups only equal page runs), and the
        # stability guard -- the cascade engages once a grouping has held
        # for stable_ticks consecutive ticks
        casc = config.cascade
        self.cascade = casc.enabled
        self.cascade_fused = casc.fused
        self.cascade_grouping = casc.grouping
        self.cascade_multi_level = casc.multi_level
        self.cascade_stable_ticks = max(1, int(casc.stable_ticks))
        self._casc_key = None           # last tick's grouping structure
        self._casc_stable = 0           # consecutive ticks it has held
        self._casc_signatures: set = set()   # schedule geometries seen
        self._casc_host = None          # (key, host operands) of the last grouping

        self.ctx_lens = np.zeros(self.max_batch, dtype=np.int64)
        self.slot_req: List[Optional[Request]] = [None] * self.max_batch
        self.queue: List[Request] = []
        self.next_tokens = np.zeros((self.max_batch, 1), dtype=np.int32)
        self.sched_cache = ScheduleCache(max_entries=config.schedule_cache_entries)
        # the registry's callbacks hold what they read, never the engine: a
        # caller keeping ``stats`` (or the registry) must not keep the
        # engine's pools and graphs alive
        sched_cache, stats = self.sched_cache, self.stats
        self.metrics.gauge_fn("schedule_cache_hit_rate", lambda: sched_cache.stats.hit_rate,
                              help="stream-K schedule cache hit rate")
        # the captured steps (decode, chunk, verify, admission): key ->
        # (schedule, graph, or None while the key has only had its eager
        # warm-up), dropped with their schedule (exact-length admissions: the
        # least recently used beyond EXACT_ADMIT_GRAPHS); capture_decode =
        # False runs every step eagerly
        self.capture_decode = self.device.type == "cuda"
        self._graphs: Dict[tuple, Tuple[object, Optional[_StepGraph]]] = {}
        self._prefill_shapes: set = set()   # distinct admission bucket lengths
        # bucketed admission needs every layer to be an attention kind:
        # recurrent layers would scan the pad tokens into their state, so
        # those architectures are admitted at the exact prompt length
        self.bucket_prefill = all(kind in ATTN_KINDS for kind in self.layer_kinds)
        self._exact_admits: Dict[tuple, None] = {}   # captured exact-length admissions, LRU first
        self._graph_pool = None
        self._capture_stream = None
        self.sched_cache.on_evict = _weak_hook(self._drop_graphs)
        self.last_step_key: Optional[tuple] = None
        self.last_logits: Optional[torch.Tensor] = None   # last decode pass (B, V)
        self.last_prefill_logits: Optional[torch.Tensor] = None   # last chunk step (N, V)
        self.last_verify_logits: Optional[torch.Tensor] = None    # last verify step (B, k+1, V)
        # a scheduler registers here to take preempted requests into its own
        # queue; without one they go back to the engine's queue
        self.preempt_sink: Optional[Callable[[Request], None]] = None

        # speculative (draft-verify) decode: the verify step is a chunk step
        # whose chunk is [last token, k drafts], so it needs the chunked
        # prefill machinery (a paged pool, an all-'attn' architecture)
        spec = config.spec
        self.spec_k = int(spec.k) if spec.enabled else 0
        self.proposer = spec.proposer
        if spec.enabled:
            if spec.k < 1:
                raise ValueError(f"SpecConfig.k must be >= 1, got {spec.k}")
            if not self.supports_chunked_prefill():
                raise ValueError(
                    "speculative decode runs the multi-row verify step through the "
                    "chunked-prefill kernels: it requires paged=True and an all-'attn' "
                    "architecture (see supports_chunked_prefill)"
                )
            if self.proposer is None:
                self.proposer = NGramProposer()
            self.metrics.gauge_fn(
                "engine_spec_accept_rate",
                lambda: stats.spec_accepted_tokens / max(1, stats.spec_draft_tokens),
                help="accepted / proposed draft tokens (cumulative)")

        # the perf watchdog (repro_torch.obs.watch): ``watchdog`` True gives
        # the default WatchConfig; a PerfWatchdog built on the engine (for
        # SLO classes or a calibration) attaches itself here instead
        self.watchdog = None
        if obs.watchdog is not None and obs.watchdog is not False:
            from repro_torch.obs.watch import PerfWatchdog, WatchConfig

            PerfWatchdog(self, WatchConfig() if obs.watchdog is True else obs.watchdog)

    # ------------------------------------------------------------- schedule
    def _tick_schedule(self, ctx_np) -> LeanSchedule:
        """The (cached) stream-K schedule for this tick: every slot attends
        over its context plus the token being written, clamped to the cache
        capacity. Built over all slots (idle ones contribute one masked
        tile)."""
        s_pad = self.cache_len + ((-self.cache_len) % self.tile)
        lens = np.minimum(ctx_np + 1, self.cache_len)
        with self.tracer.span("schedule_build") as sp:
            sched = self.sched_cache.get(
                lens.tolist(), self.cfg.n_kv_heads, self.tile, self.num_workers,
                max_len=s_pad,
            )
            if sp:
                sp.annotate(**sched.work_summary())
        return sched

    # ------------------------------------------------------------- public
    def submit(self, req: Request):
        self.queue.append(req)

    def free_slots(self) -> List[int]:
        return [s for s in range(self.max_batch) if self.slot_req[s] is None]

    def _check_fits_pool(self, req: Request):
        """Fail fast on a request that can never be served: a prompt beyond
        one slot's page capacity, or a minimum working set (prompt pages +
        the first decode write) larger than the whole pool."""
        plen = len(req.prompt)
        if plen > self.pages_per_slot * self.tile:
            raise PoisonError(
                f"request uid={req.uid}: {plen}-token prompt exceeds the "
                f"per-slot KV capacity ({self.pages_per_slot} pages x "
                f"{self.tile} tokens) — raise cache_len or truncate"
            )
        min_pages = min(self.pages_per_slot, plen // self.tile + 1)
        if min_pages > self.pool.usable_pages:
            raise PoisonError(
                f"request uid={req.uid} needs {min_pages} KV pages "
                f"({plen}-token prompt @ page_size {self.tile}) but the pool "
                f"holds only {self.pool.usable_pages} usable pages — raise "
                "num_pages or shorten the prompt"
            )

    def _run_prompt_prefill(self, prompt: np.ndarray, slot: int,
                            pages: Optional[List[int]]) -> torch.Tensor:
        """Whole-prompt prefill into ``slot``'s dense row or its ``pages``,
        through :meth:`_run_step` (captured on the card): the prompt padded
        with token 0 to the reference's bucket (:func:`bucket_length`, as
        ``repro/serving/engine.py:1057-1072``), its true length read on the
        device. Returns the last prompt position's logits ``(1, V)``."""
        return self._run_step(self._admit_step(prompt, slot, pages))

    def _admit_step(self, prompt: np.ndarray, slot: int, pages: Optional[List[int]]) -> _Step:
        """Blocking admission as one step: prefill at the bucket length,
        each layer's K/V written as soon as the layer has run -- an ``attn``
        layer's into the slot's pages (:meth:`_write_pages`, the reference's
        ``_write_slot_paged``) on a paged engine, every other into the
        slot's dense row (:meth:`_write_row`, its ``_write_slot``; a ``win``
        layer's ring of the prompt's last real positions; a recurrent
        layer's state). Inputs: the padded tokens, the true length, the
        pages (as many as the bucket covers, the tail 0) and the slot. Keyed
        on the layout and the bucket length. An architecture with recurrent
        layers is prefilled at the exact prompt length instead, with no true
        length (pad tokens would enter its state): the reference's
        ``bucket_prefill`` rule (``repro/serving/engine.py:895-904``,
        ``:1057-1072``), one key and one ``prefill_compiles`` per distinct
        length."""
        if "xattn" in self.layer_kinds:
            raise NotImplementedError(f"not ported yet: {XATTN_ADMISSION}")
        plen = len(prompt)
        bucketed = self.bucket_prefill
        L = bucket_length(plen, self.tile, max_len=self.cache_len) if bucketed else plen
        self._prefill_shapes.add(L)
        self.stats.prefill_compiles = len(self._prefill_shapes)
        toks = np.zeros((1, L), dtype=np.int32)
        toks[0, :plen] = np.asarray(prompt)
        host = {"tokens": toks}
        if bucketed:
            host["true_len"] = np.asarray([plen], dtype=np.int32)
        if self.paged:
            tbl = np.zeros(-(-L // self.tile), dtype=np.int32)
            tbl[:len(pages)] = pages
            host["pages"] = tbl
        if not self.paged or any(kind != "attn" for kind in self.layer_kinds):
            host["slot"] = np.asarray([slot], dtype=np.int32)

        def body(b):
            pages_b = b["pages"].long() if self.paged else None
            slot_b = b["slot"].long() if "slot" in b else None

            def write(layer, entry):
                if pages_b is not None and self.layer_kinds[layer] == "attn":
                    self._write_pages(pages_b, layer, entry["k"], entry["v"])
                else:
                    self._write_row(slot_b, layer, entry)

            logits, _, _ = prefill(self.params, self.cfg, b["tokens"], cache_len=self.cache_len,
                                   true_len=b.get("true_len"), write_kv=write)
            return logits

        return _Step((self._layout_key(), "admit", L), host, body, None, kind="admit")

    def _write_row(self, slot: torch.Tensor, layer: int, entry: Dict[str, torch.Tensor]):
        """Dense admission of one layer into row ``slot`` (a one-element
        device tensor), in place -- the reference's ``_write_slot``
        (``repro/serving/engine.py:246-260``): each K/V entry ``(1, H, n,
        hd)`` (an ``attn`` layer's K/V of the prompt, a ``win`` layer's
        ring) padded with zeros to the row's length; a recurrent layer's
        states (``h (1, W)``, ``conv (1, 3, W)``, ``C (1, H, hd, hd)``, ...)
        whole."""
        lc = self.cache[layer]
        recurrent = self.layer_kinds[layer] in RECURRENT_KINDS
        for name, src in entry.items():
            row = src if recurrent else torch.nn.functional.pad(
                src, (0, 0, 0, lc[name].shape[2] - src.shape[2]))
            # an f8 row: the reference's cast, its bytes copied (torch has
            # no float8 index_copy_)
            kv_bytes(lc[name]).index_copy_(0, slot, kv_bytes(to_kv(row, lc[name].dtype)))

    def _write_pages(self, pages: torch.Tensor, layer: int, k: torch.Tensor, v: torch.Tensor):
        """Copy-on-admit of one layer: its K/V ``(1, H, L, hd)`` scattered
        into ``pages`` in place, whole pages (tail padded), so stale data in
        recycled pages is overwritten. Entries 0 of ``pages`` (the bucket's
        pages past the prompt's) write nothing: each rewrites the null
        page's own content. int8 pools quantize each page and *set* its
        scale to the fresh content's ``amax / 127`` (reference
        ``_pages_admit_write_quant``): no old content survives, so nothing
        is requantized."""
        n = pages.shape[0]
        need = n * self.tile
        live = pages > 0
        per_head = self.cfg.kv_scale_granularity == "page_head"
        lc = self.cache[layer]
        for name, src in (("k", k), ("v", v)):
            src = src[0]                                   # (H, L, hd)
            H, L, hd = src.shape
            if need > L:
                src = torch.nn.functional.pad(src, (0, 0, 0, need - L))
            chunks = src[:, :need].reshape(H, n, self.tile, hd).movedim(1, 0)
            pool = lc[name]
            if self.quant:
                q, sc = quantize_kv_blocks(chunks, per_head=per_head)
                scales = lc[f"{name}_scale"]
                pool[pages] = torch.where(live[:, None, None, None], q, pool[pages])
                scales[pages] = torch.where(live[:, None], sc, scales[pages])
            else:   # (an f8 pool's bytes)
                b = kv_bytes(pool)
                b[pages] = torch.where(live[:, None, None, None],
                                       kv_bytes(to_kv(chunks, pool.dtype)), b[pages])

    def admit_blocking(self, req: Request, slot: int) -> bool:
        """Whole-prompt prefill into ``slot``, its cache row or pages
        written, first token sampled. Returns False (engine unchanged) when
        the paged pool cannot hold the prompt right now. Does not touch the
        engine queue. Traced as the ``admit`` span."""
        with self.tracer.span("admit", uid=req.uid, prompt_tokens=len(req.prompt)):
            return self._admit_blocking_inner(req, slot)

    def _admit_blocking_inner(self, req: Request, slot: int) -> bool:
        plen = len(req.prompt)
        pages = None
        if self.paged:
            self._check_fits_pool(req)
            n = max(1, -(-plen // self.tile))
            pages = self._pool_alloc(slot, n)
            if pages is None:
                return False            # pool exhausted; retry next tick
            self.page_tbl[slot, :n] = pages
        self.slot_req[slot] = req
        logits = self._run_prompt_prefill(req.prompt, slot, pages)
        self.ctx_lens[slot] = plen
        nxt = int(logits[0].argmax())
        req.generated.append(nxt)
        self.next_tokens[slot, 0] = nxt
        self.stats.prefills += 1
        return True

    def _admit(self):
        for slot in range(self.max_batch):
            if self.slot_req[slot] is None and self.queue:
                if not self.admit_blocking(self.queue[0], slot):
                    break               # pool exhausted; retry next tick
                self.queue.pop(0)

    # ------------------------------------------------------- chunked prefill
    def supports_chunked_prefill(self) -> bool:
        """Chunked prefill streams prompt pieces straight into the paged
        pool: it needs a paged engine, and the architecture's whole prompt
        state must live in pooled global-attention KV
        (:func:`supports_chunked_prefill`)."""
        return self.paged and supports_chunked_prefill(self.cfg)

    def claim_slot(self, req: Request) -> Optional[int]:
        """Reserve a free slot for ``req`` without prefilling anything: the
        entry to the PREFILLING state. The slot starts at context 0 with an
        all-null table row; pages come per chunk (:meth:`ensure_chunk_pages`).
        Raises :class:`PoisonError` for a request that can never fit."""
        if self.paged:
            self._check_fits_pool(req)
        for slot in self.free_slots():
            self.slot_req[slot] = req
            self.ctx_lens[slot] = 0
            if self.paged:
                self.page_tbl[slot, :] = 0
            self._slot_shared_tiles[slot] = set()
            self._slot_prefix_full[slot] = 0
            return slot
        return None

    def _pool_alloc(self, seq, n: int):
        """Pool allocation with radix-cache backpressure: on exhaustion,
        evict least recently used unreferenced cache leaves and retry once.
        Cached pages are elastic capacity; live requests always win.

        Fault point ``page_alloc``: an injected failure looks exactly like
        exhaustion (None), so every caller runs its real retry, preempt or
        backoff path."""
        if self.faults is not None and self.faults.fire("page_alloc"):
            return None
        got = self.pool.alloc(seq, n)
        if got is None and self.prefix_cache is not None:
            need = n - self.pool.num_free
            if self.prefix_cache.evict(need) > 0 or self.pool.num_free >= n:
                got = self.pool.alloc(seq, n)
        return got

    # ------------------------------------------------------- prefix sharing
    def attach_prefix(self, slot: int, prompt) -> int:
        """Map the longest cached prefix of ``prompt`` into ``slot``'s page
        table (refcount-shared, nothing recomputed) and return the number of
        prompt tokens it covers; the caller starts chunked prefill there.
        The match is capped at ``len(prompt) - 1`` so that at least one
        token runs through the model (the first token's logits are
        computed, not recalled). 0 without a prefix cache."""
        if self.prefix_cache is None:
            return 0
        if self.pool.holds(slot) or self.ctx_lens[slot] != 0:
            raise RuntimeError(f"attach_prefix on slot {slot} with existing pages/context")
        prompt = np.asarray(prompt)
        match = self.prefix_cache.match(prompt.tolist())
        matched = min(match.matched_tokens, len(prompt) - 1)
        if matched <= 0:
            return 0
        keep = -(-matched // self.tile)
        pages = match.pages[:keep]
        self.pool.share(slot, pages)
        self.page_tbl[slot, :keep] = pages
        self._slot_shared_tiles[slot] = set(range(keep))
        self._slot_prefix_full[slot] = matched // self.tile
        self.stats.prefix_matched_tokens += matched
        self.stats.prefix_attach_count += 1
        return matched

    def _fill_page(self, page: int, value: float):
        """Overwrite page ``page`` of every ``attn`` layer's pools with
        ``value`` (the other layers hold dense per-slot rows), in
        place (reference ``_fill_page``, ``repro/serving/engine.py:457-502``):
        NaN-poisoning a victim page under fault injection, and zero-scrubbing
        a poisoned slot's private pages before they return to the free list
        (a recycled page may be read through masked columns, where finite
        garbage is harmless and NaN is not). int8 pools cannot hold NaN: the
        content is filled with 0 and the page's scales with ``value``, so a
        NaN page dequantizes to ``0 * NaN = NaN`` and a scrub to exact
        zeros. An f8 page is filled with ``value``'s e4m3 code (NaN: 0x7f).
        The pool tensors stay the same objects, so no captured step is
        captured anew."""
        code = int(kv_bytes(to_kv(torch.tensor([value]), F8))[0])
        for lc in self._pool_layers():
            for name, t in lc.items():
                if t.dtype == F8:
                    kv_bytes(t[page]).fill_(code)
                else:
                    t[page].fill_(0 if t.dtype == torch.int8 else value)

    def _copy_page(self, src: int, dst: int):
        """Copy-on-write's device side: page ``src`` onto page ``dst`` in
        every layer's K and V pools, in place (the reference clones it into
        a donated cache). An int8 page's content and its scales are copied
        verbatim: exact, nothing requantized."""
        for lc in self._pool_layers():
            for name in lc:
                lc[name][dst].copy_(lc[name][src])

    def _pool_layers(self) -> List[Dict[str, torch.Tensor]]:
        """The caches of the layers that hold page pools: the ``attn``
        layers (a paged engine's others keep dense per-slot rows)."""
        return [lc for lc, kind in zip(self.cache, self.layer_kinds) if kind == "attn"]

    def _cow_tile(self, slot: int, t: int) -> bool:
        """Copy-on-write logical tile ``t`` of ``slot`` before a KV write
        lands in a shared page: copy the page onto a fresh one, swap the
        table entry, release the share. Returns False (state unchanged)
        when no page can be had now. The copy is traced as the ``cow``
        span. Fault point ``cow_clone``: an injected failure returns False
        with nothing changed, as a failed allocation does."""
        if self.faults is not None and self.faults.fire("cow_clone"):
            return False
        old = int(self.page_tbl[slot, t])
        got = self._pool_alloc(slot, 1)
        if got is None:
            return False
        new = got[0]
        with self.tracer.span("cow", slot=slot, tile=t):
            self._copy_page(old, new)
        self.page_tbl[slot, t] = new
        self.pool.release_pages(slot, [old])
        self._slot_shared_tiles[slot].discard(t)
        if t < self._slot_prefix_full[slot]:
            self._slot_prefix_full[slot] = t
        self.stats.cow_copies += 1
        return True

    def _cow_for_writes(self, slot: int, start: int, upto: int) -> bool:
        """Copy-on-write every shared tile that KV writes for positions
        ``[start, upto)`` would touch."""
        shared = self._slot_shared_tiles[slot]
        if not shared or upto <= start:
            return True
        for t in range(start // self.tile, (upto - 1) // self.tile + 1):
            if t in shared and not self._cow_tile(slot, t):
                return False
        return True

    def ensure_chunk_pages(self, slot: int, upto_tokens: int,
                           write_from: Optional[int] = None) -> bool:
        """Grow ``slot``'s pages to cover prompt positions ``[0,
        upto_tokens)``. With ``write_from`` (the chunk's first position),
        shared pages the chunk's KV writes would land in are copied first:
        a partial-page radix match hands the slot an immutable page its own
        appends must not touch. Returns False when the pool cannot serve
        the chunk now."""
        need = min(-(-int(upto_tokens) // self.tile), self.pages_per_slot)
        have = self.pool.count(slot)
        if have < need:
            got = self._pool_alloc(slot, need - have)
            if got is None:
                return False
            self.page_tbl[slot, have:need] = got
        if write_from is not None:
            return self._cow_for_writes(slot, int(write_from), int(upto_tokens))
        return True

    def prefill_chunks_tick(self, work: List[tuple], pack_width: int,
                            chunk_cap: int) -> np.ndarray:
        """One packed chunked-prefill step. ``work`` holds up to
        ``pack_width`` tuples ``(slot, chunk_tokens, off)``: a chunk of at
        most ``chunk_cap`` tokens of one PREFILLING slot's prompt, whose
        pages already cover ``off + len`` tokens. K/V go straight into the
        page pools (in place) through each slot's table row. The pack
        geometry ``(pack_width, chunk_cap, pages_per_slot)`` is fixed; pad
        rows are masked. Returns the ``(pack_width,)`` greedy next tokens at
        each row's last valid position -- a row that finishes its prompt
        takes its as the first token. The argmax runs on the device; the
        host sync moves ``pack_width`` ints."""
        if not self.supports_chunked_prefill():
            raise RuntimeError(
                "chunked prefill requires paged=True and an all-'attn' architecture "
                "with rotary positions (see supports_chunked_prefill)"
            )
        if len(work) > pack_width:
            raise ValueError(f"{len(work)} chunks > pack width {pack_width}")
        N, C = pack_width, chunk_cap
        toks = np.zeros((N, C), dtype=np.int32)
        offs = np.zeros(N, dtype=np.int32)
        lens = np.zeros(N, dtype=np.int32)
        tbls = np.zeros((N, self.pages_per_slot), dtype=np.int32)
        visible = [1] * N
        for i, (slot, chunk, off) in enumerate(work):
            chunk = np.asarray(chunk)
            if len(chunk) > C:
                raise ValueError(f"chunk of {len(chunk)} tokens > cap {C}")
            toks[i, : len(chunk)] = chunk
            offs[i] = off
            lens[i] = len(chunk)
            tbls[i] = self.page_tbl[slot]
            visible[i] = max(1, int(off) + len(chunk))
        # only the lean backend runs a chunk schedule; it rides the decode
        # schedule cache's bucket lattice
        n_tokens = int(lens.sum())
        sp = self.tracer.span("prefill_chunk", chunks=len(work), tokens=n_tokens)
        with sp:
            sched = None
            if self.attn_backend == "lean":
                sched = make_chunk_schedule(
                    visible, self.cfg.n_kv_heads, self.tile, self.num_workers,
                    max_len=self.pages_per_slot * self.tile, cache=self.sched_cache,
                )
                if sp:
                    sp.annotate(**sched.work_summary())
            logits = self._run_step(self._chunk_step("chunk", prefill_chunks, sched,
                                                     toks, offs, lens, tbls))
            if sp:
                self._sync(sp)
        self.last_prefill_logits = logits
        next_tok = logits.argmax(dim=-1).to(torch.int32).cpu().numpy()
        self.stats.chunk_prefills += len(work)
        self.stats.prefill_tokens += n_tokens
        self._log(self.stats.tick_prefill_tokens, n_tokens)
        return next_tok

    def _chunk_step(self, kind: str, forward: Callable, sched: Optional[LeanSchedule],
                    toks: np.ndarray, offs: np.ndarray, lens: np.ndarray,
                    tbls: np.ndarray) -> _Step:
        """The chunk step (``forward`` = :func:`prefill_chunks`, the
        reference's ``_chunk_prefill_step``) or the verify step
        (:func:`verify_step`, its ``_spec_verify_step``) over rows of
        ``toks (N, C)`` at depths ``offs`` with ``lens`` valid tokens
        through the table rows ``tbls``. The body builds the backend's
        chunk attention once for all layers (:meth:`_chunk_attn_fn`).
        Keyed on the layout, the kind, the backend, the schedule (None off
        ``lean``) and the pack shape ``(N, C)``."""

        def body(b):
            attn_fn = self._chunk_attn_fn(b["offs"], b["lens"], b["tbls"], sched)
            logits, _ = forward(self.params, self.cfg, self.cache, b["toks"], b["offs"],
                                b["lens"], b["tbls"], attn_fn=attn_fn)
            return logits

        key = (self._layout_key(), kind, self.attn_backend, sched) + toks.shape
        host = {"toks": toks, "offs": offs, "lens": lens, "tbls": tbls}
        return _Step(key, host, body, sched, kind=kind)

    def _chunk_attn_fn(self, offs: torch.Tensor, lens: torch.Tensor, tbls: torch.Tensor,
                       sched: Optional[LeanSchedule]) -> Optional[Callable]:
        """The chunk attention of the configured backend: lean -> the fused
        K4, rows attending causally from ``offs`` through the schedule's
        runtime ``qstart``, its lengths and route built once for all layers;
        fixed -> K8; ref -> None (the plain oracle)."""
        if self.attn_backend == "lean":
            n_kv = self.cfg.n_kv_heads
            seg_ctx = torch.clamp(offs + lens, min=1).to(torch.int32).repeat_interleave(n_kv)
            seg_qstart = offs.to(torch.int32).repeat_interleave(n_kv)
            route = paged_route(sched, tbls, n_kv)

            def attn_fn(q, k_pool, v_pool, tbls, o, k_scales=None, v_scales=None):
                return lean_prefill_chunks(q, k_pool, v_pool, seg_ctx, seg_qstart, tbls, sched,
                                           k_scales=k_scales, v_scales=v_scales, route=route)

            return attn_fn
        if self.attn_backend == "fixed":

            def attn_fn(q, k_pool, v_pool, tbls, o, k_scales=None, v_scales=None):
                if k_scales is not None:
                    # K8 has no int8 body: widen the pool view to bf16 first
                    # (reference engine.py:571-584)
                    k_pool, v_pool = dequant_pool(k_pool, k_scales), dequant_pool(v_pool, v_scales)
                return flash_prefill_paged(q.contiguous(), k_pool, v_pool, tbls, o.to(torch.int32))

            return attn_fn
        return None

    def decode_token_width(self) -> int:
        """Most tokens one decode tick emits per slot: ``k + 1`` with
        speculative decode, else 1. Tick composers charge it against their
        token budget."""
        return self.spec_k + 1 if self.spec_k else 1

    # ---------------------------------------------------------- speculative
    def _spec_select(self, active: List[int]) -> List[int]:
        """The slots running a verify step this tick: those that are healthy
        (degraded-mode level 0), whose context leaves room for the whole
        ``k + 1`` block and whose pages (grown, and copied where shared, as
        a prefill chunk's) cover its writes. The others decode one token
        this tick."""
        R = self.spec_k + 1
        cap = min(self.cache_len, self.pages_per_slot * self.tile)
        out = []
        for s in active:
            if self.guard_cfg is not None and self._slot_degrade[s]:
                continue
            ctx = int(self.ctx_lens[s])
            if ctx + R > cap:
                continue
            if not self.ensure_chunk_pages(s, ctx + R, write_from=ctx):
                continue            # pool pressure: plain decode this tick
            out.append(s)
        return out

    def _spec_verify(self, slots: List[int], guard_on: bool = False):
        """The verify step for ``slots`` (``repro/serving/engine.py:
        1905-1965``): one chunk-shaped forward whose chunk per slot is
        ``[last emitted token, drafts...]``, written at positions ``ctx ..
        ctx + len - 1``. Other slots are masked chunk-style (offs and lens
        0, table rows null), so their K/V are neither read nor written.
        Runs through :meth:`_run_step` (captured on the card). Returns
        ``(slots, rows (B, k+1) greedy tokens, finite (B,) or None,
        drafts)``, the verdict with ``guard_on`` (every row of a slot
        finite), screened as a decode pass's: rejected drafts need no undo,
        their K/V lie past the committed ``ctx_lens``."""
        R = self.spec_k + 1
        N = self.max_batch
        toks = np.zeros((N, R), dtype=np.int32)
        offs = np.zeros(N, dtype=np.int32)
        lens = np.zeros(N, dtype=np.int32)
        drafts: Dict[int, List[int]] = {}
        for s in slots:
            d = [int(t) for t in self.proposer.propose(self.slot_req[s], self.spec_k)]
            d = d[: self.spec_k]
            drafts[s] = d
            toks[s, 0] = self.next_tokens[s, 0]
            toks[s, 1:1 + len(d)] = d
            offs[s] = self.ctx_lens[s]
            lens[s] = 1 + len(d)
        tbls = self.page_tbl.copy()
        for s in range(N):
            if s not in drafts:
                tbls[s, :] = 0
        sched = None
        if self.attn_backend == "lean":
            spec_ctx = [int(self.ctx_lens[s]) if s in drafts else 0 for s in range(N)]
            sched = make_spec_schedule(
                spec_ctx, R, self.cfg.n_kv_heads, self.tile, self.num_workers,
                max_len=self.pages_per_slot * self.tile, cache=self.sched_cache,
            )
        sp = self.tracer.span("spec_verify", slots=len(slots), rows=R)
        with sp:
            logits = self._run_step(self._chunk_step("verify", verify_step, sched,
                                                     toks, offs, lens, tbls))
            if sp:
                self._sync(sp)
        self.last_verify_logits = logits
        if guard_on:
            rows, fin = _screen_logits(logits)
            return slots, rows, fin, drafts
        rows = logits.argmax(dim=-1).to(torch.int32).cpu().numpy()
        return slots, rows, None, drafts

    def _emit_spec_tokens(self, spec, out: Dict[int, List[int]], cap: int) -> int:
        """Greedy acceptance of this tick's verify step: draft ``i + 1``
        stands iff row ``i``'s argmax equals it and every earlier draft
        stood, so the stream is plain greedy decode's. A slot emits its
        accepted drafts plus the first disagreeing row's token; ``ctx_lens``
        advances by that count, and the page-table tail past it is dead.
        A slot whose verify rows are not all finite is quarantined as a
        decode pass's: nothing emitted, its context unchanged (the K/V the
        step wrote lie past it). Returns the tokens emitted."""
        slots, rows, finite, drafts = spec
        n_emitted = 0
        for s in slots:
            req = self.slot_req[s]
            if finite is not None and not bool(finite[s]):
                self._on_bad_slot(s)
                continue
            d = drafts[s]
            a = 0
            while a < len(d) and int(rows[s, a]) == d[a]:
                a += 1
            ctx = int(self.ctx_lens[s])
            rem = req.max_new_tokens - len(req.generated)
            e = max(min(a + 1, rem, cap - 1 - ctx), 1)
            emitted = [int(rows[s, i]) for i in range(e)]
            req.generated.extend(emitted)
            self.next_tokens[s, 0] = emitted[-1]
            self.ctx_lens[s] += e
            out[req.uid] = emitted
            n_emitted += e
            self.stats.tokens_generated += e
            self.stats.spec_draft_tokens += len(d)
            self.stats.spec_accepted_tokens += a
            if req.done or self.ctx_lens[s] >= cap - 1:
                self.release_slot(s)
        self.stats.spec_ticks += 1
        return n_emitted

    # ------------------------------------------------------------ paged mgmt
    def _ensure_decode_pages(self, active: List[int]) -> List[int]:
        """Grow each active slot's pages to cover this tick's KV write, and
        copy the page it lands in first if it is shared; a slot the pool
        cannot serve is preempted."""
        alive = []
        for s in active:
            ctx = int(self.ctx_lens[s])
            need = min(ctx // self.tile + 1, self.pages_per_slot)
            have = self.pool.count(s)
            if have < need:
                got = self._pool_alloc(s, need - have)
                if got is None:
                    self._preempt(s)
                    continue
                self.page_tbl[s, have:need] = got
            wt = min(ctx, self.pages_per_slot * self.tile - 1) // self.tile
            if wt in self._slot_shared_tiles[s] and not self._cow_tile(s, wt):
                self._preempt(s)
                continue
            alive.append(s)
        return alive

    def _preempt(self, slot: int):
        """Evict a slot: return its pages and requeue the request to resume
        by recompute (prompt extended with everything generated so far)."""
        req = self.slot_req[slot]
        if self.pool.holds(slot):
            # shares release (refcount - 1); only private pages are freed
            self.pool.free_seq(slot, eviction=True)
        self.page_tbl[slot, :] = 0
        self.slot_req[slot] = None
        self.ctx_lens[slot] = 0
        self._slot_shared_tiles[slot] = set()
        self._slot_prefix_full[slot] = 0
        self._reset_guard(slot)
        fresh = req.generated[req.folded:]
        req.prompt = np.concatenate(
            [np.asarray(req.prompt), np.asarray(fresh, dtype=np.asarray(req.prompt).dtype)]
        )
        req.folded = len(req.generated)
        if self.preempt_sink is not None:
            self.preempt_sink(req)
        else:
            self.queue.insert(0, req)
        self.stats.preemptions += 1
        self.flight.record("preempt", slot=slot, uid=req.uid, tick=int(self.stats.ticks))
        self.tracer.request_event(req.uid, "PREEMPTED", slot=slot)

    def preempt_slot(self, slot: int):
        """Public eviction hook for schedulers (breaking a page deadlock, a
        missed deadline): works for DECODING and PREFILLING occupants alike;
        a request evicted mid-prefill restarts its prompt on re-admission.
        Paged engines only."""
        if not self.paged:
            raise RuntimeError("preemption only applies to paged engines")
        if self.slot_req[slot] is None:
            raise ValueError(f"slot {slot} is idle")
        self._preempt(slot)

    def _donate_to_prefix_cache(self, slot: int, req: Optional[Request]):
        """Offer a finishing slot's KV pages to the radix cache before its
        references are released: cached blocks outlive the release and
        serve later prompts that start with the same tokens. An insert that
        fails counts ``donation_aborts``."""
        if self.prefix_cache is None or req is None:
            return
        n_tok = int(self.ctx_lens[slot])
        if n_tok <= 0 or not self.pool.holds(slot):
            return
        fresh = req.generated[req.folded:]
        toks = np.concatenate(
            [np.asarray(req.prompt, dtype=np.int64), np.asarray(fresh, dtype=np.int64)]
        )[:n_tok]
        toks = toks[: min(n_tok, self.pool.count(slot) * self.tile)]
        if len(toks) == 0:
            return
        pages = self.page_tbl[slot, : -(-len(toks) // self.tile)].tolist()
        # insert() is all-or-nothing (it unwinds its own partial growth), so
        # a failed donation costs only the cache entry: the slot still
        # releases cleanly and the pool and trie invariants hold
        try:
            self.prefix_cache.insert(toks.tolist(), pages)
        except Exception:
            self.stats.donation_aborts += 1

    def release_slot(self, slot: int):
        """Finish a slot: donate its KV to the radix cache (when there is
        one), release its page references (shared pages live on under
        their other holders) and clear its state."""
        self._donate_to_prefix_cache(slot, self.slot_req[slot])
        self.slot_req[slot] = None
        self.ctx_lens[slot] = 0
        self._free_slot_pages(slot)
        self._reset_guard(slot)

    def _free_slot_pages(self, slot: int):
        if not self.paged:
            return
        if self.pool.holds(slot):
            self.pool.free_seq(slot)
        self.page_tbl[slot, :] = 0
        self._slot_shared_tiles[slot] = set()
        self._slot_prefix_full[slot] = 0

    # ------------------------------------------------------------- cascade
    def _cascade_grouping(self, active: List[int]):
        """This tick's grouped cascade passes: the radix page paths of the
        active slots (their leading runs of full shared pages) grouped at
        their longest common prefixes (:func:`lcp_group_passes`; nested
        subsets stack one pass per trie level with ``multi_level``).
        ``grouping='identical'`` groups only equal page runs. Slots sharing
        with nobody are absent: they decode through their suffix walk."""
        paths = {}
        for s in active:
            npref = self._slot_prefix_full[s]
            if npref > 0:
                paths[s] = tuple(int(p) for p in self.page_tbl[s, :npref])
        if self.cascade_grouping == "identical":
            by_prefix: Dict[tuple, List[int]] = {}
            for s, p in paths.items():
                by_prefix.setdefault(p, []).append(s)
            return sorted(
                (tuple(sorted(m)), 0, len(p)) for p, m in by_prefix.items() if len(m) >= 2
            )
        return lcp_group_passes(paths, multi_level=self.cascade_multi_level)

    def _cascade_host_operands(self, csched: CascadeSchedule, binding: CascadeBinding,
                               fused: bool) -> Tuple[Dict[str, np.ndarray], int]:
        """What a cascade step reads of its grouping besides the binding,
        as int32 host arrays: K5's descriptors and target tables
        (``fd_*``), or the two-call merge's targets and their grid
        (``mg_*``, :func:`cascade_merge_ids`), with the grid's width (0
        with ``fused``). Memoized on the (schedule geometry, binding) pair:
        the stability guard keeps both steady across ticks, so the host
        build runs once per regrouping."""
        key = (csched.signature, fused, binding.members.tobytes(), binding.page_start.tobytes(),
               binding.prefix_pages.tobytes())
        if self._casc_host is None or self._casc_host[0] != key:
            if fused:
                fd = cascade_fused_desc_arrays(cascade_fused_descriptors(csched, binding), csched)
                arrays, width = {f"fd_{n}": a for n, a in zip(fd._fields, fd)}, 0
            else:
                *grid, width = merge_grid_arrays(cascade_merge_ids(csched, binding.members),
                                                 csched.batch * csched.num_kv_heads)
                arrays = dict(zip(("mg_ids", "mg_order", "mg_sid", "mg_rank"), grid))
            self._casc_host = (key, ({k: a.astype(np.int32) for k, a in arrays.items()}, width))
        return self._casc_host[1]

    def _cascade_schedule_for_tick(self, active: List[int], ctx_np):
        """The (schedule, binding) of this tick's cascade decode, or
        ``(None, None)`` when no grouped pass exists or the stability guard
        still holds the path back. The guard keys on the grouping's
        structure (membership and page ranges), not on lengths. Traced as
        the ``cascade_group`` span."""
        with self.tracer.span("cascade_group") as sp:
            csched, binding = self._cascade_schedule_inner(active, ctx_np)
            if sp:
                sp.annotate(engaged=csched is not None, stable_ticks=self._casc_stable)
        return csched, binding

    def _cascade_schedule_inner(self, active: List[int], ctx_np):
        passes = self._cascade_grouping(active)
        if not passes:
            self._casc_key = None
            self._casc_stable = 0
            return None, None
        key = tuple(passes)
        if key == self._casc_key:
            self._casc_stable += 1
        else:
            self._casc_key = key
            self._casc_stable = 1
        if self._casc_stable < self.cascade_stable_ticks:
            self.stats.cascade_stability_skips += 1
            return None, None
        s_pad = self.cache_len + ((-self.cache_len) % self.tile)
        lens = np.minimum(ctx_np + 1, self.cache_len)
        return self.sched_cache.get_cascade(
            lens.tolist(), [m for m, _, _ in passes], [c for _, _, c in passes],
            self.cfg.n_kv_heads, self.tile, self.num_workers, max_len=s_pad,
            page_starts=[st for _, st, _ in passes],
        )

    # ------------------------------------------------------------ decode
    def tick(self) -> Dict[int, int]:
        """Admit + one decode step for all active slots. Returns
        {uid: new_token}."""
        self._admit()
        return self.decode_tick()

    def decode_tick(self, exclude=None) -> Dict[int, int]:
        """One decode step over the active slots. Returns {uid: new_token}
        -- with speculative decode, {uid: [tokens...]} (1 to k+1 tokens per
        slot).

        ``exclude`` masks slots out of this tick: the scheduler passes its
        PREFILLING slots, whose pages hold a partial prompt that the step
        must neither read (their context is 0 for this call, so their
        segment is masked) nor write (their table rows are null for this
        call, so the token write lands in the null page). Their real tables
        and progress stay as they are. Slots running a verify step are
        masked out of the single-token step the same way.

        This wrapper owns the per-tick observability: the ``tick`` span,
        one flight-recorder event, a postmortem dump when the injector fired
        since the last one (also between ticks: admission's ``page_alloc``,
        a chunk's ``cow_clone``) and no guard path dumped this tick, and
        the watchdog's hook."""
        self._tick_dumped = False
        t0 = time.perf_counter() if self.watchdog is not None else 0.0
        with self.tracer.span("tick"):
            out = self._decode_tick_inner(exclude)
        self.flight.record(
            "tick", tick=self.stats.ticks, emitted=len(out),
            active=sum(1 for r in self.slot_req if r is not None), queued=len(self.queue),
        )
        if self.faults is not None and self.faults.total_fires > self._fires_dumped:
            if not self._tick_dumped:
                self._flight_dump("fault-injected")
            self._fires_dumped = self.faults.total_fires
        if self.watchdog is not None:
            self.watchdog.on_tick((time.perf_counter() - t0) * 1e3)
        return out

    def _decode_tick_inner(self, exclude=None) -> Dict[int, int]:
        exclude = set(exclude) if exclude else set()
        if self.faults is not None and self.faults.enabled:
            self._fault_tick_hooks(exclude)
        active = [s for s in range(self.max_batch) if self.slot_req[s] and s not in exclude]
        if self.paged:
            active = self._ensure_decode_pages(active)
        if self.guard_cfg is not None:
            self._run_audits()
        if not active:
            if self.guard_cfg is not None:
                self._update_degraded_gauge()
            return {}
        guard_on = self.guard_cfg is not None and self.guard_cfg.nan_guard
        spec_slots = self._spec_select(active) if self.spec_k else []
        norm = [s for s in active if s not in spec_slots]
        # one pass per degraded-mode level: healthy slots stay on the
        # configured path (the common case: one pass, the whole batch), a
        # quarantined slot decodes in its level's pass with the others masked
        if self.guard_cfg is None or not any(self._slot_degrade[s] for s in norm):
            passes = [(0, norm)] if norm else []
        else:
            by_lvl: Dict[int, List[int]] = {}
            for s in norm:
                by_lvl.setdefault(self._effective_level(s), []).append(s)
            passes = sorted(by_lvl.items())
        # each pass is screened before the next one runs
        results = []
        for lvl, slots in passes:
            logits = self._decode_pass(lvl, slots, active, exclude)
            self.last_logits = logits
            if guard_on:
                results.append((slots, *_screen_logits(logits)))
            else:
                results.append((slots, logits.argmax(dim=-1).cpu().numpy(), None))
        spec = self._spec_verify(spec_slots, guard_on) if spec_slots else None
        # fault point 'nan_output': flip one victim's finiteness verdict; the
        # guard reacts as to a real non-finite row, and no device state is hurt
        if guard_on and self.faults is not None and self.faults.fire("nan_output"):
            for v in self.faults.choose(active):
                for slots, _, fin in results:
                    if v in slots:
                        fin[v] = False
                if spec is not None and v in spec[0]:
                    spec[2][v] = False
        return self._emit_tokens(results, guard_on, spec)

    def _decode_pass(self, level: int, slots: List[int], active: List[int],
                     exclude: set) -> torch.Tensor:
        """One decode pass over ``slots`` at degraded-mode ``level``
        (:data:`~repro_torch.serving.guards.DEGRADE_LEVELS`), in the
        ``decode_kernel`` span, which the pass annotates with its path and
        its schedule's roofline cost; with a live span the stream is
        synchronised after the step, inside it."""
        sp = self.tracer.span("decode_kernel", level=level, slots=len(slots))
        with sp:
            logits = self._decode_pass_inner(level, slots, active, exclude)
            if sp:
                self._sync(sp)
        return logits

    def _decode_pass_inner(self, level: int, slots: List[int], active: List[int],
                           exclude: set) -> torch.Tensor:
        """The pass's step (reference ``repro/serving/engine.py:1825-1865``).
        Slots outside it are masked as ``exclude`` masks them (context 0,
        table rows null), so the step neither reads their K/V nor writes
        anywhere real. Level 0 is :meth:`_decode_pass_main` (the cascade
        included); levels 1 and 2 the paged lean step with ``fused`` True
        (K2) and False (K1 + merge), no cascade; level 3 the ``ref`` step.
        Each runs through :meth:`_run_step`, keyed by its backend and
        ``fused``."""
        masked = exclude | (set(active) - set(slots))
        ctx_np = self.ctx_lens.copy()
        ptbl_np = self.page_tbl
        if masked:
            if not self.use_fast_path:
                raise RuntimeError("slot masking requires the fast path")
            for s in masked:
                ctx_np[s] = 0
            if self.paged:
                ptbl_np = self.page_tbl.copy()
                for s in masked:
                    ptbl_np[s, :] = 0
        if level == 0:
            return self._decode_pass_main(slots, ctx_np, ptbl_np)
        if level >= 3 or self.attn_backend != "lean":
            return self._run_step(self._plain_step(None, ctx_np, ptbl_np, "ref", self.fused))
        sched = self._tick_schedule(ctx_np)
        if self.tracer.enabled:
            # a fallback pass annotates its cost but stays out of the
            # schedule log, which records the fast path
            self.tracer.annotate(path="fallback", **self._schedule_cost(sched))
        return self._run_step(self._plain_step(sched, ctx_np, ptbl_np, "lean", level == 1))

    def _effective_level(self, s: int) -> int:
        """Slot ``s``'s level this tick: a non-lean backend has no lean
        levels, so any degradation goes straight to the ``ref`` step."""
        lvl = self._slot_degrade[s]
        if lvl == 0:
            return 0
        return 3 if self.attn_backend != "lean" else lvl

    def _sync(self, sp) -> None:
        """Wait for the card and charge the wait to the live span ``sp``
        (its ``sync_ms``), as the reference blocks on its jitted step's
        result; a CPU engine's step has run already. Never called inside a
        capture."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        sp.add_sync(time.perf_counter() - t0)

    def _decode_pass_main(self, active: List[int], ctx_np, ptbl_np) -> torch.Tensor:
        """The decode step over the whole batch: the cascade when ``active``
        slots group and the guard lets it engage; else one cached schedule
        and the model's decode step on the configured backend, over the
        page pools or the dense rows; else, with ``use_fast_path=False``,
        the legacy step. The fast path runs through :meth:`_run_step`
        (captured on the card). Updates the cache in place and returns the
        logits (B, V)."""
        if not self.use_fast_path:
            return self._tick_legacy_step(active)
        csched = binding = None
        if self.cascade:
            csched, binding = self._cascade_schedule_for_tick(active, ctx_np)
        if csched is not None:
            return self._cascade_pass(csched, binding, ctx_np, ptbl_np)
        sched = self._tick_schedule(ctx_np)
        self._note_schedule(sched, "fast")
        return self._run_step(self._plain_step(sched, ctx_np, ptbl_np, self.attn_backend,
                                               self.fused))

    def _step_inputs(self, ctx_np, ptbl_np) -> Dict[str, np.ndarray]:
        host = {"tokens": self.next_tokens, "ctx": ctx_np.astype(np.int32)}
        if self.paged:
            host["ptbl"] = ptbl_np
        return host

    def _visible(self, ctx: torch.Tensor) -> torch.Tensor:
        """Each slot's visible keys this tick, as every layer computes them:
        its context plus the token being written, clamped to the slot's
        capacity."""
        cap = self.pages_per_slot * self.tile if self.paged else self.cache_len
        return torch.clamp(ctx + 1, max=cap).to(torch.int32)

    def _plain_step(self, sched: Optional[LeanSchedule], ctx_np, ptbl_np, backend: str,
                    fused: bool) -> _Step:
        """The fast path's step over this tick's schedule on ``backend``
        (``fused`` picks K2 or K1 + merge on ``lean``), as the reference's
        ``_kernel_decode_step`` (``repro/serving/engine.py:515-548``) and
        its paged twin: ``attn_fn`` of the page pools or the dense rows,
        with what every layer reads alike (the visible lengths per segment,
        the paged route) built once per step. ``ref`` reads no schedule
        (``sched`` may be None)."""
        num_splits = None
        if backend == "fixed":
            num_splits = fixed_split_factor(
                int(sched.seg_len.max(initial=1)), sched.num_segments, self.tile,
                self.num_workers,
            )
        n_kv = self.cfg.n_kv_heads

        def body(b):
            ptbl = b.get("ptbl")
            attn_fn = None
            if backend != "ref":
                seg = self._visible(b["ctx"]).repeat_interleave(n_kv)
                attn_fn = self._attn_fn(sched, ptbl, seg, num_splits, backend, fused)
            logits, _ = decode_step(self.params, self.cfg, self.cache, b["tokens"],
                                    attn_fn=attn_fn, ctx_lens=b["ctx"], page_tbl=ptbl)
            return logits

        # 'ref' reads no schedule: its graph, as the reference's jit, is
        # keyed on the layout alone
        keyed = None if backend == "ref" else sched
        key = (self._layout_key(), backend, keyed, fused, num_splits)
        return _Step(key, self._step_inputs(ctx_np, ptbl_np), body, keyed)

    def _layout_key(self) -> tuple:
        return ("paged" if self.paged else "dense", self.cfg.kv_cache_dtype)

    def _attn_fn(self, sched: LeanSchedule, ptbl: Optional[torch.Tensor], seg: torch.Tensor,
                 num_splits: Optional[int], backend: str, fused: bool) -> Callable:
        """The fast path's decode attention, an ``attn_fn(q, k, v,
        ctx_visible)`` of the page pools (``ptbl``) or of the dense rows
        (``ptbl`` None) whose ``seg`` (the visible keys per segment) and
        paged route are the step's: lean -> K2 (or K1 + merge with
        ``fused=False``); fixed -> K6 + ``merge_n`` with ``num_splits``,
        the pages gathered to dense first."""
        n_kv = self.cfg.n_kv_heads
        if backend == "lean":
            if ptbl is None:
                return lambda q, k, v, c: lean_decode_from_schedule(q, k, v, seg, sched,
                                                                    fused=fused)
            route = paged_route(sched, ptbl, n_kv)
            return lambda q, k, v, c, k_scales=None, v_scales=None: (
                lean_decode_paged_from_schedule(
                    q, k, v, seg, ptbl, sched, fused=fused, k_scales=k_scales,
                    v_scales=v_scales, route=route))
        tile = self.tile
        dense = (lambda x: x) if ptbl is None else (lambda pool: paged_gather_kv(pool, ptbl))

        def attn_fn(q, k, v, c, k_scales=None, v_scales=None):
            if k_scales is None:
                return flash_decode_from_lens(q, dense(k), dense(v), seg,
                                              num_splits=num_splits, tile=tile)
            # int8 (reference engine.py:366-372): the pages gathered and
            # dequantized to float32, which the reference's K6 reads with
            # bf16 queries and widens to float32 inside; here the queries
            # are widened first, for K6's one-dtype operands
            kd = paged_gather_kv_dequant(k, k_scales, ptbl)
            vd = paged_gather_kv_dequant(v, v_scales, ptbl)
            return flash_decode_from_lens(q.float(), kd, vd, seg, num_splits=num_splits,
                                          tile=tile).to(q.dtype)

        return attn_fn

    def _make_attn_fn(self) -> Optional[Callable]:
        """The legacy step's attention (``repro/serving/engine.py:1005-1024``):
        the host lengths of every slot (plus the token being written) drive
        a schedule built inside the call, each tick -- ``ops.lean_decode``
        (K1 + merge) on ``lean``, ``ops.flash_decode`` (K6 + ``merge_n``)
        on ``fixed``; None on ``ref``."""
        backend = self.attn_backend
        if backend == "ref":
            return None
        ctx = [int(c) + 1 for c in self.ctx_lens]
        num_workers = self.num_workers

        def attn_fn(q, k, v, ctx_visible):
            lens = [min(c, k.shape[2]) for c in ctx]
            if backend == "lean":
                return lean_decode(q, k, v, lens, num_workers=num_workers)
            return flash_decode(q, k, v, lens)

        return attn_fn

    def _tick_legacy_step(self, active: List[int]) -> torch.Tensor:
        """The reference's pre-fast-path step, kept as its benchmark baseline
        (``repro/serving/engine.py:2377-2406``), dense engines only: the
        schedule is built from the active lengths for the stats record and
        again inside the attention call (:meth:`_make_attn_fn`)."""
        lens = [int(self.ctx_lens[s]) + 1 for s in active]
        sched = make_schedule(
            lens, self.cfg.n_kv_heads,
            min(default_tile_size(self.cfg.head_dim), max(8, max(lens))), self.num_workers,
        )
        self._note_schedule(sched, "legacy")
        dev = self.device
        logits, self.cache = decode_step(
            self.params, self.cfg, self.cache, torch.as_tensor(self.next_tokens).to(dev),
            attn_fn=self._make_attn_fn(),
            ctx_lens=torch.as_tensor(self.ctx_lens, dtype=torch.int32).to(dev),
        )
        return logits

    def _cascade_pass(self, csched: CascadeSchedule, binding: CascadeBinding, ctx_np,
                      ptbl_np) -> torch.Tensor:
        """Cascade decode (:meth:`_cascade_step`) and its counters."""
        self._note_schedule(csched.suffix_sched, "cascade")
        if csched.signature not in self._casc_signatures:
            self._casc_signatures.add(csched.signature)
            self.stats.cascade_retraces += 1
        logits = self._run_step(self._cascade_step(csched, binding, ctx_np, ptbl_np))
        grouped = np.unique(binding.members[binding.members >= 0])
        passes = int((binding.members[:, 0] >= 0).sum())
        st = self.stats
        st.cascade_ticks += 1
        st.cascade_fused_ticks += int(self.cascade_fused)
        st.cascade_grouped_slots += len(grouped)
        st.cascade_grouped_passes += passes
        st.cascade_levels_max = max(st.cascade_levels_max, binding.num_levels)
        st.cascade_last = {"passes": passes, "grouped_slots": int(len(grouped)),
                           "levels": int(binding.num_levels), "fused": bool(self.cascade_fused)}
        return logits

    def _cascade_step(self, csched: CascadeSchedule, binding: CascadeBinding, ctx_np,
                      ptbl_np) -> _Step:
        """The cascade's step: the KV write goes through the full page
        table; attention walks each grouped pass's shared pages once and
        each slot's private tail, and merges (K5 in one launch, or K1 twice
        + merge with ``CascadeConfig(fused=False)``, its grid from the
        host). The suffix length of a slot is its visible context less its
        shared coverage, at least 0. The grouping rides in the step's
        inputs, so one captured step serves every binding of its
        schedule."""
        prefix_tbl, suffix_tbl = cascade_tables(ptbl_np, binding)
        fused = self.cascade_fused
        extra, width = self._cascade_host_operands(csched, binding, fused)
        host = self._step_inputs(ctx_np, ptbl_np)
        host.update(prefix_lens=binding.prefix_lens, members=binding.members,
                    seq_prefix_len=binding.seq_prefix_len, prefix_tbl=prefix_tbl,
                    suffix_tbl=suffix_tbl, **extra)
        n_kv = self.cfg.n_kv_heads

        def body(b):
            suffix = torch.clamp(self._visible(b["ctx"]) - b["seq_prefix_len"], min=0)
            suffix = suffix.repeat_interleave(n_kv)
            fdesc = grid = None
            if fused:
                fdesc = CascadeFusedDesc(*(b[f"fd_{n}"] for n in CascadeFusedDesc._fields))
            else:
                grid = MergeGrid(*(b[f"mg_{n}"].long() for n in ("ids", "order", "sid", "rank")),
                                 width=width)
            routing = cascade_routing(csched, b["members"], b["prefix_lens"], b["prefix_tbl"],
                                      b["suffix_tbl"], suffix, fused=fused, merge_grid=grid)

            def attn_fn(q, k_pool, v_pool, ctx_visible, k_scales=None, v_scales=None):
                return lean_decode_cascade_from_schedule(
                    q, k_pool, v_pool, suffix, b["prefix_lens"], b["members"],
                    b["prefix_tbl"], b["suffix_tbl"], fdesc, csched, fused=fused,
                    k_scales=k_scales, v_scales=v_scales, routing=routing,
                )

            logits, _ = decode_step(self.params, self.cfg, self.cache, b["tokens"],
                                    attn_fn=attn_fn, ctx_lens=b["ctx"], page_tbl=b["ptbl"])
            return logits

        key = (self._layout_key(), "cascade", csched, fused, width)
        return _Step(key, host, body, csched)

    # ------------------------------------------------------ captured steps
    def _run_step(self, step: _Step) -> torch.Tensor:
        """Run one step (decode, chunk, verify or admission): eagerly on a
        CPU engine, with ``capture_decode`` off, and on a key's first
        sighting (its warm-up); from its second on as a CUDA graph replay,
        captured on that sighting. Returns the step's logits."""
        flat, layout = _pack({k: np.asarray(a, dtype=np.int32) for k, a in step.host.items()})
        key = (step.key, layout)
        self.last_step_key = key
        if not self.capture_decode:
            return step.body(_unpack(torch.from_numpy(flat).to(self.device), layout))
        if self.device.type != "cuda":
            raise ValueError("capture_decode captures the step on a CUDA device; "
                             f"this engine runs on {self.device}")
        entry = self._graphs.get(key)
        if entry is None:                  # the key's warm-up tick
            self._graphs[key] = (step.sched, None)
            return step.body(_unpack(torch.from_numpy(flat).to(self.device), layout))
        rec = entry[1]
        if rec is not None and (rec.params is not self.params
                                or rec.cache_ptrs != _cache_ptrs(self.cache)):
            rec = None                     # the step's tensors were replaced: capture anew
        if rec is None:
            rec = self._capture(step, flat, layout)
            self._graphs[key] = (step.sched, rec)
        if step.kind == "admit" and not self.bucket_prefill:
            self._hold_exact_admission(key)
        return self._replay(rec, flat)

    def _hold_exact_admission(self, key: tuple) -> None:
        """Mark the captured exact-length admission ``key`` most recently
        used and drop the least recently used beyond ``EXACT_ADMIT_GRAPHS``
        (its key then warms up again)."""
        held = self._exact_admits
        held.pop(key, None)
        held[key] = None
        while len(held) > EXACT_ADMIT_GRAPHS:
            old = next(iter(held))
            del held[old]
            self._graphs.pop(old, None)

    def _capture(self, step: _Step, flat: np.ndarray, layout: tuple) -> _StepGraph:
        """Capture ``step.body`` on the engine's capture stream into the
        graphs' shared memory pool (each replay's logits are copied out
        before the next replay; the steps run one after another on one
        stream, so one graph's scratch may reuse another's), under the
        default (global) capture error
        mode. ``torch.cuda.graph`` would also empty the allocator's cache
        at every capture, which the eager steps around it then pay for;
        this is its capture without that. Python's cyclic collector is
        held off while the step is captured: a graph it frees then (an
        engine dropped earlier that sits in a reference cycle, as one with
        a Scheduler does through its preemption sink) destroys a CUDA
        graph, which the
        global capture mode forbids, and the capture is invalidated.
        Nothing runs while it is captured; the launch counters' change is
        taken back out and kept to add on each replay. A failure raises."""
        dev = self.device
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(dev)
        inputs = torch.from_numpy(flat).to(dev)
        graph = torch.cuda.CUDAGraph()
        before = launches.snapshot()
        torch.cuda.synchronize(dev)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(self._capture_stream):
                graph.capture_begin(pool=self._graph_pool)
                try:
                    logits = step.body(_unpack(inputs, layout))
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass            # the capture the error above invalidated
                    raise
                graph.capture_end()
        finally:
            if collecting:
                gc.enable()
            after = launches.snapshot()
            launches.restore(before)
        _bump(self.stats, f"{step.kind}_captures")
        return _StepGraph(
            graph=graph, kind=step.kind, inputs=inputs,
            staging=torch.empty(flat.shape, dtype=torch.int32, pin_memory=True),
            copied=torch.cuda.Event(), logits=logits,
            launches=launches.delta(after, before), sched=step.sched, params=self.params,
            cache=[dict(lc) for lc in self.cache], cache_ptrs=_cache_ptrs(self.cache),
        )

    def _replay(self, rec: _StepGraph, flat: np.ndarray) -> torch.Tensor:
        """One call of a captured step: the inputs go through the pinned
        buffer into the graph's in one asynchronous copy, the graph
        replays, the logits are copied out. No host sync."""
        if not rec.copied.query():
            rec.copied.synchronize()       # the last replay's copy still reads the buffer
        rec.staging.numpy()[:] = flat
        rec.inputs.copy_(rec.staging, non_blocking=True)
        rec.copied.record()
        rec.graph.replay()
        launches.add(rec.launches)
        _bump(self.stats, f"{rec.kind}_replays")
        return rec.logits.clone()

    def _drop_graphs(self, sched) -> None:
        """The schedule cache let ``sched`` go: drop the steps captured on
        it (and keys only warmed up), freeing what they hold. Once no graph
        is left their memory pool goes too (a pool whose graphs are all
        gone takes no new capture): the next capture opens a new one. The
        schedule's roofline cost goes with it."""
        self._sched_costs.pop(sched, None)
        self._sched_costs.pop(getattr(sched, "suffix_sched", None), None)
        for key in [k for k, (s, _) in self._graphs.items() if s is sched]:
            del self._graphs[key]
        if all(g is None for _, g in self._graphs.values()):
            self._graph_pool = None

    def _emit_tokens(self, results, guard_on: bool, spec=None) -> Dict[int, int]:
        """Emit each pass's tokens (``results``: ``(slots, next tokens,
        finite or None)`` per pass) and, when a verify step ran, its
        accepted ones (:meth:`_emit_spec_tokens`; then every value is a
        list), with the guards' bookkeeping: a slot whose row is not finite
        emits nothing and steps down the chain (:meth:`_on_bad_slot`), a
        degraded slot's finite row counts toward its heal."""
        # context cap: the cache row and, paged, the whole pool -- a context
        # past usable_pages * tile could never be re-admitted after preemption
        cap = self.cache_len
        if self.paged:
            cap = min(cap, self.pool.usable_pages * self.tile)
        out = {}
        n_emitted = 0
        for slots, next_all, finite in results:
            for s in slots:
                req = self.slot_req[s]
                if finite is not None and not bool(finite[s]):
                    # quarantine: no token, the context stays, and the slot
                    # runs this step again next tick one level further down
                    self._on_bad_slot(s)
                    continue
                if guard_on and self._slot_degrade[s]:
                    self._on_good_slot(s)
                nxt = int(next_all[s])
                req.generated.append(nxt)
                self.next_tokens[s, 0] = nxt
                self.ctx_lens[s] += 1
                out[req.uid] = [nxt] if self.spec_k else nxt
                n_emitted += 1
                self.stats.tokens_generated += 1
                if req.done or self.ctx_lens[s] >= cap - 1:
                    self.release_slot(s)
        if spec is not None:
            n_emitted += self._emit_spec_tokens(spec, out, cap)
        self.stats.ticks += 1
        self._log(self.stats.tick_decode_tokens, n_emitted)
        self.stats.schedule_cache = self.sched_cache.stats.as_dict()
        if self.paged:
            self.stats.kv_pool = self.pool.as_dict()
        if self.prefix_cache is not None:
            self.stats.prefix_cache = self.prefix_cache.as_dict()
        if self.guard_cfg is not None:
            self._update_degraded_gauge()
        if self.faults is not None:
            self.stats.faults = self.faults.as_dict()
        return out

    # --------------------------------------------------------- self-healing
    def _on_bad_slot(self, s: int):
        """A non-finite row for slot ``s``: one level down the chain, or,
        once at ``max_degrade`` for ``poison_after`` consecutive ticks,
        poison the slot."""
        gc_ = self.guard_cfg
        self.stats.nan_ticks += 1
        self.flight.record("nan_tick", slot=s, tick=int(self.stats.ticks))
        self._slot_good[s] = 0
        if self._slot_degrade[s] < gc_.max_degrade:
            self._slot_degrade[s] += 1
            self._slot_bad[s] = 0
            self.stats.degrade_escalations += 1
            self._degrade_cause.labels(cause="nan_guard").inc()
            self.flight.record("degrade", slot=s, level=self._slot_degrade[s], cause="nan_guard",
                               backend=DEGRADE_LEVELS[self._slot_degrade[s]])
            self._flight_dump("degrade", slot=s, level=self._slot_degrade[s])
            return
        self._slot_bad[s] += 1
        if self._slot_bad[s] >= gc_.poison_after:
            self._poison_slot(s)

    def _on_good_slot(self, s: int):
        """A degraded slot's finite row: after ``heal_after`` in a row, one
        level back up."""
        self._slot_bad[s] = 0
        self._slot_good[s] += 1
        if self._slot_good[s] >= self.guard_cfg.heal_after:
            self._slot_degrade[s] -= 1
            self._slot_good[s] = 0
            self.stats.degrade_heals += 1

    def _poison_slot(self, s: int):
        """The bottom of the chain: the slot's K/V is presumed corrupt. Its
        private pages are zero-filled in place (a recycled NaN page would
        poison an innocent slot through masked columns), its shared pages
        withdrawn from the radix cache, and the slot preempted: recompute
        rebuilds clean K/V from the prompt."""
        shared = self._slot_shared_tiles[s]
        for t in range(self.pool.count(s)):
            page = int(self.page_tbl[s, t])
            if t not in shared and page:
                self._fill_page(page, 0.0)
        if self.prefix_cache is not None and shared:
            self.prefix_cache.invalidate_pages({int(self.page_tbl[s, t]) for t in shared})
        self.stats.poisoned_slots += 1
        self.flight.record("poison", slot=s, tick=int(self.stats.ticks),
                           scrubbed_pages=self.pool.count(s) - len(shared))
        self._preempt(s)
        self._flight_dump("poison", slot=s)

    def force_degrade(self, levels: int = 1, cause: str = "watchdog",
                      slots: Optional[List[int]] = None) -> int:
        """Push active slots (``slots``, default all) ``levels`` steps down
        the chain, the ``cause`` (one of ``guards.DEGRADE_CAUSES``) on the
        flight event and the ``engine_degrade_cause_total`` counter. They
        heal back by the usual ``heal_after`` rule. Needs guards. Returns
        the slots moved."""
        if self.guard_cfg is None:
            raise ValueError("force_degrade requires guards=GuardConfig(...)")
        if cause not in DEGRADE_CAUSES:
            raise ValueError(f"unknown degrade cause {cause!r} (see DEGRADE_CAUSES)")
        targets = slots if slots is not None else range(self.max_batch)
        moved = 0
        for s in targets:
            if self.slot_req[s] is None:
                continue
            new = min(self._slot_degrade[s] + levels, self.guard_cfg.max_degrade)
            if new == self._slot_degrade[s]:
                continue
            self._slot_degrade[s] = new
            self._slot_good[s] = 0
            self.stats.degrade_escalations += 1
            self._degrade_cause.labels(cause=cause).inc()
            self.flight.record("degrade", slot=s, level=new, cause=cause,
                               backend=DEGRADE_LEVELS[new])
            moved += 1
        if moved:
            self._update_degraded_gauge()
        return moved

    def _reset_guard(self, s: int):
        self._slot_degrade[s] = 0
        self._slot_bad[s] = 0
        self._slot_good[s] = 0

    def _update_degraded_gauge(self):
        self.degraded_gauge.set(sum(1 for s in range(self.max_batch)
                                    if self.slot_req[s] is not None and self._slot_degrade[s]))
        self.stats.degraded = self.degraded_gauge.as_dict()

    def _run_audits(self):
        """Every ``audit_interval`` decode calls: ``pool.check()`` (with the
        int8 scales) then ``prefix_cache.check()``; a violation raises
        :class:`FatalInvariantError`, repairs in place or warns, per
        ``audit_action``. The pool goes first: a trie repair frees pages
        through it. Traced as the ``audit`` span."""
        gc_ = self.guard_cfg
        if gc_.audit_interval <= 0:
            return
        self._audit_clock += 1
        if self._audit_clock % gc_.audit_interval:
            return
        self.stats.audits_run += 1
        targets = [("kv_pool", self.pool)]
        if self.prefix_cache is not None:
            targets.append(("prefix_cache", self.prefix_cache))
        with self.tracer.span("audit", targets=len(targets)):
            for name, obj in targets:
                try:
                    if name == "kv_pool" and self.quant:
                        obj.check(scales=self._kv_scale_arrays())
                    else:
                        obj.check()
                except AssertionError as e:
                    self.stats.audit_failures += 1
                    self.flight.record("audit_failure", target=name, action=gc_.audit_action,
                                       error=str(e)[:200])
                    if gc_.audit_action == "raise":
                        self._flight_dump("fatal-audit", target=name)
                        raise FatalInvariantError(f"{name} invariant audit failed: {e}") from e
                    if gc_.audit_action == "repair":
                        obj.repair()
                        self.stats.audit_repairs += 1
                        obj.check()     # a repair must restore the invariants
                        self._flight_dump("audit-repair", target=name)
                    else:
                        warnings.warn(f"{name} invariant audit failed (action=log): {e}",
                                      RuntimeWarning)
                        self._flight_dump("audit-failure", target=name)

    # ---------------------------------------------------------- fault hooks
    def _fault_tick_hooks(self, exclude: set):
        """The per-tick fault points, before the tick's active set is
        taken: a latency spike, a preemption storm, a corrupted radix-trie
        node, a NaN page of live K/V."""
        inj = self.faults
        inj.advance()
        if inj.fire("tick_latency"):
            spec = inj.spec("tick_latency")
            time.sleep(spec.magnitude if spec.magnitude > 0 else 0.002)
        if self.paged and inj.fire("preempt_storm"):
            spec = inj.spec("preempt_storm")
            victims = [s for s in range(self.max_batch) if self.slot_req[s] is not None]
            for s in inj.choose(victims, max(1, int(spec.magnitude))):
                self._preempt(s)
        if self.prefix_cache is not None and inj.fire("trie_corrupt"):
            corrupt_trie_node(self.prefix_cache, inj.rng("trie_corrupt"))
        if self.paged and inj.fire("nan_kv"):
            self._inject_nan_kv(exclude)

    def _inject_nan_kv(self, exclude: set):
        """Device-side corruption: fill one victim slot's private page that
        holds written K/V with NaN. Shared pages are skipped (the poison
        path withdraws those), and so are slots with nothing written."""
        cands = []
        for s in range(self.max_batch):
            if self.slot_req[s] is None or s in exclude:
                continue
            ctx = int(self.ctx_lens[s])
            if ctx <= 0:
                continue
            for t in range(min(-(-ctx // self.tile), self.pages_per_slot)):
                if t not in self._slot_shared_tiles[s] and int(self.page_tbl[s, t]) != 0:
                    cands.append((s, t))
        if not cands:
            return
        s, t = self.faults.choose(cands)[0]
        self._fill_page(int(self.page_tbl[s, t]), float("nan"))

    def _kv_scale_arrays(self) -> List[np.ndarray]:
        """Host copies of every int8 pool's ``(num_pages, Hkv)`` scales, K
        then V per layer, for ``pool.check(scales=...)`` (live pages finite
        and >= 0); empty for bf16 pools."""
        return [lc[name].cpu().numpy() for lc in self.cache
                for name in ("k_scale", "v_scale") if name in lc]

    def _log(self, log: List, item):
        log.append(item)
        if len(log) > self.SCHEDULE_LOG_CAP:
            del log[: -self.SCHEDULE_LOG_CAP]

    def _flight_dump(self, reason: str, **extra) -> dict:
        """Snapshot the flight ring into a postmortem bundle, written to the
        recorder's ``dump_dir`` when it has one (the watchdog dumps on
        every fire, the guards on a degrade, a poison and a failed audit).
        Marks the tick as dumped, so the injected-fault dump of
        :meth:`decode_tick` does not double it."""
        ctx = {"tick": int(self.stats.ticks), "degraded_slots": self.degraded_gauge.value,
               **extra}
        if self.faults is not None:
            ctx["fault_fires"] = self.faults.total_fires
        self._tick_dumped = True
        return self.flight.dump(reason, extra=ctx)

    def _schedule_cost(self, sched: LeanSchedule) -> dict:
        """Roofline cost meta (KV bytes, flops, predicted ms on the H100's
        peaks) of a decode schedule, memoized per schedule object: the
        ScheduleCache hands out the same instance tick after tick, so a
        steady tick does no cost arithmetic. An entry goes when the cache
        lets its schedule go (:meth:`_drop_graphs`); the legacy step's
        uncached schedules are bounded by a clear."""
        cost = self._sched_costs.get(sched)
        if cost is None:
            if len(self._sched_costs) > 128:
                self._sched_costs.clear()
            elem = self.pool.layout.elem_bytes if self.paged else 2
            cost = schedule_decode_cost(
                sched, n_q_heads=self.cfg.n_heads, n_kv_heads=self.cfg.n_kv_heads,
                head_dim=self.cfg.head_dim, kv_elem_bytes=elem,
            )
            self._sched_costs[sched] = cost
        return cost

    def _note_schedule(self, sched: LeanSchedule, path: str):
        """The one per-pass schedule bookkeeping point of the cascade, fast
        and legacy decode paths: the stats record, and with a tracer the
        execution path and roofline cost onto the enclosing
        ``decode_kernel`` span."""
        self._record_schedule(sched)
        if self.tracer.enabled:
            self.tracer.annotate(path=path, **self._schedule_cost(sched))

    def _record_schedule(self, sched: LeanSchedule):
        self._log(self.stats.schedules, {
            "lens": sched.seg_len[:: self.cfg.n_kv_heads].tolist(),
            "total_tiles": sched.total_tiles,
            "tiles_per_worker": sched.tiles_per_worker,
            "pieces": sched.num_pieces,
        })

    def run_to_completion(self, max_ticks: int = 10_000):
        while (self.queue or any(self.slot_req)) and self.stats.ticks < max_ticks:
            self.tick()
        return self.stats
