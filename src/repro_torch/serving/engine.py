"""Continuous-batching paged decode engine with LeanAttention scheduling
(port of the paged fast path of ``repro.serving.engine``).

The engine owns a fixed pool of sequence slots, admits requests as slots
free up (whole-prompt prefill, copy-on-admit into KV pages), and runs one
decode step over all active slots per tick. Context lengths are ragged --
the regime of paper §IV-C/Fig. 6.

  * KV lives in a page pool ``(num_pages, H_kv, page_size, d)`` per layer,
    managed by :class:`~repro_torch.serving.kvpool.KVPagePool`; admission
    takes only the pages a prompt needs, decode grows sequences page by
    page, a finished request returns its pages at once, and an undersized
    pool preempts (evict + recompute-resume) only when it actually fills.
  * Each tick's stream-K schedule comes from a :class:`ScheduleCache` over
    bucketed lengths (``max_len`` = the padded cache length, as the
    reference), so schedules -- and therefore the kernels' reduction order
    -- match the reference's tick for tick.
  * Backend ``'lean'`` runs attention through the stream-K kernels: K2
    (fused) by default, K1 + merge with ``fused=False``. Backend ``'ref'``
    gathers the pages and runs the plain oracle.

Where the reference jits each step with the KV cache donated, the port
updates the page pools in place (index assignment) and runs eagerly.
Requests enter with blocking admission; prefill runs at the exact prompt
length (the reference's bucketing only bounds XLA compiles, and the
positions it pads are masked anyway).

Configurations outside this slice raise ``NotImplementedError`` naming
their ROADMAP item.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.leantile import LeanSchedule, ScheduleCache, default_tile_size
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.ops import lean_decode_paged_from_schedule
from repro_torch.models.transformer import (
    ModelConfig,
    check_supported,
    decode_step,
    init_paged_cache,
    prefill,
)
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.kvpool import KVLayout, KVPagePool


class PoisonError(RuntimeError):
    """A request that can never be served (port of
    ``repro.serving.guards.PoisonError``; the guards arrive with ROADMAP
    queue 1, item 12)."""


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


# the reference's counter names; here plain int attributes (the metrics
# registry arrives with obs/*, ROADMAP queue 1, item 13)
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


class EngineStats:
    """Engine telemetry: the reference's counters as plain ints, plus the
    per-tick schedule and token logs and the last pool/cache snapshots."""

    def __init__(self):
        for name in _STAT_COUNTERS:
            setattr(self, name, 0)
        self.schedules: List[dict] = []
        self.schedule_cache: dict = {}
        self.kv_pool: dict = {}
        self.tick_decode_tokens: List[int] = []


# EngineConfig parts this slice does not run, with their ROADMAP item
def _unported(cfg: ModelConfig, config: EngineConfig) -> Optional[str]:
    if not config.paged.enabled:
        return "the dense-cache engine (ROADMAP queue 1, next slice)"
    if config.paged.prefix_cache:
        return "the prefix cache (ROADMAP queue 1, item 8)"
    if config.cascade.enabled:
        return "cascade decode (ROADMAP queue 1, item 8)"
    if config.spec.enabled:
        return "speculative decode (ROADMAP queue 1, item 10)"
    if (config.paged.kv_dtype or cfg.kv_cache_dtype) != "bf16":
        return "non-bf16 KV pools, int8 included (ROADMAP queue 1, item 9)"
    if config.guards is not None or config.faults is not None:
        return "guards and fault injection (ROADMAP queue 1, item 12)"
    obs = config.obs
    if any(x is not None for x in (obs.tracer, obs.metrics, obs.flight,
                                   obs.flight_dir, obs.watchdog)):
        return "observability sinks (ROADMAP queue 1, item 13)"
    if not config.use_fast_path:
        return "the legacy per-tick baseline, use_fast_path=False (ROADMAP queue 1, item 17)"
    if config.attn_backend == "fixed":
        return "the fixed-split backend, kernel K6 (ROADMAP queue 1, item 11)"
    return None


class DecodeEngine:
    """The paged continuous-batching engine.

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
        missing = _unported(cfg, config)
        if missing is not None:
            raise NotImplementedError(f"not ported yet: {missing}")
        if config.attn_backend not in ("lean", "ref"):
            raise ValueError(f"unknown attn_backend {config.attn_backend!r}")
        if config.interpret is not None:
            raise ValueError(
                "interpret is a Pallas setting; the port runs kernels on CUDA "
                "tensors and their plain versions on CPU tensors"
            )
        check_supported(cfg)
        self.cfg = cfg
        self.params = params
        self.max_batch = config.max_batch
        self.cache_len = config.cache_len
        self.attn_backend = config.attn_backend
        self.num_workers = config.num_workers
        self.fused = config.fused

        # lean tiles map 1:1 onto KV pages
        page_size = config.paged.page_size
        if page_size is not None:
            self.tile = int(page_size)
        else:
            self.tile = min(default_tile_size(cfg.head_dim), max(8, self.cache_len))
        self.pages_per_slot = -(-self.cache_len // self.tile)
        num_pages = config.paged.num_pages
        if num_pages is None:           # dense-equivalent capacity + null page
            num_pages = 1 + self.max_batch * self.pages_per_slot
        layout = KVLayout(
            kv_dtype=cfg.kv_cache_dtype, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, page_size=self.tile,
            n_attn_layers=cfg.n_layers, scale_granularity=cfg.kv_scale_granularity,
        )
        self.pool = KVPagePool(num_pages, self.tile, layout=layout)
        self.page_tbl = np.zeros((self.max_batch, self.pages_per_slot), dtype=np.int32)
        self.cache = init_paged_cache(cfg, num_pages, self.tile, device=self.device)

        self.ctx_lens = np.zeros(self.max_batch, dtype=np.int64)
        self.slot_req: List[Optional[Request]] = [None] * self.max_batch
        self.queue: List[Request] = []
        self.next_tokens = np.zeros((self.max_batch, 1), dtype=np.int32)
        self.sched_cache = ScheduleCache(max_entries=config.schedule_cache_entries)
        self.stats = EngineStats()
        self.last_logits: Optional[torch.Tensor] = None   # last decode pass (B, V)

    # ------------------------------------------------------------- schedule
    def _tick_schedule(self, ctx_np) -> LeanSchedule:
        """The (cached) stream-K schedule for this tick: every slot attends
        over its context plus the token being written, clamped to the cache
        capacity. Built over all slots (idle ones contribute one masked
        tile)."""
        s_pad = self.cache_len + ((-self.cache_len) % self.tile)
        lens = np.minimum(ctx_np + 1, self.cache_len)
        return self.sched_cache.get(
            lens.tolist(), self.cfg.n_kv_heads, self.tile, self.num_workers,
            max_len=s_pad,
        )

    # ------------------------------------------------------------- public
    def submit(self, req: Request):
        self.queue.append(req)

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

    def _run_prompt_prefill(self, prompt: np.ndarray):
        """Whole-prompt prefill at the exact prompt length -> (last-position
        logits (1, V), per-layer K/V of the one slot)."""
        toks = torch.as_tensor(np.asarray(prompt, dtype=np.int64)[None, :]).to(self.device)
        logits, cache1, _ = prefill(self.params, self.cfg, toks, cache_len=self.cache_len)
        return logits, cache1

    def _write_slot_paged(self, cache1, pages: List[int]):
        """Copy-on-admit: scatter the fresh prefill K/V into the slot's
        pages, in place. Whole pages are written (tail padded), so stale
        data in recycled pages is overwritten."""
        n = len(pages)
        need = n * self.tile
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        for lc, lc1 in zip(self.cache, cache1):
            for name in ("k", "v"):
                src = lc1[name][0]                         # (H, cache_len, hd)
                H, L, hd = src.shape
                if need > L:
                    src = torch.nn.functional.pad(src, (0, 0, 0, need - L))
                chunks = src[:, :need].reshape(H, n, self.tile, hd).movedim(1, 0)
                lc[name][idx] = chunks.to(lc[name].dtype)

    def admit_blocking(self, req: Request, slot: int) -> bool:
        """Whole-prompt prefill into ``slot``, pages written, first token
        sampled. Returns False (engine unchanged) when the pool cannot hold
        the prompt right now. Does not touch the engine queue."""
        plen = len(req.prompt)
        self._check_fits_pool(req)
        n = max(1, -(-plen // self.tile))
        pages = self.pool.alloc(slot, n)
        if pages is None:
            return False            # pool exhausted; retry next tick
        self.page_tbl[slot, :n] = pages
        self.slot_req[slot] = req
        logits, cache1 = self._run_prompt_prefill(req.prompt)
        self._write_slot_paged(cache1, pages)
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

    # ------------------------------------------------------------ paged mgmt
    def _ensure_decode_pages(self, active: List[int]) -> List[int]:
        """Grow each active slot's pages to cover this tick's KV write; a
        slot the pool cannot serve is preempted."""
        alive = []
        for s in active:
            ctx = int(self.ctx_lens[s])
            need = min(ctx // self.tile + 1, self.pages_per_slot)
            have = self.pool.count(s)
            if have < need:
                got = self.pool.alloc(s, need - have)
                if got is None:
                    self._preempt(s)
                    continue
                self.page_tbl[s, have:need] = got
            alive.append(s)
        return alive

    def _preempt(self, slot: int):
        """Evict a slot: return its pages and requeue the request to resume
        by recompute (prompt extended with everything generated so far)."""
        req = self.slot_req[slot]
        if self.pool.holds(slot):
            self.pool.free_seq(slot, eviction=True)
        self.page_tbl[slot, :] = 0
        self.slot_req[slot] = None
        self.ctx_lens[slot] = 0
        fresh = req.generated[req.folded:]
        req.prompt = np.concatenate(
            [np.asarray(req.prompt), np.asarray(fresh, dtype=np.asarray(req.prompt).dtype)]
        )
        req.folded = len(req.generated)
        self.queue.insert(0, req)
        self.stats.preemptions += 1

    def release_slot(self, slot: int):
        """Finish a slot: release its pages and clear its state."""
        self.slot_req[slot] = None
        self.ctx_lens[slot] = 0
        if self.pool.holds(slot):
            self.pool.free_seq(slot)
        self.page_tbl[slot, :] = 0

    # ------------------------------------------------------------ decode
    def tick(self) -> Dict[int, int]:
        """Admit + one decode step for all active slots. Returns
        {uid: new_token}."""
        self._admit()
        return self.decode_tick()

    def decode_tick(self) -> Dict[int, int]:
        """One decode step over the active slots. Returns {uid: new_token}."""
        active = [s for s in range(self.max_batch) if self.slot_req[s]]
        active = self._ensure_decode_pages(active)
        if not active:
            return {}
        logits = self._decode_pass_main(self.ctx_lens.copy(), self.page_tbl)
        self.last_logits = logits
        next_all = logits.argmax(dim=-1).cpu().numpy()
        return self._emit_tokens(active, next_all)

    def _decode_pass_main(self, ctx_np, ptbl_np) -> torch.Tensor:
        """The fast-path decode step over the whole batch: one cached
        schedule, the model's decode step with paged attention on the lean
        kernels (or the plain oracle for ``'ref'``). Updates the pools in
        place and returns the logits (B, V)."""
        sched = self._tick_schedule(ctx_np)
        self._record_schedule(sched)
        tokens = torch.as_tensor(self.next_tokens).to(self.device)
        ctx = torch.as_tensor(ctx_np, dtype=torch.int32).to(self.device)
        ptbl = torch.as_tensor(ptbl_np).to(self.device)
        attn_fn = None
        if self.attn_backend == "lean":
            n_kv, fused = self.cfg.n_kv_heads, self.fused

            def attn_fn(q, k_pool, v_pool, ctx_visible):
                seg_ctx = ctx_visible.repeat_interleave(n_kv)
                return lean_decode_paged_from_schedule(
                    q, k_pool, v_pool, seg_ctx, ptbl, sched, fused=fused,
                )

        logits, self.cache = decode_step(
            self.params, self.cfg, self.cache, tokens,
            attn_fn=attn_fn, ctx_lens=ctx, page_tbl=ptbl,
        )
        return logits

    def _emit_tokens(self, active: List[int], next_all) -> Dict[int, int]:
        # context cap: the cache row and the whole pool -- a context past
        # usable_pages * tile could never be re-admitted after preemption
        cap = min(self.cache_len, self.pool.usable_pages * self.tile)
        out = {}
        for s in active:
            req = self.slot_req[s]
            nxt = int(next_all[s])
            req.generated.append(nxt)
            self.next_tokens[s, 0] = nxt
            self.ctx_lens[s] += 1
            out[req.uid] = nxt
            self.stats.tokens_generated += 1
            if req.done or self.ctx_lens[s] >= cap - 1:
                self.release_slot(s)
        self.stats.ticks += 1
        self._log(self.stats.tick_decode_tokens, len(out))
        self.stats.schedule_cache = self.sched_cache.stats.as_dict()
        self.stats.kv_pool = self.pool.as_dict()
        return out

    def _log(self, log: List, item):
        log.append(item)
        if len(log) > self.SCHEDULE_LOG_CAP:
            del log[: -self.SCHEDULE_LOG_CAP]

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
