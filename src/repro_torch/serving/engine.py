"""Continuous-batching paged decode engine with LeanAttention scheduling
(port of the paged fast path of ``repro.serving.engine``).

The engine owns a fixed pool of sequence slots and provides the mechanisms
a server is built from (:mod:`repro_torch.serving.scheduler` is the policy
on top): blocking admission (whole-prompt prefill, copy-on-admit into KV
pages), a packed chunked-prefill step that streams prompt chunks straight
into the pool (:meth:`DecodeEngine.prefill_chunks_tick`), and one decode
step over all active slots per tick, with slots still prefilling masked out
(``decode_tick(exclude=...)``). Context lengths are ragged -- the regime of
paper §IV-C/Fig. 6.

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
    (fused) by default, K1 + merge with ``fused=False``; chunked prefill
    through K4 + merge. Backend ``'fixed'`` is the paper's baseline: decode
    gathers the pages and runs fixed-split FlashDecoding (K6 + ``merge_n``),
    chunked prefill runs paged FA-2 (K8). Backend ``'ref'`` runs the plain
    oracles.

Where the reference jits each step with the KV cache donated, the port
updates the page pools in place (index assignment) and runs eagerly.
Blocking prefill runs at the exact prompt length (the reference's bucketing
only bounds XLA compiles, and the positions it pads are masked anyway).
Latency observations (TTFT, TPOT, queue wait) are plain lists of seconds on
:class:`EngineStats`, filled by the scheduler; the reference's histograms
come with its metrics registry (ROADMAP queue 1, item 13).

Configurations outside this slice raise ``NotImplementedError`` naming
their ROADMAP item.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.attention import paged_gather_kv
from repro_torch.core.leantile import (
    LeanSchedule,
    ScheduleCache,
    default_tile_size,
    fixed_split_factor,
    make_chunk_schedule,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.flash_prefill import flash_prefill_paged
from repro_torch.kernels.ops import (
    flash_decode_from_lens,
    lean_decode_paged_from_schedule,
    lean_prefill_chunks,
)
from repro_torch.models.transformer import (
    ModelConfig,
    check_supported,
    decode_step,
    init_paged_cache,
    prefill,
    prefill_chunks,
    supports_chunked_prefill,
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
    """Engine telemetry: the reference's counters as plain ints, the
    per-tick schedule and token logs, the last pool/cache snapshots, and
    the latency observations in seconds (time to first token, time per
    output token, queue wait), which the scheduler appends."""

    def __init__(self):
        for name in _STAT_COUNTERS:
            setattr(self, name, 0)
        self.schedules: List[dict] = []
        self.schedule_cache: dict = {}
        self.kv_pool: dict = {}
        self.tick_decode_tokens: List[int] = []
        self.tick_prefill_tokens: List[int] = []
        self.ttft: List[float] = []
        self.tpot: List[float] = []
        self.queue_wait: List[float] = []


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
        if config.attn_backend not in ("lean", "fixed", "ref"):
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
        self.last_prefill_logits: Optional[torch.Tensor] = None   # last chunk step (N, V)
        # a scheduler registers here to take preempted requests into its own
        # queue; without one they go back to the engine's queue
        self.preempt_sink: Optional[Callable[[Request], None]] = None

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

    # ------------------------------------------------------- chunked prefill
    def supports_chunked_prefill(self) -> bool:
        """Chunked prefill streams prompt pieces straight into the paged
        pool; the architecture's whole prompt state must live in pooled
        global-attention KV (:func:`supports_chunked_prefill`)."""
        return supports_chunked_prefill(self.cfg)

    def claim_slot(self, req: Request) -> Optional[int]:
        """Reserve a free slot for ``req`` without prefilling anything: the
        entry to the PREFILLING state. The slot starts at context 0 with an
        all-null table row; pages come per chunk (:meth:`ensure_chunk_pages`).
        Raises :class:`PoisonError` for a request that can never fit."""
        self._check_fits_pool(req)
        for slot in self.free_slots():
            self.slot_req[slot] = req
            self.ctx_lens[slot] = 0
            self.page_tbl[slot, :] = 0
            return slot
        return None

    def attach_prefix(self, slot: int, prompt) -> int:
        """Prompt tokens of ``slot`` already in the KV pool from a cached
        prefix: always 0, since the port has no prefix cache yet (ROADMAP
        queue 1, item 8)."""
        return 0

    def ensure_chunk_pages(self, slot: int, upto_tokens: int,
                           write_from: Optional[int] = None) -> bool:
        """Grow ``slot``'s pages to cover prompt positions ``[0,
        upto_tokens)``. Returns False, with the pool unchanged, when it
        cannot serve them now. ``write_from`` is the chunk's first position:
        in the reference, shared prefix pages the chunk would write are
        copied first; without a prefix cache no page is ever shared, so no
        copy is needed (copy-on-write comes with ROADMAP queue 1, item 8)."""
        need = min(-(-int(upto_tokens) // self.tile), self.pages_per_slot)
        have = self.pool.count(slot)
        if have < need:
            got = self.pool.alloc(slot, need - have)
            if got is None:
                return False
            self.page_tbl[slot, have:need] = got
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
                "chunked prefill requires an all-'attn' architecture with rotary "
                "positions (see supports_chunked_prefill)"
            )
        if len(work) > pack_width:
            raise ValueError(f"{len(work)} chunks > pack width {pack_width}")
        N, C = pack_width, chunk_cap
        toks = np.zeros((N, C), dtype=np.int64)
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
        sched = None
        if self.attn_backend == "lean":
            sched = make_chunk_schedule(
                visible, self.cfg.n_kv_heads, self.tile, self.num_workers,
                max_len=self.pages_per_slot * self.tile, cache=self.sched_cache,
            )
        dev = self.device
        offs_t = torch.as_tensor(offs).to(dev)
        lens_t = torch.as_tensor(lens).to(dev)
        logits, self.cache = prefill_chunks(
            self.params, self.cfg, self.cache, torch.as_tensor(toks).to(dev), offs_t, lens_t,
            torch.as_tensor(tbls).to(dev), attn_fn=self._chunk_attn_fn(offs_t, lens_t, sched),
        )
        self.last_prefill_logits = logits
        next_tok = logits.argmax(dim=-1).to(torch.int32).cpu().numpy()
        n_tokens = int(lens.sum())
        self.stats.chunk_prefills += len(work)
        self.stats.prefill_tokens += n_tokens
        self._log(self.stats.tick_prefill_tokens, n_tokens)
        return next_tok

    def _chunk_attn_fn(self, offs: torch.Tensor, lens: torch.Tensor,
                       sched: Optional[LeanSchedule]) -> Optional[Callable]:
        """The chunk attention of the configured backend: lean -> K4 +
        merge, rows attending causally from ``offs`` through the schedule's
        runtime ``qstart``; fixed -> K8; ref -> None (the plain oracle)."""
        if self.attn_backend == "lean":
            n_kv = self.cfg.n_kv_heads
            seg_ctx = torch.clamp(offs + lens, min=1).to(torch.int32).repeat_interleave(n_kv)
            seg_qstart = offs.to(torch.int32).repeat_interleave(n_kv)

            def attn_fn(q, k_pool, v_pool, tbls, o):
                return lean_prefill_chunks(q, k_pool, v_pool, seg_ctx, seg_qstart, tbls, sched)

            return attn_fn
        if self.attn_backend == "fixed":
            return lambda q, k_pool, v_pool, tbls, o: flash_prefill_paged(
                q.contiguous(), k_pool, v_pool, tbls, o.to(torch.int32))
        return None

    def decode_token_width(self) -> int:
        """Most tokens one decode tick emits per slot: 1 (the reference's
        k+1 with speculative decode is ROADMAP queue 1, item 10). Tick
        composers charge it against their token budget."""
        return 1

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
        if self.preempt_sink is not None:
            self.preempt_sink(req)
        else:
            self.queue.insert(0, req)
        self.stats.preemptions += 1

    def preempt_slot(self, slot: int):
        """Public eviction hook for schedulers (breaking a page deadlock, a
        missed deadline): works for DECODING and PREFILLING occupants alike;
        a request evicted mid-prefill restarts its prompt on re-admission."""
        if self.slot_req[slot] is None:
            raise ValueError(f"slot {slot} is idle")
        self._preempt(slot)

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

    def decode_tick(self, exclude=None) -> Dict[int, int]:
        """One decode step over the active slots. Returns {uid: new_token}.

        ``exclude`` masks slots out of this tick: the scheduler passes its
        PREFILLING slots, whose pages hold a partial prompt that the step
        must neither read (their context is 0 for this call, so their
        segment is masked) nor write (their table rows are null for this
        call, so the token write lands in the null page). Their real tables
        and progress stay as they are."""
        exclude = set(exclude) if exclude else set()
        active = [s for s in range(self.max_batch) if self.slot_req[s] and s not in exclude]
        active = self._ensure_decode_pages(active)
        if not active:
            return {}
        ctx_np = self.ctx_lens.copy()
        ptbl_np = self.page_tbl
        if exclude:
            ptbl_np = self.page_tbl.copy()
            for s in exclude:
                ctx_np[s] = 0
                ptbl_np[s, :] = 0
        logits = self._decode_pass_main(ctx_np, ptbl_np)
        self.last_logits = logits
        next_all = logits.argmax(dim=-1).cpu().numpy()
        return self._emit_tokens(active, next_all)

    def _decode_pass_main(self, ctx_np, ptbl_np) -> torch.Tensor:
        """The fast-path decode step over the whole batch: one cached
        schedule, the model's decode step with paged attention on the
        configured backend -- lean: K2 (or K1 + merge); fixed: the pages
        gathered to dense, then K6 + merge_n with FlashDecoding's split
        factor; ref: the plain oracle. Updates the pools in place and
        returns the logits (B, V)."""
        sched = self._tick_schedule(ctx_np)
        self._record_schedule(sched)
        tokens = torch.as_tensor(self.next_tokens).to(self.device)
        ctx = torch.as_tensor(ctx_np, dtype=torch.int32).to(self.device)
        ptbl = torch.as_tensor(ptbl_np).to(self.device)
        n_kv = self.cfg.n_kv_heads
        attn_fn = None
        if self.attn_backend == "lean":
            fused = self.fused

            def attn_fn(q, k_pool, v_pool, ctx_visible):
                seg_ctx = ctx_visible.repeat_interleave(n_kv)
                return lean_decode_paged_from_schedule(
                    q, k_pool, v_pool, seg_ctx, ptbl, sched, fused=fused,
                )

        elif self.attn_backend == "fixed":
            num_splits = fixed_split_factor(
                int(sched.seg_len.max(initial=1)), sched.num_segments, self.tile,
                self.num_workers,
            )
            tile = self.tile

            def attn_fn(q, k_pool, v_pool, ctx_visible):
                seg_ctx = ctx_visible.repeat_interleave(n_kv)
                return flash_decode_from_lens(
                    q, paged_gather_kv(k_pool, ptbl), paged_gather_kv(v_pool, ptbl), seg_ctx,
                    num_splits=num_splits, tile=tile,
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
