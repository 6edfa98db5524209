"""Continuous-batching scheduler: chunked stream-K prefill + decode ticks
(port of ``repro.serving.scheduler``).

The :class:`~repro_torch.serving.engine.DecodeEngine` provides the
mechanisms -- a decode tick, a paged KV pool, blocking whole-prompt
admission and a packed chunked-prefill step. This module is the policy
layer that turns them into a server:

  * a request lifecycle ``QUEUED -> PREFILLING -> DECODING -> FINISHED``
    (preemption folds back to ``QUEUED`` for recompute-resume);
  * a token-budget tick composer: each :meth:`Scheduler.step` packs up to
    ``prefill_pack`` prompt chunks (each at most ``chunk_size`` tokens, all
    together at most ``token_budget`` minus the decode batch) beside the
    decode batch, so a long prompt streams into the pool a chunk per tick
    while every sequence already decoding keeps decoding;
  * admission policies (``fcfs`` | ``priority``) with a hard starvation
    bound: a request queued longer than ``starvation_bound`` steps outranks
    every younger one, FIFO among the starving;
  * streaming: ``on_token(uid, token, done)`` fires for every generated
    token, the first one sampled off the final prefill chunk included;
  * robustness: TTFT deadlines with requeue and backoff, ``cancel``,
    admission backoff under page pressure, ``max_preemptions``, and a
    page-deadlock breaker;
  * telemetry: TTFT, TPOT and queue wait observed in seconds into the
    histograms of the engine's
    :class:`~repro_torch.serving.engine.EngineStats` (which live in its
    metrics registry, beside this module's queue-depth, active-slot and
    pending gauges), and :meth:`Scheduler.telemetry`, a JSON snapshot;
    lifecycle transitions stream into the engine's tracer
    (``request_event`` / ``request_token``), so a traced run yields
    per-uid QUEUED -> PREFILLING -> DECODING -> FINISHED timelines;
  * SLO classes: ``submit(..., slo_class=...)`` charges a request's TTFT
    and TPOT to that class's error budget when the engine's perf watchdog
    declares it (:class:`~repro_torch.obs.watch.SLOConfig`).

Chunked prefill needs an architecture whose prompt state lives entirely in
the paged pool (``engine.supports_chunked_prefill()``); otherwise the
scheduler falls back to blocking admission with the same lifecycle.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.serving.engine import DecodeEngine, Request

__all__ = ["RequestState", "SchedulerConfig", "ScheduledRequest", "SchedulerStats", "Scheduler"]


class RequestState(Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    FINISHED = "finished"
    FAILED = "failed"          # poisoned: deadline/preemption budget spent
    CANCELLED = "cancelled"    # caller withdrew the request


@dataclass
class SchedulerConfig:
    """Tick-composition and policy knobs (the reference's, field for field).

    ``token_budget`` is the per-tick token target: decode tokens (one per
    DECODING slot) always run; prefill chunks fill the remainder.
    ``prefill_pack`` bounds how many requests prefill together in one
    packed step and is the pack's fixed width.
    """

    chunk_size: int = 32
    prefill_pack: int = 2
    token_budget: int = 64
    chunked: Optional[bool] = None        # None -> auto-detect from engine
    policy: str = "fcfs"                  # 'fcfs' | 'priority'
    starvation_bound: int = 64            # scheduler steps
    # TTFT deadline in scheduler steps: a request still without its first
    # token this many steps after (re-)queueing is requeued with backoff,
    # and poison-failed after ``max_deadline_misses`` expiries
    deadline_steps: Optional[int] = None
    max_deadline_misses: int = 3
    # bounded exponential backoff for failed admissions (pool pressure):
    # 0 keeps head-of-line blocking; > 0 delays the failed request
    # ``min(cap, base << (failures-1))`` steps and lets younger ones pass
    retry_backoff: int = 0
    retry_backoff_cap: int = 64
    # a request preempted more than this many times is poison-failed
    max_preemptions: Optional[int] = None

    def __post_init__(self):
        if self.policy not in ("fcfs", "priority"):
            raise ValueError(f"unknown policy {self.policy!r}")
        if self.chunk_size <= 0 or self.prefill_pack <= 0:
            raise ValueError("chunk_size and prefill_pack must be positive")
        if self.starvation_bound <= 0:
            raise ValueError("starvation_bound must be positive")
        if self.deadline_steps is not None and self.deadline_steps <= 0:
            raise ValueError("deadline_steps must be positive (or None)")
        if self.max_deadline_misses < 1:
            raise ValueError("max_deadline_misses must be >= 1")
        if self.retry_backoff < 0 or self.retry_backoff_cap < 1:
            raise ValueError("retry_backoff >= 0, retry_backoff_cap >= 1")
        if self.max_preemptions is not None and self.max_preemptions < 1:
            raise ValueError("max_preemptions must be >= 1 (or None)")


@dataclass
class ScheduledRequest:
    """A submitted request plus its lifecycle state: the handle
    :meth:`Scheduler.submit` returns (tokens accumulate in ``generated``)."""

    req: Request
    priority: int = 0
    on_token: Optional[Callable[[int, int, bool], None]] = None
    slo_class: str = "default"            # SLO budget class (watchdog)
    state: RequestState = RequestState.QUEUED
    slot: int = -1
    prefill_done: int = 0                 # prompt tokens already chunked in
    arrival_seq: int = 0                  # submission order (FCFS tiebreak)
    arrival_step: int = 0
    arrival_time: float = 0.0
    enqueue_time: float = 0.0             # last (re-)queue time: wait metric
    admit_step: int = -1
    first_token_time: float = -1.0
    last_token_time: float = -1.0
    preemptions: int = 0
    deadline_at: int = -1                 # step the TTFT deadline expires
    deadline_window: int = -1             # the deadline's length in steps
    deadline_misses: int = 0
    not_before: int = 0                   # admission backoff: skip until
    admit_failures: int = 0               # consecutive failed admissions
    error: Optional[str] = None           # set when state is FAILED

    @property
    def uid(self) -> int:
        return self.req.uid

    @property
    def done(self) -> bool:
        return self.state is RequestState.FINISHED

    @property
    def generated(self) -> List[int]:
        return self.req.generated

    def queue_age(self, now_step: int) -> int:
        return now_step - self.arrival_step


@dataclass
class SchedulerStats:
    steps: int = 0
    admitted: int = 0
    finished: int = 0
    chunks: int = 0
    stalled_chunk_ticks: int = 0          # ticks where page pressure held
    deadlock_preemptions: int = 0         # chunks backed out entirely
    deadline_expirations: int = 0         # TTFT deadline misses (each one)
    cancellations: int = 0                # caller-cancelled requests
    poisoned: int = 0                     # requests poison-failed
    admit_backoffs: int = 0               # failed admissions that backed off
    queue_depth: List[int] = field(default_factory=list)
    # admission audit trail for the starvation bound: one record per
    # admission (step, uid, age, starving requests passed over)
    admissions: List[dict] = field(default_factory=list)

    LOG_CAP = 4096

    def log_depth(self, d: int):
        self.queue_depth.append(d)
        if len(self.queue_depth) > self.LOG_CAP:
            del self.queue_depth[: -self.LOG_CAP]


class Scheduler:
    """Continuous-batching policy layer over a :class:`DecodeEngine`."""

    def __init__(self, engine: DecodeEngine, config: Optional[SchedulerConfig] = None):
        self.engine = engine
        self.config = config or SchedulerConfig()
        if self.config.chunked is None:
            self.chunked = engine.supports_chunked_prefill()
        else:
            self.chunked = self.config.chunked
            if self.chunked and not engine.supports_chunked_prefill():
                raise ValueError(
                    "chunked prefill requires an all-'attn' architecture "
                    "(engine.supports_chunked_prefill() is False)"
                )
        self.queue: List[ScheduledRequest] = []
        self.requests: Dict[int, ScheduledRequest] = {}
        self._slot_sr: Dict[int, ScheduledRequest] = {}
        self._next_uid = 0
        self._arrival_seq = 0
        self.stats = SchedulerStats()
        # engine preemptions (pool pressure mid-decode) fold back into this
        # queue, keeping their arrival so that aging continues
        engine.preempt_sink = self._on_preempt
        # observability: lifecycle events into the engine's tracer (a
        # NULL_TRACER ignores them), gauges into its metrics registry; the
        # gauges read the queue and the slot map (both only ever mutated in
        # place), not the scheduler, so that the registry keeps neither the
        # scheduler nor its engine alive
        self.tracer = engine.tracer
        queue, slots = self.queue, self._slot_sr
        engine.metrics.gauge_fn("scheduler_queue_depth", lambda: len(queue),
                                help="requests waiting for admission")
        engine.metrics.gauge_fn("scheduler_active_slots", lambda: len(slots),
                                help="slots holding a PREFILLING or DECODING request")
        engine.metrics.gauge_fn("scheduler_pending", lambda: len(queue) + len(slots),
                                help="queued + in-flight requests")

    # ---------------------------------------------------------------- submit
    def submit(
        self,
        prompt,
        max_new_tokens: int,
        *,
        priority: int = 0,
        on_token: Optional[Callable[[int, int, bool], None]] = None,
        uid: Optional[int] = None,
        deadline_steps: Optional[int] = None,
        slo_class: str = "default",
    ) -> ScheduledRequest:
        """Enqueue a request; returns its handle at once. Tokens stream
        through ``on_token(uid, token, done)`` as :meth:`step` produces them
        and accumulate in ``handle.generated``. ``deadline_steps`` overrides
        the configured TTFT deadline for this request. ``slo_class`` names
        the request's SLO budget class: when the engine's perf watchdog
        declares it, the request's TTFT and TPOT are charged to its error
        budget."""
        prompt = np.asarray(prompt, dtype=np.int32)
        if prompt.size == 0:
            raise ValueError("empty prompt (nothing to prefill)")
        if uid is None:
            uid = self._next_uid
        self._next_uid = max(self._next_uid, uid + 1)
        if uid in self.requests:
            raise ValueError(f"duplicate request uid {uid}")
        now = time.perf_counter()
        sr = ScheduledRequest(
            req=Request(uid=uid, prompt=prompt, max_new_tokens=max_new_tokens),
            priority=priority,
            on_token=on_token,
            slo_class=slo_class,
            arrival_seq=self._arrival_seq,
            arrival_step=self.stats.steps,
            arrival_time=now,
            enqueue_time=now,
        )
        self._arrival_seq += 1
        ttft_deadline = deadline_steps if deadline_steps is not None else self.config.deadline_steps
        if ttft_deadline is not None:
            sr.deadline_window = int(ttft_deadline)
            sr.deadline_at = sr.arrival_step + sr.deadline_window
        self.requests[uid] = sr
        self.queue.append(sr)
        self.tracer.request_event(uid, "QUEUED", prompt_tokens=int(prompt.size),
                                  priority=priority)
        return sr

    def _on_preempt(self, req: Request):
        sr = self.requests.get(req.uid)
        if sr is None or sr.req is not req:
            # a request admitted through the raw engine API on the same
            # engine is not ours: keep the engine's own requeue semantics
            self.engine.queue.insert(0, req)
            return
        if sr.slot >= 0:
            self._slot_sr.pop(sr.slot, None)
        sr.state = RequestState.QUEUED
        sr.slot = -1
        sr.prefill_done = 0           # recompute-resume restarts the prompt
        sr.preemptions += 1
        cfg = self.config
        if cfg.max_preemptions is not None and sr.preemptions > cfg.max_preemptions:
            # a request thrashed off its slot this often would starve
            # everyone else with its recompute-resume work
            self._fail(sr, f"preempted {sr.preemptions}x (max_preemptions={cfg.max_preemptions})")
            return
        sr.enqueue_time = time.perf_counter()
        self.queue.insert(0, sr)
        # (the engine records PREEMPTED for this uid once this returns)
        self.tracer.request_event(sr.uid, "QUEUED", requeue=True, preemptions=sr.preemptions)

    # ---------------------------------------------------------------- policy
    def _starving(self, sr: ScheduledRequest) -> bool:
        return sr.queue_age(self.stats.steps) > self.config.starvation_bound

    def _order_queue(self):
        """Admission order. FCFS: arrival. Priority: higher ``priority``
        first, except that requests older than the starvation bound outrank
        everything, FIFO among themselves. The sort is stable."""
        if self.config.policy == "fcfs":
            self.queue.sort(key=lambda sr: sr.arrival_seq)
        else:
            self.queue.sort(
                key=lambda sr: (
                    0 if self._starving(sr) else 1,
                    -sr.priority if not self._starving(sr) else 0,
                    sr.arrival_seq,
                )
            )

    # ------------------------------------------------------------- admission
    def _record_admission(self, sr: ScheduledRequest):
        # an audit, not logic: admission always takes the ordered queue's
        # head, so this stays 0 unless blocked heads start being skipped
        passed_over = sum(
            1 for other in self.queue if self._starving(other) and not self._starving(sr)
        )
        self.stats.admitted += 1
        sr.admit_step = self.stats.steps
        self.stats.admissions.append({
            "step": self.stats.steps,
            "uid": sr.uid,
            "age": sr.queue_age(self.stats.steps),
            "starving_passed_over": passed_over,
        })
        if len(self.stats.admissions) > SchedulerStats.LOG_CAP:
            del self.stats.admissions[: -SchedulerStats.LOG_CAP]
        # wait since the LAST enqueue: a preempted request's residency is
        # not queue wait
        self.engine.stats.queue_wait.observe(time.perf_counter() - sr.enqueue_time)
        self.tracer.request_event(sr.uid, "PREFILLING", slot=sr.slot,
                                  prefix_matched=sr.prefill_done)

    def _admit_backoff(self, sr: ScheduledRequest):
        """A failed admission (pool pressure): with ``retry_backoff`` set,
        delay this request's next attempt exponentially so that younger
        requests can admit past it; without it, head-of-line blocking."""
        cfg = self.config
        if cfg.retry_backoff <= 0:
            return
        sr.admit_failures += 1
        delay = min(cfg.retry_backoff_cap, cfg.retry_backoff << (sr.admit_failures - 1))
        sr.not_before = self.stats.steps + delay
        self.stats.admit_backoffs += 1

    def _admit(self):
        if not self.queue:
            return
        self._order_queue()
        i = 0
        while i < len(self.queue) and self.engine.free_slots():
            sr = self.queue[i]
            if sr.not_before > self.stats.steps:
                i += 1                    # backing off; try the next request
                continue
            if self.chunked:
                slot = self.engine.claim_slot(sr.req)
                if slot is None:
                    self._admit_backoff(sr)
                    break
                sr.state = RequestState.PREFILLING
                sr.prefill_done = self.engine.attach_prefix(slot, sr.req.prompt)
            else:
                slot = self.engine.free_slots()[0]
                if not self.engine.admit_blocking(sr.req, slot):
                    # pool exhausted: capacity pressure is global, so stop
                    # scanning either way
                    self._admit_backoff(sr)
                    break
            self.queue.pop(i)
            sr.not_before = 0
            sr.admit_failures = 0
            sr.slot = slot
            self._slot_sr[slot] = sr
            self._record_admission(sr)
            if not self.chunked:
                # blocking admission already sampled the first token
                sr.state = RequestState.DECODING
                self.tracer.request_event(sr.uid, "DECODING", slot=slot)
                self._emit_first_token(sr)

    # --------------------------------------------------------------- prefill
    def _prefill_slots(self) -> List[ScheduledRequest]:
        srs = [sr for sr in self._slot_sr.values() if sr.state is RequestState.PREFILLING]
        srs.sort(key=lambda sr: sr.arrival_seq)     # oldest first
        return srs

    def _decoding_slots(self) -> List[int]:
        return [s for s, sr in self._slot_sr.items() if sr.state is RequestState.DECODING]

    def _compose_chunks(self) -> List[tuple]:
        """This tick's prefill chunks under the token budget:
        ``[(sr, slot, chunk_tokens, off), ...]``, at most ``prefill_pack``."""
        cfg = self.config
        budget = max(
            0,
            cfg.token_budget - len(self._decoding_slots()) * self.engine.decode_token_width(),
        )
        if budget == 0:
            # liveness floor: a saturated decode batch must not starve
            # prefill forever -- grant one token of prefill progress
            budget = 1
        work = []
        pressure = False
        for sr in self._prefill_slots():
            if len(work) >= cfg.prefill_pack or budget <= 0:
                break
            plen = len(sr.req.prompt)
            clen = min(cfg.chunk_size, plen - sr.prefill_done, budget)
            if clen <= 0:
                continue
            if not self.engine.ensure_chunk_pages(
                sr.slot, sr.prefill_done + clen, write_from=sr.prefill_done
            ):
                pressure = True
                continue                  # pool pressure; retry next tick
            chunk = sr.req.prompt[sr.prefill_done: sr.prefill_done + clen]
            work.append((sr, sr.slot, chunk, sr.prefill_done))
            budget -= clen
        if pressure and not work:
            self.stats.stalled_chunk_ticks += 1
            self._break_page_deadlock()
        return work

    def _break_page_deadlock(self):
        """Nothing could prefill for want of pages. If decode runs, its
        completions will free pages: wait. If not, half-prefilled requests
        wedge the pool: evict the youngest PREFILLING slot so the oldest can
        progress (recompute-resume on re-admission)."""
        if self._decoding_slots():
            return
        srs = self._prefill_slots()
        if len(srs) < 2:
            return                        # a single occupant always fits
        self.engine.preempt_slot(srs[-1].slot)    # routes to _on_preempt
        self.stats.deadlock_preemptions += 1

    def _run_prefill(self):
        work = self._compose_chunks()
        if not work:
            return
        first_toks = self.engine.prefill_chunks_tick(
            [(slot, chunk, off) for _, slot, chunk, off in work],
            pack_width=self.config.prefill_pack,
            chunk_cap=self.config.chunk_size,
        )
        self.stats.chunks += len(work)
        for i, (sr, slot, chunk, off) in enumerate(work):
            sr.prefill_done = off + len(chunk)
            if sr.prefill_done == len(sr.req.prompt):
                # prompt complete: this row's sampled token is the first
                # token, and the request decodes from the next tick
                nxt = int(first_toks[i])
                sr.req.generated.append(nxt)
                self.engine.next_tokens[slot, 0] = nxt
                self.engine.ctx_lens[slot] = len(sr.req.prompt)
                sr.state = RequestState.DECODING
                self.tracer.request_event(sr.uid, "DECODING", slot=slot)
                self._emit_first_token(sr)

    # ---------------------------------------------------------------- tokens
    def _emit_first_token(self, sr: ScheduledRequest):
        now = time.perf_counter()
        if sr.first_token_time < 0:
            # a preempted and resumed request comes here again; TTFT is the
            # time to its first first token only
            sr.first_token_time = now
            ttft = now - sr.arrival_time
            self.engine.stats.ttft.observe(ttft)
            if self.engine.watchdog is not None:
                self.engine.watchdog.observe_latency(sr.slo_class, "ttft", ttft)
            self.tracer.request_event(sr.uid, "FIRST_TOKEN")
        sr.last_token_time = now
        self.tracer.request_token(sr.uid)
        tok = sr.req.generated[-1]
        done = sr.req.done
        if sr.on_token:
            sr.on_token(sr.uid, tok, done)
        if done:
            self._finish(sr, free_engine_slot=True)

    def _emit_decode_token(self, sr: ScheduledRequest, tok: int, done: bool):
        now = time.perf_counter()
        if sr.last_token_time >= 0:
            tpot = now - sr.last_token_time
            self.engine.stats.tpot.observe(tpot)
            if self.engine.watchdog is not None:
                self.engine.watchdog.observe_latency(sr.slo_class, "tpot", tpot)
        sr.last_token_time = now
        self.tracer.request_token(sr.uid)
        if sr.on_token:
            sr.on_token(sr.uid, tok, done)

    def _fail(self, sr: ScheduledRequest, msg: str):
        """Poison-fail a request: terminal FAILED, never retried. The
        caller has detached it from the queue and its slot first."""
        if sr.slot >= 0:
            self._slot_sr.pop(sr.slot, None)
            sr.slot = -1
        sr.state = RequestState.FAILED
        sr.error = msg
        self.stats.poisoned += 1
        self.tracer.request_event(sr.uid, "FAILED", error=msg)
        self.requests.pop(sr.uid, None)

    def cancel(self, uid: int) -> bool:
        """Cancel a request wherever it is: QUEUED leaves the queue,
        PREFILLING/DECODING frees its slot and pages. Returns False for an
        unknown or already terminal uid."""
        sr = self.requests.get(uid)
        if sr is None:
            return False
        if sr in self.queue:
            self.queue.remove(sr)
        if sr.slot >= 0:
            slot = sr.slot
            self._slot_sr.pop(slot, None)
            sr.slot = -1
            self.engine.release_slot(slot)
        sr.state = RequestState.CANCELLED
        self.stats.cancellations += 1
        self.tracer.request_event(uid, "CANCELLED")
        self.requests.pop(uid, None)
        return True

    def _check_deadlines(self):
        """TTFT deadline sweep, before admission each step: a request past
        its deadline without a first token is pulled back (a PREFILLING one
        frees its slot and pages) and requeued with exponential backoff and
        a fresh window; after ``max_deadline_misses`` it is poison-failed."""
        cfg = self.config
        now = self.stats.steps
        expired = [
            sr for sr in list(self.requests.values())
            if sr.deadline_at >= 0 and now > sr.deadline_at and sr.first_token_time < 0
            and sr.state in (RequestState.QUEUED, RequestState.PREFILLING)
        ]
        for sr in expired:
            sr.deadline_misses += 1
            self.stats.deadline_expirations += 1
            if sr.state is RequestState.PREFILLING:
                # through _on_preempt: QUEUED at the front (and the
                # preemption budget check, which may fail it)
                self.engine.preempt_slot(sr.slot)
                if sr.state is RequestState.FAILED:
                    continue
            if sr.deadline_misses >= cfg.max_deadline_misses:
                if sr in self.queue:
                    self.queue.remove(sr)
                self._fail(sr, f"TTFT deadline ({sr.deadline_window} steps) "
                               f"missed {sr.deadline_misses}x")
                continue
            base = max(1, cfg.retry_backoff)
            delay = min(cfg.retry_backoff_cap, base << (sr.deadline_misses - 1))
            sr.not_before = now + delay
            sr.deadline_at = sr.not_before + max(1, sr.deadline_window)

    def _finish(self, sr: ScheduledRequest, free_engine_slot: bool = False):
        slot = sr.slot
        if free_engine_slot and slot >= 0:
            # the engine frees slots itself after decode ticks; this covers
            # requests whose budget the first token already spent
            self.engine.release_slot(slot)
        self._slot_sr.pop(slot, None)
        sr.slot = -1
        sr.state = RequestState.FINISHED
        self.stats.finished += 1
        self.tracer.request_event(sr.uid, "FINISHED", tokens=len(sr.req.generated))
        # the handle stays with the caller; the scheduler forgets it, so
        # server state stays bounded and the uid becomes reusable
        self.requests.pop(sr.uid, None)

    # ------------------------------------------------------------------ step
    def step(self) -> Dict[int, int]:
        """One scheduler tick: admit, pack prefill chunks, decode. Returns
        {uid: token} for decode-produced tokens -- token lists with
        speculative decode on (first tokens stream through the callbacks
        and ``handle.generated``)."""
        self.stats.steps += 1
        self.stats.log_depth(len(self.queue))
        self._check_deadlines()
        self._admit()
        if self.chunked:
            self._run_prefill()
        prefilling = [s for s, sr in self._slot_sr.items() if sr.state is RequestState.PREFILLING]
        out = self.engine.decode_tick(exclude=prefilling)
        for uid, tok in out.items():
            sr = self.requests[uid]
            # the engine frees the slot when the budget is spent or the
            # context cap is hit: either way the stream owes a done=True
            finished = self.engine.slot_req[sr.slot] is not sr.req
            # a speculative tick emits a list of tokens per slot: streamed
            # one at a time, done only on the last
            toks = tok if isinstance(tok, list) else [tok]
            for j, t in enumerate(toks):
                self._emit_decode_token(sr, t, done=finished and j == len(toks) - 1)
            if finished:
                self._finish(sr)
        return out

    # -------------------------------------------------------------- draining
    @property
    def pending(self) -> int:
        return len(self.queue) + len(self._slot_sr)

    def run_to_completion(self, max_steps: int = 10_000) -> SchedulerStats:
        while self.pending and self.stats.steps < max_steps:
            self.step()
        return self.stats

    def telemetry(self) -> dict:
        """JSON-friendly snapshot: scheduler counters, engine counters and
        latency histograms, and with a perf watchdog its fire counts and
        SLO budgets."""
        es = self.engine.stats
        return {
            "steps": self.stats.steps,
            "admitted": self.stats.admitted,
            "finished": self.stats.finished,
            "chunks": self.stats.chunks,
            "chunked": self.chunked,
            "policy": self.config.policy,
            "stalled_chunk_ticks": self.stats.stalled_chunk_ticks,
            "deadlock_preemptions": self.stats.deadlock_preemptions,
            "deadline_expirations": self.stats.deadline_expirations,
            "cancellations": self.stats.cancellations,
            "poisoned": self.stats.poisoned,
            "admit_backoffs": self.stats.admit_backoffs,
            "queue_depth_max": max(self.stats.queue_depth, default=0),
            "prefill_tokens": es.prefill_tokens,
            "tokens_generated": es.tokens_generated,
            "prefix_matched_tokens": es.prefix_matched_tokens,
            "prefix_attach_count": es.prefix_attach_count,
            "cow_copies": es.cow_copies,
            "cascade_ticks": es.cascade_ticks,
            "cascade_fused_ticks": es.cascade_fused_ticks,
            "cascade_grouped_passes": es.cascade_grouped_passes,
            "cascade_retraces": es.cascade_retraces,
            "cascade_stability_skips": es.cascade_stability_skips,
            "cascade_levels_max": es.cascade_levels_max,
            "prefix_cache": dict(es.prefix_cache),
            "spec_ticks": es.spec_ticks,
            "spec_draft_tokens": es.spec_draft_tokens,
            "spec_accepted_tokens": es.spec_accepted_tokens,
            "spec_accept_rate": es.spec_accepted_tokens / max(1, es.spec_draft_tokens),
            # the guards' and faults' counters (0 on an engine without guards or
            # an injector)
            "nan_ticks": es.nan_ticks,
            "degrade_escalations": es.degrade_escalations,
            "degrade_heals": es.degrade_heals,
            "poisoned_slots": es.poisoned_slots,
            "donation_aborts": es.donation_aborts,
            "audits_run": es.audits_run,
            "audit_failures": es.audit_failures,
            "audit_repairs": es.audit_repairs,
            "degraded": dict(es.degraded),
            "faults": dict(es.faults),
            **es.latency_dict(),
            **self._watchdog_telemetry(),
        }

    def _watchdog_telemetry(self) -> dict:
        """The watchdog's fire counts and per-class SLO budgets, when the
        engine has one (empty otherwise)."""
        wd = self.engine.watchdog
        if wd is None:
            return {}
        return {
            "watchdog": {"ticks": wd.ticks, "total_fires": wd.total_fires,
                         "fire_counts": wd.fire_counts()},
            "slo": {k: b.as_dict() for k, b in wd.budgets.items()},
        }
