"""The port's continuous-batching ``Scheduler`` against the JAX package's on
the smoke configuration: same weights (``params_from_numpy``), same prompts,
``SchedulerConfig(chunk_size=8, prefill_pack=2, token_budget=16)`` as
tests/test_scheduler.py:54-68 uses.

Oracle: the ``ref`` backend with blocking admission (the raw engine's own
tick loop). The reference's ``lean`` chunked stream is not an oracle: it
leaves the oracle at a near-tie (``test_lean_chunked_question``), and so
does its ``fixed`` stream.

Logit tolerances: the kernels (K2, K4, K6, K8) keep softmax probabilities
in float32 where the plain oracle rounds them to bf16 before the PV
product, so a kernel backend's logits sit up to ``BACKEND_TOL`` = 2**-5 from
the oracle's (two bf16 steps at the logits' scale, |logit| in [2, 4)). The
port and the JAX package on one backend differ in float32 summation order
and in where bf16 rounds: the JAX engine jits its steps, and XLA's fusion
moves logits by up to 0.0076 against eager execution (the port equals eager
JAX bit for bit; measured on the 29-token prompt of the reference's seed,
whose first token is a near-tie). ``BF16`` = one bf16 step, as
tests/test_torch_models.py.

Exact token streams therefore need prompts with a margin: ``PROMPT_SEED``'s
prompts keep every top-2 gap of the JAX oracle above 2**-4 (checked by
``test_oracle_margin``). The lean question runs on the reference's own
prompts (seed 0).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro.serving.config import EngineConfig as JConfig, PagedConfig as JPaged  # noqa: E402
from repro.serving.engine import DecodeEngine as JEngine, Request as JRequest  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402
from repro_torch.serving.config import EngineConfig, PagedConfig  # noqa: E402
from repro_torch.serving.engine import DecodeEngine, PoisonError, Request  # noqa: E402

BF16 = dict(rtol=2**-7, atol=2**-7)
BACKEND_TOL = 2**-5
SCHED = dict(chunk_size=8, prefill_pack=2, token_budget=16)
PROMPT_SEED = 25


class _JaxRecorder(JEngine):
    """The JAX engine, recording each request's decode logits rows, and
    under blocking admission its prefill row (``first``)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.rows, self.first = {}, {}
        self._row = None

    def _run_prompt_prefill(self, prompt):
        logits, cache1 = super()._run_prompt_prefill(prompt)
        self._row = np.asarray(logits[0])
        return logits, cache1

    def _admit_blocking_inner(self, req, slot):
        ok = super()._admit_blocking_inner(req, slot)
        if ok:
            self.first.setdefault(req.uid, self._row)
        return ok

    def _decode_pass_main(self, active, ctx_np, ptbl_np):
        logits = super()._decode_pass_main(active, ctx_np, ptbl_np)
        lg = np.asarray(logits)
        for s in active:
            self.rows.setdefault(self.slot_req[s].uid, []).append(lg[s])
        return logits


class _PortRecorder(DecodeEngine):
    """The port's engine, recording each request's decode logits rows and
    its own greedy picks; with ``forced`` ({uid: tokens}) it feeds those
    tokens instead of its own (teacher forcing)."""

    def __init__(self, *a, forced=None, **kw):
        super().__init__(*a, **kw)
        self.rows, self.own, self.first, self.forced = {}, {}, {}, forced
        self._row = None

    def _run_prompt_prefill(self, prompt):
        logits, cache1 = super()._run_prompt_prefill(prompt)
        self._row = logits[0].float().numpy()
        return logits, cache1

    def admit_blocking(self, req, slot):
        ok = super().admit_blocking(req, slot)
        if ok:
            self.first.setdefault(req.uid, self._row)
        return ok

    def _emit_tokens(self, active, next_all):
        next_all = next_all.copy()
        for s in active:
            req = self.slot_req[s]
            self.rows.setdefault(req.uid, []).append(self.last_logits[s].float().numpy())
            self.own.setdefault(req.uid, []).append(int(next_all[s]))
            if self.forced is not None:
                next_all[s] = self.forced[req.uid][len(req.generated)]
        return super()._emit_tokens(active, next_all)

    def prefill_chunks_tick(self, work, pack_width, chunk_cap):
        toks = super().prefill_chunks_tick(work, pack_width, chunk_cap)
        for i, (slot, chunk, off) in enumerate(work):
            req = self.slot_req[slot]
            if off + len(chunk) == len(req.prompt):
                self.first.setdefault(req.uid, self.last_prefill_logits[i].float().numpy())
                self.own.setdefault(req.uid, []).append(int(toks[i]))
                if self.forced is not None:
                    toks[i] = self.forced[req.uid][0]
        return toks


@pytest.fixture(scope="module")
def model():
    cfg_j = jax_smoke("mistral-nemo-12b")
    cfg = get_smoke_config("mistral-nemo-12b")
    pj = jinit(jax.random.PRNGKey(0), cfg_j)
    return cfg_j, cfg, pj, params_from_numpy(jax.tree.map(np.asarray, pj), cfg, device="cpu")


def _engine(model, side, backend="ref", max_batch=2, cache_len=64, num_pages=None,
            page_size=16, recorder=False, **kw):
    cfg_j, cfg, pj, pt = model
    common = dict(attn_backend=backend, max_batch=max_batch, cache_len=cache_len, num_workers=8)
    if side == "jax":
        cls = _JaxRecorder if recorder else JEngine
        return cls(cfg_j, pj, JConfig(
            paged=JPaged(enabled=True, page_size=page_size, num_pages=num_pages), **common))
    cls = _PortRecorder if recorder else DecodeEngine
    return cls(cfg, pt, EngineConfig(
        paged=PagedConfig(enabled=True, page_size=page_size, num_pages=num_pages), **common),
        device="cpu", **kw)


def _mod(side):
    return jsched if side == "jax" else tsched


def _prompts(vocab, n=4, seed=0, base=8, step=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, base + step * i) for i in range(n)]


def _run(model, side, backend, chunked, prompts, max_new=6, sched_kw=None, **eng_kw):
    eng = _engine(model, side, backend, **eng_kw)
    m = _mod(side)
    sch = m.Scheduler(eng, m.SchedulerConfig(chunked=chunked, **(sched_kw or SCHED)))
    streams = {}

    def cb(uid, tok, done):
        streams.setdefault(uid, []).append((tok, done))

    handles = [sch.submit(p, max_new, on_token=cb, uid=i) for i, p in enumerate(prompts)]
    sch.run_to_completion(max_steps=400)
    return sch, handles, streams


def _oracle(model, side, prompts, max_new=6):
    """The blocking-admission oracle: the raw engine's own tick loop on
    the ref backend. Returns its streams and each request's logits rows,
    indexed by token (the prefill row, then the decode rows)."""
    eng = _engine(model, side, "ref", recorder=True)
    R = JRequest if side == "jax" else Request
    reqs = [R(uid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion(max_ticks=200)
    return [tuple(r.generated) for r in reqs], {
        r.uid: [eng.first[r.uid]] + eng.rows[r.uid] for r in reqs}


def _jax_chunked(model, backend, prompts):
    eng = _engine(model, "jax", backend, recorder=True)
    sch = jsched.Scheduler(eng, jsched.SchedulerConfig(chunked=True, **SCHED))
    hs = [sch.submit(p, 6, uid=i) for i, p in enumerate(prompts)]
    sch.run_to_completion(max_steps=400)
    return [tuple(h.generated) for h in hs], eng.rows, sch.stats


@pytest.fixture(scope="module")
def runs(model):
    """The JAX runs the parity tests read, made once, on ``PROMPT_SEED``'s
    prompts: the oracle and the ``ref`` and ``fixed`` chunked schedulers.
    (The JAX ``lean`` scheduler runs once, in the lean question: it is the
    slowest under Pallas interpret.)"""
    prompts = _prompts(model[0].vocab_size, seed=PROMPT_SEED)
    out = {"prompts": prompts, "oracle": _oracle(model, "jax", prompts)}
    for backend in ("ref", "fixed"):
        out[backend] = _jax_chunked(model, backend, prompts)
    return out


def _top2_gap(row) -> float:
    top = np.sort(row)
    return float(top[-1] - top[-2])


def test_oracle_margin(runs):
    """The JAX oracle's greedy picks on ``PROMPT_SEED``'s prompts all win by
    more than 2**-4, so every backend within ``BACKEND_TOL`` must pick
    alike."""
    gaps = [_top2_gap(r) for rows in runs["oracle"][1].values() for r in rows]
    assert len(gaps) == 4 * 6 and min(gaps) > 2**-4, min(gaps)


def _divergence(a, b):
    return next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)


def test_oracle_and_ref_chunked_match_jax(model, runs):
    """The port's blocking oracle equals the JAX one, and the port's ``ref``
    chunked scheduler equals both and the JAX ``ref`` chunked scheduler,
    token for token, with the same number of chunk steps."""
    prompts = runs["prompts"]
    oracle, _ = _oracle(model, "port", prompts)
    assert oracle == runs["oracle"][0]
    sch, handles, streams = _run(model, "port", "ref", True, prompts)
    got = [tuple(h.generated) for h in handles]
    assert got == runs["ref"][0] == oracle
    assert sch.stats.chunks == runs["ref"][2].chunks
    assert sch.stats.steps == runs["ref"][2].steps
    for h in handles:
        assert [t for t, _ in streams[h.uid]] == h.generated
        assert [d for _, d in streams[h.uid]] == [False] * 5 + [True]


@pytest.mark.parametrize("backend", ["fixed", "lean"])
def test_kernel_backends_chunked_match_jax_and_oracle(model, runs, backend):
    """``fixed`` (K8 chunks, K6 decode on the gathered pages) and ``lean``
    (K4 chunks, K2 decode): with the prompts' margin, streams equal to the
    oracle's, with the JAX scheduler's chunk and step counts. ``fixed`` is
    also held to the JAX ``fixed`` scheduler: equal streams and each decode
    row within one bf16 step of JAX's (``lean``'s rows are held to JAX's in
    ``test_lean_chunked_question``)."""
    prompts = runs["prompts"]
    eng = _engine(model, "port", backend, recorder=True)
    sch = tsched.Scheduler(eng, tsched.SchedulerConfig(chunked=True, **SCHED))
    hs = [sch.submit(p, 6, uid=i) for i, p in enumerate(prompts)]
    sch.run_to_completion(max_steps=400)
    got = [tuple(h.generated) for h in hs]
    assert got == runs["oracle"][0]
    jax_stats = runs["ref"][2]
    assert sch.stats.chunks == jax_stats.chunks and sch.stats.steps == jax_stats.steps
    if backend == "fixed":
        jax_tokens, jax_rows, _ = runs["fixed"]
        assert got == jax_tokens
        for uid, rows in eng.rows.items():
            np.testing.assert_allclose(np.stack(rows), np.stack(jax_rows[uid]), **BF16)
    eng.pool.check()
    assert eng.pool.num_allocated == 0


def _assert_near_ties(streams, rows, oracle, what):
    """Where a kernel-backend stream leaves the oracle, the two were fed the
    same tokens up to that token, so their logits rows there compare: the
    oracle's top-2 gap must be below ``BACKEND_TOL`` and the backend's row
    within ``BACKEND_TOL`` of the oracle's. ``rows`` are decode rows (row
    ``k - 1`` behind token ``k``). Returns the gaps found."""
    oracle_tokens, oracle_rows = oracle
    gaps = []
    for uid, (a, b) in enumerate(zip(streams, oracle_tokens)):
        k = _divergence(a, b)
        if k is None:
            continue
        assert k > 0, f"{what}: request {uid} differs at its first token"
        orow, brow = oracle_rows[uid][k], rows[uid][k - 1]
        gap = _top2_gap(orow)
        print(f"{what}: request {uid} leaves the oracle at token {k} ({a} vs {b}): "
              f"oracle top-2 gap {gap:.4g} at logit {orow.max():.4g}; max |row - oracle "
              f"row| {np.abs(brow - orow).max():.4g}")
        assert gap < BACKEND_TOL, f"{what}: request {uid} diverges at a gap of {gap}: a fault"
        np.testing.assert_allclose(brow, orow, rtol=0, atol=BACKEND_TOL)
        gaps.append(gap)
    return gaps


def test_lean_chunked_question(model):
    """Is the reference's ``lean`` chunked divergence from the oracle
    (tests/test_scheduler.py::test_chunked_token_identical_to_blocking_oracle,
    on that test's prompts) a near-tie or a fault? Near-tie: where the JAX
    stream leaves the oracle, the oracle's top-2 gap is below the backends'
    logit tolerance and the lean row sits within it of the oracle's. The
    port's lean scheduler (K4 chunks, K2 decode) is then held to JAX's
    teacher-forced: fed JAX's tokens, every decode row within one bf16 step
    of JAX's, and its own greedy pick equal to JAX's wherever the pick wins
    by more than that step (first tokens judged on the oracle's prefill
    row: JAX computes the chunked and the blocking prefill bit-identically)."""
    prompts = _prompts(model[0].vocab_size, seed=0)
    oracle = _oracle(model, "jax", prompts)
    jax_tokens, jax_rows, _ = _jax_chunked(model, "lean", prompts)
    gaps = _assert_near_ties(jax_tokens, jax_rows, oracle, "JAX lean")
    assert gaps, "the reference's lean stream no longer leaves the oracle"

    eng = _engine(model, "port", "lean", recorder=True,
                  forced={i: list(t) for i, t in enumerate(jax_tokens)})
    sch = tsched.Scheduler(eng, tsched.SchedulerConfig(chunked=True, **SCHED))
    hs = [sch.submit(p, 6, uid=i) for i, p in enumerate(prompts)]
    sch.run_to_completion(max_steps=400)
    assert [tuple(h.generated) for h in hs] == jax_tokens

    def decisive(row):
        return _top2_gap(row) > BF16["atol"] + BF16["rtol"] * abs(row.max())

    for uid, toks in enumerate(jax_tokens):
        np.testing.assert_allclose(np.stack(eng.rows[uid]), np.stack(jax_rows[uid]), **BF16)
        own = eng.own[uid]                      # first token, then one per decode row
        if decisive(oracle[1][uid][0]):
            assert own[0] == toks[0], uid
        for k, row in enumerate(jax_rows[uid]):
            if decisive(row):
                assert own[k + 1] == toks[k + 1], (uid, k)
    eng.pool.check()
    assert eng.pool.num_allocated == 0


def test_lifecycle_and_streaming(model):
    """QUEUED -> PREFILLING -> DECODING -> FINISHED; every token streamed in
    order; latency observations and token logs filled; engine drained."""
    cfg_j = model[0]
    prompts = _prompts(cfg_j.vocab_size, seed=PROMPT_SEED)
    states = []
    eng = _engine(model, "port")
    sch = tsched.Scheduler(eng, tsched.SchedulerConfig(**SCHED))
    assert sch.chunked
    hs = [sch.submit(p, 6, uid=i) for i, p in enumerate(prompts)]
    while sch.pending:
        sch.step()
        states.append(tuple(h.state for h in hs))
    S = tsched.RequestState
    lifecycle = [S.QUEUED, S.PREFILLING, S.DECODING, S.FINISHED]
    for i, h in enumerate(hs):
        seen = [lifecycle.index(st[i]) for st in states]
        assert seen == sorted(seen) and seen[-1] == 3 and 2 in seen
        if len(prompts[i]) > SCHED["chunk_size"]:     # streamed over several steps
            assert 1 in seen
        assert h.done and len(h.generated) == 6 and h.admit_step >= 0
    es = eng.stats
    assert len(es.ttft) == len(hs) and len(es.queue_wait) == len(hs)
    assert len(es.tpot) == es.tokens_generated
    assert sum(es.tick_prefill_tokens) == es.prefill_tokens == sum(map(len, prompts))
    assert sum(es.tick_decode_tokens) >= es.tokens_generated
    assert not sch.requests and not any(eng.slot_req)
    eng.pool.check()
    with pytest.raises(ValueError, match="empty prompt"):
        sch.submit(np.zeros(0, np.int32), 3)


def test_blocking_fallback_equals_oracle(model, runs):
    """``chunked=False`` admits with whole-prompt prefill: same streams."""
    _, handles, _ = _run(model, "port", "ref", False, runs["prompts"])
    assert [tuple(h.generated) for h in handles] == runs["oracle"][0]
    assert all(h.state is tsched.RequestState.FINISHED for h in handles)


def test_decode_keeps_running_during_long_prefill(model):
    """While a long prompt streams in chunk by chunk, the requests already
    decoding produce a token every step (tests/test_scheduler.py:132-155)."""
    vocab = model[0].vocab_size
    rng = np.random.default_rng(3)
    eng = _engine(model, "port", max_batch=3)
    sch = tsched.Scheduler(eng, tsched.SchedulerConfig(chunk_size=8, prefill_pack=1,
                                                       token_budget=16, chunked=True))
    short = [sch.submit(rng.integers(0, vocab, 6), 20, uid=i) for i in range(2)]
    long = sch.submit(rng.integers(0, vocab, 40), 4, uid=9)
    overlap = 0
    for _ in range(60):
        out = sch.step()
        if long.state is tsched.RequestState.PREFILLING and out:
            overlap += 1
        if all(h.done for h in short + [long]):
            break
    assert overlap >= 3, f"decode stalled: {overlap} overlap ticks"
    assert long.done and all(h.done for h in short)
    eng.pool.check()


def test_priority_and_starvation_bound_match_jax(model):
    """One slot, a low-priority request and a high-priority arrival every
    step: both schedulers admit in the same order, the low one within the
    starvation bound plus a slot's residency, never passing over a
    starving request."""
    vocab = model[0].vocab_size
    admitted = {}
    for side in ("jax", "port"):
        rng = np.random.default_rng(6)
        m = _mod(side)
        eng = _engine(model, side, max_batch=1)
        sch = m.Scheduler(eng, m.SchedulerConfig(policy="priority", starvation_bound=4,
                                                 chunk_size=8, prefill_pack=1))
        low = sch.submit(rng.integers(0, vocab, 4), 2, priority=0, uid=0)
        for uid in range(1, 16):
            sch.submit(rng.integers(0, vocab, 4), 2, priority=10, uid=uid)
            sch.step()
        assert low.admit_step >= 0, f"{side}: low-priority request starved"
        assert low.admit_step - low.arrival_step <= 4 + 4
        assert all(rec["starving_passed_over"] == 0 for rec in sch.stats.admissions)
        admitted[side] = [(rec["step"], rec["uid"]) for rec in sch.stats.admissions]
    assert admitted["port"] == admitted["jax"]


def test_pool_clean_after_chunked_churn_like_jax(model):
    """An undersized pool (6 usable pages of 16 tokens) with chunked
    prefill: admissions, chunks, decode growth, completions and preemptions
    interleave; the allocator holds its invariants every step, drains, and
    the port preempts and streams exactly as the reference does."""
    vocab = model[0].vocab_size
    res = {}
    for side in ("jax", "port"):
        rng = np.random.default_rng(8)
        m = _mod(side)
        eng = _engine(model, side, max_batch=3, num_pages=7)
        sch = m.Scheduler(eng, m.SchedulerConfig(chunk_size=8, prefill_pack=2, token_budget=12,
                                                 chunked=True))
        hs = [sch.submit(rng.integers(0, vocab, int(rng.integers(2, 30))),
                         int(rng.integers(1, 6)), uid=i) for i in range(6)]
        for _ in range(200):
            sch.step()
            eng.pool.check()
            if not sch.pending:
                break
        assert not sch.pending and all(h.done for h in hs) and not sch.requests
        assert eng.pool.num_allocated == 0 and eng.pool.live_sequences == 0
        res[side] = ([tuple(h.generated) for h in hs], eng.stats.preemptions,
                     sch.stats.stalled_chunk_ticks, sch.stats.steps)
    assert res["port"] == res["jax"]


def test_over_capacity_prompt_rejected(model):
    """A prompt past one slot's page capacity is refused on both admission
    paths (it would wrap chunk writes onto the last page)."""
    vocab = model[0].vocab_size
    eng = _engine(model, "port")
    sch = tsched.Scheduler(eng, tsched.SchedulerConfig(chunk_size=8, chunked=True))
    sch.submit(np.arange(100) % vocab, 2, uid=0)
    with pytest.raises(PoisonError, match="per-slot KV capacity"):
        sch.step()
    eng2 = _engine(model, "port")
    eng2.submit(Request(uid=0, prompt=np.arange(100) % vocab, max_new_tokens=2))
    with pytest.raises(PoisonError, match="per-slot KV capacity"):
        eng2.tick()


def test_double_preemption_folds_generated_once(model):
    eng = _engine(model, "port", max_batch=1)
    req = Request(uid=0, prompt=np.arange(5, dtype=np.int32), max_new_tokens=50)
    eng.submit(req)
    for _ in range(4):
        eng.tick()
    for _ in range(2):
        eng.preempt_slot(0)
        assert len(req.prompt) == 5 + len(req.generated)
        assert req.folded == len(req.generated)
        eng.tick()
    eng.pool.check()


def _robust(model, side, **skw):
    eng = _engine(model, side, max_batch=skw.pop("max_batch", 2), cache_len=32, page_size=8,
                  num_pages=skw.pop("num_pages", None))
    m = _mod(side)
    chunked = skw.pop("chunked", None)
    return m.Scheduler(eng, m.SchedulerConfig(chunk_size=8, prefill_pack=1, token_budget=16,
                                              chunked=chunked, **skw)), eng, m.RequestState


def _robust_scenarios(model, side):
    """The scheduler's robustness paths (tests/test_guards.py:450-565) on
    one package; returns what each scenario's outcome was."""
    vocab = model[0].vocab_size
    rng = np.random.default_rng(0)
    out = {}
    sch, eng, S = _robust(model, side, max_batch=1, deadline_steps=2, max_deadline_misses=2)
    hog = sch.submit(rng.integers(0, vocab, 4), 1_000_000)
    sch.step()
    late = sch.submit(rng.integers(0, vocab, 4), 4)
    for _ in range(30):
        sch.step()
        if late.state is S.FAILED:
            break
    assert late.state is S.FAILED and "missed 2x" in late.error
    assert hog.state is S.DECODING and sch.cancel(hog.uid)
    assert sch.cancel(hog.uid) is False and sch.cancel(12345) is False
    out["deadline"] = (sch.stats.deadline_expirations, sch.stats.poisoned, sch.stats.steps,
                       len(hog.generated))
    eng.pool.check()
    assert eng.pool.num_allocated == 0

    sch, eng, S = _robust(model, side, max_batch=1, chunked=True, deadline_steps=1,
                          max_deadline_misses=2, retry_backoff=1)
    long = sch.submit(rng.integers(0, vocab, 30), 4)
    saw_prefilling = False
    for _ in range(40):
        sch.step()
        saw_prefilling |= long.state is S.PREFILLING
        if long.state is S.FAILED:
            break
    assert saw_prefilling and long.state is S.FAILED
    assert not any(r is not None for r in eng.slot_req)
    out["prefilling_deadline"] = (eng.stats.preemptions, sch.stats.steps)
    eng.pool.check()
    assert eng.pool.num_allocated == 0

    sch, eng, S = _robust(model, side, num_pages=3, chunked=False, retry_backoff=2,
                          retry_backoff_cap=8)
    first = sch.submit(rng.integers(0, vocab, 8), 6)
    blocked = sch.submit(rng.integers(0, vocab, 8), 4)
    sch.run_to_completion(max_steps=100)
    assert first.done and blocked.done and sch.stats.admit_backoffs >= 1
    out["backoff"] = (sch.stats.admit_backoffs, sch.stats.steps, tuple(blocked.generated))

    sch, eng, S = _robust(model, side, max_batch=1)
    running = sch.submit(rng.integers(0, vocab, 6), 1_000_000)
    sch.step()
    queued = sch.submit(rng.integers(0, vocab, 6), 4)
    sch.step()
    assert queued.state is S.QUEUED and sch.cancel(queued.uid)
    assert running.state is S.DECODING and sch.cancel(running.uid)
    assert queued.state is S.CANCELLED and running.state is S.CANCELLED
    assert sch.stats.cancellations == 2
    eng.pool.check()
    assert eng.pool.num_allocated == 0

    sch, eng, S = _robust(model, side, max_batch=1, max_preemptions=1)
    h = sch.submit(rng.integers(0, vocab, 6), 1_000_000)
    for _ in range(2):
        for _ in range(3):
            sch.step()
        eng.preempt_slot(h.slot)
        if h.state is S.FAILED:
            break
    assert h.state is S.FAILED and "max_preemptions=1" in h.error
    out["thrash"] = (sch.stats.poisoned, len(h.generated))
    eng.pool.check()
    assert eng.pool.num_allocated == 0
    return out


def test_deadline_backoff_and_cancel_match_jax(model):
    """A TTFT deadline missed twice poison-fails; a long prompt still
    PREFILLING at its deadline is pulled off its slot; admission backs off
    against an exhausted pool; cancel works across states; a thrashing
    request hits ``max_preemptions`` -- with the same outcomes, steps and
    tokens as the reference."""
    assert _robust_scenarios(model, "port") == _robust_scenarios(model, "jax")


def test_observability_is_refused_until_ported(model):
    eng = _engine(model, "port")
    sch = tsched.Scheduler(eng)
    with pytest.raises(NotImplementedError, match="item 13"):
        sch.submit([1, 2, 3], 2, slo_class="interactive")
    with pytest.raises(NotImplementedError, match="item 13"):
        sch.telemetry()
