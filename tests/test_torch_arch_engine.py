"""The attention-family architectures served by the port's engine against
the JAX engine, engine level: the same smoke weights (``params_from_numpy``)
and prompts through the same ``EngineConfig`` on both sides.

- ``qwen3-moe-30b-a3b`` on the chunked ``Scheduler`` (MoE in every chunk,
  decode and admission step; idle slots routed as the reference routes
  them), ``lean`` and ``ref``;
- ``gemma3-4b`` on the paged engine with prompts longer than its window of
  8 (blocking admission: ``attn`` layers paged, ``win`` rings dense);
- ``musicgen-large`` on the paged engine with ragged prompts: sinusoidal
  positions go in at ``max(ctx_lens)`` for every slot of a decode step, on
  both sides (the reference's own behaviour, kept);
- ``recurrentgemma-9b`` (RG-LRU and window layers) and ``xlstm-350m``
  (mLSTM and sLSTM) on the paged and dense engines, admitted at their exact
  prompt lengths (``prefill_compiles`` as the JAX engine's), through the
  Scheduler's blocking fallback, preempted and recomputed, and on a
  degraded pass, whose masked slots' states the reference's step advances
  too (ROADMAP queue 3);
- the refusals: ``xattn`` admission, speculative decode without chunked
  prefill.

Streams. Greedy streams of random smoke models meet near ties, and the JAX
engine jits its steps where the port runs them eagerly on the CPU (XLA's
fusion moves logits by up to a few bf16 steps, ``tests/test_torch_
scheduler.py``). A stream must equal the JAX engine's, or leave it where
the port's own top-2 logit gap at that token is below ``NEAR_TIE`` = 2**-4
(the contexts agree up to there, so the gap is the margin the pick had).
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
from repro_torch.models import decode_step, params_from_numpy, prefill  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402
from repro_torch.serving.config import EngineConfig, PagedConfig, SpecConfig  # noqa: E402
from repro_torch.serving.engine import DecodeEngine, Request  # noqa: E402

NEAR_TIE = 2**-4
SCHED = dict(chunk_size=8, prefill_pack=2, token_budget=16)
NEW = 5

_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        cfg_j, cfg = jax_smoke(arch), get_smoke_config(arch)
        pj = jinit(jax.random.PRNGKey(0), cfg_j)
        _MODELS[arch] = (cfg_j, cfg, pj, params_from_numpy(jax.tree.map(np.asarray, pj), cfg,
                                                           device="cpu"))
    return _MODELS[arch]


class _Rows(DecodeEngine):
    """The port's engine, recording the logits row each emitted token was
    picked from, per request: admission, the chunk that ends a prompt, then
    each decode tick (from the pass the slot decoded in: a tick with a
    degraded slot runs one pass per level)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.rows = {}
        self.pass_rows = {}             # slot -> its row of the pass it decoded in

    def _run_prompt_prefill(self, prompt, slot, pages):
        logits = super()._run_prompt_prefill(prompt, slot, pages)
        self.rows.setdefault(self.slot_req[slot].uid, []).append(logits[0].float().numpy())
        return logits

    def prefill_chunks_tick(self, work, pack_width, chunk_cap):
        toks = super().prefill_chunks_tick(work, pack_width, chunk_cap)
        for i, (slot, chunk, off) in enumerate(work):
            req = self.slot_req[slot]
            if off + len(chunk) == len(req.prompt):
                self.rows.setdefault(req.uid, []).append(
                    self.last_prefill_logits[i].float().numpy())
        return toks

    def _decode_pass(self, level, slots, active, exclude):
        logits = super()._decode_pass(level, slots, active, exclude)
        self.pass_rows.update({s: logits[s].float().numpy() for s in slots})
        return logits

    def _emit_tokens(self, results, guard_on, spec=None):
        for slots, _, _ in results:
            for s in slots:
                self.rows.setdefault(self.slot_req[s].uid, []).append(self.pass_rows[s])
        return super()._emit_tokens(results, guard_on, spec)


def _engine(arch, side, backend, max_batch=3, cache_len=48, page_size=8, paged=True):
    cfg_j, cfg, pj, pt = _model(arch)
    common = dict(attn_backend=backend, max_batch=max_batch, cache_len=cache_len, num_workers=4)
    if side == "jax":
        return JEngine(cfg_j, pj, JConfig(paged=JPaged(enabled=paged, page_size=page_size),
                                          **common))
    return _Rows(cfg, pt, EngineConfig(paged=PagedConfig(enabled=paged, page_size=page_size),
                                       **common), device="cpu")


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n) for n in lens]


def _serve(eng, side, prompts, chunked):
    """Serve through the Scheduler (``chunked``) or the raw engine's tick
    loop; returns the streams by uid."""
    if chunked:
        m = jsched if side == "jax" else tsched
        sch = m.Scheduler(eng, m.SchedulerConfig(chunked=True, **SCHED))
        hs = [sch.submit(p, NEW, uid=i) for i, p in enumerate(prompts)]
        sch.run_to_completion(max_steps=400)
        return {h.uid: list(h.generated) for h in hs}
    R = JRequest if side == "jax" else Request
    reqs = [R(uid=i, prompt=p, max_new_tokens=NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion(max_ticks=200)
    return {r.uid: list(r.generated) for r in reqs}


def _held_to(got, want, rows):
    """Each port stream equals the JAX one, or leaves it at a near tie of
    the port's own logits there. Returns the divergences (uid, token, gap)."""
    out = []
    for uid, stream in got.items():
        assert len(stream) == len(want[uid]) == NEW, (uid, stream, want[uid])
        k = next((i for i, (a, b) in enumerate(zip(stream, want[uid])) if a != b), None)
        if k is None:
            continue
        top = np.sort(rows[uid][k])
        gap = float(top[-1] - top[-2])
        assert gap < NEAR_TIE, (uid, k, gap, stream, want[uid])
        out.append((uid, k, gap))
    return out


def _compare(arch, backend, prompts, chunked, paged=True):
    want = _serve(_engine(arch, "jax", backend, paged=paged), "jax", prompts, chunked)
    eng = _engine(arch, "port", backend, paged=paged)
    got = _serve(eng, "port", prompts, chunked)
    divergences = _held_to(got, want, eng.rows)
    if paged:
        eng.pool.check()
        assert eng.pool.num_allocated == 0
    return eng, divergences


@pytest.mark.parametrize("backend", ["lean", "ref"])
def test_qwen3_moe_chunked_scheduler_matches_jax(backend):
    """qwen3-moe on the chunked Scheduler (chunk 8, pack 2): the MoE runs on
    every chunk row, pad rows included, and on every decode slot, idle ones
    included, as the reference routes them."""
    cfg = _model("qwen3-moe-30b-a3b")[1]
    prompts = _prompts(cfg.vocab_size, (19, 6, 11), seed=3)
    eng, div = _compare("qwen3-moe-30b-a3b", backend, prompts, chunked=True)
    assert eng.supports_chunked_prefill() and eng.stats.chunk_prefills > 0
    assert len(div) <= 1, div


@pytest.mark.parametrize("paged", [True, False])
def test_gemma3_window_rings_match_jax(paged):
    """gemma3 (five ``win`` layers of window 8, one ``attn``) on the lean
    engine with prompts of 21, 13 and 5 tokens: the rings are filled from
    the bucketed prefill's last real positions and wrap during decode. On
    the paged engine only the ``attn`` layer is paged; on the dense one
    every layer keeps per-slot rows."""
    cfg = _model("gemma3-4b")[1]
    prompts = _prompts(cfg.vocab_size, (21, 13, 5), seed=4)
    eng, div = _compare("gemma3-4b", "lean", prompts, chunked=False, paged=paged)
    assert not eng.supports_chunked_prefill()
    kinds = eng.layer_kinds
    assert [tuple(lc["k"].shape) for lc in eng.cache][kinds.index("win")] == (
        3, cfg.n_kv_heads, cfg.window, cfg.head_dim)
    if paged:
        assert eng.pool.layout.n_attn_layers == kinds.count("attn") == 1
    assert len(div) <= 1, div


def test_musicgen_ragged_shares_one_position_like_jax():
    """musicgen (sinusoidal positions, GeLU FFN) on the paged lean engine
    with ragged prompts: streams as the JAX engine's. Both embed a decode
    step's tokens at ``max(ctx_lens)`` (the reference's fast step), so a
    shorter slot's logits are those of the longest slot's position, not its
    own: shown on the port's decode step."""
    cfg_j, cfg, pj, pt = _model("musicgen-large")
    prompts = _prompts(cfg.vocab_size, (17, 9, 4), seed=5)
    eng, div = _compare("musicgen-large", "lean", prompts, chunked=False)
    assert len(div) <= 1, div
    toks = torch.from_numpy(np.stack([p[:4] for p in prompts[:2]]).astype(np.int64))
    _, cache, _ = prefill(pt, cfg, toks, cache_len=16)
    ctx = torch.tensor([4, 2], dtype=torch.int32)
    step = torch.tensor([[7], [7]])
    shared, _ = decode_step(pt, cfg, [dict(lc) for lc in cache], step, ctx_lens=ctx)
    own, _ = decode_step(pt, cfg, [dict(lc) for lc in cache], step, ctx_lens=ctx, cur_len=2)
    at_max, _ = decode_step(pt, cfg, [dict(lc) for lc in cache], step, ctx_lens=ctx, cur_len=4)
    assert torch.equal(shared, at_max) and not torch.allclose(shared[1], own[1])


def test_xattn_admission_refused():
    """llama-3.2-vision's engine admission: the reference's fails (its
    prefill computes the cross K/V over the prompt, which its slot write
    cannot place); the port refuses, naming the fault. Its layers run at the
    model level (tests/test_torch_archs.py)."""
    cfg = _model("llama-3.2-vision-11b")[1]
    prompt = _prompts(cfg.vocab_size, (9,))[0]
    jeng = _engine("llama-3.2-vision-11b", "jax", "ref")
    jeng.submit(JRequest(uid=0, prompt=prompt, max_new_tokens=2))
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        jeng.tick()
    eng = _engine("llama-3.2-vision-11b", "port", "ref")
    eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=2))
    with pytest.raises(NotImplementedError, match="xattn.*queue 3"):
        eng.tick()


GUARD_COUNTERS = ("nan_ticks", "degrade_escalations", "degrade_heals", "poisoned_slots",
                  "preemptions", "tokens_generated", "ticks")


def _guarded_gemma_run(side, prompts):
    """gemma3 paged (page 8, lean) with guards and one ``nan_kv`` fault: the
    victim's page of the ``attn`` layer turns NaN, the slot walks down the
    degraded-mode chain, is poisoned, scrubbed and recomputed. Returns the
    streams, the guard counters and the injector's record, and the engine."""
    from repro.serving import faults as jfaults, guards as jguards
    from repro_torch.serving import faults as tfaults, guards as tguards

    f, g = (jfaults, jguards) if side == "jax" else (tfaults, tguards)
    cfg_j, cfg, pj, pt = _model("gemma3-4b")
    inj = f.FaultInjector({"nan_kv": f.FaultSpec(rate=1.0, start=3, max_fires=1)}, seed=2)
    common = dict(attn_backend="lean", max_batch=3, cache_len=48, num_workers=4, faults=inj,
                  guards=g.GuardConfig(heal_after=2, poison_after=2))
    if side == "jax":
        eng = JEngine(cfg_j, pj, JConfig(paged=JPaged(enabled=True, page_size=8), **common))
        R = JRequest
    else:
        eng = DecodeEngine(cfg, pt, EngineConfig(paged=PagedConfig(enabled=True, page_size=8),
                                                 **common), device="cpu")
        R = Request
    reqs = [R(uid=i, prompt=p, max_new_tokens=12) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion(max_ticks=300)
    return {"streams": [list(r.generated) for r in reqs],
            "counters": {k: getattr(eng.stats, k) for k in GUARD_COUNTERS},
            "faults": inj.as_dict()}, eng


def test_gemma3_guards_poison_only_pooled_layers_like_jax():
    """gemma3 under guards and an injected ``nan_kv`` fault: the NaN fill
    and the poison scrub touch page ids of the ``attn`` layer's pool only,
    as the reference's ``_fill_page`` does; the ``win`` layers' dense
    per-slot rings, whose first index is a slot and not a page, are left
    alone. Streams, guard counters and the injector's record equal the JAX
    engine's; then a fill of a page id that is also a live slot's index
    leaves every ring as it was."""
    cfg = _model("gemma3-4b")[1]
    prompts = _prompts(cfg.vocab_size, (21, 13, 5), seed=6)
    want, _ = _guarded_gemma_run("jax", prompts)
    got, eng = _guarded_gemma_run("port", prompts)
    assert got == want
    assert got["counters"]["poisoned_slots"] == 1 and got["faults"]["points"]["nan_kv"]["fires"] == 1
    eng.pool.check()
    assert eng.pool.num_allocated == 0
    eng.submit(Request(uid=9, prompt=prompts[0], max_new_tokens=3))
    eng.tick()
    kinds = eng.layer_kinds
    rings = [{n: t.clone() for n, t in lc.items()} for lc, k in zip(eng.cache, kinds)
             if k == "win"]
    eng._fill_page(1, float("nan"))
    after = [lc for lc, k in zip(eng.cache, kinds) if k == "win"]
    assert all(torch.equal(a[n], b[n]) for a, b in zip(rings, after) for n in a)
    for lc, k in zip(eng.cache, kinds):
        if k == "attn":
            assert torch.isnan(lc["k"][1]).all() and torch.isnan(lc["v"][1]).all()


@pytest.mark.parametrize("arch", ["gemma3-4b", "musicgen-large"])
def test_spec_refused_without_chunked_prefill(arch):
    """Speculative decode's verify step is a chunk step: the reference
    refuses it for windowed and sinusoidal architectures, and so does the
    port."""
    cfg_j, cfg, pj, pt = _model(arch)
    with pytest.raises(ValueError, match="supports_chunked_prefill"):
        DecodeEngine(cfg, pt, EngineConfig(paged=PagedConfig(enabled=True, page_size=8),
                                           max_batch=2, cache_len=32,
                                           spec=SpecConfig(enabled=True, k=2)), device="cpu")


RECURRENT = ["recurrentgemma-9b", "xlstm-350m"]
_JAX_RUNS = {}


def _recurrent_prompts(arch):
    return _prompts(_model(arch)[1].vocab_size, (21, 13, 5), seed=7)


def _jax_streams(arch, paged):
    """The JAX lean engine's streams and ``prefill_compiles`` on the
    recurrent prompts (21, 13 and 5 tokens: past recurrentgemma's window of
    8), memoised: several tests hold the port to them."""
    if (arch, paged) not in _JAX_RUNS:
        eng = _engine(arch, "jax", "lean", paged=paged)
        want = _serve(eng, "jax", _recurrent_prompts(arch), False)
        _JAX_RUNS[arch, paged] = (want, eng.stats.prefill_compiles)
    return _JAX_RUNS[arch, paged]


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_engine_matches_jax(arch, paged):
    """The recurrent architectures on the lean engine, paged (no layer is
    pooled: ``win`` rings and states stay dense per slot) and dense:
    streams as the JAX engine's; every prompt admitted at its exact length
    (no true length, one admission key per length), ``prefill_compiles``
    equal to the JAX engine's."""
    want, compiles = _jax_streams(arch, paged)
    prompts = _recurrent_prompts(arch)
    eng = _engine(arch, "port", "lean", paged=paged)
    got = _serve(eng, "port", prompts, False)
    assert len(_held_to(got, want, eng.rows)) <= 1
    assert not eng.bucket_prefill and not eng.supports_chunked_prefill()
    assert eng.stats.prefill_compiles == compiles == len(prompts)
    assert eng._prefill_shapes == {len(p) for p in prompts}
    if paged:
        assert eng.pool.layout.n_attn_layers == 0
        eng.pool.check()
        assert eng.pool.num_allocated == 0


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_scheduler_blocking_fallback(arch):
    """The Scheduler over a recurrent engine (``chunked`` left to the
    engine) falls back to blocking whole-prompt admission, since the engine
    reports no chunked prefill, as the reference's does (asking for chunks
    is its ValueError): no chunk step runs, and the streams are the JAX
    engine's."""
    want, _ = _jax_streams(arch, True)
    eng = _engine(arch, "port", "lean")
    with pytest.raises(ValueError, match="supports_chunked_prefill"):
        tsched.Scheduler(eng, tsched.SchedulerConfig(chunked=True, **SCHED))
    sch = tsched.Scheduler(eng, tsched.SchedulerConfig(**SCHED))
    assert not sch.chunked
    hs = [sch.submit(p, NEW, uid=i) for i, p in enumerate(_recurrent_prompts(arch))]
    sch.run_to_completion(max_steps=400)
    got = {h.uid: list(h.generated) for h in hs}
    assert eng.stats.chunk_prefills == 0 and eng.stats.prefills == 3
    assert len(_held_to(got, want, eng.rows)) <= 1
    eng.pool.check()
    assert eng.pool.num_allocated == 0


def _preempted_run(arch, side):
    """The recurrent prompts on the paged lean engine, slot 0 preempted
    after its third token: it is readmitted with its prompt extended by the
    tokens it generated, prefilled at that exact length."""
    eng = _engine(arch, side, "lean")
    R = JRequest if side == "jax" else Request
    reqs = [R(uid=i, prompt=p, max_new_tokens=NEW) for i, p in enumerate(_recurrent_prompts(arch))]
    for r in reqs:
        eng.submit(r)
    while len(reqs[0].generated) < 3:
        eng.tick()
    eng.preempt_slot(0)
    eng.run_to_completion(max_ticks=200)
    return {r.uid: list(r.generated) for r in reqs}, eng


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_preemption_recomputes_at_exact_length(arch):
    """Preemption and recompute on a recurrent engine: the readmission
    prefills prompt + generated tokens at their exact length, rebuilding the
    whole state; streams and ``prefill_compiles`` as the JAX engine's, and
    the preempted stream as the unpreempted one's."""
    want, jeng = _preempted_run(arch, "jax")
    got, eng = _preempted_run(arch, "port")
    assert len(_held_to(got, want, eng.rows)) <= 1
    assert eng.stats.preemptions == jeng.stats.preemptions == 1
    assert eng.stats.prefill_compiles == jeng.stats.prefill_compiles == 4
    assert len(_recurrent_prompts(arch)[0]) + 3 in eng._prefill_shapes
    assert len(_held_to(got, _jax_streams(arch, True)[0], eng.rows)) <= 1
    eng.pool.check()


def _degraded_run(arch, side, degrade):
    """The recurrent prompts on a guarded paged lean engine; with
    ``degrade`` slot 1 is forced one level down after the first tick, so the
    next ticks run two passes, each masking the other's slots. Returns the
    streams, the guard counters, and slot 0's states after the second
    tick."""
    from repro.serving import guards as jguards
    from repro_torch.serving import guards as tguards

    g = jguards if side == "jax" else tguards
    cfg_j, cfg, pj, pt = _model(arch)
    common = dict(attn_backend="lean", max_batch=3, cache_len=48, num_workers=4,
                  guards=g.GuardConfig(heal_after=2))
    if side == "jax":
        eng = JEngine(cfg_j, pj, JConfig(paged=JPaged(enabled=True, page_size=8), **common))
        R = JRequest
    else:
        eng = _Rows(cfg, pt, EngineConfig(paged=PagedConfig(enabled=True, page_size=8),
                                          **common), device="cpu")
        R = Request
    reqs = [R(uid=i, prompt=p, max_new_tokens=NEW) for i, p in enumerate(_recurrent_prompts(arch))]
    for r in reqs:
        eng.submit(r)
    eng.tick()
    if degrade:
        assert eng.force_degrade(1, cause="watchdog", slots=[1]) == 1
    eng.tick()
    state = None
    if side == "port":
        state = {(i, k): t[0].clone() for i, lc in enumerate(eng.cache)
                 if eng.layer_kinds[i] != "win" for k, t in lc.items()}
    eng.run_to_completion(max_ticks=200)
    counters = {k: getattr(eng.stats, k) for k in ("degrade_escalations", "degrade_heals",
                                                   "ticks", "tokens_generated")}
    return {r.uid: list(r.generated) for r in reqs}, counters, (state, eng)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_degraded_pass_matches_jax(arch):
    """A degraded slot decodes in a pass of its own, the others masked (the
    reference's ``_decode_pass_inner``): masked slots get context 0, but
    the reference's decode step still advances their recurrent state, so
    on such a tick every slot's state moves once per pass. The port does
    the same (a fault of the reference, ROADMAP queue 3): streams and guard
    counters as the JAX engine's, and healthy slot 0's state after the
    two-pass tick differs from its state after a one-pass tick."""
    want, wc, _ = _degraded_run(arch, "jax", True)
    got, gc, (twice, eng) = _degraded_run(arch, "port", True)
    assert gc == wc and gc["degrade_escalations"] == 1
    assert len(_held_to(got, want, eng.rows)) <= 1
    _, _, (once, _) = _degraded_run(arch, "port", False)
    assert any(not torch.equal(twice[k], once[k]) for k in once)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_architectures_refused(arch):
    """What the reference refuses a recurrent architecture the port refuses
    too: speculative decode, whose verify step is a chunk step (their states
    have no chunk-resume plumbing). Everything else is served (the tests
    above)."""
    cfg_j, cfg, pj, pt = _model(arch)
    spec = dict(paged=PagedConfig(enabled=True, page_size=8), max_batch=2, cache_len=32,
                spec=SpecConfig(enabled=True, k=2))
    with pytest.raises(ValueError, match="supports_chunked_prefill"):
        DecodeEngine(cfg, pt, EngineConfig(**spec), device="cpu")
    from repro.serving.config import SpecConfig as JSpec

    with pytest.raises(ValueError, match="supports_chunked_prefill"):
        JEngine(cfg_j, pj, JConfig(paged=JPaged(enabled=True, page_size=8), max_batch=2,
                                   cache_len=32, spec=JSpec(enabled=True, k=2)))
