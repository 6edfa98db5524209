"""The port's speculative (draft-verify) decode against the JAX package's
on the smoke configuration: same weights (``params_from_numpy``), same
margin prompts (``PROMPT_SEED``), same proposers.

The contract is the reference's (tests/test_speculative.py): the verify
step scores the drafts with the target model and keeps only the prefix it
agrees with, so the greedy stream equals plain greedy decode token for
token. Here the port's speculative streams must also equal the JAX
speculative engine's, with the same ``spec_draft_tokens`` and
``spec_accepted_tokens``, on ``lean``, ``fixed`` and ``ref``, bf16 and int8
pools (and f8 on ``lean`` and ``fixed``), the cascade, a partially accepting ``OracleProposer`` and the
``NGramProposer``. The prompts keep every top-2 gap of the port's greedy
oracle above 2**-4 (``test_oracle_margin``), so a backend's rounding cannot
flip a token; the JAX engine jits its steps and moves logits by up to
0.008 against eager execution (tests/test_torch_scheduler.py).

Port only: a rejected block leaves its pages to the slot (the page-table
tail past the context is dead, nothing is freed or undone), the pool stays
clean under adversarial drafts, the Scheduler streams every token of a
speculative tick once with ``done`` on the last, ``decode_token_width()``
is ``k + 1``, and the proposers' own cases (tests/test_speculative.py:
352-383), against the JAX copies.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.serving import speculative as jspec  # noqa: E402
from repro.serving.config import CascadeConfig as JCascade  # noqa: E402
from repro.serving.config import EngineConfig as JConfig, PagedConfig as JPaged  # noqa: E402
from repro.serving.config import SpecConfig as JSpec  # noqa: E402
from repro.serving.engine import DecodeEngine as JEngine, Request as JRequest  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402
from repro_torch.serving.config import (  # noqa: E402
    CascadeConfig,
    EngineConfig,
    PagedConfig,
    SpecConfig,
)
from repro_torch.serving.engine import DecodeEngine, Request  # noqa: E402
from repro_torch.serving.speculative import NGramProposer, OracleProposer  # noqa: E402

PROMPT_SEED = 0
NEW = 8
K = 4


@pytest.fixture(scope="module")
def model():
    cfg_j = jax_smoke("mistral-nemo-12b")
    cfg = get_smoke_config("mistral-nemo-12b")
    pj = jinit(jax.random.PRNGKey(0), cfg_j)
    return cfg_j, cfg, pj, params_from_numpy(jax.tree.map(np.asarray, pj), cfg, device="cpu")


def _prompts(vocab, n=3):
    rng = np.random.default_rng(PROMPT_SEED)
    return [rng.integers(0, vocab, 8 + 7 * i) for i in range(n)]


def _config(side, backend="ref", kv=None, cascade=False, spec=None):
    Paged, Casc, Config, Spec = ((JPaged, JCascade, JConfig, JSpec) if side == "jax"
                                 else (PagedConfig, CascadeConfig, EngineConfig, SpecConfig))
    return Config(
        max_batch=4, cache_len=64, attn_backend=backend, num_workers=8,
        paged=Paged(enabled=True, page_size=8, kv_dtype=kv, prefix_cache=cascade),
        cascade=Casc(enabled=cascade, stable_ticks=1),
        spec=Spec(**spec) if spec is not None else Spec(),
    )


def _engine(model, side, **kw):
    cfg_j, cfg, pj, pt = model
    if side == "jax":
        return JEngine(cfg_j, pj, _config("jax", **kw))
    return DecodeEngine(cfg, pt, _config("port", **kw), device="cpu")


def _serve(eng, side, prompts, new=NEW, check_each_tick=False):
    R = JRequest if side == "jax" else Request
    reqs = [R(uid=i, prompt=p, max_new_tokens=new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    while (eng.queue or any(eng.slot_req)) and eng.stats.ticks < 300:
        eng.tick()
        if check_each_tick:
            eng.pool.check()
    assert all(r.done for r in reqs)
    return {r.uid: list(r.generated) for r in reqs}


class _GapRecorder(DecodeEngine):
    """Records the top-2 logit gap behind every token: admission's and
    each decode tick's."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.gaps = []

    def _note(self, logits):
        top = torch.topk(logits.float(), 2, dim=-1).values
        self.gaps += (top[:, 0] - top[:, 1]).tolist()

    def _run_prompt_prefill(self, prompt, slot, pages):
        logits = super()._run_prompt_prefill(prompt, slot, pages)
        self._note(logits)
        return logits

    def _emit_tokens(self, results, guard_on, spec=None):
        for active, _, _ in results:               # one pass: no guards here
            self._note(self.last_logits[active])
        return super()._emit_tokens(results, guard_on, spec)


@pytest.fixture(scope="module")
def plain(model):
    """The port's non-speculative greedy streams per (backend, kv dtype,
    cascade), made once: the oracle every speculative run must equal."""
    runs = {}

    def get(backend="ref", kv=None, cascade=False):
        key = (backend, kv, cascade)
        if key not in runs:
            runs[key] = _serve(_engine(model, "port", backend=backend, kv=kv, cascade=cascade),
                               "port", _prompts(model[1].vocab_size))
        return runs[key]

    return get


def test_oracle_margin(model):
    """Every token of the port's ``ref`` oracle on these prompts (the
    admission's and each decode tick's) wins by more than 2**-4, so
    backends within a few bf16 steps of it (and the JAX engine) pick
    alike."""
    _, cfg, _, pt = model
    eng = _GapRecorder(cfg, pt, _config("port"), device="cpu")
    _serve(eng, "port", _prompts(cfg.vocab_size))
    assert len(eng.gaps) == 3 * NEW and min(eng.gaps) > 2**-4, min(eng.gaps)


def _spec_pair(model, proposer_of, **kw):
    """The port's and the JAX package's speculative engines of ``kw``,
    each with the proposer ``proposer_of(module)`` builds from its own
    package's proposers. Returns (port engine, port streams, JAX engine,
    JAX streams)."""
    import repro_torch.serving.speculative as tspec

    prompts = _prompts(model[1].vocab_size)
    out = []
    for side, mod in (("port", tspec), ("jax", jspec)):
        eng = _engine(model, side, spec=dict(enabled=True, k=K, proposer=proposer_of(mod)), **kw)
        out += [eng, _serve(eng, side, prompts)]
    return out


@pytest.mark.parametrize("backend,kv", [("lean", None), ("fixed", None), ("ref", None),
                                        ("lean", "int8"), ("fixed", "int8"), ("ref", "int8"),
                                        ("lean", "f8"), ("fixed", "f8")])
def test_spec_streams_and_stats_equal_jax(model, plain, backend, kv):
    """A partially accepting oracle (accept rate 0.6): the port's
    speculative streams equal plain greedy decode and the JAX speculative
    engine's, with the same drafts proposed and accepted."""
    ref = plain(backend, kv)
    eng, got, jeng, jgot = _spec_pair(
        model, lambda m: m.OracleProposer(ref, accept_rate=0.6, seed=7),
        backend=backend, kv=kv)
    assert got == ref == jgot
    st, jst = eng.stats, jeng.stats
    assert 0 < st.spec_accepted_tokens < st.spec_draft_tokens
    for name in ("spec_ticks", "spec_draft_tokens", "spec_accepted_tokens", "ticks",
                 "tokens_generated"):
        assert getattr(st, name) == getattr(jst, name), name
    eng.pool.check(scales=eng._kv_scale_arrays())
    assert eng.pool.num_allocated == 0


def test_spec_cascade_equals_jax(model):
    """Speculative decode beside the radix cache and the cascade (lean):
    waves of requests sharing a prefix, a full-accept oracle; streams and
    spec and cascade counters equal the JAX engine's."""
    cfg_j, cfg, pj, pt = model
    rng = np.random.default_rng(PROMPT_SEED)
    shared = rng.integers(0, cfg.vocab_size, 24)
    waves = [[np.concatenate([shared, rng.integers(0, cfg.vocab_size, 5 + 3 * i)])
              for i in range(2)],
             [np.concatenate([shared, rng.integers(0, cfg.vocab_size, 4 + 2 * i)])
              for i in range(2)]]

    def serve(eng, side, spec_on):
        R = JRequest if side == "jax" else Request
        out, uid = {}, 0
        for wave in waves:
            reqs = []
            for p in wave:
                reqs.append(R(uid=uid, prompt=p, max_new_tokens=8))
                uid += 1
            for r in reqs:
                eng.submit(r)
            while (eng.queue or any(eng.slot_req)) and eng.stats.ticks < 300:
                eng.tick()
            out.update({r.uid: list(r.generated) for r in reqs})
        return out

    base = serve(_engine(model, "port", backend="lean", cascade=True), "port", False)
    runs = []
    for side, mod in (("port", None), ("jax", jspec)):
        prop = (OracleProposer(base) if mod is None else mod.OracleProposer(base))
        eng = _engine(model, side, backend="lean", cascade=True,
                      spec=dict(enabled=True, k=3, proposer=prop))
        runs.append((eng, serve(eng, side, True)))
    (eng, got), (jeng, jgot) = runs
    assert got == base == jgot
    for name in ("spec_ticks", "spec_draft_tokens", "spec_accepted_tokens",
                 "prefix_matched_tokens", "cascade_ticks"):
        assert getattr(eng.stats, name) == getattr(jeng.stats, name), name
    assert eng.stats.spec_accepted_tokens == eng.stats.spec_draft_tokens > 0
    eng.pool.check()
    eng.prefix_cache.check()


def test_spec_ngram_equals_jax(model, plain):
    """The in-tree prompt-lookup proposer (the default): streams equal
    plain greedy decode and the JAX engine's, drafts and acceptances
    equal."""
    ref = plain("ref")
    eng, got, jeng, jgot = _spec_pair(model, lambda m: None, backend="ref")
    assert isinstance(eng.proposer, NGramProposer)
    assert got == ref == jgot
    assert eng.stats.spec_draft_tokens == jeng.stats.spec_draft_tokens > 0
    assert eng.stats.spec_accepted_tokens == jeng.stats.spec_accepted_tokens


def test_spec_full_accept_takes_fewer_ticks(model, plain):
    """A full-accept oracle on ``lean``: every draft verified, far fewer
    decode ticks than plain decode."""
    ref = plain("lean")
    eng = _engine(model, "port", backend="lean",
                  spec=dict(enabled=True, k=K, proposer=OracleProposer(ref)))
    assert _serve(eng, "port", _prompts(model[1].vocab_size)) == ref
    assert eng.stats.spec_accepted_tokens == eng.stats.spec_draft_tokens > 0
    assert eng.stats.ticks < NEW - 1


def test_spec_dense_nonspec_matches_paged_spec(model, plain):
    """Across layouts: the dense non-speculative ``ref`` engine's streams
    equal the paged speculative ones."""
    _, cfg, _, pt = model
    dense = DecodeEngine(cfg, pt, EngineConfig(max_batch=4, cache_len=64, attn_backend="ref"),
                         device="cpu")
    ref = _serve(dense, "port", _prompts(cfg.vocab_size))
    eng = _engine(model, "port", spec=dict(enabled=True, k=K, proposer=OracleProposer(ref)))
    assert _serve(eng, "port", _prompts(cfg.vocab_size)) == ref


def test_spec_tick_returns_token_lists_and_budget_width(model, plain):
    ref = plain("ref")
    eng = _engine(model, "port", spec=dict(enabled=True, k=K, proposer=OracleProposer(ref)))
    assert eng.decode_token_width() == K + 1
    for i, p in enumerate(_prompts(model[1].vocab_size)):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=NEW))
    eng._admit()
    out = eng.decode_tick()
    assert out and all(isinstance(v, list) and 1 <= len(v) <= K + 1 for v in out.values())
    assert tuple(eng.last_verify_logits.shape) == (eng.max_batch, K + 1, model[1].vocab_size)
    assert _engine(model, "port").decode_token_width() == 1


def test_spec_requires_chunked_prefill_machinery(model):
    _, cfg, _, pt = model
    with pytest.raises(ValueError, match="speculative"):
        DecodeEngine(cfg, pt, EngineConfig(spec=SpecConfig(enabled=True, k=4)), device="cpu")
    with pytest.raises(ValueError, match="k must be"):
        _engine(model, "port", spec=dict(enabled=True, k=0))


class _Adversarial:
    """Seeded random drafts of random length: rejection churn."""

    def __init__(self, vocab, seed):
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)

    def propose(self, req, k):
        n = int(self.rng.integers(0, k + 1))
        return [int(t) for t in self.rng.integers(0, self.vocab, n)]


@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("seed", [0, 1])
def test_spec_rejected_draft_rollback_pool_invariants(model, plain, kv, seed):
    """Under random drafts the pool stays clean after every tick (no page
    freed, leaked or aliased by a rejected block) and the streams equal
    plain greedy decode."""
    _, cfg, _, _ = model
    eng = _engine(model, "port", kv=kv,
                  spec=dict(enabled=True, k=K, proposer=_Adversarial(cfg.vocab_size, seed)))
    got = _serve(eng, "port", _prompts(cfg.vocab_size), check_each_tick=True)
    assert got == plain("ref", kv)
    assert eng.stats.spec_draft_tokens > eng.stats.spec_accepted_tokens
    eng.pool.check(scales=eng._kv_scale_arrays())
    assert eng.pool.num_allocated == 0


def test_spec_rollback_trims_page_table_tail(model):
    """A rejected block keeps its pages: the slot's pages cover the whole
    ``k + 1`` block though its context advanced by one token, the table
    past the context is dead, and the next tick writes over it."""
    _, cfg, _, _ = model

    class Reject:
        def propose(self, req, k):
            return [cfg.vocab_size - 1] * k

    eng = _engine(model, "port", spec=dict(enabled=True, k=K, proposer=Reject()))
    r = Request(uid=0, prompt=_prompts(cfg.vocab_size)[0][:6], max_new_tokens=12)
    eng.submit(r)
    eng._admit()
    slot = next(s for s in range(eng.max_batch) if eng.slot_req[s] is r)
    ctx0 = int(eng.ctx_lens[slot])
    assert eng.pool.count(slot) == 1              # 6 tokens, one page of 8
    eng.decode_tick()
    ctx = int(eng.ctx_lens[slot])
    assert ctx == ctx0 + 1 and eng.stats.spec_accepted_tokens == 0
    pages = eng.pool.count(slot)
    assert pages == 2 and pages * eng.tile >= ctx0 + K + 1     # grown for the block
    tail = eng.page_tbl[slot, 1]
    eng.decode_tick()
    eng.pool.check()
    assert eng.pool.count(slot) == pages and eng.page_tbl[slot, 1] == tail


def test_spec_scheduler_streams_every_token_once(model):
    """The Scheduler over a speculative engine (chunked prefill, lean):
    every token streamed once, ``done`` only on the last, streams equal
    the non-speculative Scheduler's."""
    _, cfg, _, pt = model
    prompts = _prompts(cfg.vocab_size)
    sched_cfg = dict(chunk_size=16, token_budget=32)

    def run(spec):
        eng = DecodeEngine(cfg, pt, _config("port", backend="lean", spec=spec), device="cpu")
        sch = tsched.Scheduler(eng, tsched.SchedulerConfig(**sched_cfg))
        streams = {}
        hs = [sch.submit(p, NEW, on_token=lambda uid, t, done:
                         streams.setdefault(uid, []).append((t, done))) for p in prompts]
        sch.run_to_completion()
        return eng, hs, streams

    _, base, _ = run(None)
    ref = {h.uid: list(h.generated) for h in base}
    eng, hs, streams = run(dict(enabled=True, k=K, proposer=OracleProposer(ref)))
    assert eng.decode_token_width() == K + 1
    for h in hs:
        assert list(h.generated) == ref[h.uid]
        assert [t for t, _ in streams[h.uid]] == ref[h.uid]
        flags = [d for _, d in streams[h.uid]]
        assert flags[-1] is True and not any(flags[:-1])
    assert eng.stats.spec_ticks > 0
    assert eng.stats.spec_draft_tokens == eng.stats.spec_accepted_tokens > 0
    eng.pool.check()


# ------------------------------------------------------------- proposers
def test_ngram_proposer_prompt_lookup():
    p = NGramProposer(n=2)
    req = Request(uid=0, prompt=np.array([1, 2, 3, 9, 1, 2]), max_new_tokens=8)
    assert p.propose(req, 2) == [3, 9]
    assert p.propose(req, 4) == [3, 9, 1, 2]


def test_ngram_proposer_no_match_is_empty():
    p = NGramProposer(n=3, min_n=2)
    assert p.propose(Request(uid=0, prompt=np.array([1, 2, 3, 4]), max_new_tokens=8), 4) == []
    with pytest.raises(ValueError):
        NGramProposer(n=1, min_n=2)


def test_oracle_proposer_replay_and_corruption():
    stream = list(range(10, 30))
    req = Request(uid=5, prompt=np.array([1, 2]), max_new_tokens=20)
    exact = OracleProposer({5: stream})
    assert exact.propose(req, 4) == stream[:4]
    req.generated.extend(stream[:3])
    assert exact.propose(req, 4) == stream[3:7]
    noisy = OracleProposer({5: stream}, accept_rate=0.0, seed=1)
    drafts = noisy.propose(req, 4)
    assert len(drafts) == 4 and all(d != t for d, t in zip(drafts, stream[3:7]))
    assert noisy.propose(req, 4) == drafts
    assert exact.propose(Request(uid=99, prompt=np.array([1]), max_new_tokens=4), 4) == []


@pytest.mark.parametrize("rate,seed", [(0.3, 0), (0.6, 7), (0.9, 3)])
def test_proposers_equal_jax_copies(rate, seed):
    """The port's proposers propose what the JAX package's do: the oracle
    corrupts the same positions, the n-gram lookup finds the same match."""
    rng = np.random.default_rng(seed)
    stream = rng.integers(0, 50, 40).tolist()
    prompt = rng.integers(0, 6, 30)
    for pos in range(0, 36, 5):
        reqs = [R(uid=3, prompt=prompt, max_new_tokens=40) for R in (Request, JRequest)]
        for r in reqs:
            r.generated.extend(stream[:pos])
        t, j = reqs
        assert (OracleProposer({3: stream}, rate, seed).propose(t, 4)
                == jspec.OracleProposer({3: stream}, rate, seed).propose(j, 4))
        assert NGramProposer().propose(t, 4) == jspec.NGramProposer().propose(j, 4)
