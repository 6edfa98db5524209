"""The engine's steps as they now run -- the inputs packed into one int32
buffer, and a body that builds what every layer reads alike (the visible
lengths per segment, the paged route, the cascade's member gather, routes
and merge targets) once per step -- against the computation they replace;
and, on the card, each step captured as a CUDA graph against the eager
step. The steps: the fast-path decode step, the chunk step, the
speculative verify step and blocking admission.

On the CPU (the kernels' plain versions), on the smoke configuration:

  * every fast-path decode step of a served run, on paged and dense
    caches, bf16, int8 and f8 pools, ``lean`` (fused and two-call), ``fixed``,
    ``ref`` and the cascade (fused K5, and the two-call path, whose merge
    grid now comes from the host): logits and cache equal bit for bit to
    the same step with every layer building its own operands, the
    two-call merge grid built on the device;
  * every chunk, verify and admission step of those runs and of four
    speculative ones: logits and cache equal bit for bit to the functions
    they wrap called eagerly (admission: prefill returning every layer's
    cache, then the whole-cache writes); speculative streams equal their
    plain counterparts';
  * the two-call cascade's host merge targets and grid give the device
    grid's bits;
  * greedy streams equal to the JAX engine's (paged lean, int8 lean, the
    cascade), run as tests/test_torch_engine.py runs it; bucketed bf16
    admission on dense and paged engines gives the JAX engine's streams and
    ``prefill_compiles`` (tests/test_scheduler.py:158-185);
  * graph keys: equal across ticks that hit the ``ScheduleCache``, one key
    for every binding of a cascade schedule, and different across backend,
    ``fused``, the fixed split, the cascade schedule and the pool's dtype;
    chunk keys per schedule, backend, pack shape and pool dtype, verify
    keys per block rows, admission keys per bucket; a schedule the cache
    evicts drops its decode, chunk and verify graph entries.

On the card (marked ``cuda``; ``python -m pytest -q -m cuda
tests/test_torch_step_capture.py``): the captured steps against the eager
ones (``capture_decode = False``) on the configurations above, with slots
joining and leaving: logits and pools equal bit for bit step by step,
streams and launch counters equal, one capture per key seen twice, every
replay under ``torch.cuda.set_sync_debug_mode("error")``; a decode or chunk
capture that fails raises; an evicted schedule's graph is dropped; a
replaced cache is captured anew.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro.serving.config import CascadeConfig as JCascade  # noqa: E402
from repro.serving.config import EngineConfig as JConfig, PagedConfig as JPaged  # noqa: E402
from repro.serving.config import SpecConfig as JSpec  # noqa: E402
from repro.serving.engine import DecodeEngine as JEngine, Request as JRequest  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.attention import kv_bytes  # noqa: E402
from repro_torch.core.merge import AttnPartial, merge_grid, segment_merge  # noqa: E402
from repro_torch.kernels import launches, ops  # noqa: E402
from repro_torch.kernels import lean_decode as ld  # noqa: E402
from repro_torch.kernels.lean_decode import CascadeFusedDesc  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    decode_step,
    prefill,
    prefill_chunks,
    verify_step,
)
from repro_torch.core.attention import (  # noqa: E402
    paged_gather_kv,
    paged_gather_kv_dequant,
    quantize_kv_blocks,
)
from repro_torch.core.leantile import bucket_length  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402
from repro_torch.serving.config import (  # noqa: E402
    CascadeConfig,
    EngineConfig,
    PagedConfig,
    SpecConfig,
)
from repro_torch.serving.engine import DecodeEngine, Request, _pack, _unpack  # noqa: E402

PROMPT_SEED = 25          # margin prompts, as tests/test_torch_scheduler.py
PS = 8
COMMON = dict(max_batch=2, cache_len=64, num_workers=4)
SCHED = dict(chunk_size=8, prefill_pack=2, token_budget=32)

# (name, engine config, drive): 'blocking' serves PROMPT_SEED's prompts
# through the engine's own tick loop (slots leave and the queue's next
# request joins); 'chunked' through the Scheduler with chunked prefill
# (prefilling slots masked out of the decode ticks); 'waves' the cascade's
# prefix-sharing waves through the Scheduler with the radix cache
CONFIGS = {
    "paged-lean": (dict(attn_backend="lean"), "blocking"),
    "paged-lean-two-call": (dict(attn_backend="lean", fused=False), "blocking"),
    "paged-lean-chunked": (dict(attn_backend="lean"), "chunked"),
    "paged-fixed": (dict(attn_backend="fixed"), "chunked"),
    "paged-ref": (dict(attn_backend="ref"), "blocking"),
    "dense-lean": (dict(attn_backend="lean", paged=dict(enabled=False)), "blocking"),
    "dense-lean-two-call": (dict(attn_backend="lean", fused=False, paged=dict(enabled=False)),
                            "blocking"),
    "dense-fixed": (dict(attn_backend="fixed", paged=dict(enabled=False)), "blocking"),
    "dense-ref": (dict(attn_backend="ref", paged=dict(enabled=False)), "blocking"),
    "int8-lean": (dict(attn_backend="lean", paged=dict(kv_dtype="int8")), "blocking"),
    "int8-lean-two-call": (dict(attn_backend="lean", fused=False, paged=dict(kv_dtype="int8")),
                           "chunked"),
    "int8-fixed": (dict(attn_backend="fixed", paged=dict(kv_dtype="int8")), "blocking"),
    "int8-ref": (dict(attn_backend="ref", paged=dict(kv_dtype="int8")), "blocking"),
    "f8-lean": (dict(attn_backend="lean", paged=dict(kv_dtype="f8")), "blocking"),
    "f8-fixed-chunked": (dict(attn_backend="fixed", paged=dict(kv_dtype="f8")), "chunked"),
    "cascade": (dict(attn_backend="lean", cascade=dict(fused=True)), "waves"),
    "cascade-two-call": (dict(attn_backend="lean", cascade=dict(fused=False)), "waves"),
    "cascade-int8": (dict(attn_backend="lean", cascade=dict(fused=True),
                          paged=dict(kv_dtype="int8")), "waves"),
}

# speculative engines (the default n-gram proposer): their verify steps,
# beside the decode, chunk and admission steps above; each serves the same
# requests as its plain counterpart (PLAIN_OF), with the same streams
SPEC_CONFIGS = {
    "spec-lean": (dict(attn_backend="lean", spec=dict(k=2)), "blocking"),
    "spec-int8-fixed": (dict(attn_backend="fixed", paged=dict(kv_dtype="int8"), spec=dict(k=2)),
                        "blocking"),
    "spec-ref-chunked": (dict(attn_backend="ref", spec=dict(k=3)), "chunked"),
    "spec-cascade": (dict(attn_backend="lean", cascade=dict(fused=True), spec=dict(k=2)),
                     "waves"),
}
PLAIN_OF = {"spec-lean": "paged-lean", "spec-int8-fixed": "int8-fixed",
            "spec-ref-chunked": "paged-ref", "spec-cascade": "cascade"}


@pytest.fixture(scope="module")
def model():
    cfg_j = jax_smoke("mistral-nemo-12b")
    cfg = get_smoke_config("mistral-nemo-12b")
    pj = jinit(jax.random.PRNGKey(0), cfg_j)
    return cfg_j, cfg, pj, params_from_numpy(jax.tree.map(np.asarray, pj), cfg, device="cpu")


def _engine_config(name, side="port"):
    kw, drive = {**CONFIGS, **SPEC_CONFIGS}[name]
    kw = dict(kw)
    paged = {"enabled": True, "page_size": PS, **kw.pop("paged", {})}
    casc = kw.pop("cascade", None)
    spec = kw.pop("spec", None)
    common = dict(COMMON, max_batch=4) if casc is not None else COMMON
    if side == "jax":
        Paged, Casc, Config, Spec = JPaged, JCascade, JConfig, JSpec
    else:
        Paged, Casc, Config, Spec = PagedConfig, CascadeConfig, EngineConfig, SpecConfig
    if spec is not None:
        kw["spec"] = Spec(enabled=True, **spec)
    if casc is not None:
        paged["prefix_cache"] = True
        kw["cascade"] = Casc(enabled=True, stable_ticks=1, **casc)
    return Config(paged=Paged(**paged), **common, **kw), drive


def _prompts(vocab, n=3, base=8, step=7):
    rng = np.random.default_rng(PROMPT_SEED)
    return [rng.integers(0, vocab, base + step * i) for i in range(n)]


def _waves(vocab):
    """Two requests, then three sharing their 24-token (three-page)
    prompt prefix, with tails of their own (tests/test_torch_cascade.py's
    waves, on its margin seed)."""
    rng = np.random.default_rng(PROMPT_SEED)
    shared = rng.integers(0, vocab, 24)
    w1 = [np.concatenate([shared, rng.integers(0, vocab, 5 + 3 * i)]) for i in range(2)]
    w2 = [np.concatenate([shared, rng.integers(0, vocab, 4 + 2 * i)]) for i in range(3)]
    return [w1, w2]


def _serve(eng, drive, vocab, side="port", new=4):
    """Serve ``drive``'s requests on ``eng``; returns the greedy streams."""
    if drive == "blocking":
        R = JRequest if side == "jax" else Request
        reqs = [R(uid=i, prompt=p, max_new_tokens=new) for i, p in enumerate(_prompts(vocab))]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion(max_ticks=100)
        assert all(r.done for r in reqs)
        return [tuple(r.generated) for r in reqs]
    m = jsched if side == "jax" else tsched
    sch = m.Scheduler(eng, m.SchedulerConfig(chunked=True, **SCHED))
    out = []
    for wave in (_waves(vocab) if drive == "waves" else [_prompts(vocab)]):
        hs = [sch.submit(p, max_new_tokens=new) for p in wave]
        sch.run_to_completion(max_steps=400)
        assert all(h.done for h in hs)
        out.extend(tuple(h.generated) for h in hs)
    return out


def _clone(cache):
    return [{k: t.clone() for k, t in lc.items()} for lc in cache]


def _per_layer_logits(eng, step, cache):
    """The step as every layer computed it before: each layer builds its
    own visible lengths per segment, route and -- in a cascade -- member
    gather, routes and (two-call) merge targets, whose grid
    ``segment_merge`` builds on the device."""
    h = {k: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
         for k, a in step.host.items()}
    n_kv, ptbl = eng.cfg.n_kv_heads, h.get("ptbl")
    if step.key[1] == "cascade":
        _, _, csched, fused, _ = step.key
        fdesc = (CascadeFusedDesc(*(h[f"fd_{n}"] for n in CascadeFusedDesc._fields))
                 if fused else None)

        def attn_fn(q, k, v, c, k_scales=None, v_scales=None):
            suffix = torch.clamp(c.to(torch.int32) - h["seq_prefix_len"], min=0)
            return ops.lean_decode_cascade_from_schedule(
                q, k, v, suffix.repeat_interleave(n_kv), h["prefix_lens"], h["members"],
                h["prefix_tbl"], h["suffix_tbl"], fdesc, csched, fused=fused,
                k_scales=k_scales, v_scales=v_scales)
    else:
        _, backend, sched, fused, num_splits = step.key
        attn_fn = None
        if backend == "lean" and ptbl is None:
            def attn_fn(q, k, v, c):
                return ops.lean_decode_from_schedule(q, k, v, c.repeat_interleave(n_kv), sched,
                                                     fused=fused)
        elif backend == "lean":
            def attn_fn(q, k, v, c, k_scales=None, v_scales=None):
                return ops.lean_decode_paged_from_schedule(
                    q, k, v, c.repeat_interleave(n_kv), ptbl, sched, fused=fused,
                    k_scales=k_scales, v_scales=v_scales)
        elif backend == "fixed":
            def attn_fn(q, k, v, c, k_scales=None, v_scales=None):
                seg, kw = c.repeat_interleave(n_kv), dict(num_splits=num_splits, tile=eng.tile)
                if k_scales is not None:
                    return ops.flash_decode_from_lens(
                        q.float(), paged_gather_kv_dequant(k, k_scales, ptbl),
                        paged_gather_kv_dequant(v, v_scales, ptbl), seg, **kw).to(q.dtype)
                if ptbl is not None:
                    k, v = paged_gather_kv(k, ptbl), paged_gather_kv(v, ptbl)
                return ops.flash_decode_from_lens(q, k, v, seg, **kw)
    logits, _ = decode_step(eng.params, eng.cfg, cache, h["tokens"], attn_fn=attn_fn,
                            ctx_lens=h["ctx"], page_tbl=ptbl)
    return logits


def _eager_function(eng, step, cache):
    """What a chunk, verify or admission step computed before it became a
    step, on ``cache`` (updated in place): the chunk step's and the verify
    step's model function (:func:`prefill_chunks`, :func:`verify_step`) on
    int64 tokens and tensors made from the host arrays, the engine's chunk
    attention built from them; admission's prefill at the bucket length
    returning every layer's cache padded to ``cache_len``, then copied into
    the dense row or scattered into the prompt's pages (int8: quantized,
    scales set). Returns the logits."""
    h = step.host
    if step.kind in ("chunk", "verify"):
        toks = torch.as_tensor(h["toks"].astype(np.int64))
        offs, lens, tbls = (torch.as_tensor(h[k]) for k in ("offs", "lens", "tbls"))
        forward = prefill_chunks if step.kind == "chunk" else verify_step
        logits, _ = forward(eng.params, eng.cfg, cache, toks, offs, lens, tbls,
                            attn_fn=eng._chunk_attn_fn(offs, lens, tbls, step.sched))
        return logits
    toks = torch.as_tensor(h["tokens"].astype(np.int64))
    logits, cache1, _ = prefill(eng.params, eng.cfg, toks, cache_len=eng.cache_len,
                                true_len=int(h["true_len"][0]))
    if "slot" in h:
        for lc, lc1 in zip(cache, cache1):
            for name in ("k", "v"):
                lc[name][int(h["slot"][0])].copy_(lc1[name][0])
        return logits
    pages = [int(p) for p in h["pages"] if p > 0]
    n, idx = len(pages), torch.as_tensor(pages)
    for lc, lc1 in zip(cache, cache1):
        for name in ("k", "v"):
            src = lc1[name][0]
            H, _, hd = src.shape
            chunks = src[:, :n * eng.tile].reshape(H, n, eng.tile, hd).movedim(1, 0)
            if eng.quant:
                q, sc = quantize_kv_blocks(
                    chunks, per_head=eng.cfg.kv_scale_granularity == "page_head")
                lc[name][idx] = q
                lc[f"{name}_scale"][idx] = sc
            else:
                lc[name][idx] = chunks.to(lc[name].dtype)
    return logits


class _CheckedEngine(DecodeEngine):
    """Holds every fast-path decode step to :func:`_per_layer_logits`, and
    every chunk, verify and admission step to :func:`_eager_function`, on a
    copy of the cache it started from: logits and cache bit for bit;
    records each decode step's key and counts the other kinds."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.keys = []
        self.kinds = {}

    def _run_step(self, step):
        if step.kind != "decode":
            before = _clone(self.cache)
            out = super()._run_step(step)
            assert torch.equal(out, _eager_function(self, step, before)), step.kind
            for lc, rc in zip(self.cache, before):
                for name in lc:
                    assert torch.equal(lc[name], rc[name]), (step.kind, name)
            self.kinds[step.kind] = self.kinds.get(step.kind, 0) + 1
            return out
        before = _clone(self.cache)
        logits = super()._run_step(step)
        ref = _per_layer_logits(self, step, before)
        assert torch.equal(logits, ref)
        for lc, rc in zip(self.cache, before):
            for name in lc:
                assert torch.equal(lc[name], rc[name]), name
        self.keys.append(self.last_step_key)
        return logits


def _port_run(model, name, cls=_CheckedEngine):
    _, cfg, _, pt = model
    config, drive = _engine_config(name)
    eng = cls(cfg, pt, config, device="cpu")
    streams = _serve(eng, drive, cfg.vocab_size)
    if eng.paged:
        eng.pool.check(scales=eng._kv_scale_arrays())
        assert eng.pool.num_allocated == 0 or eng.prefix_cache is not None
    return eng, streams


@pytest.fixture(scope="module")
def port_runs(model):
    return {}


def _cached_port_run(model, port_runs, name):
    if name not in port_runs:
        port_runs[name] = _port_run(model, name)
    return port_runs[name]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_step_equals_per_layer_computation(model, port_runs, name):
    """Every fast-path step of the run: logits and cache equal, bit for
    bit, to the step with per-layer operands (_CheckedEngine)."""
    eng, streams = _cached_port_run(model, port_runs, name)
    assert len(eng.keys) == eng.stats.ticks > 0
    if CONFIGS[name][1] == "waves":
        assert eng.stats.cascade_ticks > 0
        assert eng.stats.cascade_fused_ticks == (
            eng.stats.cascade_ticks if eng.cascade_fused else 0)


@pytest.mark.parametrize("name", sorted(CONFIGS) + sorted(SPEC_CONFIGS))
def test_chunk_verify_admit_steps_equal_eager_functions(model, port_runs, name):
    """Every chunk, verify and admission step of the run: logits and
    cache equal, bit for bit, to the functions the steps wrap called
    eagerly (_CheckedEngine, :func:`_eager_function`); each kind the drive
    runs was checked, once per step."""
    eng, _ = _cached_port_run(model, port_runs, name)
    st = eng.stats
    assert eng.kinds.get("admit", 0) == st.prefills
    assert eng.kinds.get("chunk", 0) == len(st.tick_prefill_tokens)
    assert eng.kinds.get("verify", 0) == st.spec_ticks
    drive = _engine_config(name)[1]
    assert eng.kinds.get("admit" if drive == "blocking" else "chunk", 0) > 0
    assert (st.spec_ticks > 0) == (name in SPEC_CONFIGS)


@pytest.mark.parametrize("name", sorted(SPEC_CONFIGS))
def test_spec_streams_equal_plain(model, port_runs, name):
    """A speculative engine serves its plain counterpart's requests with
    the same streams; its single-token decode steps (slots without room
    for the block) still match the per-layer computation."""
    _, streams = _cached_port_run(model, port_runs, name)
    _, plain = _cached_port_run(model, port_runs, PLAIN_OF[name])
    assert streams == plain


@pytest.mark.parametrize("name", ["paged-lean", "int8-lean", "cascade"])
def test_streams_equal_jax_engine(model, port_runs, name):
    """Greedy streams of the port's engine (paged lean, int8 lean, the
    fused cascade) equal the JAX engine's on the same margin prompts."""
    cfg_j, _, pj, _ = model
    config, drive = _engine_config(name, side="jax")
    jeng = JEngine(cfg_j, pj, config)
    jstreams = _serve(jeng, drive, cfg_j.vocab_size, side="jax")
    eng, streams = _cached_port_run(model, port_runs, name)
    assert streams == jstreams
    if drive == "waves":
        for k in ("cascade_ticks", "cascade_fused_ticks", "prefix_matched_tokens"):
            assert getattr(eng.stats, k) == getattr(jeng.stats, k), k


def test_cascade_host_merge_grid_gives_device_bits():
    """The two-call cascade's merge targets from the host binding
    (``cascade_merge_ids``) equal those the device path derives, and
    ``segment_merge`` on their host grid gives the device grid's bits."""
    from repro_torch.core.leantile import make_cascade_schedule

    Hkv, B = 2, 4
    csched, binding = make_cascade_schedule(
        [61, 40, 77, 9], [[0, 1, 2], [1, 2]], [3, 2], Hkv, PS, 6, page_starts=[0, 3],
        max_len=96)
    S = B * Hkv
    ids_np = ops.cascade_merge_ids(csched, binding.members)
    pre = csched.prefix_sched
    pseg = torch.as_tensor(pre.piece_seg.astype(np.int64))
    mem_p = torch.as_tensor(binding.members).long()[pseg // Hkv]
    tgt = torch.where(mem_p >= 0, mem_p * Hkv + (pseg % Hkv)[:, None], torch.full_like(mem_p, S))
    ids = torch.cat([tgt.T.reshape(-1), torch.as_tensor(csched.suffix_sched.piece_seg).long()])
    np.testing.assert_array_equal(ids.numpy(), ids_np)
    gen = torch.Generator().manual_seed(0)
    P, rows, d = ids.numel(), 4, 16
    part = AttnPartial(torch.randn(P, rows, d, generator=gen),
                       torch.randn(P, rows, generator=gen) * 3,
                       torch.rand(P, rows, generator=gen) + 0.5)
    part.m[::5] = float("-inf")          # pieces that saw no key
    dev_grid = segment_merge(part, ids, S)
    host_grid = segment_merge(part, ids, S, grid=merge_grid(ids_np, S, torch.device("cpu")))
    for a, b in zip(dev_grid, host_grid):
        assert torch.equal(a, b)


def _key_shape(key):
    """A step key with each schedule read as its signature: what two
    engines' keys share where their configurations agree."""
    step_key, layout = key
    return tuple(getattr(x, "signature", x) for x in step_key), layout


def _plain_keys(model, name, lens_list, **change):
    """The step keys an engine of config ``name`` (with ``change``) gives
    for the tick lengths in ``lens_list`` (one tick each)."""
    _, cfg, _, pt = model
    config, _ = _engine_config(name)
    eng = DecodeEngine(cfg, pt, dataclasses.replace(config, **change), device="cpu")
    keys = []
    for lens in lens_list:
        ctx = np.asarray(lens, dtype=np.int64)
        ptbl = eng.page_tbl if eng.paged else None
        sched = eng._tick_schedule(ctx)
        step = eng._plain_step(sched, ctx, ptbl, eng.attn_backend, eng.fused)
        keys.append((step.key, _pack(step.host)[1]))
    return keys


def test_graph_keys(model, port_runs):
    """Keys equal across ticks that hit the schedule cache (the same
    schedule object) and differ across backend, ``fused``, the fixed
    split, the pool's dtype and the layout; every binding of one cascade
    schedule shares its key, and two cascade schedules have two."""
    same = _plain_keys(model, "paged-lean", [[5, 9], [6, 10], [7, 11]])
    assert same[0] == same[1] == same[2]          # one bucket: a cache hit
    assert _plain_keys(model, "paged-lean", [[5, 40]])[0] != same[0]
    assert _key_shape(_plain_keys(model, "paged-lean", [[5, 9]])[0]) == _key_shape(same[0])
    others = [_plain_keys(model, n, [[5, 9]])[0] for n in
              ("paged-lean-two-call", "paged-fixed", "paged-ref", "int8-lean", "dense-lean")]
    assert len({_key_shape(k) for k in others + [same[0]]}) == 6
    fixed = _plain_keys(model, "paged-fixed", [[5, 9], [50, 9]], num_workers=16)
    (a, _), (b, _) = fixed
    assert a[4] != b[4] and a != b                 # another split, another key
    for name in ("cascade", "cascade-two-call", "cascade-int8"):
        casc = _cascade_keys(model, name, [
            ([30, 30, 14, 14], [[0, 1]]), ([14, 14, 30, 30], [[2, 3]]),   # one geometry
            ([30, 30, 30, 14], [[0, 1, 2]])])
        assert casc[0] == casc[1] != casc[2]
        assert len({_key_shape(k) for k in casc}) == 2


def _cascade_keys(model, name, ticks):
    """The step keys of cascade ticks ``(lengths, groups)`` (two shared
    pages from page 0) on an engine of config ``name``."""
    _, cfg, _, pt = model
    config, _ = _engine_config(name)
    eng = DecodeEngine(cfg, pt, config, device="cpu")
    keys = []
    for lens, groups in ticks:
        ctx = np.asarray(lens, dtype=np.int64)
        csched, binding = eng.sched_cache.get_cascade(
            (ctx + 1).tolist(), groups, [2] * len(groups), cfg.n_kv_heads, PS, eng.num_workers,
            max_len=eng.cache_len)
        step = eng._cascade_step(csched, binding, ctx, eng.page_tbl)
        keys.append((step.key, _pack(step.host)[1]))
    return keys


def test_evicted_schedule_drops_its_graph(model):
    """An engine keeps a (schedule, graph) entry per key; when the
    schedule cache evicts or clears a schedule, its entries go with it."""
    _, cfg, _, pt = model
    config, _ = _engine_config("paged-lean")
    eng = DecodeEngine(cfg, pt, dataclasses.replace(config, schedule_cache_entries=1),
                       device="cpu")
    s1 = eng._tick_schedule(np.asarray([5, 9]))
    eng._graphs[("k1",)] = (s1, "graph of s1")
    eng._graphs[("ref",)] = (None, "graph of no schedule")
    s2 = eng._tick_schedule(np.asarray([50, 9]))        # evicts s1
    assert s2 is not s1 and ("k1",) not in eng._graphs and ("ref",) in eng._graphs
    eng._graphs[("k2",)] = (s2, "graph of s2")
    eng.sched_cache.clear()
    assert list(eng._graphs) == [("ref",)]


def _chunk_key(eng, work, pack=2, cap=8):
    """The key of the chunk step ``eng`` runs for ``work`` ((slot, chunk
    length, offset), ...)."""
    eng.prefill_chunks_tick([(s, np.arange(n) % 7, off) for s, n, off in work], pack, cap)
    return eng.last_step_key


def _claimed(model, name, n=2, **change):
    _, cfg, _, pt = model
    config, _ = _engine_config(name)
    eng = DecodeEngine(cfg, pt, dataclasses.replace(config, **change), device="cpu")
    for i in range(n):
        slot = eng.claim_slot(Request(uid=i, prompt=np.arange(40), max_new_tokens=2))
        assert eng.ensure_chunk_pages(slot, 40)
    return eng


def test_chunk_verify_admit_keys(model):
    """Chunk steps share a key while their schedule bucket holds and differ
    across backend, pack shape and pool dtype; verify keys carry the block's
    rows; admission keys are the bucket length, and ``prefill_compiles``
    counts the distinct buckets."""
    eng = _claimed(model, "paged-lean")
    a = _chunk_key(eng, [(0, 8, 0), (1, 8, 0)])
    assert _chunk_key(eng, [(0, 8, 0), (1, 7, 1)]) == a            # one bucket
    assert _chunk_key(eng, [(0, 8, 24), (1, 8, 0)]) != a          # another schedule
    assert _chunk_key(eng, [(0, 8, 0)], pack=3) != a
    assert _chunk_key(eng, [(0, 8, 0)], cap=16) != a
    (key, layout) = a
    assert key[1] == "chunk" and key[3] is not None and layout[0][2] == (2, 8)
    others = [_chunk_key(_claimed(model, n), [(0, 8, 0), (1, 8, 0)])
              for n in ("paged-fixed", "paged-ref", "int8-lean")]
    assert len({_key_shape(k) for k in others + [a]}) == 4
    assert all(k[0][3] is None for k in others[:2])               # no schedule off lean

    verify = {}
    for k in (2, 4):
        eng = _claimed(model, "paged-lean", spec=SpecConfig(enabled=True, k=k))
        eng.ctx_lens[:2] = [9, 12]
        eng._spec_verify([0, 1])
        verify[k] = eng.last_step_key
        assert verify[k][0][1] == "verify" and verify[k][0][-1] == k + 1
    assert _key_shape(verify[2]) != _key_shape(verify[4])

    _, cfg, _, pt = model
    for name in ("paged-lean", "dense-lean"):
        config, _ = _engine_config(name)
        eng = DecodeEngine(cfg, pt, config, device="cpu")
        keys = {}
        for plen in (3, 7, 8, 9, 20, 30):
            eng.admit_blocking(Request(uid=plen, prompt=np.arange(plen), max_new_tokens=1), 0)
            keys[plen] = eng.last_step_key
            eng.release_slot(0)
        bucket = {n: bucket_length(n, eng.tile, max_len=eng.cache_len) for n in keys}
        for a in keys:
            for b in keys:
                assert (keys[a] == keys[b]) == (bucket[a] == bucket[b])
        assert {k[0][2] for k in keys.values()} == set(bucket.values())
        assert eng.stats.prefill_compiles == len(set(bucket.values()))
        assert eng.stats.prefill_compiles == (4 if eng.paged else 1)   # dense: tile 64


def test_evicted_schedule_drops_chunk_and_verify_graphs(model):
    """Chunk and verify graph entries go with their schedule, as decode
    ones do; admission entries run no schedule and stay."""
    eng = _claimed(model, "paged-lean", schedule_cache_entries=1,
                   spec=SpecConfig(enabled=True, k=2))
    entries = []
    for step in (eng._chunk_step("chunk", prefill_chunks, eng._tick_schedule(
                     np.asarray([7, 0])), *_chunk_host(eng)),
                 eng._admit_step(np.arange(5), 0, [1])):
        key = (step.key, _pack(step.host)[1])
        eng._graphs[key] = (step.sched, f"graph of {step.kind}")
        entries.append(key)
    eng.ctx_lens[:2] = [30, 3]
    eng._spec_verify([0, 1])                # another schedule: evicts the chunk's
    assert entries[0] not in eng._graphs and entries[1] in eng._graphs


def _chunk_host(eng):
    N, C, W = 2, 8, eng.pages_per_slot
    return (np.zeros((N, C), np.int32), np.zeros(N, np.int32), np.full(N, 8, np.int32),
            np.zeros((N, W), np.int32))


@pytest.mark.parametrize("paged", [False, True])
def test_bucketed_admission_equals_jax(model, paged):
    """Blocking admission at the reference's bucket length on bf16 pools
    (tests/test_scheduler.py:158-185): 13 prompt lengths through the dense
    or the paged ``ref`` engine give the JAX engine's streams, and
    ``prefill_compiles`` counts the distinct buckets as the JAX engine's
    does."""
    cfg_j, cfg, pj, pt = model
    rng = np.random.default_rng(PROMPT_SEED)
    lengths = list(range(3, 41, 3))
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lengths]
    kw = dict(max_batch=2, cache_len=64, attn_backend="ref")
    runs = []
    for side, Eng, Config, Paged, R in (
            ("port", DecodeEngine, EngineConfig, PagedConfig, Request),
            ("jax", JEngine, JConfig, JPaged, JRequest)):
        config = Config(paged=Paged(enabled=paged, page_size=PS if paged else None), **kw)
        eng = (Eng(cfg, pt, config, device="cpu") if side == "port"
               else Eng(cfg_j, pj, config))
        reqs = [R(uid=i, prompt=p, max_new_tokens=3) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion(max_ticks=200)
        runs.append((eng, [tuple(r.generated) for r in reqs]))
    (eng, streams), (jeng, jstreams) = runs
    assert streams == jstreams
    expected = {bucket_length(n, eng.tile, max_len=64) for n in lengths}
    assert eng.stats.prefill_compiles == jeng.stats.prefill_compiles == len(expected) <= 5


def test_packed_inputs_round_trip():
    """The step's host inputs in one int32 buffer: each 64-byte aligned,
    the views read back the arrays."""
    host = {"tokens": np.arange(3, dtype=np.int32).reshape(3, 1),
            "ctx": np.asarray([7, 0, 9], dtype=np.int32),
            "ptbl": np.arange(12, dtype=np.int32).reshape(3, 4) + 1}
    flat, layout = _pack(host)
    assert [o % 16 for _, o, _ in layout] == [0, 0, 0]
    views = _unpack(torch.from_numpy(flat), layout)
    for k, a in host.items():
        assert views[k].dtype == torch.int32 and np.array_equal(views[k].numpy(), a)


def test_launch_count_bookkeeping():
    """What the engine does around a capture: the counters' change is
    taken back out and added once per replay."""
    before = launches.snapshot()
    assert (ld, "fused_launches") in before and (ld, "cascade_ring_launches") in before
    ld.fused_launches += 40
    after = launches.snapshot()
    d = launches.delta(after, before)
    assert d == {(ld, "fused_launches"): 40}
    launches.restore(before)
    assert launches.snapshot() == before
    launches.add(d)
    launches.add(d)
    assert ld.fused_launches == before[(ld, "fused_launches")] + 80
    launches.restore(before)


def test_capture_needs_a_cuda_engine(model):
    _, cfg, _, pt = model
    config, _ = _engine_config("paged-lean")
    eng = DecodeEngine(cfg, pt, config, device="cpu")
    assert eng.capture_decode is False
    eng.capture_decode = True
    eng.submit(Request(uid=0, prompt=np.arange(5), max_new_tokens=2))
    with pytest.raises(ValueError, match="CUDA"):
        eng.tick()


# --------------------------------------------------------------------- card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_params(model, dev):
    _, cfg, _, pt = model
    conv = lambda t: t.to(dev)
    return {k: (conv(v) if torch.is_tensor(v) else
                [{kk: ({a: conv(b) for a, b in vv.items()} if isinstance(vv, dict) else conv(vv))
                  for kk, vv in layer.items()} for layer in v])
            for k, v in pt.items()}


class _TickLog(DecodeEngine):
    """Records each tick's logits rows of the slots it served, the cache
    after it, each fast-path step's key, and runs every replay under
    ``set_sync_debug_mode("error")``. The rows of idle and masked slots and
    the null page are not kept: those slots all write their token to the
    null page, in whichever order the device runs the writes, and read it
    back as their one visible key -- garbage by design, which the
    scheduler never reads."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.logits, self.keys, self.pools = [], [], []

    def _run_step(self, step):
        out = super()._run_step(step)
        if step.kind != "decode":
            return out
        self.keys.append(self.last_step_key)
        first = 1 if self.paged else 0
        self.pools.append([{k: t[first:].clone() for k, t in lc.items()} for lc in self.cache])
        return out

    def _emit_tokens(self, results, guard_on, spec=None):
        for active, _, _ in results:               # one pass: no guards here
            self.logits.append(self.last_logits[active].clone())
        return super()._emit_tokens(results, guard_on, spec)

    def _replay(self, rec, flat):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return super()._replay(rec, flat)
        finally:
            torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_captured_step_equals_eager_on_card(cuda, model, name):
    """The smoke engine on the card, eager (``capture_decode = False``)
    and captured, serving the same requests: each step's logits of the
    slots it served and the cache after it (the null page aside) bit for
    bit, equal streams and launch counters, one capture per key that
    ticked at least twice, replays with no host sync."""
    _, cfg, _, _ = model
    params = _card_params(model, cuda)
    config, drive = _engine_config(name)
    runs = {}
    for captured in (False, True):
        eng = _TickLog(cfg, params, config, device=cuda)
        eng.capture_decode = captured
        launches.restore({k: 0 for k in launches.snapshot()})
        streams = _serve(eng, drive, cfg.vocab_size)
        runs[captured] = (eng, streams, launches.snapshot())
    (e0, s0, c0), (e1, s1, c1) = runs[False], runs[True]
    assert s1 == s0 and c1 == c0
    assert [_key_shape(k) for k in e1.keys] == [_key_shape(k) for k in e0.keys]
    assert len(e1.logits) == len(e0.logits) > 0
    for t, (a, b) in enumerate(zip(e0.logits, e1.logits)):
        assert torch.equal(a, b), f"tick {t}: logits differ by {(a - b).abs().max().item()}"
    for t, (p0, p1) in enumerate(zip(e0.pools, e1.pools)):
        for i, (l0, l1) in enumerate(zip(p0, p1)):
            for k in l0:
                rows = (kv_bytes(l0[k]) != kv_bytes(l1[k])).flatten(1).any(1)  # f8: its bytes
                rows = rows.nonzero().flatten().tolist()
                assert not rows, f"tick {t}: layer {i} {k} differs in rows {rows}"
    twice = {k for k in e1.keys if e1.keys.count(k) >= 2}
    assert e1.stats.decode_captures == len(twice) > 0
    assert e1.stats.decode_replays == len(e1.keys) - len(set(e1.keys))
    assert e0.stats.decode_captures == e0.stats.decode_replays == 0


@pytest.mark.cuda
def test_graphs_drop_with_their_schedule_and_cache_on_card(cuda, model):
    """With one schedule cache entry, a new schedule evicts the old one and
    its graph; a cache replaced by copies is captured anew, and its step
    still gives the eager step's logits."""
    _, cfg, _, _ = model
    params = _card_params(model, cuda)
    config, _ = _engine_config("paged-lean")
    config = dataclasses.replace(config, schedule_cache_entries=1)
    eng = _TickLog(cfg, params, config, device=cuda)
    ref = _TickLog(cfg, params, config, device=cuda)
    ref.capture_decode = False
    for e in (eng, ref):
        for i, p in enumerate(_prompts(cfg.vocab_size, n=2)):
            e.submit(Request(uid=i, prompt=p, max_new_tokens=12))
        for _ in range(4):
            e.tick()
    assert eng.stats.decode_captures >= 1 and eng.stats.decode_replays >= 1
    sched = next(s for s, g in eng._graphs.values() if g is not None and s is not None)
    eng.sched_cache.clear()
    # admission graphs run no schedule and stay
    assert all(k[0][1] == "admit" for k in eng._graphs)
    assert sched not in [s for s, _ in eng._graphs.values()]
    captures = eng.stats.decode_captures
    for e in (eng, ref):
        e.tick()                     # warm-up of the schedule built anew
        e.tick()                     # its capture
    assert eng.stats.decode_captures == captures + 1
    eng.cache = _clone(eng.cache)
    for e in (eng, ref):
        e.tick()
    assert eng.stats.decode_captures == captures + 2
    for a, b in zip(eng.logits, ref.logits):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_capture_failure_raises_on_card(cuda, model, monkeypatch):
    """A step whose body cannot be captured (here: a host sync inside)
    raises at its capture; the engine does not fall back to eager."""
    import repro_torch.serving.engine as engine_mod

    _, cfg, _, _ = model
    params = _card_params(model, cuda)
    config, _ = _engine_config("paged-lean")
    eng = DecodeEngine(cfg, params, config, device=cuda)
    real = engine_mod.decode_step

    def syncing(*a, **kw):
        logits, cache = real(*a, **kw)
        logits.sum().item()
        return logits, cache

    monkeypatch.setattr(engine_mod, "decode_step", syncing)
    for r in _prompts(cfg.vocab_size, n=1):
        eng.submit(Request(uid=0, prompt=r, max_new_tokens=6))
    eng.tick()                       # admission + the key's eager warm-up tick
    with pytest.raises(RuntimeError):
        eng.tick()                   # its capture
    assert eng.stats.decode_captures == 0


class _KindLog(DecodeEngine):
    """Records, after every chunk, verify and admission step, its output
    rows of the rows it served (chunk and verify rows with tokens, the
    admission's one row) and the cache (the null page aside), and runs
    every replay under ``set_sync_debug_mode("error")``."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.steps = []

    def _run_step(self, step):
        out = super()._run_step(step)
        if step.kind == "decode":
            return out
        rows = out if step.kind == "admit" else out[torch.as_tensor(step.host["lens"] > 0)]
        first = 1 if self.paged else 0
        self.steps.append((step.kind, self.last_step_key, rows.clone(),
                           [{k: t[first:].clone() for k, t in lc.items()} for lc in self.cache]))
        return out

    def _replay(self, rec, flat):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return super()._replay(rec, flat)
        finally:
            torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["paged-lean-chunked", "paged-fixed", "int8-lean-two-call",
                                  "dense-lean", "int8-lean", "spec-lean", "spec-int8-fixed",
                                  "spec-ref-chunked"])
def test_captured_step_kinds_equal_eager_on_card(cuda, model, name):
    """Chunk, verify and admission steps on the card, eager and captured,
    the requests served twice (so that every admission bucket comes back):
    each step's served rows and the cache after it (the null page aside)
    bit for bit, equal streams and launch counters; each kind the drive
    runs captures a key seen twice and replays it after."""
    _, cfg, _, _ = model
    params = _card_params(model, cuda)
    config, drive = _engine_config(name)
    runs = {}
    for captured in (False, True):
        eng = _KindLog(cfg, params, config, device=cuda)
        eng.capture_decode = captured
        launches.restore({k: 0 for k in launches.snapshot()})
        streams = [_serve(eng, drive, cfg.vocab_size) for _ in range(2)]
        runs[captured] = (eng, streams, launches.snapshot())
    (e0, s0, c0), (e1, s1, c1) = runs[False], runs[True]
    assert s1 == s0 and c1 == c0
    assert [(k, _key_shape(key)) for k, key, _, _ in e1.steps] == [
        (k, _key_shape(key)) for k, key, _, _ in e0.steps]
    for t, ((kind, _, a, p0), (_, _, b, p1)) in enumerate(zip(e0.steps, e1.steps)):
        assert torch.equal(a, b), f"step {t} ({kind}): logits differ by {(a - b).abs().max()}"
        for i, (l0, l1) in enumerate(zip(p0, p1)):
            for k in l0:
                assert torch.equal(l0[k], l1[k]), f"step {t} ({kind}): layer {i} {k} differs"
    kinds = {"admit"} if drive == "blocking" else {"chunk"}
    kinds |= {"verify"} if name.startswith("spec") else set()
    for kind in kinds:
        keys = [key for k, key, _, _ in e1.steps if k == kind]
        twice = {key for key in keys if keys.count(key) >= 2}
        assert getattr(e1.stats, f"{kind}_captures") == len(twice) > 0, kind
        assert getattr(e1.stats, f"{kind}_replays") == len(keys) - len(set(keys)), kind
        assert getattr(e0.stats, f"{kind}_captures") == getattr(e0.stats, f"{kind}_replays") == 0


@pytest.mark.cuda
def test_chunk_capture_failure_raises_on_card(cuda, model, monkeypatch):
    """A chunk step whose body cannot be captured raises at its capture;
    the engine does not fall back to the eager step."""
    import repro_torch.serving.engine as engine_mod

    _, cfg, _, _ = model
    params = _card_params(model, cuda)
    eng = DecodeEngine(cfg, params, _engine_config("paged-lean")[0], device=cuda)
    real = engine_mod.prefill_chunks

    def syncing(*a, **kw):
        logits, cache = real(*a, **kw)
        logits.sum().item()
        return logits, cache

    monkeypatch.setattr(engine_mod, "prefill_chunks", syncing)
    for i in range(2):
        slot = eng.claim_slot(Request(uid=i, prompt=np.arange(40), max_new_tokens=2))
        assert eng.ensure_chunk_pages(slot, 40)
    work = [(0, np.arange(8), 0), (1, np.arange(8), 0)]
    eng.prefill_chunks_tick(work, 2, 8)          # the key's eager warm-up
    with pytest.raises(RuntimeError):
        eng.prefill_chunks_tick(work, 2, 8)      # its capture
    assert eng.stats.chunk_captures == 0


@pytest.mark.cuda
def test_capture_survives_the_cyclic_collector_on_card(cuda, model, monkeypatch):
    """Graphs of an engine dropped earlier wait in a reference cycle for
    the cyclic collector; if it runs while another step is being captured,
    destroying them invalidates that capture. Here the dropped graphs sit
    in a fresh cycle and the collector is set to run at the next
    allocation from inside the captured step: the capture still succeeds
    (the engine holds the collector off while it captures) and replays."""
    import gc

    import repro_torch.serving.engine as engine_mod

    _, cfg, _, _ = model
    params = _card_params(model, cuda)
    config, drive = _engine_config("paged-lean")
    old = DecodeEngine(cfg, params, config, device=cuda)
    _serve(old, drive, cfg.vocab_size)
    recs = [g for _, g in old._graphs.values() if g is not None]
    assert recs
    old._graphs.clear()
    del old
    real = engine_mod.decode_step

    def collect_soon(*a, **kw):
        if torch.cuda.is_current_stream_capturing():
            gc.set_threshold(1)
        return real(*a, **kw)

    monkeypatch.setattr(engine_mod, "decode_step", collect_soon)
    thresholds = gc.get_threshold()
    gc.set_threshold(10**9)
    try:
        junk = {"graphs": recs}
        junk["cycle"] = junk
        del recs, junk                    # cyclic garbage holding CUDA graphs
        eng = DecodeEngine(cfg, params, config, device=cuda)
        streams = _serve(eng, drive, cfg.vocab_size)
    finally:
        gc.set_threshold(*thresholds)
    assert eng.stats.decode_captures > 0 and eng.stats.decode_replays > 0
    ref = DecodeEngine(cfg, params, config, device=cuda)
    ref.capture_decode = False
    assert _serve(ref, drive, cfg.vocab_size) == streams
