"""The port's copies of the self-healing policy and the fault injector
(``repro_torch.serving.guards`` / ``faults``) against the JAX package's,
and the port engine's page fill against the reference's ``_fill_page``.

The copies import nothing of the JAX package, so each test drives both with
the same inputs: the taxonomy and the config validations give the same
answers; the same specs and seed give the same fire sequence, ``choose``
picks and ``as_dict`` over a few hundred opportunities; ``corrupt_trie_node``
picks the same victim on identical tries; and a NaN or 0.0 fill of one page
gives equal pools (NaN positions equal) on bf16, int8 and f8 pages.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.models.transformer import init_paged_cache as jinit_paged  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import faults as jfaults  # noqa: E402
from repro.serving import guards as jguards  # noqa: E402
from repro.serving import kvpool as jkv  # noqa: E402
from repro.serving import prefix_cache as jpc  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import cache_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.serving import faults as tfaults  # noqa: E402
from repro_torch.serving import guards as tguards  # noqa: E402
from repro_torch.serving import kvpool as tkv  # noqa: E402
from repro_torch.serving import prefix_cache as tpc  # noqa: E402
from repro_torch.serving.config import EngineConfig, PagedConfig  # noqa: E402
from repro_torch.serving.engine import DecodeEngine  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

SIDES = (jguards, tguards)


# ------------------------------------------------------------ error taxonomy
@pytest.mark.parametrize("name", ["ServingError", "RetryableError", "PoisonError",
                                  "FatalError", "FatalInvariantError", "ValueError"])
def test_classify_matches_reference(name):
    got = []
    for g in SIDES:
        exc = getattr(g, name, ValueError)("x")
        got.append(g.classify(exc))
        if name != "ValueError":
            assert issubclass(type(exc), RuntimeError)
    assert got[0] == got[1]


def test_taxonomy_constants_match_reference():
    assert tguards.DEGRADE_LEVELS == jguards.DEGRADE_LEVELS
    assert tguards.DEGRADE_CAUSES == jguards.DEGRADE_CAUSES
    assert tguards.MAX_DEGRADE == jguards.MAX_DEGRADE
    assert tfaults.FAULT_POINTS == jfaults.FAULT_POINTS
    assert ([f.name for f in dataclasses.fields(tguards.GuardConfig)]
            == [f.name for f in dataclasses.fields(jguards.GuardConfig)])
    assert tguards.GuardConfig() == tguards.GuardConfig(**dataclasses.asdict(
        jguards.GuardConfig()))


@pytest.mark.parametrize("kw", [
    {}, dict(heal_after=0), dict(poison_after=0), dict(max_degrade=4), dict(max_degrade=-1),
    dict(max_degrade=2, audit_interval=5, audit_action="log"), dict(audit_interval=-1),
    dict(audit_action="explode"),
])
def test_guard_config_validation_matches_reference(kw):
    verdicts = []
    for g in SIDES:
        try:
            g.GuardConfig(**kw)
            verdicts.append("ok")
        except ValueError as e:
            verdicts.append(str(e))
    assert verdicts[0] == verdicts[1]


@pytest.mark.parametrize("kw", [
    dict(rate=0.5, start=2, stop=9, burst=3), dict(rate=1.5), dict(rate=-0.1),
    dict(rate=0.5, burst=0), dict(rate=0.5, start=5, stop=4),
])
def test_fault_spec_validation_matches_reference(kw):
    verdicts = []
    for f in (jfaults, tfaults):
        try:
            f.FaultSpec(**kw)
            verdicts.append("ok")
        except ValueError as e:
            verdicts.append(str(e))
    assert verdicts[0] == verdicts[1]


def test_injector_rejects_unknown_point():
    for f in (jfaults, tfaults):
        with pytest.raises(ValueError, match="unknown injection point"):
            f.FaultInjector({"page_allocz": f.FaultSpec(rate=1.0)})


# ------------------------------------------------------------- fault injector
SPEC_SETS = [
    {"page_alloc": dict(rate=0.3)},
    {"page_alloc": dict(rate=0.5, start=2, stop=40, burst=2),
     "cow_clone": dict(rate=0.7, start=2, stop=40)},
    {"nan_output": dict(rate=1.0, start=6, stop=8), "nan_kv": dict(rate=1.0, start=6, max_fires=1),
     "preempt_storm": dict(rate=1.0, start=5, max_fires=1, magnitude=2)},
    {p: dict(rate=0.2, start=3, stop=60, burst=3) for p in jfaults.FAULT_POINTS},
]


def _drive(f, specs, seed, plan):
    """One injector of module ``f`` through ``plan``: per tick, an advance
    and a list of (point, choose count) opportunities; a ``stop_all``
    three quarters of the way. Returns every fire verdict, every pick and the final ``as_dict``."""
    inj = f.FaultInjector({p: f.FaultSpec(**kw) for p, kw in specs.items()}, seed=seed)
    log = []
    for i, ops in enumerate(plan):
        if i == len(plan) * 3 // 4:
            inj.stop_all()
        inj.advance()
        for point, n in ops:
            fired = inj.fire(point)
            log.append((point, fired))
            if fired and n:
                log.append(tuple(inj.choose(list(range(2 * n + 1)), n)))
            if point == "trie_corrupt" and fired:
                log.append(int(inj.rng(point).integers(1000)))
    return log, inj.as_dict()


@pytest.mark.parametrize("seed", [0, 6, 11])
@pytest.mark.parametrize("which", range(len(SPEC_SETS)))
def test_injector_sequence_matches_reference(which, seed):
    specs = SPEC_SETS[which]
    rng = np.random.default_rng(100 + seed)
    points = list(jfaults.FAULT_POINTS)
    plan = [[(points[int(rng.integers(len(points)))], int(rng.integers(0, 4)))
             for _ in range(int(rng.integers(1, 7)))] for _ in range(80)]
    ref, ref_d = _drive(jfaults, specs, seed, plan)
    got, got_d = _drive(tfaults, specs, seed, plan)
    assert sum(1 for e in ref if isinstance(e, tuple) and len(e) == 2) >= 200
    assert got == ref
    assert got_d == ref_d


def test_injector_disabled_and_stop_all_match_reference():
    out = []
    for f in (jfaults, tfaults):
        inj = f.FaultInjector({"page_alloc": f.FaultSpec(rate=1.0)}, enabled=False)
        inj.advance()
        a = inj.fire("page_alloc")
        inj2 = f.FaultInjector({"cow_clone": f.FaultSpec(rate=1.0, burst=8)})
        inj2.advance()
        b = inj2.fire("cow_clone")
        inj2.stop_all()
        out.append((a, inj.as_dict(), b, inj2.fire("cow_clone"), inj2.as_dict()))
    assert out[0] == out[1]
    assert out[1][2] and not out[1][0] and not out[1][3]


# ---------------------------------------------------------- trie corruption
def _trie(kv, pc, seed):
    layout = kv.KVLayout(kv_dtype="bf16", n_kv_heads=2, head_dim=8, page_size=2, n_attn_layers=1)
    pool = kv.KVPagePool(64, page_size=2, layout=layout)
    cache = pc.RadixPrefixCache(pool)
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 50, 8).tolist()
    for i in range(5):
        toks = base[: 2 * int(rng.integers(1, 4))] + rng.integers(0, 50, 2 * (i % 3 + 1)).tolist()
        pages = pool.alloc(("donor", i), len(toks) // 2)
        cache.insert(toks, pages)
        pool.free_seq(("donor", i))
    return pool, cache


def _blocks(cache):
    out = []

    def walk(node, depth):
        for key in sorted(node.children):
            child = node.children[key]
            out.append((depth, key, tuple(child.block), child.page))
            walk(child, depth + 1)

    walk(cache.root, 0)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_corrupt_trie_node_picks_the_reference_victim(seed):
    sides = [_trie(jkv, jpc, seed), _trie(tkv, tpc, seed)]
    assert _blocks(sides[0][1]) == _blocks(sides[1][1])
    for f, (pool, cache) in zip((jfaults, tfaults), sides):
        assert f.corrupt_trie_node(cache, np.random.default_rng(seed))
        with pytest.raises(AssertionError):
            cache.check()
    assert _blocks(sides[0][1]) == _blocks(sides[1][1])
    for pool, cache in sides:
        cache.repair()
        cache.check()
        pool.check()
        assert pool.num_allocated == 0


# ---------------------------------------------------------------- page fill
@pytest.fixture(scope="module")
def model():
    cfg_j = jax_smoke("mistral-nemo-12b")
    cfg = get_smoke_config("mistral-nemo-12b")
    pj = jinit(jax.random.PRNGKey(0), cfg_j)
    return cfg_j, cfg, params_from_numpy(jax.tree.map(np.asarray, pj), cfg, device="cpu")


NUM_PAGES, PAGE = 6, 8


def _random_pools(cfg_j, seed):
    """A JAX paged cache (numpy leaves) with every pool and scale filled
    from a seeded generator: int8 content, positive float32 scales, bf16
    values."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jinit_paged(cfg_j, 2, 32, NUM_PAGES, PAGE))

    def fill(a):
        if a.dtype == np.int8:
            return rng.integers(-127, 128, a.shape).astype(np.int8)
        if a.dtype == np.float32:
            return rng.uniform(0.01, 1.0, a.shape).astype(np.float32)
        return np.asarray(jnp.asarray(rng.standard_normal(a.shape), a.dtype))

    return jax.tree.map(fill, tree)


def _as_f32(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype != torch.int8 else t.numpy()


@pytest.mark.parametrize("value", [float("nan"), 0.0])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "f8"])
def test_fill_page_matches_reference(model, kv_dtype, value):
    cfg_j, cfg, pt = model
    cfg_j = dataclasses.replace(cfg_j, kv_cache_dtype=kv_dtype)
    cfg_t = dataclasses.replace(cfg, kv_cache_dtype=kv_dtype)
    tree = _random_pools(cfg_j, seed=3)
    page = 4
    filled = jengine._fill_page(jax.tree.map(jnp.asarray, tree), jnp.asarray(page, jnp.int32),
                                jnp.asarray(value, jnp.float32), cfg=cfg_j)
    want = cache_from_numpy(jax.tree.map(np.asarray, filled), cfg_t, device="cpu")
    eng = DecodeEngine(cfg, pt, EngineConfig(
        max_batch=2, cache_len=32, num_workers=4,
        paged=PagedConfig(enabled=True, page_size=PAGE, num_pages=NUM_PAGES, kv_dtype=kv_dtype)),
        device="cpu")
    eng.cache = cache_from_numpy(tree, cfg_t, device="cpu")
    tensors = [t for lc in eng.cache for t in lc.values()]
    eng._fill_page(page, value)
    assert [t for lc in eng.cache for t in lc.values()] == tensors    # in place
    assert len(want) == len(eng.cache) == cfg.n_layers
    for lw, lt in zip(want, eng.cache):
        assert set(lw) == set(lt) == ({"k", "v", "k_scale", "v_scale"} if kv_dtype == "int8"
                                      else {"k", "v"})
        for name in lw:
            a, b = _as_f32(lw[name]), _as_f32(lt[name])
            assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True), name
            filled_page = b[page]
            if name in ("k", "v") and kv_dtype == "int8":
                assert (filled_page == 0).all()
            elif value == 0.0:
                assert (filled_page == 0).all()
            else:
                assert np.isnan(filled_page).all()
            others = np.delete(b, page, axis=0)
            assert np.isfinite(others.astype(np.float32)).all()
