"""The port's copy of the radix prefix cache (``repro_torch.serving.
prefix_cache``) against the JAX package's, driven in lockstep: one seeded
sequence of insert, match, share, evict and release on a pool of each
package must give the same matches, pages, statistics and ``check()``
verdicts at every step. ``lcp_group_passes`` must give equal passes."""
import numpy as np
import pytest

from repro.serving import kvpool as jkv
from repro.serving import prefix_cache as jpc
from repro_torch.serving import kvpool as tkv
from repro_torch.serving import prefix_cache as tpc


def _pair(usable, ps):
    out = []
    for kv, pc in ((jkv, jpc), (tkv, tpc)):
        layout = kv.KVLayout(kv_dtype="bf16", n_kv_heads=2, head_dim=8, page_size=ps,
                             n_attn_layers=1)
        pool = kv.KVPagePool(usable + 1, page_size=ps, layout=layout)
        out.append((pool, pc.RadixPrefixCache(pool)))
    return out


def _same(sides, what):
    (pj, cj), (pt, ct) = sides
    assert pj.as_dict() == pt.as_dict(), what
    assert cj.as_dict() == ct.as_dict(), what
    for pool, cache in sides:
        pool.check()
        cache.check()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_radix_cache_matches_reference_under_churn(seed):
    """Donate (alloc, insert, release), match + share + alloc, preempt
    (release without donating) and evict, chosen from one seeded stream and
    applied to both packages; both end drained."""
    rng = np.random.default_rng(seed)
    ps, vocab = 4, 6
    sides = _pair(usable=20, ps=ps)
    roots = [rng.integers(0, vocab, 8).tolist() for _ in range(3)]
    live, donated, uid = {}, [], 0
    for step in range(80):
        r = rng.random()
        if r < 0.45:
            # a new request: a shared root, or a finished request's tokens
            # (whose partial tail page it may match), plus a random tail
            base = (donated[int(rng.integers(0, len(donated)))] if donated and r < 0.15
                    else roots[int(rng.integers(0, 3))])
            toks = base + rng.integers(0, vocab, int(rng.integers(0, 9))).tolist()
            key = f"r{uid}"
            uid += 1
            got = []
            for pool, cache in sides:
                m = cache.match(toks)
                matched = min(m.matched_tokens, len(toks) - 1)
                keep = -(-matched // ps) if matched > 0 else 0
                if keep:
                    pool.share(key, m.pages[:keep])
                need = -(-len(toks) // ps) - keep
                pages = pool.alloc(key, need) if need else []
                if pages is None:
                    cache.evict(need)
                    if pool.holds(key):
                        pool.free_seq(key)
                got.append((m.pages, m.matched_tokens, m.tail_partial, pages))
            assert got[0] == got[1], f"step {step}: match/alloc differ"
            if got[0][3] is not None:
                live[key] = toks
        elif r < 0.75 and live:
            key = list(live)[int(rng.integers(0, len(live)))]
            toks = live.pop(key)
            donated.append(toks)
            took = [cache.insert(toks, pool.pages_of(key)) for pool, cache in sides]
            assert took[0] == took[1]
            for pool, _ in sides:
                pool.free_seq(key)
        elif r < 0.9 and live:
            key = list(live)[int(rng.integers(0, len(live)))]
            live.pop(key)
            for pool, _ in sides:
                pool.free_seq(key, eviction=True)
        else:
            n = int(rng.integers(1, 4))
            freed = [cache.evict(n) for _, cache in sides]
            assert freed[0] == freed[1]
        _same(sides, f"step {step}")
    for key in live:
        for pool, _ in sides:
            pool.free_seq(key)
    dropped = [cache.drop_all() for _, cache in sides]
    assert dropped[0] == dropped[1]
    _same(sides, "drained")
    for pool, _ in sides:
        assert pool.num_allocated == 0


@pytest.mark.parametrize("multi_level", [True, False])
def test_lcp_group_passes_equal(multi_level):
    rng = np.random.default_rng(5)
    for _ in range(40):
        chains = [rng.integers(1, 50, 6).tolist() for _ in range(2)]
        paths = {}
        for s in range(int(rng.integers(1, 7))):
            c = chains[int(rng.integers(0, 2))]
            cut = int(rng.integers(0, 7))
            tail = rng.integers(100, 200, int(rng.integers(0, 3))).tolist()
            paths[s] = tuple(c[:cut] + tail)
        for min_group in (2, 3):
            assert tpc.lcp_group_passes(paths, multi_level=multi_level, min_group=min_group) == \
                jpc.lcp_group_passes(paths, multi_level=multi_level, min_group=min_group)


def test_register_metrics_matches_reference():
    """The radix cache's gauges in each package's metrics registry, after
    the same donation and lookups: equal exports."""
    from repro.obs.metrics import MetricsRegistry as JRegistry
    from repro_torch.obs.metrics import MetricsRegistry as TRegistry

    sides = _pair(usable=8, ps=4)
    regs = []
    for (pool, cache), Registry in zip(sides, (JRegistry, TRegistry)):
        reg = Registry()
        cache.register_metrics(reg)
        pages = pool.alloc("a", 3)
        cache.insert(list(range(12)), pages)
        pool.free_seq("a")
        for toks in (list(range(10)), [9, 9, 9, 9], list(range(4)) + [7]):
            cache.match(toks)
        regs.append(reg)
    assert regs[1].to_prometheus() == regs[0].to_prometheus()
    d = regs[1].as_dict()
    assert d["prefix_cache_cached_pages"] == 3 and 0 < d["prefix_cache_hit_rate"] < 1
