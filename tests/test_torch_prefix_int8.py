"""Prefix sharing on int8 pages: why a shared run and an unshared run of the
same waves read different int8 pages -- in the JAX engine and in the port
alike.

An int8 page carries one float32 scale per KV head, and the quantizing write
only grows it (``repro/core/attention.py`` ``paged_scatter_tokens_quant``:
a scatter-max of the new tokens' ``amax / 127`` into the page's scale row,
then the page's content requantized to the grown scale). Neither engine sets
a page's scale back when the pool hands the page out again, so a recycled
page starts from the scale its last owner left. In the shared run, wave 2
reads the system prompt's pages that wave 1 wrote onto fresh pages (scale
0). In the unshared run, each wave-2 request writes its own copy of the
system prompt onto the pages wave 1 freed, in another order (two requests
prefill side by side and take the freed pages in turn), so most of them
start from a scale larger than their new content needs, quantize it
coarser, and the first-token logits move. On the card the same holds at
full width (``chip_smoke.py --prefix-step``): two of Mistral-NeMo-12B's
wave-2 requests read system-prompt pages up to 40 int8 steps apart between
the runs; with such pools, a first-token row that holds an exact tie can
pick another token in each run, which is what parts the int8
prefix-serving comparison at 24 layers. ROADMAP queue 3 keeps it among the
known problems in the reference.

Held here at smoke width on the ``ref`` backend (the mechanism is in the
page write, which every backend shares, not in a kernel), with max one new
token a request (no decode write), the Scheduler at chunk 8 = the page
size (every page written whole):

  * the JAX engine's system-prompt pages differ between its shared and
    unshared runs (scales and int8 values), and agree once every page the
    pool hands out starts from scale 0 (``fresh`` runs);
  * the port's pages equal the JAX engine's in each of the three runs,
    within ``test_torch_quant_kv``'s tolerance (scales one float32 ulp, int8
    values one step: XLA computes ``amax / 127`` as ``amax * (1 / 127)``);
  * the port's first-token logits part between shared and unshared int8
    runs, and not between the shared run and the fresh one, nor between
    shared and unshared bf16 runs.

And the card's comparison itself (``chip_smoke.prefix_logit_gaps``) on
synthetic rows: it pairs a request's rows only while both runs follow the
same tokens -- after a first-token flip only the first-token row.
"""
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro.serving.config import EngineConfig as JConfig, PagedConfig as JPaged  # noqa: E402
from repro.serving.engine import DecodeEngine as JEngine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import cache_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402
from repro_torch.serving.config import EngineConfig, PagedConfig  # noqa: E402
from repro_torch.serving.engine import DecodeEngine  # noqa: E402

PS = 8                      # page size = chunk size: every page written whole
SYSTEM = 4 * PS             # the shared system prompt, four pages
TAILS = ((5,), (3, 6))      # wave 1, then wave 2 (two requests side by side)
MODES = ("shared", "unshared", "fresh")
COMMON = dict(attn_backend="ref", max_batch=4, cache_len=64, num_workers=4)
SCHED = dict(chunk_size=PS, prefill_pack=2, token_budget=2 * PS)
WAVE2 = (1, 2)              # uids of wave 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    cfg_j = jax_smoke("mistral-nemo-12b")
    cfg = get_smoke_config("mistral-nemo-12b")
    pj = jinit(jax.random.PRNGKey(0), cfg_j)
    return cfg_j, cfg, pj, params_from_numpy(jax.tree.map(np.asarray, pj), cfg, device="cpu")


def _waves(vocab):
    rng = np.random.default_rng(11)
    system = rng.integers(0, vocab, SYSTEM).astype(np.int32)
    return [[np.concatenate([system, rng.integers(0, vocab, n).astype(np.int32)])
             for n in wave] for wave in TAILS]


def _recording(base, pages_of):
    """``base`` keeping, as each request's prompt completes, its
    system-prompt pages (ids and every layer's K, V and scales, through
    ``pages_of(engine, ids)``) and, where the engine has them, its
    first-token logits."""

    class Recorder(base):
        def prefill_chunks_tick(self, work, pack_width, chunk_cap):
            out = super().prefill_chunks_tick(work, pack_width, chunk_cap)
            for i, (slot, chunk, off) in enumerate(work):
                req = self.slot_req[slot]
                if off + len(chunk) == len(req.prompt):
                    ids = self.page_tbl[slot, :SYSTEM // PS].copy()
                    self.snaps[req.uid] = (ids, pages_of(self, ids))
                    if hasattr(self, "last_prefill_logits"):
                        self.first_rows[req.uid] = self.last_prefill_logits[i].float().clone()
            return out

    return Recorder


def _port_pages(eng, ids):
    idx = torch.as_tensor(ids.astype(np.int64))
    return [{k: t[idx].clone() for k, t in lc.items()} for lc in eng.cache]


def _jax_pages(cfg):
    def pages_of(eng, ids):
        cache = cache_from_numpy(jax.tree.map(np.asarray, eng.cache), cfg, device="cpu")
        idx = torch.as_tensor(ids.astype(np.int64))
        return [{k: t[idx].clone() for k, t in lc.items()} for lc in cache]
    return pages_of


def _fresh_scales(eng, zero):
    """Every page the engine's pool hands out starts from scale 0."""
    alloc = eng._pool_alloc

    def fresh(seq, n):
        got = alloc(seq, n)
        if got:
            zero(eng, got)
        return got

    eng._pool_alloc = fresh


def _zero_port(eng, pages):
    idx = torch.as_tensor(pages)
    for lc in eng.cache:
        for name in ("k_scale", "v_scale"):
            lc[name][idx] = 0.0


def _zero_jax(eng, pages):
    idx = jnp.asarray(pages, jnp.int32)
    eng.cache = jax.tree_util.tree_map_with_path(
        lambda path, a: a.at[:, idx].set(0.0) if str(path[-1].key).endswith("_scale") else a,
        eng.cache)


def _serve(eng, sched_mod, waves):
    sch = sched_mod.Scheduler(eng, sched_mod.SchedulerConfig(**SCHED))
    uid = 0
    for wave in waves:
        for p in wave:
            sch.submit(p, 1, uid=uid)
            uid += 1
        sch.run_to_completion(max_steps=200)
    assert not sch.pending
    return eng


def _run(model, framework, mode, kv_dtype="int8"):
    cfg_j, cfg, pj, pt = model
    paged = dict(enabled=True, page_size=PS, kv_dtype=kv_dtype, prefix_cache=mode == "shared")
    if framework == "jax":
        eng = _recording(JEngine, _jax_pages(cfg))(cfg_j, pj, JConfig(**COMMON,
                                                                      paged=JPaged(**paged)))
        zero, sched_mod = _zero_jax, jsched
    else:
        eng = _recording(DecodeEngine, _port_pages)(
            cfg, pt, EngineConfig(**COMMON, paged=PagedConfig(**paged)), device="cpu")
        zero, sched_mod = _zero_port, tsched
    eng.snaps, eng.first_rows = {}, {}
    if mode == "fresh":
        _fresh_scales(eng, zero)
    return _serve(eng, sched_mod, _waves(cfg.vocab_size))


@pytest.fixture(scope="module")
def runs(model):
    return {(fw, mode): _run(model, fw, mode) for fw in ("jax", "port") for mode in MODES}


def _pages_close(a, b):
    """Scales within one float32 ulp and int8 values within one step."""
    for la, lb in zip(a, b):
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(la[name].numpy(), lb[name].numpy(), rtol=2**-23, atol=0)
        for name in ("k", "v"):
            assert (la[name].int() - lb[name].int()).abs().max().item() <= 1, name


def _largest_gap(a, b):
    """Largest relative scale difference and int8 difference of two
    copies of the pages."""
    rel = steps = 0.0
    for la, lb in zip(a, b):
        for name in ("k", "v"):
            sa, sb = la[name + "_scale"], lb[name + "_scale"]
            rel = max(rel, ((sa - sb).abs() / sb.clamp(min=1e-30)).max().item())
            steps = max(steps, (la[name].int() - lb[name].int()).abs().max().item())
    return rel, steps


@pytest.mark.parametrize("uid", WAVE2)
def test_jax_unshared_pages_start_from_recycled_scales(runs, uid):
    """In the JAX engine, wave 2's system-prompt pages of the unshared run
    carry other scales than the shared run's and int8 values several steps
    off -- in layer 0, whose K/V depend on the tokens alone, scales at or
    above the shared run's (a scale only grows); with fresh scales they
    agree with the shared run's."""
    _, shared = runs[("jax", "shared")].snaps[uid]
    _, unshared = runs[("jax", "unshared")].snaps[uid]
    _, fresh = runs[("jax", "fresh")].snaps[uid]
    rel, steps = _largest_gap(unshared, shared)
    assert rel > 0.05 and steps > 2
    for name in ("k_scale", "v_scale"):
        assert bool((unshared[0][name] >= shared[0][name] * (1 - 2**-23)).all())
    assert _largest_gap(unshared[:1], shared[:1])[0] > 0.05
    _pages_close(fresh, shared)


@pytest.mark.parametrize("mode", MODES)
def test_port_pages_match_jax(runs, mode):
    """The port writes the JAX engine's pages in every run: the same page
    ids, and the same content within the module tolerance."""
    for uid in (0,) + WAVE2:
        jids, jpages = runs[("jax", mode)].snaps[uid]
        tids, tpages = runs[("port", mode)].snaps[uid]
        np.testing.assert_array_equal(tids, jids)
        _pages_close(tpages, jpages)


def test_port_first_token_logits_part_on_int8_only(model, runs):
    """The port's first-token logits of wave 2: the unshared int8 run parts
    from the shared one; the fresh-scale run and bf16 pages do not."""
    gap = lambda a, b, u: (a.first_rows[u] - b.first_rows[u]).abs().max().item()
    shared, unshared, fresh = (runs[("port", m)] for m in MODES)
    bf = {m: _run(model, "port", m, kv_dtype=None) for m in ("shared", "unshared")}
    for uid in WAVE2:
        assert gap(fresh, shared, uid) == 0.0
        assert gap(bf["shared"], bf["unshared"], uid) == 0.0
    assert max(gap(unshared, shared, uid) for uid in WAVE2) > 0.0


def _gap_runs(first_on, first_off, decode_on, decode_off, bump=None):
    """Two synthetic serving runs of one request (uid 0): first tokens,
    first-token rows, and decode rows with the tokens they emitted; every
    row of ``on`` equals ``off``'s except decode row ``bump``, moved by 1."""
    rows = [torch.linspace(-4.0, 4.0, 16) + i for i in range(len(decode_on) + 1)]
    run = lambda first, toks, moved: {
        "handles": [SimpleNamespace(uid=0, generated=[first] + list(toks))],
        "eng": SimpleNamespace(first_rows={0: rows[0]}, rows={0: [
            (rows[i + 1] + (1.0 if i == moved else 0.0), t, i == 1) for i, t in enumerate(toks)]})}
    return run(first_on, decode_on, bump), run(first_off, decode_off, None)


@pytest.mark.parametrize("case", ["first-token flip", "decode flip", "no flip"])
def test_prefix_logit_gaps_pairing(case):
    """``prefix_logit_gaps`` pairs the first-token row, then decode rows up
    to and including the first whose tokens differ, and none after a
    first-token flip (the decode rows then follow different tokens); each
    paired row keeps its tolerance (``atol_frac`` x the median |off| +
    ``LOGIT_RTOL`` |off|)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    toks = [3, 4, 5, 6]
    if case == "first-token flip":
        on, off = _gap_runs(1, 2, toks, [9, 9, 9, 9])
        want = [0]
    elif case == "decode flip":
        on, off = _gap_runs(1, 1, toks, [3, 4, 7, 6])
        want = [0, 1, 2, 3]
    else:
        on, off = _gap_runs(1, 1, toks, toks, bump=1)
        want = [0, 1, 2, 3, 4]
    gaps = chip_smoke.prefix_logit_gaps(torch, on, off, chip_smoke.LOGIT_ATOL_FRAC)
    assert [g["row"] for g in gaps] == want
    assert all(g["finite"] for g in gaps)
    assert [g["cascade"] for g in gaps] == [row == 2 for row in want]
    # decode row 1 (row 2 of the pairing) moved by 1 against an allowance of
    # a tenth of the median |logit| plus 2**-6 of each
    assert [g["ok"] for g in gaps] == [not (case == "no flip" and row == 2) for row in want]
