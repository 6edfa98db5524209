"""The recurrent blocks (``repro_torch.models.recurrent``) and the recurrent
architectures (``recurrentgemma-9b``, ``xlstm-350m``) at the model level,
against the JAX reference on the same seeded numpy inputs: the JAX smoke
weights carried across (``params_from_numpy``; block tests convert one
block's leaves the same way), the JAX functions called eagerly (jitted,
XLA's fusions keep some bf16 roundings in float32: the port rounds where
the reference's op sequence says, as eager JAX does). Shapes are shared
between the tests (batch 2, width 64, 13 tokens) so that eager JAX
compiles each primitive once.

Tolerances.
- The RG-LRU scan (:func:`associative_scan`) combines in the reference's
  odd/even order: bit for bit with ``lax.associative_scan``.
- bf16 outputs (a block's output, the logits) are held to one bf16 step of
  their scale, ``2**-7`` relative plus ``2**-7`` absolute, as
  ``tests/test_torch_archs.py`` holds the attention kinds: both sides round
  at the same places, and a float32 summation order (XLA's dot against
  PyTorch's) can move one bf16 rounding.
- float32 states and the float32 outputs of the sequential forms (``h``,
  ``conv``, mLSTM's ``C``/``n``/``m`` and ``h``, sLSTM's ``c``/``n``/``m``/
  ``h``) are held to ``STATE`` = 1e-4 relative plus 1e-5 absolute: the
  products are float32 on both sides and differ by summation order and
  the last bit of ``exp``/``sigmoid``/``tanh`` (a few float32 ulps,
  compounded over the steps of a sequence; measured at most 2.7e-5 on an
  mLSTM ``C`` of size ~1). The mLSTM chunkwise form against its sequential
  oracle (both in the port, on the same bf16 q/k/v) is held to one bf16
  step of the output's scale (``2**-8`` x its largest magnitude): the
  chunked path rounds its weighted products to bf16, the oracle keeps them
  in float32 (measured at most 1.5e-2 on outputs up to 12.6).
- In a whole model (prefill, decode steps) every cache entry is held to
  ``BF16``: a state's inputs there are bf16 GEMM outputs of the residual
  stream, where one summation order can move one bf16 rounding.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config, get_smoke_config as jax_smoke  # noqa: E402
from repro.models import decode_step as jdecode, init_params as jinit  # noqa: E402
from repro.models import prefill as jprefill, recurrent as jrec  # noqa: E402
from repro.models.transformer import count_params as jcount  # noqa: E402
from repro.models.transformer import init_cache as jinit_cache  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import (  # noqa: E402
    cache_from_numpy,
    count_params,
    decode_step,
    init_cache,
    init_paged_cache,
    init_params,
    layer_kinds,
    params_from_numpy,
    prefill,
)
from repro_torch.models import recurrent as trec  # noqa: E402
from repro_torch.models.transformer import F32_KEYS  # noqa: E402

BF16 = dict(rtol=2**-7, atol=2**-7)
STATE = dict(rtol=1e-4, atol=1e-5)
ARCHS = ["recurrentgemma-9b", "xlstm-350m"]
CACHE = 32
D, W, H = 64, 64, 2


def _f(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _block(init, *args):
    """A block's JAX parameters and the port's copy of them (matmul leaves
    in bf16, ``F32_KEYS`` leaves float32, as ``params_from_numpy``)."""
    pj = init(jax.random.PRNGKey(3), *args)
    pt = {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(
        torch.float32 if k in F32_KEYS else torch.bfloat16) for k, v in pj.items()}
    return pj, pt


def _x(B, T, seed=0, dim=D):
    x = np.random.default_rng(seed).standard_normal((B, T, dim)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("T", [1, 2, 13, 16])
def test_associative_scan_bits(T):
    """The linear recurrence's scan equals ``lax.associative_scan`` bit for
    bit at even, odd and power-of-two lengths."""
    rng = np.random.default_rng(T)
    a = rng.uniform(0.5, 1.0, (2, T, W)).astype(np.float32)
    b = rng.standard_normal((2, T, W)).astype(np.float32)
    comb = lambda c1, c2: (c1[0] * c2[0], c2[0] * c1[1] + c2[1])
    want = jax.lax.associative_scan(comb, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    got = trec.associative_scan(trec._rglru_combine, [torch.from_numpy(a), torch.from_numpy(b)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("state", [False, True])
def test_causal_conv4(state):
    """Prefill's conv (bf16 in, bf16 out) and decode's (a float32 state
    before bf16 inputs: float32 out), the taps in the reference's order:
    bit for bit, new state too."""
    rng = np.random.default_rng(4)
    u = jnp.asarray(rng.standard_normal((2, 1 if state else 13, W)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((4, W)) * 0.5, jnp.bfloat16)
    st = jnp.asarray(rng.standard_normal((2, 3, W)), jnp.float32) if state else None
    want, wst = jrec._causal_conv4(u, w, st)
    tt = lambda a: None if a is None else torch.from_numpy(_f(a).copy()).to(
        torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32)
    got, gst = trec._causal_conv4(tt(u), tt(w), tt(st))
    assert got.dtype == (torch.float32 if state else torch.bfloat16)
    np.testing.assert_array_equal(_f(got), _f(want))
    np.testing.assert_array_equal(_f(gst), _f(wst))


def test_rglru_forward_and_step():
    """The RG-LRU block over a sequence (with an incoming state and conv
    taps), then two decode steps from its final state, against the
    reference's; and the parallel form equals a loop of steps to the float32
    state tolerance."""
    pj, pt = _block(jrec.rglru_init, D, W)
    xj, xt = _x(2, 13)
    rng = np.random.default_rng(5)
    h0 = rng.standard_normal((2, W)).astype(np.float32)
    c0 = rng.standard_normal((2, 3, W)).astype(np.float32)
    want, (hj, cj) = jrec.rglru_forward(pj, xj, jnp.asarray(h0), jnp.asarray(c0, jnp.bfloat16))
    got, (ht, ct) = trec.rglru_forward(pt, xt, torch.from_numpy(h0),
                                       torch.from_numpy(c0).to(torch.bfloat16))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BF16)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **STATE)
    np.testing.assert_array_equal(_f(ct), _f(cj))
    hj, cj = hj, cj.astype(jnp.float32)
    ht, ct = ht.clone(), ct.float()
    for t in range(2):
        sj, st = _x(2, 1, seed=20 + t)
        oj, hj, cj = jrec.rglru_step(pj, sj, hj, cj)
        ot, ht, ct = trec.rglru_step(pt, st, ht, ct)
        assert ct.dtype == torch.float32
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **BF16)
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **STATE)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **STATE)
    # the scan against the sequential recurrence it replaces, in the port
    u = torch.from_numpy(rng.standard_normal((2, 13, W)).astype(np.float32))
    a, b = trec._rglru_coeffs(pt, u.to(torch.bfloat16))
    _, h = trec.associative_scan(trec._rglru_combine, [a, b])
    hs, prev = [], torch.zeros(2, W)
    for t in range(13):
        prev = a[:, t] * prev + b[:, t]
        hs.append(prev)
    np.testing.assert_allclose(h.numpy(), torch.stack(hs, 1).numpy(), **STATE)


def _qkv_gates(T, seed=6):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((2, T, H, 16)).astype(np.float32) for _ in range(3))
    q /= 4.0
    i_pre = rng.standard_normal((2, T, H)).astype(np.float32)
    logf = -np.log1p(np.exp(-(rng.standard_normal((2, T, H)) + 3.0))).astype(np.float32)
    return q, k, v, i_pre, logf


@pytest.mark.parametrize("T,chunk", [(13, 8), (16, 8), (5, 8)])
def test_mlstm_sequence_chunked(T, chunk):
    """The chunkwise-parallel mLSTM at T not a multiple of the chunk (pad
    rows), a multiple, and shorter than one chunk: against the reference's
    chunked form on bf16 q/k/v (outputs and states to ``STATE``), and
    against the port's own sequential oracle on the same values."""
    q, k, v, i_pre, logf = _qkv_gates(T)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    hj, sj = jax.jit(jrec.mlstm_sequence_chunked, static_argnames="chunk")(
        bf(q), bf(k), bf(v), jnp.asarray(i_pre), jnp.asarray(logf), chunk=chunk)
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    ht, st = trec.mlstm_sequence_chunked(tb(q), tb(k), tb(v), torch.from_numpy(i_pre),
                                         torch.from_numpy(logf), chunk=chunk)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **STATE)
    for g, w in zip(st, sj):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **STATE)
    hr, sr = trec.mlstm_sequence_ref(tb(q).float(), tb(k).float(), tb(v).float(),
                                     torch.from_numpy(i_pre), torch.from_numpy(logf))
    for g, w in ((ht, hr), (st[0], sr[0])):
        w = w.numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=2**-8 * np.abs(w).max())


@pytest.mark.parametrize("T", [13, 1])
def test_mlstm_block_forward_and_step(T):
    """The mLSTM block over a prompt (chunked for T > 1 with a chunk of
    ``max(8, T)``; the sequential float32 form for T == 1), then two decode
    steps from its state, against the reference's."""
    pj, pt = _block(jrec.mlstm_init, D, H)
    xj, xt = _x(2, T)
    oj, sj = jrec.mlstm_block_forward(pj, xj, H)
    ot, st = trec.mlstm_block_forward(pt, xt, H)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **BF16)
    for g, w in zip(st, sj):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **STATE)
    for t in range(2):
        yj, yt = _x(2, 1, seed=30 + t)
        oj, sj = jrec.mlstm_block_step(pj, yj, H, sj)
        ot, st = trec.mlstm_block_step(pt, yt, H, st)
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **BF16)
        for g, w in zip(st, sj):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **STATE)


def test_slstm_forward_and_step():
    """The sLSTM over a prompt (its bias added in bf16), then two decode
    steps; and the sequence form equals one step at a time."""
    pj, pt = _block(jrec.slstm_init, D, H)
    pj = dict(pj, b=jnp.linspace(-1.0, 1.0, 4 * D))         # a bias that shows
    pt["b"] = torch.from_numpy(np.array(pj["b"], np.float32)).to(torch.bfloat16)
    xj, xt = _x(2, 13)
    oj, sj = jrec.slstm_forward(pj, xj, H)
    ot, st = trec.slstm_forward(pt, xt, H)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **BF16)
    for g, w in zip(st, sj):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **STATE)
    for t in range(2):
        yj, yt = _x(2, 1, seed=40 + t)
        oj, sj = jrec.slstm_step(pj, yj, H, sj)
        ot, st = trec.slstm_step(pt, yt, H, st)
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **BF16)
        for g, w in zip(st, sj):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **STATE)
    state = None
    for t in range(13):
        o, state = trec.slstm_step(pt, xt[:, t:t + 1], H, state)
    np.testing.assert_array_equal(state[3].numpy(), trec.slstm_forward(pt, xt, H)[1][3].numpy())


_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        cfg_j, cfg = jax_smoke(arch), get_smoke_config(arch)
        pj = jinit(jax.random.PRNGKey(0), cfg_j)
        _MODELS[arch] = (cfg_j, cfg, pj, params_from_numpy(jax.tree.map(np.asarray, pj), cfg,
                                                           device="cpu"))
    return _MODELS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_params_keep_float32_leaves(arch):
    """``params_from_numpy`` keeps ``lam``, ``b_if``, sLSTM's ``r`` and the
    ``ln_inner`` norms float32 (the reference reads them so) and sends the
    other recurrent matmul leaves to bf16; ``init_params`` draws the same
    tree (shapes and dtypes); ``count_params`` is the reference's."""
    cfg_j, cfg, pj, pt = _model(arch)
    kinds = layer_kinds(cfg)
    f32 = {"lam", "b_if", "r", "ln_inner"}
    seen = set()
    for lp, kind in zip(pt["layers"], kinds):
        if kind in ("mlstm", "slstm"):
            assert "ffn" not in lp and "attn" not in lp
        if "rec" in lp:
            for name, t in lp["rec"].items():
                assert t.dtype == (torch.float32 if name in f32 else torch.bfloat16), name
                seen.add(name)
    assert seen & f32 == ({"lam"} if arch == "recurrentgemma-9b" else {"b_if", "r", "ln_inner"})
    drawn = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert _layout(drawn) == _layout(pt)
    assert count_params(cfg) == jcount(cfg_j)
    assert count_params(get_config(arch)) == jcount(jax_config(arch))


def _layout(tree):
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_layout(v) for v in tree]
    return tuple(tree.shape), tree.dtype


@pytest.mark.parametrize("arch", ARCHS)
def test_caches_match_reference_layout(arch):
    """The dense and the paged caches hold each recurrent layer's per-slot
    float32 states in the reference's shapes; ``cache_from_numpy`` keeps
    them float32."""
    cfg_j, cfg, _, _ = _model(arch)
    want = cache_from_numpy(jax.tree.map(np.asarray, jinit_cache(cfg_j, 3, CACHE)), cfg,
                            device="cpu")
    for got in (init_cache(cfg, 3, CACHE, device="cpu"),
                init_paged_cache(cfg, 9, 8, device="cpu", batch=3, cache_len=CACHE)):
        for lt, lw, kind in zip(got, want, layer_kinds(cfg)):
            assert {k: (tuple(v.shape), v.dtype) for k, v in lt.items()} == {
                k: (tuple(v.shape), v.dtype) for k, v in lw.items()}, kind
            if kind != "win":
                assert all(v.dtype == torch.float32 for v in lt.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match(arch):
    """Prefill of two 13-token prompts (logits and every layer's cache:
    recurrent states, recurrentgemma's window rings), then three decode
    steps on the JAX cache with the second slot at a shorter context:
    logits and caches."""
    cfg_j, cfg, pj, pt = _model(arch)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 13)).astype(np.int32)
    lj, cj, _ = jprefill(pj, cfg_j, jnp.asarray(toks), cache_len=CACHE)
    lt, ct, cur = prefill(pt, cfg, torch.from_numpy(toks), cache_len=CACHE)
    assert cur == 13
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **BF16)
    want = cache_from_numpy(jax.tree.map(np.asarray, cj), cfg, device="cpu")
    for lc_t, lc_j in zip(ct, want):
        assert set(lc_t) == set(lc_j)
        for name in lc_t:
            np.testing.assert_allclose(_f(lc_t[name]), _f(lc_j[name]), **BF16)
    ct = want
    ctx = np.array([13, 10], np.int32)
    step = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 3)).astype(np.int32)
    for t in range(3):
        tok = step[:, t:t + 1]
        lj, cj = jdecode(pj, cfg_j, cj, jnp.asarray(tok), jnp.asarray(ctx.max()),
                         ctx_lens=jnp.asarray(ctx))
        lt, ct = decode_step(pt, cfg, ct, torch.from_numpy(tok), ctx_lens=torch.from_numpy(ctx))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **BF16)
        ctx = ctx + 1
    want = cache_from_numpy(jax.tree.map(np.asarray, cj), cfg, device="cpu")
    for lc_t, lc_j in zip(ct, want):
        for name in lc_t:
            np.testing.assert_allclose(_f(lc_t[name]), _f(lc_j[name]), **BF16)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_advances_state_in_place(arch):
    """``decode_step`` writes the new states into the cache's own tensors
    (a captured step's replay must advance the real state) and advances
    every slot, a masked one (context 0) too, as the reference's step does."""
    cfg_j, cfg, pj, pt = _model(arch)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    _, cache, _ = prefill(pt, cfg, torch.from_numpy(toks), cache_len=CACHE)
    kinds = layer_kinds(cfg)
    before = [{k: (v.data_ptr(), v.clone()) for k, v in lc.items()} for lc in cache]
    ctx = torch.tensor([9, 0], dtype=torch.int32)
    decode_step(pt, cfg, cache, torch.tensor([[3], [4]]), ctx_lens=ctx)
    for lc, old, kind in zip(cache, before, kinds):
        if kind == "win":
            continue
        for name, t in lc.items():
            assert t.data_ptr() == old[name][0]
            assert not torch.equal(t[1], old[name][1][1]), (kind, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_bucketed_prefill_refused(arch):
    """A padded prompt with ``true_len`` would scan the pad tokens into the
    carried state: the reference refuses it for recurrent kinds, and so does
    the port, naming it."""
    cfg_j, cfg, pj, pt = _model(arch)
    toks = np.zeros((1, 16), np.int32)
    with pytest.raises(ValueError, match="bucketed prefill"):
        jprefill(pj, cfg_j, jnp.asarray(toks), cache_len=CACHE, true_len=9)
    with pytest.raises(ValueError, match="bucketed prefill"):
        prefill(pt, cfg, torch.from_numpy(toks), cache_len=CACHE, true_len=9)


@pytest.mark.parametrize("T", [1, 2])
def test_rglru_prompts_under_three_tokens_as_the_reference(T):
    """The reference's prefill conv pads with ``zeros_like(x[:, :3])``,
    which has T rows when T < 3: over one token the RG-LRU block raises
    IndexError, over two it computes the conv of position 1 only (position
    0 never enters the state), so recurrentgemma's 1- and 2-token prompts
    fail or go wrong. A fault of the reference (ROADMAP queue 3); the port
    does the same."""
    pj, pt = _block(jrec.rglru_init, D, W)
    xj, xt = _x(2, T)
    if T == 1:
        with pytest.raises(IndexError):
            jrec.rglru_forward(pj, xj)
        with pytest.raises(IndexError):
            trec.rglru_forward(pt, xt)
        return
    want, (hj, _) = jrec.rglru_forward(pj, xj)
    got, (ht, _) = trec.rglru_forward(pt, xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BF16)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **STATE)
    out, _ = trec._causal_conv4(torch.ones(1, T, W, dtype=torch.bfloat16),
                                torch.ones(4, W, dtype=torch.bfloat16))
    assert out.shape[1] == 1


def test_slstm_reference_init_is_chaotic_at_full_width():
    """The reference draws sLSTM's recurrent ``r`` (H, hd, 4 hd) with
    ``dense_init``, whose fan-in is ``shape[0]``, the head count: at
    xlstm-350m's width (4 heads of 256) its std is 0.5, not 1/16, and the
    recurrence amplifies a float32 rounding difference about 4x every five
    steps. Shown in the reference alone: ``r`` moved by one float32 ulp
    leaves the block's output as it was for the first four tokens and
    moves every one of the last eight (of 64) by over 0.5, outputs of size
    about 3. So two correct implementations of the sLSTM (or one prompt
    prefilled in two ways) part after a few dozen steps; the port inits
    ``r`` the same way (ROADMAP queue 3)."""
    pj = jrec.slstm_init(jax.random.PRNGKey(2), 1024, 4)
    assert abs(float(jnp.std(pj["r"])) - 0.5) < 0.01
    moved = dict(pj, r=jnp.nextafter(pj["r"], jnp.float32(np.inf)))
    x = jnp.asarray(np.random.default_rng(0).standard_normal((1, 64, 1024)), jnp.float32)
    run = jax.jit(lambda p: jrec.slstm_forward(p, x, 4)[0])
    gap = np.abs(np.asarray(run(pj)) - np.asarray(run(moved))).max(axis=-1)[0]
    assert gap[:4].max() == 0 and gap[-8:].min() > 0.5, gap
