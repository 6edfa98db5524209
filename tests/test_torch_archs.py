"""The attention-family architectures on the port against the JAX reference,
model level: every smoke configuration whose layers are all attention kinds
(MoE, GeLU and squared-ReLU FFNs, sinusoidal positions, sliding-window
rings, cross-attention layers), with the same weights (carried across by
``params_from_numpy``) and the same seeded token inputs.

Tolerances. bf16 outputs are held to one bf16 step of their scale, 2**-7
relative plus 2**-7 absolute, as ``tests/test_torch_models.py`` holds the
dense model: both sides round at the same places and differ only where a
float32 summation order moves one bf16 rounding. The FFN activations are held bit for bit, and so is ``moe_forward`` in
bf16 (the serving compute dtype) against the reference's jitted, as the
engine's steps and the scanned stages run it: routing, drops, ties and the
combine. XLA keeps some of the reference's bf16 roundings in float32 where
a fusion widens the result anyway, and which ones depends on the shapes it
fuses: jitted on ``(1, 21, D)`` or ``(1, 26, D)`` it adds the shared
expert's output to the routed one unrounded (on ``(3, 7, D)`` it rounds),
and in a scanned stage it can keep a router logit unrounded. The port
rounds where the reference's op sequence says. So the routed experts are
held bit for bit, a shared expert's sum to one bf16 step, and what runs
after a MoE layer in a model (the
next layers' K/V, the logits) to two bf16 steps (``MOE``): a router weight
moved by 1e-3 moves a token's MoE output by a bf16 step or two. Each
number of the tolerances is met with room on these inputs; a wrong route
or a dropped pair moves a token's output by its whole size. ``moe_forward``
in float32 is held to 1e-5: XLA's and PyTorch's float32 ``exp`` differ in
the last bit for about one value in ten, and their GEMMs sum in different
orders, so float32 bits cannot match.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import decode_step as jdecode, init_params as jinit  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.models import layers as jlayers, moe as jmoe  # noqa: E402
from repro.models.transformer import prefill_chunks as jchunks, verify_step as jverify  # noqa: E402
from repro.models.transformer import init_paged_cache as jinit_paged  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_smoke_config  # noqa: E402
from repro_torch.models import (  # noqa: E402
    cache_from_numpy,
    decode_step,
    init_cache,
    layer_kinds,
    params_from_numpy,
    prefill,
    prefill_chunks,
    supports_chunked_prefill,
    verify_step,
)
from repro_torch.models import layers as tlayers, moe as tmoe  # noqa: E402
from repro_torch.models.transformer import check_supported  # noqa: E402

BF16 = dict(rtol=2**-7, atol=2**-7)
MOE = dict(rtol=2**-6, atol=2**-6)
ARCHS = ["qwen3-moe-30b-a3b", "qwen2-moe-a2.7b", "nemotron-4-15b", "yi-34b", "gemma3-4b",
         "musicgen-large", "llama-3.2-vision-11b"]
CHUNKED = [a for a in ARCHS if a in ("qwen3-moe-30b-a3b", "qwen2-moe-a2.7b", "nemotron-4-15b",
                                      "yi-34b")]
CACHE = 32
PROMPT = 13


def _f(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _tree(t):
    return {k: _tree(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in t.items()}


_MODELS = {}


def _model(arch):
    """Both packages' smoke model with the JAX weights; the cross-attention
    gate set to 0.5 (it is initialised to 0, which would hide the cross
    attention)."""
    if arch not in _MODELS:
        cfg_j, cfg = jax_smoke(arch), get_smoke_config(arch)
        pj = jinit(jax.random.PRNGKey(0), cfg_j)
        if cfg.cross_kv_len:
            for unit in pj["stages"]:
                for lp in unit:
                    if "xgate" in lp:
                        lp["xgate"] = jnp.full_like(lp["xgate"], 0.5)
        pt = params_from_numpy(jax.tree.map(np.asarray, pj), cfg, device="cpu")
        _MODELS[arch] = (cfg_j, cfg, pj, pt)
    return _MODELS[arch]


def _img(cfg, seed=9, B=2):
    if not cfg.cross_kv_len:
        return None, None
    e = (np.random.default_rng(seed).standard_normal((B, cfg.cross_kv_len, cfg.d_model))
         * 0.5).astype(np.float32)
    return jnp.asarray(e), torch.from_numpy(e)


def _tol(cfg):
    return MOE if cfg.moe is not None else BF16


def _tokens(cfg, B, L, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, L)).astype(np.int32)


def test_registry_holds_the_attention_family():
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS

    assert sorted(ARCH_IDS) == sorted(JAX_ARCH_IDS) == sorted(
        ARCHS + ["mistral-nemo-12b", "recurrentgemma-9b", "xlstm-350m"])
    for arch in ARCHS:
        kinds = set(layer_kinds(get_smoke_config(arch)))
        assert kinds <= {"attn", "win", "xattn"}, (arch, kinds)


def test_layer_order_and_params(monkeypatch):
    """A mixed stage pattern flattens stage by stage, repeat by repeat,
    pattern in order; each layer's parameters carry across with their
    kind's leaves (gelu / squared-ReLU have no ``wg``; MoE layers
    ``router``/experts/``shared``; ``xattn`` ``ln_x``/``xattn``/``xgate``)."""
    cfg = get_smoke_config("gemma3-4b")
    assert layer_kinds(cfg) == ["win"] * 5 + ["attn"]
    two = dataclasses.replace(cfg, n_layers=10, stages=((("win", "attn"), 3), (("win",) * 4, 1)))
    assert layer_kinds(two) == ["win", "attn"] * 3 + ["win"] * 4
    for arch in ARCHS:
        cfg_j, cfg, pj, pt = _model(arch)
        assert len(pt["layers"]) == cfg.n_layers
        for i, (lp, kind) in enumerate(zip(pt["layers"], layer_kinds(cfg))):
            assert ("xattn" in lp) == (kind == "xattn")
            if cfg.moe is not None:
                assert set(lp["moe"]) >= {"router", "wg", "wu", "wd"}
                assert ("shared" in lp["moe"]) == bool(cfg.moe.d_ff_shared)
            else:
                assert ("wg" in lp["ffn"]) == (cfg.ffn_kind == "swiglu")
        lj = pj["stages"][0][0]
        want = lj["moe"]["wd"][1] if cfg.moe is not None else lj["attn"]["wo"][1]
        got = pt["layers"][1]["moe"]["wd"] if cfg.moe is not None else pt["layers"][1]["attn"]["wo"]
        if arch != "gemma3-4b" and arch != "llama-3.2-vision-11b":
            np.testing.assert_array_equal(_f(got), _f(jnp.asarray(want).astype(jnp.bfloat16)))


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "nemotron-4-15b"])
def test_init_params_draws_in_the_reference_layout_order(arch):
    """``init_params`` draws each layer's matmul weights in the order of the
    reference's ``attn_init`` / ``ffn_init`` (wq, wk, wv, wo, then wg, wu,
    wd for SwiGLU; wu, wd otherwise), so a seed gives the same random model
    from one release to the next (the card's recorded streams rest on it)."""
    import math

    from repro_torch.models import init_params

    cfg = get_smoke_config(arch)
    gen = torch.Generator().manual_seed(7)
    p = init_params(cfg, gen, device="cpu", dtype=torch.float32)
    gen = torch.Generator().manual_seed(7)

    def draw(shape, scale=None):
        w = torch.randn(shape, generator=gen)
        return w.mul_(scale if scale is not None else 1.0 / math.sqrt(shape[0]))

    D, F, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    assert torch.equal(p["embed"], draw((cfg.vocab_size, D), 0.02))
    if not cfg.tie_embeddings:
        assert torch.equal(p["unembed"], draw((D, cfg.vocab_size)))
    for lp in p["layers"]:
        for name, shape in (("wq", (D, cfg.n_heads * hd)), ("wk", (D, cfg.n_kv_heads * hd)),
                            ("wv", (D, cfg.n_kv_heads * hd)), ("wo", (cfg.n_heads * hd, D))):
            assert torch.equal(lp["attn"][name], draw(shape)), name
        names = ("wg", "wu", "wd") if cfg.ffn_kind == "swiglu" else ("wu", "wd")
        for name in names:
            assert torch.equal(lp["ffn"][name], draw((F, D) if name == "wd" else (D, F))), name


@pytest.mark.parametrize("kind", ["gelu", "squared_relu"])
def test_ffn_activation_bits(kind):
    """gelu (the tanh approximation) and squared ReLU on every bf16 value
    of magnitude 1e-12 to 1e4 and zero, against XLA's bf16 op sequence:
    equal to the bit wherever no subnormal number is involved (XLA flushes
    subnormals to zero, PyTorch on the CPU does not; from 1e-12 up ``x**3``
    is normal)."""
    bits = np.arange(65536, dtype=np.uint32) << 16
    xf = bits.view(np.float32)
    xf = xf[np.isfinite(xf) & (np.abs(xf) < 1e4) & ((np.abs(xf) >= 1e-12) | (xf == 0))]
    xj = jnp.asarray(xf).astype(jnp.bfloat16)
    xt = torch.from_numpy(xf).bfloat16()
    if kind == "gelu":
        want, got = jax.nn.gelu(xj), tlayers.gelu(xt)
    else:
        want, got = jnp.square(jax.nn.relu(xj)), torch.relu(xt) * torch.relu(xt)
    want, got = _f(want), _f(got)
    tiny = np.finfo(np.float32).tiny

    def sub(a):
        return (a != 0) & (np.abs(a) < tiny)

    normal = ~(sub(want) | sub(got) | sub(xf))
    np.testing.assert_array_equal(got[normal], want[normal])
    assert normal.sum() > 13000


@pytest.mark.parametrize("kind", ["swiglu", "gelu", "squared_relu"])
def test_ffn_forward_matches(kind):
    rng = np.random.default_rng(3)
    D, F = 64, 96
    pj = jlayers.ffn_init(jax.random.PRNGKey(1), D, F, kind)
    x = rng.standard_normal((2, 5, D)).astype(np.float32)
    want = jlayers.ffn_forward(pj, jnp.asarray(x), kind=kind)
    got = tlayers.ffn_forward(_tree(jax.tree.map(np.asarray, pj)), torch.from_numpy(x), kind=kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BF16)


def test_sinusoidal_positions():
    pos = np.arange(37) + 1000
    want = np.asarray(jlayers.sinusoidal_pos(jnp.asarray(pos), 64))
    got = tlayers.sinusoidal_pos(torch.from_numpy(pos), 64).numpy()
    assert got.dtype == np.float32 and got.shape == (37, 64)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=2e-6)


def _moe_pair(E=8, K=2, F=32, shared=0, cf=1.0, D=64, seed=0):
    cj = jmoe.MoEConfig(num_experts=E, top_k=K, d_ff_expert=F, d_ff_shared=shared,
                        capacity_factor=cf)
    ct = tmoe.MoEConfig(num_experts=E, top_k=K, d_ff_expert=F, d_ff_shared=shared,
                        capacity_factor=cf)
    pj = jmoe.moe_init(jax.random.PRNGKey(seed), D, cj)
    return cj, ct, pj, _tree(jax.tree.map(np.asarray, pj))


def _jit_moe(cfg, dtype):
    """The reference's ``moe_forward`` jitted, as the engine's steps and the
    model's scanned stages run it (XLA fuses the combine's products and sum
    in float32 there; eagerly it rounds each product)."""
    return jax.jit(lambda p, x: jmoe.moe_forward(p, x, cfg, compute_dtype=dtype)[0])


@pytest.mark.parametrize("shared,tokens", [(0, 21), (0, 26), (48, 21), (64, 26)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_moe_forward_matches(shared, tokens, dtype):
    """A smoke-width MoE with ``capacity_factor=1.0``: C = 5 or 6 rows for
    21 or 26 tokens x 2 pairs over 8 experts, so pairs are dropped. bf16 bit
    for bit (with a shared expert: one bf16 step); float32 within 1e-5 (see
    the module docstring)."""
    cj, ct, pj, pt = _moe_pair(shared=shared)
    assert tmoe.capacity(ct, tokens) == int(tokens * 2 / 8)
    x = np.random.default_rng(0).standard_normal((1, tokens, 64)).astype(np.float32)
    want = _jit_moe(cj, getattr(jnp, dtype))(pj, jnp.asarray(x))
    got, _ = tmoe.moe_forward(pt, torch.from_numpy(x), ct, compute_dtype=getattr(torch, dtype))
    # the drops happen: some expert is asked for more than C rows
    probs = torch.softmax(torch.from_numpy(x).reshape(tokens, 64).bfloat16()
                          @ pt["router"].bfloat16(), -1)
    _, idx = tmoe.top_k(probs.float(), 2)
    assert np.bincount(idx.reshape(-1).numpy(), minlength=8).max() > tmoe.capacity(ct, tokens)
    if dtype == "bfloat16" and shared:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **BF16)
    elif dtype == "bfloat16":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_moe_forward_dispatch_groups():
    """8192 tokens dispatch in two groups of 4096 (``_auto_groups``), each
    sorted and capacity-limited on its own (C = 1024). Equal to the bit but
    in under 0.1% of the outputs, and there within one bf16 step of the
    expert outputs' scale: at 1024 rows an expert's GEMM sums in another
    order than XLA's, which moves one bf16 rounding of an output ``y``,
    and the float32 combine of two such outputs of opposite sign keeps
    that step where they cancel. A route or drop taken differently would
    move a whole token's 64 outputs by their own size."""
    cj, ct, pj, pt = _moe_pair()
    assert tmoe._auto_groups(8192) == 2 and tmoe._auto_groups(8191) == 1
    x = np.random.default_rng(2).standard_normal((2, 4096, 64)).astype(np.float32)
    want = np.asarray(_jit_moe(cj, jnp.bfloat16)(pj, jnp.asarray(x)))
    got = tmoe.moe_forward(pt, torch.from_numpy(x), ct)[0].numpy()
    assert (got != want).mean() < 1e-3
    np.testing.assert_allclose(got, want, rtol=2**-7, atol=2**-7 * np.abs(want).max())


def test_moe_top_k_ties_take_the_lower_index():
    """Experts 1 and 5 (and 2 and 6) have the same router column, so every
    token's probabilities tie in pairs: ``jax.lax.top_k`` keeps the lower
    index, and so must the port, or the pairs sort into other experts'
    capacity. Bit for bit in bf16, with drops (C = 2)."""
    cj, ct, pj, pt = _moe_pair(E=8, K=3, cf=0.5)
    r = np.array(pj["router"])
    r[:, 5], r[:, 6] = r[:, 1], r[:, 2]
    pj["router"] = jnp.asarray(r)
    pt["router"] = torch.from_numpy(r)
    x = np.random.default_rng(4).standard_normal((2, 6, 64)).astype(np.float32)
    probs = torch.softmax(torch.from_numpy(x).reshape(12, 64).bfloat16() @ pt["router"].bfloat16()
                          .reshape(64, 8), -1).float()
    assert torch.equal(probs[:, 1], probs[:, 5])
    vals, idx = tmoe.top_k(probs, 8)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 8)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    assert ((idx == 1).long().argmax(-1) < (idx == 5).long().argmax(-1)).all()
    want = _jit_moe(cj, jnp.bfloat16)(pj, jnp.asarray(x))
    got, _ = tmoe.moe_forward(pt, torch.from_numpy(x), ct)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches(arch):
    """Whole-prompt prefill: last-position logits and every layer's cache
    (global rows padded to the cache, window rings, cross-attention K/V)."""
    cfg_j, cfg, pj, pt = _model(arch)
    toks = _tokens(cfg, 2, PROMPT)
    ij, it = _img(cfg)
    lj, cj, _ = jprefill(pj, cfg_j, jnp.asarray(toks), cache_len=CACHE, img_emb=ij)
    lt, ct, cur = prefill(pt, cfg, torch.from_numpy(toks), cache_len=CACHE, img_emb=it)
    assert cur == PROMPT
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **_tol(cfg))
    want = cache_from_numpy(jax.tree.map(np.asarray, cj), cfg, device="cpu")
    for lc_t, lc_j in zip(ct, want):
        assert set(lc_t) == set(lc_j)
        for name in lc_t:
            assert lc_t[name].shape == lc_j[name].shape, name
            np.testing.assert_allclose(_f(lc_t[name]), _f(lc_j[name]), **_tol(cfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match(arch):
    """Three decode steps on the dense cache of a prefill, slots at ragged
    lengths (the second slot pretends a shorter context), from the JAX
    cache on both sides: logits and caches (the rings written past their
    end on gemma3's window of 8)."""
    cfg_j, cfg, pj, pt = _model(arch)
    toks = _tokens(cfg, 2, PROMPT)
    ij, it = _img(cfg)
    _, cj, _ = jprefill(pj, cfg_j, jnp.asarray(toks), cache_len=CACHE, img_emb=ij)
    ct = cache_from_numpy(jax.tree.map(np.asarray, cj), cfg, device="cpu")
    ctx = np.array([PROMPT, PROMPT - 3], np.int32)
    step = _tokens(cfg, 2, 3, seed=7)
    for t in range(3):
        tok = step[:, t:t + 1]
        lj, cj = jdecode(pj, cfg_j, cj, jnp.asarray(tok), jnp.asarray(ctx.max()),
                         ctx_lens=jnp.asarray(ctx))
        lt, ct = decode_step(pt, cfg, ct, torch.from_numpy(tok), ctx_lens=torch.from_numpy(ctx))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **_tol(cfg))
        ctx = ctx + 1
    want = cache_from_numpy(jax.tree.map(np.asarray, cj), cfg, device="cpu")
    for lc_t, lc_j in zip(ct, want):
        for name in lc_t:
            np.testing.assert_allclose(_f(lc_t[name]), _f(lc_j[name]), **_tol(cfg))


@pytest.mark.parametrize("arch", CHUNKED)
def test_chunks_and_verify_match(arch):
    """Chunked prefill of two prompts in two chunks each into the paged pool,
    then a verify block of 3 rows, against the reference's (MoE FFNs on
    every chunk row, pad rows included, as the reference routes them)."""
    cfg_j, cfg, pj, pt = _model(arch)
    assert supports_chunked_prefill(cfg)
    page, pages, W = 8, 12, 4
    tbls = np.array([[3, 7, 1, 0], [5, 2, 9, 0]], np.int32)
    toks = _tokens(cfg, 2, 16, seed=3)
    jc = jinit_paged(cfg_j, 2, W * page, pages, page)
    tc = [{k: torch.zeros_like(v) for k, v in lc.items()}
          for lc in cache_from_numpy(jax.tree.map(np.asarray, jc), cfg, device="cpu")]
    for off, n in ((0, 8), (8, (8, 5))):
        lens = np.array([n, n] if isinstance(n, int) else n, np.int32)
        offs = np.array([off, off], np.int32)
        chunk = toks[:, off:off + 8]
        lj, jc = jchunks(pj, cfg_j, jc, jnp.asarray(chunk), jnp.asarray(offs), jnp.asarray(lens),
                         jnp.asarray(tbls))
        lt, tc = prefill_chunks(pt, cfg, tc, torch.from_numpy(chunk), torch.from_numpy(offs),
                                torch.from_numpy(lens), torch.from_numpy(tbls))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **_tol(cfg))
    block = _tokens(cfg, 2, 3, seed=4)
    offs, lens = np.array([16, 13], np.int32), np.array([3, 3], np.int32)
    lj, jc = jverify(pj, cfg_j, jc, jnp.asarray(block), jnp.asarray(offs), jnp.asarray(lens),
                     jnp.asarray(tbls))
    lt, tc = verify_step(pt, cfg, tc, torch.from_numpy(block), torch.from_numpy(offs),
                         torch.from_numpy(lens), torch.from_numpy(tbls))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **_tol(cfg))
    want = cache_from_numpy(jax.tree.map(np.asarray, jc), cfg, device="cpu")
    for lc_t, lc_j in zip(tc, want):
        for name in ("k", "v"):
            np.testing.assert_allclose(_f(lc_t[name][1:]), _f(lc_j[name][1:]), **_tol(cfg))


@pytest.mark.parametrize("form", ["ctx_lens", "cur_len"])
def test_window_ring_written_past_its_end(form):
    """One ``win`` layer's decode against a ring of 8 rows with contexts past
    it (19 and 8: the writes wrap to rows 3 and 0, every row visible), per
    slot or at one ``cur_len``, against the reference's ``attn_decode``."""
    cfg_j, cfg, pj, pt = _model("gemma3-4b")
    rng = np.random.default_rng(5)
    S = cfg.window
    k = (rng.standard_normal((2, cfg.n_kv_heads, S, cfg.head_dim)) * 0.5).astype(np.float32)
    v = (rng.standard_normal(k.shape) * 0.5).astype(np.float32)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
              rope_theta=cfg.rope_theta, window=S)
    ctx = np.array([19, 8], np.int32)
    if form == "ctx_lens":
        jkw, tkw, cur = dict(ctx_lens=jnp.asarray(ctx)), dict(ctx_lens=torch.from_numpy(ctx)), 0
    else:
        jkw, tkw, cur = {}, {}, 19
    pj0 = jax.tree.map(lambda a: a[0], pj["stages"][0][0]["attn"])
    out_j, kc_j, vc_j = jlayers.attn_decode(
        pj0, jnp.asarray(x), jnp.asarray(k).astype(jnp.bfloat16),
        jnp.asarray(v).astype(jnp.bfloat16), cur, **jkw, **kw)
    kc, vc = torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16()
    out_t, kc_t, vc_t = tlayers.attn_decode(pt["layers"][0]["attn"], torch.from_numpy(x), kc, vc,
                                            cur if form == "cur_len" else None, **tkw, **kw)
    assert kc_t is kc
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **BF16)
    np.testing.assert_allclose(_f(kc_t), _f(kc_j), **BF16)
    np.testing.assert_allclose(_f(vc_t), _f(vc_j), **BF16)
    row = 19 % S
    assert not torch.equal(kc_t[0, :, row], torch.from_numpy(k).bfloat16()[0, :, row])


@pytest.mark.parametrize("true_len", [None, 11, 5])
def test_ring_from_prefill_matches(true_len):
    """The ring a sliding-window layer keeps from a prefill of 14 positions
    into 8 rows: exact-length, and bucketed with 11 and 5 real positions
    (pad positions never land)."""
    from repro.models.transformer import _ring_from_prefill as jring
    from repro_torch.models.transformer import ring_from_prefill

    rng = np.random.default_rng(6)
    kh = rng.standard_normal((1, 2, 14, 4)).astype(np.float32)
    vh = rng.standard_normal((1, 2, 14, 4)).astype(np.float32)
    kj, vj = jring(jnp.asarray(kh), jnp.asarray(vh), 8, 14, true_len)
    for n in ([true_len] if true_len is None else [true_len, torch.tensor([true_len])]):
        kt, vt = ring_from_prefill(torch.from_numpy(kh), torch.from_numpy(vh), 8, n)
        np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_vision_cross_attention_with_image():
    """llama-3.2-vision's ``xattn`` layer with an ``img_emb`` given: the
    cached image K/V are its projections (not the prompt's), the gate
    (0.5 here) lets them move the logits, and a decode step reads them."""
    cfg_j, cfg, pj, pt = _model("llama-3.2-vision-11b")
    toks = _tokens(cfg, 2, PROMPT)
    ij, it = _img(cfg)
    lt, ct, _ = prefill(pt, cfg, torch.from_numpy(toks), cache_len=CACHE, img_emb=it)
    other, _, _ = prefill(pt, cfg, torch.from_numpy(toks), cache_len=CACHE, img_emb=it * 2)
    assert not torch.allclose(lt, other)
    x = [i for i, kind in enumerate(layer_kinds(cfg)) if kind == "xattn"][0]
    assert ct[x]["xk"].shape == (2, cfg.n_kv_heads, cfg.cross_kv_len, cfg.head_dim)
    ctx = torch.tensor([PROMPT, PROMPT], dtype=torch.int32)
    tok = torch.from_numpy(_tokens(cfg, 2, 1, seed=2))
    l1, _ = decode_step(pt, cfg, [dict(lc) for lc in ct], tok, ctx_lens=ctx)
    ct2 = [dict(lc) for lc in ct]
    ct2[x]["xv"] = ct2[x]["xv"] * 2
    l2, _ = decode_step(pt, cfg, ct2, tok, ctx_lens=ctx)
    assert not torch.allclose(l1, l2)


@pytest.mark.parametrize("quant", [False, True])
def test_null_page_writes_keep_the_last_row(quant):
    """Pad rows of a chunk pack all land on slot 0 of the null page; the
    reference's scatter applies them in order, so the last stays. The port
    writes that row's values from every such row, the same content on any
    device (a MoE routes the rows that read it back): the pool, page 0
    included, equals the reference's bit for bit, also with the writer
    index computed once for the step (``chunk_writer_rows``) as the chunk
    and decode steps pass it to every layer."""
    from repro.core import attention as jatt
    from repro_torch.core import attention as tatt

    rng = np.random.default_rng(8)
    pool = (rng.standard_normal((6, 2, 4, 8)) * 0.5).astype(np.float32)
    tbls = np.array([[3, 5, 0], [1, 0, 0], [0, 0, 0]], np.int32)
    offs, lens = np.array([2, 1, 0], np.int32), np.array([3, 2, 0], np.int32)
    vals = rng.standard_normal((3, 4, 2, 8)).astype(np.float32)
    if quant:
        q, sc = jatt.quantize_kv_blocks(jnp.asarray(pool))
        want, want_s = jatt.paged_scatter_tokens_quant(
            q, sc, jnp.asarray(tbls), jnp.asarray(offs), jnp.asarray(lens), jnp.asarray(vals))
    else:
        want = jatt.paged_scatter_tokens(jnp.asarray(pool), jnp.asarray(tbls),
                                         jnp.asarray(offs), jnp.asarray(lens), jnp.asarray(vals))
    writer = tatt.chunk_writer_rows(torch.from_numpy(tbls), torch.from_numpy(offs),
                                    torch.from_numpy(lens), 4, 4, "cpu")
    for w in (None, writer):
        if quant:
            got, got_s = tatt.paged_scatter_tokens_quant(
                torch.from_numpy(np.asarray(q).copy()), torch.from_numpy(np.asarray(sc).copy()),
                torch.from_numpy(tbls), torch.from_numpy(offs), torch.from_numpy(lens),
                torch.from_numpy(vals), writer=w)
            np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
        else:
            got = tatt.paged_scatter_tokens(torch.from_numpy(pool.copy()), torch.from_numpy(tbls),
                                            torch.from_numpy(offs), torch.from_numpy(lens),
                                            torch.from_numpy(vals), writer=w)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pages = torch.tensor([4, 0, 2, 0, 0, 1])
    rows = torch.arange(6.0)[:, None].expand(6, 3)
    out = tatt.null_page_last_writer(pages, rows)
    assert out[:, 0].tolist() == [0.0, 4.0, 2.0, 4.0, 4.0, 5.0]
    # a decode step: slot b writes position ctx_lens[b]; idle slots page 0
    tbl = torch.tensor([[3, 5], [0, 0], [1, 0], [0, 0]], dtype=torch.int32)
    ctx = torch.tensor([5, 0, 2, 0], dtype=torch.int32)
    assert tlayers.decode_writer_rows(tbl, ctx, 4).tolist() == [0, 3, 2, 3]


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-350m"])
def test_recurrent_kinds_refused(arch):
    """The recurrent architectures run at the model level
    (``tests/test_torch_recurrent.py``); what the reference refuses them the
    port refuses too: chunked prefill (their state has no chunk-resume
    plumbing), as ``repro/models/transformer.py:647-651`` does; and, as for
    every architecture, a KV dtype the reference's ``KVLayout`` does not
    know -- an f8 cache, once refused here, is served (e4m3 attention
    layers beside float32 states)."""
    cfg_j, cfg, pj, pt = _model(arch)
    check_supported(cfg)
    assert not supports_chunked_prefill(cfg)
    args = (np.zeros((1, 8), np.int32), np.zeros(1, np.int32), np.full(1, 8, np.int32),
            np.zeros((1, 2), np.int32))
    with pytest.raises(ValueError, match="chunked prefill requires"):
        jchunks(pj, cfg_j, None, *(jnp.asarray(a) for a in args))
    with pytest.raises(ValueError, match="chunked prefill requires"):
        prefill_chunks(pt, cfg, None, *(torch.from_numpy(a) for a in args))
    with pytest.raises(ValueError, match="unknown kv_dtype"):
        check_supported(dataclasses.replace(cfg, kv_cache_dtype="fp4"))
    f8 = dataclasses.replace(cfg, kv_cache_dtype="f8")
    check_supported(f8)
    kinds = {kind: lc for kind, lc in zip(layer_kinds(f8), init_cache(f8, 1, 8, device="cpu"))}
    assert all(t.dtype == (torch.float8_e4m3fn if kind in ("attn", "win") else torch.float32)
               for kind, lc in kinds.items() for t in lc.values())
