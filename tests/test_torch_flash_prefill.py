"""K7's plain PyTorch version (``flash_prefill_plain``, what the CUDA
kernel is held to on the card) against the JAX package's Pallas K7 in
interpret mode and against the prefill oracles, on the reference's own
``PREFILL_CASES`` (tests/test_kernels.py:130-136); and the model's
whole-prompt prefill run through it against the JAX prefill.

Tolerances:
  * float32: 2e-5, the reference's kernel contract.
  * bf16 against the JAX kernel: one bf16 step of the output (2**-7 of
    |out|) plus 2e-5 -- both upcast the same bf16 inputs, compute in float32
    and round the result once, so only float32 summation order separates
    them and it can move the rounding by one step.
  * bf16 against the oracle ``flash_prefill_ref``: the reference's 3e-2
    (tests/test_kernels.py:155), since the oracle rounds the probabilities
    to bf16 before the PV product and the kernels do not.
  * model logits: one bf16 step of their scale (``BF16``, as
    tests/test_torch_models.py) against the JAX prefill running the JAX K7;
    ``BACKEND_TOL`` against the JAX prefill as it is (see the test).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels.flash_prefill import flash_prefill as jflash_prefill  # noqa: E402
from repro.kernels.ref import flash_prefill_ref as jflash_prefill_ref  # noqa: E402
from repro.models import init_params as jinit, prefill as jprefill  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.attention import mha_prefill_chunked, mha_prefill_ref  # noqa: E402
from repro_torch.kernels import flash_prefill as tfp  # noqa: E402
from repro_torch.kernels.ref import flash_prefill_ref  # noqa: E402
from repro_torch.models import params_from_numpy, prefill  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.models.transformer import _prefill_attn  # noqa: E402

F32_TOL = 2e-5
BF16_STEP = 2.0 ** -7
BF16 = dict(rtol=2**-7, atol=2**-7)
BACKEND_TOL = 2**-5

PREFILL_CASES = [
    # B, Hq, Hkv, Lq, Lk, d, causal, window
    (2, 4, 2, 64, 64, 64, True, None),
    (1, 4, 4, 100, 100, 64, True, 32),
    (2, 2, 1, 37, 150, 128, False, None),
    (1, 8, 2, 128, 256, 32, True, None),   # q shorter than kv (chunked)
    (1, 2, 2, 65, 65, 16, True, 16),
]


def _inputs(case, dtype, seed):
    B, Hq, Hkv, Lq, Lk, d, causal, window = case
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, Lq, d), (B, Hkv, Lk, d), (B, Hkv, Lk, d))]
    j = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    kw = dict(causal=causal, window=window, q_offset=Lk - Lq if causal else 0)
    return j, t, kw


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PREFILL_CASES)
def test_plain_matches_jax_kernel_and_oracle(case, dtype):
    """Block sizes 32 (the reference test's: several query blocks, key
    tiles and skips per case) and the default 128 (one block per axis)."""
    j, t, kw = _inputs(case, dtype, seed=sum(case[:6]))
    oracle = _np(flash_prefill_ref(*t, **kw))
    np.testing.assert_allclose(oracle, _np(jflash_prefill_ref(*j, **kw)), rtol=F32_TOL,
                               atol=F32_TOL if dtype == "float32" else BF16_STEP)
    for block in (32, 128):
        got = _np(tfp.flash_prefill_plain(*t, block_q=block, block_kv=block, **kw))
        want = _np(jflash_prefill(*j, block_q=block, block_kv=block, interpret=True, **kw))
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
            np.testing.assert_allclose(got, oracle, rtol=F32_TOL, atol=F32_TOL)
        else:
            gap = np.abs(got - want)
            assert (gap <= BF16_STEP * np.abs(want) + F32_TOL).all(), gap.max()
            np.testing.assert_allclose(got, oracle, rtol=3e-2, atol=3e-2)


def test_wrapper_on_cpu_is_the_plain_version():
    """On CPU tensors the wrapper runs the plain version, counts no launch,
    and checks what it is given."""
    case = PREFILL_CASES[1]
    _, t, kw = _inputs(case, "float32", seed=3)
    before = (tfp.dense_launches, tfp.launches)
    out = tfp.flash_prefill(*t, **kw)
    assert (tfp.dense_launches, tfp.launches) == before
    assert out.dtype == torch.float32 and out.shape == t[0].shape
    assert torch.equal(out, tfp.flash_prefill_plain(*t, **kw))
    q, k, v = t
    with pytest.raises(ValueError, match="window"):
        tfp.flash_prefill(q, k, v, window=0)
    with pytest.raises(ValueError, match="do not fit"):
        tfp.flash_prefill(q, k[..., :8], v[..., :8])


def test_rows_past_every_key_attend_to_nothing():
    """A causal query before position 0 (``q_offset`` < 0) or a window past
    ``Lk`` sees no key: K7's flush gives 0 there, as the reference
    kernel's does."""
    q = torch.randn(1, 2, 12, 16, generator=torch.Generator().manual_seed(0))
    k = torch.randn(1, 1, 6, 16, generator=torch.Generator().manual_seed(1))
    out = tfp.flash_prefill_plain(q, k, k, q_offset=-4)
    assert torch.equal(out[:, :, :4], torch.zeros_like(out[:, :, :4]))
    want = np.asarray(jflash_prefill(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                                     jnp.asarray(k.numpy()), q_offset=-4, interpret=True))
    np.testing.assert_allclose(out.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    out = tfp.flash_prefill_plain(q, k, k, q_offset=3, window=2)
    assert torch.equal(out[:, :, 5:], torch.zeros_like(out[:, :, 5:]))


@pytest.fixture(scope="module")
def model():
    cfg_j = jax_smoke("mistral-nemo-12b")
    cfg = get_smoke_config("mistral-nemo-12b")
    pj = jinit(jax.random.PRNGKey(0), cfg_j)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), cfg, device="cpu")
    return cfg_j, cfg, pj, pt


def _jax_k7(q, k, v, causal=True, window=None, q_offset=0, **_):
    return jflash_prefill(q, k, v, causal=causal, window=window, q_offset=q_offset,
                          interpret=True)


@pytest.mark.parametrize("q_chunk,L", [(512, 23), (8, 21)])
def test_prefill_through_k7_plain_matches_jax(model, monkeypatch, q_chunk, L):
    """The model's whole-prompt prefill with K7's plain version as its
    attention (what runs on the card, up to the kernel's float32 summation
    order), on a prompt shorter than ``attn_q_chunk`` and one longer:

      * against the JAX prefill with the JAX K7 (interpret mode) as its
        attention -- the same function on both sides: logits within one
        bf16 step, the caches equal within one bf16 step, the same greedy
        token;
      * against the JAX prefill as it is (the plain oracle, or the
        q-chunked one): within ``BACKEND_TOL`` = 2**-5, the tolerance of a
        kernel backend against the oracle in tests/test_torch_scheduler.py,
        since K7 keeps the probabilities in float32 where the oracle rounds
        them to bf16 before the PV product; the same greedy token.

    Neither package is changed: the attention the port's prefill picks, and
    the JAX prefill's, are swapped for this test only (``monkeypatch``)."""
    import repro.models.layers as jlayers
    import repro.models.transformer as jtransformer

    cfg_j, cfg, pj, pt = model
    cfg_j = dataclasses.replace(cfg_j, attn_q_chunk=q_chunk)
    cfg = dataclasses.replace(cfg, attn_q_chunk=q_chunk)
    toks = np.random.default_rng(L).integers(0, cfg.vocab_size, (1, L)).astype(np.int32)
    monkeypatch.setattr(ttransformer, "_prefill_attn", lambda *a: tfp.flash_prefill_plain)
    lt, ct, _ = prefill(pt, cfg, torch.from_numpy(toks), cache_len=32)
    lo, _, _ = jprefill(pj, cfg_j, jnp.asarray(toks), cache_len=32)
    monkeypatch.setattr(jlayers, "mha_prefill_ref", _jax_k7)
    monkeypatch.setattr(jtransformer, "mha_prefill_chunked", _jax_k7)
    lj, cj, _ = jprefill(pj, cfg_j, jnp.asarray(toks), cache_len=32)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **BF16)
    for i in range(cfg.n_layers):
        np.testing.assert_allclose(ct[i]["k"].float().numpy(), _np(cj[0][0]["k"][i]), **BF16)
        np.testing.assert_allclose(ct[i]["v"].float().numpy(), _np(cj[0][0]["v"][i]), **BF16)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lo), rtol=BACKEND_TOL, atol=BACKEND_TOL)
    assert int(lt.argmax()) == int(np.asarray(lj).argmax()) == int(np.asarray(lo).argmax())


def test_prefill_attention_by_device(model):
    """K7 on CUDA at every prompt length; on the CPU what the reference
    computes, switching to the q-chunked attention above ``attn_q_chunk``."""
    cfg = model[1]
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for L in (1, cfg.attn_q_chunk, cfg.attn_q_chunk + 1, 3000):
        assert _prefill_attn(cfg, L, cuda) is tfp.flash_prefill
    assert _prefill_attn(cfg, cfg.attn_q_chunk, cpu) is mha_prefill_ref
    chunked = _prefill_attn(cfg, cfg.attn_q_chunk + 1, cpu)
    assert chunked.func is mha_prefill_chunked and chunked.keywords == {"q_chunk": cfg.attn_q_chunk}
