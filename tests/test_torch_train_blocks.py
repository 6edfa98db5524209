"""The training forms on the port against the JAX package: ``forward``'s
logits and aux loss on float32 master weights; the recurrent blocks'
backward -- the chunked mLSTM across chunks, and the sLSTM at
xlstm-350m's full width, whose gradients overflow in both packages (the
reference's init)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import forward as jforward, init_params as jinit  # noqa: E402
from repro.models import recurrent as jrec  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import forward, params_from_numpy  # noqa: E402
from repro_torch.models import recurrent as trec  # noqa: E402


@pytest.mark.parametrize("T", [24, 20])
def test_mlstm_chunked_backward_matches_jax(T):
    """The chunked mLSTM's backward across chunks (chunk 8: three chunks,
    the state carried between them; at 20 tokens the last chunk padded),
    each chunk rematerialised, against ``jax.grad`` of the reference's: the
    bf16 q/k/v gradients within 2**-6 of their largest (one bf16 step and
    a half; measured 0.7%), the float32 gate gradients within 1e-5
    (measured 2.5e-6)."""
    rng = np.random.default_rng(0)
    B, H, hd = 2, 2, 16
    q, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32) for _ in range(3))
    ip = rng.standard_normal((B, T, H)).astype(np.float32)
    lf = -np.log1p(np.exp(-rng.standard_normal((B, T, H)) - 2)).astype(np.float32)
    W = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    Wc = rng.standard_normal((B, H, hd, hd)).astype(np.float32)

    def fj(q, k, v, ip, lf):
        h, (C, _, _) = jrec.mlstm_sequence_chunked(q, k, v, ip, lf, chunk=8)
        return (h.astype(jnp.float32) * W).sum() + (C * Wc).sum()

    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = jax.grad(fj, argnums=(0, 1, 2, 3, 4))(*bf, jnp.asarray(ip), jnp.asarray(lf))
    args = [torch.from_numpy(np.asarray(a.astype(jnp.float32))).bfloat16().requires_grad_()
            for a in bf] + [torch.from_numpy(a).requires_grad_() for a in (ip, lf)]
    h, (C, _, _) = trec.mlstm_sequence_chunked(*args, chunk=8)
    ((h.float() * torch.from_numpy(W)).sum() + (C * torch.from_numpy(Wc)).sum()).backward()
    for i, (a, t) in enumerate(zip(want, args)):
        a = np.asarray(a.astype(jnp.float32))
        tol = 2.0 ** -6 if i < 3 else 1e-5
        np.testing.assert_allclose(t.grad.float().numpy(), a, rtol=0,
                                   atol=tol * np.abs(a).max(), err_msg=f"argument {i}")


def test_slstm_gradients_overflow_at_full_width_in_both_packages():
    """The reference's sLSTM init (ROADMAP queue 3: ``r`` drawn with fan-in
    = heads, std 0.5 at xlstm-350m's 4 heads of 256) makes the recurrence
    chaotic, and its backward explodes: the gradient of an input grows
    about 10**0.1 a token. At xlstm-350m's full width, on the same weights
    and inputs, both packages' input gradients are finite at 128 tokens
    (about 1e17) and non-finite at 320 (float32 overflows): the port
    trains as the reference does, this fault included."""
    D, H = 1024, 4
    pj = jrec.slstm_init(jax.random.PRNGKey(0), D, H)
    pt = {k: torch.from_numpy(np.array(v)) for k, v in jax.tree.map(np.asarray, pj).items()}
    rng = np.random.default_rng(0)
    grad_j = jax.jit(jax.grad(lambda x, w: (jrec.slstm_forward(pj, x, H)[0].astype(jnp.float32)
                                            * w).sum()))
    for T, finite in ((128, True), (320, False)):
        x = rng.standard_normal((1, T, D)).astype(np.float32)
        w = rng.standard_normal((1, T, D)).astype(np.float32)
        xt = torch.from_numpy(x).requires_grad_()
        out, _ = trec.slstm_forward(pt, xt, H)
        (out.float() * torch.from_numpy(w)).sum().backward()
        gj = np.asarray(grad_j(jnp.asarray(x), jnp.asarray(w)))
        assert bool(torch.isfinite(xt.grad).all()) == finite, T
        assert bool(np.isfinite(gj).all()) == finite, T
        if finite:
            assert np.abs(gj).max() > 1e12 and float(xt.grad.abs().max()) > 1e12


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "llama-3.2-vision-11b", "xlstm-350m"])
def test_forward_matches_jax(arch):
    """``forward`` on float32 master weights: the ``(B, L, V)`` logits
    within a bf16 step of their scale (2**-7, the model-level tolerance of
    ``tests/test_torch_archs.py``; measured 0 for the attention models and
    2**-10 for xlstm's) and the MoE aux loss within 1e-6 relative (measured
    equal), against the jitted reference."""
    cj, ct = jax_smoke(arch), get_smoke_config(arch)
    pj = jinit(jax.random.PRNGKey(2), cj)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cj.vocab_size, (2, 12)).astype(np.int32)
    img = (rng.standard_normal((2, cj.cross_kv_len, cj.d_model)).astype(np.float32)
           if cj.cross_kv_len else None)
    lj, aj = jax.jit(lambda p, t, i: jforward(p, cj, t, i))(
        pj, jnp.asarray(toks), None if img is None else jnp.asarray(img))
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), ct, "cpu", dtype=torch.float32)
    lt, at = forward(pt, ct, torch.from_numpy(toks), None if img is None else torch.from_numpy(img))
    lj = np.asarray(lj)
    np.testing.assert_allclose(lt.numpy(), lj, rtol=2 ** -7, atol=2 ** -7 * np.abs(lj).max())
    assert abs(float(at) - float(aj)) <= 1e-6 * abs(float(aj))
