"""Shared cases of the training parity tests (``test_torch_train_step*.py``):
the port's loss, gradients, AdamW update, train step, gradient
accumulation and int8 gradient compression against the JAX package's on
the same smoke configuration, weights and batch.

Every case runs a smoke configuration with ``attn_q_chunk`` and
``loss_chunk`` 16 on a batch of 2 x 24 tokens from the data pipeline, so
the q-chunked attention (a short last chunk) and the chunked cross
entropy (23 targets: two chunks, the second padded and masked) both run;
every stage unit is rematerialised (``remat``, the smoke default). The
weights are the JAX package's ``init_params`` with every all-zero leaf
(the norms, the cross-attention gate) perturbed by N(0, 0.1), so that
weight decay on them shows.

Tolerances, and why:

- loss, ce, aux: 2e-4 relative. Both sides round the same bf16 products;
  XLA's fusions keep some roundings in float32 that the port makes (the
  jitted reference), and float32 ``exp`` differs in the last bit. Measured
  at most 6.9e-5 (recurrentgemma), 0 for the dense attention models.
- gradients, per leaf: cosine >= 0.999, norm within 2%, and every element
  within 2**-4 of the leaf's largest. The cotangents of bf16 matmuls are
  rounded to bf16 on both sides, so an element moves by a bf16 step of its
  own size wherever a float32 sum crossed a rounding boundary in another
  order. Measured: cosine >= 0.99973, norm within 1.03%, elements within
  3.3% (recurrentgemma's conv weights). A missing or wrong term moves a
  leaf by its own size.
- AdamW on the same gradients: every element of the parameters and both
  moments within 4e-6 of the leaf's largest (float32 op for op; ``pow``
  and ``sqrt`` may differ by an ulp). Measured <= 1.0e-6.
- int8 compression of the same gradients: equal int8 values, scales
  within one float32 ulp.
- one train step: lr to 1e-7 relative, grad_norm within 5e-3 (the
  gradients' own tolerance, summed: measured <= 1.1e-3 uncompressed,
  2e-3 compressed), the first moment within the gradients' 2**-4 of the
  leaf's largest (the second within twice that), and the parameters
  within 1e-6 wherever the reference's first moment is above 2**-4 of
  its leaf's largest and above 1e-5 (a clipped gradient of 1e-4). Step 1
  of Adam moves an element by ``lr * g / (|g| + eps)``, about ``lr *
  sign(g)``: where the gradient sits at the rounding noise its sign is a
  coin toss on either side, and where it is within a few thousand ``eps``
  (llama-3.2-vision's gated ``ln_x``: gradients of 1e-7) the rounding moves
  the step itself; there the parameter may differ by up to ``2 lr``.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.data.pipeline import DataConfig, batch_at  # noqa: E402
from repro.models import init_params as jinit, loss_fn as jloss  # noqa: E402
from repro.training import optimizer as jopt, train_loop as jtrain  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch import training as ttrain  # noqa: E402
from repro_torch.training.tree import flatten  # noqa: E402

OPT_KW = dict(lr=1e-2, warmup_steps=1, weight_decay=0.1)
LOSS_RTOL = 2e-4
GRAD_COS, GRAD_NORM, GRAD_ELEM = 0.999, 0.02, 2.0 ** -4
ADAM_ELEM = 4e-6
GNORM_RTOL = 5e-3
PARAM_ATOL = 1e-6
FIRM_M = 1e-5


def configs(arch):
    kw = dict(attn_q_chunk=16, loss_chunk=16)
    return (dataclasses.replace(jax_smoke(arch), **kw),
            dataclasses.replace(get_smoke_config(arch), **kw))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def case(arch):
    """The configurations, the perturbed weights as numpy, the batch, and
    the reference's loss, metrics and gradients on them."""
    cj, ct = configs(arch)
    rng = np.random.default_rng(0)
    pn = _np(jinit(jax.random.PRNGKey(0), cj))
    pn = jax.tree.map(lambda a: a if a.any() else
                      (0.1 * rng.standard_normal(a.shape)).astype(np.float32), pn)
    dc = DataConfig(vocab_size=cj.vocab_size, seq_len=24, global_batch=2, seed=5,
                    img_tokens=cj.cross_kv_len, d_model=cj.d_model)
    batch = batch_at(dc, 3)
    vg = jax.jit(jax.value_and_grad(lambda p, b: jloss(p, cj, b), has_aux=True))
    (loss, metrics), grads = vg(jax.tree.map(jnp.asarray, pn), _jbatch(batch))
    return dict(cj=cj, ct=ct, pn=pn, batch=batch, loss=float(loss),
                metrics={k: float(v) for k, v in metrics.items()}, grads=_np(grads))


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _port_params(c):
    return params_from_numpy(c["pn"], c["ct"], "cpu", dtype=torch.float32)


def _close_rel(got, want, rtol, what):
    assert abs(got - want) <= rtol * abs(want), f"{what}: port {got}, reference {want}"


def assert_grads_close(want_tree, got_tree, what):
    paths, want = flatten(want_tree)
    gpaths, got = flatten(got_tree)
    assert paths == gpaths
    for path, a, b in zip(paths, want, got):
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        if na == 0:
            assert nb == 0, f"{what} {path}: the reference's gradient is zero, the port's not"
            continue
        cos = float((a * b).sum() / (na * nb))
        assert cos >= GRAD_COS, f"{what} {path}: cosine {cos}"
        assert abs(nb / na - 1) <= GRAD_NORM, f"{what} {path}: norm ratio {nb / na}"
        np.testing.assert_allclose(b, a, rtol=0, atol=GRAD_ELEM * np.abs(a).max(),
                                   err_msg=f"{what} {path}")


def check_loss_and_grads(arch):
    c = case(arch)
    (loss, metrics), grads = ttrain.value_and_grad(ttrain.make_loss(c["ct"]), _port_params(c),
                                                   _tbatch(c["batch"]))
    _close_rel(float(loss), c["loss"], LOSS_RTOL, "loss")
    for k in ("ce", "aux"):
        _close_rel(float(metrics[k]), c["metrics"][k], LOSS_RTOL, k)
    assert_grads_close(c["grads"], params_to_numpy(grads, c["ct"]), arch)


def check_adamw_update(arch):
    """Two AdamW steps on the reference's gradients, carried across: the
    stacked-rank weight decay rule, the moments, the schedule."""
    c = case(arch)
    opt = jopt.OptConfig(**OPT_KW)
    pj = jax.tree.map(jnp.asarray, c["pn"])
    oj = jopt.adamw_init(pj)
    gj = jax.tree.map(jnp.asarray, c["grads"])
    pt = _port_params(c)
    ot = ttrain.adamw_init(pt)
    gt = params_from_numpy(c["grads"], c["ct"], "cpu", dtype=torch.float32)
    for _ in range(2):
        pj, oj, mj = jopt.adamw_update(gj, oj, pj, opt)
        pt, ot, mt = ttrain.adamw_update(gt, ot, pt, ttrain.OptConfig(**OPT_KW))
    assert int(ot["step"]) == 2 and ot["step"].dtype == torch.int32
    for k in ("lr", "grad_norm"):
        _close_rel(float(mt[k]), float(mj[k]), 1e-6, k)
    for name, want, got in (("params", pj, pt), ("m", oj["m"], ot["m"]), ("v", oj["v"], ot["v"])):
        paths, a = flatten(_np(want))
        _, b = flatten(params_to_numpy(got, c["ct"]))
        for path, x, y in zip(paths, a, b):
            np.testing.assert_allclose(y, x, rtol=0, atol=ADAM_ELEM * np.abs(x).max(),
                                       err_msg=f"{arch} {name} {path}")


def check_quantize_grads(arch):
    """int8 compression of the reference's gradients, carried across: one
    scale per stacked leaf (every repeat of a stage shares it)."""
    c = case(arch)
    qj, sj = jtrain.quantize_grads_int8(jax.tree.map(jnp.asarray, c["grads"]))
    gt = params_from_numpy(c["grads"], c["ct"], "cpu", dtype=torch.float32)
    qt, st = ttrain.quantize_grads_int8(gt, c["ct"])
    paths, qa = flatten(_np(qj))
    _, qb = flatten(params_to_numpy(qt, c["ct"]))
    for path, x, y in zip(paths, qa, qb):
        np.testing.assert_array_equal(y, x, err_msg=f"{arch} q {path}")
    # a stacked leaf's one scale against each of its layers' scales
    _, sa = flatten(_np(sj))
    sb = params_to_numpy(st, c["ct"])
    for path, x, y in zip(paths, sa, flatten(sb)[1]):
        np.testing.assert_allclose(y, np.broadcast_to(x, y.shape), rtol=2 ** -23,
                                   err_msg=f"{arch} scale {path}")
    deq = ttrain.dequantize_grads(qt, st)
    for x, s, y in zip(flatten(qt)[1], flatten(st)[1], flatten(deq)[1]):
        assert torch.equal(y, x.float() * s)


def check_train_step(arch, grad_accum=1, compress=False):
    c = case(arch)
    opt = jopt.OptConfig(**OPT_KW)
    jstep = jax.jit(jtrain.make_train_step(c["cj"], opt, grad_accum=grad_accum,
                                           compress_grads=compress))
    pj = jax.tree.map(jnp.asarray, c["pn"])
    pj, oj, mj = jstep(pj, jopt.adamw_init(pj), _jbatch(c["batch"]))
    pt = _port_params(c)
    step = ttrain.make_train_step(c["ct"], ttrain.OptConfig(**OPT_KW), grad_accum=grad_accum,
                                  compress_grads=compress)
    pt, ot, mt = step(pt, ttrain.adamw_init(pt), _tbatch(c["batch"]))
    assert set(mt) == set(mj)
    for k in ("loss", "ce", "aux"):
        _close_rel(float(mt[k]), float(mj[k]), LOSS_RTOL, k)
    _close_rel(float(mt["lr"]), float(mj["lr"]), 1e-7, "lr")
    _close_rel(float(mt["grad_norm"]), float(mj["grad_norm"]), GNORM_RTOL, "grad_norm")
    paths, mw = flatten(_np(oj["m"]))
    _, mg = flatten(params_to_numpy(ot["m"], c["ct"]))
    _, vw = flatten(_np(oj["v"]))
    _, vg = flatten(params_to_numpy(ot["v"], c["ct"]))
    _, pw = flatten(_np(pj))
    _, pg = flatten(params_to_numpy(pt, c["ct"]))
    lr = float(mj["lr"])
    for path, m0, m1, v0, v1, p0, p1 in zip(paths, mw, mg, vw, vg, pw, pg):
        what = f"{arch} {path}"
        scale = np.abs(m0).max()
        np.testing.assert_allclose(m1, m0, rtol=0, atol=GRAD_ELEM * scale, err_msg=what)
        np.testing.assert_allclose(v1, v0, rtol=0, atol=2 * GRAD_ELEM * np.abs(v0).max(),
                                   err_msg=what)
        firm = np.abs(m0) > max(GRAD_ELEM * scale, FIRM_M)
        np.testing.assert_allclose(p1[firm], p0[firm], rtol=0, atol=PARAM_ATOL, err_msg=what)
        assert np.abs(p1 - p0).max() <= 2 * lr * (1 + 1e-3) + PARAM_ATOL, what
