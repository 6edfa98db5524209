"""Training on the port against the JAX package (``tests/_torch_train.py``
has the cases and their tolerances): llama-3.2-vision-11b's smoke
configuration, whose fifth layer adds gated cross attention to the data
pipeline's stub image embeddings (the plain non-causal oracle on every
device)."""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import _torch_train as tt  # noqa: E402

ARCHS = ["llama-3.2-vision-11b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    tt.check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_update_matches_jax(arch):
    tt.check_adamw_update(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    tt.check_train_step(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_grad_accum_and_compression_match_jax(arch):
    tt.check_train_step(arch, grad_accum=2, compress=True)
