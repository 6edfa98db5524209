"""Training on the port against the JAX package (``tests/_torch_train.py``
has the cases and their tolerances): the dense attention model
(mistral-nemo) and the MoE (qwen3-moe: its Switch aux loss in the loss,
its router's gradient through it). Both smoke configurations stack two
repeats of one layer, so a stacked leaf's decay rule and its one int8
compression scale span two of the port's layers."""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import _torch_train as tt  # noqa: E402

ARCHS = ["mistral-nemo-12b", "qwen3-moe-30b-a3b"]


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


@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_grads_matches_jax(arch):
    tt.check_quantize_grads(arch)
