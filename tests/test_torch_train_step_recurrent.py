"""Training on the port against the JAX package (``tests/_torch_train.py``
has the cases and their tolerances): the recurrent blocks' backward --
recurrentgemma-9b (two RG-LRU layers, their odd/even scan, and a window
attention layer) and xlstm-350m (two mLSTM layers in their chunked form,
each chunk rematerialised, and an sLSTM layer). The blocks' own
backward: ``tests/test_torch_train_blocks.py``."""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import _torch_train as tt  # noqa: E402

ARCHS = ["recurrentgemma-9b", "xlstm-350m"]


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

