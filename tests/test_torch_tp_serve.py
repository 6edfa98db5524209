"""Tensor-parallel serving (plan ``heads``) on the port against the JAX
reference's sharded steps: the smoke configurations of mistral-nemo,
gemma3, llama-3.2-vision (with image embeddings), nemotron and yi on a
``(data=4, model=2)`` mesh at batch 8 under layout "2d" (the smoke configs
pick dp_only), each rank holding its blocks of the parameters
(``param_specs(mode="serve")``), of the batch and of the caches.

The JAX side runs once in a subprocess on eight host devices (parameters
and caches ``device_put`` by the reference's specs, both steps under
``jax.jit``); the port's on the eight ranks of one spawned ``gloo`` group
(``tests/_torch_dist.py``). Each case: the prefill's logits and four
greedy serve steps against JAX's sharded steps and the port's one-device
steps (``TP_TOL``, and streams equal or parting at a near tie), the ranks
of a ``model`` group bit for bit equal, each rank's prefill cache block
against the same block of JAX's cache by ``cache_specs``, and its
parameter blocks against numpy's blocks of the same specs. The MoE and
``(2, 4)`` cases are ``test_torch_tp_moe.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_dist import (  # noqa: E402
    TP_STEPS,
    run_tp,
    tp_against,
    tp_cache_blocks,
    tp_held,
    tp_model_groups_equal,
)

CASES = ("mistral-nemo", "gemma3", "llama-vision", "nemotron", "yi")


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return run_tp(CASES, tmp_path_factory.mktemp("tp_serve"))


@pytest.fixture(scope="module")
def ref(both):
    return both[1]


@pytest.fixture(scope="module")
def ranks(both):
    return both[2]


@pytest.mark.parametrize("name", CASES)
def test_decode_plan_is_heads(ref, ranks, name):
    want = {"mode": "heads", "seq_axes": None, "batch_spec": "data"}
    assert ref[name]["plan"] == want
    assert all(r[name]["plan"] == want for r in ranks)


@pytest.mark.parametrize("name", CASES)
def test_steps_match_jax_sharded(ref, ranks, name):
    held = tp_held(ranks, name)
    n = sum(tp_against(r[name], ref[name], name, held, f"{name} rank {i}")
            for i, r in enumerate(ranks))
    assert n >= len(ranks) * TP_STEPS       # half the rows' steps at least: most streams agree


@pytest.mark.parametrize("name", CASES)
def test_steps_match_one_device(ranks, name):
    held = tp_held(ranks, name)
    for i, r in enumerate(ranks):
        tp_against(r[name], ranks[0][name]["one"], name, held, f"{name} rank {i}")


@pytest.mark.parametrize("name", CASES)
def test_model_group_bit_for_bit(ranks, name):
    assert tp_model_groups_equal(ranks, name) == 4


@pytest.mark.parametrize("name", CASES)
def test_prefill_cache_blocks(ref, ranks, name):
    tp_cache_blocks(ref, ranks, name)


@pytest.mark.parametrize("name", CASES)
def test_parameter_blocks_are_numpy_blocks(ranks, name):
    for r in ranks:
        cut = r[name]["cut"]
        assert cut["bad"] == [] and cut["split"] > 0, (name, cut)
        assert r[name]["drawn"], name
