"""``pipeline_forward`` and the backward rules of the tensor-parallel
collectives, on the ranks of one spawned ``gloo`` group of eight.

``pipeline_forward`` runs the reference's test (``tests/
test_distributed.py:134``: four ``tanh(x @ w)`` stages over ``pod`` of a
``(pod=4, data=2)`` mesh, six micro-batches), each rank its stage's weights,
against the stages run in sequence and against JAX's ``pipeline_forward``
on the same inputs (a subprocess on eight host devices), within the
reference test's float32 1e-5.

Each backward rule (``repro_torch/distributed/tensor_parallel.py``) is held
against one-rank autograd of the whole computation on a ``(data=4,
model=2)`` mesh: the column-parallel input and the row-parallel sum (an
MLP), the vocabulary-parallel lookup and logits (a cross entropy), and the
MoE's row gather (rows mixed across the batch). An all-reduce whose
backward sums the cotangent again counts the gradient ``model`` times.
"""
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_dist import _jax_ref, run_ranks  # noqa: E402

# float32 sums in another order
RULE_TOL = 1e-5
# the vocabulary case's logits are bf16 products on both sides, and so are
# their cotangents: each rank rounds its half of the vocabulary's
# contribution to bf16 before the float32 sum, where one rank rounds the
# whole; one bf16 step (2**-7) of the gradient's largest element
VOCAB_TOL = 2.0 ** -7


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe")
    in_path, out_path = tmp / "inputs.pkl", tmp / "ref.pkl"
    with open(in_path, "wb") as f:
        pickle.dump({}, f)
    proc = _jax_ref("pipe", in_path, out_path)
    try:
        ranks = run_ranks("pipe", 8, in_path)
    finally:
        log, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, log
    with open(out_path, "rb") as f:
        return pickle.load(f), ranks


def test_pipeline_matches_sequential_on_every_rank(both):
    _, ranks = both
    assert sorted(r["stage"] for r in ranks) == [0, 0, 1, 1, 2, 2, 3, 3]
    for r in ranks:
        np.testing.assert_allclose(r["pipe"], r["sequential"], rtol=1e-5, atol=1e-5)


def test_pipeline_matches_jax(both):
    ref, ranks = both
    for r in ranks:
        np.testing.assert_allclose(r["pipe"], ref["out"], rtol=1e-5, atol=1e-5)


def test_bubble_fraction():
    from repro_torch.distributed.pipeline import bubble_fraction

    from repro.distributed.pipeline import bubble_fraction as jax_bubble

    for p, m in ((4, 6), (1, 3), (8, 1), (2, 32)):
        assert bubble_fraction(p, m) == jax_bubble(p, m)
    assert 0 < bubble_fraction(4, 6) < 1


def test_bubble_fraction_in_ranks_and_jax(both):
    ref, ranks = both
    assert all(r["bubble"] == ref["bubble"] == 3 / 9 for r in ranks)


@pytest.mark.parametrize("rule", ["mlp", "rows"])
def test_backward_rule_matches_one_rank(both, rule):
    _, ranks = both
    for r in ranks:
        assert r["rules"][rule] <= RULE_TOL, (rule, r["rules"]["coord"], r["rules"][rule])


def test_vocab_parallel_backward_matches_one_rank(both):
    _, ranks = both
    for r in ranks:
        assert r["rules"]["vocab"] <= VOCAB_TOL * r["rules"]["vocab_scale"], r["rules"]


def test_summed_cotangent_counts_gradient_twice(both):
    # torch.distributed.nn's all_reduce sums the cotangent in its backward:
    # on model=2 the row-parallel block's gradient comes out doubled
    _, ranks = both
    for r in ranks:
        assert r["rules"]["nn_all_reduce"] > 100 * RULE_TOL, r["rules"]
