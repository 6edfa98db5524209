"""Tensor-parallel serving (plan ``heads``) on the port against the JAX
reference's sharded steps: the MoE smoke configurations and the ``(data=2,
model=4)`` mesh. qwen3-moe (8 experts over model=2: expert parallelism,
each rank its 4 experts' slots) and qwen2-moe (6 experts: EP over model=2;
over model=4 expert-TP, each expert's hidden width split, and its shared
expert row-parallel), and musicgen (sinusoidal positions, whole on every
rank) on both meshes, at batch 8 under layout "2d".

The harness and the checks are ``test_torch_tp_serve.py``'s. A MoE row is
held only where its routing keeps a margin (``ROUTER_MARGIN``, ``tests/
_torch_dist.py``): the smoke routers' probabilities tie exactly in bf16,
and the sharded steps' rounding flips such choices, as JAX's own sharded
steps do against its one-device steps.

The MoE across the data split: qwen3-moe's first MoE at a capacity factor
of 1.0, which drops pairs, on seeded rows split over data=4. Each rank
gathers the other data ranks' rows before the dispatch, so the capacity and
the drops are the global batch's: its rows equal the one-device MoE's and
JAX's sharded ``moe_forward``'s, and differ where each data rank routes only
its own rows.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_dist import (  # noqa: E402
    TP_BATCH,
    TP_STEPS,
    TP_TOL,
    block,
    run_tp,
    tp_against,
    tp_cache_blocks,
    tp_held,
    tp_model_groups_equal,
)

CASES = ("qwen3-moe", "qwen2-moe", "musicgen", "musicgen-2x4", "qwen2-moe-2x4")
DROPS, EXPERT_TP = "qwen3-drops", "qwen2-moe-alone-2x4"
# the MoE alone on equal inputs: the float32 combine rounded once, and under
# expert-TP each rank's bf16 partial of each expert's output: a bf16 step
# (2**-7) of the output's largest magnitude
MOE_ALONE = 2**-7


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return run_tp(CASES + (DROPS, EXPERT_TP), tmp_path_factory.mktemp("tp_moe"))


@pytest.fixture(scope="module")
def ref(both):
    return both[1]


@pytest.fixture(scope="module")
def ranks(both):
    return both[2]


@pytest.mark.parametrize("name", CASES + (DROPS, EXPERT_TP))
def test_decode_plan_is_heads(ref, ranks, name):
    assert ref[name]["plan"]["mode"] == "heads"
    assert all(r[name]["plan"] == ref[name]["plan"] for r in ranks)


@pytest.mark.parametrize("name", CASES)
def test_steps_match_jax_sharded(ref, ranks, name):
    """The prefill's logits on every row (the sharded prefills round alike:
    no router choice flips between them on these inputs), the steps on the
    rows :func:`tp_held` keeps; musicgen has no MoE: every step."""
    held = tp_held(ranks, name)
    n = sum(tp_against(r[name], ref[name], name, held, f"{name} rank {i}", first_all=True)
            for i, r in enumerate(ranks))
    if name.startswith("musicgen"):      # every row on each rank of its model group
        assert n == TP_BATCH * TP_STEPS * (4 if name.endswith("2x4") else 2)


@pytest.mark.parametrize("name", CASES)
def test_steps_match_one_device(ranks, name):
    held = tp_held(ranks, name)
    for i, r in enumerate(ranks):
        tp_against(r[name], ranks[0][name]["one"], name, held, f"{name} rank {i}")


@pytest.mark.parametrize("name", CASES)
def test_model_group_bit_for_bit(ranks, name):
    assert tp_model_groups_equal(ranks, name) == (2 if name.endswith("2x4") else 4)


@pytest.mark.parametrize("name", CASES)
def test_prefill_cache_blocks(ref, ranks, name):
    tp_cache_blocks(ref, ranks, name)


@pytest.mark.parametrize("name", CASES)
def test_parameter_blocks_are_numpy_blocks(ranks, name):
    for r in ranks:
        cut = r[name]["cut"]
        assert cut["bad"] == [] and cut["split"] > 0, (name, cut)
        assert r[name]["drawn"], name


def _moe_alone(ref, ranks, name, sizes):
    """Each rank's rows of the MoE alone against the one-device MoE's and
    JAX's sharded ``moe_forward``'s."""
    one = ranks[0][name]["one"]
    for i, r in enumerate(ranks):
        res = r[name]
        coord = dict(zip(("data", "model"), res["coord"]))
        tol = dict(rtol=MOE_ALONE, atol=MOE_ALONE * np.abs(one["moe"]).max())
        for want in (one["moe"], ref[name]["moe"]):
            np.testing.assert_allclose(res["moe"], block(want, ("data", None, None), coord, sizes),
                                       **tol, err_msg=f"{name} rank {i}")
    return one


def test_moe_drops_route_the_global_batch(ref, ranks):
    """EP: each rank runs qwen3's 4 experts from expert 0 or 4; the
    capacity binds (pairs are dropped), and only the global batch's routing
    gives the one-device rows."""
    assert [r[DROPS]["expert_offset"] for r in ranks] == [0, 4] * 4
    one = _moe_alone(ref, ranks, DROPS, {"data": 4, "model": 2})
    assert one["drops"] > 0
    for i, r in enumerate(ranks):
        coord = dict(zip(("data", "model"), r[DROPS]["coord"]))
        mine = block(one["moe"], ("data", None, None), coord, {"data": 4, "model": 2})
        assert not np.allclose(r[DROPS]["local_routing"], mine, **TP_TOL), i


def test_expert_tp_alone(ref, ranks):
    """Expert-TP: qwen2's 6 experts do not divide model=4, so every rank
    holds every expert's quarter of ``d_ff_expert`` and a quarter of the
    shared expert."""
    assert all(r[EXPERT_TP]["expert_offset"] == 0 for r in ranks)
    _moe_alone(ref, ranks, EXPERT_TP, {"data": 2, "model": 4})
