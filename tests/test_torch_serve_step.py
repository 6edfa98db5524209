"""The smoke gemma3's serve step under ``seq_all`` on the port against the
JAX reference: ``decode_plan`` on a ``(data=2, model=2)`` mesh at batch 3
(which no data split divides) gives the full-mesh sequence split, each of
the four ranks holding 16 of the 64 cache positions; the 52-token prompt
leaves the last block part-empty, and it takes every decoded token.

The JAX side runs once in a subprocess on four of eight host devices, the
port's on the four ranks of one spawned ``gloo`` group
(``tests/_torch_dist.py``). Tolerances and the greedy rule are those of
``tests/test_torch_sp_decode.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_dist import BF16, CACHE, PROMPT, block, held_to, run_both  # noqa: E402

WORLD = 4


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return run_both("seq_all", WORLD, tmp_path_factory.mktemp("seq_all"))


@pytest.fixture(scope="module")
def ranks(both):
    return both[2]


def test_decode_plan_is_seq_all(both, ranks):
    want = {"mode": "seq_all", "seq_axes": ("data", "model"), "batch_spec": None}
    assert both[1]["serve"]["plan"] == want
    assert all(r["plan"] == want for r in ranks)


def test_logits_and_streams_match_jax(both, ranks):
    js = both[1]["serve"]
    for r, res in enumerate(ranks):
        held_to(res["sp"]["tokens"], js["tokens"], js["logits"], r)
        same = (res["sp"]["tokens"] == js["tokens"]).all(0)
        assert same.any()
        np.testing.assert_allclose(res["sp"]["logits"][:, same], js["logits"][:, same], **BF16)


def test_ranks_agree_bit_for_bit(ranks):
    for res in ranks[1:]:
        assert np.array_equal(res["sp"]["logits"], ranks[0]["sp"]["logits"])
        assert np.array_equal(res["sp"]["tokens"], ranks[0]["sp"]["tokens"])


def test_against_plain_step(ranks):
    for r, res in enumerate(ranks):
        held_to(res["sp"]["tokens"], res["plain"]["tokens"], res["plain"]["logits"], r)
        np.testing.assert_allclose(res["sp"]["logits"], res["plain"]["logits"], **BF16)


def test_last_block_part_empty_takes_the_new_tokens(both, ranks):
    """Block 3 holds positions 48-63: the prompt fills 48-51, the decoded
    tokens 52-55; blocks 0-2 end as the prefill left them, and every block
    equals the reference's after the steps."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import cache_from_numpy, layer_kinds

    cfg = get_smoke_config("gemma3-4b")
    before = cache_from_numpy(both[0]["cache"], cfg, device="cpu")
    after = cache_from_numpy(both[1]["serve"]["cache"], cfg, device="cpu")
    block_len = CACHE // WORLD
    assert (PROMPT - 1) // block_len == WORLD - 1 and PROMPT % block_len
    spec, sizes = (None, None, ("data", "model"), None), {"data": 2, "model": 2}
    for r, res in enumerate(ranks):
        coord = {"data": r // 2, "model": r % 2}
        for kind, lc, b, a in zip(layer_kinds(cfg), res["sp"]["cache"], before, after):
            if kind != "attn":
                continue
            for name in ("k", "v"):
                got = lc[name]
                np.testing.assert_allclose(got, block(a[name].float().numpy(), spec, coord, sizes),
                                           **BF16)
                if r < WORLD - 1:
                    assert np.array_equal(got, block(b[name].float().numpy(), spec, coord, sizes))
                else:
                    was = block(b[name].float().numpy(), spec, coord, sizes)
                    moved = np.abs(got - was).sum((0, 1, 3))
                    assert (np.nonzero(moved)[0] == np.arange(PROMPT, PROMPT + 4) - 48).all()


def test_no_global_layer_runs_whole(ranks):
    """recurrentgemma (RG-LRU and window layers) under ``seq_all``: nothing
    to split, the plain step on every rank."""
    assert all(r["recurrent_whole"] for r in ranks)

