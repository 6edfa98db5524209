"""Sequence-parallel decode on the port against the JAX reference:
``chunk_partial``, ``tree_merge``, the merge as a collective,
``sp_decode_attention`` on the reference's three plans, the int8
all-reduce, and the smoke gemma3's serve step under ``seq_model``.

The JAX side runs once, in a subprocess on eight host devices
(``tests/_torch_dist_ref.py``, as ``tests/test_distributed.py`` runs the
reference's own); the port's side runs once, on the eight ranks of one
spawned ``gloo`` group over a ``(data=4, model=2)`` CPU mesh, each rank on
its own shards (``tests/_torch_dist.py``); the tests compare the two.

Tolerances: float32 attention within 2e-5 of JAX's and of the plain oracle
(the reference's contract, ``tests/test_paged_invariants.py:177-180``):
K2's plain version and the reference's einsums sum in other orders. The
merge and the int8 all-reduce within 1e-6 (float32 ops, the same order of
operands). The serve step's logits within one bf16 step of their scale,
``2**-7`` relative plus ``2**-7`` absolute, as the smoke parity tests
(``tests/test_torch_archs.py``) hold the single-device step: both sides
round at the same places; the reference rounds the probabilities to bf16
before the PV product, K2 does not. Greedy streams equal, or parting only
where the reference's top-2 gap is below ``NEAR_TIE`` (``tests/
_torch_dist.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_dist import (  # noqa: E402
    BF16,
    SP_PLANS,
    SP_SHAPE,
    block,
    held_to,
    merge_partials,
    psum_input,
    run_both,
    sp_inputs,
)

WORLD = 8
ATTN_TOL = 2e-5


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return run_both("sp", WORLD, tmp_path_factory.mktemp("sp"))


@pytest.fixture(scope="module")
def ref(both):
    return both[1]


@pytest.fixture(scope="module")
def ranks(both):
    return both[2]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_partial_matches_jax(dtype):
    from repro.core.attention import chunk_partial as jchunk
    from repro_torch.core.attention import chunk_partial

    rng = np.random.default_rng(1)
    q = rng.standard_normal((3, 2, 4, 16)).astype(np.float32)
    k = rng.standard_normal((3, 2, 24, 16)).astype(np.float32)
    v = rng.standard_normal((3, 2, 24, 16)).astype(np.float32)
    valid = np.array([0, 7, 24], np.int32)[:, None, None, None]   # an empty chunk
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jchunk(*(jnp.asarray(a, jd) for a in (q, k, v)), 0.25, valid_len=jnp.asarray(valid))
    got = chunk_partial(*(torch.from_numpy(a).to(td) for a in (q, k, v)), 0.25,
                        valid_len=torch.from_numpy(valid))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [1, 2, 5, 8])
def test_tree_merge_matches_jax(n):
    from repro.core.merge import AttnPartial as JP, finalize as jfin, tree_merge as jtree
    from repro_torch.core.merge import AttnPartial, finalize, tree_merge

    o, m, l = merge_partials(n)
    want = jtree(JP(*(jnp.asarray(a) for a in (o, m, l))))
    got = tree_merge(AttnPartial(*(torch.from_numpy(a) for a in (o, m, l))))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(finalize(got).numpy(), np.asarray(jfin(want)), rtol=1e-6,
                               atol=1e-6)


def test_ranks_sit_row_major(ranks):
    """Rank r of a (data, model) mesh sits at (r // model, r % model), so a
    rank's index over ("data", "model") is JAX's ``axis_index`` of it."""
    assert [r["coord"] for r in ranks] == [(r // 2, r % 2) for r in range(WORLD)]


def test_production_mesh_needs_its_ranks(ranks):
    """The reference's production meshes, (16, 16) and (2, 16, 16), are
    refused on a group of 8 ranks."""
    for r in ranks:
        assert len(r["refused"]) == 2 and all("has 8" in m for m in r["refused"])


def test_lean_merge_collective_matches_merge_n(ranks):
    """Four ranks (the data axis) merge their own partials, two rows empty
    on some ranks: every rank finalizes JAX's ``merge_n`` of the four, with
    the same bits as the others."""
    from repro.core.merge import AttnPartial as JP, finalize as jfin, merge_n

    want = np.asarray(jfin(merge_n(JP(*(jnp.asarray(a) for a in merge_partials(4))))))
    for r in ranks:
        np.testing.assert_allclose(r["merge"], want, rtol=1e-6, atol=1e-6)
        assert np.array_equal(r["merge"], ranks[0]["merge"])


@pytest.mark.parametrize("plan", range(len(SP_PLANS)), ids=lambda i: "+".join(
    SP_PLANS[i]["seq_axis"]))
def test_sp_decode_attention_plans(ref, ranks, plan):
    """Each rank's block of the output against the same block of JAX's
    ``sp_decode_attention`` and of ``mha_decode_ref``, with the lengths
    drawn as the reference draws them: many rank-row pairs hold no valid
    key (checked below)."""
    want = ref
    B, Hq, Hkv, S, d = SP_SHAPE
    ctx = sp_inputs()[3]
    seq = SP_PLANS[plan]["seq_axis"]
    n_seq = int(np.prod([{"data": 4, "model": 2}[a] for a in seq]))
    assert (ctx <= S - S // n_seq).any(), "no rank-row pair is empty"
    for r, res in enumerate(ranks):
        got, spec = res[f"plan{plan}"]
        coord = {"data": r // 2, "model": r % 2}
        np.testing.assert_allclose(got, block(want[f"plan{plan}"], spec, coord),
                                   rtol=0, atol=ATTN_TOL)
        np.testing.assert_allclose(got, block(want["ref"], spec, coord), rtol=0, atol=ATTN_TOL)


def test_compressed_psum_matches_jax(ref, ranks):
    want = ref
    for r, res in enumerate(ranks):
        w = want["psum"][r // 2:r // 2 + 1]
        np.testing.assert_allclose(res["psum"], w, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(res["psum_mean"], w / 4, rtol=1e-6, atol=1e-6)
    # one quantization step per element of each of the four summands
    exact = psum_input().sum(0)
    step = np.abs(psum_input()).max() / 127
    assert np.abs(ranks[0]["psum"][0] - exact).max() <= 4 * step / 2 + 1e-6


def test_serve_step_seq_model_logits_match_jax(ref, ranks):
    """``make_serve_step`` under ``decode_plan``'s ``seq_model`` on the
    ``(2, 4)`` mesh (batch over data, the 64-position caches over model:
    the prompt's 52 positions leave the last block part-empty, and it takes
    every decoded token): each rank's rows against JAX's, teacher-forced by
    neither side -- each decodes its own greedy stream."""
    js = ref["serve"]
    for r, res in enumerate(ranks):
        assert res["plan"] == js["plan"] == {"mode": "seq_model", "seq_axes": ("model",),
                                             "batch_spec": "data"}
        rows = slice((r // 4) * 2, (r // 4) * 2 + 2)
        held_to(res["sp"]["tokens"], js["tokens"][:, rows], js["logits"][:, rows], r)
        same = (res["sp"]["tokens"] == js["tokens"][:, rows]).all(0)
        np.testing.assert_allclose(res["sp"]["logits"][:, same], js["logits"][:, rows][:, same],
                                   **BF16)


def test_serve_step_seq_model_against_plain_step(ranks):
    """The port's sequence-parallel step against its own ``mesh=None``
    step on the whole cache; the ranks of a sequence group agree bit for
    bit."""
    for r, res in enumerate(ranks):
        rows = slice((r // 4) * 2, (r // 4) * 2 + 2)
        plain = res["plain"]
        held_to(res["sp"]["tokens"], plain["tokens"][:, rows], plain["logits"][:, rows], r)
        np.testing.assert_allclose(res["sp"]["logits"], plain["logits"][:, rows], **BF16)
        group = ranks[(r // 4) * 4]
        assert np.array_equal(res["sp"]["logits"], group["sp"]["logits"])


def test_serve_step_writes_the_owning_block(ref, ranks):
    """After the steps every rank's cache blocks equal the same blocks of
    the reference's cache: each new token's K/V landed in the block that
    holds its position and nowhere else; the window rings are whole."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import cache_from_numpy, layer_kinds

    cfg = get_smoke_config("gemma3-4b")
    final = cache_from_numpy(ref["serve"]["cache"], cfg, device="cpu")
    for r, res in enumerate(ranks):
        coord = {"data": r // 4, "model": r % 4}
        sizes = {"data": 2, "model": 4}
        for kind, lc, want in zip(layer_kinds(cfg), res["sp"]["cache"], final):
            spec = ("data", None, "model", None) if kind == "attn" else ("data", None, None, None)
            for name in ("k", "v"):
                w = block(want[name].float().numpy(), spec, coord, sizes)
                np.testing.assert_allclose(lc[name], w, **BF16)
