"""Parity of the port's associative merge with the reference, identity
(-inf) inputs included."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

jm = importlib.import_module("repro.core.merge")
tm = importlib.import_module("repro_torch.core.merge")

TOL = dict(rtol=1e-6, atol=1e-6)   # float32, same formulas, one op order


def _partials(rng, lead, g=3, d=5, empty=()):
    o = rng.standard_normal(lead + (g, d)).astype(np.float32)
    m = rng.standard_normal(lead + (g,)).astype(np.float32)
    l = (rng.random(lead + (g,)) + 0.1).astype(np.float32)
    for i in empty:                           # identity elements
        o[i], m[i], l[i] = 0.0, -np.inf, 0.0
    return o, m, l


def _j(o, m, l):
    return jm.AttnPartial(jnp.asarray(o), jnp.asarray(m), jnp.asarray(l))


def _t(o, m, l):
    return tm.AttnPartial(torch.from_numpy(o), torch.from_numpy(m), torch.from_numpy(l))


def _close(a, b):
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), y.numpy(), **TOL)


@pytest.mark.parametrize("empty", [(), (0,), (1,), (0, 1)])
def test_merge(empty):
    rng = np.random.default_rng(0)
    o, m, l = _partials(rng, (2,), empty=empty)
    _close(
        jm.merge(_j(o[0], m[0], l[0]), _j(o[1], m[1], l[1])),
        tm.merge(_t(o[0], m[0], l[0]), _t(o[1], m[1], l[1])),
    )


@pytest.mark.parametrize("empty", [(), (2,), (0, 1, 2, 3)])
def test_merge_n_and_finalize(empty):
    rng = np.random.default_rng(1)
    p = _partials(rng, (4,), empty=empty)
    rj, rt = jm.merge_n(_j(*p)), tm.merge_n(_t(*p))
    _close(rj, rt)
    if len(empty) < 4:
        np.testing.assert_allclose(
            np.asarray(jm.finalize(rj)), tm.finalize(rt).numpy(), **TOL
        )


@pytest.mark.parametrize(
    "ids,empty",
    [
        ([0, 0, 1, 1, 1, 2], ()),
        ([0, 0, 2, 2, 2, 5, 4], (2,)),          # empty segments 1, 3; padding id 5
        ([3, 0, 3, 1, 0, 2], (0, 5)),            # unsorted ids
        ([1, 1, 1], (0, 1, 2)),                  # all-identity segment
    ],
)
def test_segment_merge(ids, empty):
    rng = np.random.default_rng(2)
    p = _partials(rng, (len(ids),), empty=empty)
    ids = np.asarray(ids, np.int32)
    S = 5
    _close(
        jm.segment_merge(_j(*p), jnp.asarray(ids), S),
        tm.segment_merge(_t(*p), torch.from_numpy(ids), S),
    )


def test_segment_merge_is_deterministic():
    """Repeated merges of one input are bit-identical (no atomic order)."""
    rng = np.random.default_rng(4)
    p = _t(*_partials(rng, (40,), g=4, d=16))
    ids = torch.from_numpy(rng.integers(0, 6, 40).astype(np.int32))
    a, b = tm.segment_merge(p, ids, 6), tm.segment_merge(p, ids, 6)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
