"""Parity of the port's stream-K scheduler copy with the reference: every
host-side array the kernels consume must be equal, element for element."""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import leantile as jlt  # noqa: E402
from repro_torch.core import leantile as tlt  # noqa: E402

_FIELDS = (
    "tile_size", "num_workers", "tiles_per_worker", "total_tiles",
    "num_segments", "num_pieces",
)
_ARRAYS = (
    "iter_seg", "iter_tile", "iter_piece", "iter_first", "iter_last",
    "iter_len", "iter_valid", "piece_seg", "piece_host", "seg_batch",
    "seg_head", "seg_len",
)


def _assert_same_schedule(a, b):
    for f in _FIELDS:
        assert getattr(a, f) == getattr(b, f), f
    for f in _ARRAYS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    np.testing.assert_array_equal(a.packed_descriptors(), b.packed_descriptors())
    np.testing.assert_array_equal(a.fused_descriptors(), b.fused_descriptors())
    for fused in (False, True):
        for x, y in zip(a.iter_kv_meta(fused=fused), b.iter_kv_meta(fused=fused)):
            np.testing.assert_array_equal(x, y)
    for x, y in zip(a.piece_ranges(), b.piece_ranges()):
        np.testing.assert_array_equal(x, y)
    assert a.max_pieces_per_worker() == b.max_pieces_per_worker()
    assert a.signature == b.signature


@pytest.mark.parametrize("lens", [[1], [37, 1, 20], [4000, 1500, 700, 1], [129] * 5])
@pytest.mark.parametrize("heads", [1, 2, 8])
@pytest.mark.parametrize("tile", [8, 128])
@pytest.mark.parametrize("workers", [1, 4, 132])
def test_make_schedule_arrays_equal(lens, heads, tile, workers):
    _assert_same_schedule(
        jlt.make_schedule(lens, heads, tile, workers),
        tlt.make_schedule(lens, heads, tile, workers),
    )


@settings(max_examples=40, deadline=None)
@given(
    lens=st.lists(st.integers(1, 3000), min_size=1, max_size=6),
    heads=st.integers(1, 8),
    tile=st.sampled_from([8, 16, 64, 128, 256]),
    workers=st.integers(1, 140),
)
def test_make_schedule_arrays_equal_random(lens, heads, tile, workers):
    _assert_same_schedule(
        jlt.make_schedule(lens, heads, tile, workers),
        tlt.make_schedule(lens, heads, tile, workers),
    )


@pytest.mark.parametrize("n,tile,max_len", [(1, 8, None), (37, 8, 64), (4001, 128, 4096), (9, 16, 40)])
def test_bucket_length_equal(n, tile, max_len):
    assert jlt.bucket_length(n, tile, max_len) == tlt.bucket_length(n, tile, max_len)


def test_default_tile_size_kept():
    for d in (16, 64, 128, 256):
        assert tlt.default_tile_size(d) == jlt.default_tile_size(d)


def test_schedule_cache_hits_and_misses_match():
    """The engine's tick sequence: growing ragged lengths through one cache;
    the same lookups hit and miss, and hand out equal schedules."""
    rng = np.random.default_rng(3)
    cj, ct = jlt.ScheduleCache(max_entries=4), tlt.ScheduleCache(max_entries=4)
    lens = rng.integers(1, 60, 3)
    for _ in range(40):
        lens = lens + rng.integers(0, 3, 3)
        a = cj.get(lens.tolist(), 2, 8, 4, max_len=64)
        b = ct.get(lens.tolist(), 2, 8, 4, max_len=64)
        _assert_same_schedule(a, b)
        assert cj.stats.as_dict() == ct.stats.as_dict()
        assert len(cj) == len(ct)
    assert ct.stats.hits > 0 and ct.stats.misses > 0 and ct.stats.evictions > 0


def test_cascade_descriptors_equal():
    """The copy is whole: the cascade schedule (a later slice's input)
    already matches too."""
    args = ([70, 90, 40, 33], [(0, 1), (2, 3)], [3, 2], 2, 16, 5)
    (sj, bj), (st_, bt) = jlt.make_cascade_schedule(*args), tlt.make_cascade_schedule(*args)
    np.testing.assert_array_equal(
        jlt.cascade_fused_descriptors(sj, bj), tlt.cascade_fused_descriptors(st_, bt)
    )
    assert sj.signature == st_.signature
