"""The decode ring's path rule and sizes (``repro_torch.kernels.decode_ring``),
which K1, K2, K5 and K6 pass to their kernels: how many shared-memory slots a CTA
streams its K/V tiles through, and where the walk over device memory
stays. Host arithmetic only; the kernels themselves are held to their plain
versions on the card (tests/test_torch_kernels_cuda.py)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_ring as dr
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import lean_decode as ld

BF16, F32, INT8 = 2, 4, 1


def test_row_bucket():
    assert [dr.row_bucket(n) for n in (1, 2, 3, 4, 5, 12, 16, 17, 40, 64)] == [
        2, 2, 4, 4, 8, 16, 16, 32, 64, 64]
    with pytest.raises(ValueError, match="up to 64"):
        dr.row_bucket(65)


def test_state_and_slot_bytes():
    # attn::smem_bytes at gq 4, d 128, tile 128: q, acc (4 x 128), p (4 x
    # 128) and m, l, alpha (4 each), float32
    assert dr.state_bytes(4, 128, 128) == 4 * (2 * 512 + 512 + 12) == 6192
    assert dr.slot_bytes(BF16, 128, 128) == 32768
    assert dr.slot_bytes(INT8, 128, 12) == 1536
    assert dr.slot_bytes(BF16, 64, 12) == 1536
    assert dr.slot_bytes(F32, 96, 1) == 384            # rounded up to 128


@pytest.mark.parametrize("elem,d,tile,rows,slots", [
    (BF16, 128, 128, 4, 6),     # K6 at the main path's shapes: 3 tiles in flight
    (F32, 128, 128, 4, 3),      # K6 on the fixed int8 path (float32 pages)
    (BF16, 128, 128, 16, 6),    # K5, 4 members x g 4
    (BF16, 128, 128, 64, 4),    # K5's 64-row bucket: 99 KB of float state
    (F32, 128, 128, 64, 2),
    (INT8, 128, 128, 16, 8),    # int8 slots hold 16 KB: MAX_SLOTS
    (INT8, 128, 128, 64, 8),
    (BF16, 128, 12, 4, 8),
    (BF16, 128, 256, 4, 3),
    (INT8, 128, 256, 64, 3),
])
def test_ring_slots(elem, d, tile, rows, slots):
    assert dr.ring_slots(elem, d, tile, rows) == slots
    assert dr.bytes_in_flight(elem, d, tile, rows) == slots * dr.slot_bytes(elem, d, tile)


@pytest.mark.parametrize("elem,d,tile,rows", [
    (F32, 128, 256, 4),         # a float32 K or V tile of 256 keys is 128 KB: one slot
    (F32, 128, 256, 64),
    (BF16, 128, 256, 64),       # beside the 64-row bucket's state
    (BF16, 12, 16, 4),          # rows of 24 bytes: not a bulk-copy unit
    (F32, 6, 16, 4),
])
def test_walk_over_device_memory_where_the_ring_does_not_fit(elem, d, tile, rows):
    assert dr.ring_slots(elem, d, tile, rows) == 0
    assert dr.bytes_in_flight(elem, d, tile, rows) == 0


def test_ring_fits_the_shared_memory_it_is_given():
    """Over a grid of shapes: the slots and the float state fit a CTA's
    shared memory beside its static part, one more slot would not (unless
    at MAX_SLOTS), and a ring has at least two slots."""
    for elem in (INT8, BF16, F32):
        for d in (16, 32, 64, 96, 128, 256):
            for tile in (8, 12, 16, 64, 100, 128, 256):
                for rows in dr.ROW_BUCKETS:
                    ns = dr.ring_slots(elem, d, tile, rows)
                    if ns == 0:
                        continue
                    used = ns * dr.slot_bytes(elem, d, tile) + dr.state_bytes(rows, d, tile)
                    room = dr.SMEM_LIMIT - dr.STATIC_BYTES
                    assert 2 <= ns <= dr.MAX_SLOTS and used <= room
                    assert d * elem % dr.COPY_ALIGN == 0
                    assert ns == dr.MAX_SLOTS or used + dr.slot_bytes(elem, d, tile) > room


def test_wrappers_read_the_rule():
    assert fd.ring_slots(torch.bfloat16, 4, 128, 128) == 6
    assert fd.ring_slots(torch.float32, 2, 128, 256) == 0
    # K5 sizes its state by the row bucket of the stacked prefix rows
    assert ld.ring_slots(torch.bfloat16, 12, 128, 128) == dr.ring_slots(
        BF16, 128, 128, 16)
    assert ld.ring_slots(torch.int8, 64, 128, 128) == 8
    assert ld.ring_slots(torch.float32, 16, 128, 256) == 0


@pytest.mark.parametrize("kv_dtype,rows,d,tile,slots", [
    (torch.bfloat16, 4, 128, 128, 6),   # K2 and K1 at the main path's shapes: 3 tiles in flight
    (torch.int8, 4, 128, 128, 8),       # K2-int8: 16 KB slots
    (torch.float32, 4, 128, 128, 3),
    (torch.bfloat16, 2, 64, 16, 8),     # the smoke config's g 2
    (torch.bfloat16, 3, 128, 128, 6),   # rows between the buckets take the next one
    (torch.bfloat16, 64, 128, 128, 4),  # the two-call cascade's stacked prefix rows
    (torch.float32, 64, 128, 128, 2),
    (torch.int8, 64, 128, 256, 3),
    (torch.bfloat16, 40, 128, 256, 0),  # a bf16 page of 256 beside the 64-row bucket
    (torch.float32, 4, 128, 256, 0),    # a float32 page of 256
])
def test_k1_k2_wrappers_read_the_rule(kv_dtype, rows, d, tile, slots):
    """K1's and K2's wrappers pass the rule's slots for their operands (the
    row bucket of gq); 0 picks the walk over device memory."""
    from repro_torch.core.leantile import make_schedule

    elem = 1 if kv_dtype == torch.int8 else torch.finfo(kv_dtype).bits // 8
    assert ld.ring_slots(kv_dtype, rows, d, tile) == slots == dr.ring_slots(
        elem, d, tile, dr.row_bucket(rows))
    sched = make_schedule([3 * tile, 5], 1, tile, 4)
    q = torch.zeros(2, rows, d, dtype=torch.float32 if kv_dtype == torch.float32
                    else torch.bfloat16)
    kv = torch.zeros(8, tile, d, dtype=kv_dtype)
    seg_ctx = torch.tensor([3 * tile, 5], dtype=torch.int32)
    route = torch.zeros(sched.grid_iters, dtype=torch.int32)
    assert ld._check_cuda(q, kv, kv, seg_ctx, route, sched, "K2") == slots


def test_k1_k2_on_cpu_tensors_count_no_launch():
    """On CPU tensors K1 and K2 run their plain versions: no launch, on the
    ring or off it."""
    from repro_torch.core.leantile import make_schedule

    rng = np.random.default_rng(1)
    sched = make_schedule([300, 7], 2, 128, 4)
    q = torch.as_tensor(rng.standard_normal((4, 4, 128)), dtype=torch.bfloat16)
    kv = torch.as_tensor(rng.standard_normal((8, 128, 128)), dtype=torch.bfloat16)
    route = torch.as_tensor(rng.integers(0, 8, sched.grid_iters), dtype=torch.int32)
    seg_ctx = torch.tensor([300, 300, 7, 7], dtype=torch.int32)
    ld.reset_launch_counts()
    o, lse = ld.lean_decode_fused(q, kv, kv, seg_ctx, route, sched, 128 ** -0.5)
    parts = ld.lean_decode_partials(q, kv, kv, seg_ctx, route, sched, 128 ** -0.5)
    assert o.shape == (4, 4, 128) and parts[0].shape[1:] == (4, 128)
    assert (ld.fused_launches, ld.fused_ring_launches, ld.partials_launches,
            ld.partials_ring_launches) == (0, 0, 0, 0)


def test_cpu_tensors_count_no_launch():
    """On CPU tensors K6 runs its plain version: no launch, on the ring or
    off it, whatever the rule says."""
    rng = np.random.default_rng(0)
    q = torch.as_tensor(rng.standard_normal((2, 4, 128)), dtype=torch.bfloat16)
    k = torch.as_tensor(rng.standard_normal((2, 256, 128)), dtype=torch.bfloat16)
    seg = torch.tensor([200, 1], dtype=torch.int32)
    fd.reset_launch_counts()
    o, m, l = fd.flash_decode_partials(q, k, k, seg, 2, 128, 128 ** -0.5)
    assert o.shape == (2, 2, 4, 128) and fd.launches == fd.ring_launches == 0
    assert bool((m[1, 1] == -1e30).all()) and bool((l[1, 1] == 0).all())
