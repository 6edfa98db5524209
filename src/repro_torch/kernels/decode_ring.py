"""The path rule and sizes of the decode ring (``csrc/attn_decode_ring.cuh``),
which K6 (:mod:`.flash_decode`), and K1, K2 and K5 (:mod:`.lean_decode`)
stream their K/V tiles through.

A slot holds one tile's K or V rows; a CTA's walk copies K then V of each
tile, so ``slots // 2`` tiles are in flight while the consumers compute.
The slots take the shared memory the CTA's float state (queries,
accumulator, scores and running max and sum of its row bucket) leaves, up
to :data:`MAX_SLOTS`. Fewer than two slots, or a row whose bytes are not a
multiple of 16 (the bulk copy's unit), keep the walk over device memory:
the rule reads shapes and dtypes only, and the wrappers pass its slot
count to the kernel, which refuses one that does not fit.
"""
from __future__ import annotations

SMEM_LIMIT = 232448      # bytes of shared memory a CTA may use on Hopper
STATIC_BYTES = 1024      # static shared memory a ring kernel may declare
MAX_SLOTS = 8
COPY_ALIGN = 16          # bytes: the bulk copy's unit and its address alignment
ROW_BUCKETS = (2, 4, 8, 16, 32, 64)


def row_bucket(rows: int) -> int:
    """The decode kernels' row bucket for ``rows`` query rows (attn::row_bucket)."""
    for b in ROW_BUCKETS:
        if rows <= b:
            return b
    raise ValueError(f"the decode kernels take up to {ROW_BUCKETS[-1]} rows, got {rows}")


def state_bytes(rows: int, d: int, tile: int) -> int:
    """The CTA's float state at a row bucket (attn::smem_bytes)."""
    return 4 * (2 * rows * d + rows * tile + 3 * rows)


def slot_bytes(elem: int, d: int, tile: int) -> int:
    """One slot: a tile's K or V rows of ``elem``-byte values, rounded up to 128."""
    return -(-tile * d * elem // 128) * 128


def ring_slots(elem: int, d: int, tile: int, rows: int) -> int:
    """Slots of the ring for K/V values of ``elem`` bytes, head dim ``d``,
    tiles of ``tile`` keys and a row bucket of ``rows``; 0 where the walk
    over device memory runs."""
    if d * elem % COPY_ALIGN:
        return 0
    room = SMEM_LIMIT - STATIC_BYTES - state_bytes(rows, d, tile)
    slots = min(MAX_SLOTS, max(room, 0) // slot_bytes(elem, d, tile))
    return slots if slots >= 2 else 0


def bytes_in_flight(elem: int, d: int, tile: int, rows: int) -> int:
    """The most K/V bytes the ring holds in flight: all its slots full."""
    return ring_slots(elem, d, tile, rows) * slot_bytes(elem, d, tile)


def check_aligned(what: str, **tensors):
    """The bulk copy reads from 16-byte aligned addresses."""
    for name, t in tensors.items():
        if t.data_ptr() % COPY_ALIGN:
            raise ValueError(f"{what}: {name} must be {COPY_ALIGN}-byte aligned for the ring's "
                             "bulk copies")
