"""Core LeanAttention machinery: associative merge, stream-K schedule and
the plain attention references (port of ``repro.core``)."""
from .merge import AttnPartial, merge, merge_n, segment_merge, finalize
from .leantile import (
    LeanSchedule,
    ScheduleCache,
    bucket_ctx_lens,
    bucket_length,
    make_schedule,
    default_tile_size,
)
from .attention import (
    NEG_INF,
    mha_decode_ref,
    mha_prefill_ref,
    mha_prefill_chunked,
    paged_gather_kv,
)
