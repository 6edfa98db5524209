"""Transformer model for the port's serving path (port of ``repro.models``)."""
from .transformer import (
    ModelConfig,
    decode_step,
    init_paged_cache,
    init_params,
    params_from_numpy,
    prefill,
    prefill_chunks,
    supports_chunked_prefill,
)
