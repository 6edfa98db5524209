"""Transformer model for the port's serving paths (port of ``repro.models``)."""
from .moe import MoEConfig, moe_forward
from .transformer import (
    ATTN_KINDS,
    ModelConfig,
    cache_from_numpy,
    decode_step,
    init_cache,
    init_paged_cache,
    init_params,
    layer_kinds,
    params_from_numpy,
    prefill,
    prefill_chunks,
    supports_chunked_prefill,
    verify_step,
)
