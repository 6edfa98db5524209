"""Plain oracles of the decode and prefill kernels (port of
``repro.kernels.ref``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.attention import mha_decode_ref, mha_prefill_ref


def lean_decode_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    ctx_lens: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The lean kernels compute *exact* attention; oracle = standard decode."""
    return mha_decode_ref(q, k, v, ctx_lens=ctx_lens, scale=scale)


def flash_prefill_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """K7's oracle: the plain prefill attention."""
    return mha_prefill_ref(q, k, v, causal=causal, window=window, scale=scale, q_offset=q_offset)
