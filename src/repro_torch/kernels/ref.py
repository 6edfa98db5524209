"""Plain oracle for the lean decode kernels (port of ``repro.kernels.ref``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.attention import mha_decode_ref


def lean_decode_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    ctx_lens: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The lean kernels compute *exact* attention; oracle = standard decode."""
    return mha_decode_ref(q, k, v, ctx_lens=ctx_lens, scale=scale)
