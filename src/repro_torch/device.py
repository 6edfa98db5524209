"""Device selection for the port's entry points.

The reference switches Pallas to interpret mode by itself on a CPU host
(``repro/serving/engine.py:750-754``). The port does not: an entry point
runs where its ``device`` says, and a request for CUDA on a host without it
raises rather than quietly running on the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``torch.device(device)``, refusing CUDA when none is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
