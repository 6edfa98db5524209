"""Architecture registry: ``get_config(name)`` / ``get_smoke_config(name)``
(port of ``repro.configs``). Only the architectures the port runs are
registered; the reference's others come with ROADMAP queue 1, item 14."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models import ModelConfig

ARCH_IDS: List[str] = ["mistral-nemo-12b"]


def _module(name: str):
    if name not in ARCH_IDS:
        raise KeyError(f"unknown or not yet ported arch {name!r}; ported: {ARCH_IDS}")
    return importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_').replace('.', '_')}"
    )


def get_config(name: str) -> ModelConfig:
    return _module(name).config()


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke_config()
