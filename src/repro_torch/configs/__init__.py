"""Architecture registry: ``get_config(name)`` / ``get_smoke_config(name)``
(port of ``repro.configs``): the attention-family architectures and the
recurrent ones (``recurrentgemma-9b``: RG-LRU with sliding-window
attention; ``xlstm-350m``: mLSTM and sLSTM)."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models import ModelConfig

ARCH_IDS: List[str] = [
    "musicgen-large",
    "llama-3.2-vision-11b",
    "qwen2-moe-a2.7b",
    "qwen3-moe-30b-a3b",
    "yi-34b",
    "gemma3-4b",
    "mistral-nemo-12b",
    "nemotron-4-15b",
    "recurrentgemma-9b",
    "xlstm-350m",
]


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
