"""Deterministic synthetic token pipeline (port of ``repro.data``)."""
from .pipeline import DataConfig, batch_at, iterate

__all__ = ["DataConfig", "batch_at", "iterate"]
