"""Deterministic, shard-aware synthetic token pipeline (a copy of
``repro/data/pipeline.py``, which is numpy only: the port's batches equal
the reference's array for array).

Every batch is a pure function of ``(seed, step, shard)`` — the property
fault tolerance rests on: after a restart (or an elastic re-shard onto a
different host count) any rank can regenerate exactly the batches it owes,
so checkpoint-resume reproduces the loss trajectory bit-for-bit (tested).

The generator mixes a Philox-style counter hash; "documents" are Zipf-ish
token draws with structural repetition so models actually learn something
in the examples.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    img_tokens: int = 0          # >0: also emit stub image embeddings
    d_model: int = 0


def _hash_u64(x: np.ndarray) -> np.ndarray:
    x = (x ^ (x >> 30)) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> 27)) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> 31)


def batch_at(cfg: DataConfig, step: int, shard: int = 0,
             num_shards: int = 1) -> dict:
    """The shard's slice of the global batch at ``step``. Deterministic."""
    assert cfg.global_batch % num_shards == 0
    per = cfg.global_batch // num_shards
    rows = np.arange(per, dtype=np.uint64) + np.uint64(shard * per)
    base = (
        np.uint64(cfg.seed) * np.uint64(0x9E3779B97F4A7C15)
        + np.uint64(step) * np.uint64(0xD1342543DE82EF95)
    )
    pos = np.arange(cfg.seq_len, dtype=np.uint64)
    h = _hash_u64(base + rows[:, None] * np.uint64(1_000_003) + pos[None, :])
    # Zipf-ish skew: square a uniform for mass at low ids
    u = (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)
    toks = (u * u * cfg.vocab_size).astype(np.int64)
    # structural repetition: every odd position copies the previous token —
    # half the targets are perfectly predictable (fast learnability signal)
    if cfg.seq_len >= 4:
        toks[:, 1::2] = toks[:, 0::2][:, : toks[:, 1::2].shape[1]]
    out = {"tokens": toks.astype(np.int32)}
    if cfg.img_tokens:
        hi = _hash_u64(base + rows[:, None] * np.uint64(7919)
                       + np.arange(cfg.img_tokens, dtype=np.uint64)[None, :])
        emb = ((hi >> np.uint64(11)).astype(np.float64) / float(1 << 53) - 0.5)
        out["img_emb"] = np.repeat(
            emb[:, :, None], cfg.d_model, axis=2
        ).astype(np.float32) * 0.02
    return out


def iterate(cfg: DataConfig, start_step: int = 0, shard: int = 0,
            num_shards: int = 1) -> Iterator[dict]:
    step = start_step
    while True:
        yield batch_at(cfg, step, shard, num_shards)
        step += 1
