"""Assigned input shapes (port of ``repro/configs/shapes.py``):

  train_4k     seq=4,096   global_batch=256   -> a train step
  prefill_32k  seq=32,768  global_batch=32    -> a prefill forward
  decode_32k   seq=32,768  global_batch=128   -> a serve step (1 token)
  long_500k    seq=524,288 global_batch=1     -> a serve step (1 token);
               only for sub-quadratic archs (see ``shape_applicable``)

:func:`input_specs` gives every input of a shape's step as ``meta``
tensors (the reference's ``jax.ShapeDtypeStruct`` stand-ins): shapes and
dtypes, no memory.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# archs with sub-quadratic / bounded-KV attention run long_500k
LONG_CTX_ARCHS = {"recurrentgemma-9b", "xlstm-350m", "gemma3-4b"}


def shape_applicable(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch.split("-smoke")[0] in LONG_CTX_ARCHS
    return True


def _has_xattn(cfg) -> bool:
    return any("xattn" in pat for pat, _ in cfg.stages)


def input_specs(cfg, shape: str) -> dict:
    """Every input of the step ``shape`` lowers, as ``device="meta"``
    tensors of the reference's shapes and dtypes
    (``repro/configs/shapes.py:49``): ``tokens`` int32 ``(B, S)`` for a
    train or prefill step (with ``img_emb`` bf16 ``(B, cross_kv_len,
    d_model)`` for a cross-attention model); for a decode step ``tokens``
    ``(B, 1)``, ``cur_len`` a 0-d int32 and ``cache`` of :func:`repro_torch.
    models.init_cache` for ``S`` tokens (the port's per-layer list)."""
    from repro_torch.models import init_cache

    spec = SHAPES[shape]
    B, S = spec.global_batch, spec.seq_len
    meta = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")
    if spec.kind in ("train", "prefill"):
        out = {"tokens": meta((B, S), torch.int32)}
    else:
        out = {"tokens": meta((B, 1), torch.int32), "cur_len": meta((), torch.int32),
               "cache": init_cache(cfg, B, S, device="meta")}
    if _has_xattn(cfg):
        out["img_emb"] = meta((B, cfg.cross_kv_len, cfg.d_model), torch.bfloat16)
    return out
