"""Assigned input shapes (port of ``repro/configs/shapes.py``):

  train_4k     seq=4,096   global_batch=256   -> a train step
  prefill_32k  seq=32,768  global_batch=32    -> a prefill forward
  decode_32k   seq=32,768  global_batch=128   -> a serve step (1 token)
  long_500k    seq=524,288 global_batch=1     -> a serve step (1 token);
               only for sub-quadratic archs (see ``shape_applicable``)

The reference's ``input_specs`` (``jax.ShapeDtypeStruct`` stand-ins for
its dry run) belongs to the distributed port and is left out.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


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
