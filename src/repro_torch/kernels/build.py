"""Build and load the port's CUDA kernels (``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``).

Sources live in ``csrc/`` beside this module. At first use each one is
compiled for ``sm_90a`` into ``<checkout>/build/repro_torch/`` under a name
that carries a hash of the source, so an edited source never loads a stale
library. All sources build in parallel, one ``nvcc`` each. ``--use_fast_math``
is deliberately off: the kernels' ``expf``/``logf`` must stay accurate for
the 2e-5 float32 contract with the reference.

The binding helpers at the end are shared by the kernels' wrappers.

Nothing here runs at import time; the CPU tests import this module freely.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

import torch

from repro_torch.core.attention import F8

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("lean_decode.cu", "lean_decode_walk.cu", "lean_prefill.cu", "lean_prefill_tc.cu",
           "flash_decode.cu", "flash_prefill.cu", "lean_cascade.cu", "lean_cascade_walk.cu",
           "lean_merge.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Preprocessor macros every library of this process is built with: empty
# for the kernels as they ship; chip_smoke.py's --decode-ring-clocks sets
# ("DECODE_RING_CLOCKS",) for a probe build, named apart by its hash.
DEFINES: tuple = ()

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "build only on a machine with the CUDA toolkit"
        )
    return found


def _lib_path(source: str) -> Path:
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(DEFINES).encode())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{Path(source).stem}_{digest}.so"


# seconds from the start of the last build() to the end of each of its
# sources' nvcc (they run at the same time, so each shares the machine)
source_seconds: Dict[str, float] = {}


def build(sources=SOURCES) -> float:
    """Compile every source whose library is missing, all at once; returns
    the wall seconds spent. ``nvcc``'s ``-Xptxas -v`` report (registers,
    shared memory, spills) is kept beside each library as ``.log``."""
    todo = [s for s in sources if not _lib_path(s).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, t0 = _nvcc(), time.perf_counter()
    procs = []
    for src in todo:
        out = _lib_path(src)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, *(f"-D{m}" for m in DEFINES), "-o", str(tmp), str(CSRC / src)]
        procs.append((src, out, tmp, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT, text=True
        )))
    failed: List[str] = []
    pending = list(procs)
    while pending:
        for item in list(pending):
            src, out, tmp, log, proc = item
            if proc.poll() is None:
                continue
            pending.remove(item)
            source_seconds[src] = time.perf_counter() - t0
            log.close()
            if proc.returncode != 0:
                failed.append(f"{src} (exit {proc.returncode}):\n"
                              + out.with_suffix(".log").read_text())
                continue
            os.replace(tmp, out)
        time.sleep(0.05)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, building it first if needed."""
    lib = _loaded.get(source)
    if lib is None:
        build((source,))
        lib = ctypes.CDLL(str(_lib_path(source)))
        _loaded[source] = lib
    return lib


def ptxas_report(source: str) -> str:
    """The ``-Xptxas -v`` lines of the last build of ``source``."""
    log = _lib_path(source).with_suffix(".log")
    return log.read_text() if log.exists() else ""


# ------------------------------------------------------------ binding helpers
# dtype codes of the C entry points: q and K/V share one dtype (0, 1), or
# bf16 queries read int8 K/V rows with a float32 scale per row (2), or e4m3
# K/V rows with no scales (3, the f8 pools)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
INT8_KV_CODE = 2
F8_KV_CODE = 3
INT8_VEC = 16       # bytes: 1-byte (int8, e4m3) rows are read as 16-byte vectors
BYTE_KV = (torch.int8, F8)


def dtype_code(q: torch.Tensor, kv: torch.Tensor) -> int:
    if kv.dtype == torch.int8:
        return INT8_KV_CODE
    if kv.dtype == F8:
        return F8_KV_CODE
    return DTYPE_CODE[q.dtype]


def ptr(t) -> ctypes.c_void_p:
    """The device address of ``t`` (NULL for None)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``: kernels launch on it."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_launch(err: int, what: str):
    """Raise on the ``cudaError_t`` a C entry point returned."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed with cudaError_t {err}")


def check_contiguous(**tensors):
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_dtypes(q, *kv):
    """The kernels take float32 or bfloat16 operands of one dtype, or -- the
    int8 and f8 pools -- bf16 queries with int8 or e4m3 K/V whose rows hold
    a multiple of 16 values from a 16-byte aligned base (the kernels read
    them as 16-byte vectors)."""
    dts = [q.dtype] + [t.dtype for t in kv]
    if kv and kv[0].dtype in BYTE_KV and all(t.dtype == kv[0].dtype for t in kv):
        name = "int8" if kv[0].dtype == torch.int8 else "e4m3"
        if q.dtype != torch.bfloat16:
            raise TypeError(f"{name} K/V kernels take bf16 queries, got {q.dtype}")
        for t in kv:
            if t.shape[-1] % INT8_VEC or t.data_ptr() % INT8_VEC:
                raise ValueError(f"{name} K/V rows need a head dim that is a multiple of "
                                 f"{INT8_VEC} and a {INT8_VEC}-byte aligned base, got "
                                 f"d {t.shape[-1]}")
        return
    if dts[0] not in DTYPE_CODE or any(dt != dts[0] for dt in dts):
        raise TypeError(f"kernels take float32 or bfloat16 operands of one dtype, got {dts}")
