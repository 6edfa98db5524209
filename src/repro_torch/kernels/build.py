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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("lean_decode.cu", "lean_prefill.cu", "flash_decode.cu", "flash_prefill.cu",
           "lean_cascade.cu", "lean_merge.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

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
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{Path(source).stem}_{digest}.so"


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
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed: List[str] = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
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
# dtype codes of the C entry points: q and K/V share one dtype
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


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


def check_dtypes(*tensors):
    """The kernels take float32 or bfloat16 operands of one dtype."""
    dts = [t.dtype for t in tensors]
    if dts[0] not in DTYPE_CODE or any(dt != dts[0] for dt in dts):
        raise TypeError(f"kernels take float32 or bfloat16 operands of one dtype, got {dts}")
