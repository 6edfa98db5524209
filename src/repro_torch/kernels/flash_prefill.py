"""FA-2 chunked prefill through the page table: Hopper kernel K8 and its
plain PyTorch version -- the fixed-grid baseline of chunked prefill.

K8, :func:`flash_prefill_paged`, replaces the Pallas kernel
``repro/kernels/flash_prefill.py:162`` ``_prefill_paged_kernel``. Each pack
row is one prompt chunk of ``C`` positions from the runtime offset
``q_offsets[n]``; its keys are read page by page through its table row up to
the causal limit, which doubles as the length guard (stale pool data always
sits past every valid query). The output is normalised with ``l = max(l,
1e-30)`` and has q's dtype. The CUDA source is ``csrc/flash_prefill.cu``:
it folds the ``g`` query heads of a KV head into one CTA's rows, so a page
is read once per row block and not once per query head.

The dense FA-2 prefill of the reference (K7, ``flash_prefill.py:24``) is on
no engine path and is not ported yet (ROADMAP queue 2).

The wrapper launches the kernel for CUDA tensors and runs the plain version
for CPU tensors -- only because the tensors lie on the CPU; a failed launch
raises. ``launches`` counts kernel launches (plain runs do not count).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.core.attention import NEG_INF
from . import build
from .lean_prefill import check_row_kernel

SOURCE = "flash_prefill.cu"

# launch counter: +1 per kernel launch, nowhere else
launches = 0


def reset_launch_counts() -> None:
    global launches
    launches = 0


def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_prefill_paged_launch.argtypes = [
            I, P, P, P, P, P, P, I, I, I, I, I, I, I, F, P,
        ]
        lib.flash_prefill_paged_launch.restype = I
        lib._argtypes_set = True
    return lib


def flash_prefill_paged_plain(q, k_pool, v_pool, page_tbls, q_offsets, scale: float):
    """Plain PyTorch K8: every query row walks its table row's pages in
    order with the online-softmax update (pages past the row's position
    leave it unchanged, as the kernel's causal skip does), vectorised over
    pack rows, heads and rows. Returns ``(N, Hq, C, d)`` in q's dtype."""
    N, Hq, C, d = q.shape
    num_pages, Hkv, ps, _ = k_pool.shape
    W = page_tbls.shape[1]
    g = Hq // Hkv
    dev = q.device
    qf = q.reshape(N, Hkv, g * C, d).float()
    qpos = q_offsets.long()[:, None] + torch.arange(g * C, device=dev)[None, :] % C   # (N, gC)
    acc = torch.zeros(N, Hkv, g * C, d, dtype=torch.float32, device=dev)
    m = torch.full((N, Hkv, g * C), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(N, Hkv, g * C, dtype=torch.float32, device=dev)
    pos = torch.arange(ps, device=dev)
    tbl = page_tbls.long()
    for jb in range(W):
        kpos = jb * ps + pos                                              # (ps,)
        ok = (kpos[None, None, :] <= qpos[..., None])[:, None]           # (N, 1, gC, ps)
        k = k_pool[tbl[:, jb]].float()                                    # (N, Hkv, ps, d)
        v = v_pool[tbl[:, jb]].float()
        seen = ok.any(dim=2)[..., None]                                   # keys some row sees
        v = torch.where(seen, v, 0.0)
        s = torch.einsum("nhrd,nhtd->nhrt", qf, k) * scale
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        acc = alpha[..., None] * acc + torch.einsum("nhrt,nhtd->nhrd", p, v)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(N, Hq, C, d).to(q.dtype)


def flash_prefill_paged(
    q: torch.Tensor,            # (N, Hq, C, d) one prompt chunk per row
    k_pool: torch.Tensor,       # (num_pages, Hkv, page_size, d)
    v_pool: torch.Tensor,
    page_tbls: torch.Tensor,    # (N, W) int32 page table rows
    q_offsets: torch.Tensor,    # (N,) int32 absolute position of each chunk's q[0]
    scale: Optional[float] = None,
) -> torch.Tensor:
    """K8: FA-2 chunked prefill through the page table. Returns ``(N, Hq,
    C, d)`` in q's dtype; rows of chunk padding hold garbage that callers
    discard. Every id in ``page_tbls`` must index the pools (the kernel
    trusts it; checking would cost a device sync)."""
    global launches
    N, Hq, C, d = q.shape
    num_pages, Hkv, ps, _ = k_pool.shape
    if v_pool.shape != k_pool.shape or k_pool.shape[3] != d or Hq % Hkv:
        raise ValueError(f"pools {tuple(k_pool.shape)} / {tuple(v_pool.shape)} do not fit "
                         f"q {tuple(q.shape)}")
    if page_tbls.dim() != 2 or page_tbls.shape[0] != N or q_offsets.shape != (N,):
        raise ValueError("page_tbls must be (N, W) and q_offsets (N,)")
    devices = {t.device for t in (q, k_pool, v_pool, page_tbls, q_offsets)}
    if len(devices) != 1:
        raise ValueError(f"operands lie on several devices: {sorted(map(str, devices))}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return flash_prefill_paged_plain(q, k_pool, v_pool, page_tbls, q_offsets, scale)
    build.check_dtypes(q, k_pool, v_pool)
    if page_tbls.dtype != torch.int32 or q_offsets.dtype != torch.int32:
        raise TypeError("page_tbls and q_offsets must be int32")
    build.check_contiguous(q=q, k_pool=k_pool, v_pool=v_pool, page_tbls=page_tbls,
                           q_offsets=q_offsets)
    check_row_kernel(d, ps, "flash_prefill_paged (K8)")
    W = page_tbls.shape[1]
    out = torch.empty_like(q)
    err = _library().flash_prefill_paged_launch(
        build.DTYPE_CODE[q.dtype], build.ptr(q), build.ptr(k_pool), build.ptr(v_pool),
        build.ptr(page_tbls), build.ptr(q_offsets), build.ptr(out),
        N, Hkv, W, (Hq // Hkv) * C, C, d, ps, float(scale), build.stream(q.device),
    )
    build.check_launch(err, "flash_prefill_paged (K8)")
    launches += 1
    return out
