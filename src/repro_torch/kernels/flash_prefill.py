"""FA-2 prefill: Hopper kernels K7 (dense, the whole-prompt prefill) and K8
(through the page table, the fixed-grid baseline of chunked prefill), each
with its plain PyTorch version.

K7, :func:`flash_prefill`, replaces the Pallas kernel
``repro/kernels/flash_prefill.py:24`` ``_prefill_kernel``: causal and
sliding-window attention with GQA and a query offset, ``q (B, Hq, Lq, d)``
against ``k/v (B, Hkv, Lk, d)``. The reference walks (query block, key block)
pairs and skips the blocks its relevance test rules out
(``flash_prefill.py:53-58``); the CUDA kernel turns that skip into each
CTA's loop bounds. It is the attention of the model's whole-prompt prefill
on CUDA tensors (:func:`repro_torch.models.transformer.prefill`).

K8, :func:`flash_prefill_paged`, replaces ``flash_prefill.py:162``
``_prefill_paged_kernel``. Each pack row is one prompt chunk of ``C``
positions from the runtime offset ``q_offsets[n]``; its keys are read page
by page through its table row up to the causal limit, which doubles as the
length guard (stale pool data always sits past every valid query).

Both normalise with ``l = max(l, 1e-30)`` and return q's dtype. The CUDA
source is ``csrc/flash_prefill.cu``: both kernels fold the ``g`` query heads
of a KV head into one CTA's rows, so a K/V tile is read once per row block
and not once per query head.

Path rule (:func:`tensor_core_path`, a plain function of ``(dtype, d,
page)``). On CUDA tensors each wrapper launches one of two kernels:

* bf16 with ``d`` in {64, 128} (the main path: Mistral-NeMo-12B, d 128),
  for K7 also ``d`` 256 (gemma-3's admission), and for K8 a ``page`` that
  is a multiple of 8 (a page is a whole number of 8-row swizzle atoms): the
  tensor-core row-block kernel (``csrc/attn_tc.cuh``: wgmma for QK^T and
  PV, K/V tiles through TMA -- 128 keys, 64 at d 256 -- 128 rows a CTA, P
  through PV as two bf16 halves). Both need their operands 16-byte aligned
  (TMA) and raise otherwise.
* float32, bf16 at any other ``d`` (K8 and the fused K4 at d 256 too, which
  no engine path launches), and K8 on a page that is not a multiple of 8
  (the engine picks such a page itself for a short cache, ``min(
  default_tile_size, max(8, cache_len))``): the CUDA-core kernel (float32
  tiles in shared memory, any page; a page too large for its shared memory
  is walked in sub-tiles). Tensor cores on float32 would mean TF32 and
  break the 2e-5 float32 contract.

Nothing catches a failed build or launch and gives way to the other kernel.

The wrappers launch the kernels for CUDA tensors and run the plain versions
for CPU tensors -- only because the tensors lie on the CPU; a failed build
or launch raises. ``dense_launches`` (K7) and ``launches`` (K8) count every
kernel launch, ``dense_tc_launches`` and ``tc_launches`` the tensor-core
ones among them (plain runs do not count).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.core.attention import NEG_INF, widen_kv
from . import build
from .lean_prefill import check_row_kernel

SOURCE = "flash_prefill.cu"
TC_HEAD_DIMS = (64, 128)     # head dims of the tensor-core kernels (K7, K8, the fused K4)
TC_DENSE_HEAD_DIMS = (64, 128, 256)   # and of K7's (key tiles of 64 at d 256)
TC_ALIGN = 16                # bytes: TMA's global address alignment

# launch counters: +1 per kernel launch, nowhere else
launches = 0            # K8, every launch
dense_launches = 0      # K7, every launch
tc_launches = 0         # K8 on the tensor cores
dense_tc_launches = 0   # K7 on the tensor cores


def reset_launch_counts() -> None:
    global launches, dense_launches, tc_launches, dense_tc_launches
    launches = dense_launches = tc_launches = dense_tc_launches = 0


def tensor_core_path(dtype: torch.dtype, d: int, page: Optional[int] = None) -> bool:
    """Whether the CUDA wrappers launch a tensor-core kernel: bf16 queries
    with, for K7 (``page`` None), ``d`` in :data:`TC_DENSE_HEAD_DIMS`, and
    for K8 and the fused K4 (``page`` given), ``d`` in
    :data:`TC_HEAD_DIMS` and a page that is a multiple of 8 rows.
    Everything else runs on the CUDA cores. The rule reads shapes and
    dtypes only."""
    if dtype != torch.bfloat16:
        return False
    if page is None:
        return d in TC_DENSE_HEAD_DIMS
    return d in TC_HEAD_DIMS and page % 8 == 0


def check_tc(what: str, **tensors):
    """TMA reads global memory from 16-byte aligned addresses. (The kernel's
    shared memory, 160 KB at d 128 and 192 KB at d 256, fits every head dim
    the path takes.)"""
    for name, t in tensors.items():
        if t.data_ptr() % TC_ALIGN:
            raise ValueError(f"{what}: {name} must be {TC_ALIGN}-byte aligned for TMA")


def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_prefill_paged_launch.argtypes = [
            I, P, P, P, P, P, P, I, I, I, I, I, I, I, F, P,
        ]
        lib.flash_prefill_paged_launch.restype = I
        lib.flash_prefill_launch.argtypes = [I, P, P, P, P, I, I, I, I, I, I, I, I, I, F, P]
        lib.flash_prefill_launch.restype = I
        lib.flash_prefill_tc_launch.argtypes = [P, P, P, P, I, I, I, I, I, I, I, I, F, P]
        lib.flash_prefill_tc_launch.restype = I
        lib.flash_prefill_paged_tc_launch.argtypes = [
            I, P, P, P, P, P, P, I, I, I, I, I, I, I, I, F, P,
        ]
        lib.flash_prefill_paged_tc_launch.restype = I
        lib._argtypes_set = True
    return lib


def flash_prefill_paged_plain(q, k_pool, v_pool, page_tbls, q_offsets, scale: float):
    """Plain PyTorch K8: every query row walks its table row's pages in
    order with the online-softmax update (pages past the row's position
    leave it unchanged, as the kernel's causal skip does), vectorised over
    pack rows, heads and rows. Returns ``(N, Hq, C, d)`` in q's dtype.
    e4m3 pools (the f8 pools) are read widened to bf16: the f8 form's plain
    version is the bf16 form's on the widened pool."""
    k_pool, v_pool = widen_kv(k_pool), widen_kv(v_pool)
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
    trusts it; checking would cost a device sync). The kernel follows
    :func:`tensor_core_path`. The pools share q's dtype, or are e4m3 (the
    f8 pools) beside bf16 q: the kernel stages and widens their tiles, no
    widened pool is written."""
    global launches, tc_launches
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
    if k_pool.dtype == torch.int8:
        raise TypeError("flash_prefill_paged (K8) has no int8 form: dequantize the pools first")
    if page_tbls.dtype != torch.int32 or q_offsets.dtype != torch.int32:
        raise TypeError("page_tbls and q_offsets must be int32")
    build.check_contiguous(q=q, k_pool=k_pool, v_pool=v_pool, page_tbls=page_tbls,
                           q_offsets=q_offsets)
    W = page_tbls.shape[1]
    rows = (Hq // Hkv) * C
    tc = tensor_core_path(q.dtype, d, ps)
    if tc:
        check_tc("flash_prefill_paged (K8)", q=q, k_pool=k_pool, v_pool=v_pool)
    else:
        check_row_kernel(d, ps, "flash_prefill_paged (K8)")
    out = torch.empty_like(q)
    if tc:
        err = _library().flash_prefill_paged_tc_launch(
            build.dtype_code(q, k_pool), build.ptr(q), build.ptr(k_pool), build.ptr(v_pool),
            build.ptr(page_tbls), build.ptr(q_offsets), build.ptr(out), N, Hkv, W, rows, C, d,
            ps, num_pages, float(scale), build.stream(q.device),
        )
    else:
        err = _library().flash_prefill_paged_launch(
            build.dtype_code(q, k_pool), build.ptr(q), build.ptr(k_pool), build.ptr(v_pool),
            build.ptr(page_tbls), build.ptr(q_offsets), build.ptr(out),
            N, Hkv, W, rows, C, d, ps, float(scale), build.stream(q.device),
        )
    build.check_launch(err, "flash_prefill_paged (K8)")
    launches += 1
    tc_launches += int(tc)
    return out


# ------------------------------------------------------------------- K7
def _blocks(Lq: int, Lk: int, block_q: int, block_kv: int):
    """The reference's block sizes: at most the (8-rounded) lengths."""
    return min(block_q, max(8, Lq)), min(block_kv, max(8, Lk))


def flash_prefill_plain(q, k, v, causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None, q_offset: int = 0,
                        block_q: int = 128, block_kv: int = 128) -> torch.Tensor:
    """Plain PyTorch K7, walking the reference kernel's blocks: query blocks
    of ``block_q`` rows (Lq and Lk padded to block multiples with zeros),
    key tiles of ``block_kv`` in order, each skipped for a query block that
    the relevance test of ``repro/kernels/flash_prefill.py:53-58`` rules out
    (past ``Lk``, past the causal diagonal, before the window's left edge);
    the online-softmax update masks with ``NEG_INF`` and the flush divides by
    ``max(l, 1e-30)``. Vectorised over batch, heads and query blocks.
    Returns ``(B, Hq, Lq, d)`` in q's dtype."""
    B, Hq, Lq, d = q.shape
    _, Hkv, Lk, _ = k.shape
    g = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    block_q, block_kv = _blocks(Lq, Lk, block_q, block_kv)
    pq, pk = (-Lq) % block_q, (-Lk) % block_kv
    nq, nk = (Lq + pq) // block_q, (Lk + pk) // block_kv
    dev = q.device
    pad = torch.nn.functional.pad
    qf = pad(q, (0, 0, 0, pq)).float().reshape(B, Hkv, g, nq, block_q, d)
    kf = pad(k, (0, 0, 0, pk)).float()
    vf = pad(v, (0, 0, 0, pk)).float()
    q_start = torch.arange(nq, device=dev) * block_q + q_offset               # (nq,)
    qpos = q_start[:, None] + torch.arange(block_q, device=dev)[None, :]     # (nq, bq)
    acc = torch.zeros(B, Hkv, g, nq, block_q, d, dtype=torch.float32, device=dev)
    m = torch.full((B, Hkv, g, nq, block_q), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros_like(m)
    for jb in range(nk):
        k_start = jb * block_kv
        relevant = torch.full((nq,), k_start < Lk, device=dev)
        if causal:
            relevant &= k_start <= q_start + block_q - 1
        if window is not None:
            relevant &= (k_start + block_kv - 1) > (q_start - window)
        if not bool(relevant.any()):
            continue
        kpos = k_start + torch.arange(block_kv, device=dev)
        ok = (kpos < Lk)[None, None, :].expand(nq, block_q, block_kv)
        if causal:
            ok = ok & (kpos[None, None, :] <= qpos[..., None])
        if window is not None:
            ok = ok & (kpos[None, None, :] > qpos[..., None] - window)
        kt, vt = kf[:, :, k_start:k_start + block_kv], vf[:, :, k_start:k_start + block_kv]
        s = torch.einsum("bhgnqd,bhkd->bhgnqk", qf, kt) * scale
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        rel = relevant[:, None]                                              # (nq, 1)
        l = torch.where(rel, alpha * l + p.sum(dim=-1), l)
        acc = torch.where(rel[..., None],
                          alpha[..., None] * acc + torch.einsum("bhgnqk,bhkd->bhgnqd", p, vt),
                          acc)
        m = torch.where(rel, m_new, m)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Hq, nq * block_q, d)[:, :, :Lq].to(q.dtype)


def flash_prefill(
    q: torch.Tensor,            # (B, Hq, Lq, d)
    k: torch.Tensor,            # (B, Hkv, Lk, d)
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
    block_q: int = 128,
    block_kv: int = 128,
) -> torch.Tensor:
    """K7: FA-2 prefill (causal, sliding window, GQA; query ``i`` at
    absolute position ``q_offset + i``). Returns ``(B, Hq, Lq, d)`` in q's
    dtype. ``block_kv`` is the key tile the CUDA-core kernel walks (and the
    plain version's); ``block_q`` is the plain version's query block -- the
    CUDA-core kernel takes row blocks of 64 of the ``g * Lq`` rows a KV head
    serves, the tensor-core kernel (:func:`tensor_core_path`) row blocks of
    128 and key tiles of 128 (64 at d 256) of its own. Block sizes change
    which fully masked blocks are skipped, never the result. Operands must be
    contiguous on CUDA."""
    global dense_launches, dense_tc_launches
    B, Hq, Lq, d = q.shape
    Bk, Hkv, Lk, dk = k.shape
    if v.shape != k.shape or Bk != B or dk != d or Hq % Hkv:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be a positive number of keys, got {window}")
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"operands lie on several devices: {sorted(map(str, devices))}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, causal, window, scale, q_offset, block_q, block_kv)
    build.check_dtypes(q, k, v)
    build.check_contiguous(q=q, k=k, v=v)
    _, tile = _blocks(Lq, Lk, block_q, block_kv)
    tc = tensor_core_path(q.dtype, d)
    if tc:
        check_tc("flash_prefill (K7)", q=q, k=k, v=v)
    else:
        check_row_kernel(d, tile, "flash_prefill (K7)")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    g = Hq // Hkv
    args = (B * Hkv, g * Lq, Lq, Lk, d)
    mask = (int(bool(causal)), int(window or 0), int(q_offset), float(scale))
    if tc:
        err = _library().flash_prefill_tc_launch(
            build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out), *args, *mask,
            build.stream(q.device),
        )
    else:
        err = _library().flash_prefill_launch(
            build.DTYPE_CODE[q.dtype], build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out),
            *args, tile, *mask, build.stream(q.device),
        )
    build.check_launch(err, "flash_prefill (K7)")
    dense_launches += 1
    dense_tc_launches += int(tc)
    return out
