#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing catches it:

  1. device line (name, ``nvidia-smi`` name and power limit), TF32 off;
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc);
  3. kernel phase at the main path's shapes (Mistral-NeMo-12B attention:
     Hq 32, Hkv 8, d 128, page = tile 128, one stream-K worker per SM, a
     ragged batch on shuffled pages): K1 (+ merge) and K2 against their
     plain PyTorch versions in float32 and bf16, dense == paged bit for
     bit, kernel / plain / library times and the bound; then K4 and K8 on a
     pack of two 256-token prompt chunks, and K6 (fixed split) against K2
     on two decode shapes -- the paper's comparison;
  4. engine phase: Mistral-NeMo-12B at full width, random bf16 weights from
     a seeded generator, served through ``DecodeEngine`` (paged, lean, K2);
     then the same prompts again on that engine with a few decode ticks
     under ``torch.profiler``: device busy, launches and idle share per tick;
  5. the same model with ``fused=False`` for a few ticks (K1 + merge);
  6. the first decode tick of a ``'ref'``-backend engine against the lean
     one on the same weights and prompts;
  7. scheduler phases: the same prompts served by ``Scheduler`` with
     chunked prefill on the ``lean`` backend (K4 chunks, K2 decode) and on
     ``fixed`` (K8 chunks, K6 decode), in turns lean, fixed, fixed, lean:
     steps, launches, TTFT, decode tokens flowing during the long prefill,
     first tokens against the blocking engine's; then one phase of each
     under ``torch.profiler``: device busy, kernels, host syncs;
  8. the kernel summary (one JSON line), the ``nvidia-smi`` line, and last
     ``{"ok": true, "device": {...}}``.

Imports ``repro_torch`` only, never JAX or the JAX package ``repro``.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# float32 contract of the reference (tests/test_paged_invariants.py:177-180).
F32_TOL = 2e-5
# bf16 inputs: kernel and plain version both upcast the bf16 values exactly
# to float32 and compute in float32, so they differ only in summation order
# and the float32 contract applies unchanged.
BF16_TOL = 2e-5
# Lean vs 'ref' engine logits (phase 6), elementwise |lean - ref| <= atol +
# rtol * |ref|. The model is bf16 and the two backends round attention
# differently: the lean kernels keep the softmax probabilities in float32,
# the plain oracle rounds them to bf16 before the PV product (as the
# reference's does). The logits leave the unembed GEMM rounded to bf16, so
# a large logit moves by whole bf16 steps of its own size: rtol is 4 steps
# (2^-6). The rest is drift of a few bf16 steps of the residual stream over
# the layers: atol is a tenth of the run's typical |logit| (the median of
# the ref logits, printed). A wrong attention output moves logits by about
# that typical size, ten times the allowance.
LOGIT_RTOL = 2.0 ** -6
LOGIT_ATOL_FRAC = 0.1
RATE_BYTES = {"PCIe": 2.0e12, "NVL": 3.9e12, "H200": 4.8e12}   # else H100 SXM 3.35e12
RATE_OPS = {"float32": 67e12, "bfloat16": 989e12}             # dense, no sparsity


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def mem_rate(name: str) -> float:
    for key, rate in RATE_BYTES.items():
        if key in name:
            return rate
    return 3.35e12


def gpu_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` runs, CUDA events around
    each run. Before each run a 256 MB write evicts the 50 MB L2, because
    the engine reads each layer's K/V cold; then a spin kernel keeps the
    stream busy while the host enqueues, so the wrappers' host overhead is
    not counted."""
    import torch

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    cycles = int(min(max(host_s * 4e9, 1e6), 2e9))
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        flush.zero_()
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# --------------------------------------------------------------- kernel phase
def make_kv_problem(torch, lens, Hq, Hkv, d, tile, width, dtype, gen, dev):
    """A ragged paged batch: pages shuffled over the pool, page 0 the null
    page (zeros), and the dense view of the same K/V."""
    from repro_torch.core.attention import paged_gather_kv

    B = len(lens)
    n_pages = [-(-L // tile) for L in lens]
    num_pages = 1 + sum(n_pages) + 3
    perm = torch.randperm(num_pages - 1, generator=gen, device=dev).cpu() + 1
    tbl = torch.zeros(B, width, dtype=torch.int32)
    k = 0
    for b, n in enumerate(n_pages):
        tbl[b, :n] = perm[k:k + n]
        k += n
    shape = (num_pages, Hkv, tile, d)
    k_pool = torch.randn(shape, generator=gen, device=dev).to(dtype)
    v_pool = torch.randn(shape, generator=gen, device=dev).to(dtype)
    k_pool[0] = 0
    v_pool[0] = 0
    q = torch.randn(B, Hq, d, generator=gen, device=dev).to(dtype)
    tbl = tbl.to(dev)
    return q, k_pool, v_pool, tbl, paged_gather_kv(k_pool, tbl), paged_gather_kv(v_pool, tbl)


def kernel_phase(torch, sm_count: int, dev_name: str):
    from repro_torch.core.leantile import make_schedule
    from repro_torch.core.merge import AttnPartial, finalize, segment_merge
    from repro_torch.kernels import lean_decode as ld
    from repro_torch.kernels import ops

    lens, Hq, Hkv, d, tile, width = [4000, 1500, 700, 1], 32, 8, 128, 128, 32
    gq, B = Hq // Hkv, len(lens)
    sched = make_schedule(lens, Hkv, tile, sm_count)
    print(f"kernel phase: lens {lens} Hq {Hq} Hkv {Hkv} d {d} tile {tile} "
          f"workers {sm_count} tiles {sched.total_tiles} T {sched.tiles_per_worker} "
          f"pieces {sched.num_pieces}", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    dev = torch.device("cuda")
    seg_ctx = torch.tensor([L for L in lens for _ in range(Hkv)], dtype=torch.int32, device=dev)
    scale = 1.0 / math.sqrt(d)
    results = {}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        dname = str(dtype).split(".")[-1]
        q, k_pool, v_pool, tbl, k_dense, v_dense = make_kv_problem(
            torch, lens, Hq, Hkv, d, tile, width, dtype, gen, dev)
        q_seg = q.reshape(B * Hkv, gq, d).contiguous()
        k_rows, v_rows = ops._pool_rows(k_pool, v_pool)
        route = ops._paged_route(sched, tbl, Hkv)
        args = (q_seg, k_rows, v_rows, seg_ctx, route, sched, scale)

        # K2 against its plain version
        o, lse = ld.lean_decode_fused(*args)
        o_ref, lse_ref = ld.lean_decode_fused_plain(*args)
        torch.cuda.synchronize()
        err_k2 = max((o - o_ref).abs().max().item(), (lse - lse_ref).abs().max().item())
        check(torch.allclose(o, o_ref, atol=tol, rtol=tol)
              and torch.allclose(lse, lse_ref, atol=tol, rtol=tol),
              f"K2 {dname} disagrees with its plain version: max |err| {err_k2}")
        # K1 (partials, then + segment_merge) against its plain version
        parts = ld.lean_decode_partials(*args)
        parts_ref = ld.lean_decode_partials_plain(*args)
        torch.cuda.synchronize()
        err_k1 = max((a - b).abs().max().item() for a, b in zip(parts, parts_ref))
        check(all(torch.allclose(a, b, atol=tol, rtol=tol) for a, b in zip(parts, parts_ref)),
              f"K1 {dname} partials disagree with the plain version: max |err| {err_k1}")
        seg = segment_merge(AttnPartial(*parts), ld.schedule_tensors(sched, dev)["piece_seg"],
                            sched.num_segments)
        o_two = finalize(seg)
        err_k1m = (o_two - o_ref).abs().max().item()
        check(torch.allclose(o_two, o_ref, atol=tol, rtol=tol),
              f"K1 + merge {dname} disagrees with plain K2: max |err| {err_k1m}")
        # dense and paged reach the same kernels: bit-identical outputs
        for fused in (True, False):
            out_p = ops.lean_decode_paged_from_schedule(
                q, k_pool, v_pool, seg_ctx, tbl, sched, fused=fused, return_lse=True)
            out_d = ops.lean_decode_from_schedule(
                q, k_dense, v_dense, seg_ctx, sched, fused=fused, return_lse=True)
            check(all(torch.equal(a, b) for a, b in zip(out_p, out_d)),
                  f"dense and paged differ ({dname}, fused={fused})")
        print(f"  {dname}: K2 max|err| {err_k2:.3e}  K1 max|err| {err_k1:.3e}  "
              f"K1+merge vs plain K2 {err_k1m:.3e}  dense==paged bitwise: yes", flush=True)

        # times: kernel, plain version, and the library on the dense KV
        k2_ms = gpu_ms(lambda: ld.lean_decode_fused(*args))
        k2_plain_ms = gpu_ms(lambda: ld.lean_decode_fused_plain(*args), reps=5)
        k1_ms = gpu_ms(lambda: ld.lean_decode_partials(*args))
        k1_plain_ms = gpu_ms(lambda: ld.lean_decode_partials_plain(*args), reps=5)
        elem = torch.finfo(dtype).bits // 8
        tokens = sum(lens) * Hkv                        # K/V rows attended
        kv_bytes = 2 * tokens * d * elem
        lib = library_yardstick(torch, q, k_dense, v_dense, lens, gq, elem)
        lib_ms = lib[LIBRARY_CALL][0]
        print("  " + dname + " SDPA (gather excluded): " + "; ".join(
            f"{how} {ms:.4f} ms reading {nb / 1e6:.1f} MB" for how, (ms, nb) in lib.items()),
            flush=True)
        small = q_seg.numel() * elem + 4 * (seg_ctx.numel() + route.numel()
                                            + ld.schedule_tensors(sched, dev)["desc"].numel())
        ops_count = 4 * gq * d * tokens                  # QK^T and PV, 2 flops a MAC
        out_k2 = 4 * (o.numel() + lse.numel())
        out_k1 = 4 * sum(t.numel() for t in parts)
        for name, out_bytes, ms, plain_ms, err in (
            ("lean_decode_fused", out_k2, k2_ms, k2_plain_ms, err_k2),
            ("lean_decode_partials", out_k1, k1_ms, k1_plain_ms, err_k1),
        ):
            t_bytes = (kv_bytes + small + out_bytes) / mem_rate(dev_name) * 1e3
            t_ops = ops_count / RATE_OPS[dname] * 1e3
            results[(name, dname)] = {
                "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "max_abs_err": err, "kv_bytes": kv_bytes,
            }
            r = results[(name, dname)]
            print(f"  {dname} {name}: {ms:.4f} ms (bound {r['bound_ms']:.4f} ms by "
                  f"{r['bound_by']}, {kv_bytes / 1e6:.1f} MB K/V; plain {plain_ms:.3f} ms; "
                  f"library {lib_ms:.4f} ms)", flush=True)
    return results


# library_ms is the single call; the per-sequence calls are printed beside it
LIBRARY_CALL = "one call, padded + mask"


def bound(dev_name, dname, nbytes, flops):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the peak rate for the inputs' type."""
    t_bytes = nbytes / mem_rate(dev_name) * 1e3
    t_ops = flops / RATE_OPS[dname] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def reset_launch_counts():
    from repro_torch.kernels import flash_decode, flash_prefill, lean_decode, lean_prefill

    for m in (lean_decode, lean_prefill, flash_decode, flash_prefill):
        m.reset_launch_counts()


def launch_counts():
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import lean_decode as ld
    from repro_torch.kernels import lean_prefill as lp

    return {"K1": ld.partials_launches, "K2": ld.fused_launches, "K4": lp.launches,
            "K6": fd.launches, "K8": fp.launches}


# ------------------------------------------------------- chunked-prefill kernels
CHUNK_OFFS, CHUNK = (2048, 37), 256


def chunk_pack(torch, offs, C, Hq, Hkv, d, tile, dtype, gen, dev):
    """A pack of prompt chunks of ``C`` tokens at offsets ``offs``, each
    row's pages (prefix + chunk) shuffled over the pool, page 0 null."""
    N = len(offs)
    n_pages = [-(-(o + C) // tile) for o in offs]
    width = max(n_pages)
    num_pages = 1 + sum(n_pages) + 3
    perm = torch.randperm(num_pages - 1, generator=gen, device=dev).cpu() + 1
    tbl = torch.zeros(N, width, dtype=torch.int32)
    k = 0
    for n, npg in enumerate(n_pages):
        tbl[n, :npg] = perm[k:k + npg]
        k += npg
    shape = (num_pages, Hkv, tile, d)
    k_pool = torch.randn(shape, generator=gen, device=dev).to(dtype)
    v_pool = torch.randn(shape, generator=gen, device=dev).to(dtype)
    k_pool[0] = 0
    v_pool[0] = 0
    q = torch.randn(N, Hq, C, d, generator=gen, device=dev).to(dtype)
    return q, k_pool, v_pool, tbl.to(dev)


def prefill_kernel_phase(torch, sm_count: int, dev_name: str):
    """K4 (stream-K chunk partials) and K8 (paged FA-2 chunk prefill) on a
    pack of two 256-token chunks at offsets 2048 and 37, Mistral-NeMo-12B
    attention shapes, against their plain versions; times, bounds and the
    library yardstick (SDPA with the chunk-causal mask on the gathered K/V,
    the g query heads of a KV head folded into rows)."""
    from repro_torch.core.attention import paged_gather_kv
    from repro_torch.core.leantile import make_chunk_schedule
    from repro_torch.core.merge import AttnPartial, finalize, segment_merge
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import lean_decode as ld
    from repro_torch.kernels import lean_prefill as lp
    from repro_torch.kernels import ops

    Hq, Hkv, d, tile, C = 32, 8, 128, 128, CHUNK
    g, N = Hq // Hkv, len(CHUNK_OFFS)
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    visible = [o + C for o in CHUNK_OFFS]
    sched = make_chunk_schedule(visible, Hkv, tile, sm_count, max_len=max(visible) + tile)
    seg_ctx = torch.tensor([v for v in visible for _ in range(Hkv)], dtype=torch.int32, device=dev)
    seg_qs = torch.tensor([o for o in CHUNK_OFFS for _ in range(Hkv)], dtype=torch.int32,
                          device=dev)
    q_off = torch.tensor(CHUNK_OFFS, dtype=torch.int32, device=dev)
    scale = 1.0 / math.sqrt(d)
    # each query row sees its own prefix: offset + position in chunk + 1 keys
    keys_seen = sum(Hq * (C * o + C * (C + 1) // 2) for o in CHUNK_OFFS)
    flops = 4 * d * keys_seen                        # QK^T and PV, 2 flops a MAC
    print(f"prefill kernel phase: pack of {N} chunks of {C} at offsets {list(CHUNK_OFFS)}, "
          f"Hq {Hq} Hkv {Hkv} d {d} page {tile}, workers {sm_count}, tiles "
          f"{sched.total_tiles}, T {sched.tiles_per_worker}, pieces {sched.num_pieces}; "
          f"{flops / 1e9:.2f} GFLOP", flush=True)
    results = {}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        dname = str(dtype).split(".")[-1]
        elem = torch.finfo(dtype).bits // 8
        q, k_pool, v_pool, tbl = chunk_pack(torch, CHUNK_OFFS, C, Hq, Hkv, d, tile, dtype,
                                            gen, dev)
        q_seg = q.reshape(N * Hkv, g * C, d).contiguous()
        k_rows, v_rows = ops._pool_rows(k_pool, v_pool)
        route = ops._paged_route(sched, tbl, Hkv)
        args = (q_seg, k_rows, v_rows, seg_ctx, seg_qs, route, sched, scale, C)

        parts = lp.lean_prefill_chunk_partials(*args)
        parts_ref = lp.lean_prefill_partials_plain(*args)
        torch.cuda.synchronize()
        err_k4 = max((a - b).abs().max().item() for a, b in zip(parts, parts_ref))
        check(all(torch.allclose(a, b, atol=tol, rtol=tol) for a, b in zip(parts, parts_ref)),
              f"K4 {dname} partials disagree with the plain version: max |err| {err_k4}")
        piece_seg = ld.schedule_tensors(sched, dev)["piece_seg"]
        merged = [finalize(segment_merge(AttnPartial(*x), piece_seg, sched.num_segments))
                  for x in (parts, parts_ref)]
        err_k4o = (merged[0] - merged[1]).abs().max().item()
        check(torch.allclose(merged[0], merged[1], atol=tol, rtol=tol),
              f"K4 {dname} merged output disagrees with the plain version: {err_k4o}")

        o8 = fp.flash_prefill_paged(q, k_pool, v_pool, tbl, q_off)
        o8_ref = fp.flash_prefill_paged_plain(q, k_pool, v_pool, tbl, q_off, scale)
        torch.cuda.synchronize()
        err_k8 = (o8.float() - o8_ref.float()).abs().max().item()
        if dtype == torch.float32:
            ok8 = torch.allclose(o8, o8_ref, atol=tol, rtol=tol)
        else:
            # both round a float32 result to bf16: one bf16 step of the
            # output apart (a tie can land either way), plus the float32
            # tolerance where the output nears zero and its sum cancels
            step = torch.finfo(torch.bfloat16).eps * o8_ref.float().abs()
            ok8 = bool(((o8.float() - o8_ref.float()).abs() <= step + tol).all())
        check(ok8, f"K8 {dname} disagrees with the plain version: max |err| {err_k8}")
        # K4 + merge against K8: two kernels, one function
        o4 = merged[0].reshape(N, Hq, C, d)
        err_48 = (o4 - o8.float()).abs().max().item()
        print(f"  {dname}: K4 partials max|err| {err_k4:.3e}, merged {err_k4o:.3e}; "
              f"K8 max|err| {err_k8:.3e}; K4+merge vs K8 {err_48:.3e}", flush=True)

        k4_ms = gpu_ms(lambda: lp.lean_prefill_chunk_partials(*args), reps=10)
        k4_plain_ms = gpu_ms(lambda: lp.lean_prefill_partials_plain(*args), reps=3)
        k8_ms = gpu_ms(lambda: fp.flash_prefill_paged(q, k_pool, v_pool, tbl, q_off), reps=10)
        k8_plain_ms = gpu_ms(lambda: fp.flash_prefill_paged_plain(q, k_pool, v_pool, tbl, q_off,
                                                                  scale), reps=3)
        # library: SDPA on the gathered K/V with the chunk-causal mask
        k_dense, v_dense = paged_gather_kv(k_pool, tbl), paged_gather_kv(v_pool, tbl)
        K = k_dense.shape[2]
        qpos = q_off[:, None].long() + torch.arange(g * C, device=dev)[None, :] % C
        mask = (torch.arange(K, device=dev)[None, None, :] <= qpos[..., None])[:, None]
        qf = q.reshape(N, Hkv, g * C, d)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms = gpu_ms(lambda: sdpa(qf, k_dense, v_dense, attn_mask=mask), reps=10)
        lib_bytes = 2 * k_dense.numel() * elem
        kv_bytes = 2 * sum(visible) * Hkv * d * elem           # each K/V row once
        small = 4 * (seg_ctx.numel() * 2 + route.numel()
                     + ld.schedule_tensors(sched, dev)["desc"].numel())
        part_bytes = 4 * sum(t.numel() for t in parts)
        print(f"  {dname} SDPA (gather excluded, chunk-causal mask): {lib_ms:.4f} ms reading "
              f"{lib_bytes / 1e6:.1f} MB; K4 partials {part_bytes / 1e6:.1f} MB "
              f"({sched.num_pieces} pieces x {g * C} rows)", flush=True)
        for name, out_bytes, ms, plain_ms, err in (
            ("lean_prefill_chunk_partials", part_bytes, k4_ms, k4_plain_ms, err_k4),
            ("flash_prefill_paged", o8.numel() * elem, k8_ms, k8_plain_ms, err_k8),
        ):
            b_ms, b_by = bound(dev_name, dname, q.numel() * elem + kv_bytes + small + out_bytes,
                               flops)
            results[(name, dname)] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                                      "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}
            print(f"  {dname} {name}: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}; "
                  f"{flops / ms / 1e9:.1f} TFLOP/s; plain {plain_ms:.3f} ms; library "
                  f"{lib_ms:.4f} ms)", flush=True)
    return results


# ------------------------------------------------------ fixed-split decode (K6)
DECODE_SHAPES = ((4000, 1500, 700, 1), (16384, 512, 256, 17))


def fixed_decode_phase(torch, sm_count: int, dev_name: str):
    """K6 (fixed-split partials) against its plain version at K2's ragged
    lens and at one long-context shape, with FlashDecoding's split factor;
    then K2 against K6 on both shapes (the paper's comparison): K2 is the
    whole stream-K decode, K6 + merge_n the whole fixed-split one."""
    from repro_torch.core.leantile import fixed_split_factor, make_schedule
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import lean_decode as ld
    from repro_torch.kernels import ops

    Hq, Hkv, d, tile = 32, 8, 128, 128
    gq = Hq // Hkv
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    scale = 1.0 / math.sqrt(d)
    results = {}
    for lens in DECODE_SHAPES:
        B = len(lens)
        width = -(-max(lens) // tile)
        splits = fixed_split_factor(max(lens), B * Hkv, tile, sm_count)
        sched = make_schedule(list(lens), Hkv, tile, sm_count)
        seg_ctx = torch.tensor([L for L in lens for _ in range(Hkv)], dtype=torch.int32,
                               device=dev)
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            dname = str(dtype).split(".")[-1]
            elem = torch.finfo(dtype).bits // 8
            q, k_pool, v_pool, tbl, k_dense, v_dense = make_kv_problem(
                torch, list(lens), Hq, Hkv, d, tile, width, dtype, gen, dev)
            q_seg = q.reshape(B * Hkv, gq, d).contiguous()
            k_seg = k_dense.reshape(B * Hkv, width * tile, d)
            v_seg = v_dense.reshape(B * Hkv, width * tile, d)
            args = (q_seg, k_seg, v_seg, seg_ctx, splits, tile, scale)
            parts = fd.flash_decode_partials(*args)
            parts_ref = fd.flash_decode_partials_plain(*args)
            torch.cuda.synchronize()
            err = max((a - b).abs().max().item() for a, b in zip(parts, parts_ref))
            check(all(torch.allclose(a, b, atol=tol, rtol=tol) for a, b in zip(parts, parts_ref)),
                  f"K6 {dname} lens {lens} disagrees with the plain version: max |err| {err}")
            o6 = ops.flash_decode_from_lens(q, k_dense, v_dense, seg_ctx, num_splits=splits,
                                            tile=tile)
            k_rows, v_rows = ops._pool_rows(k_pool, v_pool)
            route = ops._paged_route(sched, tbl, Hkv)
            k2_args = (q_seg, k_rows, v_rows, seg_ctx, route, sched, scale)
            o2, _ = ld.lean_decode_fused(*k2_args)
            err_26 = (o2.reshape(B, Hq, d) - o6.float()).abs().max().item()
            check(err_26 <= (1e-4 if dtype == torch.float32 else 2.0 ** -7),
                  f"K2 and K6 + merge_n disagree on lens {lens} ({dname}): {err_26}")
            k6_ms = gpu_ms(lambda: fd.flash_decode_partials(*args))
            k6_plain_ms = gpu_ms(lambda: fd.flash_decode_partials_plain(*args), reps=3)
            k6_full_ms = gpu_ms(lambda: ops.flash_decode_from_lens(
                q, k_dense, v_dense, seg_ctx, num_splits=splits, tile=tile))
            k2_ms = gpu_ms(lambda: ld.lean_decode_fused(*k2_args))
            tokens = sum(lens) * Hkv
            kv_bytes = 2 * tokens * d * elem
            out_bytes = 4 * sum(t.numel() for t in parts)
            b_ms, b_by = bound(dev_name, dname, kv_bytes + q_seg.numel() * elem + 4 * B * Hkv
                               + out_bytes, 4 * gq * d * tokens)
            lib = library_yardstick(torch, q, k_dense, v_dense, list(lens), gq, elem)
            lib_ms, lib_bytes = lib[LIBRARY_CALL]
            results[(lens, dname)] = {"ms": k6_ms, "plain_ms": k6_plain_ms, "library_ms": lib_ms,
                                      "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}
            print(f"K6 lens {list(lens)} {dname}: splits {splits} x {-(-width // splits)} tiles "
                  f"({B * Hkv * splits} CTAs), max|err| {err:.3e}; {k6_ms:.4f} ms partials, "
                  f"{k6_full_ms:.4f} ms with merge_n (bound {b_ms:.4f} ms by {b_by}, "
                  f"{kv_bytes / 1e6:.1f} MB K/V; plain {k6_plain_ms:.3f} ms; library "
                  f"{lib_ms:.4f} ms reading {lib_bytes / 1e6:.1f} MB)", flush=True)
            print(f"  K2 vs K6, lens {list(lens)} {dname}: stream-K K2 {k2_ms:.4f} ms "
                  f"({sched.num_workers} workers, {sched.num_pieces} pieces) against fixed-split "
                  f"K6 + merge_n {k6_full_ms:.4f} ms: K2/K6 = {k2_ms / k6_full_ms:.3f}; "
                  f"outputs agree within {err_26:.2e}", flush=True)
    return results


def library_yardstick(torch, q, k_dense, v_dense, lens, gq, elem):
    """``scaled_dot_product_attention`` on the K/V already gathered to dense
    ``(B, Hkv, S_pad, d)``, timed two ways; returns ``{how: (ms, K/V bytes
    read)}``. The ``gq`` query heads of a KV head are folded into query rows,
    which is the same function with no K/V copied per query head. One call
    reads the padded batch with a length mask; one call per sequence reads
    exactly its length. Timed only; the port never calls it."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, Hkv, S_pad, d = k_dense.shape
    qf = q.reshape(B, Hkv, gq, d)
    mask = (torch.arange(S_pad, device=q.device)[None, :]
            < torch.tensor(lens, device=q.device)[:, None])[:, None, None, :]
    padded_ms = gpu_ms(lambda: sdpa(qf, k_dense, v_dense, attn_mask=mask))
    views = [(qf[b:b + 1], k_dense[b:b + 1, :, :L], v_dense[b:b + 1, :, :L])
             for b, L in enumerate(lens)]
    per_seq_ms = gpu_ms(lambda: [sdpa(*v) for v in views])
    return {
        LIBRARY_CALL: (padded_ms, 2 * B * Hkv * S_pad * d * elem),
        f"{B} calls, one per sequence": (per_seq_ms, 2 * sum(lens) * Hkv * d * elem),
    }


# --------------------------------------------------------------- engine phases
PROMPT_LENS = (3000, 1200, 300, 17)


def make_requests(Request, vocab, new_tokens, seed=1):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [
        Request(uid=i, prompt=rng.integers(0, vocab, n).astype(np.int32),
                max_new_tokens=new_tokens)
        for i, n in enumerate(PROMPT_LENS)
    ]


def engine_config(backend, sm_count, fused=True):
    from repro_torch.serving.config import EngineConfig, PagedConfig

    return EngineConfig(
        max_batch=4, cache_len=4096, attn_backend=backend, num_workers=sm_count,
        fused=fused, paged=PagedConfig(enabled=True, page_size=128),
    )


def drive(torch, eng, reqs):
    """Submit, then tick until drained. Returns (first tick's seconds, the
    later ticks' (seconds, tokens emitted), first tick's logits)."""
    for r in reqs:
        eng.submit(r)
    first, ticks, first_logits = None, [], None
    while eng.queue or any(eng.slot_req):
        t0 = time.perf_counter()
        out = eng.tick()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if first is None:
            first, first_logits = dt, eng.last_logits.clone()
        else:
            ticks.append((dt, len(out)))
    return first, ticks, first_logits


TRACED_TICKS = 5


def _union_us(intervals):
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def traced_ticks(torch, eng, reqs, untraced_p50_s: float):
    """Where a decode tick's time goes: serve ``reqs`` again on the drained
    engine, past admission and a warm-up, and trace ``TRACED_TICKS`` decode
    ticks with ``torch.profiler``. Prints device busy per tick (union of the
    kernel intervals), kernel launches per tick, the device's idle share --
    of the traced ticks, and of the untraced tick p50, since the profiler
    slows the host -- and the kernels with the most device time."""
    for r in reqs:
        eng.submit(r)
    for _ in range(3):                       # admission tick + warm-up
        eng.tick()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    walls = []
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(TRACED_TICKS):
            t0 = time.perf_counter()
            eng.tick()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    while eng.queue or any(eng.slot_req):
        eng.tick()
    eng.pool.check()
    check(eng.pool.num_allocated == 0, "pages leaked after the traced ticks")
    kernels, busy_ms, by_name = device_time(prof)
    busy_ms /= TRACED_TICKS
    wall_ms = statistics.median(walls) * 1e3
    print(f"traced ticks: {TRACED_TICKS} decode ticks under torch.profiler, wall p50 "
          f"{wall_ms:.2f} ms; device busy {busy_ms:.2f} ms/tick; "
          f"{len(kernels) / TRACED_TICKS:.0f} kernel launches/tick; device idle share "
          f"{1 - busy_ms * TRACED_TICKS / (sum(walls) * 1e3):.3f} traced, "
          f"{1 - busy_ms / (untraced_p50_s * 1e3):.3f} of the untraced tick p50", flush=True)
    print_top(by_name, TRACED_TICKS, "tick", 10)


def device_time(prof):
    """(device kernels, device busy ms -- the union of their intervals --,
    {kernel name: (calls, us)}) of a ``torch.profiler`` run."""
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    check(kernels, "the profiler recorded no device kernels")
    busy_ms = _union_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    return kernels, busy_ms, by_name


def print_top(by_name, per: int, unit: str, top: int):
    for kname, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"  {t / per / 1e3:8.3f} ms/{unit}  {n / per:7.1f}x  {kname[:90]}", flush=True)


def traced_scheduler_phase(torch, cfg, params, backend, sm_count, new_tokens, blocking):
    """A scheduler phase under ``torch.profiler``: device busy against the
    traced wall, kernels, host syncs (``aten::item``: the host waits for the
    device and the launch queue drains), and the kernels with the most
    device time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run = scheduler_phase(torch, cfg, params, backend, sm_count, new_tokens, blocking)
    kernels, busy_ms, by_name = device_time(prof)
    syncs = sum(1 for e in prof.events() if e.device_type.name == "CPU" and e.name == "aten::item")
    print(f"traced scheduler phase ({backend}): wall {run['wall'] * 1e3:.1f} ms under the "
          f"profiler, device busy {busy_ms:.1f} ms (idle share {1 - busy_ms / (run['wall'] * 1e3):.3f}), "
          f"{len(kernels)} kernels, {syncs} host syncs (aten::item)", flush=True)
    print_top(by_name, 1, "phase", 6)


SCHED_CHUNK, SCHED_PACK, SCHED_BUDGET = 256, 2, 512


def scheduler_phase(torch, cfg, params, backend, sm_count, new_tokens, blocking):
    """The ``PROMPT_LENS`` requests served by ``Scheduler`` with chunked
    prefill on ``backend``. ``blocking`` holds the blocking engine phase's
    first tokens and first-token logits per request. Returns the launch
    counts and step counts of the run."""
    from repro_torch.serving.engine import DecodeEngine
    from repro_torch.serving.scheduler import RequestState, Scheduler, SchedulerConfig

    class FirstTokenEngine(DecodeEngine):
        """Keeps the logits row each request's first token was sampled
        from, off the chunk step that completed its prompt."""

        first_rows = {}

        def prefill_chunks_tick(self, work, pack_width, chunk_cap):
            toks = super().prefill_chunks_tick(work, pack_width, chunk_cap)
            for i, (slot, chunk, off) in enumerate(work):
                req = self.slot_req[slot]
                if off + len(chunk) == len(req.prompt):
                    self.first_rows[req.uid] = self.last_prefill_logits[i].float()
            return toks

    eng = FirstTokenEngine(cfg, params, engine_config(backend, sm_count), device="cuda")
    sch = Scheduler(eng, SchedulerConfig(chunk_size=SCHED_CHUNK, prefill_pack=SCHED_PACK,
                                         token_budget=SCHED_BUDGET, chunked=True))
    reset_launch_counts()
    t0 = time.perf_counter()
    handles = [sch.submit(p, new_tokens, uid=i) for i, p in enumerate(blocking["prompts"])]
    long = handles[0]
    overlap = 0
    while sch.pending and sch.stats.steps < 400:
        out = sch.step()
        if long.state is RequestState.PREFILLING:
            overlap += len(out)
    check(not sch.pending, f"{backend} scheduler: requests still pending after 400 steps")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    chunk_steps, ticks = len(eng.stats.tick_prefill_tokens), eng.stats.ticks
    check(all(h.done and len(h.generated) == new_tokens for h in handles),
          f"{backend} scheduler: a request did not finish")
    eng.pool.check()
    check(eng.pool.num_allocated == 0, f"{backend} scheduler: {eng.pool.num_allocated} pages leaked")
    check(overlap > 0, f"{backend} scheduler: decode stalled during the long prefill")
    kernels = {"lean": ("K4", "K2"), "fixed": ("K8", "K6")}[backend]
    check(counts[kernels[0]] == cfg.n_layers * chunk_steps and chunk_steps > 0,
          f"{backend} scheduler: {kernels[0]} launched {counts[kernels[0]]} times, expected "
          f"{cfg.n_layers} x {chunk_steps} chunk steps")
    check(counts[kernels[1]] == cfg.n_layers * ticks and ticks > 0,
          f"{backend} scheduler: {kernels[1]} launched {counts[kernels[1]]} times, expected "
          f"{cfg.n_layers} x {ticks} decode ticks")
    others = {k: n for k, n in counts.items() if k not in kernels and n}
    check(not others, f"{backend} scheduler: other kernels ran: {others}")
    ttft = [(h.first_token_time - h.arrival_time) * 1e3 for h in handles]
    agree = sum(h.generated[0] == blocking["first"][h.uid] for h in handles)
    worst = None
    for h in handles:
        ref = blocking["rows"][h.uid]
        got = eng.first_rows[h.uid]
        check(bool(torch.isfinite(got).all()), f"{backend} scheduler: first-token logits not finite")
        atol = LOGIT_ATOL_FRAC * ref.abs().median().item()
        delta = (got - ref).abs()
        check(torch.allclose(got, ref, rtol=LOGIT_RTOL, atol=atol),
              f"{backend} scheduler: request {h.uid}'s first-token logits differ from blocking "
              f"prefill by up to {delta.max().item()} (allowed {atol} + {LOGIT_RTOL} |ref|)")
        if worst is None or delta.max().item() > worst[0]:
            worst = (delta.max().item(), atol, h.uid)
    print(f"scheduler phase ({backend}): chunk {SCHED_CHUNK}, pack {SCHED_PACK}, budget "
          f"{SCHED_BUDGET}: {sch.stats.steps} scheduler steps, {chunk_steps} chunk steps, "
          f"{ticks} decode ticks in {wall:.2f} s; launches {kernels[0]} {counts[kernels[0]]} = "
          f"{cfg.n_layers} x {chunk_steps}, {kernels[1]} {counts[kernels[1]]} = {cfg.n_layers} x "
          f"{ticks}; TTFT ms per request (prompts {list(PROMPT_LENS)}): "
          + ", ".join(f"{t:.1f}" for t in ttft)
          + f"; {overlap} decode tokens while the {PROMPT_LENS[0]}-token prompt was prefilling; "
          f"pool clean; first tokens agreeing with blocking prefill {agree}/{len(handles)}; "
          f"worst first-token logit gap {worst[0]:.4f} (request {worst[2]}, allowed "
          f"{worst[1]:.4f} + {LOGIT_RTOL} |ref|)", flush=True)
    return {"counts": counts, "chunk_steps": chunk_steps, "ticks": ticks, "wall": wall}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card",
              file=sys.stderr)
        return 2
    try:
        from repro_torch.configs import get_config
        from repro_torch.kernels import build
        from repro_torch.kernels import lean_decode as ld
        from repro_torch.models import init_params
        from repro_torch.serving.engine import DecodeEngine, Request
    except ImportError as exc:
        print(f"chip_smoke: the port's package is missing ({exc}); run from a "
              "checkout of the repository", file=sys.stderr)
        return 2

    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev_name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"device: {dev_name} ({smi}), {sm_count} SMs, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    # 2. build
    build_s = build.build()
    print(f"build: {build_s:.1f} s", flush=True)
    for source in build.SOURCES:
        for line in build.ptxas_report(source).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {source}: {line.strip()}")

    # 3. kernels
    kres = kernel_phase(torch, sm_count, dev_name)
    kres.update(prefill_kernel_phase(torch, sm_count, dev_name))
    k6res = fixed_decode_phase(torch, sm_count, dev_name)

    # 4. engine, full width, K2
    cfg = get_config("mistral-nemo-12b")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    print(f"engine phase: {cfg.name} full width, all {cfg.n_layers} layers "
          f"(d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), "
          f"bf16 weights in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.1f} GB", flush=True)
    new_tokens = 16
    eng = DecodeEngine(cfg, params, engine_config("lean", sm_count), device="cuda")
    reqs = make_requests(Request, cfg.vocab_size, new_tokens)
    blocking = {"prompts": [r.prompt.copy() for r in reqs]}
    reset_launch_counts()
    first_s, ticks, lean_logits = drive(torch, eng, reqs)
    counts = launch_counts()
    k2_launches, k1_in_main = counts["K2"], counts["K1"]
    check(counts["K4"] == counts["K6"] == counts["K8"] == 0,
          f"blocking engine ran chunk or fixed-split kernels: {counts}")
    decode_steps = eng.stats.ticks
    check(all(len(r.generated) == new_tokens for r in reqs), "a request did not finish")
    check(tuple(lean_logits.shape) == (len(reqs), cfg.vocab_size)
          and bool(torch.isfinite(lean_logits).all()), "lean logits malformed or not finite")
    check(k2_launches == cfg.n_layers * decode_steps and k2_launches > 0,
          f"K2 launched {k2_launches} times, expected {cfg.n_layers} x {decode_steps}")
    check(k1_in_main == 0, f"K1 ran {k1_in_main} times on the fused path")
    eng.pool.check()
    check(eng.pool.num_allocated == 0, f"{eng.pool.num_allocated} pages leaked")
    p50 = statistics.median(dt for dt, _ in ticks)
    tok_s = sum(n for _, n in ticks) / sum(dt for dt, _ in ticks)
    print(f"  {len(reqs)} requests (prompts {list(PROMPT_LENS)}, {new_tokens} new tokens "
          f"each): admission + first decode tick {first_s * 1e3:.1f} ms; decode tick "
          f"p50 {p50 * 1e3:.2f} ms over {len(ticks)} ticks, {tok_s:.1f} tokens/s; "
          f"K2 launches {k2_launches} = {cfg.n_layers} layers x {decode_steps} steps; "
          "pool clean", flush=True)
    traced_ticks(torch, eng, make_requests(Request, cfg.vocab_size, TRACED_TICKS + 6), p50)
    del eng

    # 5. two-phase (K1 + merge)
    eng = DecodeEngine(cfg, params, engine_config("lean", sm_count, fused=False), device="cuda")
    reqs2 = make_requests(Request, cfg.vocab_size, 4)
    reset_launch_counts()
    drive(torch, eng, reqs2)
    k1_launches, k2_in_two = ld.partials_launches, ld.fused_launches
    check(k1_launches == cfg.n_layers * eng.stats.ticks and k1_launches > 0,
          f"K1 launched {k1_launches} times, expected {cfg.n_layers} x {eng.stats.ticks}")
    check(k2_in_two == 0, "K2 ran on the fused=False path")
    check(bool(torch.isfinite(eng.last_logits).all()), "two-phase logits are not finite")
    eng.pool.check()
    print(f"two-phase phase: {eng.stats.ticks} decode steps, K1 launches {k1_launches}, "
          "logits finite, pool clean", flush=True)
    del eng

    # 6. 'ref' backend against lean on the first decode tick
    eng = DecodeEngine(cfg, params, engine_config("ref", sm_count), device="cuda")
    for r in make_requests(Request, cfg.vocab_size, new_tokens):
        eng.submit(r)
    eng.tick()
    ref_logits = eng.last_logits
    typical = ref_logits.abs().median().item()
    atol = LOGIT_ATOL_FRAC * typical
    delta = (ref_logits - lean_logits).abs()
    at = int(delta.argmax())
    diff, ref_at = delta.flatten()[at].item(), ref_logits.flatten()[at].item()
    agree = int((ref_logits.argmax(-1) == lean_logits.argmax(-1)).sum())
    print(f"ref cross-check: first decode tick, median |ref logit| {typical:.4f}; "
          f"max |logit lean - ref| {diff:.4f} where ref = {ref_at:.4f} (allowed "
          f"{atol:.4f} + {LOGIT_RTOL} |ref|); greedy tokens agreeing "
          f"{agree}/{len(PROMPT_LENS)}", flush=True)
    check(typical > 0 and torch.allclose(lean_logits, ref_logits, rtol=LOGIT_RTOL, atol=atol),
          f"lean and ref logits differ by up to {diff} (ref {ref_at}, typical |logit| {typical})")
    del eng

    # 7. scheduler phases: chunked prefill on the lean and fixed backends,
    # against the blocking engine's first tokens (prefill at the exact length)
    from repro_torch.models import prefill

    blocking["first"] = [r.generated[0] for r in reqs]
    blocking["rows"] = []
    for p in blocking["prompts"]:
        toks = torch.as_tensor(p.astype("int64")[None]).cuda()
        blocking["rows"].append(prefill(params, cfg, toks, cache_len=4096)[0][0].float())
    # in turns (lean, fixed, fixed, lean), so that the backends' wall times
    # compare on one card without the first phase's warm-up in either
    sched_runs, walls = {}, []
    for b in ("lean", "fixed", "fixed", "lean"):
        run = scheduler_phase(torch, cfg, params, b, sm_count, new_tokens, blocking)
        sched_runs.setdefault(b, run)
        walls.append(run["wall"])
    print("scheduler phases, wall s in turns (lean, fixed, fixed, lean): "
          + ", ".join(f"{w:.2f}" for w in walls), flush=True)
    for b in ("lean", "fixed"):
        traced_scheduler_phase(torch, cfg, params, b, sm_count, new_tokens, blocking)

    # 8. summary: kernel times in bf16 at the main path's shapes; launches
    # from the run of the path each kernel serves
    k6 = k6res[(DECODE_SHAPES[0], "bfloat16")]
    kres[("flash_decode_partials", "bfloat16")] = k6
    launches = {"lean_decode_fused": k2_launches, "lean_decode_partials": k1_launches,
                "lean_prefill_chunk_partials": sched_runs["lean"]["counts"]["K4"],
                "flash_decode_partials": sched_runs["fixed"]["counts"]["K6"],
                "flash_prefill_paged": sched_runs["fixed"]["counts"]["K8"]}
    where = {
        "lean_decode_fused": ("lean_decode.cu", "src/repro/kernels/lean_decode.py:302"),
        "lean_decode_partials": ("lean_decode.cu", "src/repro/kernels/lean_decode.py:117"),
        "lean_prefill_chunk_partials": ("lean_prefill.cu",
                                        "src/repro/kernels/lean_prefill.py:51"),
        "flash_decode_partials": ("flash_decode.cu", "src/repro/kernels/flash_decode.py:25"),
        "flash_prefill_paged": ("flash_prefill.cu", "src/repro/kernels/flash_prefill.py:162"),
    }
    kernels = []
    for name, (source, replaces) in where.items():
        r = kres[(name, "bfloat16")]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            # no one PyTorch call computes K1's per-piece partials; SDPA
            # computes the attention K2, K4 (+ merge), K6 (+ merge_n) and K8 do
            "library_ms": None if name == "lean_decode_partials" else r["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
