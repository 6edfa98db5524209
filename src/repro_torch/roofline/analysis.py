"""Roofline cost of one stream-K decode pass, on the card's published peaks
(port of the device-independent part of ``repro.roofline.analysis``).

Hardware model: NVIDIA H100 80GB HBM3, SXM5 (NVIDIA data sheet, dense
rates without sparsity, at its 700 W power limit):

  peak bf16 tensor-core compute   989 TFLOP/s
  HBM3 bandwidth                  3.35 TB/s

A card set below 700 W (``nvidia-smi --query-gpu=power.limit``) reaches
less of either, so a prediction from these peaks is a bound, not an
expectation; :func:`calibrated_cost` carries the measured difference.

:func:`model_flops_for` counts a step's useful operations (training's MFU
divides it by the step time and ``PEAK_FLOPS``). The reference's HLO
parsers (``analyze``, ``collective_bytes``, ``Roofline``) and its dry-run
readers (``roofline/measure.py``, ``roofline/report.py``) belong to the
distributed port (ROADMAP queue 1, item 16).
"""
from __future__ import annotations

from typing import Dict

PEAK_FLOPS = 989e12     # bf16 FLOP/s, dense
HBM_BW = 3.35e12        # bytes/s


def schedule_decode_cost(
    sched,
    *,
    n_q_heads: int,
    n_kv_heads: int,
    head_dim: int,
    kv_elem_bytes: int = 4,
    q_rows: int = 1,
) -> Dict[str, float]:
    """Predicted cost of one stream-K decode pass over ``sched``.

    ``sched`` is a ``LeanSchedule``: ``seg_len`` holds the per-segment
    context length in tokens (one segment per (batch, kv_head) pair), so
    the KV traffic the kernel must stream is exactly

        kv_bytes = sum(seg_len) * head_dim * 2 * kv_elem_bytes

    (K and V planes), and the attention flops per query row are the
    usual QK^T + PV = 4 * head_dim per (q_head, kv token) with
    ``n_q_heads / n_kv_heads`` query heads sharing each segment's KV.
    ``tile_kv_bytes`` is the tile-padded variant (``total_tiles *
    tile_size`` KV positions) -- what the kernel actually walks, padding
    included. Predicted times come from the module's hardware model
    (``HBM_BW`` / ``PEAK_FLOPS``); the obs report compares them to
    measured ``decode_kernel`` span milliseconds.
    """
    kv_tokens = int(sched.seg_len.sum())
    tile_kv_tokens = int(sched.total_tiles) * int(sched.tile_size)
    plane = head_dim * 2 * kv_elem_bytes           # K + V per token
    group = max(1, n_q_heads // max(1, n_kv_heads))
    flops = 4.0 * head_dim * group * q_rows * kv_tokens
    kv_bytes = float(kv_tokens * plane)
    tile_kv_bytes = float(tile_kv_tokens * plane)
    return {
        "kv_tokens": kv_tokens,
        "kv_bytes": kv_bytes,
        "tile_kv_bytes": tile_kv_bytes,
        "flops": flops,
        "pred_mem_ms": tile_kv_bytes / HBM_BW * 1e3,
        "pred_compute_ms": flops / PEAK_FLOPS * 1e3,
        "total_tiles": int(sched.total_tiles),
        "num_segments": int(sched.num_segments),
        "num_pieces": int(sched.num_pieces),
    }


def calibrated_cost(cost: dict, factor: float) -> dict:
    """Scale a :func:`schedule_decode_cost` prediction into measured-time
    units using a fitted correction factor (see
    :func:`repro_torch.obs.calib.fit_calibration`). The hardware model
    above is a *bound*; the factor carries everything the bound ignores --
    launch overhead, the rest of the decode step the span times, layout
    traffic -- so consumers compare measured ms against ``factor *
    predicted`` instead of the raw bound."""
    out = dict(cost)
    out["pred_mem_ms"] = cost["pred_mem_ms"] * factor
    out["pred_compute_ms"] = cost["pred_compute_ms"] * factor
    out["calib_factor"] = float(factor)
    return out


def model_flops_for(cfg, shape_spec, n_params_active: int) -> float:
    """Analytic useful FLOPs of one step (``repro/roofline/analysis.py:
    221-255``): train ``6 N tokens`` (forward 2N, backward 4N) plus the
    attention term; prefill ``2 N tokens`` plus attention; decode ``2 N B``
    plus the KV term. Attention counts ``QK^T + PV = 4 Hq hd`` per (token,
    visible key) and layer, a window capping the keys, three times over
    for training."""
    B, S = shape_spec.global_batch, shape_spec.seq_len
    attn = 0.0
    for pattern, reps in cfg.stages:
        for kind in pattern:
            if kind not in ("attn", "win", "xattn"):
                continue
            w = cfg.window if kind == "win" else None
            Hq, hd = cfg.spec_heads, cfg.head_dim
            if shape_spec.kind in ("train", "prefill"):
                if w is None:
                    ctx_sum = S * (S + 1) / 2
                else:
                    ctx_sum = w * S - w * (w - 1) / 2 if S > w else S * (S + 1) / 2
                mult = 3 if shape_spec.kind == "train" else 1
                attn += reps * mult * B * 4 * Hq * hd * ctx_sum
            else:
                ctx = min(S, w) if w else S
                attn += reps * B * 4 * Hq * hd * ctx
    N = n_params_active
    if shape_spec.kind == "train":
        return 6.0 * N * B * S + attn
    if shape_spec.kind == "prefill":
        return 2.0 * N * B * S + attn
    return 2.0 * N * B + attn
