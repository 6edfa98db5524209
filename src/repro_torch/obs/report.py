"""Render recorded traces into attribution and timeline reports (port of
``repro.obs.report``; the text is the reference's, line for line).

Consumes the JSON documents written by :meth:`repro_torch.obs.trace.Tracer.save`
(and flight-recorder bundles) and prints:

  * **per-tick attribution** — for each tick, measured milliseconds split
    by child span (schedule_build / prefill_chunk / decode_kernel / ...)
    next to the roofline cost model's *predicted* memory and compute
    milliseconds for the schedules that ran (``pred_mem_ms`` /
    ``pred_compute_ms`` span metadata, stamped by the engine from
    ``roofline.analysis.schedule_decode_cost``). The ratio column is the
    source paper's occupancy story in table form: how far measured
    decode time sits above the bandwidth bound the schedule implies.
  * **per-request timelines** — TTFT / TPOT / queue-wait per uid from
    the tracer's lifecycle events.
  * **cache & cascade effectiveness** — hit rates and cascade grouping
    counters from the metrics snapshot embedded in the trace ``meta``.

All functions take the loaded trace dict and return strings; the CLI in
``repro_torch.obs.__main__`` just loads, renders, prints.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.roofline.analysis import HBM_BW, PEAK_FLOPS

__all__ = [
    "tick_attribution",
    "render_attribution",
    "render_requests",
    "render_effectiveness",
    "render_watchdog",
    "render_report",
    "render_flight",
]

# child spans broken out as columns (others fold into "other")
_PHASE_COLS = ("schedule_build", "prefill_chunk", "decode_kernel",
               "cascade_group", "merge", "cow", "audit")


def _fmt_ms(v: Optional[float]) -> str:
    return f"{v:8.3f}" if v is not None else "       -"


def tick_attribution(doc: dict, calib=None) -> List[dict]:
    """Fold the span list into one row per tick.

    Each row: measured total tick ms, per-phase child ms, summed
    device-sync ms, and the cost model's predicted memory/compute ms
    (from decode_kernel span metadata — either the pre-stamped
    ``pred_*_ms`` fields or derived from ``kv_bytes``/``flops`` via the
    hardware model). With a fitted :class:`repro_torch.obs.calib.Calibration`,
    each decode span's prediction is scaled by its path's correction
    factor, so the ratio column reads ~1.0 on a healthy run instead of
    the raw platform gap."""
    ticks: Dict[int, dict] = {}
    for sp in doc.get("spans", []):
        t = sp.get("tick", -1)
        row = ticks.get(t)
        if row is None:
            row = ticks[t] = {
                "tick": t, "total_ms": 0.0, "sync_ms": 0.0,
                "pred_mem_ms": 0.0, "pred_compute_ms": 0.0,
                "kv_bytes": 0.0, "flops": 0.0, "other_ms": 0.0,
                **{c: 0.0 for c in _PHASE_COLS},
            }
        name = sp["name"]
        ms = sp.get("ms", 0.0)
        row["sync_ms"] += sp.get("sync_ms", 0.0)
        if name == "tick":
            row["total_ms"] += ms
        elif name in _PHASE_COLS:
            row[name] += ms
        else:
            row["other_ms"] += ms
        meta = sp.get("meta") or {}
        if name == "decode_kernel":
            kv = meta.get("kv_bytes", meta.get("tile_kv_bytes"))
            fl = meta.get("flops")
            if kv is not None:
                row["kv_bytes"] += float(kv)
            if fl is not None:
                row["flops"] += float(fl)
            pm = meta.get("pred_mem_ms")
            pc = meta.get("pred_compute_ms")
            factor = (
                calib.factor(meta.get("path", "fast"))
                if calib is not None else 1.0
            )
            row["pred_mem_ms"] += factor * (
                float(pm) if pm is not None
                else (float(kv) / HBM_BW * 1e3 if kv is not None else 0.0)
            )
            row["pred_compute_ms"] += factor * (
                float(pc) if pc is not None
                else (float(fl) / PEAK_FLOPS * 1e3 if fl is not None else 0.0)
            )
    return [ticks[t] for t in sorted(ticks)]


def render_attribution(doc: dict, limit: int = 40, calib=None) -> str:
    rows = tick_attribution(doc, calib=calib)
    head = "== per-tick attribution (measured vs roofline-predicted ms) =="
    if calib is not None:
        head = ("== per-tick attribution (measured vs CALIBRATED "
                "roofline ms) ==")
    lines = [
        head,
        ("tick   total  sched  prefil decode  cascde  other  "
         "pr.mem pr.cmp  meas/pred"),
    ]
    if not rows:
        lines.append("  (no spans recorded)")
        return "\n".join(lines)
    shown = rows[-limit:]
    if len(rows) > len(shown):
        lines.append(f"  ... {len(rows) - len(shown)} earlier ticks elided")
    for r in shown:
        pred = r["pred_mem_ms"] + r["pred_compute_ms"]
        ratio = (
            f"{r['decode_kernel'] / pred:7.1f}x" if pred > 0 else "       -"
        )
        lines.append(
            f"{r['tick']:4d} "
            f"{r['total_ms']:7.2f} {r['schedule_build']:6.2f} "
            f"{r['prefill_chunk']:6.2f} {r['decode_kernel']:7.2f} "
            f"{r['cascade_group']:7.2f} {r['other_ms']:6.2f} "
            f"{r['pred_mem_ms']:8.2g} {r['pred_compute_ms']:8.2g} "
            f"{ratio}"
        )
    tot = {
        k: sum(r[k] for r in rows)
        for k in ("total_ms", "decode_kernel", "pred_mem_ms",
                  "pred_compute_ms", "kv_bytes")
    }
    pred = tot["pred_mem_ms"] + tot["pred_compute_ms"]
    lines.append(
        f"  sum: total {tot['total_ms']:.2f} ms, decode_kernel "
        f"{tot['decode_kernel']:.2f} ms, predicted {pred:.4g} ms "
        f"({tot['kv_bytes'] / 1e6:.2f} MB KV streamed)"
    )
    if pred > 0:
        note = (
            "(1.0x == matches the calibrated expectation)"
            if calib is not None else
            "(1.0x == hardware-limited; interpret-mode CPU runs are "
            "far above)"
        )
        lines.append(
            f"  measured decode / roofline bound: "
            f"{tot['decode_kernel'] / pred:.1f}x {note}"
        )
    return "\n".join(lines)


def render_requests(doc: dict) -> str:
    reqs = doc.get("requests") or {}
    lines = [
        "== per-request timelines ==",
        ("uid            queue_wait   ttft      tpot.mean  "
         "tokens  final"),
    ]
    if not reqs:
        lines.append("  (no request events recorded)")
        return "\n".join(lines)

    def _key(item):
        ev = item[1].get("events") or [{}]
        return ev[0].get("t", 0.0)

    for uid, s in sorted(reqs.items(), key=_key):
        if s is None:
            continue
        tpot = (s.get("tpot_s") or {}).get("mean")
        final = (s.get("events") or [{}])[-1].get("state", "?")
        lines.append(
            f"{str(uid)[:14]:14s} "
            f"{_fmt_ms(_sec_ms(s.get('queue_wait_s')))}  "
            f"{_fmt_ms(_sec_ms(s.get('ttft_s')))}  "
            f"{_fmt_ms(_sec_ms(tpot))}   "
            f"{s.get('tokens', 0):5d}  {final}"
        )
    return "\n".join(lines)


def _sec_ms(v: Optional[float]) -> Optional[float]:
    return v * 1e3 if v is not None else None


def render_effectiveness(doc: dict) -> str:
    """Cache / cascade effectiveness from the metrics snapshot the
    engine embeds under trace ``meta.metrics`` (registry ``as_dict``)."""
    metrics = (doc.get("meta") or {}).get("metrics") or {}
    lines = ["== cache & cascade effectiveness =="]
    if not metrics:
        lines.append("  (no metrics snapshot embedded in trace)")
        return "\n".join(lines)
    picks = [
        ("prefix_cache_hit_rate", "prefix-cache hit rate"),
        ("prefix_cache_bytes_saved", "prefix-cache bytes saved"),
        ("schedule_cache_hit_rate", "schedule-cache hit rate"),
        ("engine_cascade_ticks", "cascade ticks"),
        ("engine_cascade_grouped_passes", "cascade grouped passes"),
        ("engine_cascade_grouped_slots", "cascade grouped slots"),
        ("kvpool_pages_in_use", "KV pages in use"),
        ("kvpool_page_utilization", "KV page utilization"),
        ("kvpool_pages_saved", "KV pages deduped"),
    ]
    shown = 0
    for key, label in picks:
        if key in metrics:
            v = metrics[key]
            if isinstance(v, float):
                lines.append(f"  {label:28s} {v:.4g}")
            else:
                lines.append(f"  {label:28s} {v}")
            shown += 1
    if not shown:
        for k in sorted(metrics)[:12]:
            lines.append(f"  {k:34s} {metrics[k]}")
    return "\n".join(lines)


def render_watchdog(doc: dict) -> str:
    """Detector timeline + SLO error-budget table from the watchdog
    snapshot embedded under trace ``meta.watchdog`` (see
    :meth:`repro_torch.obs.watch.PerfWatchdog.as_dict`)."""
    wd = (doc.get("meta") or {}).get("watchdog") or {}
    lines = ["== watchdog detector timeline =="]
    if not wd:
        lines.append("  (no watchdog snapshot embedded in trace)")
    else:
        counts = wd.get("fire_counts") or {}
        armed = ", ".join(
            f"{k}:{v}" for k, v in sorted(counts.items()) if v
        ) or "none"
        lines.append(
            f"  {wd.get('ticks', 0)} watched ticks, "
            f"{wd.get('total_fires', 0)} detector fires ({armed})"
        )
        fires = wd.get("fires") or []
        for f in fires[-20:]:
            det = f.get("detector", "?")
            detail = ", ".join(
                f"{k}={v}" for k, v in sorted(f.items())
                if k not in ("detector", "tick", "window")
            )
            lines.append(f"  tick {f.get('tick', -1):4d}  {det:20s} {detail}")
        if not fires:
            lines.append("  (no detector fires)")
    lines.append("")
    lines.append("== SLO error budgets ==")
    slo = wd.get("slo") or {}
    if not slo:
        lines.append("  (no SLO classes declared)")
    else:
        lines.append(
            "  class         events breach  budget  remaining  burn"
        )
        for name in sorted(slo):
            b = slo[name]
            lines.append(
                f"  {name[:13]:13s} {b.get('events', 0):6d} "
                f"{b.get('breaches', 0):6d} "
                f"{b.get('budget', 0.0):7.3f} "
                f"{b.get('budget_remaining', 0.0):9.3f} "
                f"{b.get('burn_rate', 0.0):6.2f}"
            )
    return "\n".join(lines)


def render_report(doc: dict, limit: int = 40, calib=None) -> str:
    head = (
        f"trace: {doc.get('ticks', 0)} ticks, "
        f"{len(doc.get('spans', []))} spans, "
        f"{len(doc.get('requests') or {})} requests"
    )
    return "\n\n".join([
        head,
        render_attribution(doc, limit=limit, calib=calib),
        render_requests(doc),
        render_effectiveness(doc),
        render_watchdog(doc),
    ])


def render_flight(doc: dict, tail: int = 20) -> str:
    """Human view of a flight-recorder postmortem bundle."""
    events = doc.get("events", [])
    lines = [
        f"flight dump: reason={doc.get('reason')!r}, "
        f"{len(events)} events (showing last {min(tail, len(events))})",
    ]
    reason = str(doc.get("reason") or "")
    if reason.startswith("watchdog-"):
        lines.append(
            f"watchdog-armed postmortem: detector "
            f"{reason[len('watchdog-'):]!r} "
            "(tripping window in context below)"
        )
    ctx = doc.get("context")
    if ctx:
        lines.append("context: " + ", ".join(
            f"{k}={v}" for k, v in sorted(ctx.items())
        ))
    for ev in events[-tail:]:
        extra = {
            k: v for k, v in ev.items()
            if k not in ("seq", "t", "kind")
        }
        body = " ".join(f"{k}={v}" for k, v in sorted(extra.items()))
        lines.append(
            f"  #{ev.get('seq', '?'):>5} t={ev.get('t', 0.0):9.4f}s "
            f"{ev.get('kind', '?'):14s} {body}"
        )
    return "\n".join(lines)
