"""CLI: render traces and flight dumps, fit roofline calibrations (port of
``python -m repro.obs``).

    python -m repro_torch.obs report TRACE.json [--limit N] [--calib CALIB.json]
    python -m repro_torch.obs flight FLIGHT.json [--tail N]
    python -m repro_torch.obs calibrate TRACE.json [--out CALIB.json]

Exit codes: 0 on success, 2 on unreadable/malformed input.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.obs.calib import fit_calibration, load_calibration
from repro_torch.obs.flight import load_flight_dump
from repro_torch.obs.report import render_flight, render_report
from repro_torch.obs.trace import load_trace


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Render observability artifacts.",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser(
        "report",
        help="per-tick attribution + request timelines from a trace",
    )
    rp.add_argument("trace", help="trace JSON written by Tracer.save()")
    rp.add_argument("--limit", type=int, default=40,
                    help="max ticks to print (default 40)")
    rp.add_argument("--calib", default=None,
                    help="fitted calibration JSON: render the occupancy "
                         "column against calibrated predictions")

    fp = sub.add_parser(
        "flight", help="render a flight-recorder postmortem bundle"
    )
    fp.add_argument("dump", help="flight dump JSON")
    fp.add_argument("--tail", type=int, default=20,
                    help="trailing events to print (default 20)")

    cp = sub.add_parser(
        "calibrate",
        help="fit per-path roofline correction factors from a trace",
    )
    cp.add_argument("trace", help="trace JSON with decode_kernel spans")
    cp.add_argument("--out", default=None,
                    help="write the fitted calibration JSON here")
    cp.add_argument("--min-samples", type=int, default=3,
                    help="min spans per path for a dedicated factor")

    args = p.parse_args(argv)
    try:
        if args.cmd == "report":
            calib = (
                load_calibration(args.calib)
                if args.calib is not None else None
            )
            print(render_report(
                load_trace(args.trace), limit=args.limit, calib=calib
            ))
        elif args.cmd == "flight":
            print(render_flight(load_flight_dump(args.dump), tail=args.tail))
        else:
            calib = fit_calibration(
                load_trace(args.trace), min_samples=args.min_samples
            )
            for path, f in sorted(calib.factors.items()):
                print(
                    f"{path:10s} factor {f:12.4g}  "
                    f"({calib.samples.get(path, 0)} spans)"
                )
            print(f"{'default':10s} factor {calib.default:12.4g}")
            if args.out:
                calib.save(args.out)
                print(f"wrote {args.out}")
    except (OSError, ValueError, KeyError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
