#!/usr/bin/env python3
"""Find the highest production rate the follow service sustains: run a
follow cell's traffic at each of several rates and print, per rate, how
the service's lag (records produced but not yet in a published document)
moves over the window.

    python3 benchmark/sweep_follow.py --workload demo-compacted.follow \\
        --rates 1e6,2e6,3e6 --seconds 20 --seed 7

A rate is sustained when the lag does not grow over the window: the
least-squares slope of the lag over the window's frames, the first left
out (it closes the backlog's pass), is under ``GROWTH`` of the rate.
Near the service's capacity the passes lengthen for tens of seconds
before the lag levels off, so such a rate is not sustained over the
window. One JSON line per rate; the cell's own rate is
then fixed at four fifths of the highest sustained one. The cell is any
of the manifest's cells of traffic ``follow``; its file's ``rate`` is
replaced by each of ``--rates``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.control import cell_files  # noqa: E402
from benchmark.run import Run  # noqa: E402
from benchmark.traffic import follow  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: Largest lag growth, as a share of the production rate, that counts as
#: a lag that does not grow.
GROWTH = 0.02


def lag_trace(out: dict) -> "list[tuple[float, int]]":
    """(seconds into the window, lag in records) at each frame of the
    window."""
    stamps, frames = out["stamps"], out["frames"]
    t0 = stamps[0] if stamps else 0.0
    rows = []
    k = 0
    for mono, _, data in frames:
        if not stamps or mono < t0 or mono > stamps[-1]:
            continue
        while k < len(stamps) and stamps[k] <= mono:
            k += 1
        produced = (out["backlog"] + k) * out["per_step"]
        rows.append((mono - t0, produced - int(data.get("records", 0))))
    return rows


def main(argv=None, *, manifest: "Path | None" = None, cpu: bool = False) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True, help="records/s, comma-separated")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    cell, config, params = cell_files(args.workload, manifest or ROOT / "BENCHMARK.json")
    for rate in [float(r) for r in args.rates.split(",")]:
        run_args = SimpleNamespace(workload=cell["name"], seed=args.seed,
                                   seconds=args.seconds, trace=0)
        ctx = Run(run_args, cell, config, dict(params, rate=rate), "", not cpu,
                  ["--device", "cpu"] if cpu else [])
        ctx.t_start = time.monotonic()
        out = follow.run(ctx)
        lags = lag_trace(out)
        pts = lags[1:]
        slope = None
        if len(pts) >= 3:
            mt = sum(t for t, _ in pts) / len(pts)
            ml = sum(lag for _, lag in pts) / len(pts)
            slope = (sum((t - mt) * (lag - ml) for t, lag in pts)
                     / sum((t - mt) ** 2 for t, _ in pts))
        stale = out["metrics"]
        c = out["layer"]["counters"]
        print(json.dumps({
            "rate": rate, "frames": len(lags), "lag_slope": slope,
            "sustained": slope is not None and slope < GROWTH * rate,
            "staleness_p50_s": stale.get("staleness_p50_s"),
            "staleness_p95_s": stale.get("staleness_p95_s"),
            "finalize_s": c.get("kta_backend_finalize_seconds:sum", 0.0)
            / max(1.0, c.get("kta_backend_finalize_seconds:count", 0.0)),
            "failed": out["failed"], "lags": lags,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
