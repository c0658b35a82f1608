"""Time one scan command in several checkouts of the port, in turns.

    python -m kafka_topic_analyzer_tpu_torch.tools.ab_scan \\
        --tree build/parent --tree . --rounds 2 -- \\
        -t scan --source segfile --segment-dir DUMP -c --native on

Every run is a fresh process in its checkout (that checkout's package and
kernel builds), timed around `engine.run_scan` with the device
synchronized on both sides, so set-up, the kernels' first build and
interpreter start stay out of the wall.  Each tree first runs once
untimed (it builds its kernels there).  Round r runs the trees in order
when r is even and in reverse when it is odd (A B B A ...), so a drift of
the host over the call falls on every tree alike.  Prints one line per
run and, last, one JSON object: records/s of every run per tree, their
median and quartiles, and whether every run's report (timing lines
aside) is the same.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

#: What each run executes, in its checkout: one scan of the CLI's
#: arguments through the engine, timed on the host clock.
_CHILD = r"""
import json, sys, time
import torch
from kafka_topic_analyzer_tpu_torch import cli
from kafka_topic_analyzer_tpu_torch.backends.gpu import TorchBackend
from kafka_topic_analyzer_tpu_torch.engine import run_scan
from kafka_topic_analyzer_tpu_torch.report import render_report

args = cli.build_parser().parse_args(json.loads(sys.argv[1]))
source, config, use_native = cli.setup(args)
backend = TorchBackend(config, device=args.device, use_native=use_native)
sync = torch.cuda.synchronize if backend.device.type == "cuda" else (lambda: None)
sync()
t0 = time.perf_counter()
result = run_scan(args.topic, source, backend, args.batch_size)
sync()
wall = time.perf_counter() - t0
report = render_report(args.topic, result.metrics, result.start_offsets,
                       result.end_offsets, result.duration_secs,
                       show_alive_keys=True)
print(json.dumps({"records": result.records, "wall": wall,
                  "dispatches": backend.dispatches,
                  "report": "".join(
                      line for line in report.splitlines(keepends=True)
                      if not line.startswith(("Scanning took:", "Estimated Msg/s:")))}))
"""


def run_once(tree: str, argv: "list[str]") -> dict:
    """One scan of ``argv`` in a fresh process rooted at ``tree``."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    out = subprocess.run(
        [sys.executable, "-c", _CHILD, json.dumps(argv)],
        cwd=tree, env=env, capture_output=True, text=True, check=True,
    ).stdout
    return json.loads(out.splitlines()[-1])


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(prog="ab_scan", description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="a checkout of the repo (repeat; two or more)")
    ap.add_argument("--rounds", type=int, default=2,
                    help="timed rounds; each runs every tree once")
    ap.add_argument("scan", nargs=argparse.REMAINDER,
                    help="after --: the analyzer CLI's arguments")
    args = ap.parse_args(argv)
    scan = args.scan[1:] if args.scan[:1] == ["--"] else args.scan
    rates: "dict[str, list[float]]" = {tree: [] for tree in args.tree}
    reports = set()
    for tree in args.tree:
        reports.add(run_once(tree, scan)["report"])
    for r in range(args.rounds):
        for tree in (args.tree if r % 2 == 0 else args.tree[::-1]):
            got = run_once(tree, scan)
            reports.add(got["report"])
            rate = got["records"] / got["wall"]
            rates[tree].append(rate)
            print(f"round {r} {tree}: {got['records']} records in "
                  f"{got['wall']:.6f} s = {rate:.1f} records/s, "
                  f"{got['dispatches']} dispatches")
    print(json.dumps({
        "rates": rates,
        "median": {t: statistics.median(v) for t, v in rates.items()},
        "quartiles": {t: statistics.quantiles(v, n=4) if len(v) > 1 else v
                      for t, v in rates.items()},
        "reports_equal": len(reports) == 1,
    }))
    return 0 if len(reports) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
