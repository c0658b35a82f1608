"""Run every BASELINE benchmark config and the end-to-end pipeline, and emit
one JSON report (port of the reference's ``tools/bench_all.py``).

Usage:
    python -m kafka_topic_analyzer_tpu_torch.tools.bench_all [--batch-size N]
        [--steps N] [--configs 1,2,3,4,5] [--device cuda|cpu] [--out report.json]

Each config runs through ``tools/bench.py --accuracy`` in a subprocess
(fresh process, honest per-config timing), then ``tools/bench_e2e.py
--backend gpu --quiet``; every child gets ``--device``.  The report maps
each config id and ``e2e`` to the child's last stdout line (its JSON
result), or to ``{"error": ...}`` (the end of its stderr) when the child
failed.  There is no accelerator probe: a child without its card fails,
and says so in its error.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

#: Seconds the end-to-end child may run.
E2E_TIMEOUT_S = 900.0


def _last_json(proc) -> dict:
    """The child's result: its last stdout line, or its error."""
    if proc.returncode != 0:
        return {"error": proc.stderr.strip()[-500:]}
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch-size", type=int, default=None,
                    help="records per device step (default: the bench's "
                         "2^20)")
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--out", default="-")
    ap.add_argument("--configs", default="1,2,3,4,5")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="passed to every child (cuda fails without a card)")
    args = ap.parse_args(argv)

    repo = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    report = {}
    for cfg in [int(c) for c in args.configs.split(",") if c]:
        cmd = [
            sys.executable, "-m", "kafka_topic_analyzer_tpu_torch.tools.bench",
            "--config", str(cfg),
            "--batches", str(args.batches),
            "--steps", str(args.steps),
            "--accuracy",  # the BASELINE metric includes sketch error
            "--device", args.device,
        ]
        if args.batch_size:
            cmd += ["--batch-size", str(args.batch_size)]
        print(f"bench_all: running config {cfg}...", file=sys.stderr)
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=repo)
        report[str(cfg)] = _last_json(proc)
        print(f"bench_all: config {cfg}: {json.dumps(report[str(cfg)])}",
              file=sys.stderr)

    # The end-to-end pipeline (broker → wire client → decode → pack →
    # device) beside the device-path numbers: the like-for-like comparison
    # with the reference's published 590,221 msgs/s.
    cmd = [
        sys.executable, "-m", "kafka_topic_analyzer_tpu_torch.tools.bench_e2e",
        "--backend", "gpu", "--quiet", "--device", args.device,
    ]
    print("bench_all: running e2e pipeline...", file=sys.stderr)
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=repo,
                              timeout=E2E_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        report["e2e"] = {"error": f"timed out after {E2E_TIMEOUT_S:.0f} s"}
    else:
        report["e2e"] = _last_json(proc)
    print(f"bench_all: e2e: {json.dumps(report['e2e'])}", file=sys.stderr)

    if args.out == "-":
        print(json.dumps(report))  # one line: the last line is the result
    else:
        with open(args.out, "w") as f:
            f.write(json.dumps(report, indent=2) + "\n")
        print(f"bench_all: wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
