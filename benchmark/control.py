#!/usr/bin/env python3
"""The controls of a cell's correctness check: what its comparison reads
when the answer is computed a step below the precision the configuration
states. The benchmark's own runs never run them.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--program]

- The reference in 32-bit numbers (``reference_report(lowp=True)``), in the
  program's place: every number the cell compares, against the 64-bit
  reference, at the cell's own size (the audit's whole topic; for a follow
  cell the backlog and ``--steps`` more windows a partition).
- ``--program`` (cells with ``-c``): the program's own lower-precision
  path, one audit on the card with ``--alive-bitmap-bits 31``, a bitmap of
  half the slots, held against the reference of the 2^32-slot report.

One JSON line per seed and control, each with the numbers and the cell's
limits; ``rejected`` says whether the check turns the control down.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.gen.topic import Topic  # noqa: E402
from benchmark.reference.compare import compare, verdict  # noqa: E402
from benchmark.reference.report import reference_report  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def cell_files(name: str, manifest: Path) -> "tuple[dict, dict, dict]":
    bench = json.loads(manifest.read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((manifest.parent / entry["file"]).read_text())
    params = json.loads(
        (manifest.parent / "benchmark" / "workloads" / f"{name}.json").read_text())
    return cell, config, params


def lowp_reading(config: dict, seed: int, extra_windows: int = 0) -> dict:
    topic = Topic(config, seed, name="bench-" + config["name"])
    heads = [topic.windows + extra_windows] * topic.P
    ref = reference_report(topic, heads, config["argv"])
    got = reference_report(topic, heads, config["argv"], lowp=True)
    return compare(got, ref)


def program_reading(config: dict, seed: int, device: "list[str]") -> dict:
    from benchmark.gen.broker import BrokerProcess
    from benchmark.traffic.audit import audit

    name = "bench-" + config["name"]
    topic = Topic(config, seed, name=name)
    with BrokerProcess(config, seed, name, topic.windows) as broker:
        broker.wait_ready()
        rc, doc = audit(["-t", name, "-b", broker.bootstrap, "--json", "--quiet",
                         *config["argv"], "--alive-bitmap-bits", "31", *device])
    if rc != 0 or doc is None:
        raise RuntimeError(f"the control audit failed (exit {rc})")
    return compare(doc, reference_report(topic, [topic.windows] * topic.P, config["argv"]))


def main(argv=None, *, manifest: "Path | None" = None, cpu: bool = False) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--steps", type=int, default=0,
                    help="windows a partition past the backlog (follow cells)")
    ap.add_argument("--program", action="store_true",
                    help="also run the program's --alive-bitmap-bits 31 path")
    args = ap.parse_args(argv)
    cell, config, params = cell_files(args.workload, manifest or ROOT / "BENCHMARK.json")
    limits = params["limits"]
    for seed in [int(s) for s in args.seeds.split(",")]:
        runs = [("32-bit-reference", lowp_reading(config, seed, args.steps))]
        if args.program and "-c" in config["argv"]:
            runs.append(("alive-bitmap-bits-31",
                         program_reading(config, seed, ["--device", "cpu"] if cpu else [])))
        for control, numbers in runs:
            print(json.dumps({"workload": cell["name"], "seed": seed, "control": control,
                              "numbers": numbers, "limits": limits,
                              "rejected": not verdict(numbers, limits)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
