"""Shared fixtures of the harness's CPU tests: a manifest of the real cells
cut to a tiny topic, beside copies of their files."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def tiny_manifest(dst: Path) -> Path:
    """The benchmark's manifest with every configuration cut to a topic
    the host folds in a second, 2^22 alive slots, batches of 4,096, and a
    follow cell beside its cells."""
    (dst / "benchmark").mkdir(parents=True, exist_ok=True)
    shutil.copytree(ROOT / "benchmark" / "workloads", dst / "benchmark" / "workloads")
    (dst / "benchmark" / "configs").mkdir()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for entry in bench["configs"]:
        config = json.loads((ROOT / entry["file"]).read_text())
        t = config["topic"]
        keyed = t["key_bytes"] is not None
        t.update(partitions=3 if keyed else 4, records_per_batch=200 if keyed else 100,
                 templates_per_partition=10 if keyed else 4,
                 records_per_partition=4000 if keyed else 2000)
        argv = [a for a in config["argv"]]
        i = argv.index("--ingest-workers")
        argv[i + 1] = "2"
        argv += ["--batch-size", "4096"]
        if keyed:
            t["slot_bits"] = 22
            argv += ["--alive-bitmap-bits", "22"]
        config["argv"] = argv
        (dst / entry["file"]).write_text(json.dumps(config))
    add_follow_cell(bench, dst)
    path = dst / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


#: A cell of the ``follow`` traffic, which no cell of the manifest runs yet
#: (its rate waits for a sweep on the card): the tests keep the driver and
#: its readers whole for the cell that will.
FOLLOW_CELL = {"name": "demo-compacted.follow", "config": "xenji-demo-compacted",
               "traffic": "follow", "chips": 1, "why": "the follow driver at a tiny size"}
FOLLOW_PARAMS = {"rate": 20000, "settle_s": 20,
                 "limits": {"counters_mismatch": 0, "extremes_mismatch": 0, "alive_keys_gap": 0,
                            "hll_rel_gap": 1e-10, "quantile_rel_gap": 1e-9}}
FOLLOW_METRICS = {
    "end_to_end": [
        {"name": "staleness_p50_s", "unit": "s", "better": "lower", "bound": 0.25,
         "source": "host_clock", "workloads": [FOLLOW_CELL["name"]]},
        {"name": "staleness_p95_s", "unit": "s", "better": "lower", "bound": 0.25,
         "source": "host_clock", "workloads": [FOLLOW_CELL["name"]]},
    ],
    "per_layer": [
        {"name": "finalize_s.follow", "unit": "s", "better": "lower", "source": "program_counter",
         "layer": "finalize", "moves": "staleness_p95_s", "workloads": [FOLLOW_CELL["name"]]},
        {"name": "delivery_ms_p95.follow", "unit": "ms", "better": "lower",
         "source": "host_clock", "layer": "service", "moves": "staleness_p95_s",
         "workloads": [FOLLOW_CELL["name"]]},
        {"name": "device_idle_share.follow", "unit": "share", "better": "lower",
         "source": "device_trace", "layer": "device", "moves": "staleness_p95_s",
         "workloads": [FOLLOW_CELL["name"]]},
    ],
}


def add_follow_cell(bench: dict, dst: Path) -> None:
    bench["workloads"].append(FOLLOW_CELL)
    for group, entries in FOLLOW_METRICS.items():
        bench[group].extend(entries)
    path = dst / "benchmark" / "workloads" / f"{FOLLOW_CELL['name']}.json"
    path.write_text(json.dumps(FOLLOW_PARAMS))


@pytest.fixture(scope="session")
def manifest(tmp_path_factory) -> Path:
    return tiny_manifest(tmp_path_factory.mktemp("bench"))
