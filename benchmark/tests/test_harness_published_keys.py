"""The published-keys cell (``demo-published-keys.audit``): its entries in
``BENCHMARK.json``, its seven readers on a small recorded fixture and on
runs in which they find nothing, the bytes ``bitmap_pairs`` needs, and a
whole run of the cell on the host at a tiny size."""

from __future__ import annotations

import json
import math
from pathlib import Path

import pytest

from benchmark import run
from benchmark.roofline import H100_HBM_BYTES_PER_S
from benchmark.roofline_dense import bitmap_pairs_bytes
from benchmark.run import load_reader

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "demo-published-keys.audit"
READERS = ["alive_switch_s.dense", "alive_grow_s.dense", "bitmap_pairs_roofline.dense",
           "finalize_s.dense", "device_resident_bytes.dense", "audit_records_per_s.dense",
           "device_idle_share.dense"]

CONFIG = {"topic": {"partitions": 10}, "argv": ["-c", "--distinct-keys-per-partition"]}
#: The dense bitmap's bytes and the sketches' (HLL and DDSketch, P = 10).
RESIDENT = {"alive": 1 << 29, "hll": 2_621_440, "quantiles": 204_960, "metrics": 896}
#: Three audits' counters.
COUNTERS = {
    "kta_backend_finalize_seconds:sum": 1.5,
    "kta_backend_finalize_seconds:count": 3.0,
    "kta_alive_grow_seconds_total": 0.06,
    "kta_alive_switch_seconds_total": 0.9,
    # 40 launches of bitmap_pairs at 262,144 pairs each.
    "kta_alive_dense_pairs_total": 40.0 * 262_144,
    **{f"kta_device_resident_bytes_total{{owner={k}}}": 3.0 * v for k, v in RESIDENT.items()},
}
DEVICE = {
    "busy_s": 0.5, "window_s": 10.0,
    "stage_device_s": {"dispatch": 0.4, "finalize": 0.1},
    "ops": {"(anonymous namespace)::bitmap_pairs_kernel(...)": (40 * 1e-5, 40),
            "Memcpy DtoH (Device -> Pageable)": (0.1, 3)},
    "idle_gaps": {"ingest": 9.5},
}
LAYER = {"counters": COUNTERS, "walls": [5.0, 5.0], "records": 96_000_000, "window_s": 10.0,
         "device": DEVICE}
EXPECTED = {
    "audit_records_per_s.dense": 9_600_000.0,
    "device_idle_share.dense": 0.95,
    "device_resident_bytes.dense": sum(RESIDENT.values()),
    "finalize_s.dense": 0.5,
    "alive_grow_s.dense": 0.02,
    "alive_switch_s.dense": 0.3,
    # 17,957,548.5 B a launch at 3.35 TB/s over 10 us a launch: 53.6%.
    "bitmap_pairs_roofline.dense": 100 * (bitmap_pairs_bytes(262_144, 32) / H100_HBM_BYTES_PER_S) / 1e-5,
}
EMPTY = {"counters": {}, "walls": [], "device": None}


def test_the_manifest_has_the_configuration_and_the_cell():
    """Only records a partition are cut from the demo's topic, every
    record keeps a key of its own, the cell runs on one chip under the
    demo audit's limits, and its seven metrics are read in it alone."""
    conf = next(c for c in BENCH["configs"] if c["name"] == "xenji-demo-published-keys")
    demo = json.loads((ROOT / "benchmark/configs/xenji-demo-compacted.json").read_text())
    config = json.loads((ROOT / conf["file"]).read_text())
    assert conf["reduced"] == ["records_per_partition"] == list(config["reduced"])
    assert config["source"] == demo["source"] and config["published"] == demo["published"]
    assert config["argv"] == demo["argv"]
    t = config["topic"]
    assert t["records_per_partition"] == 3_200_000
    # Every record a distinct key, as published: no template repeats.
    assert t["templates_per_partition"] * t["records_per_batch"] == t["records_per_partition"]
    same = ("partitions", "records_per_batch", "key_bytes", "tombstone_share", "value_bytes",
            "brokers")
    assert {k: t[k] for k in same} == {k: demo["topic"][k] for k in same}
    cell = next(w for w in BENCH["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (conf["name"], "audit", 1)
    params = json.loads((ROOT / f"benchmark/workloads/{CELL}.json").read_text())
    demo_params = json.loads((ROOT / "benchmark/workloads/demo-compacted.audit.json").read_text())
    assert params == demo_params
    reading = [m for m in BENCH["per_layer"] if CELL in m["workloads"]]
    assert sorted(m["name"] for m in reading) == sorted(READERS)
    for m in reading:
        assert m["workloads"] == [CELL] and m["moves"] == "device_memory_peak_bytes"


@pytest.mark.parametrize("name", READERS)
def test_reader_on_fixture(name):
    assert load_reader(name)(LAYER, CONFIG) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing(name):
    assert load_reader(name)(EMPTY, CONFIG) is None


@pytest.mark.parametrize("name", ["alive_grow_s.dense", "alive_switch_s.dense",
                                  "bitmap_pairs_roofline.dense"])
def test_reader_finds_nothing_without_the_dense_counters(name):
    """A program that books neither the grows' and the switch's seconds
    nor the dense pairs (the cell's parent) leaves those metrics out."""
    counters = {k: v for k, v in COUNTERS.items() if not k.startswith("kta_alive_")}
    assert load_reader(name)(dict(LAYER, counters=counters), CONFIG) is None


def test_the_roofline_reads_nothing_without_a_launch():
    ops = {k: v for k, v in DEVICE["ops"].items() if "bitmap" not in k}
    layer = dict(LAYER, device=dict(DEVICE, ops=ops))
    assert load_reader("bitmap_pairs_roofline.dense")(layer, CONFIG) is None


def test_the_roofline_reads_the_bitmap_size_from_the_arguments():
    small = dict(CONFIG, argv=CONFIG["argv"] + ["--alive-bitmap-bits", "24"])
    least = bitmap_pairs_bytes(262_144, 24) / H100_HBM_BYTES_PER_S
    assert load_reader("bitmap_pairs_roofline.dense")(LAYER, small) == pytest.approx(
        100 * least / 1e-5)


def test_bitmap_pairs_bytes_on_hand_worked_cases():
    # 2^9 slots are two 32-byte sectors; two pairs miss a given sector with
    # chance (1/2)^2, so they touch 2 * 3/4 = 1.5 sectors on average:
    # 2 * 5 B + 4 B + 1.5 * 2 * 32 B.
    assert bitmap_pairs_bytes(2, 9) == pytest.approx(110.0)
    # No pair: the count alone.  One pair: one sector read and written.
    assert bitmap_pairs_bytes(0, 32) == 4.0
    assert bitmap_pairs_bytes(1, 32) == pytest.approx(5 + 4 + 64)
    # A row of 262,144 pairs at 2^32 slots touches 1 - e^(-1/64) of the
    # 2^24 sectors: 260,107 of them, ~17.96 MB in all.
    touched = (1 << 24) * -math.expm1(-262_144 / (1 << 24))
    assert round(touched) == 260_107
    assert bitmap_pairs_bytes(262_144, 32) == pytest.approx(5 * 262_144 + 4 + 64 * touched)


def test_the_cell_runs_correct_on_the_host(manifest, capsys):
    """A whole traced run of the cell at the fixture's tiny size (2^22
    slots: the dense bitmap from the start), held to the reference."""
    rc = run.main(["--workload", CELL, "--seed", str(2**31 + 77), "--seconds", "2",
                   "--trace", "1"], manifest=manifest, cpu=True)
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    result = json.loads(out.out.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    # The host has no device timeline: the trace's readers find nothing.
    assert {"audit_records_per_s.dense", "finalize_s.dense", "device_resident_bytes.dense",
            "alive_grow_s.dense", "alive_switch_s.dense"} <= set(result["metrics"])
    assert "bitmap_pairs_roofline.dense" not in result["metrics"]
    assert result["metrics"]["device_resident_bytes.dense"]["value"] >= (1 << 22) // 8
