"""Whole runs of the fleet cell (``tpcc-cdc-w8.fleet``: the TPC-C
change-data-capture topics, cut by the manifest fixture to three
partitions a topic and about a hundredth of the records) on the host:
correct as the program stands, incorrect with the timed path broken
underneath, and the 32-bit reference of its topics rejected."""

from __future__ import annotations

import json

import numpy as np
import pytest

from benchmark.gen.tpcc_cdc import TpccCdc
from benchmark.reference.compare import compare, verdict, worst
from benchmark.reference.report import reference_report
from test_harness_run import _altered, _half, one_run

CELL = "tpcc-cdc-w8.fleet"
FLEET_READERS = {"audit_records_per_s.fleet", "device_resident_bytes.fleet", "finalize_s.fleet",
                 "fleet_admission_wait_share.fleet", "fleet_tail_share.fleet"}


def test_fleet_cell_is_correct(manifest, capsys):
    result = one_run(manifest, CELL, capsys)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "device_memory_peak_bytes"}
    assert result["checks"]["documents_missing"]["value"] == 0


def test_fleet_traced_run_reads_the_fleet(manifest, capsys):
    result = one_run(manifest, CELL, capsys, trace=1)
    assert result["correct"]
    # The host has no device timeline: the idle share finds nothing.
    assert set(result["metrics"]) == FLEET_READERS
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert m["device_resident_bytes.fleet"] > 0
    assert 0 < m["fleet_tail_share.fleet"] < 1


@pytest.mark.parametrize("fault", [_half, _altered], ids=["half-the-batches", "answer-altered"])
def test_broken_fleet_is_incorrect(manifest, fault, monkeypatch, capsys):
    fault(monkeypatch)
    result = one_run(manifest, CELL, capsys)
    assert not result["correct"], result["checks"]


def test_32bit_reference_of_the_topics_is_rejected(manifest):
    bench = json.loads(manifest.read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((manifest.parent / entry["file"]).read_text())
    limits = json.loads((manifest.parent / "benchmark" / "workloads" / f"{CELL}.json").read_text())
    db = TpccCdc(config, 11)
    readings = [compare(reference_report(t, t.heads, config["argv"], lowp=True),
                        reference_report(t, t.heads, config["argv"])) for t in db.topics]
    numbers = worst(readings)
    assert not verdict(numbers, limits["limits"])
    assert numbers["extremes_mismatch"] > 0 and numbers["hll_rel_gap"] > 1e-10
    assert all(np.all(t.heads > 0) for t in db.topics)
