"""The fleet cell's readers on a small recorded fixture, and on a run in
which they find nothing: the parent of the program that books the fleet's
spans, counters and resident high-water mark, or an untraced window."""

from __future__ import annotations

import pytest

from benchmark.run import load_reader

CONFIG = {"topic": {"partitions": 1}}
#: Two fleet audits of three topics each.
COUNTERS = {
    "kta_backend_finalize_seconds:sum": 3.0,
    "kta_backend_finalize_seconds:count": 6.0,
    "kta_fleet_admission_wait_seconds_total": 4.5,
    "kta_fleet_pass_seconds_total": 9.0,
}
AUDITS = [(100.0, 110.0), (110.0, 118.0)]
PASSES = [(100.5, 103.0, "a"), (100.5, 104.0, "b"), (103.0, 109.0, "c"),
          (110.5, 112.0, "a"), (110.5, 113.0, "b"), (112.0, 117.0, "c")]
DEVICE = {"busy_s": 1.8, "window_s": 18.0, "ops": {"Memcpy DtoH (Device -> Pageable)": (1.8, 6)},
          "stage_device_s": {}, "idle_gaps": {}}
LAYER = {"counters": COUNTERS, "gauges": {"kta_device_resident_bytes_max": 1_611_461_000.0},
         "walls": [10.0, 8.0], "audits": AUDITS, "passes": PASSES, "records": 36_000_000,
         "window_s": 18.0, "device": DEVICE}
EXPECTED = {
    "audit_records_per_s.fleet": 2_000_000.0,
    "device_idle_share.fleet": 0.9,
    "device_resident_bytes.fleet": 1_611_461_000.0,
    "finalize_s.fleet": 0.5,
    "fleet_admission_wait_share.fleet": 0.5,
    # (110 - 104) + (118 - 113) over 18 s of audits.
    "fleet_tail_share.fleet": 11.0 / 18.0,
}
#: What a program without the fleet's instruments leaves the readers.
PARENT = {"counters": {k: v for k, v in COUNTERS.items() if "fleet" not in k},
          "gauges": {"kta_device_resident_bytes_total{owner=alive}": 3.0},
          "audits": AUDITS, "passes": [], "records": 0, "window_s": 0.0, "device": None}
EMPTY = {"counters": {}, "gauges": {}, "audits": [], "passes": [], "records": 0,
         "window_s": 0.0, "device": None}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_fixture(name):
    assert load_reader(name)(LAYER, CONFIG) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(set(EXPECTED) - {"finalize_s.fleet"}))
@pytest.mark.parametrize("layer", [PARENT, EMPTY], ids=["parent", "empty"])
def test_reader_finds_nothing(name, layer):
    assert load_reader(name)(layer, CONFIG) is None


def test_finalize_finds_nothing_in_an_empty_window():
    assert load_reader("finalize_s.fleet")(EMPTY, CONFIG) is None
