"""The readers of what the program measures inside its layers (worker and
drive-loop CPU, fetch-round waits, finalize's phases, device-resident
bytes, each fold's device span), on a small recorded fixture and on a run
in which they find nothing: the parent of the program that books these
counters, or an untraced window."""

from __future__ import annotations

import pytest

from benchmark.run import load_reader

CONFIG = {"topic": {"partitions": 10}}
#: A window of three audits: two ingest workers, 40 dispatches.
COUNTERS = {
    "kta_ingest_worker_active_seconds_total{worker=0}": 10.0,
    "kta_ingest_worker_active_seconds_total{worker=1}": 6.0,
    "kta_ingest_worker_cpu_seconds_total{worker=0}": 5.0,
    "kta_ingest_worker_cpu_seconds_total{worker=1}": 3.0,
    "kta_ingest_round_wait_seconds_total": 4.0,
    "kta_stage_seconds_total{stage=dispatch}": 3.0,
    "kta_stage_cpu_seconds_total{stage=dispatch}": 0.75,
    "kta_stage_cpu_seconds_total{stage=ingest}": 0.5,
    "kta_backend_finalize_seconds:sum": 1.5,
    "kta_backend_finalize_seconds:count": 3.0,
    "kta_finalize_phase_seconds_total{phase=drain}": 0.03,
    "kta_finalize_phase_seconds_total{phase=copy}": 0.9,
    "kta_finalize_phase_seconds_total{phase=derive}": 0.45,
    "kta_device_resident_bytes_total{owner=alive}": 3 * 536_870_912.0,
    "kta_device_resident_bytes_total{owner=metrics}": 3 * 896.0,
    "kta_device_resident_bytes_total{owner=scratch}": 3 * 536_870_912.0,
    "kta_dispatch_seconds:count": 40.0,
    "kta_fold_device_seconds_total": 0.016,
}
LAYER = {"counters": COUNTERS, "walls": [5.0, 5.0, 5.0], "records": 48_000_000,
         "window_s": 15.0, "device": None}
EXPECTED = {
    "ingest_cpu_share.scan": 8.0 / 16.0,
    "ingest_round_wait_share.scan": 4.0 / 16.0,
    "dispatch_cpu_share.scan": 0.25,
    "finalize_copy_s.scan": 0.3,
    "finalize_derive_s.scan": 0.15,
    "device_resident_bytes.scan": 2 * 536_870_912 + 896,
    "fold_span_device_ms.scan": 0.4,
}
#: The counters a program without these instruments books in the window.
PARENT = {k: v for k, v in COUNTERS.items()
          if k.startswith(("kta_ingest_worker_active", "kta_stage_seconds",
                           "kta_backend_finalize", "kta_dispatch_seconds"))}
EMPTY = {"counters": {}, "walls": [], "device": None}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_fixture(name):
    assert load_reader(name)(LAYER, CONFIG) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
@pytest.mark.parametrize("counters", [PARENT, {}], ids=["parent", "empty"])
def test_reader_finds_nothing(name, counters):
    assert load_reader(name)(dict(EMPTY, counters=counters), CONFIG) is None


def test_finalize_phases_fit_in_finalize():
    """The fixture's copy and derive lie inside finalize, as the program's
    phases lie inside its finalize histogram."""
    phases = sum(load_reader(n)(LAYER, CONFIG)
                 for n in ("finalize_copy_s.scan", "finalize_derive_s.scan"))
    assert phases <= load_reader("finalize_s.scan")(LAYER, CONFIG)
