"""Each per-layer reader on a small recorded fixture, and on a run in
which it finds nothing to read."""

from __future__ import annotations

import pytest

from benchmark import probes
from benchmark.roofline import H100_HBM_BYTES_PER_S, counters_merge_bytes
from benchmark.run import load_reader

CONFIG = {"topic": {"partitions": 10}}
COUNTERS = {
    "kta_ingest_worker_active_seconds_total{worker=w0}": 10.0,
    "kta_ingest_worker_stall_seconds_total{worker=w0}": 2.0,
    "kta_ingest_worker_active_seconds_total{worker=w1}": 10.0,
    "kta_ingest_worker_stall_seconds_total{worker=w1}": 4.0,
    "kta_stage_seconds_total{stage=dispatch}": 3.0,
    "kta_backend_finalize_seconds:sum": 1.5,
    "kta_backend_finalize_seconds:count": 3.0,
    "kta_dispatch_seconds:count": 40.0,
}
DEVICE = {
    "busy_s": 0.5, "window_s": 10.0,
    # Finalize's copy is left out of the fold's device time.
    "stage_device_s": {"dispatch": 0.4, "ingest": 0.2, "finalize": 5.0, "between-scans": 0.1},
    "ops": {"(anonymous namespace)::counters_merge_kernel(...)": (40 * 2.5e-6, 40),
            "Memcpy HtoD (Pinned -> Device)": (0.5, 80)},
    "idle_gaps": {"ingest": 9.5},
}
LAYER = {"counters": COUNTERS, "walls": [5.0, 5.0], "records": 32_000_000, "window_s": 10.0,
         "device": DEVICE,
         "frames": [(100.0 + i, {"report_ts": 100.0 + i - 0.001 * (i + 1)}) for i in range(20)]}
EXPECTED = {
    "audit_records_per_s.scan": 3_200_000.0,
    "ingest_busy_share.scan": (0.8 + 0.6) / 2,
    "dispatch_share.scan": 0.3,
    "finalize_s.scan": 0.5,
    "finalize_s.follow": 0.5,
    "delivery_ms_p95.follow": 19.0,
    "device_idle_share.scan": 0.95,
    "device_idle_share.follow": 0.95,
    "fold_device_ms.scan": 15.0,
    "counters_merge_roofline.scan": 100 * (counters_merge_bytes(10) / H100_HBM_BYTES_PER_S) / 2.5e-6,
}
EMPTY = {"counters": {}, "walls": [], "device": None, "frames": []}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_fixture(name):
    assert load_reader(name)(LAYER, CONFIG) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_finds_nothing(name):
    assert load_reader(name)(EMPTY, CONFIG) is None


def test_roofline_bytes_match_the_kernels_own_count():
    # csrc/counters_merge.cu: 3 * 56 * P bytes, 2.7 KB at P = 16, plus the sums.
    assert counters_merge_bytes(16) == 2720


def test_device_summary_clips_unions_and_names_gaps():
    tr = probes.DeviceTrace(False, "", False)
    tr.device = [(1.0, 2.0, "k"), (1.5, 2.5, "k"), (4.0, 5.0, "copy"), (9.0, 12.0, "k")]
    tr.stages = [(0.0, 3.0, "dispatch"), (3.0, 8.0, "finalize")]
    s = tr.summary(0.5, 10.0)
    assert s["busy_s"] == pytest.approx(1.5 + 1.0 + 1.0)
    assert s["ops"]["k"] == (pytest.approx(1.0 + 1.0 + 1.0), 3)
    assert s["idle_gaps"] == {"dispatch": pytest.approx(0.5),
                              "finalize": pytest.approx(1.5 + 4.0)}
    # Each activity goes to the stage covering its midpoint: (9, 12) is
    # clipped to (9, 10), outside every span.
    assert s["stage_device_s"] == {"dispatch": pytest.approx(2.0),
                                   "finalize": pytest.approx(1.0),
                                   "between-scans": pytest.approx(1.0)}


def test_nearest_rank():
    assert probes.nearest_rank([3, 1, 2, 4], 0.5) == 2
    assert probes.nearest_rank(list(range(1, 101)), 0.95) == 95
