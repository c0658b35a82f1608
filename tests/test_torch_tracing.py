"""What the port measures inside its layers, on the CPU: the ingest
workers' CPU and fetch-round waits, the drive loop's CPU per stage,
finalize's phases, the device-resident bytes and each fold's device span,
and the span tracer's one clock, span ids and scan context, alone and
merged into the ``torch.profiler`` trace.

Scans run against the loopback `fake_broker` cluster (three nodes, so a
worker's fetch rounds go through the fetch pool) or the synthetic
source, through the CLI in this process.
"""

import bisect
import contextlib
import dataclasses
import io
import json
import pathlib

import pytest

from fake_broker import FakeCluster
from kafka_topic_analyzer_tpu_torch import cli
from kafka_topic_analyzer_tpu_torch.backends.base import READY, DispatchQueue
from kafka_topic_analyzer_tpu_torch.backends.gpu import TorchBackend
from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig
from kafka_topic_analyzer_tpu_torch.engine import run_scan
from kafka_topic_analyzer_tpu_torch.io.synthetic import SyntheticSource, SyntheticSpec
from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics
from kafka_topic_analyzer_tpu_torch.obs import trace
from kafka_topic_analyzer_tpu_torch.obs.registry import default_registry
from kafka_topic_analyzer_tpu_torch.parallel.sharded import ShardedTorchBackend
from kafka_topic_analyzer_tpu_torch.utils.profiling import (
    CLOCK_MARKER,
    TRACE_FILE,
    ScanProfile,
)

TOPIC = "tracing.t"
PARTITIONS = 6
#: Span categories the program records (the flight recorder's counter
#: samples are ``ph: "C"`` and carry no span context).
SPAN_CATS = ("stage", "io", "ingest", "finalize")
#: Spans recorded on an ingest worker's own thread or for it on a fetch
#: pool thread.
WORKER_SPANS = {"worker", "round-wait", "fetch", "pack", "send", "put-stall", "slot-wait"}


@pytest.fixture(autouse=True)
def _reset():
    default_registry().reset()
    trace.set_active(None)
    yield
    trace.set_active(None)
    default_registry().reset()


def rows(partition: int, n: int):
    return [(i, 1_600_000_000_000 + i * 1000 + partition,
             f"k{partition}-{i % 53}".encode() if i % 9 else None,
             bytes(20 + (i * 7 + partition) % 61) if i % 5 else None) for i in range(n)]


def samples(snap: dict, name: str) -> dict:
    """Label values (joined) → value of one family in a snapshot."""
    out = {}
    for s in snap.get(name, {}).get("samples", []):
        key = ",".join(str(v) for _, v in sorted(s["labels"].items()))
        out[key] = s.get("value", s.get("sum"))
    return out


def kafka_scan(tmp_path, *flags) -> "tuple[dict, list[dict]]":
    """A two-worker ``-c`` audit of the cluster's topic with a span tracer:
    the registry's snapshot and the trace's events."""
    path = tmp_path / "host.json"
    with FakeCluster(TOPIC, {p: rows(p, 1500) for p in range(PARTITIONS)},
                     n_nodes=3, max_records_per_fetch=200) as cluster:
        with contextlib.redirect_stdout(io.StringIO()):
            assert cli.main(["-t", TOPIC, "-b", cluster.bootstrap, "--device", "cpu",
                             "-c", "--alive-bitmap-bits", "20", "--batch-size", "1024",
                             "--ingest-workers", "2", "--quiet",
                             "--trace-json", str(path), *flags]) == 0
    return default_registry().snapshot(), json.loads(path.read_text())["traceEvents"]


# ---------------------------------------------------------------------------
# counters of one scan


def test_worker_stage_and_finalize_seconds_bound_each_other(tmp_path):
    snap, _ = kafka_scan(tmp_path)
    active = samples(snap, "kta_ingest_worker_active_seconds_total")
    cpu = samples(snap, "kta_ingest_worker_cpu_seconds_total")
    assert sorted(active) == sorted(cpu) == ["0", "1"]
    for worker, secs in active.items():
        assert 0 <= cpu[worker] <= secs
    assert sum(cpu.values()) > 0
    wait = samples(snap, "kta_ingest_round_wait_seconds_total")[""]
    assert 0 < wait <= sum(active.values())
    wall = samples(snap, "kta_stage_seconds_total")
    stage_cpu = samples(snap, "kta_stage_cpu_seconds_total")
    assert set(stage_cpu) == set(wall) >= {"ingest", "dispatch", "finalize"}
    for stage, secs in wall.items():
        assert 0 <= stage_cpu[stage] <= secs
    phases = samples(snap, "kta_finalize_phase_seconds_total")
    assert set(phases) == {"drain", "copy", "derive"}
    finalize = snap["kta_backend_finalize_seconds"]["samples"][0]
    assert finalize["count"] == 1
    assert 0 < sum(phases.values()) <= finalize["sum"]
    # On the CPU a fold's token is ready when it returns: no device span.
    assert samples(snap, "kta_fold_device_seconds_total") == {"": 0.0}


# ---------------------------------------------------------------------------
# spans of one scan


def test_spans_carry_scan_worker_and_enclosing_span(tmp_path):
    _, events = kafka_scan(tmp_path)
    spans = [e for e in events if e["ph"] == "X"]
    assert {e["cat"] for e in spans} <= set(SPAN_CATS)
    by_id = {e["args"]["id"]: e for e in spans}
    assert len(by_id) == len(spans)
    assert {e["args"]["scan"] for e in spans} == {spans[0]["args"]["scan"]}
    names = {e["name"] for e in spans}
    assert {"worker", "round-wait", "fetch", "pack", "send", "ingest", "dispatch",
            "finalize", "drain", "copy", "derive"} <= names
    for e in spans:
        if e["name"] in WORKER_SPANS:
            assert e["args"]["worker"] in ("0", "1")
        else:
            assert "worker" not in e["args"]
        parent = e["args"]["parent"]
        if parent is None:
            continue
        outer = by_id[parent]
        assert outer["tid"] == e["tid"]
        assert outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]
    # Each worker's spans nest in its ``worker`` span; the pool threads'
    # fetches carry the worker they fetch for.
    workers = {e["args"]["id"]: e for e in spans if e["name"] == "worker"}
    assert sorted(e["args"]["worker"] for e in workers.values()) == ["0", "1"]
    for e in spans:
        if e["name"] in ("round-wait", "put-stall"):
            assert workers[e["args"]["parent"]]["args"]["worker"] == e["args"]["worker"]
    fetch_tids = {e["tid"] for e in spans if e["name"] == "fetch"}
    assert not fetch_tids & {e["tid"] for e in workers.values()}
    for name in ("drain", "copy", "derive"):
        (phase,) = [e for e in spans if e["name"] == name]
        assert by_id[phase["args"]["parent"]]["name"] == "finalize"


def test_scans_are_numbered_and_the_prefetch_thread_carries_the_number():
    tracer = trace.SpanTracer()
    trace.set_active(tracer)
    spec = SyntheticSpec(num_partitions=2, messages_per_partition=3000,
                         keys_per_partition=50, seed=3)
    config = AnalyzerConfig(num_partitions=2, batch_size=1024, count_alive_keys=True,
                            alive_bitmap_bits=16)
    for _ in range(2):
        run_scan("t", SyntheticSource(spec), TorchBackend(config, device="cpu"), 1024)
    spans = [e for e in tracer.events() if e["ph"] == "X"]
    scans = sorted({e["args"]["scan"] for e in spans})
    assert len(scans) == 2 and scans[1] == scans[0] + 1
    main = {e["tid"] for e in spans if e["cat"] == "stage"}
    sends = [e for e in spans if e["name"] == "send"]
    assert sends and not {e["tid"] for e in sends} & main
    for scan in scans:
        assert any(e["args"]["scan"] == scan for e in sends)


# ---------------------------------------------------------------------------
# one clock


class FakeClock:
    """Readings 100.0, 100.5, 101.0, ...: every stamp names its reading."""

    def __init__(self):
        self.readings = []

    def __call__(self) -> float:
        t = 100.0 + 0.5 * len(self.readings)
        self.readings.append(t)
        return t


def test_every_span_is_stamped_from_its_tracers_clock():
    clock = FakeClock()
    tracer = trace.SpanTracer(clock=clock)
    assert clock.readings == [100.0]  # the tracer's origin
    trace.set_active(tracer)
    profile = ScanProfile(tracer=tracer)
    with profile.stage("dispatch", items=3):
        with trace.timed("copy", obs_metrics.FINALIZE_PHASE_SECONDS.labels(phase="copy"),
                         cat="finalize"):
            with trace.maybe_span("fetch", cat="io"):
                pass
        with tracer.span("decode", cat="io"):
            pass
    ev = {e["name"]: e for e in tracer.events()}
    # Readings in order: dispatch opens (100.5), copy (101.0), fetch
    # (101.5, 102.0), copy closes (102.5), decode (103.0, 103.5), dispatch
    # closes (104.0).
    assert clock.readings[1:] == [100.5 + 0.5 * i for i in range(8)]
    stamps = {"dispatch": (100.5, 104.0), "copy": (101.0, 102.5),
              "fetch": (101.5, 102.0), "decode": (103.0, 103.5)}
    for name, (start, end) in stamps.items():
        assert ev[name]["ts"] == pytest.approx((start - 100.0) * 1e6, abs=1e-6)
        assert ev[name]["dur"] == pytest.approx((end - start) * 1e6, abs=1e-6)
    # The counters beside the spans book the spans' own durations.
    assert obs_metrics.STAGE_SECONDS.labels(stage="dispatch").value == 3.5
    assert obs_metrics.FINALIZE_PHASE_SECONDS.labels(phase="copy").value == 1.5
    assert ev["copy"]["args"]["parent"] == ev["dispatch"]["args"]["id"]
    assert ev["fetch"]["args"]["parent"] == ev["copy"]["args"]["id"]
    assert ev["decode"]["args"]["parent"] == ev["dispatch"]["args"]["id"]
    assert ev["dispatch"]["args"]["parent"] is None


def test_no_call_site_stamps_a_span_with_its_own_clock():
    """Spans are recorded through the tracer's `begin`/`end` (which
    `timed` and `ScanProfile` use); ``add_complete`` is the tracer's own."""
    root = pathlib.Path(trace.__file__).resolve().parents[1]
    callers = sorted(str(p.relative_to(root)) for p in root.rglob("*.py")
                     if "add_complete(" in p.read_text())
    assert callers == ["obs/trace.py"]


# ---------------------------------------------------------------------------
# device-resident bytes and the fold's device span


def state_bytes(state) -> int:
    """Every tensor of a state, walked independently of the program."""
    total = 0
    for sub in dataclasses.fields(state):
        part = getattr(state, sub.name)
        if part is not None:
            total += sum(getattr(part, f.name).nbytes for f in dataclasses.fields(part))
    return total


CONFIGS = {
    "compacted with sketches": dict(count_alive_keys=True, enable_hll=True,
                                    distinct_keys_per_partition=True,
                                    enable_quantiles=True, quantiles_per_partition=True),
    "compacted, pair lists": dict(count_alive_keys=True, alive_compaction="off"),
    "keyless": dict(),
}


@pytest.mark.parametrize("features", list(CONFIGS.values()), ids=list(CONFIGS))
def test_resident_bytes_are_the_states_tensors_and_the_scratch(features):
    """The resident bytes are the state's tensors alone: the pair lists
    (compacted or per row) apply in place, with no word accumulator (no
    ``scratch`` owner) beside the bitmap."""
    config = AnalyzerConfig(num_partitions=3, batch_size=512, alive_bitmap_bits=18,
                            hll_p=10, **features)
    backend = TorchBackend(config, device="cpu")
    booked = samples(default_registry().snapshot(), "kta_device_resident_bytes_total")
    assert sum(booked.values()) == state_bytes(backend.state)
    owners = {"metrics"} | {k for k in ("alive", "hll", "quantiles")
                            if getattr(backend.state, k) is not None}
    assert set(booked) == owners
    assert "scratch" not in booked
    assert booked["metrics"] == 3 * 7 * 8 + 4 * 3 * 8 + 2 * 8
    if config.count_alive_keys:
        assert booked["alive"] == (1 << 18) // 8


def test_mesh_resident_bytes_sum_the_stacks():
    config = AnalyzerConfig(num_partitions=4, batch_size=256, count_alive_keys=True,
                            alive_bitmap_bits=16, enable_hll=True, hll_p=8,
                            mesh_shape=(2, 1))
    backend = ShardedTorchBackend(config, device="cpu")
    want = sum(state_bytes(s) for s in backend._stacks.values())
    booked = samples(default_registry().snapshot(), "kta_device_resident_bytes_total")
    assert sum(booked.values()) == want
    assert "scratch" not in booked


class TimingEvent:
    """A completed timing event at ``t`` seconds (``torch.cuda.Event``'s
    surface: ``elapsed_time`` in milliseconds)."""

    def __init__(self, t: float):
        self.t = t

    def query(self) -> bool:
        return True

    def synchronize(self) -> None:
        pass

    def elapsed_time(self, end: "TimingEvent") -> float:
        return (end.t - self.t) * 1e3


def test_retired_folds_book_their_device_span():
    queue = DispatchQueue(depth=2)
    queue.launched(TimingEvent(1.25), 1, TimingEvent(1.0))
    queue.launched(TimingEvent(2.5), 1, TimingEvent(2.0))
    queue.launched(READY, 1)  # a host fold: nothing to time
    queue.drain()
    assert obs_metrics.FOLD_DEVICE_SECONDS.value == pytest.approx(0.75)
    assert default_registry().snapshot()["kta_dispatch_seconds"]["samples"][0]["count"] == 3


# ---------------------------------------------------------------------------
# one timeline: --trace-json with --profile-dir


#: Aten ops only the fold issues on the CPU (the counters' adds and
#: extremes, the bitmap's scatter); finalize copies, workers pack with
#: numpy and copy.
FOLD_OPS = ("aten::index_add_", "aten::maximum", "aten::minimum", "aten::sum")


def test_host_spans_merge_into_the_profilers_trace(tmp_path):
    host = tmp_path / "host.json"
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        assert cli.main(["-t", "t", "--source", "synthetic", "--synthetic",
                         "partitions=3,messages=20000,keys=500,tombstones=150",
                         "--device", "cpu", "-c", "--quiet", "--ingest-workers", "2",
                         "--trace-json", str(host), "--profile-dir", str(tmp_path)]) == 0
    events = json.loads((tmp_path / TRACE_FILE).read_text())["traceEvents"]
    dispatch = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                      if e.get("cat") == "stage" and e["name"] == "dispatch")
    assert dispatch
    starts = [a for a, _ in dispatch]

    def inside(e) -> bool:
        i = bisect.bisect_right(starts, e["ts"]) - 1
        return i >= 0 and e["ts"] + e.get("dur", 0) <= dispatch[i][1]

    ops = [e for e in events if e.get("ph") == "X" and e["name"] in FOLD_OPS]
    assert ops and all(inside(e) for e in ops)
    assert sum(e["name"] == CLOCK_MARKER for e in events) == 1
    tracks = {e["tid"]: e["args"]["name"] for e in events
              if e.get("ph") == "M" and e["args"].get("name", "").startswith("host spans")}
    assert sorted(tracks.values()) == ["host spans: MainThread", "host spans: kta-ingest-0",
                                       "host spans: kta-ingest-1"]
    assert {e["tid"] for e in events if e.get("cat") in SPAN_CATS} == set(tracks)
    # --trace-json itself keeps the tracer's own time base.
    alone = json.loads(host.read_text())["traceEvents"]
    assert [e["name"] for e in alone if e.get("ph") == "X"].count("dispatch") == len(dispatch)
    assert all(0 <= e["ts"] < 600e6 for e in alone)
    assert not any(e.get("ph") == "M" for e in alone)


def test_trace_json_alone_writes_no_profile(tmp_path):
    host = tmp_path / "host.json"
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["-t", "t", "--source", "synthetic", "--synthetic",
                         "partitions=2,messages=4000", "--device", "cpu", "--quiet",
                         "--trace-json", str(host)]) == 0
    assert json.loads(host.read_text())["traceEvents"]
    assert not (tmp_path / TRACE_FILE).exists()
