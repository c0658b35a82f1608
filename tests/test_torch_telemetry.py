"""The port's scan telemetry against the reference's, through both CLIs.

After the same Kafka scan (loopback `fake_broker`, superbatch K = 1, one
ingest worker), the port's ``/metrics`` exposition has the reference's
metric families (names, types, label names), and every counting
instrument equals the reference's: records, batches, bytes, fetches, fused
rows and fallbacks, wire bytes, alive pairs, corrupt frames.  The one
family the port books that the reference does not at K = 1 is the
dispatch queue's ``kta_superbatch_size`` (one observation per dispatch):
the port's launch-site queue runs at K = 1, the reference's only above.
``--stats`` writes the reference's blocks; ``--trace-json`` stage totals
equal ``--stats``; ``--events-jsonl`` carries the reference's lifecycle
events; ``--metrics-port 0`` announces the port it bound.

The scan doctor calls a slow source ingest-bound and a slow device
dispatch-bound, with the dispatch queue's throttle wait as the evidence
(on the CPU a completion token whose ``synchronize`` sleeps stands in for
the slow device), and the reference's doctor reads the port's snapshots
to the same verdicts.  Each environment kill switch (``KTA_WIRE_V4``,
``KTA_DISABLE_COMPACTION``, ``KTA_DISABLE_FUSED``, ``KTA_DISABLE_NATIVE``)
flips the path and books its reason as the reference does, with the
report unchanged.
"""

import contextlib
import io
import json
import re
import time
import urllib.request

import pytest
import torch

from fake_broker import CorruptionInjector, FakeBroker
from port_instruments import PORT_ONLY
from kafka_topic_analyzer_tpu import cli as ref_cli
from kafka_topic_analyzer_tpu.io import kafka_codec as ref_cc
from kafka_topic_analyzer_tpu.io import native as ref_native
from kafka_topic_analyzer_tpu.obs import doctor as ref_doctor
from kafka_topic_analyzer_tpu.obs.exporters import PrometheusExporter as RefExporter
from kafka_topic_analyzer_tpu.obs.registry import default_registry as ref_registry
from kafka_topic_analyzer_tpu_torch import cli
from kafka_topic_analyzer_tpu_torch.backends.base import DispatchQueue
from kafka_topic_analyzer_tpu_torch.backends.gpu import TorchBackend
from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig, DispatchConfig
from kafka_topic_analyzer_tpu_torch.engine import run_scan
from kafka_topic_analyzer_tpu_torch.io import native
from kafka_topic_analyzer_tpu_torch.io.synthetic import SyntheticSource, SyntheticSpec
from kafka_topic_analyzer_tpu_torch.obs import doctor
from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics
from kafka_topic_analyzer_tpu_torch.obs.exporters import PrometheusExporter
from kafka_topic_analyzer_tpu_torch.obs.registry import default_registry

TOPIC = "telemetry.t"
FLAGS = ["-c", "--distinct-keys-per-partition", "--quantiles-per-partition", "--pallas",
         "--alive-bitmap-bits", "24", "--batch-size", "2048", "--quiet"]
#: The one family the port's K = 1 dispatch queue books and the
#: reference's single-batch path does not.
K1_ONLY = {"kta_superbatch_size"}


@pytest.fixture(autouse=True)
def _reset_registries():
    default_registry().reset()
    ref_registry().reset()
    yield
    default_registry().reset()
    ref_registry().reset()


def rows(partition: int, n: int):
    """Records whose keys are distinct across partitions (``-c`` then
    does not depend on the order of fetches of different partitions)."""
    return [(i, 1_600_000_000_000 + i * 1000 + partition,
             f"k{partition}-{i % 61}".encode() if i % 9 else None,
             bytes(30 + (i * 5 + partition) % 57) if i % 7 else None) for i in range(n)]


def broker(corrupt: bool = False, **topic) -> FakeBroker:
    """The test topic; ``topic`` passes the frame layout (``message_magic``,
    ``compression``) on to `FakeBroker`."""
    inj = (CorruptionInjector().flip_byte(0, chunk=2, offset=-1)
           .garbage_compression(0, chunk=4)) if corrupt else None
    return FakeBroker(TOPIC, {p: rows(p, 3000) for p in range(3)},
                      max_records_per_fetch=500, corruption=inj,
                      honor_partition_max_bytes=corrupt, **topic)


def both(argv, port_extra=(), ref_extra=()):
    """Scan with each CLI in turn from reset registries; returns
    ((rc, stdout, stderr, snapshot) of the port, the same of the
    reference)."""
    out = []
    for main, extra, registry in (
            (cli.main, ["--device", "cpu", *port_extra], default_registry),
            (ref_cli.main, ["--backend", "tpu", *ref_extra], ref_registry)):
        default_registry().reset()
        ref_registry().reset()
        stdout, stderr = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr):
            rc = main(argv + extra)
        out.append((rc, drop_timing(stdout.getvalue()), stderr.getvalue(),
                    registry().snapshot()))
    return out


def drop_timing(text: str) -> str:
    return "".join(line for line in text.splitlines(keepends=True)
                   if not line.startswith(("Scanning took:", "Estimated Msg/s:")))


def counting(snapshot: dict) -> dict:
    """Every counter and histogram that counts (no seconds) of the
    reference's catalog: name and labels → value, or → (count, bucket
    counts)."""
    out = {}
    for name, fam in snapshot.items():
        if "seconds" in name or name in K1_ONLY or name in PORT_ONLY:
            continue
        for s in fam["samples"]:
            key = (name, tuple(sorted(s.get("labels", {}).items())))
            if fam["type"] == "counter":
                out[key] = s["value"]
            elif fam["type"] == "histogram":
                out[key] = (s["count"], tuple(s["counts"]))
    return out


def families(text: str) -> dict:
    """Prometheus text → {family: (type, label names)}."""
    types = dict(re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M))
    labels = {name: set() for name in types}
    for m in re.finditer(r"^([a-zA-Z_:][\w:]*)(?:\{([^}]*)\})? ", text, re.M):
        name = m.group(1)
        if name not in types:
            name = re.sub(r"_(bucket|count|sum)$", "", name)
        labels[name].update(set(re.findall(r'(\w+)="', m.group(2) or "")) - {"le"})
    return {name: (types[name], frozenset(labels[name])) for name in types}


def scrape(exporter) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{exporter.port}/metrics",
                                timeout=5) as resp:
        return resp.read().decode()


# ---------------------------------------------------------------------------
# exposition and counters after the same scan


def test_metrics_families_equal_the_reference():
    exporters = (PrometheusExporter(0), RefExporter(0))
    try:
        with broker() as b:
            argv = ["-t", TOPIC, "-b", f"127.0.0.1:{b.port}", *FLAGS]
            with contextlib.redirect_stdout(io.StringIO()):
                assert cli.main(argv + ["--device", "cpu"]) == 0
                assert ref_cli.main(argv + ["--backend", "tpu"]) == 0
        port, ref = (families(scrape(e)) for e in exporters)
    finally:
        for e in exporters:
            e.close()
    # The reference's families, plus exactly the port's own instruments.
    assert sorted(port) == sorted(set(ref) | set(PORT_ONLY))
    assert {name: fam for name, fam in port.items() if name not in PORT_ONLY} == ref
    for name, (kind, labels) in PORT_ONLY.items():
        assert port[name][0] == kind
        assert port[name][1] <= set(labels)
    assert port["kta_scan_records_total"] == ("counter", frozenset())
    assert port["kta_partition_lag"][1] == {"partition"}


SCANS = {
    "v5 fused": ["--native", "on"],
    "v4 fused": ["--native", "on", "--wire-format", "v4"],
    "v5 chained": ["--native", "off"],
    "compaction off": ["--native", "on", "--alive-compaction", "off"],
    "corrupt skip": ["--native", "on", "--check-crcs", "--on-corruption", "skip",
                     "--librdkafka", "retry.backoff.ms=5"],
    # Fused sinks fed decoded frames: the fallback labels.
    "gzip fused": ["--native", "on"],
    "legacy fused": ["--native", "on"],
}
#: The frame layout of each scan's topic (modern uncompressed by default).
TOPICS = {"gzip fused": dict(compression=ref_cc.COMPRESSION_GZIP),
          "legacy fused": dict(message_magic=1)}


@pytest.mark.parametrize("scan", list(SCANS))
def test_counting_counters_equal_the_reference(scan):
    with broker(corrupt=scan.startswith("corrupt"), **TOPICS.get(scan, {})) as b:
        port, ref = both(["-t", TOPIC, "-b", f"127.0.0.1:{b.port}", *FLAGS, *SCANS[scan]])
    assert port[:2] == ref[:2]
    got, want = counting(port[3]), counting(ref[3])
    assert got == want
    total = dict(got)
    assert total[("kta_scan_records_total", ())] == port[3]["kta_scan_records_total"][
        "samples"][0]["value"] > 0
    assert total[("kta_fetch_requests_total", ())] > 0
    assert total[("kta_wire_bytes_total", ())] > 0
    if scan.startswith("corrupt"):
        assert total[("kta_corrupt_frames_total", (("kind", "bad-compression"),))] == 1
    if scan in TOPICS:
        label = "python-decode" if scan.startswith("legacy") else "frame-fallback"
        assert total[("kta_fused_fallback_total", (("reason", label),))] == 9000
    if "fused" in scan or scan.startswith("corrupt"):
        assert total[("kta_fused_batches_total", ())] > 0
    # The port's own: one dispatch per batch through the K = 1 queue.
    dispatched = port[3]["kta_superbatch_size"]["samples"][0]
    assert dispatched["count"] == dispatched["sum"] == \
        total[("kta_scan_batches_total", ())]


def test_stats_blocks_equal_the_reference():
    with broker() as b:
        port, ref = both(["-t", TOPIC, "-b", f"127.0.0.1:{b.port}", *FLAGS, "--stats"])
    assert port[:2] == ref[:2]

    def headers(err: str) -> list:
        return [re.match(r"\s*[^:]+:", line).group(0) for line in err.splitlines()
                if re.match(r"\s*[^:]+:", line)]

    queue_line = [line for line in port[2].splitlines() if "superbatch dispatches" in line]
    assert queue_line == ["  dispatch: 5 superbatch dispatches (K=1, depth=2), 5 batches "
                          "folded, " + queue_line[0].split("folded, ")[1]]
    got = headers(port[2].replace(queue_line[0] + "\n", ""))
    want = headers(ref[2])
    assert [h for h in got if not h.startswith(" ")] == \
        [h for h in want if not h.startswith(" ")] == \
        ["scan stages:", "telemetry:", "BOTTLENECK:"]
    # Every line of the reference's digest, in its order; the port adds
    # its dispatch queue's line.
    assert got == want
    for line in ("  scan: 9,000 records, 5 batches, 0.3 MB\n",
                 "  fused: 9,000 records in 5 row(s) via native decode→pack\n"):
        assert line in port[2] and line in ref[2]


def test_trace_stage_totals_equal_stats_and_events_match(tmp_path):
    paths = {}
    with broker() as b:
        for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                                  ("ref", ref_cli.main, ["--backend", "tpu"])):
            trace, events = tmp_path / f"{name}.json", tmp_path / f"{name}.jsonl"
            default_registry().reset()
            with contextlib.redirect_stdout(io.StringIO()):
                assert main(["-t", TOPIC, "-b", f"127.0.0.1:{b.port}", *FLAGS, *extra,
                             "--trace-json", str(trace), "--events-jsonl", str(events),
                             "--flight-record"]) == 0
            paths[name] = (trace, events)
            if name == "port":
                snap = default_registry().snapshot()
    stages = {}
    for ev in json.loads(paths["port"][0].read_text())["traceEvents"]:
        if ev.get("cat") == "stage":
            stages[ev["name"]] = stages.get(ev["name"], 0.0) + ev["dur"] / 1e6
    booked = {s["labels"]["stage"]: s["value"]
              for s in snap["kta_stage_seconds_total"]["samples"] if s["value"]}
    assert set(stages) == set(booked) == {"ingest", "dispatch", "finalize"}
    for stage, secs in booked.items():
        assert stages[stage] == pytest.approx(secs, rel=1e-6, abs=1e-6)
    assert any(ev.get("ph") == "C" for ev in
               json.loads(paths["port"][0].read_text())["traceEvents"])
    kinds = [[json.loads(line)["type"] for line in p[1].read_text().splitlines()]
             for p in (paths["port"], paths["ref"])]
    assert kinds[0][0] == kinds[1][0] == "scan_start"
    assert kinds[0][-1] == kinds[1][-1] == "scan_end"
    assert set(kinds[0]) == set(kinds[1])


def test_metrics_port_zero_announces_the_bound_port(capsys):
    assert cli.main(["-t", TOPIC, "--source", "synthetic", "--synthetic",
                     "partitions=2,messages=400", "--device", "cpu", "--quiet",
                     "--metrics-port", "0"]) == 0
    err = capsys.readouterr().err
    assert re.fullmatch(r"serving metrics on http://127\.0\.0\.1:\d+/metrics\n", err)


# ---------------------------------------------------------------------------
# the scan doctor


class SlowToken:
    """A completion token of a slow device: not done until
    ``synchronize`` has waited ``dt``."""

    def __init__(self, dt: float):
        self._dt, self._done = dt, False

    def query(self) -> bool:
        return self._done

    def synchronize(self) -> None:
        time.sleep(self._dt)
        self._done = True


class SlowDevice(TorchBackend):
    """The torch backend on the CPU whose folds retire ``dt`` after their
    launch, behind a dispatch queue of depth 1."""

    def __init__(self, config, dt: float):
        super().__init__(config, device="cpu", dispatch=DispatchConfig(depth=1))
        self._dt = dt

    def _completion_token(self):
        return SlowToken(self._dt)


class SlowSource:
    """A source that starves the pipeline: every batch costs ``dt`` on the
    producing thread."""

    def __init__(self, inner, dt: float):
        self._inner, self._dt = inner, dt

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def batches(self, batch_size, start_at=None):
        for b in self._inner.batches(batch_size, start_at=start_at):
            time.sleep(self._dt)
            yield b


def spec(n=1024, parts=2):
    return SyntheticSpec(num_partitions=parts, messages_per_partition=n,
                         keys_per_partition=50)


def config(parts=2):
    return AnalyzerConfig(num_partitions=parts, batch_size=256)


def test_throttle_wait_booked_at_the_launch_site():
    q = DispatchQueue(1)
    q.throttle()
    assert obs_metrics.DISPATCH_THROTTLE_SECONDS.value == 0.0
    q.launched(SlowToken(0.05), 1)
    q.throttle()
    waited = obs_metrics.DISPATCH_THROTTLE_SECONDS.value
    assert waited >= 0.04
    q.launched(SlowToken(0.0), 1)
    q.drain()
    assert obs_metrics.DISPATCH_THROTTLE_SECONDS.value == waited


def test_slow_device_reads_dispatch_bound():
    result = run_scan("synth", SyntheticSource(spec()), SlowDevice(config(), 0.05), 256)
    d = doctor.diagnose_scan(result)
    assert result.dispatch_depth == 1
    assert d.verdict == "dispatch-bound"
    assert d.evidence["throttle_wait"] > 0.2
    assert d.stages["dispatch"] > 0.5
    ref = ref_doctor.diagnose(result.telemetry, dispatch_depth=1)
    assert ref.as_dict() == doctor.diagnose(result.telemetry, dispatch_depth=1).as_dict()


def test_slow_source_reads_ingest_bound():
    result = run_scan("synth", SlowSource(SyntheticSource(spec()), 0.05),
                      TorchBackend(config(), device="cpu"), 256)
    d = doctor.diagnose_scan(result)
    assert d.verdict == "ingest-bound"
    assert d.stages["ingest"] > 0.5
    assert d.evidence["throttle_wait"] == 0.0
    ref = ref_doctor.diagnose(result.telemetry, dispatch_depth=2)
    assert ref.as_dict() == doctor.diagnose(result.telemetry, dispatch_depth=2).as_dict()


@pytest.mark.parametrize("shape", [(8.0, 1.0, 0.0), (1.0, 9.0, 6.0), (3.0, 3.0, 0.0),
                                   (0.0, 0.0, 0.0)])
def test_doctor_verdicts_equal_the_reference(shape):
    ingest, dispatch, throttle = shape
    snap = {
        "kta_stage_seconds_total": {"type": "counter", "help": "", "samples": [
            {"labels": {"stage": "ingest"}, "value": ingest},
            {"labels": {"stage": "dispatch"}, "value": dispatch}]},
        "kta_dispatch_throttle_seconds_total": {"type": "counter", "help": "",
                                                "samples": [{"labels": {}, "value": throttle}]},
    }
    got = doctor.diagnose(snap).as_dict()
    assert got == ref_doctor.diagnose(snap).as_dict()
    assert got["verdict"] == {(8.0, 1.0, 0.0): "ingest-bound",
                              (1.0, 9.0, 6.0): "dispatch-bound",
                              (0.0, 0.0, 0.0): "no-signal"}.get(shape, got["verdict"])


# ---------------------------------------------------------------------------
# kill switches


SWITCHES = {
    "KTA_WIRE_V4": ("kta_wire_v4_fallback_total", "env-kill-switch"),
    "KTA_DISABLE_COMPACTION": ("kta_alive_compaction_off_total", "env-kill-switch"),
    "KTA_DISABLE_FUSED": ("kta_fused_fallback_total", "fused-disabled"),
    "KTA_DISABLE_NATIVE": ("kta_fused_fallback_total", "native-disabled"),
}


@pytest.mark.parametrize("switch", list(SWITCHES))
def test_kill_switch_flips_the_path_and_books_its_reason(switch, monkeypatch):
    with broker() as b:
        argv = ["-t", TOPIC, "-b", f"127.0.0.1:{b.port}", *FLAGS]
        clean = both(argv)
        monkeypatch.setenv(switch, "1")
        if switch == "KTA_DISABLE_NATIVE":
            # The switch is read at the shim's first load: forget the
            # loaded shims (monkeypatch restores them afterwards).
            for module in (native, ref_native):
                monkeypatch.setattr(module, "_lib", None)
                monkeypatch.setattr(module, "_load_error", None)
        port, ref = both(argv)
    assert port[:2] == ref[:2]
    assert port[1] == clean[0][1]
    assert counting(port[3]) == counting(ref[3])
    family, reason = SWITCHES[switch]
    booked = {s["labels"].get("reason"): s["value"] for s in port[3][family]["samples"]}
    assert booked.get(reason, 0) >= 1, booked
    fused_rows = counting(port[3]).get(("kta_fused_batches_total", ()), 0)
    if switch in ("KTA_DISABLE_FUSED", "KTA_DISABLE_NATIVE"):
        assert fused_rows == 0
        if switch == "KTA_DISABLE_NATIVE":
            assert native.native_status() == (False, "disabled")
    else:
        assert fused_rows > 0
    if switch == "KTA_WIRE_V4":
        assert AnalyzerConfig().wire_format == 4
        per_record = "kta_wire_packed_bytes_per_record"
        assert port[3][per_record]["samples"][0]["value"] != \
            clean[0][3][per_record]["samples"][0]["value"]
    if switch == "KTA_DISABLE_COMPACTION":
        assert counting(port[3]).get(("kta_alive_pairs_emitted_total", ()), 0) == 0


# ---------------------------------------------------------------------------
# on the card


@pytest.mark.cuda
def test_cuda_stats_and_profile_scan(tmp_path, capsys):
    """On a card: a ``--stats --profile-dir`` scan prints the cpu scan's
    report, writes the doctor's digest, launches its format's kernel and
    leaves a Chrome trace."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from kafka_topic_analyzer_tpu_torch.ops import counters_merge
    from kafka_topic_analyzer_tpu_torch.utils.profiling import TRACE_FILE, device_events

    argv = ["-t", TOPIC, "--source", "synthetic", "--synthetic",
            "partitions=4,messages=20000,keys=500", *FLAGS]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    want = drop_timing(capsys.readouterr().out)
    counters_merge.counters_merge.launches = 0
    assert cli.main(argv + ["--stats", "--profile-dir", str(tmp_path)]) == 0
    cap = capsys.readouterr()
    assert drop_timing(cap.out) == want
    assert "BOTTLENECK: " in cap.err and "scan stages:" in cap.err
    assert counters_merge.counters_merge.launches > 0
    trace = tmp_path / TRACE_FILE
    assert trace.exists()
    names = {e["name"] for e in device_events(str(trace))}
    assert not names or any("counters_merge" in n for n in names), names
