"""The port's small utilities against the reference's: the env_logger spec
(`utils/log`), the progress spinner (`utils/progress`) and the stage
profile's live bookings (`utils/profiling.ScanProfile`)."""

import logging

import pytest

from kafka_topic_analyzer_tpu.utils import log as ref_log
from kafka_topic_analyzer_tpu.utils.progress import Spinner as RefSpinner
from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics
from kafka_topic_analyzer_tpu_torch.obs.registry import default_registry
from kafka_topic_analyzer_tpu_torch.obs.trace import SpanTracer
from kafka_topic_analyzer_tpu_torch.utils import log
from kafka_topic_analyzer_tpu_torch.utils.profiling import ScanProfile, maybe_torch_trace
from kafka_topic_analyzer_tpu_torch.utils.progress import Spinner


@pytest.fixture(autouse=True)
def _reset_registry():
    default_registry().reset()
    yield
    default_registry().reset()


@pytest.mark.parametrize("spec", [
    "debug", "warn", "module=debug,info", "nonsense", "trace", "off", "",
    "kta.io=debug,error", "garbage,=debug,kta.io=loud", "nope,kta=trace",
    "info,warn", " kta.io = debug , warn ",
])
def test_log_spec_parses_as_the_reference(spec):
    assert log.parse_spec(spec) == ref_log.parse_spec(spec)


@pytest.mark.parametrize("target, want", [
    ("kta", "kafka_topic_analyzer_tpu_torch"),
    ("kta.io", "kafka_topic_analyzer_tpu_torch.io"),
    ("ktax.io", "ktax.io"),
    ("other.mod", "other.mod"),
])
def test_log_target_alias_names_the_port_package(target, want):
    assert log.resolve_target(target) == want


def test_init_logging_configures_named_loggers(monkeypatch):
    monkeypatch.setenv("KTA_LOG", "warn,kta.io=debug")
    io_logger = logging.getLogger("kafka_topic_analyzer_tpu_torch.io")
    old_level = io_logger.level
    try:
        log.init_logging()
        assert io_logger.level == logging.DEBUG
        child = logging.getLogger("kafka_topic_analyzer_tpu_torch.io.kafka_wire")
        assert child.getEffectiveLevel() == logging.DEBUG
    finally:
        io_logger.setLevel(old_level)


class _FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self) -> float:
        return self.t


#: (clock step in s, message) — a frame drawn, one held by the rate
#: limit, then another drawn; finish flushes the held one first.
STEPS = [(1.0, "first"), (0.01, "held"), (0.5, "third"), (0.02, "last-frame")]


@pytest.mark.parametrize("enabled", [True, False])
def test_spinner_writes_the_reference_frames(enabled, capsys):
    out = []
    for cls in (Spinner, RefSpinner):
        clock = _FakeClock()
        sp = cls(enabled=enabled, min_interval_s=0.1, clock=clock)
        for dt, msg in STEPS:
            clock.t += dt
            sp.set_message(msg)
        sp.finish_with_message("done")
        sp.finish_with_message("again")
        out.append(capsys.readouterr())
    assert out[0].err == out[1].err and out[0].out == out[1].out == ""
    if enabled:
        assert out[0].err.index("last-frame") < out[0].err.index("done")
        assert "again" not in out[0].err
    else:
        assert out[0].err == ""


def test_scan_profile_books_live_stage_counters_and_mirrors_the_tracer():
    tracer = SpanTracer()
    prof = ScanProfile(tracer=tracer)
    with prof.stage("ingest"):
        pass
    with prof.stage("dispatch", items=10, nbytes=1_000):
        pass
    with prof.stage("dispatch", items=5, nbytes=500):
        pass
    secs = obs_metrics.STAGE_SECONDS
    assert obs_metrics.STAGE_RECORDS.labels(stage="dispatch").value == 15
    assert obs_metrics.STAGE_BYTES.labels(stage="dispatch").value == 1_500
    assert obs_metrics.STAGE_RECORDS.labels(stage="ingest").value == 0
    events = tracer.events()
    assert [e["name"] for e in events] == ["ingest", "dispatch", "dispatch"]
    assert {e["cat"] for e in events} == {"stage"}
    # One measurement: the trace's durations are the booked seconds.
    for stage in ("ingest", "dispatch"):
        dur = sum(e["dur"] for e in events if e["name"] == stage)
        assert dur == pytest.approx(secs.labels(stage=stage).value * 1e6)


def test_maybe_torch_trace_without_a_directory_is_a_no_op(tmp_path):
    for directory in (None, ""):
        with maybe_torch_trace(directory, "cpu"):
            pass
    assert list(tmp_path.iterdir()) == []
