"""What the benchmark reads from the program besides its answers: the
program's counters (its metrics registry) and, in a traced run, the
device timeline of ``torch.profiler`` with the program's stage spans laid
over it."""

from __future__ import annotations

import bisect
import json
import math
import os
import time
from collections import defaultdict

#: Device activity in a ``torch.profiler`` Chrome trace.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: The drive loop's stages, as the program names its spans.
HOST_STAGES = ("finalize", "dispatch", "ingest", "snapshot")


def counters() -> "dict[str, float]":
    """The program's registry flattened: ``name{label=value,...}`` for
    counters and gauges, ``name:sum`` and ``name:count`` for histograms."""
    from kafka_topic_analyzer_tpu_torch.obs.registry import default_registry

    out: "dict[str, float]" = {}
    for name, inst in default_registry().snapshot().items():
        for s in inst["samples"]:
            labels = ",".join(f"{k}={v}" for k, v in sorted(s["labels"].items()))
            key = f"{name}{{{labels}}}" if labels else name
            if inst["type"] == "histogram":
                out[key + ":sum"] = float(s["sum"])
                out[key + ":count"] = float(s["count"])
            else:
                out[key] = float(s["value"])
    return out


def nearest_rank(values: "list[float]", q: float) -> float:
    """The ``q`` quantile by nearest rank: the smallest value with at least
    ``q`` of the values at or below it."""
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def delta(before: "dict[str, float]", after: "dict[str, float]") -> "dict[str, float]":
    return {k: v - before.get(k, 0.0) for k, v in after.items()}


def _union_length(intervals: "list[tuple[float, float]]") -> float:
    total = 0.0
    end = -float("inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


class DeviceTrace:
    """``torch.profiler`` over the enclosed block, with the program's stage
    spans recorded by a span tracer installed as the process's active one.
    Both are placed on ``time.monotonic()``: the profiler by a marker
    recorded at a known instant, the tracer by its own start."""

    def __init__(self, enabled: bool, tmpdir: str, cuda: bool):
        self.enabled = enabled
        self.tmpdir = tmpdir
        self.cuda = cuda
        self.device: "list[tuple[float, float, str]]" = []
        self.stages: "list[tuple[float, float, str]]" = []

    def __enter__(self) -> "DeviceTrace":
        if not self.enabled:
            return self
        import torch
        from torch.profiler import ProfilerActivity, profile

        from kafka_topic_analyzer_tpu_torch.obs import trace as obs_trace
        from kafka_topic_analyzer_tpu_torch.obs.trace import SpanTracer

        self._tracer = SpanTracer(clock=time.monotonic)
        obs_trace.set_active(self._tracer)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._mark = time.monotonic()
        with torch.profiler.record_function("bench.marker"):
            pass
        return self

    def __exit__(self, *exc) -> None:
        if not self.enabled:
            return
        from kafka_topic_analyzer_tpu_torch.obs import trace as obs_trace

        self._prof.__exit__(*exc)
        obs_trace.set_active(None)
        path = os.path.join(self.tmpdir, "bench_trace.json")
        self._prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
        os.unlink(path)
        events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
        marks = [e for e in events if e.get("name") == "bench.marker" and e.get("ph") == "X"]
        if not marks:
            raise RuntimeError("the profiler's trace lacks the benchmark's marker")
        shift = self._mark - min(e["ts"] for e in marks) / 1e6
        self.device = [
            (e["ts"] / 1e6 + shift, (e["ts"] + e.get("dur", 0)) / 1e6 + shift, e["name"])
            for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES
        ]
        t0 = self._tracer._t0
        self.stages = [
            (t0 + e["ts"] / 1e6, t0 + (e["ts"] + e["dur"]) / 1e6, e["name"])
            for e in self._tracer.events()
            if e.get("ph") == "X" and e.get("cat") == "stage"
        ]

    def summary(self, t0: float, t1: float) -> dict:
        """What the device did in ``[t0, t1]`` (monotonic seconds)."""
        clip = [(max(a, t0), min(b, t1), n) for a, b, n in self.device if b > t0 and a < t1]
        busy = _union_length([(a, b) for a, b, _ in clip])
        by_name: "dict[str, list]" = defaultdict(lambda: [0.0, 0])
        for a, b, n in clip:
            by_name[n][0] += b - a
            by_name[n][1] += 1
        # Device activity and the idle gaps between it, each named by the
        # host stage whose span covers its midpoint ("between-scans"
        # outside any). The drive loop's stage spans follow one another on
        # its thread.
        stages = sorted(s for s in self.stages if s[2] in HOST_STAGES)
        starts = [s[0] for s in stages]

        def stage_at(t: float) -> str:
            i = bisect.bisect_right(starts, t) - 1
            return stages[i][2] if i >= 0 and stages[i][1] >= t else "between-scans"

        by_stage: "dict[str, float]" = defaultdict(float)
        for a, b, _ in clip:
            by_stage[stage_at((a + b) / 2)] += b - a
        gaps: "dict[str, float]" = defaultdict(float)
        cursor = t0
        for a, b in sorted([(a, b) for a, b, _ in clip]) + [(t1, t1)]:
            if a > cursor:
                gaps[stage_at((a + cursor) / 2)] += a - cursor
            cursor = max(cursor, b)
        return {
            "busy_s": busy,
            "window_s": t1 - t0,
            "ops": {n: (s, c) for n, (s, c) in by_name.items()},
            "stage_device_s": dict(by_stage),
            "idle_gaps": dict(gaps),
        }
