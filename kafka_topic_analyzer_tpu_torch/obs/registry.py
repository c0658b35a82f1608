"""Metrics registry: counters, gauges, and fixed-bucket histograms (port
of the reference's ``obs/registry.py``, unchanged).

Dependency-free (stdlib only) and cheap enough for the scan hot loop:
every instrument is a plain Python object guarded by its own lock, and an
increment is one lock acquire + one integer add — no allocation per
observation, no string formatting until scrape time.  Instruments update
once per *batch* or per *fetch round*, never per record, so the telemetry
tax on a multi-million-record scan is a few thousand lock round-trips.

Three representations, one source of truth:

- live instruments (this module) — what the hot paths mutate;
- ``MetricsRegistry.snapshot()`` — a JSON-able dict, the wire format for
  cross-process aggregation (``merge_snapshots``) and the ``--json``
  report's ``telemetry`` block;
- ``render_prometheus(snapshot)`` — Prometheus text exposition v0.0.4,
  served by ``obs.exporters.PrometheusExporter``.

Thread-safety (audited for N-ingest-worker scans, where the wire counters
and per-worker instruments are hit from several threads concurrently —
tests/test_obs.py has the hammer):

- every mutation of an instrument's numeric state (``inc``/``set``/
  ``observe``/``_reset_values``) holds that instrument's own lock, so
  concurrent writers never lose updates;
- child creation (``labels``) and registry get-or-create hold the family/
  registry lock; the child *lookup* is deliberately lock-free (a CPython
  dict read is atomic under the GIL, children are only ever added) so the
  per-observation cost on labeled hot paths is one dict get, not a shared
  lock acquire per worker per batch;
- ``reset()`` is NOT atomic with respect to concurrent traffic (children
  can be re-created mid-reset); it is a test-isolation helper, called only
  between scans.

Merge semantics (multi-controller aggregation, parallel/sharded.py):
counters and histograms are additive; gauges take the elementwise max by
default (per-partition gauges carry disjoint label sets across processes,
so the max is a union in practice), but a gauge whose per-process values
are themselves disjoint counts — e.g. each process's locally-degraded
partitions — declares ``merge="sum"`` and the policy rides in the
snapshot.  The histogram merge law — merging N shard snapshots equals
observing the union of their samples — is property-tested in
tests/test_obs.py.
"""

from __future__ import annotations

import bisect
import contextlib
import math
import re
import threading
from time import perf_counter as _perf_counter
from typing import Dict, Iterable, List, Optional, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: Default latency buckets (seconds) — device steps land in the 1-100 ms
#: range on current hardware, finalize in the 10 ms - 10 s range.
LATENCY_BUCKETS_S = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0,
)

#: Default batch-size buckets (records per engine step).
BATCH_SIZE_BUCKETS = (
    256, 1024, 4096, 16384, 65536, 262144, 1048576, 4194304,
)


def _check_labels(labelnames: Tuple[str, ...]) -> None:
    for ln in labelnames:
        if not _LABEL_RE.match(ln):
            raise ValueError(f"bad label name {ln!r}")


class _Instrument:
    """Shared base: name/help/label plumbing.  An instrument constructed
    with ``labelnames`` is a *family*; ``labels(...)`` returns (creating on
    first use) the child carrying those label values."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        _check_labels(tuple(labelnames))
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: "Dict[Tuple[str, ...], _Instrument]" = {}

    def labels(self, *values: object, **kv: object) -> "_Instrument":
        if kv:
            if values:
                raise ValueError("pass label values positionally OR by name")
            values = tuple(str(kv[ln]) for ln in self.labelnames)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got {values}"
            )
        # Lock-free fast path: children are only ever ADDED (reset() is
        # confined to between-scan test isolation), and a CPython dict get
        # is atomic — so the steady-state labeled hot path (per-worker
        # counters, per-partition gauges) costs one dict lookup instead of
        # serializing every ingest worker on the family lock.
        child = self._children.get(values)
        if child is not None:
            return child
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._make_child()
                self._children[values] = child
            return child

    def _make_child(self) -> "_Instrument":
        raise NotImplementedError

    # -- snapshot ------------------------------------------------------------

    def _sample_values(self) -> dict:
        raise NotImplementedError

    def _reset_values(self) -> None:
        raise NotImplementedError

    def samples(self) -> List[dict]:
        """One dict per label set ({} for the unlabeled instrument)."""
        if self.labelnames:
            with self._lock:
                items = sorted(self._children.items())
            return [
                dict(labels=dict(zip(self.labelnames, vals)),
                     **child._sample_values())
                for vals, child in items
            ]
        return [dict(labels={}, **self._sample_values())]

    def reset(self) -> None:
        with self._lock:
            self._children.clear()
        self._reset_values()


class Counter(_Instrument):
    """Monotonically increasing value."""

    kind = "counter"

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...] = ()):
        super().__init__(name, help, labelnames)
        self._value = 0.0

    def _make_child(self) -> "Counter":
        return Counter(self.name, self.help)

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _sample_values(self) -> dict:
        return {"value": self.value}

    def _reset_values(self) -> None:
        with self._lock:
            self._value = 0.0


class Gauge(_Instrument):
    """Point-in-time value (lag, ETA, degraded count).

    ``merge`` picks the cross-process aggregation: ``"max"`` (default —
    right for same-quantity gauges like lag, where the fleet's worst value
    is the honest one) or ``"sum"`` (for gauges whose per-process values
    are disjoint local counts, like each process's degraded partitions)."""

    kind = "gauge"

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: Tuple[str, ...] = (),
        merge: str = "max",
    ):
        super().__init__(name, help, labelnames)
        if merge not in ("max", "sum"):
            raise ValueError(f"bad gauge merge policy {merge!r}")
        self.merge = merge
        self._value = 0.0

    def _make_child(self) -> "Gauge":
        return Gauge(self.name, self.help, merge=self.merge)

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _sample_values(self) -> dict:
        return {"value": self.value}

    def _reset_values(self) -> None:
        with self._lock:
            self._value = 0.0


class Histogram(_Instrument):
    """Fixed-bucket histogram: per-bucket counts (non-cumulative in
    memory, cumulative at exposition) plus sum and count.  ``observe`` is
    one bisect + three adds under the lock — no allocation."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        buckets: Iterable[float] = LATENCY_BUCKETS_S,
        labelnames: Tuple[str, ...] = (),
    ):
        super().__init__(name, help, labelnames)
        bs = tuple(float(b) for b in buckets)
        if not bs or list(bs) != sorted(bs) or len(set(bs)) != len(bs):
            raise ValueError("histogram buckets must be sorted and unique")
        if math.isinf(bs[-1]):
            bs = bs[:-1]  # +Inf is implicit (the overflow slot)
        self.buckets = bs
        self._counts = [0] * (len(bs) + 1)  # last slot = overflow (+Inf)
        self._sum = 0.0
        self._count = 0

    def _make_child(self) -> "Histogram":
        return Histogram(self.name, self.help, self.buckets)

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    @contextlib.contextmanager
    def time(self):
        """Observe the wall seconds of the ``with`` body (backend
        step/finalize latency instrumentation)."""
        t0 = _perf_counter()
        try:
            yield
        finally:
            self.observe(_perf_counter() - t0)

    def _sample_values(self) -> dict:
        with self._lock:
            return {
                "buckets": list(self.buckets),
                "counts": list(self._counts),
                "sum": self._sum,
                "count": self._count,
            }

    def _reset_values(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.buckets) + 1)
            self._sum = 0.0
            self._count = 0


class MetricsRegistry:
    """Get-or-create instrument store.  The module-level default registry
    (``default_registry()``) is what the library's hot paths write to;
    tests build private registries or ``reset()`` the default one."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: "Dict[str, _Instrument]" = {}

    def _get_or_create(self, cls, name: str, help: str, **kw) -> _Instrument:
        with self._lock:
            inst = self._instruments.get(name)
            if inst is not None:
                if not isinstance(inst, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as {inst.kind}"
                    )
                return inst
            inst = cls(name, help, **kw)
            self._instruments[name] = inst
            return inst

    def counter(
        self, name: str, help: str, labelnames: Tuple[str, ...] = ()
    ) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames=labelnames)

    def gauge(
        self,
        name: str,
        help: str,
        labelnames: Tuple[str, ...] = (),
        merge: str = "max",
    ) -> Gauge:
        return self._get_or_create(
            Gauge, name, help, labelnames=labelnames, merge=merge
        )

    def histogram(
        self,
        name: str,
        help: str,
        buckets: Iterable[float] = LATENCY_BUCKETS_S,
        labelnames: Tuple[str, ...] = (),
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, buckets=buckets, labelnames=labelnames
        )

    def instruments(self) -> List[_Instrument]:
        with self._lock:
            return [self._instruments[n] for n in sorted(self._instruments)]

    def snapshot(self) -> dict:
        """JSON-able view of every instrument — the registry wire format.
        Gauges carry their merge policy so ``merge_snapshots`` applies it
        without access to the live instruments."""
        out = {}
        for inst in self.instruments():
            doc = {
                "type": inst.kind,
                "help": inst.help,
                "samples": inst.samples(),
            }
            if inst.kind == "gauge":
                doc["merge"] = inst.merge
            out[inst.name] = doc
        return out

    def reset(self) -> None:
        """Zero every instrument (keeps registrations) — test isolation."""
        for inst in self.instruments():
            inst.reset()


_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _default


# -- snapshot algebra ---------------------------------------------------------


def _label_key(sample: dict) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(sample.get("labels", {}).items()))


def _copy_sample(sample: dict) -> dict:
    """One-level-deep sample copy (labels dict, bucket/count lists) so
    merges never mutate a caller's snapshot."""
    return {
        k: (dict(v) if isinstance(v, dict) else
            list(v) if isinstance(v, list) else v)
        for k, v in sample.items()
    }


def merge_snapshots(snapshots: List[dict]) -> dict:
    """Aggregate registry snapshots from N processes into one cluster-wide
    view: counters and histogram bucket counts add, gauges follow their
    declared merge policy (max by default, sum for disjoint local counts;
    disjoint-label gauges union either way).  Mismatched histogram bucket
    layouts raise — they indicate skewed code versions across the fleet."""
    out: dict = {}
    for snap in snapshots:
        for name, metric in snap.items():
            tgt = out.get(name)
            if tgt is None:
                out[name] = {
                    "type": metric["type"],
                    "help": metric.get("help", ""),
                    "samples": [_copy_sample(s) for s in metric["samples"]],
                }
                if "merge" in metric:
                    out[name]["merge"] = metric["merge"]
                continue
            if tgt["type"] != metric["type"]:
                raise ValueError(
                    f"metric {name!r} has conflicting types across "
                    f"processes: {tgt['type']} vs {metric['type']}"
                )
            by_labels = {_label_key(s): s for s in tgt["samples"]}
            for s in metric["samples"]:
                cur = by_labels.get(_label_key(s))
                if cur is None:
                    tgt["samples"].append(_copy_sample(s))
                    by_labels[_label_key(s)] = tgt["samples"][-1]
                elif tgt["type"] == "counter":
                    cur["value"] += s["value"]
                elif tgt["type"] == "gauge":
                    if tgt.get("merge", "max") == "sum":
                        cur["value"] += s["value"]
                    else:
                        cur["value"] = max(cur["value"], s["value"])
                elif tgt["type"] == "histogram":
                    if list(cur["buckets"]) != list(s["buckets"]):
                        raise ValueError(
                            f"histogram {name!r} bucket layouts differ "
                            "across processes"
                        )
                    cur["counts"] = [
                        a + b for a, b in zip(cur["counts"], s["counts"])
                    ]
                    cur["sum"] += s["sum"]
                    cur["count"] += s["count"]
    for metric in out.values():
        metric["samples"].sort(key=_label_key)
    return out


# -- Prometheus text exposition ----------------------------------------------


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() and abs(f) < 2**53 else repr(f)


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels_text(labels: dict, extra: "Optional[Tuple[str, str]]" = None) -> str:
    items = sorted(labels.items())
    if extra is not None:
        items.append(extra)
    if not items:
        return ""
    inner = ",".join(f'{k}="{_escape_label(str(v))}"' for k, v in items)
    return "{" + inner + "}"


def render_prometheus(snapshot: dict) -> str:
    """Prometheus text exposition v0.0.4 of a registry snapshot."""
    lines: List[str] = []
    for name in sorted(snapshot):
        metric = snapshot[name]
        help_text = str(metric.get("help", "")).replace("\n", " ")
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {metric['type']}")
        for s in metric["samples"]:
            labels = s.get("labels", {})
            if metric["type"] == "histogram":
                cum = 0
                for le, c in zip(
                    list(s["buckets"]) + [math.inf],
                    s["counts"],
                ):
                    cum += c
                    lt = _labels_text(labels, ("le", _fmt_value(le)))
                    lines.append(f"{name}_bucket{lt} {cum}")
                lines.append(
                    f"{name}_sum{_labels_text(labels)} {_fmt_value(s['sum'])}"
                )
                lines.append(
                    f"{name}_count{_labels_text(labels)} {s['count']}"
                )
            else:
                lines.append(
                    f"{name}{_labels_text(labels)} {_fmt_value(s['value'])}"
                )
    return "\n".join(lines) + "\n"
