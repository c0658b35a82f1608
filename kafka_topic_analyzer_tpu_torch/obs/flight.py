"""Pipeline flight recorder: synchronized per-stage occupancy time series
(port of the reference's ``obs/flight.py``: the tracks of features the
port lacks read zero; `FlightRecorder.attach_history` feeds the
disk-backed history of ``obs/history.py``).

Every bench round since the superbatch layer landed has diagnosed the
pipeline by hand — BENCH_NOTES rounds 7/9/10/11 each reconstruct a
per-stage ledger from scattered counters to argue whether a scan was
ingest-bound, fold-bound, or tunnel-gated.  This module records the same
signals the ledger was built from, continuously and in one clock domain,
so the attribution can be computed instead of argued (obs/doctor.py).

Design constraints (DESIGN.md §17):

- **Never perturb the pipeline.**  The sampler is a read-only consumer of
  the instruments the hot paths already write (§9): one tick reads ~a
  dozen counter/gauge values — each a lock acquire + a float read — at a
  default 4 Hz.  It takes no pipeline locks, allocates a handful of
  floats per tick, and touches no queue, socket, or device handle.  The
  instruments it reads are booked whether or not a recorder is running
  (notably ``kta_dispatch_throttle_seconds_total``), so switching the
  recorder on changes *observation*, not *behavior* — scans stay
  byte-identical (tests/test_flight.py holds the report equal either
  way, and the drain-throughput referee holds within 2%).
- **Bounded memory for unbounded scans.**  Samples land in a decimating
  ring: when the buffer reaches ``max_samples`` it is thinned 2:1 and
  the sampling interval doubles, so an arbitrarily long scan keeps a
  full-scan-coverage series at progressively coarser resolution instead
  of growing without bound (or silently dropping its head or tail).
- **Clock-injectable** like Spinner/Backoff: tests drive ``sample_once``
  with a fake clock and never sleep.

Tracks are CUMULATIVE registry values (counters, histogram sums) or
INSTANTANEOUS gauges, sampled at one timestamp per tick — deltas between
ticks are the per-window occupancy obs/doctor.py windows verdicts over.
The live series is exported three ways: ``/flight`` on the Prometheus
endpoint (JSON), Chrome counter tracks on the active ``--trace-json``
tracer (``ph: "C"`` events alongside the stage spans), and the windowed
verdict lines of the ``--stats`` BOTTLENECK digest.

Cross-controller: series stay process-local (timestamps from different
hosts don't interleave meaningfully), but every cumulative track reads a
COUNTER, and counters sum across the ``gather_telemetry`` merge — so the
fleet-wide doctor verdict aggregates through the registry algebra, not
through series shipping.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics
from kafka_topic_analyzer_tpu_torch.obs import trace as obs_trace
from kafka_topic_analyzer_tpu_torch.utils.profiling import STAGE_ORDER as _STAGES


def _family_total(family) -> float:
    """Sum of a labeled family's child values (0.0 when no children)."""
    return sum(s["value"] for s in family.samples() if s.get("labels"))


def _hist_sum(hist) -> float:
    return hist.samples()[0]["sum"]


def _default_tracks() -> "List[Tuple[str, str, Callable[[], float]]]":
    """(name, kind, reader) triples.  kind: 'cum' = cumulative (window
    occupancy = delta / window), 'inst' = instantaneous gauge."""
    m = obs_metrics
    tracks: "List[Tuple[str, str, Callable[[], float]]]" = [
        # Drive-loop occupancy (ScanProfile books these live per stage
        # window; the ingest stage IS the consumer's wait-for-batch time).
        *[
            (f"stage_{name}_s", "cum",
             (lambda c=m.STAGE_SECONDS.labels(stage=name): c.value))
            for name in _STAGES
        ],
        # Dispatch backpressure: the launch-site throttle wait, in-flight
        # depth, and the pending superbatch fill.
        ("throttle_s", "cum", lambda: m.DISPATCH_THROTTLE_SECONDS.value),
        ("dispatch_inflight", "inst", lambda: m.DISPATCH_INFLIGHT.value),
        ("superbatch_fill", "inst", lambda: m.SUPERBATCH_FILL.value),
        ("stager_slots", "cum", lambda: m.STAGER_SLOTS.value),
        # Ingest-side occupancy: per-worker stall/active totals and the
        # fan-in queue depth (sum over pools).
        ("worker_stall_s", "cum",
         lambda: _family_total(m.INGEST_WORKER_STALL_SECONDS)),
        ("worker_active_s", "cum",
         lambda: _family_total(m.INGEST_WORKER_ACTIVE_SECONDS)),
        ("ingest_queue_depth", "inst",
         lambda: _family_total(m.INGEST_QUEUE_DEPTH)),
        # Source-side rates: fetch/decode seconds and round/byte counts
        # (io/kafka_wire.py books these per fetch round).
        ("fetch_s", "cum", lambda: m.FETCH_SECONDS.value),
        ("decode_s", "cum", lambda: m.DECODE_SECONDS.value),
        ("fetch_rounds", "cum", lambda: m.FETCH_REQUESTS.value),
        ("fetch_bytes", "cum", lambda: m.FETCH_BYTES.value),
        # Device step/retire latency totals (histogram sums are cumulative
        # seconds — delta/window = device-side busy fraction as seen from
        # the dispatching thread).
        ("step_s", "cum", lambda: _hist_sum(m.BACKEND_STEP_SECONDS)),
        ("retire_s", "cum", lambda: _hist_sum(m.DISPATCH_SECONDS)),
        # Scan progress, so windows carry a records-rate alongside.
        ("records", "cum", lambda: m.SCAN_RECORDS.value),
        # Follow-mode service signals (serve/follow.py): the moving-head
        # lag and the poll/pass cadence, so a service run's flight series
        # shows "how far behind the head" next to the stage occupancies
        # for the life of the service.  Zero-valued lanes for batch scans.
        ("follow_lag", "inst", lambda: m.FOLLOW_LAG.value),
        ("follow_polls", "cum", lambda: m.FOLLOW_POLLS.value),
        ("follow_passes", "cum", lambda: m.FOLLOW_PASSES.value),
        # Service-health lanes (obs/doctor.diagnose_trends + the alert
        # engine's longer baselines): fault/corruption/cache counters
        # whose RATES are what the trend doctor windows verdicts over —
        # retry storms, corruption storms, segstore fallback and
        # cache-poison spikes, and the warm-cache verify residual.
        ("degraded_partitions", "inst",
         lambda: m.DEGRADED_PARTITIONS.value),
        ("refresh_failures", "cum",
         lambda: m.WATERMARK_REFRESH_FAILURES.value),
        ("backoff_sleeps", "cum", lambda: m.BACKOFF_SLEEPS.value),
        ("corrupt_frames", "cum",
         lambda: _family_total(m.CORRUPT_FRAMES)),
        ("segstore_fallbacks", "cum",
         lambda: _family_total(m.SEGSTORE_FALLBACK)),
        ("cache_verify_s", "cum",
         lambda: m.SEGSTORE_CACHE_VERIFY_SECONDS.value),
        ("cache_hit_bytes", "cum",
         lambda: m.SEGSTORE_CACHE_HIT_BYTES.value),
        # Fetch-scheduler occupancy (io/fetchsched.py): queue depth vs
        # in-flight workers vs cumulative queue wait.  The trio is what
        # lets diagnose_trends attribute a fetch-bound stretch to
        # scheduler starvation (queue persistently deeper than the pool
        # — raise --fetch-concurrency) vs wire saturation (pool busy,
        # queue shallow — the link is the limit).
        ("fetch_sched_queue", "inst",
         lambda: m.FETCH_SCHED_QUEUE_DEPTH.value),
        ("fetch_sched_inflight", "inst",
         lambda: m.FETCH_SCHED_INFLIGHT.value),
        ("fetch_sched_wait_s", "cum",
         lambda: m.FETCH_SCHED_WAIT_SECONDS.value),
    ]
    return tracks


class FlightRecorder:
    """Low-overhead occupancy sampler over the default metrics registry.

    ``start()`` runs the sampler on a daemon thread at ``interval_s``;
    tests call ``sample_once()`` directly with an injected clock and
    never start the thread.  ``series()`` returns the JSON-able ring
    contents at any time (the ``/flight`` endpoint serves it live).
    """

    def __init__(
        self,
        interval_s: float = 0.25,
        max_samples: int = 2048,
        clock: Callable[[], float] = time.monotonic,
    ):
        if interval_s <= 0:
            raise ValueError("flight sample interval must be > 0")
        if max_samples < 16:
            raise ValueError("flight ring needs >= 16 samples")
        self.interval_s = float(interval_s)
        self.max_samples = int(max_samples)
        self._clock = clock
        self._t0 = clock()
        self._tracks = _default_tracks()
        self._lock = threading.Lock()
        self._t: List[float] = []
        self._bufs: "List[List[float]]" = [[] for _ in self._tracks]
        #: Samples ever taken — the ring mutates ONLY inside a sample
        #: (appends and the 2:1 decimation both), so this count is the
        #: strong cache validator ``/flight`` conditional GETs revalidate
        #: against, and the key of the one-entry serialized cache below.
        self._samples_total = 0
        self._series_cache: "Optional[Tuple[int, bytes]]" = None
        self._stop = threading.Event()
        self._thread: "Optional[threading.Thread]" = None
        #: Optional disk-backed history sink (obs/history.HistoryStore):
        #: every tick the recorder takes also lands one history row, so
        #: the durable series and the live ring can never disagree about
        #: what a tick saw.  The store has its own lock and directory —
        #: the recorder's read-only-consumer discipline is untouched.
        self._history = None

    def attach_history(self, store) -> "FlightRecorder":
        """Persist every sample into ``store`` (obs/history.HistoryStore),
        registering the track kinds so downsampling follows the same
        cum/inst policy the doctor's window math assumes."""
        store.register_kinds({name: kind for name, kind, _ in self._tracks})
        self._history = store
        return self

    # -- sampling ------------------------------------------------------------

    def sample_once(self) -> None:
        """Take one synchronized sample of every track.  Reads are
        per-instrument lock acquires only — no pipeline state is touched."""
        now = self._clock() - self._t0
        row = [reader() for _, _, reader in self._tracks]
        with self._lock:
            self._t.append(now)
            self._samples_total += 1
            for buf, v in zip(self._bufs, row):
                buf.append(v)
            if len(self._t) > self.max_samples:
                # Decimate 2:1 and double the interval: bounded memory,
                # full-scan coverage, progressively coarser resolution.
                self._t = self._t[::2]
                self._bufs = [buf[::2] for buf in self._bufs]
                self.interval_s *= 2.0
        obs_metrics.FLIGHT_SAMPLES.inc()
        history = self._history
        if history is not None:
            try:
                history.append(
                    {
                        name: row[i]
                        for i, (name, _, _) in enumerate(self._tracks)
                    }
                )
            except Exception:
                # Telemetry is best-effort by contract (obs/events.py):
                # a full disk or vanished directory must neither kill
                # the sampler thread nor fail a finished scan at
                # teardown's closing sample.  Detach the sink — one log
                # line, not one per tick.
                import logging

                logging.getLogger(__name__).exception(
                    "history sink failed; detaching it"
                )
                self._history = None
        tracer = obs_trace.active()
        if tracer is not None:
            # Counter tracks render as stacked area lanes under the stage
            # spans in chrome://tracing / Perfetto.  Instantaneous gauges
            # are the useful live lanes; cumulative tracks would render as
            # ever-growing ramps, so they stay in the /flight series.
            tracer.add_counter(
                "flight",
                {
                    name: row[i]
                    for i, (name, kind, _) in enumerate(self._tracks)
                    if kind == "inst"
                },
            )

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.sample_once()

    def start(self) -> "FlightRecorder":
        if self._thread is not None:
            raise RuntimeError("flight recorder already started")
        self._thread = threading.Thread(
            target=self._run, name="kta-flight-recorder", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the sampler thread (idempotent) and take one closing
        sample so even sub-interval scans record their final state."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self.sample_once()

    # -- export --------------------------------------------------------------

    def series(self) -> dict:
        """JSON-able snapshot of the ring: one timestamp list plus one
        value list per track, with each track's kind ('cum'/'inst')."""
        with self._lock:
            t = list(self._t)
            bufs = [list(b) for b in self._bufs]
        return {
            "interval_s": self.interval_s,
            "t": t,
            "kinds": {name: kind for name, kind, _ in self._tracks},
            "tracks": {
                name: bufs[i]
                for i, (name, _, _) in enumerate(self._tracks)
            },
        }

    def series_etag(self) -> str:
        """Strong validator for ``/flight``: the ring changes only when
        a sample lands, so the sample count pins its contents.  O(1) —
        the handler checks If-None-Match before any body exists."""
        with self._lock:
            return f'"f{self._samples_total}"'

    def series_bytes(self) -> "Tuple[bytes, str]":
        """(body, etag) for ``/flight`` — serialized on the RECORDER
        side (rule 9: handlers serialize nothing) with a one-entry cache
        keyed by the validator, so N dashboard polls between ticks pay
        one encode, not N."""
        with self._lock:
            cached = self._series_cache
            if cached is not None and cached[0] == self._samples_total:
                return cached[1], f'"f{cached[0]}"'
            stamp = self._samples_total
        body = json.dumps(self.series()).encode()
        with self._lock:
            # A tick may have landed during the encode; cache under the
            # stamp the body was built from so the ETag stays truthful
            # (the next poll simply re-encodes).
            self._series_cache = (stamp, body)
        return body, f'"f{stamp}"'


_active: "Optional[FlightRecorder]" = None


def set_active(recorder: "Optional[FlightRecorder]") -> None:
    global _active
    _active = recorder


def active() -> "Optional[FlightRecorder]":
    return _active
