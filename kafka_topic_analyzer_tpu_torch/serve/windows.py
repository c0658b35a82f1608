"""Time-windowed folds: a ring of associatively mergeable window states
(port of the reference's ``serve/windows.py``, numpy only).

The cumulative analyzer state (DESIGN.md §2) answers "what has this topic
ever held"; a service sitting on a live head must also answer "what
changed in the last 5 minutes" — and no cumulative fold can, because its
merges are irreversible (HLL registers max, counters only grow).  So
follow mode runs a second, deliberately small fold layer: wall-clock time
is cut into fixed windows, each window accumulates its own `WindowState`,
and the ring keeps the most recent N of them.  Every per-window fold
obeys the same associative-merge discipline as the main state —

- per-partition record/byte/tombstone counts   merge by +
- per-partition HLL key-cardinality registers  merge by elementwise max
- per-partition log2 size-distribution buckets merge by +

— so "the last K windows" is `merge` over K states in any grouping or
order, windows from different processes could union the same way, and the
merge-unit tests can check associativity/commutativity directly
(tests/test_follow.py).

Feeding: `WindowObserver` wraps the scan's RecordSource and folds every
yielded batch before passing it through untouched — the main fold never
sees a difference (byte-identity holds with windows on or off).  The
observer intentionally does not forward the fused-sink fast path: window
cardinality needs the decoded key hashes, which the fused decode→pack
pass never materializes, so the engine books the bypass on
``kta_fused_fallback_total{reason="source-unfusable"}`` — visible, never
silent — and the scan takes the chained decode path (`engine.fused_gate`
sees the dropped ``sink=`` through its signature check).  Observation takes
one ring lock per batch (parallel-ingest workers call ``batches()``
concurrently) and costs a few bincounts — O(B) numpy, no Python loop.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from kafka_topic_analyzer_tpu_torch.records import RecordBatch

#: log2 size buckets: bucket b holds sizes in [2^(b-1), 2^b), bucket 0
#: holds size 0 (tombstones / null-key records count their actual bytes).
SIZE_BUCKETS = 32


class WindowState:
    """One window's fold: fixed-shape numpy state, associative merge."""

    __slots__ = ("records", "bytes", "tombstones", "hll", "size_hist")

    def __init__(self, num_partitions: int, hll_p: int):
        p = int(num_partitions)
        self.records = np.zeros(p, dtype=np.int64)
        self.bytes = np.zeros(p, dtype=np.int64)
        self.tombstones = np.zeros(p, dtype=np.int64)
        #: Per-partition HLL registers (distinct keys seen this window).
        self.hll = np.zeros((p, 1 << hll_p), dtype=np.uint8)
        #: Per-partition log2 message-size histogram.
        self.size_hist = np.zeros((p, SIZE_BUCKETS), dtype=np.int64)

    @property
    def num_partitions(self) -> int:
        return len(self.records)

    def observe(self, rows: np.ndarray, batch: RecordBatch) -> None:
        """Fold one batch's valid records, pre-mapped to dense ``rows``."""
        p = self.num_partitions
        valid = batch.valid
        rows = rows[valid]
        if len(rows) == 0:
            return
        sizes = (batch.key_len + batch.value_len).astype(np.int64)[valid]
        self.records += np.bincount(rows, minlength=p)
        self.bytes += np.bincount(rows, weights=sizes, minlength=p).astype(
            np.int64
        )
        self.tombstones += np.bincount(
            rows[batch.value_null[valid]], minlength=p
        )
        # log2 buckets: 0 for size 0, else floor(log2(size)) + 1, capped.
        nz = sizes > 0
        buckets = np.zeros(len(sizes), dtype=np.int64)
        # Exact integer floor(log2): sizes are int64 >= 1 here, and
        # float64 represents them exactly up to 2^53 — far above any
        # record size (lengths are int32).
        buckets[nz] = (
            np.floor(np.log2(sizes[nz].astype(np.float64))).astype(np.int64)
            + 1
        )
        np.clip(buckets, 0, SIZE_BUCKETS - 1, out=buckets)
        flat = np.bincount(
            rows * SIZE_BUCKETS + buckets, minlength=p * SIZE_BUCKETS
        )
        self.size_hist += flat.reshape(p, SIZE_BUCKETS)
        # Distinct keys: the same splitmix64 bucket/rho split the scan's
        # cumulative sketch uses (packing.hll_idx_rho_numpy), scatter-max
        # into this window's per-partition registers.
        from kafka_topic_analyzer_tpu_torch.packing import hll_idx_rho_numpy

        keyed = ~batch.key_null[valid]
        hll_p = int(np.log2(self.hll.shape[1]))
        idx, rho = hll_idx_rho_numpy(
            batch.key_hash64[valid][keyed], np.ones(int(keyed.sum()), bool),
            hll_p,
        )
        m = self.hll.shape[1]
        np.maximum.at(
            self.hll.reshape(-1),
            rows[keyed] * m + idx.astype(np.int64),
            rho,
        )

    def merge(self, other: "WindowState") -> "WindowState":
        """Associative, commutative merge — the window-ring algebra."""
        if self.hll.shape != other.hll.shape:
            raise ValueError("window states have different shapes")
        out = WindowState(self.num_partitions, int(np.log2(self.hll.shape[1])))
        out.records = self.records + other.records
        out.bytes = self.bytes + other.bytes
        out.tombstones = self.tombstones + other.tombstones
        out.hll = np.maximum(self.hll, other.hll)
        out.size_hist = self.size_hist + other.size_hist
        return out

    def cardinality(self) -> "List[float]":
        """Per-partition distinct-key estimates from this window's
        registers (ops/hll.py estimator — same math as the main sketch)."""
        from kafka_topic_analyzer_tpu_torch.ops.hll import hll_estimate

        return [
            float(hll_estimate(self.hll[i])) if self.records[i] else 0.0
            for i in range(self.num_partitions)
        ]

    def as_dict(self, partition_ids: "List[int]", span_s: float) -> dict:
        """JSON block for one window (or a merged span of windows)."""
        total = int(self.records.sum())
        card = self.cardinality()
        return {
            "records": total,
            "bytes": int(self.bytes.sum()),
            "rate_per_s": round(total / span_s, 3) if span_s > 0 else 0.0,
            "partitions": {
                str(pid): {
                    "records": int(self.records[i]),
                    "bytes": int(self.bytes[i]),
                    "tombstones": int(self.tombstones[i]),
                    "distinct_keys_est": round(card[i], 1),
                    "size_log2_hist": _trimmed(self.size_hist[i]),
                }
                for i, pid in enumerate(partition_ids)
            },
        }


def _trimmed(hist: np.ndarray) -> "List[int]":
    """Histogram list with the all-zero tail dropped (wire thrift)."""
    nz = np.nonzero(hist)[0]
    if len(nz) == 0:
        return []
    return hist[: int(nz[-1]) + 1].astype(int).tolist()


class WindowRing:
    """The most recent N window states, rotated by wall clock.

    Bounded memory for an unbounded service: one `WindowState` per live
    window, oldest dropped as the clock advances.  ``merged(last=k)``
    answers "the last k·window_secs seconds" via the associative merge;
    ``report()`` renders the JSON block ``/report.json`` embeds.
    Thread-safe: observers fold under one lock (parallel-ingest workers
    call concurrently), readers snapshot under the same lock.
    """

    def __init__(
        self,
        partition_ids: "List[int]",
        window_secs: float = 60.0,
        window_count: int = 8,
        hll_p: int = 10,
        clock: Callable[[], float] = time.monotonic,
    ):
        if window_secs <= 0:
            raise ValueError("window_secs must be > 0")
        if window_count < 1:
            raise ValueError("window_count must be >= 1")
        self.partition_ids = sorted(int(p) for p in partition_ids)
        self._sorted = np.array(self.partition_ids, dtype=np.int64)
        self.window_secs = float(window_secs)
        self.window_count = int(window_count)
        self.hll_p = int(hll_p)
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        #: window index -> state, insertion-ordered, at most window_count.
        self._states: "Dict[int, WindowState]" = {}

    def _window_of(self, now: float) -> int:
        return int((now - self._t0) // self.window_secs)

    def _prune(self, cur: int) -> None:
        """Drop states that have aged out of the ring's horizon — by
        INDEX distance from the current window, not by insertion count:
        quiet periods create no states, so an insertion-count bound would
        let a burst from hours ago linger in 'the last N windows'."""
        floor = cur - self.window_count + 1
        for wi in [w for w in self._states if w < floor]:
            del self._states[wi]

    def _state_for(self, wi: int) -> WindowState:
        st = self._states.get(wi)
        if st is None:
            st = WindowState(len(self.partition_ids), self.hll_p)
            self._states[wi] = st
            self._prune(wi)
        return st

    def observe_batch(self, batch: RecordBatch) -> None:
        rows = np.searchsorted(self._sorted, batch.partition).astype(np.int64)
        with self._lock:
            self._state_for(self._window_of(self._clock())).observe(
                rows, batch
            )

    def merged(self, last: "Optional[int]" = None) -> WindowState:
        """Associative merge of the most recent ``last`` windows (the
        whole ring horizon by default) — "what changed in the last
        last·window_secs seconds"."""
        cur = self._window_of(self._clock())
        with self._lock:
            self._prune(cur)
            floor = cur - (last or self.window_count) + 1
            states = [
                self._states[k] for k in sorted(self._states) if k >= floor
            ]
        acc = WindowState(len(self.partition_ids), self.hll_p)
        for st in states:
            acc = acc.merge(st)
        return acc

    def coverage_s(self) -> float:
        """Seconds of wall clock the ring currently spans: the horizon
        width, clamped to the ring's lifetime.  The honest denominator
        for the merged rate — it COUNTS quiet windows (they are part of
        the observed span even though they hold no state), where summing
        only the populated windows would overstate a bursty topic's rate
        by the empty fraction."""
        now = self._clock()
        return max(1e-9, min(now - self._t0,
                             self.window_count * self.window_secs))

    def report(self) -> dict:
        """The ``windows`` block of ``/report.json``: per-window summaries
        (newest last) plus the merged whole-ring view."""
        now = self._clock()
        cur = self._window_of(now)
        with self._lock:
            self._prune(cur)
            items = sorted(self._states.items())
        windows = []
        for wi, st in items:
            # The open (newest) window's rate denominator is its elapsed
            # fraction, not the full width — else a fresh window reads as
            # an artificial rate dip.
            span = self.window_secs
            if wi == cur:
                span = max(1e-9, (now - self._t0) - wi * self.window_secs)
            doc = st.as_dict(self.partition_ids, span)
            doc["window"] = wi
            doc["start_s"] = round(wi * self.window_secs, 3)
            windows.append(doc)
        merged_doc = self.merged().as_dict(self.partition_ids, self.coverage_s())
        return {
            "window_secs": self.window_secs,
            "window_count": self.window_count,
            "hll_p": self.hll_p,
            "windows": windows,
            "merged": merged_doc,
        }


class WindowObserver:
    """Source wrapper feeding a `WindowRing` from every yielded batch.

    Forwards the full RecordSource surface (watermarks, degradation,
    corruption accessors) by delegation, like io/segfile.TeeSource — but
    deliberately does NOT forward the fused-sink ``sink=`` parameter: the
    window folds need decoded key hashes (see module docstring), and the
    engine's signature check then routes the scan down the chained decode
    path and books the bypass.  Batches pass through unmodified, before
    any in-place remap, so the ring always sees true partition ids.
    """

    def __init__(self, inner, ring: WindowRing, enabled: bool = True):
        self.inner = inner
        self.ring = ring
        #: The follow service starts the observer DISABLED for the
        #: initial catch-up pass and enables it at the first poll
        #: boundary: windows answer "what changed at the live head", and
        #: streaming a year of backlog through the current wall-clock
        #: window would report all of history as having arrived "now"
        #: (rate and cardinality both nonsense until it aged out).
        self.enabled = enabled

    def __getattr__(self, name: str):
        # Everything not overridden (partitions, watermarks,
        # refresh_watermarks, degraded_partitions, corruption accessors,
        # heal_degraded, close, ...) delegates to the wrapped source —
        # including ``supports_fused_sink``, so the engine can SEE the
        # inner source's fused capability and book that this wrapper
        # dropped it (a silent capability mask would hide the bypass).
        return getattr(self.inner, name)

    def batches(
        self,
        batch_size: int,
        partitions=None,
        start_at=None,
    ) -> "Iterator[RecordBatch]":
        for batch in self.inner.batches(
            batch_size, partitions=partitions, start_at=start_at
        ):
            if self.enabled:
                self.ring.observe_batch(batch)
            yield batch
