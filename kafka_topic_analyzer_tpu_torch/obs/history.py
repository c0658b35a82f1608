"""Disk-backed multi-resolution telemetry history (port of the
reference's ``obs/history.py``, the same on-disk format: a store written
by either package is read by the other; DESIGN.md §22).

The flight recorder answers "what is the pipeline doing *right
now*" from an in-memory ring that dies with the process.  A service
meant to follow a topic for days needs the same series to survive a
SIGTERM→restart and to stay queryable over hours without unbounded
memory — this module is that layer: an RRD-style, crash-safe,
append-only time-series store fed from the recorder's tick path
(obs/flight.FlightRecorder.attach_history) and served at ``/history``
on ``--metrics-port``.

Shape of the store (one directory, living NEXT TO the checkpoints —
``checkpoint.history_dir`` — so the series resumes with the state):

- **Tiers of halving resolution.**  Tier 0 receives every appended
  sample.  Every 2 samples of tier k downsample into 1 sample of tier
  k+1 (cumulative tracks keep the LAST value — deltas are preserved
  exactly; instantaneous gauges average), so tier k holds 2^k-coarser
  rows covering 2^k the time span in the same bytes.  A window query
  answers from the finest tier that still retains each sub-range —
  recent history at full resolution, old history coarser, never absent.
- **Append-only segment files, atomic rotation.**  Rows append as JSONL
  lines (write+flush per row — a killed process loses at most the line
  in flight) to ``tier<k>/open.jsonl``; at the segment byte bound the
  open file is ``os.replace``d to its ``seg-<t0>-<t1>.jsonl`` name in
  one atomic rename and a fresh open file starts.  Load tolerates a
  truncated final line (SIGKILL mid-write) by skipping it.
- **Bounded by ``--history-bytes``.**  The byte budget splits evenly
  across tiers; when a tier exceeds its share its OLDEST closed segment
  is deleted — which is exactly the RRD contract: fine-grained history
  ages out first, the coarse tiers keep the long view.
- **Restart continuity without gap misattribution.**  Every row carries
  the store's *epoch* (bumped once per open).  Counters restart from
  zero with the process, so a consumer computing rates must difference
  only within an epoch; the wall-clock gap between the last pre-restart
  row and the first post-restart row stays IN the timeline (quiet-gap
  windows are counted in any rate denominator, never collapsed) — see
  ``track_rate``.  ``window()`` serves the pre-restart rows the moment
  the store reopens.

Timestamps are wall-clock (``time.time``), not monotonic: rows from
different process lifetimes must order on one axis.  The clock is
injectable like Spinner/Backoff so tests never sleep.

Like obs/flight.py, the module-level ``active()``/``set_active()`` pair
registers the session's store for the ``/history`` HTTP handler, which
may only call the ``window`` snapshot accessor (tools/lint.sh rule 9).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Tuple

from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics

log = logging.getLogger(__name__)

META_NAME = "meta.json"
OPEN_NAME = "open.jsonl"

#: Row = (wall_ts, epoch, {track: value}).
Row = Tuple[float, int, Dict[str, float]]


class HistoryStore:
    """One directory of tiered telemetry history.

    ``append`` is called from the flight recorder's sampler thread (4 Hz
    by default): one JSON line + flush per tier touched.  ``window`` is
    the read side — the ``/history`` handler, the trend doctor, and
    tests all consume the same dict shape.
    """

    def __init__(
        self,
        directory: str,
        max_bytes: int = 8 << 20,
        tiers: int = 4,
        clock: Callable[[], float] = time.time,
    ):
        if max_bytes < 4096:
            raise ValueError("--history-bytes must be >= 4096")
        if not (1 <= tiers <= 10):
            raise ValueError("history tiers must be in [1, 10]")
        self.directory = directory
        self.max_bytes = int(max_bytes)
        self.tiers = int(tiers)
        self._clock = clock
        self._lock = threading.Lock()
        self._kinds: Dict[str, str] = {}
        #: Per-tier byte budget; segments rotate at a quarter of it so a
        #: tier always retains >= ~3/4 budget of closed history.
        self._tier_budget = max(1024, self.max_bytes // self.tiers)
        self._seg_bytes = max(512, self._tier_budget // 4)
        #: In-memory mirror of everything retained on disk (bounded by
        #: max_bytes of JSONL, so the decoded rows stay small).
        self._rows: "List[List[Row]]" = [[] for _ in range(self.tiers)]
        #: Closed segments, oldest first: {path, bytes, nrows}.
        self._segments: "List[List[dict]]" = [[] for _ in range(self.tiers)]
        #: Open-file handle / byte count / first row ts per tier.
        self._open_fh: "List[Optional[object]]" = [None] * self.tiers
        self._open_bytes = [0] * self.tiers
        self._open_first: "List[Optional[float]]" = [None] * self.tiers
        self._open_last: "List[Optional[float]]" = [None] * self.tiers
        self._open_rows = [0] * self.tiers
        #: Downsample cascade: the unpaired row of tier k awaiting its
        #: partner (reset on restart — exactness is per-run).
        self._pending: "List[Optional[Row]]" = [None] * self.tiers
        self.epoch = 1
        self._closed = False
        #: Rows appended this process lifetime — with the epoch, the
        #: store's strong cache validator: retention eviction and
        #: downsample cascades only ever happen inside an append, so
        #: (epoch, append_seq) pins the full retained row state.
        self._append_seq = 0
        #: Serialized-query cache keyed by ETag (which embeds the
        #: validator state + query): repeated identical dashboard
        #: queries between appends reuse one encode (DESIGN §26).
        self._query_cache: "Dict[str, bytes]" = {}
        self._load()

    # -- layout ---------------------------------------------------------------

    def _tier_dir(self, k: int) -> str:
        return os.path.join(self.directory, f"tier{k}")

    def _load(self) -> None:
        """Open (or reopen) the directory: bump the epoch, rotate any
        crash-leftover open segment, and mirror the retained rows."""
        os.makedirs(self.directory, exist_ok=True)
        meta_path = os.path.join(self.directory, META_NAME)
        meta: dict = {}
        try:
            with open(meta_path, "r", encoding="utf-8") as f:
                meta = json.load(f)
        except (OSError, ValueError):
            meta = {}
        self.epoch = int(meta.get("epoch", 0)) + 1
        self._kinds = dict(meta.get("kinds", {}))
        self._write_meta()
        for k in range(self.tiers):
            d = self._tier_dir(k)
            os.makedirs(d, exist_ok=True)
            # A leftover open.jsonl is the pre-restart tail: seal it as a
            # closed segment so the pre-restart window stays served.
            leftover = os.path.join(d, OPEN_NAME)
            if os.path.exists(leftover):
                rows, nbytes = self._read_rows(leftover)
                if rows:
                    final = os.path.join(
                        d,
                        f"seg-{int(rows[0][0] * 1000)}"
                        f"-{int(rows[-1][0] * 1000)}.jsonl",
                    )
                    os.replace(leftover, final)
                else:
                    os.unlink(leftover)
            segs = sorted(
                f for f in os.listdir(d)
                if f.startswith("seg-") and f.endswith(".jsonl")
            )
            for name in segs:
                path = os.path.join(d, name)
                rows, nbytes = self._read_rows(path)
                if not rows:
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
                    continue
                self._rows[k].extend(rows)
                self._segments[k].append(
                    {"path": path, "bytes": nbytes, "nrows": len(rows)}
                )
            # The mirror stays in SEGMENT order (filename sort ≈ write
            # order), never globally time-sorted: _enforce_budget drops
            # the oldest segment's rows as a positional prefix, and that
            # invariant must hold even when a wall-clock step between
            # runs makes write order disagree with timestamp order.
            # window() sorts its filtered rows at query time instead.
            self._enforce_budget(k)
            self._open_segment(k)
        self._book_bytes()

    @staticmethod
    def _read_rows(path: str) -> "Tuple[List[Row], int]":
        """Rows of one segment file, tolerating a truncated tail line
        (the crash-in-flight write) and skipping undecodable lines."""
        rows: "List[Row]" = []
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return [], 0
        for line in data.splitlines():
            if not line.strip():
                continue
            try:
                t, epoch, values = json.loads(line)
                rows.append((float(t), int(epoch), dict(values)))
            except (ValueError, TypeError):
                continue  # truncated/corrupt line: skip, keep the rest
        return rows, len(data)

    def _write_meta(self) -> None:
        meta_path = os.path.join(self.directory, META_NAME)
        tmp = meta_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"epoch": self.epoch, "kinds": self._kinds}, f)
        os.replace(tmp, meta_path)

    def _open_segment(self, k: int) -> None:
        self._open_fh[k] = open(
            os.path.join(self._tier_dir(k), OPEN_NAME), "ab"
        )
        self._open_bytes[k] = 0
        self._open_first[k] = None
        self._open_last[k] = None
        self._open_rows[k] = 0

    # -- write side -----------------------------------------------------------

    def register_kinds(self, kinds: Dict[str, str]) -> None:
        """Track kind map ('cum'/'inst') — the downsample policy.  The
        flight recorder registers its tracks at attach time; kinds
        persist in meta.json so a reopened store downsamples new rows
        identically."""
        with self._lock:
            if self._closed:
                return
            self._kinds.update(kinds)
            self._write_meta()

    def append(
        self, values: Dict[str, float], t: "Optional[float]" = None
    ) -> None:
        """Record one sample row (stamped with the store clock unless a
        test injects ``t``).  Lands in tier 0 and cascades coarser."""
        with self._lock:
            if self._closed:
                return
            ts = float(self._clock() if t is None else t)
            self._append_tier(0, (ts, self.epoch, dict(values)))
            self._append_seq += 1
        obs_metrics.HISTORY_SAMPLES.inc()
        self._book_bytes()

    def _append_tier(self, k: int, row: Row) -> None:
        self._rows[k].append(row)
        line = (
            json.dumps(
                [round(row[0], 3), row[1], row[2]],
                separators=(",", ":"),
            ).encode()
            + b"\n"
        )
        fh = self._open_fh[k]
        fh.write(line)
        fh.flush()
        self._open_bytes[k] += len(line)
        self._open_rows[k] += 1
        if self._open_first[k] is None:
            self._open_first[k] = row[0]
        self._open_last[k] = row[0]
        if self._open_bytes[k] >= self._seg_bytes:
            self._rotate(k)
        if k + 1 < self.tiers:
            pend = self._pending[k]
            if pend is None:
                self._pending[k] = row
            else:
                self._pending[k] = None
                self._append_tier(k + 1, self._merge(pend, row))

    def _merge(self, a: Row, b: Row) -> Row:
        """Downsample one pair: cumulative tracks keep the LAST value
        (the delta over the merged span is exact), instantaneous gauges
        average.  Pairs spanning an epoch boundary keep the later row's
        values outright — averaging across a counter reset would invent
        data."""
        values: Dict[str, float] = {}
        for name, vb in b[2].items():
            kind = self._kinds.get(name, "cum")
            va = a[2].get(name)
            if kind == "inst" and va is not None and a[1] == b[1]:
                values[name] = (va + vb) / 2.0
            else:
                values[name] = vb
        return (b[0], b[1], values)

    def _rotate(self, k: int) -> None:
        """Seal the open segment under its span name (one atomic rename)
        and start a fresh one; then enforce the tier's byte budget."""
        fh = self._open_fh[k]
        fh.close()
        path = os.path.join(self._tier_dir(k), OPEN_NAME)
        final = os.path.join(
            self._tier_dir(k),
            f"seg-{int(self._open_first[k] * 1000)}"
            f"-{int(self._open_last[k] * 1000)}.jsonl",
        )
        os.replace(path, final)
        self._segments[k].append(
            {
                "path": final,
                "bytes": self._open_bytes[k],
                "nrows": self._open_rows[k],
            }
        )
        obs_metrics.HISTORY_ROTATIONS.inc()
        self._open_segment(k)
        self._enforce_budget(k)

    def _enforce_budget(self, k: int) -> None:
        while (
            sum(s["bytes"] for s in self._segments[k]) > self._tier_budget
            and len(self._segments[k]) > 1
        ):
            seg = self._segments[k].pop(0)
            try:
                os.unlink(seg["path"])
            except OSError:
                log.warning("history: could not delete %r", seg["path"])
            del self._rows[k][: seg["nrows"]]

    def _book_bytes(self) -> None:
        with self._lock:
            total = sum(
                sum(s["bytes"] for s in self._segments[k])
                + self._open_bytes[k]
                for k in range(self.tiers)
            )
        obs_metrics.HISTORY_BYTES.set(total)

    def close(self) -> None:
        """Flush and close the open files (idempotent).  Open segments
        stay on disk and are sealed by the next open — a SIGKILL without
        close() loses nothing but the line in flight."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for fh in self._open_fh:
                if fh is not None:
                    try:
                        fh.close()
                    except OSError:
                        pass

    # -- read side ------------------------------------------------------------

    def tier_rows(self, k: int) -> "List[Row]":
        """One tier's retained rows (tests/introspection)."""
        with self._lock:
            return list(self._rows[k])

    def _compose(
        self, lo: float, hi: float, min_tier: int
    ) -> "Tuple[List[Row], List[int]]":
        """In-window rows at the finest retained resolution per
        sub-range, starting no finer than ``min_tier`` (callers hold the
        lock)."""
        out: "List[Row]" = []
        covered_from: "Optional[float]" = None
        tiers_used: "List[int]" = []
        for k in range(min_tier, self.tiers):
            # Sorted per query: the mirror keeps write order (the
            # eviction invariant), which a wall-clock step across a
            # restart can decouple from timestamp order.
            rows = sorted(
                (r for r in self._rows[k] if lo <= r[0] <= hi),
                key=lambda r: r[0],
            )
            if not rows:
                continue
            if covered_from is None:
                out = rows
                covered_from = rows[0][0]
                tiers_used.append(k)
            else:
                older = [r for r in rows if r[0] < covered_from]
                if older:
                    out = older + out
                    covered_from = older[0][0]
                    tiers_used.append(k)
        out.sort(key=lambda r: (r[0], r[1]))
        return out, tiers_used

    def _window_locked(
        self,
        t0: "Optional[float]",
        t1: "Optional[float]",
        tracks: "Optional[List[str]]",
        max_points: "Optional[int]",
    ) -> dict:
        lo = float("-inf") if t0 is None else float(t0)
        hi = float("inf") if t1 is None else float(t1)
        out, tiers_used = self._compose(lo, hi, 0)
        decimated = False
        if max_points is not None and 0 < max_points < len(out):
            # Price the query from the existing RRD tiers: drop the
            # finest tiers until the composed window fits — the answer
            # a coarser tier gives is the same downsample policy the
            # store already applies over time, just applied over the
            # whole window.
            for start in range(1, self.tiers):
                coarser, used = self._compose(lo, hi, start)
                if not coarser:
                    break  # coarser tiers hold nothing here yet
                out, tiers_used = coarser, used
                if len(out) <= max_points:
                    break
            if len(out) > max_points:
                # Even the coarsest retained tier exceeds the price:
                # stride-decimate keeping each stride's LAST row (the
                # cum-exact choice, same as the tier cascade).
                stride = -(-len(out) // max_points)
                out = out[stride - 1::stride]
                decimated = True
        names = (
            list(tracks)
            if tracks
            else sorted({n for r in out for n in r[2]})
        )
        doc = {
            "t": [round(r[0], 3) for r in out],
            "epoch": [r[1] for r in out],
            "tracks": {
                name: [r[2].get(name) for r in out] for name in names
            },
            "kinds": {
                n: self._kinds.get(n, "cum") for n in names
            },
            "tiers_used": tiers_used,
            "epoch_now": self.epoch,
            "now": round(self._clock(), 3),
        }
        if max_points is not None:
            doc["max_points"] = int(max_points)
            doc["points"] = len(out)
            doc["decimated"] = decimated
        return doc

    def window(
        self,
        t0: "Optional[float]" = None,
        t1: "Optional[float]" = None,
        tracks: "Optional[List[str]]" = None,
        max_points: "Optional[int]" = None,
    ) -> dict:
        """Windowed query: rows with ``t0 <= t <= t1`` at the finest
        retained resolution per sub-range — tier 0 answers for whatever
        span it still holds, each coarser tier extends the answer
        further back.  ``max_points`` prices the query: the coarsest
        retained tier that satisfies the bound answers instead, so a
        month-wide dashboard query returns kilobytes, not the raw ring.
        The JSON-able result is what ``/history`` serves: one timestamp
        list, one epoch list (restart boundaries are data), and one
        value list per track (None where a row predates the track)."""
        with self._lock:
            return self._window_locked(t0, t1, tracks, max_points)

    @staticmethod
    def _query_key(
        t0: "Optional[float]",
        t1: "Optional[float]",
        tracks: "Optional[List[str]]",
        max_points: "Optional[int]",
    ) -> int:
        key = repr(
            (t0, t1, tuple(tracks) if tracks else None, max_points)
        )
        return zlib.crc32(key.encode())

    def window_etag(
        self,
        t0: "Optional[float]" = None,
        t1: "Optional[float]" = None,
        tracks: "Optional[List[str]]" = None,
        max_points: "Optional[int]" = None,
    ) -> str:
        """Strong validator for one ``/history`` query: (epoch,
        append-seq, query) — any append (which is also the only place
        retention eviction or a downsample cascade can run) moves it.
        O(1); the handler checks If-None-Match against this BEFORE any
        body is built."""
        qh = self._query_key(t0, t1, tracks, max_points)
        with self._lock:
            return f'"h{self.epoch}.{self._append_seq}.{qh:08x}"'

    def window_bytes(
        self,
        t0: "Optional[float]" = None,
        t1: "Optional[float]" = None,
        tracks: "Optional[List[str]]" = None,
        max_points: "Optional[int]" = None,
    ) -> "Tuple[bytes, str]":
        """(body, etag) for ``/history`` — serialized on the STORE side
        (rule 9: handlers serialize nothing), under the store's own
        lock, and cached per validator so identical queries between
        appends reuse one encode.  The body is frozen at first encode
        for its ETag: a 200 and a later 304 for the same validator
        always describe the same bytes."""
        qh = self._query_key(t0, t1, tracks, max_points)
        with self._lock:
            etag = f'"h{self.epoch}.{self._append_seq}.{qh:08x}"'
            body = self._query_cache.get(etag)
            if body is None:
                body = json.dumps(
                    self._window_locked(t0, t1, tracks, max_points)
                ).encode()
                self._query_cache[etag] = body
                while len(self._query_cache) > 32:
                    self._query_cache.pop(next(iter(self._query_cache)))
            return body, etag


# -- window algebra (shared by the trend doctor and the alert rules) ----------


def track_points(
    window: dict, name: str
) -> "List[Tuple[float, int, float]]":
    """(t, epoch, value) points of one track, rows without it skipped."""
    t = window.get("t") or []
    epochs = window.get("epoch") or [1] * len(t)
    series = (window.get("tracks") or {}).get(name) or []
    return [
        (t[i], epochs[i], float(series[i]))
        for i in range(min(len(t), len(series)))
        if series[i] is not None
    ]


def track_delta(window: dict, name: str) -> float:
    """Total increase of a CUMULATIVE track over the window, summing
    within-epoch differences only — a restart's counter reset never
    reads as a negative delta, and the dead time between epochs simply
    contributes nothing (the wall clock still advances, see
    ``track_rate``)."""
    pts = track_points(window, name)
    total = 0.0
    for i in range(1, len(pts)):
        if pts[i][1] == pts[i - 1][1]:
            total += max(0.0, pts[i][2] - pts[i - 1][2])
        else:
            # First row of a new epoch: the counter restarted at 0, so
            # its current value IS the progress since the restart.
            total += max(0.0, pts[i][2])
    return total

def track_rate(window: dict, name: str) -> float:
    """Per-second rate of a cumulative track over the FULL wall span of
    the window — quiet/restart gaps count in the denominator (a scan
    that sat dead for an hour did not sustain its pre-crash rate)."""
    pts = track_points(window, name)
    if len(pts) < 2:
        return 0.0
    span = pts[-1][0] - pts[0][0]
    return track_delta(window, name) / span if span > 0 else 0.0


_active: "Optional[HistoryStore]" = None


def set_active(store: "Optional[HistoryStore]") -> None:
    global _active
    _active = store


def active() -> "Optional[HistoryStore]":
    return _active
