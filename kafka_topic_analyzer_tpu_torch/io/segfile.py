"""Segment-dump files (.ktaseg): columnar on-disk record metadata
(port of the reference's ``io/segfile.py``).

A cluster-free ingestion path: scan a topic once (any source — the Kafka
wire client can persist while fetching), keep only the fixed-width metadata
columns the reducers need (SURVEY.md §3.4 — never payload bytes), and re-run
analyses at memory bandwidth.  One file per partition, little-endian,
columnar so batches map straight into `RecordBatch` arrays:

    magic      8s   b"KTASEG01"
    partition  i32
    flags      i32  (bit0: per-record offsets column present)
    start_off  i64  (first offset in the file)
    count      i64
    key_len    i32[count]
    value_len  i32[count]
    key_null   u8 [count]
    value_null u8 [count]
    ts_ms      i64[count]
    key_hash32 u32[count]   (fnv32 reference variant)
    key_hash64 u64[count]
    [offsets   i64[count]]  iff flags bit0 — set when the source's offset
                            space has gaps (log compaction), so watermarks
                            and snapshot resume stay offset-exact

Files are named ``{topic}-{partition}.ktaseg`` or, for rolled dumps of one
partition, ``{topic}-{partition}.c{chunk}.ktaseg`` — the reader orders a
partition's chunks by start offset.
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from kafka_topic_analyzer_tpu_torch.io.kafka_codec import CorruptFrameError
from kafka_topic_analyzer_tpu_torch.io.objstore import SegmentFetchUnavailable
from kafka_topic_analyzer_tpu_torch.io.source import RecordSource
from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics
from kafka_topic_analyzer_tpu_torch.records import RecordBatch


class CorruptSegmentError(CorruptFrameError, ValueError):
    """A .ktaseg file whose *bytes* are wrong — the cold-path analog of the
    wire scan's corrupt-frame taxonomy (io/kafka_codec.py), so operators
    triaging a broken dump see the same classified kinds, with the file
    path in place of the fetch span.  ``ValueError`` stays in the MRO for
    callers that pre-date the classification.

    ``path`` names the damaged file; the inherited ``partition``/``span``
    context fields carry the header's claim and the damaged byte range.
    """

    kind = "corrupt-segment"

    def __init__(self, message: str, *, path: "Optional[str]" = None, **kw):
        super().__init__(message, **kw)
        self.path = path


class TruncatedSegmentError(CorruptSegmentError):
    """The file ends before its header-declared column payload (or before
    the header itself) — an interrupted dump or a partial copy."""

    kind = "truncated"


class MalformedSegmentError(CorruptSegmentError):
    """Structurally impossible header or layout: bad magic, negative
    count/partition, header↔filename disagreement, overlapping chunks."""

    kind = "malformed-header"


MAGIC = b"KTASEG01"
_HEADER = struct.Struct("<8sii qq")  # magic, partition, flags, start, count
HEADER_SIZE = _HEADER.size
FLAG_OFFSETS = 1

#: (column name, dtype) in file order; names match RecordBatch fields except
#: ts_ms (stored at millisecond precision; RecordBatch carries seconds).
COLUMNS = (
    ("key_len", np.int32),
    ("value_len", np.int32),
    ("key_null", np.uint8),
    ("value_null", np.uint8),
    ("ts_ms", np.int64),
    ("key_hash32", np.uint32),
    ("key_hash64", np.uint64),
)


def segment_path(directory: str, topic: str, partition: int) -> str:
    return os.path.join(directory, f"{topic}-{partition}.ktaseg")


def parse_segment_header(
    header: bytes, path: str
) -> "Tuple[int, int, int, int]":
    """Validate + decode one .ktaseg header → (partition, flags,
    start_offset, count).  ONE implementation for every byte source —
    local files, remotely fetched chunk bodies, and the remote catalog's
    ranged header probes — so classification can never diverge by tier."""
    if len(header) != HEADER_SIZE:
        raise TruncatedSegmentError(
            f"{path}: truncated header ({len(header)} of "
            f"{HEADER_SIZE} bytes)",
            path=path,
            span=(0, len(header)),
        )
    magic, partition, flags, start_offset, count = _HEADER.unpack(header)
    if magic != MAGIC:
        raise MalformedSegmentError(
            f"{path}: bad magic {magic!r}", path=path, span=(0, 8)
        )
    if count < 0 or partition < 0:
        raise MalformedSegmentError(
            f"{path}: impossible header (partition {partition}, "
            f"count {count})",
            path=path,
            partition=partition,
            span=(0, HEADER_SIZE),
            num_records=max(count, 0),
        )
    return partition, flags, start_offset, count


def segment_column_layout(
    count: int, flags: int
) -> "Tuple[Dict[str, Tuple[int, np.dtype]], int]":
    """(column name -> (byte offset, dtype), expected total size) for a
    chunk with the given header — the layout every reader shares."""
    col_offsets: Dict[str, Tuple[int, np.dtype]] = {}
    off = HEADER_SIZE
    cols = list(COLUMNS) + (
        [("offsets", np.int64)] if flags & FLAG_OFFSETS else []
    )
    for name, dtype in cols:
        col_offsets[name] = (off, np.dtype(dtype))
        off += count * np.dtype(dtype).itemsize
    return col_offsets, off


def check_segment_size(
    actual: int, expected: int, path: str, partition: int, count: int
) -> None:
    """Classify a chunk whose byte length disagrees with its header's
    column layout: short = truncated (interrupted dump, partial copy or
    fetch), long = malformed (trailing garbage)."""
    if actual != expected:
        kind = (
            TruncatedSegmentError if actual < expected
            else MalformedSegmentError
        )
        raise kind(
            f"{path}: size {actual} != expected {expected} for "
            f"{count} records",
            path=path,
            partition=partition,
            span=(0, actual),
            num_records=count,
        )


def write_segment(
    path: str,
    partition: int,
    start_offset: int,
    columns: Dict[str, np.ndarray],
    offsets: "np.ndarray | None" = None,
) -> None:
    """Write one partition's columns to a .ktaseg file."""
    count = len(columns["key_len"])
    flags = FLAG_OFFSETS if offsets is not None else 0
    with open(path, "wb") as f:
        f.write(_HEADER.pack(MAGIC, partition, flags, start_offset, count))
        for name, dtype in COLUMNS:
            arr = np.ascontiguousarray(columns[name], dtype=dtype)
            if arr.shape != (count,):
                raise ValueError(f"{name}: bad shape {arr.shape}")
            f.write(arr.tobytes())
        if offsets is not None:
            arr = np.ascontiguousarray(offsets, dtype=np.int64)
            if arr.shape != (count,):
                raise ValueError("offsets: bad shape")
            f.write(arr.tobytes())


def write_segment_from_batches(
    directory: str, topic: str, partition: int, batches: "list[RecordBatch]",
    start_offset: int = 0,
) -> str:
    """Convenience writer from RecordBatches of a single partition."""
    full = RecordBatch.concat(batches)
    if not np.all(full.partition == partition):
        raise ValueError("batches contain records of other partitions")
    path = segment_path(directory, topic, partition)
    write_segment(
        path,
        partition,
        start_offset,
        {
            "key_len": full.key_len,
            "value_len": full.value_len,
            "key_null": full.key_null.astype(np.uint8),
            "value_null": full.value_null.astype(np.uint8),
            "ts_ms": full.ts_s * 1000,
            "key_hash32": full.key_hash32,
            "key_hash64": full.key_hash64,
        },
    )
    return path


class SegmentFile:
    """Memory-mapped reader of one .ktaseg file."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            header = f.read(HEADER_SIZE)
        partition, flags, start_offset, count = parse_segment_header(
            header, path
        )
        self.partition = partition
        self.start_offset = start_offset
        self.count = count
        self.has_offsets = bool(flags & FLAG_OFFSETS)
        self._col_offsets, expected = segment_column_layout(count, flags)
        check_segment_size(
            os.path.getsize(path), expected, path, partition, count
        )
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")
        #: Lazily-built constants for the zero-copy read path: every batch
        #: of this file shares one partition/valid array via prefix views.
        #: Sized to the LARGEST SPAN READ (bounded by the scan's batch
        #: size), not the file's record count — a year-scale chunk must
        #: not pin O(file) host RAM for two constant columns.  Marked
        #: read-only so an accidental in-place mutator downstream fails
        #: loudly instead of corrupting sibling batches (the memmap
        #: columns are mode="r" and give the same guarantee).
        self._const_partition: "Optional[np.ndarray]" = None
        self._const_valid: "Optional[np.ndarray]" = None

    @property
    def end_offset(self) -> int:
        """One past the last record's offset (offset-exact for gappy dumps)."""
        if self.has_offsets and self.count:
            return int(self.column("offsets", self.count - 1, self.count)[0]) + 1
        return self.start_offset + self.count

    def column(self, name: str, lo: int = 0, hi: Optional[int] = None) -> np.ndarray:
        off, dtype = self._col_offsets[name]
        hi = self.count if hi is None else hi
        start = off + lo * dtype.itemsize
        stop = off + hi * dtype.itemsize
        return self._mm[start:stop].view(dtype)

    def read_batch(self, lo: int, hi: int, copy: bool = False) -> RecordBatch:
        """Rows [lo, hi) as a RecordBatch — ZERO-COPY by default.

        The int/hash columns and both null flags are direct views of the
        memmap (bool and uint8 share a byte layout, so the flags reinterpret
        in place); partition and valid slice per-file read-only constants.
        The only per-batch allocation is the ms→s timestamp division — the
        one column whose stored unit differs from the batch contract.  The
        cold path packs straight from these views (wire v4 sections copy
        from the mapped pages exactly once, pack_batch ``out=``), so a
        segment scan's per-record byte traffic is file page → packed row.

        ``copy=True`` detaches every column (the pre-catalog behavior) for
        callers that must outlive or mutate the mapping.
        """
        n = hi - lo
        if self._const_partition is None or len(self._const_partition) < n:
            part = np.full(n, self.partition, dtype=np.int32)
            part.flags.writeable = False
            ones = np.ones(n, dtype=np.bool_)
            ones.flags.writeable = False
            self._const_partition, self._const_valid = part, ones
        batch = RecordBatch(
            partition=self._const_partition[:n],
            key_len=self.column("key_len", lo, hi),
            value_len=self.column("value_len", lo, hi),
            key_null=self.column("key_null", lo, hi).view(np.bool_),
            value_null=self.column("value_null", lo, hi).view(np.bool_),
            ts_s=self.column("ts_ms", lo, hi) // 1000,
            key_hash32=self.column("key_hash32", lo, hi),
            key_hash64=self.column("key_hash64", lo, hi),
            valid=self._const_valid[:n],
        )
        if self.has_offsets:
            batch.offsets = self.column("offsets", lo, hi)
        return batch.copy() if copy else batch


class RemoteSegmentFile(SegmentFile):
    """One object-store chunk, open for reading (DESIGN.md §21).

    The catalog opens it from a ranged HEADER probe alone — validation
    (header decode, size-vs-layout check against the LIST size, overlap
    ordering) never downloads a chunk body.  The body arrives lazily, the
    first time a column is touched (``ensure_body``): cache → verified
    fetch → ``np.frombuffer``, after which every inherited read path —
    ``column`` views, ``read_batch`` zero-copy semantics, the fused
    ``append_columns`` feed — works byte-for-byte like the memory-mapped
    local file, because ``_mm`` is the same uint8 array shape over the
    same bytes (a verified cache hit arrives as the cache file's memmap —
    zero-copy straight through).  ``release()`` drops the body reference
    once the stream has consumed the chunk (outstanding batch views keep
    the buffer alive through numpy's base refcount) and best-effort
    cancels a scheduler request for it that never started — degraded-skip
    paths must not pay for bytes nobody will read — bounding a stream's
    resident memory to readahead + 1 chunks.

    Acquisition failures are CACHED on the file: a scheduler worker that
    hit a deterministic failure (classified corruption, exhausted retry
    budget) must hand the consumer exactly that failure, not trigger a
    second fetch cycle.
    """

    def __init__(
        self,
        fetch_body: "Callable[[Callable[[bytes], None]], bytes]",
        name: str,
        location: str,
        size: int,
        header: bytes,
        end_offset: "Optional[int]" = None,
    ):
        # Deliberately no super().__init__: there is no local path to map.
        self.path = f"{location.rstrip('/')}/{name}"
        self.name = name
        partition, flags, start_offset, count = parse_segment_header(
            header, self.path
        )
        self.partition = partition
        self.start_offset = start_offset
        self.count = count
        self.has_offsets = bool(flags & FLAG_OFFSETS)
        self._header = header
        self._col_offsets, expected = segment_column_layout(count, flags)
        check_segment_size(size, expected, self.path, partition, count)
        self._expected_size = expected
        self._fetch_body = fetch_body
        self._end = end_offset
        self._lock = threading.Lock()
        self._data: "Optional[np.ndarray]" = None
        self._failure: "Optional[BaseException]" = None
        #: The fetch scheduler ticket covering this chunk's body, while
        #: one is queued or in flight (set by the read-ahead window so
        #: release() can cancel a fetch that never started).
        self._pending = None
        self._const_partition = None
        self._const_valid = None

    @property
    def end_offset(self) -> int:
        """Offset-exact for gappy chunks WITHOUT a body fetch: the store
        probed the trailing offsets entry (suffix range) at open time."""
        if self._end is not None:
            return self._end
        return self.start_offset + self.count

    @property
    def _mm(self) -> np.ndarray:
        return self.ensure_body()

    def ensure_body(self) -> np.ndarray:
        """The chunk's bytes, fetching (cache → store, verified) on first
        touch.  Thread-safe: a scheduler worker and the consuming stream
        serialize on the per-chunk lock, so the consumer blocks on an
        in-flight prefetch instead of fetching twice."""
        with self._lock:
            if self._failure is not None:
                raise self._failure
            if self._data is None:
                try:
                    raw = self._fetch_body(self._validate_body)
                except (CorruptSegmentError, SegmentFetchUnavailable) as e:
                    self._failure = e  # deterministic: replay, don't refetch
                    raise
                # A verified cache hit is already a uint8 memmap view —
                # keep it zero-copy; a transport body is bytes.
                self._data = (
                    raw if isinstance(raw, np.ndarray)
                    else np.frombuffer(raw, dtype=np.uint8)
                )
            return self._data

    def _validate_body(self, raw: bytes) -> None:
        """Classify FETCHED bytes with the exact local-reader taxonomy:
        short body = truncated, header bytes that no longer decode (or
        disagree with what the catalog validated) = malformed.  The store
        disambiguates in-flight vs at-rest damage around this (one
        re-fetch — io/kafka_wire.py's rule)."""
        if len(raw) < HEADER_SIZE:
            raise TruncatedSegmentError(
                f"{self.path}: fetched body holds {len(raw)} of "
                f"{HEADER_SIZE} header bytes",
                path=self.path,
                partition=self.partition,
                span=(0, len(raw)),
            )
        header = bytes(raw[:HEADER_SIZE])
        parse_segment_header(header, self.path)
        if header != self._header:
            raise MalformedSegmentError(
                f"{self.path}: fetched header disagrees with the "
                "catalog-validated header — object changed or damaged "
                "since the catalog opened it",
                path=self.path,
                partition=self.partition,
                span=(0, HEADER_SIZE),
                num_records=self.count,
            )
        check_segment_size(
            len(raw), self._expected_size, self.path, self.partition,
            self.count,
        )

    def release(self) -> None:
        """Drop the body reference (batch views already handed out keep
        the underlying buffer alive; new touches re-fetch via the cache),
        and cancel a scheduler request for this chunk that has not
        started yet (booked on ``kta_fetch_sched_cancelled_total``) —
        the degraded-skip and teardown paths must not pay for bytes
        nobody will read.

        BEST-EFFORT: ``ensure_body`` holds the per-chunk lock for the
        whole fetch (socket timeout + backoff sleeps), and release is
        called from teardown paths — the degraded-partition skip and the
        end-of-stream sweep — that must never stall tens of seconds
        behind a scheduler worker stuck in a hung request.  If the lock
        is busy, the in-flight fetch owns the body's lifetime; memory
        stays bounded by the read-ahead window either way."""
        ticket, self._pending = self._pending, None
        if ticket is not None:
            ticket.cancel()  # no-op once running/done; booked if it lands
        if self._lock.acquire(blocking=False):
            try:
                self._data = None
            finally:
                self._lock.release()


class _ScheduledReadahead:
    """One stream's read-ahead WINDOW over the process-wide fetch
    scheduler (``--segment-readahead N`` · io/fetchsched.py).

    The stream no longer owns a thread pool: it registers a `FetchStream`
    with the shared scheduler and keeps chunks [i, i+N] of its plan
    *submitted* — the head of the window (the chunk the decoder will need
    next) at DEMAND class, the rest speculative.  The scheduler's
    admission policy does the rest: demand beats speculation
    process-wide, streams round-robin within a class, and the worker
    count is ``--fetch-concurrency`` no matter how many streams run.
    Workers never surface errors: a failed prefetch parks the failure on
    its chunk (``RemoteSegmentFile.ensure_body`` — cache-aware,
    failure-caching), and the consumer re-raises it at the chunk's
    position in the stream — ordering, degradation, and corruption
    semantics are exactly the synchronous path's.

    In-flight chunk memory stays bounded at (N + 1) chunks per stream:
    only submitted-window bodies can materialize, and the consumer
    releases each chunk as it passes.
    """

    def __init__(self, depth: int):
        from kafka_topic_analyzer_tpu_torch.io.fetchsched import get_scheduler

        self.depth = depth
        self._stream = get_scheduler().stream()
        self._tickets: "Dict[int, object]" = {}
        self._submitted: "set[int]" = set()
        self._consumed: "set[int]" = set()
        self._weighted = False

    @staticmethod
    def _prefetch(seg: "RemoteSegmentFile") -> None:
        try:
            seg.ensure_body()
        except Exception:
            pass  # parked on the segment; the consumer re-raises in order

    def schedule(self, plan, i: int, degraded: "Dict[int, str]") -> None:
        """Keep chunks [i, i+N] of the plan submitted (skipping local
        chunks and partitions already degraded this scan).  Chunk i — the
        one the consumer is about to block on — submits at DEMAND class;
        the look-ahead tail is speculative."""
        if not self._weighted:
            # Weighted admission (DESIGN §25): this stream's fair share
            # of the wire is proportional to how much it still has to
            # fetch — the plan's chunk count (≈ partitions × segments).
            # Registered once, at the first schedule, when the plan is
            # first known.
            self._weighted = True
            self._stream.set_weight(max(1.0, float(len(plan))))
        for j in range(i, min(i + self.depth + 1, len(plan))):
            if j in self._submitted:
                continue
            self._submitted.add(j)
            p, seg, _first = plan[j]
            if p in degraded or not isinstance(seg, RemoteSegmentFile):
                self._consumed.add(j)
                continue
            obs_metrics.SEGSTORE_READAHEAD.inc(1)
            ticket = self._stream.submit(
                lambda s=seg: self._prefetch(s),
                seq=j,
                speculative=(j != i),
            )
            self._tickets[j] = ticket
            seg._pending = ticket  # so release() can cancel a queued fetch

    def claim(self, i: int) -> None:
        """The consumer is blocked on chunk i NOW: promote its request to
        DEMAND if it is still queued behind speculative work (booked as a
        deadline reorder) and wait for the worker to finish it.  The
        subsequent ``ensure_body`` then finds the body — or the parked
        failure — without fetching twice (per-chunk lock)."""
        ticket = self._tickets.get(i)
        if ticket is not None:
            self._stream.demand(ticket)

    def done(self, i: int) -> None:
        """The consumer reached chunk i: it no longer counts as ahead."""
        if i in self._submitted and i not in self._consumed:
            self._consumed.add(i)
            obs_metrics.SEGSTORE_READAHEAD.inc(-1)
        self._tickets.pop(i, None)

    def close(self) -> None:
        for j in self._submitted - self._consumed:
            self._consumed.add(j)
            obs_metrics.SEGSTORE_READAHEAD.inc(-1)
        self._tickets.clear()
        # Unregisters the stream from the scheduler: queued requests are
        # cancelled (booked), in-flight ones finish on their workers.
        self._stream.close()


class SegmentDumpWriter:
    """Incrementally dump a scan's record metadata into rolled .ktaseg
    chunks (``{topic}-{p}.c{N}.ktaseg``), one writer shared by a whole scan.

    Buffers per partition and rolls a chunk to disk every
    ``records_per_chunk`` records, so memory stays bounded regardless of
    topic size.  Thread-safe across per-shard prefetch threads because each
    partition is fed by exactly one shard (records.py contract) — state is
    per partition.
    """

    def __init__(self, directory: str, topic: str, records_per_chunk: int = 1 << 18):
        os.makedirs(directory, exist_ok=True)
        # Refuse a directory that already holds this topic's segments: a
        # shorter re-dump would leave stale chunks behind, and the reader
        # would silently merge old and new records.  Same name pattern as
        # the reader's enumeration (segstore), so the staleness check can
        # never desync from what a later scan would pick up.
        from kafka_topic_analyzer_tpu_torch.io.segstore import topic_chunk_pattern

        pattern = topic_chunk_pattern(topic)
        stale = [f for f in os.listdir(directory) if pattern.match(f)]
        if stale:
            raise ValueError(
                f"{directory!r} already contains {len(stale)} segment file(s) "
                f"for topic {topic!r} (e.g. {stale[0]}) — remove them or "
                "choose another directory"
            )
        self.directory = directory
        self.topic = topic
        self.records_per_chunk = records_per_chunk
        self._buf: Dict[int, List[RecordBatch]] = {}
        self._buffered: Dict[int, int] = {}
        self._chunk_idx: Dict[int, int] = {}
        self._written: Dict[int, int] = {}
        #: True start offsets of the source (set via set_base_offsets):
        #: offset-less (gapless) sources may still start above 0 after
        #: retention, and chunk headers must not silently rebase to 0.
        self._base: Dict[int, int] = {}

    def set_base_offsets(self, start_offsets: Dict[int, int]) -> None:
        self._base.update(start_offsets)

    def append(self, batch: RecordBatch) -> None:
        valid = batch.valid
        if not valid.all():
            batch = batch.take(np.nonzero(valid)[0])
        for p in np.unique(batch.partition):
            sub = batch.take(np.nonzero(batch.partition == p)[0])
            p = int(p)
            self._buf.setdefault(p, []).append(sub)
            self._buffered[p] = self._buffered.get(p, 0) + len(sub)
            if self._buffered[p] >= self.records_per_chunk:
                self._flush(p)

    def _flush(self, p: int) -> None:
        batches = self._buf.pop(p, [])
        self._buffered[p] = 0
        if not batches:
            return
        full = RecordBatch.concat(batches)
        idx = self._chunk_idx.get(p, 0)
        self._chunk_idx[p] = idx + 1
        path = os.path.join(self.directory, f"{self.topic}-{p}.c{idx}.ktaseg")
        # Offset-carrying sources: the first record's true offset; gapless
        # sources: the source's start offset plus records already written.
        start = (
            int(full.offsets[0])
            if full.offsets is not None
            else self._base.get(p, 0) + self._written.get(p, 0)
        )
        self._written[p] = self._written.get(p, 0) + len(full)
        write_segment(
            path,
            p,
            start,
            {
                "key_len": full.key_len,
                "value_len": full.value_len,
                "key_null": full.key_null.astype(np.uint8),
                "value_null": full.value_null.astype(np.uint8),
                "ts_ms": full.ts_s * 1000,
                "key_hash32": full.key_hash32,
                "key_hash64": full.key_hash64,
            },
            offsets=full.offsets,
        )

    def close(self) -> None:
        for p in list(self._buf):
            self._flush(p)


class TeeSource(RecordSource):
    """Wraps a source and dumps every yielded batch through a
    `SegmentDumpWriter` — scan once from Kafka, re-analyze forever from
    segments (``--dump-segments``)."""

    def __init__(self, inner: RecordSource, writer: SegmentDumpWriter):
        self.inner = inner
        self.writer = writer

    def partitions(self):
        return self.inner.partitions()

    def watermarks(self):
        return self.inner.watermarks()

    def is_empty(self):
        return self.inner.is_empty()

    def offsets_for_timestamp(self, ts_ms: int):
        return self.inner.offsets_for_timestamp(ts_ms)

    def degraded_partitions(self):
        return self.inner.degraded_partitions()

    def corruption_stats(self):
        return self.inner.corruption_stats()

    def corruption_spans(self):
        return self.inner.corruption_spans()

    def seed_corrupt_spans(self, spans):
        # The engine discovers this by hasattr; forward only when the inner
        # source actually implements it (the RecordSource base does not).
        seed = getattr(self.inner, "seed_corrupt_spans", None)
        if seed is not None:
            seed(spans)

    def batches(self, batch_size, partitions=None, start_at=None):
        self.writer.set_base_offsets(self.inner.watermarks()[0])
        for batch in self.inner.batches(batch_size, partitions, start_at):
            self.writer.append(batch)
            yield batch

    def close(self):
        self.writer.close()
        if hasattr(self.inner, "close"):
            self.inner.close()


class SegmentFileSource(RecordSource):
    """RecordSource over a catalog of {topic}-{partition}[.cN].ktaseg
    chunks in a SegmentStore (a local directory today — io/segstore.py is
    the object-store seam); a partition's chunks are ordered by start
    offset.

    This is the first-class cold path: with ``--ingest-workers N`` the
    engine shards the catalog's partitions over N decode→pack workers
    (record-count-balanced via `partition_record_counts`), each draining
    its own ``batches()`` stream — safe because distinct partitions touch
    distinct SegmentFiles, so workers never share mutable reader state,
    and exact for the same reason the wire fan-in is (DESIGN.md §11: each
    partition's records travel one worker's stream in offset order).
    """

    def __init__(self, store, topic: str, fetch=None):
        from kafka_topic_analyzer_tpu_torch.config import SegmentFetchConfig
        from kafka_topic_analyzer_tpu_torch.io.segstore import (
            SegmentCatalog,
            open_segment_store,
        )

        fetch = fetch if fetch is not None else SegmentFetchConfig()
        if isinstance(store, str):
            store = open_segment_store(store, fetch=fetch)
        self.store = store
        self.topic = topic
        remote = bool(getattr(store, "is_remote", False))
        if remote:
            # Size the ONE process-wide fetch scheduler before the catalog
            # fans out its header probes through it.  An explicit
            # --fetch-concurrency pins the pool; auto lets the engine's
            # resolved stream count grow it (fetchsched.note_streams).
            from kafka_topic_analyzer_tpu_torch.io import fetchsched

            concurrency = fetch.resolve_concurrency()
            if concurrency is not None:
                fetchsched.configure(concurrency, explicit=True)
        self.catalog = SegmentCatalog(store, topic)
        self.segments: Dict[int, List[SegmentFile]] = self.catalog.segments
        #: Per-stream read-ahead WINDOW (0 = demand-only, no speculation;
        #: resolves to 0 for local stores, where there is nothing to
        #: hide).  The process-wide fetch scheduler supplies the workers.
        self.readahead = fetch.resolve_readahead(remote)
        #: partition -> reason, for partitions dropped mid-scan after their
        #: chunk fetches exhausted the transport retry budget (the wire
        #: scan's degraded surface, shared across parallel-ingest worker
        #: streams).
        self._degraded: Dict[int, str] = {}
        self._degraded_lock = threading.Lock()
        if not self.segments:
            raise SystemExit(
                f"no {topic}-*.ktaseg files in {store.describe()!r}"
            )

    def partitions(self) -> List[int]:
        return sorted(self.segments)

    def close(self) -> None:
        """Release every remote chunk body this catalog still holds (and
        cancel their queued scheduler requests) — fleet teardown and
        per-topic failure paths must stop a finished source from pinning
        memory or competing for the shared fetch pool.  Local memmaps
        need nothing: pages un-fault on their own."""
        for chunks in self.segments.values():
            for seg in chunks:
                if isinstance(seg, RemoteSegmentFile):
                    seg.release()

    def degraded_partitions(self) -> Dict[int, str]:
        return dict(self._degraded)

    def _note_degraded(self, partition: int, reason: str) -> None:
        """Drop ``partition`` from the rest of the scan (its remaining
        chunks are skipped) and record why — the engine reports it and
        exits EXIT_DEGRADED, exactly like a wire partition past its
        budget.  Lock-guarded: worker streams share this map."""
        with self._degraded_lock:
            self._degraded.setdefault(partition, reason)

    def watermarks(self) -> Tuple[Dict[int, int], Dict[int, int]]:
        return self.catalog.watermarks()

    def partition_record_counts(self) -> Dict[int, int]:
        """Exact retained records per partition (catalog metadata) — the
        engine balances parallel-ingest workers by these instead of by
        partition count, since cold catalogs know their sizes up front."""
        return self.catalog.record_counts()

    #: Cold chunks can feed the fused decode→pack sink: the memmap column
    #: views go straight into wire-v4 rows (sink.append_columns — the
    #: ms→s divide happens inside the native appender), skipping both the
    #: RecordBatch view layer and the separate pack pass.
    supports_fused_sink = True

    def batches(
        self,
        batch_size: int,
        partitions: Optional[List[int]] = None,
        start_at: Optional[Dict[int, int]] = None,
        sink=None,
    ) -> Iterator[RecordBatch]:
        parts = sorted(partitions) if partitions is not None else self.partitions()
        # Sequential per-partition chunks: fastest IO pattern, and the order
        # contract only requires per-partition offset order.  The plan is
        # materialized up front so the read-ahead pool can see (and start
        # fetching) the chunks BEHIND the one the stream is consuming.
        # (Resume into a gappy remote chunk touches its offsets column —
        # one synchronous body fetch, cache-served on a re-resume.)
        plan: "List[Tuple[int, SegmentFile, int]]" = []
        for p in parts:
            resume = start_at.get(p) if start_at else None
            for seg in self.segments[p]:
                first = 0
                if resume is not None:
                    if resume >= seg.end_offset:
                        continue  # chunk fully below the resume point
                    if resume > seg.start_offset:
                        # Only the ONE chunk straddling the resume point
                        # needs its offsets column (a synchronous body
                        # fetch on remote stores — admitted through the
                        # shared scheduler as a demand request, like
                        # every other remote byte); chunks entirely above
                        # the resume point start at record 0 — probing
                        # them too would download every remaining chunk
                        # at plan time and pin them all in memory.
                        if seg.has_offsets:
                            try:
                                if isinstance(seg, RemoteSegmentFile):
                                    from kafka_topic_analyzer_tpu_torch.io import (
                                        fetchsched,
                                    )

                                    fetchsched.get_scheduler().run(
                                        seg.ensure_body
                                    )
                                offs = np.asarray(seg.column("offsets"))
                            except SegmentFetchUnavailable as e:
                                # Plan-time fetches degrade like consumer
                                # ones: drop the partition, keep scanning.
                                self._note_degraded(p, str(e))
                                break
                            first = int(np.searchsorted(offs, resume))
                        else:
                            first = min(
                                max(resume - seg.start_offset, 0), seg.count
                            )
                plan.append((p, seg, first))
        pool = None
        if any(isinstance(seg, RemoteSegmentFile) for _, seg, _ in plan):
            # EVERY remote plan routes through the shared scheduler —
            # readahead 0 just shrinks the window to demand-only
            # (chunk i submits at DEMAND class, nothing speculates).
            pool = _ScheduledReadahead(self.readahead)
        try:
            for i, (p, seg, first) in enumerate(plan):
                if p in self._degraded:
                    if pool is not None:
                        pool.done(i)
                    if isinstance(seg, RemoteSegmentFile):
                        # A chunk the pool prefetched before its partition
                        # degraded must not stay pinned in memory for the
                        # rest of the stream.
                        seg.release()
                    continue  # budget exhausted earlier in this stream
                if pool is not None:
                    pool.schedule(plan, i, self._degraded)
                try:
                    if isinstance(seg, RemoteSegmentFile):
                        # Materialize the body HERE, before any records are
                        # booked or appended: a chunk either enters the
                        # scan whole or degrades its partition cleanly.
                        # claim() first — if the chunk's request is still
                        # queued behind speculative work, promote it to
                        # demand class (the deadline rule) and ride the
                        # worker's fetch instead of starting a second one.
                        if pool is not None:
                            pool.claim(i)
                        seg.ensure_body()
                except SegmentFetchUnavailable as e:
                    # The transport budget for this partition ran out:
                    # drop it from the scan and keep going — the engine
                    # reports the degraded set (graceful degradation,
                    # io/retry.py), exactly like a dead wire partition.
                    self._note_degraded(p, str(e))
                    if pool is not None:
                        pool.done(i)
                    seg.release()
                    continue
                if pool is not None:
                    pool.done(i)
                if sink is not None:
                    # Fused cold path: the whole chunk's column views in
                    # one native append (chunk bytes → packed row; the sink
                    # cuts batch_size rows itself).  ts_mode=1 is the
                    # reader's ``ts_ms // 1000`` rule.  Batches book at
                    # the batch_size-cut count the chained loop below
                    # would have reported, so kta_segment_batches_total
                    # stays comparable whichever path engaged.
                    n = seg.count - first
                    if n <= 0:
                        continue
                    obs_metrics.SEGMENT_RECORDS.inc(n)
                    obs_metrics.SEGMENT_BATCHES.inc(
                        -(-n // batch_size)
                    )
                    sink.append_columns(
                        seg.partition,
                        seg.column("key_len", first),
                        seg.column("value_len", first),
                        seg.column("key_null", first),
                        seg.column("value_null", first),
                        seg.column("ts_ms", first),
                        seg.column("key_hash32", first),
                        seg.column("key_hash64", first),
                        n,
                        ts_mode=1,
                        offsets=(
                            seg.column("offsets", first)
                            if seg.has_offsets else None
                        ),
                    )
                    yield from sink.take_completed()
                else:
                    for lo in range(first, seg.count, batch_size):
                        hi = min(lo + batch_size, seg.count)
                        obs_metrics.SEGMENT_RECORDS.inc(hi - lo)
                        obs_metrics.SEGMENT_BATCHES.inc()
                        yield seg.read_batch(lo, hi)
                if isinstance(seg, RemoteSegmentFile):
                    # Consumed: drop the stream's body reference (views
                    # already yielded keep the buffer alive; memory stays
                    # bounded at readahead + 1 chunks per stream).
                    seg.release()
        finally:
            if pool is not None:
                pool.close()
                # Sweep bodies the pool prefetched but the consumer never
                # reached (early generator close, errors): best-effort —
                # a fetch still racing in a pool thread may repopulate
                # its one chunk after this, bounded by the pool depth.
                for _, seg, _ in plan:
                    if isinstance(seg, RemoteSegmentFile):
                        seg.release()
        if sink is not None:
            sink.flush()
            yield from sink.take_completed()
