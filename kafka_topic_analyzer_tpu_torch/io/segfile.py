"""Segment-dump files (.ktaseg): columnar on-disk record metadata (port of
the reference's ``io/segfile.py``, its local reader and writer).

The cluster-free path: a topic's record metadata, kept once, re-analysed
at memory bandwidth.  One file per partition (or per rolled chunk of one),
little-endian, columnar, so batches map straight into `RecordBatch`
arrays:

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
    [offsets   i64[count]]  iff flags bit0: set when the offsets have gaps
                            (log compaction), so watermarks stay exact

Files are named ``{topic}-{partition}.ktaseg`` or, for rolled chunks,
``{topic}-{partition}.c{chunk}.ktaseg``; the reader orders a partition's
chunks by start offset.  The bytes are the reference's: each package reads
the other's dumps.  `SegmentDumpWriter` and `TeeSource` write the rolled
chunks of a live scan (``--dump-segments``).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from kafka_topic_analyzer_tpu_torch.io.kafka_codec import CorruptFrameError
from kafka_topic_analyzer_tpu_torch.io.source import RecordSource
from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics
from kafka_topic_analyzer_tpu_torch.records import RecordBatch


class CorruptSegmentError(CorruptFrameError, ValueError):
    """A .ktaseg file whose bytes are wrong, classified like a corrupt
    wire frame; ``path`` names the file, the inherited ``partition`` and
    ``span`` say what the header claims and which bytes are damaged."""

    kind = "corrupt-segment"

    def __init__(self, message: str, *, path: "Optional[str]" = None, **kw):
        super().__init__(message, **kw)
        self.path = path


class TruncatedSegmentError(CorruptSegmentError):
    """The file ends before its header or its declared columns."""

    kind = "truncated"


class MalformedSegmentError(CorruptSegmentError):
    """An impossible header or layout: bad magic, negative count or
    partition, header/file-name disagreement, overlapping chunks."""

    kind = "malformed-header"


MAGIC = b"KTASEG01"
_HEADER = struct.Struct("<8sii qq")  # magic, partition, flags, start, count
HEADER_SIZE = _HEADER.size
FLAG_OFFSETS = 1

#: (column, dtype) in file order; names match RecordBatch fields except
#: ts_ms (milliseconds on disk; RecordBatch carries seconds).
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


def parse_segment_header(header: bytes, path: str) -> "Tuple[int, int, int, int]":
    """Validate and decode one header → (partition, flags, start_offset,
    count)."""
    if len(header) != HEADER_SIZE:
        raise TruncatedSegmentError(
            f"{path}: truncated header ({len(header)} of {HEADER_SIZE} bytes)",
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
            f"{path}: impossible header (partition {partition}, count {count})",
            path=path,
            partition=partition,
            span=(0, HEADER_SIZE),
            num_records=max(count, 0),
        )
    return partition, flags, start_offset, count


def segment_column_layout(
    count: int, flags: int
) -> "Tuple[Dict[str, Tuple[int, np.dtype]], int]":
    """(column → (byte offset, dtype), expected file size) of a chunk with
    this header."""
    col_offsets: Dict[str, Tuple[int, np.dtype]] = {}
    off = HEADER_SIZE
    cols = list(COLUMNS) + ([("offsets", np.int64)] if flags & FLAG_OFFSETS else [])
    for name, dtype in cols:
        col_offsets[name] = (off, np.dtype(dtype))
        off += count * np.dtype(dtype).itemsize
    return col_offsets, off


def check_segment_size(
    actual: int, expected: int, path: str, partition: int, count: int
) -> None:
    """A file shorter than its header's layout is truncated, a longer one
    malformed (trailing garbage)."""
    if actual != expected:
        kind = TruncatedSegmentError if actual < expected else MalformedSegmentError
        raise kind(
            f"{path}: size {actual} != expected {expected} for {count} records",
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
    """Write the batches of one partition as its .ktaseg file."""
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
        partition, flags, start_offset, count = parse_segment_header(header, path)
        self.partition = partition
        self.start_offset = start_offset
        self.count = count
        self.has_offsets = bool(flags & FLAG_OFFSETS)
        self._col_offsets, expected = segment_column_layout(count, flags)
        check_segment_size(os.path.getsize(path), expected, path, partition, count)
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")
        #: Read-only partition and valid columns shared by every batch of
        #: this file (prefix views), sized to the longest span read.
        self._const_partition: "Optional[np.ndarray]" = None
        self._const_valid: "Optional[np.ndarray]" = None

    @property
    def end_offset(self) -> int:
        """One past the last record's offset (exact for gappy dumps)."""
        if self.has_offsets and self.count:
            return int(self.column("offsets", self.count - 1, self.count)[0]) + 1
        return self.start_offset + self.count

    def column(self, name: str, lo: int = 0, hi: Optional[int] = None) -> np.ndarray:
        off, dtype = self._col_offsets[name]
        hi = self.count if hi is None else hi
        return self._mm[off + lo * dtype.itemsize : off + hi * dtype.itemsize].view(dtype)

    def read_batch(self, lo: int, hi: int, copy: bool = False) -> RecordBatch:
        """Rows ``[lo, hi)``, zero-copy by default: the columns are views
        of the mapping (the null flags read as bool in place), partition
        and valid slice the file's constants, and only ``ts_s = ts_ms //
        1000`` is computed.  ``copy=True`` detaches every column."""
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
        # source implements it (the RecordSource base does not).
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
    """The records of a catalog of ``{topic}-{partition}[.cN].ktaseg``
    chunks in a local `segstore.SegmentStore`, each partition's chunks in
    start-offset order.  ``store`` is a store or a ``--segment-dir`` spec.
    An empty catalog exits with the reference's message."""

    def __init__(self, store, topic: str):
        from kafka_topic_analyzer_tpu_torch.io.segstore import (
            SegmentCatalog,
            open_segment_store,
        )

        if isinstance(store, str):
            store = open_segment_store(store)
        self.store = store
        self.topic = topic
        self.catalog = SegmentCatalog(store, topic)
        self.segments: Dict[int, List[SegmentFile]] = self.catalog.segments
        if not self.segments:
            raise SystemExit(f"no {topic}-*.ktaseg files in {store.describe()!r}")

    def partitions(self) -> List[int]:
        return sorted(self.segments)

    def watermarks(self) -> Tuple[Dict[int, int], Dict[int, int]]:
        return self.catalog.watermarks()

    def partition_record_counts(self) -> Dict[int, int]:
        return self.catalog.record_counts()

    #: Chunks feed a fused sink: the mapped columns go straight into rows
    #: (``sink.append_columns``, the ms→s division inside the shim).
    supports_fused_sink = True

    def batches(
        self,
        batch_size: int,
        partitions: Optional[List[int]] = None,
        start_at: Optional[Dict[int, int]] = None,
        sink=None,
    ) -> Iterator[RecordBatch]:
        """Each partition's chunks in turn.  Without ``sink``: zero-copy
        batches of at most ``batch_size`` records, cut per chunk.  With a
        `packing.FusedPackSink`: every chunk in one append, yielding the
        sink's completed `packing.PackedRow`s (rows fill across chunks and
        partitions)."""
        parts = sorted(partitions) if partitions is not None else self.partitions()
        for p in parts:
            resume = start_at.get(p) if start_at else None
            for seg in self.segments[p]:
                first = 0
                if resume is not None:
                    if resume >= seg.end_offset:
                        continue  # the whole chunk lies below the resume point
                    if resume > seg.start_offset:
                        first = (
                            int(np.searchsorted(seg.column("offsets"), resume))
                            if seg.has_offsets
                            else min(resume - seg.start_offset, seg.count)
                        )
                if sink is not None:
                    n = seg.count - first
                    if n <= 0:
                        continue
                    # Batches book at the batch_size cut the chained loop
                    # below would report, so kta_segment_batches_total is
                    # the same whichever path ran.
                    obs_metrics.SEGMENT_RECORDS.inc(n)
                    obs_metrics.SEGMENT_BATCHES.inc(-(-n // batch_size))
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
                        offsets=seg.column("offsets", first) if seg.has_offsets else None,
                    )
                    yield from sink.take_completed()
                else:
                    for lo in range(first, seg.count, batch_size):
                        hi = min(lo + batch_size, seg.count)
                        obs_metrics.SEGMENT_RECORDS.inc(hi - lo)
                        obs_metrics.SEGMENT_BATCHES.inc()
                        yield seg.read_batch(lo, hi)
        if sink is not None:
            sink.flush()
            yield from sink.take_completed()
