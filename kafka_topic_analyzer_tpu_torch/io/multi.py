"""Multi-topic fan-in source (port of the reference's ``io/multi.py``).

The reference analyzes exactly one topic per run.  Fan-in generalizes the
data-parallel axis: each (topic, partition) pair becomes one dense row of
the counter matrix, so T topics scan concurrently through one backend —
across the mesh they shard like any other partitions, and the merged state
yields both per-topic reports (row slices) and a cross-topic union (column
sums / sketch merges, which are associative by design).

`MultiTopicSource` wraps per-topic sources and remaps their true partition
ids into disjoint dense row ranges; `rows_for(topic)` recovers the slice for
per-topic reporting.

**Alive-key semantics under fan-in.**  The alive bitmap's last-writer-wins
update is only well-defined along a single partition's offset order; the
same key living in two topics has no global order (and its rows may land on
different mesh shards), so a raw shared bitmap would give mesh- and
interleaving-dependent counts.  Fan-in therefore *salts* the 32-bit slot
hash per topic (a bijection per topic, preserving within-topic collision
statistics): aliveness is tracked per (topic, key), every slot is owned by
exactly one topic's partitions, and the reported number is the
**sum of per-topic alive keys** — deterministic on any mesh.  The 64-bit
hash is left unsalted: HLL distinct counting is insertion-only (order- and
shard-insensitive), so the distinct-keys line remains a true cross-topic
union.

The salt is applied to the DECODED batch, so this source never declares
``supports_fused_sink``: a fused pass would pack the unsalted slots, and
the alive count would silently become a cross-topic count instead of
the sum of the per-topic ones.  The engine books nothing for it (no
fused capability is hidden) and takes the chained path.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from kafka_topic_analyzer_tpu_torch.io.source import RecordSource
from kafka_topic_analyzer_tpu_torch.records import RecordBatch


def _booked(source: RecordSource, method: str) -> dict:
    """What a topic's source books through ``method``; empty for sources
    that book nothing (synthetic, segment files)."""
    fn = getattr(source, method, None)
    return dict(fn()) if fn is not None else {}


class MultiTopicSource(RecordSource):
    def __init__(self, topic_sources: "list[tuple[str, RecordSource]]"):
        if not topic_sources:
            raise ValueError("need at least one topic")
        names = [t for t, _ in topic_sources]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate topic names in fan-in: {names}")
        if any(not t for t in names):
            raise ValueError("empty topic name in fan-in")
        self.topic_sources = topic_sources
        #: (topic, true_partition) per dense row, topics in given order.
        self.rows: List[Tuple[str, int]] = []
        self._row_of: Dict[Tuple[str, int], int] = {}
        #: Per-topic bijective salt for the 32-bit bitmap slot hash (see
        #: module docstring); topic index 0 keeps the identity so a 1-topic
        #: fan-in behaves exactly like a plain scan.
        self._salt32: Dict[str, int] = {}
        for i, (topic, src) in enumerate(topic_sources):
            from kafka_topic_analyzer_tpu_torch.ops.fnv import splitmix64

            self._salt32[topic] = (splitmix64(i) & 0xFFFFFFFF) if i else 0
            for p in src.partitions():
                self._row_of[(topic, p)] = len(self.rows)
                self.rows.append((topic, p))

    def rows_for(self, topic: str) -> List[int]:
        return [i for i, (t, _) in enumerate(self.rows) if t == topic]

    def true_partition(self, row: int) -> int:
        return self.rows[row][1]

    # -- RecordSource --------------------------------------------------------

    def partitions(self) -> List[int]:
        return list(range(len(self.rows)))

    def watermarks(self) -> Tuple[Dict[int, int], Dict[int, int]]:
        start: Dict[int, int] = {}
        end: Dict[int, int] = {}
        for topic, src in self.topic_sources:
            s, e = src.watermarks()
            for p, v in s.items():
                start[self._row_of[(topic, p)]] = v
            for p, v in e.items():
                end[self._row_of[(topic, p)]] = v
        return start, end

    def offsets_for_timestamp(self, ts_ms: int) -> Dict[int, int]:
        """Per-row first offset with record ts >= ts_ms (broker timestamp
        index per topic, remapped into dense row space)."""
        out: Dict[int, int] = {}
        for topic, src in self.topic_sources:
            for p, off in src.offsets_for_timestamp(ts_ms).items():
                out[self._row_of[(topic, p)]] = off
        return out

    def degraded_partitions(self) -> Dict[int, str]:
        """Degraded rows across the fan-in, keyed by dense row id (the
        partition-id space this source exposes), reasons prefixed with the
        owning topic."""
        out: Dict[int, str] = {}
        for topic, src in self.topic_sources:
            for p, reason in _booked(src, "degraded_partitions").items():
                out[self._row_of[(topic, p)]] = f"{topic}/{p}: {reason}"
        return out

    def corruption_stats(self) -> Dict[int, dict]:
        """Corruption accounting across the fan-in, keyed by dense row id
        like `degraded_partitions`; spans gain ``topic``/``topic_partition``
        so `seed_corrupt_spans` can route them back."""
        out: Dict[int, dict] = {}
        for topic, src in self.topic_sources:
            for p, d in _booked(src, "corruption_stats").items():
                row = self._row_of[(topic, p)]
                d = dict(d, topic=topic)
                d["spans"] = [
                    dict(s, partition=row, topic=topic, topic_partition=p)
                    for s in d.get("spans", [])
                ]
                out[row] = d
        return out

    def corruption_spans(self) -> "list[dict]":
        return [
            dict(
                s,
                partition=self._row_of[(topic, s["partition"])],
                topic=topic,
                topic_partition=s["partition"],
            )
            for topic, src in self.topic_sources
            for s in (getattr(src, "corruption_spans", list)() or [])
        ]

    def seed_corrupt_spans(self, spans: "list[dict]") -> None:
        by_topic: Dict[str, list] = {}
        for s in spans:
            topic = s.get("topic")
            if topic is not None and "topic_partition" in s:
                by_topic.setdefault(topic, []).append(
                    dict(s, partition=int(s["topic_partition"]))
                )
                continue
            row = int(s["partition"])  # pre-fan-in snapshot shape: row id
            if 0 <= row < len(self.rows):
                t, p = self.rows[row]
                by_topic.setdefault(t, []).append(dict(s, partition=p))
        for topic, src in self.topic_sources:
            seed = getattr(src, "seed_corrupt_spans", None)
            if seed is not None and topic in by_topic:
                seed(by_topic[topic])

    def batches(
        self,
        batch_size: int,
        partitions: Optional[List[int]] = None,
        start_at: Optional[Dict[int, int]] = None,
    ) -> Iterator[RecordBatch]:
        rows = partitions if partitions is not None else self.partitions()
        wanted = set(rows)
        for topic, src in self.topic_sources:
            sub_parts = [
                p for p in src.partitions() if self._row_of[(topic, p)] in wanted
            ]
            if not sub_parts:
                continue
            sub_start = None
            if start_at:
                sub_start = {
                    p: start_at[self._row_of[(topic, p)]]
                    for p in sub_parts
                    if self._row_of[(topic, p)] in start_at
                }
            remap = np.full(max(sub_parts) + 1, -1, dtype=np.int32)
            for p in sub_parts:
                remap[p] = self._row_of[(topic, p)]
            salt = np.uint32(self._salt32[topic])
            for batch in src.batches(batch_size, partitions=sub_parts, start_at=sub_start):
                batch.partition = remap[batch.partition]
                if salt:
                    keyed = ~batch.key_null
                    batch.key_hash32 = np.where(
                        keyed, batch.key_hash32 ^ salt, batch.key_hash32
                    )
                yield batch

    def close(self) -> None:
        for _, src in self.topic_sources:
            if hasattr(src, "close"):
                src.close()
