"""CPU-exact oracle backend (vectorized numpy; port of the reference's
``backends/cpu.py`` with its semantics: ``--backend cpu``).  Faster on a
2^20 batch: one scatter-add per channel, exact distinct keys kept only
when a distinct count is reported (in one set unless per partition),
the size histogram in sorted numpy arrays rather than a dict filled in a
Python loop, and each bitmap slot's last writer found by one sort.  It folds decoded
`RecordBatch`es only — no packed rows, no fused sink — and imports
nothing of torch, so an oracle scan never touches a device.

Reproduces the reference's accumulator semantics exactly (src/metric.rs:
207-252 per-message update; src/metric.rs:262-305 alive-key bitset including
fnv32 collision behavior) but over batches.  This backend is the referee for
every TPU claim: counters must match it bit-for-bit, sketches within their
error budget (SURVEY.md §4).

It deliberately shares no array code with the TPU backend — an independent
implementation is what makes parity tests meaningful.
"""

from __future__ import annotations

import numpy as np

from kafka_topic_analyzer_tpu_torch.backends.base import MetricBackend, instrument_steps
from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig
from kafka_topic_analyzer_tpu_torch.records import RecordBatch
from kafka_topic_analyzer_tpu_torch.results import (
    COUNTER_CHANNELS,
    QUANTILE_PROBS,
    QuantileSummary,
    TopicMetrics,
    finalize_extremes,
)
from kafka_topic_analyzer_tpu_torch.utils.timefmt import utc_now_seconds


def _exact_quantiles(sizes: np.ndarray, counts: np.ndarray) -> QuantileSummary:
    """Exact quantiles of a (size -> count) histogram (sizes sorted)."""
    if len(sizes) == 0:
        return QuantileSummary(
            list(QUANTILE_PROBS), [float("nan")] * len(QUANTILE_PROBS)
        )
    order = np.argsort(sizes)
    sizes = sizes[order]
    counts = counts[order]
    cum = np.cumsum(counts)
    total = int(cum[-1])
    vals = []
    for q in QUANTILE_PROBS:
        rank = max(0, min(total - 1, int(np.ceil(q * total)) - 1))
        vals.append(float(sizes[int(np.searchsorted(cum, rank + 1))]))
    return QuantileSummary(list(QUANTILE_PROBS), vals)


@instrument_steps
class CpuExactBackend(MetricBackend):
    def __init__(self, config: AnalyzerConfig, init_now_s: "int | None" = None):
        super().__init__(config)
        p = config.num_partitions
        self.per_partition = np.zeros((p, len(COUNTER_CHANNELS)), dtype=np.int64)
        # Reference init values: earliest=now, latest=epoch, smallest=u64::MAX,
        # largest=0 (src/metric.rs:40-43).  We keep "unset" sentinels (per
        # partition, matching the TPU state layout) and apply the now/epoch
        # clamps at finalize.
        self.init_now_s = utc_now_seconds() if init_now_s is None else init_now_s
        i64 = np.iinfo(np.int64)
        self.earliest_s = np.full(p, i64.max, dtype=np.int64)
        self.latest_s = np.full(p, i64.min, dtype=np.int64)
        self.smallest = np.full(p, i64.max, dtype=np.int64)
        self.largest = np.zeros(p, dtype=np.int64)
        self.overall_size = 0
        self.overall_count = 0
        # Alive-key bitmap over fnv32 slots, packed bits (reference: BitSet).
        self._alive_words: "np.ndarray | None" = None
        if config.count_alive_keys:
            nwords = 1 << max(config.alive_bitmap_bits - 5, 0)
            self._alive_words = np.zeros(nwords, dtype=np.uint32)
        # Exact distinct-key tracking by 64-bit hash identity, one set per
        # partition (referee for the HLL sketch and its per-partition rows;
        # collision probability ~2^-64).  Global distinct = |union| — the
        # same key CAN appear in several partitions in arbitrary streams.
        # Kept only when a distinct count is reported, in one set when no
        # per-partition count is.
        self._track_keys = config.enable_hll or config.distinct_keys_per_partition
        self._seen_keys: "list[set[int]]" = [
            set() for _ in range(p if config.distinct_keys_per_partition else 1)
        ]
        # Exact message sizes histogram referee for quantiles, keyed by
        # (partition << 32 | size) so per-partition summaries are exact too:
        # the sorted distinct keys and their counts.
        self._size_keys = np.zeros(0, dtype=np.int64)
        self._size_counts = np.zeros(0, dtype=np.int64)

    # -- update --------------------------------------------------------------

    def update(self, batch: RecordBatch) -> None:
        valid = batch.valid
        if not valid.any():
            return
        part = batch.partition
        kn = valid & ~batch.key_null
        vn = valid & ~batch.value_null
        tomb = valid & batch.value_null
        knull = valid & batch.key_null
        k_bytes = np.where(kn, batch.key_len, 0).astype(np.int64)
        v_bytes = np.where(vn, batch.value_len, 0).astype(np.int64)

        # One 1-D scatter-add per channel (a [B, 7] one is ~3x slower).
        pv = part[valid]
        for c, col in enumerate((valid, tomb, vn, knull, kn, k_bytes, v_bytes)):
            np.add.at(self.per_partition[:, c], pv, col[valid].astype(np.int64))

        self.overall_count += int(valid.sum())
        self.overall_size += int(k_bytes.sum() + v_bytes.sum())

        msg_size = k_bytes + v_bytes
        sized = vn  # min/max excludes tombstones (src/metric.rs:249-251)
        if sized.any():
            np.minimum.at(self.smallest, part[sized], msg_size[sized])
            np.maximum.at(self.largest, part[sized], msg_size[sized])
        np.minimum.at(self.earliest_s, part[valid], batch.ts_s[valid])
        np.maximum.at(self.latest_s, part[valid], batch.ts_s[valid])

        keyed = valid & ~batch.key_null
        if keyed.any():
            if self._track_keys and len(self._seen_keys) == 1:
                self._seen_keys[0].update(batch.key_hash64[keyed].tolist())
            elif self._track_keys:
                for pid in np.unique(part[keyed]):
                    sel = keyed & (part == pid)
                    self._seen_keys[int(pid)].update(batch.key_hash64[sel].tolist())
            if self._alive_words is not None:
                self._update_alive_bitmap(
                    batch.key_hash32[keyed], vn[keyed]
                )
        if self.config.enable_quantiles:
            keys = (part[sized].astype(np.int64) << 32) | msg_size[sized]
            uniq, counts = np.unique(keys, return_counts=True)
            merged = np.union1d(self._size_keys, uniq)
            total = np.zeros(len(merged), dtype=np.int64)
            total[np.searchsorted(merged, self._size_keys)] = self._size_counts
            total[np.searchsorted(merged, uniq)] += counts
            self._size_keys, self._size_counts = merged, total

    def _update_alive_bitmap(self, h32: np.ndarray, alive: np.ndarray) -> None:
        """Last-writer-wins per slot within the batch, then packed-bit RMW.

        Semantics identical to replaying ``insert``/``remove`` in record order
        (src/metric.rs:273-280): for each slot only its last record matters.
        """
        bits = self.config.alive_bitmap_bits
        slot = (h32.astype(np.uint64) & np.uint64((1 << bits) - 1)).astype(np.int64)
        # Last occurrence per slot: sort (slot << 32 | record index), both
        # below 2^32, and keep each slot's last entry, its largest index.
        keyed = np.sort((slot.astype(np.uint64) << np.uint64(32))
                        | np.arange(len(slot), dtype=np.uint64))
        sorted_slot = (keyed >> np.uint64(32)).astype(np.int64)
        last = np.ones(len(slot), dtype=bool)
        last[:-1] = sorted_slot[1:] != sorted_slot[:-1]
        uniq = sorted_slot[last]
        final_alive = alive[(keyed[last] & np.uint64(0xFFFFFFFF)).astype(np.int64)]
        word = (uniq >> 5).astype(np.int64)
        bit = (np.uint32(1) << (uniq & 31).astype(np.uint32)).astype(np.uint32)
        set_w = word[final_alive]
        set_b = bit[final_alive]
        clr_w = word[~final_alive]
        clr_b = bit[~final_alive]
        np.bitwise_and.at(self._alive_words, clr_w, ~clr_b)
        np.bitwise_or.at(self._alive_words, set_w, set_b)

    # -- finalize ------------------------------------------------------------

    def finalize(self) -> TopicMetrics:
        earliest, latest, smallest = finalize_extremes(
            int(self.earliest_s.min()),
            int(self.latest_s.max()),
            int(self.smallest.min()),
            self.init_now_s,
        )

        alive_keys = None
        if self._alive_words is not None:
            # bitwise_count avoids unpackbits' 8x temporary (4 GiB at 2^32).
            alive_keys = int(np.bitwise_count(self._alive_words).sum())
        quantiles = None
        quantiles_pp = None
        if self.config.enable_quantiles and len(self._size_keys):
            keys, kcounts = self._size_keys, self._size_counts
            sizes_all = keys & 0xFFFFFFFF
            quantiles = _exact_quantiles(sizes_all, kcounts)
            if self.config.quantiles_per_partition:
                parts_of_key = keys >> 32
                quantiles_pp = []
                for p in range(self.config.num_partitions):
                    sel = parts_of_key == p
                    quantiles_pp.append(
                        _exact_quantiles(sizes_all[sel], kcounts[sel])
                    )

        return TopicMetrics(
            partitions=list(range(self.config.num_partitions)),
            per_partition=self.per_partition.copy(),
            earliest_ts_s=earliest,
            latest_ts_s=latest,
            smallest_message=smallest,
            largest_message=int(self.largest.max()),
            overall_size=self.overall_size,
            overall_count=self.overall_count,
            alive_keys=alive_keys,
            # Report the exact distinct counts only when distinct-key
            # counting was requested, so cpu/tpu reports stay line-compatible.
            distinct_keys_exact=(
                len(set().union(*self._seen_keys)) if len(self._seen_keys) > 1
                else len(self._seen_keys[0])
            ) if self.config.enable_hll else None,
            distinct_keys_exact_per_partition=(
                [len(s) for s in self._seen_keys]
                if self.config.distinct_keys_per_partition
                else None
            ),
            quantiles=quantiles,
            quantiles_per_partition=quantiles_pp,
            per_partition_extremes=np.stack(
                [self.earliest_s, self.latest_s, self.smallest, self.largest],
                axis=1,
            ),
            init_now_s=self.init_now_s,
        )
