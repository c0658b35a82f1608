"""TorchBackend: the streaming reduction with its state resident on one
device (port of the reference's ``TpuBackend`` at superbatch K=1).

Per batch:
- `prepare` packs the row (wire v5 or v4, per-row alive pairs inside it
  when compaction is off) and, under compaction, the batch's compacted
  alive-pair table straight into a pinned host buffer and starts ONE
  asynchronous host→device copy of both (numpy packers, or the native
  shim with ``use_native``);
- `make_fused_sink` gives a `packing.FusedPackSink` whose rows are packed
  straight into the same pinned slots; a completed row (and, under
  compaction, its pairs packed into the slot's pair region) leaves
  through the same single copy;
- `update` views the device bytes as typed tensors and folds them into the
  state (backends/step.py), launching the counter kernel of the row's wire
  format on CUDA (`counters_merge` for v5, `counters_update` for v4).

Nothing synchronizes until `finalize`, so packing the next batch overlaps
the device's work on this one, on the main thread or on a prefetch
worker (engine.py): `prepare` and the sink may run on one thread while
`update` runs on another.  The copy, its event and the fold all run on
the stream the backend holds (``self.stream``, the creating thread's
current stream), whichever thread issues them.  Pinned buffers form a
ring sized from the prefetch depth; a slot is refilled only after the
CUDA event recorded behind its last copy has completed.  A one-time
pack→unpack self-check at construction holds the device-side byte views
against the host layout.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from kafka_topic_analyzer_tpu_torch._torch_support import resolve_device
from kafka_topic_analyzer_tpu_torch.backends.finalize import metrics_from_state
from kafka_topic_analyzer_tpu_torch.backends.step import (
    analyzer_step,
    apply_pair_table,
)
from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig
from kafka_topic_analyzer_tpu_torch.models.state import AnalyzerState, state_to_numpy
from kafka_topic_analyzer_tpu_torch.ops.bitmap import bitmap_scratch
from kafka_topic_analyzer_tpu_torch.packing import (
    FusedPackSink,
    alive_table_mode,
    batch_alive_pairs,
    pack_batch,
    pack_pair_table,
    packed_nbytes,
    pair_table_capacity,
    pair_table_nbytes,
    unpack_device,
    unpack_numpy,
    unpack_pair_table_device,
    unpack_pair_table_numpy,
)
from kafka_topic_analyzer_tpu_torch.records import RecordBatch
from kafka_topic_analyzer_tpu_torch.results import TopicMetrics
from kafka_topic_analyzer_tpu_torch.utils.timefmt import utc_now_seconds

def ring_slots(prefetch_depth: int) -> int:
    """Pinned staging slots for a prefetch depth: the item being folded,
    ``depth`` queued behind it and the one the worker holds or fills (at
    least 3: one filled, two copies in flight).  A slot whose copy is
    still in flight is waited for, never overwritten, so a short ring only
    stalls the producer."""
    return max(3, prefetch_depth + 2)


class StagedBatch:
    """A batch packed and on its way to the device: ``row`` is the packed
    row, ``pairs`` the compacted pair table (None unless the config
    compacts alive pairs), both device ``uint8`` tensors."""

    __slots__ = ("row", "pairs")

    def __init__(self, row: torch.Tensor, pairs: "torch.Tensor | None"):
        self.row = row
        self.pairs = pairs


def _host_view(t: torch.Tensor, dtype) -> np.ndarray:
    out = t.to("cpu", copy=True).numpy()
    return out if out.ndim == 0 else out.view(dtype)


def self_check_unpack(device: torch.device) -> None:
    """Pack known batches on the host, unpack them on ``device`` and
    compare field by field: catches a byte-view mismatch before it could
    corrupt results.  Covers both wire formats, per-row and both
    compacted pair forms, every HLL pair form, the register table and odd
    batch sizes (misaligned sections: the v4 ``ts_minmax`` is 8-byte
    aligned only when 9·B is a multiple of 8)."""
    from kafka_topic_analyzer_tpu_torch.io.synthetic import (
        SyntheticSource,
        SyntheticSpec,
    )

    spec = SyntheticSpec(
        num_partitions=3, messages_per_partition=40, keys_per_partition=16, seed=11
    )
    batch = next(SyntheticSource(spec).batches(100))
    configs = [
        AnalyzerConfig(
            num_partitions=3, batch_size=128, count_alive_keys=True,
            alive_bitmap_bits=16, enable_hll=True, hll_p=8,
            enable_quantiles=True,
        ),
        AnalyzerConfig(
            num_partitions=3, batch_size=127, count_alive_keys=True,
            alive_bitmap_bits=24, distinct_keys_per_partition=True, hll_p=8,
            quantiles_per_partition=True,
        ),
        AnalyzerConfig(
            num_partitions=3, batch_size=101, count_alive_keys=True,
            alive_bitmap_bits=24, distinct_keys_per_partition=True, hll_p=8,
            quantiles_per_partition=True, wire_format=4,
        ),
        AnalyzerConfig(
            num_partitions=3, batch_size=128, count_alive_keys=True,
            alive_bitmap_bits=16, enable_hll=True, hll_p=12,
            enable_quantiles=True, wire_format=4,
        ),
        AnalyzerConfig(
            num_partitions=3, batch_size=127, count_alive_keys=True,
            alive_bitmap_bits=24, distinct_keys_per_partition=True, hll_p=8,
            quantiles_per_partition=True, alive_compaction="off",
        ),
    ]
    for config in configs:
        row = pack_batch(batch, config)
        checks = [
            (unpack_numpy(row, config),
             unpack_device(torch.from_numpy(row).to(device), config)),
        ]
        if config.compact_alive:
            cap = pair_table_capacity(config, config.batch_size)
            pairs, _, _ = pack_pair_table(
                [batch_alive_pairs(batch, config)], config, cap
            )
            checks.append(
                (unpack_pair_table_numpy(pairs, config, cap),
                 unpack_pair_table_device(
                     torch.from_numpy(pairs).to(device), config, cap))
            )
        for expected, got in checks:
            for name, exp in expected.items():
                exp = np.asarray(exp)
                if not np.array_equal(_host_view(got[name], exp.dtype), exp):
                    raise RuntimeError(
                        f"packed-transfer self-check failed on field {name!r}: "
                        f"the {device} unpack disagrees with the host layout"
                    )


class TorchBackend:
    """Batched replacement for the reference's per-message handler: feed
    batches in per-partition offset order, read the results once at the
    end."""

    def __init__(
        self,
        config: AnalyzerConfig,
        init_now_s: "int | None" = None,
        device: "str | torch.device | None" = None,
        use_native: bool = False,
        prefetch_depth: int = 2,
    ):
        self.config = config
        self.device = resolve_device(device)
        #: Pack through the native shim when it loads (``--native``).
        self.use_native = use_native
        self.stream = (
            torch.cuda.current_stream(self.device)
            if self.device.type == "cuda" else None
        )
        self.init_now_s = utc_now_seconds() if init_now_s is None else init_now_s
        self_check_unpack(self.device)
        self.state = AnalyzerState.init(config, self.device)
        b = config.batch_size
        self._pair_cap = pair_table_capacity(config, b) if config.compact_alive else 0
        # Pair lists (per row, or a compacted table in its list form)
        # scatter through a persistent word accumulator.
        pair_lists = config.count_alive_keys and (
            not config.compact_alive
            or alive_table_mode(config, self._pair_cap) == 1
        )
        self._scratch = (
            bitmap_scratch(config.alive_bitmap_bits, self.device)
            if pair_lists else None
        )
        self._row_nbytes = packed_nbytes(config, b)
        # The pair table starts on a 16-byte boundary of the staging row.
        self._pair_off = -(-self._row_nbytes // 16) * 16
        self._nbytes = self._pair_off + (
            pair_table_nbytes(config, self._pair_cap) if config.compact_alive else 0
        )
        pin = self.device.type == "cuda"
        self._ring = [
            torch.empty(self._nbytes, dtype=torch.uint8, pin_memory=pin)
            for _ in range(ring_slots(prefetch_depth))
        ]
        self._ring_np = [host.numpy() for host in self._ring]
        self._events: "list[torch.cuda.Event | None]" = [None] * len(self._ring)
        self._next = 0
        #: Batches folded into the state (one dispatch each at K=1).
        self.dispatches = 0

    def _on_stream(self):
        """Make the backend's stream current on the calling thread."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def _claim_slot(self) -> int:
        """The next pinned slot, once its last copy has completed."""
        slot = self._next
        self._next = (slot + 1) % len(self._ring)
        if self._events[slot] is not None:
            self._events[slot].synchronize()
        return slot

    def _send(self, slot: int) -> StagedBatch:
        """Start the one asynchronous copy of a filled slot to the device,
        and record the event that frees the slot."""
        with self._on_stream():
            dev = torch.empty(self._nbytes, dtype=torch.uint8, device=self.device)
            dev.copy_(self._ring[slot], non_blocking=True)
            if self.stream is not None:
                event = torch.cuda.Event()
                event.record(self.stream)
                self._events[slot] = event
        return StagedBatch(
            dev[: self._row_nbytes],
            dev[self._pair_off :] if self.config.compact_alive else None,
        )

    def _pack_pairs(self, pairs, slot: int) -> None:
        """Pack one dispatch's compacted pair table into ``slot``'s pair
        region."""
        pack_pair_table(
            [pairs], self.config, self._pair_cap, use_native=self.use_native,
            out=self._ring_np[slot][self._pair_off :],
        )

    def prepare(self, batch: RecordBatch) -> StagedBatch:
        """Pack a batch into the next pinned staging slot and start its
        copy to the device."""
        slot = self._claim_slot()
        pack_batch(
            batch, self.config, use_native=self.use_native,
            out=self._ring_np[slot][: self._row_nbytes],
        )
        if self.config.compact_alive:
            self._pack_pairs(
                batch_alive_pairs(batch, self.config, self.use_native), slot
            )
        return self._send(slot)

    def make_fused_sink(self, dense_of) -> FusedPackSink:
        """A sink whose rows are packed straight into the pinned slots and
        come out staged exactly like `prepare`'s (call only when the
        native shim is loaded; one sink per ingest stream)."""
        ptrs = [host.ctypes.data for host in self._ring_np]

        def alloc() -> np.ndarray:
            return self._ring_np[self._claim_slot()][: self._row_nbytes]

        def stage(row: np.ndarray, pairs=None) -> StagedBatch:
            slot = ptrs.index(row.ctypes.data)
            if self.config.compact_alive:
                self._pack_pairs(pairs, slot)
            return self._send(slot)

        return FusedPackSink(
            self.config, self.config.batch_size, dense_of,
            stage=stage, alloc=alloc,
        )

    def update(self, batch: "RecordBatch | StagedBatch") -> None:
        """Fold one batch (packed here if it was not prepared) into the
        state.  Asynchronous on CUDA."""
        if isinstance(batch, RecordBatch):
            batch = self.prepare(batch)
        with self._on_stream():
            analyzer_step(
                self.state, unpack_device(batch.row, self.config), self.config,
                scratch=self._scratch,
            )
            if batch.pairs is not None:
                apply_pair_table(
                    self.state,
                    unpack_pair_table_device(batch.pairs, self.config, self._pair_cap),
                    self.config,
                    scratch=self._scratch,
                )
        self.dispatches += 1

    def get_state(self) -> AnalyzerState:
        return self.state

    def finalize(self) -> TopicMetrics:
        """Copy the state to the host (waiting for the device) and derive
        the metrics there."""
        with self._on_stream():
            leaves = state_to_numpy(self.state)
        return metrics_from_state(leaves, self.config, self.init_now_s)
