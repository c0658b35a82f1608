"""Static configuration of one analysis run (port of the reference's
``AnalyzerConfig``).

Same fields, defaults and validation as the reference, restricted to what
the port runs: wire format 4 or 5, alive-pair compaction auto or off, one
device.  Asking for a mesh raises "not yet ported" instead of quietly
running something else.  The reference's ``KTA_WIRE_V4`` and
``KTA_DISABLE_COMPACTION`` environment switches are not ported: the port
reads no environment here, and the two fields below are its only way to
choose.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class AnalyzerConfig:
    #: Number of Kafka partitions in the topic (P): rows of the counter
    #: matrix.
    num_partitions: int = 1
    #: Records per device step (B).
    batch_size: int = 1 << 16

    #: Reference-compatible alive-key bitmap (``-c``).
    count_alive_keys: bool = False
    #: log2 of the bitmap slot space; 32 is reference-exact (512 MiB).
    alive_bitmap_bits: int = 32
    #: HyperLogLog distinct-key sketch.
    enable_hll: bool = False
    #: HLL precision p (m = 2^p registers), in [4, 16].
    hll_p: int = 16
    #: One register file per partition (implies enable_hll).
    distinct_keys_per_partition: bool = False
    #: DDSketch message-size quantiles.
    enable_quantiles: bool = False
    #: One sketch row per partition (implies enable_quantiles).
    quantiles_per_partition: bool = False
    #: DDSketch relative accuracy alpha (gamma = (1+a)/(1-a)).
    quantile_alpha: float = 0.005
    #: Number of log-gamma buckets.
    quantile_buckets: int = 2560

    #: Kept for flag parity with the reference (``--pallas``), whose v4
    #: checks it gates (batch size here, value length at pack time).  In
    #: the port every counter fold on CUDA runs through a hand-written
    #: kernel whatever this says: the wire-v5 table merge through
    #: ops/counters_merge.py, the wire-v4 per-record update through
    #: ops/counters_update.py.
    use_pallas_counters: bool = False
    #: ``auto`` compacts the alive pairs into one table per dispatch
    #: (wire v5 with ``-c``); ``off`` keeps the per-row pair sections.
    alive_compaction: str = "auto"
    #: ``0`` resolves to 5; ``5`` is the combiner format (per-partition
    #: tables); ``4`` ships per-record columns.
    wire_format: int = 0
    #: Device mesh (data, space); only (1, 1) is ported.
    mesh_shape: Tuple[int, int] = (1, 1)

    def __post_init__(self) -> None:
        if self.quantiles_per_partition and not self.enable_quantiles:
            object.__setattr__(self, "enable_quantiles", True)
        if self.distinct_keys_per_partition and not self.enable_hll:
            object.__setattr__(self, "enable_hll", True)
        if self.num_partitions < 1:
            raise ValueError("num_partitions must be >= 1")
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if not (0 < self.alive_bitmap_bits <= 32):
            raise ValueError("alive_bitmap_bits must be in (0, 32]")
        if not (4 <= self.hll_p <= 16):
            raise ValueError("hll_p must be in [4, 16]")
        if self.quantile_buckets < 8:
            raise ValueError("quantile_buckets must be >= 8")
        if self.wire_format == 0:
            object.__setattr__(self, "wire_format", 5)
        elif self.wire_format not in (4, 5):
            raise ValueError(
                f"wire_format {self.wire_format!r} invalid (0=auto, 4, or 5)"
            )
        if self.alive_compaction not in ("auto", "off"):
            raise ValueError(
                f"alive_compaction {self.alive_compaction!r} invalid "
                "(auto or off)"
            )
        # The compacted pair table is a v5 combiner section; v4 and
        # compaction "off" keep the per-row pairs.
        object.__setattr__(
            self,
            "_compact_alive",
            self.count_alive_keys
            and self.alive_compaction == "auto"
            and self.wire_format == 5,
        )
        if (
            self.use_pallas_counters
            and self.wire_format == 4
            and self.batch_size % 1024
        ):
            # The reference's v4 MXU kernel folds 1024-record blocks; the
            # port keeps the refusal so both CLIs accept the same flags.
            raise ValueError(
                "use_pallas_counters requires batch_size % 1024 == 0"
            )
        if tuple(self.mesh_shape) != (1, 1):
            raise ValueError(
                f"mesh_shape {tuple(self.mesh_shape)} is not yet ported "
                "(one device only)"
            )

    @property
    def hll_m(self) -> int:
        return 1 << self.hll_p

    @property
    def compact_alive(self) -> bool:
        """True when the alive pairs ship as one compacted table per
        dispatch instead of per-row sections: ``-c`` under wire v5 with
        compaction ``auto`` (resolved in ``__post_init__``)."""
        return self._compact_alive

    @property
    def quantile_gamma(self) -> float:
        a = self.quantile_alpha
        return (1.0 + a) / (1.0 - a)
