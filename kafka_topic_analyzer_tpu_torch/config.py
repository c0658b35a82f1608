"""Static configuration of one analysis run (port of the reference's
``AnalyzerConfig``).

Same fields, defaults and validation as the reference, restricted to what
the port runs: wire format 5 with alive-pair compaction on, one device.
Asking for wire v4, for compaction off or for a mesh raises "not yet
ported" instead of quietly running something else.
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

    #: Kept for flag parity with the reference (``--pallas``).  In the
    #: port the wire-v5 counter merge always runs through the hand-written
    #: kernel on CUDA (ops/counters_merge.py), whatever this says.
    use_pallas_counters: bool = False
    #: ``auto`` compacts the alive pairs into one table per dispatch (the
    #: only form the port runs); ``off`` is not yet ported.
    alive_compaction: str = "auto"
    #: ``0`` resolves to 5; ``5`` is the combiner format; ``4`` is not yet
    #: ported.
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
        elif self.wire_format == 4:
            raise ValueError("wire_format 4 is not yet ported (use 5)")
        elif self.wire_format != 5:
            raise ValueError(
                f"wire_format {self.wire_format!r} invalid (0=auto, 4, or 5)"
            )
        if self.alive_compaction == "off":
            raise ValueError("alive_compaction 'off' is not yet ported")
        if self.alive_compaction != "auto":
            raise ValueError(
                f"alive_compaction {self.alive_compaction!r} invalid "
                "(auto or off)"
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
        dispatch — always, for an alive-key scan in the port."""
        return self.count_alive_keys

    @property
    def quantile_gamma(self) -> float:
        a = self.quantile_alpha
        return (1.0 + a) / (1.0 - a)
